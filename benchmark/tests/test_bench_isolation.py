"""What the benchmark loads: nothing it runs imports JAX or the JAX
package (compared by whole top-level names: the port's begins with the
JAX package's), and the reference imports nothing of the port. Then the
reference and the port agree on a tiny f32 batch on the CPU, in each
cell; on a card, each cell runs from the command as a check runs it."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT, run_tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "neural_motifs_tpu"}
CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    mods = _loaded("import runpy, benchmark.drivers.eval_loop, benchmark.drivers.train_loop\n"
                   "import benchmark.reference.judge, benchmark.reference.judge_train\n"
                   "runpy.run_path('benchmark/run.py', run_name='not_main')")
    assert not mods & FORBIDDEN
    assert "benchmark" in mods


def test_reference_loads_nothing_of_the_port():
    mods = _loaded("import benchmark.reference.judge, benchmark.reference.judge_train, "
                   "benchmark.reference.rel_model, benchmark.reference.common")
    assert not mods & (FORBIDDEN | {"neural_motifs_tpu_torch"})


def test_a_run_loads_no_jax():
    """The port's modules that a run imports, the drivers' lazy imports
    included."""
    mods = _loaded("import neural_motifs_tpu_torch.training.eval_rels, "
                   "neural_motifs_tpu_torch.training.train_detector, "
                   "neural_motifs_tpu_torch.training.build, benchmark.drivers.eval_loop")
    assert not mods & FORBIDDEN and "neural_motifs_tpu_torch" in mods


@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_reference_and_port_agree_at_f32(cell):
    """The port at f32 on the CPU against the reference: every decision
    the same, and every number at least 50 times under its limit (f32's
    rounding, and in training the max-pool ties of the blocky scenes,
    which the two sides' memory layouts route to different taps)."""
    res = run_tiny(cell)
    checks = res["checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert checks["exact"]["value"] == 0
    for k, v in checks.items():
        assert v["value"] <= v["limit"] / 50, (k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_cell_on_the_card(card, cell, tmp_path):
    """The command as a check runs it, a short window: the contract's
    last line, the card named."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           "2147483901", "--seconds", "10", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert res["device"]["platform"] == "gpu" and "H100" in res["device"]["kind"]
    assert res["correct"] and "setup_s" in res["metrics"]
