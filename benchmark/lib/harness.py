"""The benchmark's one command:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It finds the cell in BENCHMARK.json, its configuration under
benchmark/configs/ and its traffic mix under benchmark/traffic/ by name,
runs the traffic's driver (benchmark/drivers/<entry>.py): set-up, the
measured window, the check of what the window produced. Then it reads each
metric of the cell through its reader (benchmark/metrics/<name>.py) and
prints the result as the last line of standard output, the numbers
compared for `correct` beside their limits last on standard error.
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics, with the device's busy time and the breakdown.

Two more options serve the limits' measurements and are not used by a
check: `--control fp8` puts the reference, computed at fp8, in the
program's place (no window); `--fault <name>` breaks the timed path in one
of the ways the comparison has to catch.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "neural_motifs_tpu")


def process_start() -> float:
    """perf_counter() at the moment this process started (from /proc), or
    now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def parse_args(argv):
    p = argparse.ArgumentParser(description="neural_motifs_tpu_torch benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8",), default=None)
    p.add_argument("--fault", default=None)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(spec: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(the cell's entry, its configuration file, its traffic file)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    confs = {c["name"]: c for c in spec["configs"]}
    conf = load_json(root / confs[cell["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    return cell, conf, traffic


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    whose `workloads` list it, or, without the key, every cell that reports
    the end-to-end metric they move (end-to-end metrics without the key:
    every cell)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def read_metrics(metrics: list[dict], record, root: Path = ROOT) -> dict:
    """Each metric through its reader, benchmark/metrics/<name>.py
    (`read(record)`: a number, or None where it finds nothing to read)."""
    out = {}
    for m in metrics:
        reader = load_file_module(root / "benchmark" / "metrics" / f"{m['name']}.py",
                                  "bench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fail(msg: str, code: int = 3) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, t0: float | None = None) -> int:
    t0 = process_start() if t0 is None else t0
    args = parse_args(argv)
    real_stdout = sys.stdout
    sys.stdout = sys.stderr          # the port's prints go to standard error
    try:
        spec = load_json(ROOT / "BENCHMARK.json")
        cell, conf, traffic = load_cell(spec, args.workload)
        import torch
        if not torch.cuda.is_available():
            return fail("no CUDA device (torch.cuda.is_available() is false)")
        if torch.cuda.device_count() < cell["chips"]:
            return fail(f"the cell needs {cell['chips']} devices, "
                        f"{torch.cuda.device_count()} present")
        driver = importlib.import_module(f"benchmark.drivers.{traffic['entry']}")
        ctx = Context(args=args, cell=cell, conf=conf, traffic=traffic,
                      device=torch.device("cuda", 0), t0=t0, root=ROOT)
        record = driver.run(ctx)
        result = finish(spec, ctx, record)
    finally:
        sys.stdout = real_stdout
    bad = forbidden_modules()
    if bad:
        return fail(f"the process loaded {bad} (JAX or the JAX package)")
    report_checks(record.checks)
    print(json.dumps(result), flush=True)
    return 0


class Context:
    """What a driver is given: the arguments, the cell's three files, the
    device, the process's start on perf_counter's clock, the checkout."""

    def __init__(self, args, cell, conf, traffic, device, t0, root=ROOT):
        self.args, self.cell, self.conf, self.traffic = args, cell, conf, traffic
        self.device, self.t0, self.root = device, t0, Path(root)

    def limits(self) -> dict:
        return load_json(self.root / "benchmark" / "limits" / f"{self.cell['name']}.json")


def finish(spec: dict, ctx: Context, record) -> dict:
    """The result line of a run."""
    kind = "per_layer" if ctx.args.trace else "end_to_end"
    metrics = read_metrics(cell_metrics(spec, ctx.cell["name"], kind), record, ctx.root)
    device = dict(record.device)
    if ctx.args.trace and record.profile is not None:
        device["busy_s"] = record.profile["busy_s"]
        device["window_s"] = record.profile["window_s"]
    out = {"correct": bool(record.correct), "attempted": int(record.attempted),
           "failed": int(record.failed), "metrics": metrics, "device": device}
    if ctx.args.trace and record.profile is not None:
        out["breakdown"] = {"device_ops": record.profile["device_ops"][:10],
                            "idle_gaps": record.profile["idle_gaps"][:10]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in record.checks.items()}
    return out


def report_checks(checks: dict) -> None:
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr, flush=True)
