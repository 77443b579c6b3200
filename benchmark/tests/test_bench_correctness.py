"""The comparison that decides `correct` fails where it has to, at a tiny
size on the CPU (benchmark/tests/tiny.py): the lower-precision control
(the reference at fp8 in the program's place, the configuration in bf16)
comes out not correct in every cell, and so does each fault that a cell
can have, the timed path broken underneath a run:

  eval cells      half_batch  the second half of a batch answered with
                              the first half's answers
                  altered     one object's class changed where the
                              answers are produced
  training cell   half_batch  the loss taken over half the batch
                  frozen      a step that returns its state unchanged

The limits are the cells' own (benchmark/limits/), set from the card."""

from __future__ import annotations

import json

import pytest

from benchmark.tests.conftest import ROOT, run_tiny

CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
FAULTS = {"eval": ("half_batch", "altered"), "train": ("half_batch", "frozen")}


def _kind(cell: str) -> str:
    return "train" if ".train." in cell else "eval"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run_tiny(cell, "--control", "fp8", "--dtype", "bfloat16")
    assert not res["correct"], res["checks"]
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[_kind(c)]])
def test_fault_is_not_correct(cell, fault):
    res = run_tiny(cell, "--fault", fault)
    assert not res["correct"], res["checks"]
