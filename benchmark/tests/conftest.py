"""Fixtures of the benchmark's own tests (run from the repository root:
`python -m pytest benchmark/tests -q`)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present (decided here, when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")


def run_tiny(workload: str, *extra: str, timeout: int = 600) -> dict:
    """benchmark/tests/tiny.py in a process of its own; its result line."""
    env = dict(os.environ, NM_TPU_IM_SCALE="96", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "benchmark.tests.tiny", "--workload",
                           workload, *extra], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
