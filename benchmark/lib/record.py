"""What a run records for the metric readers: counts, host spans, the
profiled slice, the work its inputs needed, and the device."""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Record:
    """One run's record. Readers (benchmark/metrics/<name>.py) take what
    they need and return None where it is absent."""

    def __init__(self, entry: str, cell: str):
        self.entry = entry            # the driver: 'eval_loop' | 'train_loop'
        self.cell = cell
        self.setup_s = None
        self.window_s = None
        self.images = 0
        self.batches = 0
        self.latencies_s = []         # eval: forward call to the end of consume
        self.step_s = []              # train: train_epoch's host time of each step call
        self.spans = defaultdict(list)
        self.profile = None           # benchmark.lib.profile.read_slice's dict
        self.launches = []            # the profiled slice's kernel launches
        self.flops = 0.0              # what the window's inputs need
        self.peak_window_bytes = None
        self.device = {}
        self.power = None             # the card's name and power limit (nvidia-smi)
        self.kernel_bound_ms = 0.0    # the profiled slice's launches' summed bounds
        self.correct = False
        self.attempted = 0
        self.failed = 0
        self.checks = {}              # name -> (value, limit)


class Spans:
    """Host spans on perf_counter's clock, by name, into a Record, each also
    a torch.profiler range 'bench.<name>'; nothing where `on` is false (a
    run that is not traced)."""

    def __init__(self, record: Record, on: bool):
        self.record, self.on = record, on
        self._open = {}

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        with torch.autograd.profiler.record_function("bench." + name):
            t = time.perf_counter()
            try:
                yield
            finally:
                self.record.spans[name].append(time.perf_counter() - t)

    def open(self, name: str) -> None:
        if self.on:
            rf = torch.autograd.profiler.record_function("bench." + name)
            rf.__enter__()
            self._open.setdefault(name, []).append((rf, time.perf_counter()))

    def close(self, name: str) -> None:
        if self.on and self._open.get(name):
            rf, t = self._open[name].pop()
            rf.__exit__(None, None, None)
            self.record.spans[name].append(time.perf_counter() - t)

    def module(self, module: torch.nn.Module, name: str) -> list:
        """Spans around every call of `module` (unsynced forward hooks)."""
        if not self.on:
            return []
        return [module.register_forward_pre_hook(lambda m, a: self.open(name)),
                module.register_forward_hook(lambda m, a, o: self.close(name))]


def device_info(device: torch.device, peak_bytes: int) -> dict:
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
