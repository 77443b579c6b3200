"""Observability (counterpart of neural_motifs_tpu/utils/observe.py): the
parameter table, the eval pair-budget telemetry, and the tracer of the
program's layers.

The tracer records spans at the layer boundaries of a *run*, the loop of
an evaluation (`eval_rels.run_batches`, kind "eval") or of a training
epoch (`train_state.train_epoch`, kind "train"):

    with observe.run("eval"):
        observe.batch(k)                    # the batch the next spans serve
        with observe.span("detector", device=images.device):
            ...

A span records its name, its parent (the span open around it), the batch
or step it serves and its start and end on `time.perf_counter_ns`. Given
a CUDA `device` it also records the device time between two timing events
on the current stream, read without a sync: `poll()` resolves the pairs
the device has passed, and is called right after the loops' own blocking
reads; the run's close waits once on its last event. While a torch
profile records, each span is also a `record_function` range
"nm.<name>", on the trace's clock beside the kernels it launches.

Counts go at the same boundaries: the bytes of each batch's device
inputs, its images, and each run's launches of the five CUDA kernels (the
delta of their `.launches` counters). Outside a run a span or a count
only checks a flag. Runs may nest; spans and counts belong to the
innermost open run of the thread that opened it. `last_run(kind)` is the
last finished run of a kind and `report(run)` its table.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
from torch import nn

_profiling = torch._C._autograd._profiler_enabled
_now = time.perf_counter_ns
_KERNELS = (("K1", "roi_align", "roi_align_cuda"),
            ("K1 backward", "roi_align", "roi_align_bwd_cuda"),
            ("K2", "nms", "perclass_nms_cuda"),
            ("K3", "nms", "greedy_nms_cuda"),
            ("K4", "highway_lstm", "highway_lstm_cuda"))


def print_para(model: nn.Module) -> str:
    """Table of the model's parameters: name, shape, size and whether it
    trains, largest first, with the totals; printed and returned."""
    rows = [(k, tuple(p.shape), p.numel(), p.requires_grad)
            for k, p in model.named_parameters()]
    rows.sort(key=lambda r: -r[2])
    lines = [f"{'name':60s} {'shape':>20s} {'size':>12s} {'train':>6s}"]
    for k, shape, size, train in rows:
        lines.append(f"{k:60s} {str(shape):>20s} {size:>12,d} {'yes' if train else 'no':>6s}")
    total = sum(r[2] for r in rows)
    trained = sum(r[2] for r in rows if r[3])
    lines.append(f"{'TOTAL':60s} {'':>20s} {total:>12,d}")
    lines.append(f"{'TRAINABLE':60s} {'':>20s} {trained:>12,d}")
    out = "\n".join(lines)
    print(out)
    return out


class PairBudgetTelemetry:
    """Exactness accounting for eval pair compaction (max_pairs_eval).

    Compaction keeps the top-`budget` valid pairs per image; it is exact iff
    the pre-compaction valid-pair count (SGPrediction.num_valid_pairs) fits
    the budget. The reference scores every candidate pair, so an overflow
    caps recall; this aggregates and reports it."""

    def __init__(self, budget: int):
        self.budget = int(budget)
        self.images = 0
        self.overflow_images = 0
        self.dropped_pairs = 0
        self.max_valid = 0

    def update(self, num_valid_pairs) -> None:
        if num_valid_pairs is None:
            return
        nv = np.asarray(num_valid_pairs).astype(np.int64)
        self.images += int(nv.size)
        over = nv - self.budget
        self.overflow_images += int((over > 0).sum())
        self.dropped_pairs += int(np.clip(over, 0, None).sum())
        if nv.size:
            self.max_valid = max(self.max_valid, int(nv.max()))

    def report(self) -> str:
        if self.overflow_images == 0:
            return (f"[pairs] compaction budget {self.budget}: EXACT on all "
                    f"{self.images} images (max valid pairs {self.max_valid})")
        return (f"[pairs] WARNING: compaction budget {self.budget} overflowed "
                f"on {self.overflow_images}/{self.images} images "
                f"({self.dropped_pairs} valid pairs dropped, max valid "
                f"{self.max_valid}). Results are NOT exact vs the reference "
                f"(it scores every pair) — raise -max_pairs_eval.")


def kernel_launches() -> dict:
    """The five CUDA kernels' launch counters, by kernel."""
    from neural_motifs_tpu_torch.ops import highway_lstm, nms, roi_align
    mods = {"roi_align": roi_align, "nms": nms, "highway_lstm": highway_lstm}
    return {k: getattr(mods[m], fn).launches for k, m, fn in _KERNELS}


class SpanRecord:
    """One span: name, parent record (None at the top), the batch or step
    it serves, host start and end (ns, perf_counter_ns), and its device
    seconds (None on the CPU, or until resolved)."""

    __slots__ = ("name", "parent", "batch", "t0", "t1", "device_s", "events")

    def __init__(self, name: str, parent, batch: int):
        self.name, self.parent, self.batch = name, parent, batch
        self.t0 = self.t1 = 0
        self.device_s = None
        self.events = None

    @property
    def host_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9


class Run:
    """A loop's spans and counts: `batches` run, `records` in the order
    they opened, `counts` (h2d_bytes, images, the kernels' launches)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.batch = 0               # the batch the next spans serve
        self.batches = 0             # batches or steps the loop ran
        self.records: list[SpanRecord] = []
        self.counts: dict = defaultdict(int)
        self.thread = threading.get_ident()
        self.open: list[SpanRecord] = []
        self.pending: list[SpanRecord] = []   # device events not yet resolved
        self._launches0 = kernel_launches()

    def summary(self) -> dict:
        """name -> (calls, host s, self host s, device s or None), in the
        order the names first opened. Self time is a span's duration less
        the part its child spans cover; device time is None where a span
        of the name has none."""
        out = {}
        for r in self.records:
            row = out.setdefault(r.name, [0, 0.0, 0.0, 0.0])
            d = r.host_s
            row[0] += 1
            row[1] += d
            row[2] += d
            row[3] = None if row[3] is None or r.device_s is None else row[3] + r.device_s
            if r.parent is not None:
                out[r.parent.name][2] -= d
        return out

    def total(self, name: str, clock: str = "host") -> Optional[float]:
        """Seconds in `name` on the host clock or the device's (None where
        a span of it has no device time); 0 host seconds where none ran."""
        if clock not in ("host", "device"):
            raise ValueError(f"clock is 'host' or 'device', not {clock!r}")
        _, host, _, dev = self.summary().get(name, (0, 0.0, 0.0, None))
        return host if clock == "host" else dev


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("tracer", "run", "name", "batch", "device", "stream", "rec", "rf")

    def __init__(self, tracer, run, name, batch, device):
        self.tracer, self.run, self.name = tracer, run, name
        self.batch, self.device, self.rf = batch, device, None

    def __enter__(self):
        run = self.run
        rec = SpanRecord(self.name, run.open[-1] if run.open else None,
                         run.batch if self.batch is None else self.batch)
        if _profiling():
            self.rf = torch.autograd.profiler.record_function("nm." + self.name)
            self.rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            rec.events = self.tracer.event_pair(self.device)
            self.stream = torch.cuda.current_stream(self.device)
            rec.events[0].record(self.stream)
        run.open.append(rec)
        run.records.append(rec)
        self.rec = rec
        rec.t0 = _now()
        return rec

    def __exit__(self, *exc):
        rec, run = self.rec, self.run
        rec.t1 = _now()
        run.open.pop()
        if rec.events is not None:
            rec.events[1].record(self.stream)
            run.pending.append(rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Tracer:
    """The runs open in this process (innermost last), the last finished
    run of each kind, and the pool of timing events by device."""

    def __init__(self):
        self.stack: list[Run] = []
        self.last: dict = {}
        self.pool: dict = defaultdict(list)

    def current(self) -> Optional[Run]:
        if self.stack and self.stack[-1].thread == threading.get_ident():
            return self.stack[-1]
        return None

    @contextmanager
    def run(self, kind: str):
        r = Run(kind)
        self.stack.append(r)
        try:
            yield r
        finally:
            self.stack.remove(r)
            if r.pending:   # the run's one wait: its last device event
                r.pending[-1].events[1].synchronize()
            self.resolve(r)
            now = kernel_launches()
            for k, n in now.items():
                r.counts[f"launches {k}"] = n - r._launches0[k]
            self.last[kind] = r

    def span(self, name: str, batch: Optional[int] = None, device=None):
        run = self.current()
        if run is None:
            return _NULL
        return _Span(self, run, name, batch, device)

    def batch(self, k: int) -> None:
        run = self.current()
        if run is not None:
            run.batch = k
            run.batches = max(run.batches, k + 1)

    def count(self, name: str, n: int) -> None:
        run = self.current()
        if run is not None:
            run.counts[name] += n

    def event_pair(self, device: torch.device) -> tuple:
        """(start, end, device index): two timing events from the pool."""
        index = torch.cuda.current_device() if device.index is None else device.index
        free = self.pool[index]
        while len(free) < 2:
            free.append(torch.cuda.Event(enable_timing=True))
        return free.pop(), free.pop(), index

    def resolve(self, run: Run) -> None:
        """Device times of the run's pending spans whose end the device
        has passed, in the order they closed (one stream's order)."""
        done = 0
        for rec in run.pending:
            start, end, index = rec.events
            if not end.query():
                break
            rec.device_s = start.elapsed_time(end) * 1e-3
            rec.events = None
            self.pool[index] += [start, end]
            done += 1
        del run.pending[:done]

    def poll(self) -> None:
        for r in self.stack:
            if r.pending:
                self.resolve(r)


_TRACER = Tracer()
run = _TRACER.run
span = _TRACER.span
batch = _TRACER.batch
count = _TRACER.count
poll = _TRACER.poll


def traced(name: str):
    """A function's calls as spans `name` (host time only)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def last_run(kind: str) -> Optional[Run]:
    """The last finished run of `kind` ("eval" or "train") in this process."""
    return _TRACER.last.get(kind)


def tensor_bytes(x) -> int:
    """Bytes of the tensors in `x` (a tensor, or a dict, list or tuple of
    them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(v) for v in x)
    return 0


def report(r: Run) -> str:
    """The run's table: a line a span name (indented under its parent)
    with its calls, host ms a batch, self host ms a batch and device ms a
    batch; the counts a batch above it."""
    n = max(r.batches, 1)
    c = r.counts
    launches = ", ".join(f"{k} {c[f'launches {k}'] / n:.2f}" for k, _, _ in _KERNELS)
    lines = [f"[observe] {r.kind}: {r.batches} batches, {c['images'] / n:.2f} images and "
             f"{c['h2d_bytes'] / n / 1e6:.3f} MB of device inputs a batch; "
             f"launches a batch: {launches}",
             f"{'span':24s} {'calls':>7s} {'host ms':>10s} {'self ms':>10s} "
             f"{'device ms':>10s}"]
    depth = {}
    for rec in r.records:
        if rec.name not in depth:
            depth[rec.name] = 0 if rec.parent is None else depth[rec.parent.name] + 1
    for name, (calls, host, own, dev) in r.summary().items():
        lines.append(f"{'  ' * depth[name] + name:24s} {calls:7d} {1e3 * host / n:10.3f} "
                     f"{1e3 * own / n:10.3f} "
                     f"{'-' if dev is None else f'{1e3 * dev / n:.3f}':>10s}")
    return "\n".join(lines)
