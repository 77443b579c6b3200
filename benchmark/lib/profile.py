"""A profiled slice of the window: torch.profiler over a few batches or
steps, its trace read into the busy time, the device time by kernel, the
device time of kernels launched under the benchmark's host ranges, and
the idle gaps named by the host range open during each."""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160   # a kernel's name in the breakdown, cut (C++ template names run to 1 kB)


class Slices:
    """The profiled slice of a window: `length` batches or steps from the
    first of `firsts`, with the port's kernel launches observed. It is read
    as soon as it stops (a profile sometimes records no device time, and a
    second session would disturb the first's); one without device time
    arms the next of `firsts`. The reading's host time is kept apart
    (`read_s`), so that the window can leave it out."""

    def __init__(self, firsts: tuple, length: int, observer_factory):
        self.firsts, self.length, self.factory = list(firsts), length, observer_factory
        self.current = None          # (first, Slice, observer)
        self.result, self.bound_ms, self.read_s = None, 0.0, 0.0

    def before(self, k: int) -> None:
        """Call before batch or step k is issued."""
        if self.result is None and self.current is None and self.firsts \
                and k == self.firsts[0]:
            self.current = (self.firsts.pop(0), Slice(), self.factory())
            self.current[2].install()
            self.current[1].start()

    def after(self, k: int) -> None:
        """Call once batch or step k is done with."""
        if self.current is not None and k == self.current[0] + self.length - 1:
            self._finish()

    def close(self) -> None:
        if self.current is not None:
            self._finish()

    def _finish(self) -> None:
        _, sl, obs = self.current
        self.current = None
        sl.stop()
        obs.uninstall()
        t = time.perf_counter()
        got = sl.read()
        if got is not None and got["busy_s"] > 0:
            self.result, self.bound_ms = got, obs.bound_ms()
        self.read_s += time.perf_counter() - t

    def read(self) -> tuple[dict | None, float]:
        return self.result, self.bound_ms


class Slice:
    """Start and stop a profile; `read()` gives its numbers."""

    def __init__(self):
        self.prof = None
        self.t_start = self.t_stop = None

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t_stop is None

    def read(self) -> dict | None:
        if self.prof is None or self.t_stop is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        return read_trace(trace.get("traceEvents", []), self.t_stop - self.t_start)


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(events: list, wall_s: float) -> dict | None:
    """busy_s, window_s, device_ops, idle_gaps, kernel_s (by kernel name),
    range_device_s (by 'bench.' range: the device time of the kernels
    launched inside it) and range_counts from a chrome trace's events;
    None without device activity."""
    dev, kernels, ranges, launches = [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((e["name"], ts, dur, e.get("args", {}).get("correlation")))
        elif cat == "user_annotation" and e["name"].startswith("bench."):
            ranges.append((e["name"], ts, ts + dur))
        elif cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = ts
    if not dev:
        return None
    busy = _merge(dev)
    busy_us = sum(e - s for s, e in busy)
    kernel_s = defaultdict(float)
    for name, _, dur, _ in kernels:
        kernel_s[name] += dur / 1e6
    range_counts = defaultdict(int)
    for rname, _, _ in ranges:
        range_counts[rname] += 1
    range_device_s = defaultdict(float)
    for name, _, dur, corr in kernels:
        t = launches.get(corr)
        if t is None:
            continue
        for rname, s, e in ranges:
            if s <= t <= e:
                range_device_s[rname] += dur / 1e6
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        inner = [(e - s, rname) for rname, s, e in ranges if s <= mid <= e]
        gaps[min(inner)[1][len("bench."):] if inner else "other"] += (s1 - e0) / 1e6
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_us / 1e6, "window_s": wall_s,
            "device_ops": [[n[:NAME_CHARS], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])],
            "kernel_s": dict(kernel_s), "range_device_s": dict(range_device_s),
            "range_counts": dict(range_counts)}
