"""Spans of the benchmark's own, the device trace of the measured window,
and the reductions that the per-layer readers share.

Spans are host intervals on `time.time_ns()`, the clock of the profiler's
events, recorded only in a traced run. The device trace is
`torch.profiler` with CUDA activity alone, over the window; its device
operations are clipped to the window before anything is summed.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field


class Spans:
    """Named host intervals `(name, start_ns, end_ns, thread)`; off, a
    span costs one branch."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns(), threading.get_ident()))


class Window:
    """The measured window: `t0_ns`, `t1_ns` on the profiler's clock, and
    with `trace` on a card the device operations that ran in it."""

    def __init__(self, trace: bool, device):
        self.trace = trace
        self.device = device
        self.prof = None
        self.t0_ns = self.t1_ns = 0

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if self.trace and self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self._sync()
        self.t0_ns = time.time_ns()
        return self

    def close(self):
        """Mark the window's end (the device work already queued is left
        to run; what runs after the mark is clipped away)."""
        if not self.t1_ns:
            self.t1_ns = time.time_ns()

    def __exit__(self, *exc):
        self.close()
        self._sync()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def device_ops(self) -> list:
        """`(name, start_ns, end_ns)` of every device operation, clipped to
        the window (the profiler's buffer requests are no device work)."""
        if self.prof is None:
            return []
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.name() == "Activity Buffer Request":
                continue
            lo = max(e.start_ns(), self.t0_ns)
            hi = min(e.start_ns() + e.duration_ns(), self.t1_ns)
            if hi > lo:
                out.append((e.name(), lo, hi))
        return out


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def union(intervals) -> list:
    """Merged `(lo, hi)` intervals, sorted."""
    merged: list = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    return merged


def covered_ns(intervals, lo: int | None = None, hi: int | None = None) -> int:
    """Nanoseconds of the union of `intervals` inside `[lo, hi]`."""
    total = 0
    for a, b in union(intervals):
        a = a if lo is None else max(a, lo)
        b = b if hi is None else min(b, hi)
        total += max(b - a, 0)
    return total


@dataclass
class View:
    """What a per-layer reader reads: the window, its device operations,
    the spans, and the counts the traffic made in it."""

    t0_ns: int
    t1_ns: int
    ops: list
    spans: list
    counts: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_s(self, select=lambda name: True, lo=None, hi=None) -> float:
        """Seconds in which a selected device operation ran."""
        return covered_ns([(a, b) for n, a, b in self.ops if select(n)], lo, hi) / 1e9


def breakdown(view: View, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each labelled by the innermost span open over it."""
    by_name: dict = {}
    for name, a, b in view.ops:
        by_name[name] = by_name.get(name, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = union((a, b) for _, a, b in view.ops)
    gaps, prev = [], view.t0_ns
    for a, b in busy + [[view.t1_ns, view.t1_ns]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]

    def label(lo, hi):
        mid = (lo + hi) // 2
        open_ = [(b - a, n) for n, a, b, _ in view.spans if a <= mid <= b]
        return min(open_)[1] if open_ else "no span"

    return {
        "device_ops": [[name[:120], ns / 1e9] for name, ns in ops],
        "idle_gaps": [[label(lo, hi), (hi - lo) / 1e9] for lo, hi in gaps],
    }
