"""Tracing and profiling helpers (counterpart of
bliss_tpu/utils/profiling.py): accumulating stage timers, and a
`torch.profiler` trace of a block of code written as a Chrome trace."""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    """Accumulating wall-clock timers around decode/transfer/compute."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:24s} {self.totals[name]:8.3f}s "
                f"({self.counts[name]} calls)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir):
    """Trace the block with `torch.profiler`: host activity, and the card's
    kernels when a card is present. On exit the trace is written to
    `log_dir/trace.json` (open it in chrome://tracing or Perfetto). Yields
    the profiler, so the caller can also read `key_averages()`."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


# ---------------------------------------------------------------------------
# host memory and process age, read from /proc (Linux; no psutil)
# ---------------------------------------------------------------------------


def process_age_s(pid="self") -> float:
    """Seconds since process `pid` started (its `starttime` in
    /proc/<pid>/stat against /proc/uptime, to the clock tick)."""
    import os

    with open(f"/proc/{pid}/stat") as f:
        # the fields after the command name, which may hold spaces
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def rss_mb(pid="self") -> float:
    """Resident memory of process `pid` (`VmRSS`), in MiB; 0 once it is
    gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (FileNotFoundError, ProcessLookupError):
        pass
    return 0.0


def descendants(root: int) -> list:
    """The live processes whose parent chain leads to `root` (from
    /proc/*/stat)."""
    import os

    children: Dict[int, list] = defaultdict(list)
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (FileNotFoundError, ProcessLookupError, IndexError, ValueError):
            continue
        children[ppid].append(int(entry))
    out, todo = [], [root]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


class RssSampler:
    """Samples, every `period` seconds on a thread, the resident memory of
    process `root` (default: this one) and of its descendants: the peak of
    their sum, the root's own peak, each descendant's peak by pid (in the
    order they appeared), and every (seconds, sum, root's) sample. A sum
    counts the pages of the shared libraries once a process. Use as a
    context manager."""

    def __init__(self, period: float = 5.0, root: int | None = None):
        import os
        import threading

        self.period = period
        self.root = os.getpid() if root is None else root
        self.peak_mb = self.root_peak_mb = 0.0
        self.child_peaks: Dict[int, float] = {}
        self.samples: list = []
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @property
    def child_peak_mb(self) -> float:
        return max(self.child_peaks.values(), default=0.0)

    def sample(self) -> None:
        own = rss_mb(self.root)
        kids = {p: rss_mb(p) for p in descendants(self.root)}
        total = own + sum(kids.values())
        self.samples.append((time.perf_counter() - self._t0, total, own))
        self.peak_mb = max(self.peak_mb, total)
        self.root_peak_mb = max(self.root_peak_mb, own)
        for p, mb in kids.items():
            self.child_peaks[p] = max(self.child_peaks.get(p, 0.0), mb)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.sample()
            self._stop.wait(self.period)

    def __enter__(self) -> "RssSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.sample()

    def slope_mb_per_min(self, skip: float = 0.25) -> float:
        """Least-squares slope of the root process's RSS, MiB a minute, over
        the samples after the first `skip` of the run's time (start-up:
        imports, kernel loads, the first batches' buffers); 0 with fewer
        than 3."""
        import numpy as np

        t, _, m = np.asarray(self.samples or [(0.0, 0.0, 0.0)]).T
        keep = t >= skip * t[-1]
        if keep.sum() < 3:
            return 0.0
        return float(np.polyfit(t[keep] / 60.0, m[keep], 1)[0])
