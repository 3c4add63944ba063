"""Tracing and profiling helpers (counterpart of
bliss_tpu/utils/profiling.py): the program's span recorder, a
`torch.profiler` trace of a block of code written as a Chrome trace with
the program's spans in it, and readers of /proc.

The recorder (`RECORDER`) keeps named host intervals of the program's own
steps on `time.time_ns()`, the clock of the profiler's events, so a span
lines up with the torch operations and device kernels of one trace. It
records only while a torch profiler is running (`device_trace`, or any
`torch.profiler.profile`); otherwise a span site costs a branch in
`begin` and a no-op `end`, and allocates nothing."""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import pathlib
import threading
import time
from collections import defaultdict
from typing import Dict, NamedTuple, Optional

import torch.autograd.profiler as _torch_profiler


class Span(NamedTuple):
    """One recorded span. `thread` is the OS thread id, as the profiler's
    rows have it; `parent` the index, in the same `take()`, of the
    innermost span of the thread that encloses this one (-1: none);
    `batch` the batch's sequence id, else the parent's (-1: none); `args`
    a few small integers, or None."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int
    batch: int
    args: Optional[dict]


class _Off:
    """The span of a site while no profiler runs: false, and its `end()`
    does nothing."""

    __slots__ = ()

    def __bool__(self):
        return False

    def end(self):
        pass


_OFF = _Off()


class _Open:
    """A span being recorded, from its `begin` to its `end()`."""

    __slots__ = ("rec", "name", "batch", "seq", "start")

    def __init__(self, rec: "Recorder", name: str, batch: int):
        self.rec, self.name, self.batch = rec, name, batch
        self.seq = next(rec._seq)
        self.start = time.time_ns()

    def end(self, **args) -> None:
        """Close the span, with `args` (a few small integers) attached."""
        self.rec._keep((self.start, self.seq, time.time_ns(), self.name,
                        threading.get_native_id(), self.batch, args or None))


class Recorder:
    """Spans of the program's steps, kept in memory: at most `capacity`
    until `take()`; past it a span is dropped and counted in `dropped`.

    A site is `sp = RECORDER.begin(name)`, the step, `sp.end()`. A step
    that raises leaves its span unrecorded. Spans of one thread nest by
    time; no span may stay open across a `yield`."""

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = capacity
        self.dropped = 0
        self._kept: list = []
        self._lock = threading.Lock()
        self._seq = itertools.count()

    def begin(self, name: str, batch: int = -1):
        """Open span `name` while a torch profiler runs, else return a
        shared no-op span (false: `if sp:` guards work done only for a
        span's `args`)."""
        if not _torch_profiler._is_profiler_enabled:
            return _OFF
        return _Open(self, name, batch)

    def _keep(self, record: tuple) -> None:
        with self._lock:
            if len(self._kept) < self.capacity:
                self._kept.append(record)
            else:
                self.dropped += 1

    def take(self) -> list:
        """The spans closed since the last `take()`, in the order they
        opened (a parent before its children), and the buffer emptied."""
        with self._lock:
            kept, self._kept = self._kept, []
        kept.sort()
        out: list = []
        open_: Dict[int, list] = defaultdict(list)  # a thread's enclosing spans, by index
        for start, _, end, name, tid, batch, args in kept:
            stack = open_[tid]
            while stack and out[stack[-1]].end_ns < end:
                stack.pop()
            parent = stack[-1] if stack else -1
            if batch < 0 and parent >= 0:
                batch = out[parent].batch
            stack.append(len(out))
            out.append(Span(name, start, end, tid, parent, batch, args))
        return out


#: The program's recorder: the batch driver and the analyzer record here.
RECORDER = Recorder()


@contextlib.contextmanager
def device_trace(log_dir):
    """Trace the block with `torch.profiler`: host activity, the card's
    kernels when a card is present, and the program's spans (`RECORDER`,
    which this takes). On exit the trace is written to
    `log_dir/trace.json` (open it in chrome://tracing or Perfetto). Yields
    the profiler, so the caller can also read `key_averages()`."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    # the trace's times are microseconds after its base, or since the epoch without one
    base, pid = int(trace.get("baseTimeNanoseconds", 0)), os.getpid()
    trace["traceEvents"] += [
        {"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": dict(s.args or {}, batch=s.batch)}
        for s in RECORDER.take() if s.start_ns >= t0
    ]
    path.write_text(json.dumps(trace))


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
