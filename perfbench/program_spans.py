"""The program's own spans, for the readers that put the host's time and
the card's idle time down to the program's steps.

The port records its steps (`bliss_tpu_torch.utils.profiling.RECORDER`:
the batch driver's `batch.*` spans, the analyzer's `analyze` and
`analyze.<stage>`) on `time.time_ns()`, the clock of the profiler's
events, while a profiler runs, as it does over a traced window. The first
reader takes them from the recorder after the window and keeps them with
the view (`view.program_spans`); each reader then uses the spans of the
driver's thread, the one that dispatched the batches, clipped to the
window. A program without the recorder, or a window without a span (an
untraced run), gives the readers None.
"""

from __future__ import annotations

from perfbench.trace import covered_ns, union


def _take() -> list:
    try:
        from bliss_tpu_torch.utils.profiling import RECORDER
    except ImportError:  # a program from before it had the recorder
        return []
    return RECORDER.take()


def driver_spans(view):
    """`[(name, lo, hi)]` of the driver's thread, clipped to the window, in
    the order they opened; None without one."""
    if not hasattr(view, "program_spans"):
        view.program_spans = _take()
    dispatches: dict = {}
    for s in view.program_spans:
        if s.name == "batch.dispatch":
            dispatches[s.thread] = dispatches.get(s.thread, 0) + 1
    if not dispatches:
        return None
    driver = max(dispatches, key=dispatches.get)
    out = []
    for s in view.program_spans:
        lo, hi = max(s.start_ns, view.t0_ns), min(s.end_ns, view.t1_ns)
        if s.thread == driver and hi > lo:
            out.append((s.name, lo, hi))
    return out or None


def ms_per_song(view, names) -> float | None:
    """Milliseconds a song that the driver's thread spent in the spans
    `names` (their union, so a nested pair counts once)."""
    spans, songs = driver_spans(view), view.counts.get("songs")
    if spans is None or not songs:
        return None
    return 1e3 * covered_ns([(lo, hi) for name, lo, hi in spans if name in names]) / 1e9 / songs


def idle_intervals(view) -> list:
    """The window's `[lo, hi]` intervals in which no device operation ran."""
    out, prev = [], view.t0_ns
    for lo, hi in union((a, b) for _, a, b in view.ops) + [[view.t1_ns, view.t1_ns]]:
        if lo > prev:
            out.append((prev, min(lo, view.t1_ns)))
        prev = max(prev, hi)
    return out


def innermost(spans, t0: int, t1: int) -> list:
    """`[t0, t1]` cut into `(lo, hi, name)` pieces, each named by the
    innermost of the nested `spans` open over it (None: no span)."""
    pieces, stack, at = [], [], t0

    def upto(t):
        nonlocal at
        if t > at:
            pieces.append((at, t, stack[-1][0] if stack else None))
            at = t

    for name, lo, hi in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][1] <= lo:
            upto(stack[-1][1])
            stack.pop()
        upto(lo)
        stack.append((name, hi))
    while stack:
        upto(stack[-1][1])
        stack.pop()
    upto(t1)
    return pieces


def idle_by_span(view) -> dict | None:
    """Nanoseconds of the card's idle time in the window by the innermost
    span of the driver's thread open over it (key None: in no span); None
    without spans or device operations."""
    spans = driver_spans(view)
    if spans is None or not view.ops:
        return None
    idle = idle_intervals(view)
    out: dict = {}
    i = 0
    for lo, hi, name in innermost(spans, view.t0_ns, view.t1_ns):
        while i < len(idle) and idle[i][1] <= lo:
            i += 1
        j, ns = i, 0
        while j < len(idle) and idle[j][0] < hi:
            ns += min(hi, idle[j][1]) - max(lo, idle[j][0])
            j += 1
        if ns:
            out[name] = out.get(name, 0) + ns
    return out


def idle_share(view, name) -> float | None:
    """The share, in %, of the card's idle time in the window during which
    the driver's thread was innermost in span `name` (None: in none)."""
    by = idle_by_span(view)
    total = sum(by.values()) if by else 0
    return 100.0 * by.get(name, 0) / total if total else None
