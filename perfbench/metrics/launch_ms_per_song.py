"""Host time of the batch driver's thread in `analyze` (its call of
`models/analyzer.py:analyze_tensor`, which enqueues the analysis's work on
the card), over the songs yielded in the window, in ms a song."""

from perfbench.program_spans import ms_per_song


def read(view):
    return ms_per_song(view, {"analyze"})
