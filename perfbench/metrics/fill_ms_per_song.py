"""Host time of the batch driver's thread in `batch.fill` (`io/batch.py:_fill`,
each song copied into its staging row), over the songs yielded in the window,
in ms a song."""

from perfbench.program_spans import ms_per_song


def read(view):
    return ms_per_song(view, {"batch.fill"})
