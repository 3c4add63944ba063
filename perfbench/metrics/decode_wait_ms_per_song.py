"""Host time of the batch driver's thread in `batch.decode_wait` (waiting
for a decode thread's next song), over the songs yielded in the window, in
ms a song."""

from perfbench.program_spans import ms_per_song


def read(view):
    return ms_per_song(view, {"batch.decode_wait"})
