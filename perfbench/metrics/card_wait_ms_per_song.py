"""Host time of the batch driver's thread waiting on the card: in
`batch.slot_wait` (a staging buffer's last upload) and `batch.card_wait`
(a batch's features), over the songs yielded in the window, in ms a song."""

from perfbench.program_spans import ms_per_song


def read(view):
    return ms_per_song(view, {"batch.slot_wait", "batch.card_wait"})
