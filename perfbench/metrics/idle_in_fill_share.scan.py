"""The share of the card's idle time in the scan's window (the window less
the union of its device operations) during which the batch driver's thread
was in `batch.fill`, in %."""

from perfbench.program_spans import idle_share


def read(view):
    return idle_share(view, "batch.fill")
