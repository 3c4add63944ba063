"""The share of the card's idle time in the scan's window during which the
batch driver's thread was in none of the program's spans, in %."""

from perfbench.program_spans import idle_share


def read(view):
    return idle_share(view, None)
