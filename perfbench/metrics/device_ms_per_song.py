"""Device busy time of the window's kernels (copies and memsets left
out), over the songs yielded in it, in ms a song."""

from perfbench.trace import is_copy


def read(view):
    songs = view.counts.get("songs")
    busy = view.busy_s(lambda name: not is_copy(name))
    if not songs or not busy:
        return None
    return 1e3 * busy / songs
