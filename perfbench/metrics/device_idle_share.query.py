"""The device's idle share over the warm queries (from the first warm
`playlist_from` to the window's end): 1 - busy / wall, in %."""


def read(view):
    warm = view.counts.get("warm")
    if not warm or not view.ops:
        return None
    lo, hi = warm
    return 100.0 * (1.0 - view.busy_s(lo=lo, hi=hi) / ((hi - lo) / 1e9))
