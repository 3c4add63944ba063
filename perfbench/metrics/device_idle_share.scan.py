"""The device's idle share of the scan's window: 1 - (the union of its
operations' spans) / (the window's wall time), in %."""


def read(view):
    if "songs" not in view.counts or not view.ops:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)
