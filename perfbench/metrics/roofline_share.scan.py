"""The share of the window's kernel time that the analysis's work needs
at the chip's peaks: Σ over the songs yielded in the window of each
descriptor stage's least time at its valid shapes (`perfbench/roofline.py`),
over the device's busy time of its non-copy operations (the uploads and
memsets left out, as `device_ms_per_song` leaves them), in %."""

from perfbench.trace import is_copy


def read(view):
    least = view.counts.get("least_s")
    busy = view.busy_s(lambda name: not is_copy(name))
    if not least or not busy:
        return None
    return 100.0 * least / busy
