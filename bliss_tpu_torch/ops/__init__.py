"""Signal-processing primitives and kernel wrappers of the port (the
primitives re-exported here are those of bliss_tpu/ops/__init__.py; its
matmul `convolve` has no counterpart: the CUDA kernels replace it)."""

from .reductions import (
    geometric_mean,
    masked_mean,
    masked_quantile_midpoint,
    masked_quantile_midpoint_all,
    masked_std,
    normalize_range,
    zero_crossing_count,
)
from .spectral import framed_pvoc_mags, pvoc_mags, pvoc_mags_buggy, stft
from .windows import (
    frame_signal,
    frame_signal_reflect,
    hann_periodic,
    n_frames_stft,
    n_frames_strided,
    reflect_pad,
)

__all__ = [
    "hann_periodic",
    "frame_signal",
    "frame_signal_reflect",
    "reflect_pad",
    "n_frames_strided",
    "n_frames_stft",
    "stft",
    "pvoc_mags_buggy",
    "pvoc_mags",
    "framed_pvoc_mags",
    "masked_mean",
    "masked_std",
    "masked_quantile_midpoint",
    "masked_quantile_midpoint_all",
    "geometric_mean",
    "zero_crossing_count",
    "normalize_range",
]
