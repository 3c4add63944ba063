"""The constant tables of the analysis, computed by the port itself.

These play the part of a model's weights: the Hann windows, the FFT
twiddles the kernels read, the tuning-indexed chroma filterbank
(src/chroma.rs:197-267), the interval template indices
(src/chroma.rs:139-175) and the beat tracker's weight vectors
(src/aubio.rs:909-962). `default_tables()` builds them on the host;
`tables_from_numpy` accepts tables computed elsewhere (for instance by
the JAX package) so two implementations can be fed identical constants.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .features import SAMPLE_RATE
from .ops.windows import _hann_np

CHROMA_N_FFT = 8192
N_CHROMA = 12
TEMPO_HOP = 256

# Dyad/triad template bank, templates are columns (src/chroma.rs:139-152).
_TEMPLATES = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 1, 0, 0, 0, 0, 1, 1, 0],
        [0, 0, 0, 1, 0, 0, 1, 0, 0, 1],
        [0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, 0, 0, 1, 0],
        [0, 0, 0, 0, 0, 0, 1, 1, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    ],
    dtype=np.int64,
)


def template_product_indices() -> np.ndarray:
    """[10*12, 3] pitch-class indices of the active entries of every
    rolled template; index 12 points at an all-ones row (2-entry dyads)."""
    out = np.full((10 * 12, 3), 12, dtype=np.int32)
    for t in range(10):
        template = _TEMPLATES[:, t]
        for s in range(12):
            idx = np.flatnonzero(np.roll(template, s))
            out[t * 12 + s, : len(idx)] = idx
    return out


def chroma_filter_table(n_fft: int = CHROMA_N_FFT, sample_rate: int = SAMPLE_RATE):
    """[100, 12, n_fft//2+1] f64 chroma filterbank for every tuning bin.

    The tuning estimate is quantized to 100 histogram bins
    (src/chroma.rs:334-359), so the tuning-dependent filter takes only
    100 values, computed here once in f64.
    """
    n_chroma = N_CHROMA
    n_chroma2 = round(n_chroma / 2.0)
    out = np.zeros((100, n_chroma, 1 + n_fft // 2), np.float64)
    for i in range(100):
        tuning = (-50.0 + i) / 100.0
        freqs = np.linspace(0.0, float(sample_rate), n_fft + 1)
        a440 = 440.0 * 2.0 ** (tuning / n_chroma)
        with np.errstate(divide="ignore"):
            fb = n_chroma * np.log2(freqs / (a440 / 16.0))
        fb[0] = fb[1] - 1.5 * n_chroma
        binwidth = np.concatenate([np.maximum(np.diff(fb), 1.0), [1.0]])
        d = fb[None, :] - np.arange(n_chroma)[:, None]
        d = np.mod(d + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
        d = d / binwidth
        wts = np.exp(-0.5 * (2.0 * d) ** 2)
        norm = np.sqrt(np.sum(wts * wts, axis=0))
        norm[norm < np.finfo(np.float64).tiny] = 1.0
        wts = wts / norm
        octweight = np.exp(-0.5 * ((fb / n_chroma - 5.0) / 2.0) ** 2)
        wts = wts * octweight
        wts = np.roll(wts, -3, axis=0)
        out[i] = wts[:, : 1 + n_fft // 2]
    return out


def tempo_geometry(sample_rate: int = SAMPLE_RATE):
    """winlen/step of the detection-function buffer (src/aubio.rs:1335-1341)."""
    winlen = 1
    target = int((5.8 * sample_rate) / TEMPO_HOP)
    while winlen < target:
        winlen <<= 1
    winlen = max(winlen, 4)
    return winlen, winlen // 4


def beat_weights(sample_rate: int = SAMPLE_RATE):
    """(rwv, dfwv) of BeatTracking::new (src/aubio.rs:909-962), in f32."""
    winlen, _ = tempo_geometry(sample_rate)
    laglen = winlen // 4
    rayparam_f = np.float32(60.0 * sample_rate / 120.0 / TEMPO_HOP)
    dfwvnorm = np.exp(
        (np.float32(np.log(2.0)) / rayparam_f) * np.float32(winlen + 2)
    )
    i_f = np.arange(1, laglen + 1, dtype=np.float32)
    rwv = (i_f / rayparam_f**2) * np.exp(-(i_f**2) / (2.0 * rayparam_f**2))
    j_f = np.arange(1, winlen + 1, dtype=np.float32)
    dfwv = np.exp((np.float32(np.log(2.0)) / rayparam_f) * j_f) / dfwvnorm
    return rwv.astype(np.float32), dfwv.astype(np.float32)


def twiddles(n: int) -> np.ndarray:
    """[2, n//2+1] f32 (cos, -sin) of 2*pi*k/n from the integer phase k,
    evaluated in f64 and rounded once."""
    k = np.arange(n // 2 + 1)
    th = (k % n) * (2.0 * np.pi / n)
    return np.stack([np.cos(th), -np.sin(th)]).astype(np.float32)


#: name -> (shape, dtype) of every table the analysis reads.
SPEC = {
    "hann_512": ((512,), np.float32),
    "hann_8192": ((8192,), np.float32),
    "twiddle_512": ((2, 257), np.float32),
    "twiddle_8192": ((2, 4097), np.float32),
    "chroma_filter": ((100, N_CHROMA, CHROMA_N_FFT // 2 + 1), np.float64),
    "interval_indices": ((120, 3), np.int32),
    "bt_rwv": ((128,), np.float32),
    "bt_dfwv": ((512,), np.float32),
}


@functools.lru_cache(maxsize=1)
def _default_numpy() -> dict:
    rwv, dfwv = beat_weights()
    return {
        "hann_512": _hann_np(512),
        "hann_8192": _hann_np(8192),
        "twiddle_512": twiddles(512),
        "twiddle_8192": twiddles(8192),
        "chroma_filter": chroma_filter_table(),
        "interval_indices": template_product_indices(),
        "bt_rwv": rwv,
        "bt_dfwv": dfwv,
    }


class Tables:
    """Host copies of the tables plus per-device tensor copies."""

    def __init__(self, arrays: dict):
        self.arrays = arrays
        self._on = {}

    def on(self, device) -> dict:
        """The tables as tensors on `device` (cached)."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = {
                name: torch.as_tensor(np.ascontiguousarray(a), device=device)
                for name, a in self.arrays.items()
            }
        return self._on[key]


@functools.lru_cache(maxsize=1)
def default_tables() -> Tables:
    return Tables(dict(_default_numpy()))


def tables_from_numpy(d: dict) -> Tables:
    """Tables from numpy arrays computed elsewhere. Names missing from `d`
    keep the port's own values; shapes and dtypes are checked."""
    arrays = dict(_default_numpy())
    for name, value in d.items():
        if name not in SPEC:
            raise KeyError(f"unknown table {name!r}")
        shape, dtype = SPEC[name]
        value = np.asarray(value)
        if value.shape != shape:
            raise ValueError(f"table {name!r}: shape {value.shape} != {shape}")
        arrays[name] = value.astype(dtype, copy=False)
    return Tables(arrays)


def bt_rayparam(sample_rate: int = SAMPLE_RATE):
    """(rayparam as f32, its C truncation to uint) (src/aubio.rs:909-962)."""
    rayparam_f = np.float32(60.0 * sample_rate / 120.0 / TEMPO_HOP)
    return float(rayparam_f), float(np.uint32(rayparam_f))

