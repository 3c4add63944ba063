"""Tuning-estimator kernel wrappers (counterpart of
bliss_tpu/ops/pallas_select.py:bisect16_pair and
bliss_tpu/ops/pallas_hist.py:histogram_threshold_plane).

Both kernels live in csrc/tuning.cu and count exact integers. Each
wrapper runs its kernel on CUDA tensors and its plain version (here, with
`torch.bincount` and `torch.cumsum`) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

N_BUCKETS = 1 << 16
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def bisect16_pair_plain(plane: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Plain version of `bisect16_pair`: a bincount of the u16 values,
    its cumulative sum, and `searchsorted` for each rank."""
    b = plane.shape[0]
    u = plane.reshape(b, -1).to(torch.int64) + 32768
    keep = u != N_BUCKETS - 1
    song = torch.arange(b, device=plane.device).unsqueeze(1).expand_as(u)
    hist = torch.bincount(
        (song * N_BUCKETS + u)[keep], minlength=b * N_BUCKETS
    ).reshape(b, N_BUCKETS)
    cum = torch.cumsum(hist, dim=1)
    target = ks.to(torch.int64) + 1
    # first v <= 0xFFFE with count(<= v) >= k + 1, else 0xFFFF
    bucket = torch.searchsorted(cum[:, : N_BUCKETS - 1].contiguous(), target)
    below = torch.where(
        bucket > 0,
        torch.gather(cum, 1, torch.clamp(bucket - 1, min=0)),
        torch.zeros_like(bucket),
    )
    return torch.cat([bucket, below], dim=1).to(torch.int32)


def bisect16_pair(plane: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Paired exact k-th-smallest buckets over an i16 plane `[B, ...]`
    (u16 values offset by -32768; u16 0xFFFF marks an excluded element).

    `ks` is `[B, 2]` int32 (floor/ceil ranks). Returns `[B, 4]` int32
    `[b_f, b_c, below_f, below_c]`: each rank's u16 bucket and the number
    of elements in lower buckets, bit for bit the TPU kernel's contract
    (ndarray-stats Midpoint semantics, pallas_select.py:15-17).
    """
    if not _build.on_cuda(plane):
        return bisect16_pair_plain(plane, ks)
    dev = plane.device
    b = plane.shape[0]
    flat = plane.reshape(b, -1)
    _build.require("plane", flat, torch.int16, 2, dev)
    _build.require("ks", ks, torch.int32, 2, dev)
    if ks.shape != (b, 2):
        raise ValueError(f"ks: expected shape ({b}, 2), got {tuple(ks.shape)}")
    hist = torch.zeros((b, N_BUCKETS), dtype=torch.int32, device=dev)
    out = torch.empty((b, 4), dtype=torch.int32, device=dev)
    fn = _build.function(
        "tuning", "bisect16_pair_launch", [_P, _I, _L, _P, _P, _P, _P]
    )
    err = fn(
        _build.ptr(flat), b, flat.shape[1], _build.ptr(ks), _build.ptr(hist),
        _build.ptr(out), _build.stream_ptr(dev),
    )
    _build.check("bisect16_pair", err)
    _build.count_launch("bisect16_pair")
    return out


def histogram_threshold_plane_plain(
    idx8: torch.Tensor, skey: torch.Tensor, tk: torch.Tensor, n_bins: int
) -> torch.Tensor:
    """Plain version of `histogram_threshold_plane` by `torch.bincount`."""
    b = idx8.shape[0]
    v = idx8.reshape(b, -1).to(torch.int64)
    sel = (v >= 0) & (v < n_bins) & (skey.reshape(b, -1) >= tk.reshape(b, 1))
    song = torch.arange(b, device=idx8.device).unsqueeze(1).expand_as(v)
    counts = torch.bincount((song * n_bins + v)[sel], minlength=b * n_bins)
    return counts.reshape(b, n_bins).to(torch.int32)


def histogram_threshold_plane(
    idx8: torch.Tensor, skey: torch.Tensor, tk: torch.Tensor, n_bins: int
) -> torch.Tensor:
    """Counts of `(idx8 == v) & (skey >= tk)` for v in [0, n_bins), per song.

    `idx8` is the int8 tuning-bin plane `[B, ...]` (out-of-range values are
    ignored), `skey` the i32 order-isomorphic magnitude keys of the same
    shape, `tk` the `[B]` i32 threshold keys. Returns `[B, n_bins]` int32.
    """
    if not _build.on_cuda(idx8):
        return histogram_threshold_plane_plain(idx8, skey, tk, n_bins)
    dev = idx8.device
    b = idx8.shape[0]
    flat_i = idx8.reshape(b, -1)
    flat_k = skey.reshape(b, -1)
    _build.require("idx8", flat_i, torch.int8, 2, dev)
    _build.require("skey", flat_k, torch.int32, 2, dev)
    _build.require("tk", tk, torch.int32, 1, dev)
    if flat_k.shape != flat_i.shape or tk.shape[0] != b or n_bins > 128:
        raise ValueError("histogram_threshold_plane: mismatched shapes")
    out = torch.zeros((b, n_bins), dtype=torch.int32, device=dev)
    fn = _build.function(
        "tuning", "hist_threshold_launch", [_P, _P, _P, _I, _L, _I, _P, _P]
    )
    err = fn(
        _build.ptr(flat_i), _build.ptr(flat_k), _build.ptr(tk), b,
        flat_i.shape[1], n_bins, _build.ptr(out), _build.stream_ptr(dev),
    )
    _build.check("histogram_threshold_plane", err)
    _build.count_launch("histogram_threshold_plane")
    return out
