"""Tuning-estimator kernel wrappers (counterpart of
bliss_tpu/ops/pallas_select.py and bliss_tpu/ops/pallas_hist.py).

The fused route's `bisect16_pair` and `histogram_threshold_plane`, and the
unfused route's byte-radix select (`masked_quantile_midpoint_radix`, four
launches of `bisect8_keys`; `bisect8` is the same counting pass over a
ready-made int8 plane) and `histogram_int_plane`. All kernels live in
csrc/tuning.cu and count exact integers. Each wrapper runs its kernel on
CUDA tensors and its plain version (here, with `torch.bincount` and
`torch.cumsum`) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

N_BUCKETS = 1 << 16
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _counting_select(plane: torch.Tensor, ks: torch.Tensor, n_buckets: int):
    """Plain counting select over a plane `[B, ...]` of values offset by
    -n_buckets/2 (the top value marks an excluded element) for ranks
    `ks [B, R]`: a bincount, its cumulative sum and `searchsorted`. Returns
    `[B, R]` buckets and `[B, R]` counts below them, int64."""
    b = plane.shape[0]
    u = plane.reshape(b, -1).to(torch.int64) + n_buckets // 2
    keep = u != n_buckets - 1
    song = torch.arange(b, device=plane.device).unsqueeze(1).expand_as(u)
    hist = torch.bincount(
        (song * n_buckets + u)[keep], minlength=b * n_buckets
    ).reshape(b, n_buckets)
    cum = torch.cumsum(hist, dim=1)
    target = ks.to(torch.int64) + 1
    # first v <= top - 1 with count(<= v) >= k + 1, else the top value
    bucket = torch.searchsorted(cum[:, : n_buckets - 1].contiguous(), target)
    below = torch.where(
        bucket > 0,
        torch.gather(cum, 1, torch.clamp(bucket - 1, min=0)),
        torch.zeros_like(bucket),
    )
    return bucket, below


def bisect16_pair_plain(plane: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Plain version of `bisect16_pair`."""
    bucket, below = _counting_select(plane, ks, N_BUCKETS)
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


def bisect8_plain(plane: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version of `bisect8`."""
    bucket, below = _counting_select(plane, k.reshape(-1, 1), 256)
    return torch.cat([bucket, below], dim=1).to(torch.int32)


def bisect8(plane: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th-smallest byte bucket over an int8 plane `[B, ...]` (key
    bytes offset by -128; 127, byte 0xFF, marks an excluded element).

    `k` is `[B]` int32. Returns `[B, 2]` int32 `[bucket, below]`: the first
    byte v <= 0xFE with count(<= v) >= k + 1, else 0xFF, and the number of
    elements in lower buckets; bit for bit the TPU kernel's sentinel rule
    (pallas_select.py:17-24): a valid byte 0xFF is reached only as the 0xFF
    fallback and never counted.
    """
    if not _build.on_cuda(plane):
        return bisect8_plain(plane, k)
    dev = plane.device
    b = plane.shape[0]
    flat = plane.reshape(b, -1)
    _build.require("plane", flat, torch.int8, 2, dev)
    _build.require("k", k, torch.int32, 1, dev)
    if k.shape[0] != b:
        raise ValueError(f"k: expected shape ({b},), got {tuple(k.shape)}")
    hist = torch.zeros((b, 256), dtype=torch.int32, device=dev)
    out = torch.empty((b, 2), dtype=torch.int32, device=dev)
    fn = _build.function("tuning", "bisect8_launch", [_P, _I, _L, _P, _P, _P, _P])
    err = fn(
        _build.ptr(flat), b, flat.shape[1], _build.ptr(k), _build.ptr(hist),
        _build.ptr(out), _build.stream_ptr(dev),
    )
    _build.check("bisect8", err)
    _build.count_launch("bisect8")
    return out


def histogram_int_plane_plain(idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain version of `histogram_int_plane`: `torch.bincount` with
    per-song offsets."""
    b = idx.shape[0]
    v = idx.reshape(b, -1).to(torch.int64)
    sel = (v >= 0) & (v < n_bins)
    song = torch.arange(b, device=idx.device).unsqueeze(1).expand_as(v)
    counts = torch.bincount((song * n_bins + v)[sel], minlength=b * n_bins)
    return counts.reshape(b, n_bins).to(torch.int32)


def histogram_int_plane(idx: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Counts of `idx == v` for v in [0, n_bins) over an int32 plane
    `[B, ...]`, per song -> `[B, n_bins]` int32. Values outside
    [0, n_bins) are ignored (the caller uses `n_bins` as the sentinel)."""
    if not _build.on_cuda(idx):
        return histogram_int_plane_plain(idx, n_bins)
    dev = idx.device
    b = idx.shape[0]
    flat = idx.reshape(b, -1)
    _build.require("idx", flat, torch.int32, 2, dev)
    if n_bins > 128:
        raise ValueError(f"histogram_int_plane: n_bins {n_bins} > 128")
    out = torch.zeros((b, n_bins), dtype=torch.int32, device=dev)
    fn = _build.function("tuning", "hist_int_launch", [_P, _I, _L, _I, _P, _P])
    err = fn(
        _build.ptr(flat), b, flat.shape[1], n_bins, _build.ptr(out),
        _build.stream_ptr(dev),
    )
    _build.check("histogram_int_plane", err)
    _build.count_launch("histogram_int_plane")
    return out


_INT32_MIN = -(1 << 31)


def radix_keys(values: torch.Tensor, mask: torch.Tensor, q: float = 0.5):
    """The radix select's inputs for `[B, ...]` values: the u32 sort keys'
    bit patterns as int32 `[B, N]` (all ones where masked out), the flat
    mask, the valid counts `[B]`, and the floor/ceil ranks of the midpoint
    quantile, each `[B]` int32 (pallas_select.py:236-245)."""
    b = values.shape[0]
    v = values.reshape(b, -1)
    m = mask.reshape(b, -1)
    skey = v.view(torch.int32)
    u = torch.where(skey < 0, ~skey, skey ^ _INT32_MIN)
    u = torch.where(m, u, -1)
    n = m.to(torch.int32).sum(1)
    pos = (n - 1).to(torch.float32) * q
    ranks = [
        torch.clamp(torch.floor(pos).to(torch.int32), min=0),
        torch.clamp(torch.ceil(pos).to(torch.int32), min=0),
    ]
    return u, m, n, ranks


def radix_plane(u: torch.Tensor, m: torch.Tensor, level: int, prefix: torch.Tensor):
    """The int8 plane of radix `level` (0-3): each key's byte at that level
    offset by -128, where the key's higher bytes equal the rank's `prefix
    [B]` (and the mask holds), 127 elsewhere (pallas_select.py:249-263)."""
    shift = 24 - 8 * level
    sb = (((u >> shift) & 0xFF) - 128).to(torch.int8)
    member = m
    if level:
        # the higher bytes, logically shifted down
        hi_bits = (u >> (shift + 8)) & ((1 << (24 - shift)) - 1)
        member = m & (hi_bits == prefix.to(torch.int32).unsqueeze(1))
    return torch.where(member, sb, 127).to(torch.int8).contiguous()


def bisect8_keys_plain(
    values: torch.Tensor, mask: torch.Tensor, level: int, state: torch.Tensor,
    q: float = 0.5, median: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of `bisect8_keys`: per rank the int8 plane of this
    level (`radix_plane` over `radix_keys`) through `bisect8_plain`."""
    from .reductions import _u32_key_to_float

    u, m, n, ranks = radix_keys(values, mask, q)
    if level == 0:
        state[:, 0:2] = 0
        state[:, 2:4] = torch.stack(ranks, dim=1)
    state[:, 4] = n
    out = torch.stack(
        [
            bisect8_plain(radix_plane(u, m, level, state[:, s]), state[:, 2 + s])
            for s in range(2)
        ],
        dim=1,
    )
    state[:, 0:2] = (state[:, 0:2] << 8) | out[:, :, 0]
    state[:, 2:4] -= out[:, :, 1]
    if level == 3 and median is not None:
        lo, hi = (_u32_key_to_float(state[:, s], values.dtype) for s in range(2))
        median.copy_(torch.where(n > 0, (lo + hi) * 0.5, float("inf")))
    return out


def bisect8_keys(
    values: torch.Tensor, mask: torch.Tensor, level: int, state: torch.Tensor,
    q: float = 0.5, median: torch.Tensor | None = None,
) -> torch.Tensor:
    """One level (0-3, from the top byte down) of the byte-radix select
    over the u32 sort keys of `values [B, N]` f32 where `mask [B, N]` bool
    holds, for the floor and the ceil rank of the midpoint quantile `q` in
    one pass over the mask; no `[B, N]` plane is formed.

    `state` is `[B, 5]` int64, advanced in place: per rank the key's higher
    bytes found so far, per rank the rank that remains among the keys that
    share them, and the valid count. Level 0 reads nothing of it: it counts
    the valid elements and takes the ranks `floor / ceil((n - 1) * q)` from
    that count. Returns `[B, 2, 2]` int32, per rank `[bucket, below]`: bit
    for bit what `bisect8` returns for that rank's `radix_plane`, the 0xFF
    rule included. After level 3 `state[:, :2]` holds the two keys, and
    `median [B]` f32, when given, the midpoint of their floats (+inf for a
    song without a valid element)."""
    if not _build.on_cuda(values):
        return bisect8_keys_plain(values, mask, level, state, q, median)
    dev = values.device
    b = values.shape[0]
    _build.require("values", values, torch.float32, 2, dev)
    _build.require("mask", mask, torch.bool, 2, dev)
    _build.require("state", state, torch.int64, 2, dev)
    if mask.shape != values.shape or state.shape != (b, 5) or not 0 <= level <= 3:
        raise ValueError("bisect8_keys: mismatched shapes or level outside 0-3")
    if median is not None:
        _build.require("median", median, torch.float32, 1, dev)
        if median.shape[0] != b:
            raise ValueError(f"median: expected shape ({b},), got {tuple(median.shape)}")
    # per rank 256 buckets, then the count of valid elements
    hist = torch.zeros((b, 513), dtype=torch.int32, device=dev)
    out = torch.empty((b, 2, 2), dtype=torch.int32, device=dev)
    fn = _build.function(
        "tuning", "bisect8_keys_launch",
        [_P, _P, _I, _L, _I, ctypes.c_float, _P, _P, _P, _P, _P],
    )
    err = fn(
        _build.ptr(values), _build.ptr(mask), b, values.shape[1], level, q,
        _build.ptr(state), _build.ptr(hist), _build.ptr(out),
        _build.ptr(median) if median is not None else None, _build.stream_ptr(dev),
    )
    _build.check("bisect8_keys", err)
    _build.count_launch("bisect8_keys")
    return out


def masked_quantile_midpoint_radix(
    values: torch.Tensor, mask: torch.Tensor, q: float = 0.5
) -> torch.Tensor:
    """Midpoint-interpolated masked quantile of each song's f32 values
    `[B, ...]` -> `[B]` by a 4-level byte radix over the u32 sort keys
    (bliss_tpu/ops/pallas_select.py:masked_quantile_midpoint_radix): one
    `bisect8_keys` per level, which counts both ranks in one pass over the
    mask and carries prefixes and ranks in a `[B, 5]` device tensor; 4
    launches per call and no host synchronisation. CUDA tensors are read in
    place and must be contiguous. Exactly `masked_quantile_midpoint_all`'s
    result; +inf for an all-False mask."""
    if mask.shape != values.shape:
        raise ValueError("masked_quantile_midpoint_radix: mask and values differ in shape")
    dev = values.device
    b = values.shape[0]
    if _build.on_cuda(values):
        # read in place: reshaping a non-contiguous tensor would copy the plane
        _build.require("values", values, torch.float32, values.dim(), dev)
        _build.require("mask", mask, torch.bool, mask.dim(), dev)
    v, m = values.reshape(b, -1), mask.reshape(b, -1)
    state = torch.zeros((b, 5), dtype=torch.int64, device=dev)
    median = torch.empty(b, dtype=torch.float32, device=dev)
    for level in range(4):
        bisect8_keys(v, m, level, state, q, median)
    return median
