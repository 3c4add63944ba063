"""Tuning-estimator kernel wrappers (counterpart of
bliss_tpu/ops/pallas_select.py and bliss_tpu/ops/pallas_hist.py).

The fused route: `tuning_peaks` reads the frame-major spectrum once and
lists each song's tuning peaks as (sort key, tuning bin); `tuning_select`
takes one block a song over that list and gives the midpoint median's
order statistics, the threshold key and the thresholded bin counts, bit
for bit what the TPU contracts of `bisect16_pair` (run twice) and
`histogram_threshold_plane` give over the plane composition
(`models/chroma.py:tuning_planes`, `level2_plane`, `threshold_key`, and
`bisect16_pair_plain` and `histogram_threshold_plane_plain` here). The
unfused route's byte-radix select (`masked_quantile_midpoint_radix`, four
launches of `bisect8_keys`; `bisect8_plain` is the TPU contract of one
level over a ready-made int8 plane) and `histogram_int_plane`. All kernels
live in csrc/tuning.cu and count exact integers. Each wrapper runs its kernel on
CUDA tensors and its plain version on CPU tensors. The plain versions of
the fused route's two sit here too, with the stencil and the tuning bin
they compute (`pip_stencil`, `tuning_bins`); the caller gives the band.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

N_BUCKETS = 1 << 16
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


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
    """The TPU contract of `bisect16_pair` (pallas_select.py:129), paired
    exact k-th-smallest buckets over an i16 plane `[B, ...]` (u16 values
    offset by -32768; u16 0xFFFF marks an excluded element), for the ranks
    `ks [B, 2]`: `[B, 4]` int32 `[b_f, b_c, below_f, below_c]`, each rank's
    first u16 value v <= 0xFFFE with count(<= v) >= k + 1 (else 0xFFFF) and
    the count below it. No path runs it: the tests and `chip_smoke.py` hold
    `tuning_select` against this composition."""
    bucket, below = _counting_select(plane, ks, N_BUCKETS)
    return torch.cat([bucket, below], dim=1).to(torch.int32)


def histogram_threshold_plane_plain(
    idx8: torch.Tensor, skey: torch.Tensor, tk: torch.Tensor, n_bins: int
) -> torch.Tensor:
    """The TPU contract of `histogram_threshold_plane` (pallas_hist.py:93)
    by `torch.bincount`: per song the counts of `(idx8 == v) & (skey >= tk)`
    for v in [0, n_bins) over an int8 tuning-bin plane and its i32 keys,
    `[B, n_bins]` int32. Held against `tuning_select`'s counts, as
    `bisect16_pair_plain` is."""
    b = idx8.shape[0]
    v = idx8.reshape(b, -1).to(torch.int64)
    sel = (v >= 0) & (v < n_bins) & (skey.reshape(b, -1) >= tk.reshape(b, 1))
    song = torch.arange(b, device=idx8.device).unsqueeze(1).expand_as(v)
    counts = torch.bincount((song * n_bins + v)[sel], minlength=b * n_bins)
    return counts.reshape(b, n_bins).to(torch.int32)


def pip_stencil(spec_fm: torch.Tensor, first: int, rows: int, hz_per_bin: float):
    """The pip_track stencil over a FRAME-MAJOR spectrum `[B, F, bins]`:
    `(pitches, mags, is_peak)`, each `[B, F, rows]`, where row `i` is
    spectrum bin `first + 1 + i` between its neighbours `first + i` and
    `first + 2 + i` (models/chroma.py:peak_band gives the band). Elementwise
    throughout, so the three are contiguous when `spec_fm` is: `ops.spectral.stft`
    returns the `[B, bins, F]` view of such storage, and `spec_fm` is that
    view transposed back. `tuning_peaks` computes it step for step."""
    dtype = spec_fm.dtype
    ref_value = 0.1 * spec_fm.amax(-1, keepdim=True)  # per-frame threshold
    before = spec_fm[..., first : first + rows]
    elem = spec_fm[..., first + 1 : first + 1 + rows]
    after = spec_fm[..., first + 2 : first + 2 + rows]
    is_peak = (elem > ref_value) & (after <= elem) & (before < elem)
    avg = 0.5 * (after - before)
    shift_den = 2.0 * elem - after - before
    shift_den = torch.where(
        torch.abs(shift_den) < torch.finfo(dtype).tiny, shift_den + 1.0, shift_den
    )
    shift = avg / shift_den
    row_bins = torch.arange(rows, dtype=dtype, device=spec_fm.device) + (first + 1)
    pitches = (row_bins + shift) * hz_per_bin
    mags = elem + 0.5 * avg * shift
    return pitches, mags, is_peak


def tuning_bins(pitches: torch.Tensor, resolution: float, bins_per_octave: int):
    """Histogram bin in [0, 1/resolution) of each frequency's deviation from
    the equal-tempered grid (src/chroma.rs:334-359); the octave is
    models/chroma.py:hz_to_octs at tuning 0, whose A4 / 16 is 27.5 exactly."""
    dtype = pitches.dtype
    n_bins = int(round(1.0 / resolution))
    a4_16 = torch.full((), 440.0 / 16.0, dtype=dtype, device=pitches.device)
    octs = torch.log2(torch.clamp(pitches, min=torch.finfo(dtype).tiny) / a4_16)
    v = torch.remainder(bins_per_octave * octs, 1.0)
    v = torch.where(v >= 0.5, v - 1.0, v)
    idxf = (v - (-0.5)) / resolution
    # Rust `as usize` truncates toward zero and saturates negatives at 0
    return torch.clamp(idxf.to(torch.int32), 0, n_bins - 1)


def peak_capacity(frames: int, rows: int) -> int:
    """Entries of one song's peak list: no two adjacent band rows are both
    peaks (row i needs after <= elem, row i + 1 elem < after), so a frame
    holds at most ceil(rows / 2)."""
    return frames * ((rows + 1) // 2)


def tuning_peaks_plain(
    spec_fm: torch.Tensor, frame_mask: torch.Tensor, first: int, rows: int,
    hz_per_bin: float, resolution: float = 0.01, bins_per_octave: int = 12,
):
    """Plain version of `tuning_peaks`: `pip_stencil`, `tuning_bins` and
    the sort keys over the whole band, then each song's peaks gathered in
    (frame, row) order."""
    from .reductions import _float_sort_key

    b, f, _ = spec_fm.shape
    cap = peak_capacity(f, rows)
    pitches, mags, is_peak = pip_stencil(spec_fm, first, rows, hz_per_bin)
    pos = (is_peak & frame_mask.unsqueeze(-1) & (pitches > 0.0)).reshape(b, -1)
    key = _float_sort_key(mags).reshape(b, -1)
    idx = tuning_bins(pitches, resolution, bins_per_octave).reshape(b, -1)
    n = pos.sum(1).to(torch.int32)
    # a stable sort puts each song's peaks first, in order
    order = torch.argsort((~pos).to(torch.uint8), dim=1, stable=True)[:, :cap]
    keys = torch.gather(key, 1, order).contiguous()
    return keys, torch.gather(idx, 1, order).to(torch.uint8).contiguous(), n


def tuning_peaks(
    spec_fm: torch.Tensor, frame_mask: torch.Tensor, first: int, rows: int,
    hz_per_bin: float, resolution: float = 0.01, bins_per_octave: int = 12,
):
    """Each song's tuning peaks from the frame-major f32 spectrum
    `[B, F, bins]` (the storage `ops.spectral.stft` returns a `[B, bins, F]`
    view of) and `frame_mask [B, F]` bool: the `rows` band rows from bin
    `first + 1` on that are peaks with a positive pitch in a valid frame, as
    `pip_stencil` finds them. Returns `(keys, bins, n)`: `keys [B, cap]`
    int32 the sort keys of the peak magnitudes, `bins [B, cap]` uint8 their
    tuning bins, song b's `n[b]` peaks first in no set order, with `cap =
    peak_capacity(F, rows)`. One pass over the spectrum; no plane."""
    if not _build.on_cuda(spec_fm):
        return tuning_peaks_plain(
            spec_fm, frame_mask, first, rows, hz_per_bin, resolution, bins_per_octave
        )
    dev = spec_fm.device
    _build.require("spectrum", spec_fm, torch.float32, 3, dev)
    _build.require("frame_mask", frame_mask, torch.bool, 2, dev)
    b, f, bins = spec_fm.shape
    if first < 0 or first + rows + 2 > bins or frame_mask.shape != (b, f):
        raise ValueError(
            f"tuning_peaks: spectrum {tuple(spec_fm.shape)} and frame mask "
            f"{tuple(frame_mask.shape)} do not fit the band of {rows} rows after bin {first}"
        )
    n_bins = int(round(1.0 / resolution))
    cap = peak_capacity(f, rows)
    keys = torch.empty((b, cap), dtype=torch.int32, device=dev)
    bin_out = torch.empty((b, cap), dtype=torch.uint8, device=dev)
    n = torch.empty(b, dtype=torch.int32, device=dev)
    # PyTorch's CUDA division by a Python scalar multiplies by the f32
    # reciprocal; the kernel bins as the plain composition does on the card
    inv_res = float(np.float32(1.0) / np.float32(resolution))
    fn = _build.function(
        "tuning", "tuning_peaks_launch",
        [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _L, _P, _P, _P, _P],
    )
    _build.launch(
        "tuning_peaks", fn, dev, _build.ptr(spec_fm), _build.ptr(frame_mask), b, f, bins,
        first, rows, n_bins, hz_per_bin, float(bins_per_octave), inv_res, cap,
        _build.ptr(keys), _build.ptr(bin_out), _build.ptr(n),
    )
    return keys, bin_out, n


def _order_stat(values: torch.Tensor, member: torch.Tensor, ks: torch.Tensor):
    """bisect16_pair's contract over a list: per rank of `ks [B, R]` the
    k-th smallest of the 16-bit `values [B, C]` where `member` holds (0xFFFF
    when k reaches the count) and the count of members below it, by a sort."""
    s = torch.sort(torch.where(member, values, 1 << 16), dim=1).values
    total = member.sum(1, keepdim=True)
    found = ks < total
    kth = torch.gather(s, 1, torch.clamp(ks, max=max(s.shape[1] - 1, 0)))
    bucket = torch.where(found, kth, 0xFFFF)
    below = (member.unsqueeze(1) & (values.unsqueeze(1) < bucket.unsqueeze(2))).sum(2)
    return bucket, torch.where(found, below, total)


def tuning_select_plain(
    keys: torch.Tensor, bins: torch.Tensor, n: torch.Tensor, n_bins: int = 100
) -> dict:
    """Plain version of `tuning_select`, by sorts over the list."""
    from .reductions import _float_sort_key, _u32_key_to_float

    b, cap = keys.shape
    dev = keys.device
    # one excluded column, so that an empty list still has a minimum
    keys = torch.cat([keys, torch.full((b, 1), -1, dtype=keys.dtype, device=dev)], 1)
    bins = torch.cat([bins, torch.zeros((b, 1), dtype=bins.dtype, device=dev)], 1)
    n64 = n.to(torch.int64)
    listed = torch.arange(cap + 1, device=dev) < n64.unsqueeze(1)
    u = keys.to(torch.int64) & 0xFFFFFFFF
    u = u ^ (1 << 31)  # the unsigned key
    hi, lo = u >> 16, u & 0xFFFF
    ks = torch.stack([torch.clamp((n64 - 1) // 2, min=0), n64 // 2], 1)
    b1, below1 = _order_stat(hi, listed & (hi != 0xFFFF), ks)
    rem = torch.clamp(ks - below1, min=0)
    b2, below2 = _order_stat(lo, listed & (hi == b1[:, :1]) & (lo != 0xFFFF), rem)
    min_c = torch.where(listed & (hi == b1[:, 1:]), lo, 0xFFFF).amin(1)
    lo_c = torch.where(b1[:, 0] == b1[:, 1], b2[:, 1], min_c)
    x_f = _u32_key_to_float((b1[:, 0] << 16) | b2[:, 0], torch.float32)
    x_c = _u32_key_to_float((b1[:, 1] << 16) | lo_c, torch.float32)
    t = (x_f + x_c) * 0.5
    tk = torch.where(t == 0.0, -1, _float_sort_key(t)).to(torch.int32)
    v = bins.to(torch.int64)
    sel = listed & (keys >= tk.unsqueeze(1)) & (v < n_bins)
    song = torch.arange(b, device=dev).unsqueeze(1).expand_as(v)
    counts = torch.bincount((song * n_bins + v)[sel], minlength=b * n_bins)
    i32 = torch.int32
    return {
        "counts": counts.reshape(b, n_bins).to(i32),
        "o1": torch.cat([b1, below1], 1).to(i32),
        "o2": torch.cat([b2, below2], 1).to(i32),
        "min_c": min_c.to(i32),
        "tk": tk,
    }


def tuning_select(
    keys: torch.Tensor, bins: torch.Tensor, n: torch.Tensor, n_bins: int = 100
) -> dict:
    """One block a song over `tuning_peaks`' list: the midpoint median of
    the peak magnitudes in key space and the tuning-bin counts of the peaks
    at or above it. Returns int32 tensors, bit for bit the TPU contract's
    intermediates as the plane composition gives them: `o1 [B, 4]` =
    `bisect16_pair` over the keys' top halves for the ranks (n - 1) // 2
    and n // 2, `o2 [B, 4]` = `bisect16_pair` over the low halves of the
    floor rank's bucket for the remaining ranks, `min_c [B]` the least low
    half of the ceil rank's bucket, `tk [B]` the threshold key
    (`models/chroma.py:level2_plane`, `threshold_key`), and `counts
    [B, n_bins]` = `histogram_threshold_plane` at `tk`."""
    if not _build.on_cuda(keys):
        return tuning_select_plain(keys, bins, n, n_bins)
    dev = keys.device
    _build.require("keys", keys, torch.int32, 2, dev)
    _build.require("bins", bins, torch.uint8, 2, dev)
    _build.require("n", n, torch.int32, 1, dev)
    b, cap = keys.shape
    if bins.shape != (b, cap) or n.shape != (b,) or not 0 < n_bins <= 128:
        raise ValueError("tuning_select: mismatched shapes or n_bins outside 1-128")
    shapes = {"counts": (b, n_bins), "o1": (b, 4), "o2": (b, 4), "min_c": (b,), "tk": (b,)}
    out = {k: torch.empty(v, dtype=torch.int32, device=dev) for k, v in shapes.items()}
    fn = _build.function(
        "tuning", "tuning_select_launch",
        [_P, _P, _P, _I, _L, _I, _P, _P, _P, _P, _P, _P],
    )
    _build.launch(
        "tuning_select", fn, dev, _build.ptr(keys), _build.ptr(bins), _build.ptr(n), b, cap,
        n_bins, *(_build.ptr(out[k]) for k in ("counts", "o1", "o2", "min_c", "tk")),
    )
    return out


def bisect8_plain(plane: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The TPU contract of `bisect8` (pallas_select.py:39): the exact
    k-th-smallest byte bucket over an int8 plane `[B, ...]` (key bytes
    offset by -128; 127, byte 0xFF, marks an excluded element).

    `k` is `[B]` int32. Returns `[B, 2]` int32 `[bucket, below]`: the first
    byte v <= 0xFE with count(<= v) >= k + 1, else 0xFF, and the number of
    elements in lower buckets; a valid byte 0xFF is reached only as the 0xFF
    fallback and never counted (pallas_select.py:17-24).
    """
    bucket, below = _counting_select(plane, k.reshape(-1, 1), 256)
    return torch.cat([bucket, below], dim=1).to(torch.int32)


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
    _build.launch(
        "histogram_int_plane", fn, dev, _build.ptr(flat), b, flat.shape[1], n_bins,
        _build.ptr(out),
    )
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
    _build.launch(
        "bisect8_keys", fn, dev, _build.ptr(values), _build.ptr(mask), b, values.shape[1],
        level, q, _build.ptr(state), _build.ptr(hist), _build.ptr(out),
        _build.ptr(median) if median is not None else None,
    )
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
