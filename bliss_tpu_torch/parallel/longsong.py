"""Sequence parallelism: one very long song sharded over the time axis
(counterpart of bliss_tpu/parallel/longsong.py).

The chroma descriptor reads the whole song, because its tuning estimate is
a global histogram over all frames (bliss-rs src/chroma.rs:67-85); the
other descriptors stream. For hour-long files the time axis is cut into
`shards` equal pieces, each piece builds all of its own descriptor frames
from its samples plus a window-sized halo of its neighbours', and only
small things cross shards:

  * ONE halo exchange of sample margins (chroma 8192/2205 reflect frames,
    timbral 512/128 and tempo 512/256 strided frames, the silence gate's
    lookahead, the ZCR's previous sample),
  * sums for the tuning histogram, the global peak-magnitude median (an
    exact selection by 2 x 32 counting rounds), the interval-feature
    frame sums and the ZCR count,
  * gathers of per-frame scalar series (timbral centroid / rolloff /
    flatness, tempo novelty and silence, loudness chunk levels), so the
    cheap summaries and the sequential beat tracker run once, with the
    semantics of the unsharded path.

**The mesh axis of the JAX package is a leading tensor axis here.** All
shards lie on one device as `[D, shard_len]`, and the three collectives
are the three small functions `halo_exchange`, `psum` and `all_gather`
over that axis; spreading the shards over several cards changes their
bodies and nothing else. The chroma frames, the one large intermediate
(`[fps_max, 8192]` a shard, 3.7 times the shard's samples), are gathered
and transformed one shard at a time, so only one shard's frames are alive
at once; the other stages run over all shards in one call.

Frame ownership is derived from SAMPLE ranges: shard `d` owns chroma
frame `f` iff `f*hop` lies in its sample range, so a frame's window never
strays more than `window/2 < halo` beyond the shard's samples (an equal
number of frames per shard drifts by ~hop per shard and overruns the halo
on long signals: a 3e-4 parity breach at 45 s on 8 shards in the JAX
package's history).

Kernels on this path: each shard's chroma frames `[fps_max, 8192]`,
gathered across the halo, go through `ct_frames_mags`; the tempo magnitudes
`[D, hps + 7, 257]` come from `frame_dft_mags`; the tuning histogram is
`histogram_int_plane`. The timbral rows come from `timbral_fft` over the
halo-extended shards. This departs from bliss_tpu/parallel/longsong.py:
312-317, which materialises matmul-DFT magnitudes: the flatness contract
needs an FFT-structured f32 spectrum, and with `timbral_fft` the sharded
vector matches the bucketed analyzer's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import chroma as chroma_model
from ..models import loudness as loudness_model
from ..models import tempo as tempo_model
from ..models import timbral as timbral_model
from ..models.analyzer import _resolve_dtype, bucket_length, resolve_device
from ..ops.dft_kernels import ct_frames_mags, frame_dft_mags, timbral_fft
from ..ops.reductions import (
    _float_sort_key,
    _key_to_float,
    masked_quantile_midpoint_all,
    normalize_range,
)
from ..ops.tuning_kernels import histogram_int_plane
from ..ops.windows import n_frames_stft, n_frames_strided
from ..tables import default_tables

WINDOW = chroma_model.WINDOW_SIZE  # 8192
HOP = chroma_model.HOP_SIZE  # 2205
_PAD = WINDOW // 2

T_WIN = timbral_model.WINDOW_SIZE  # 512
T_HOP = timbral_model.HOP_SIZE  # 128
B_WIN = tempo_model.WINDOW_SIZE  # 512
B_HOP = tempo_model.HOP_SIZE  # 256
L_CHUNK = loudness_model.WINDOW_SIZE  # 1024

#: sample halo: covers the chroma reflect window (window/2 + hop of
#: ownership slack), the tempo/timbral strided-frame history (<= 2048)
#: and the silence/loudness lookahead (<= 1024).
HALO = WINDOW + HOP  # 10397

#: shard length granularity: loudness chunks (1024) align exactly, and
#: the 128/256 hops divide it, so all strided descriptors split evenly.
_GRAIN = L_CHUNK


# ---------------------------------------------------------------------------
# the three collectives over the shard axis (axis 0)
# ---------------------------------------------------------------------------


def halo_exchange(shards: torch.Tensor):
    """`(left, right)`, each `[D, HALO]`: the last samples of each shard's
    left neighbour and the first of its right neighbour; the two global
    edges read zeros (the zero padding / zero history of the unsharded
    path)."""
    zeros = shards.new_zeros((1, HALO))
    left = torch.cat([zeros, shards[:-1, -HALO:]])
    right = torch.cat([shards[1:, :HALO], zeros])
    return left, right


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a per-shard quantity `[D, ...]` over the shards."""
    return x.sum(0)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every shard's piece `[D, ...]`, in shard order, visible to all: on
    one device the stacked tensor itself."""
    return x


# ---------------------------------------------------------------------------
# exact global selection
# ---------------------------------------------------------------------------


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone mapping of float32 to its unsigned 32-bit sort key (total
    order, IEEE), held in int64."""
    return _float_sort_key(x.to(torch.float32)).to(torch.int64) + (1 << 31)


def _global_kth_smallest(values, mask, k):
    """Exact k-th smallest masked f32 value across all shards `[D, ...]`:
    32-round bisection on the float's order-isomorphic integer key (the
    signed int32 form, which orders as `_float_key` does and takes half
    its memory), one `psum` of a per-shard count per round."""
    d_count = values.shape[0]
    mask = mask.reshape(d_count, -1)
    keys = _float_sort_key(values.to(torch.float32)).reshape(d_count, -1)
    info = torch.iinfo(torch.int32)
    lo = torch.full((), info.min, dtype=torch.int64, device=values.device)
    hi = torch.full((), info.max, dtype=torch.int64, device=values.device)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        cnt = psum(((keys <= mid.to(torch.int32)) & mask).sum(-1))
        take_low = cnt >= k + 1
        lo, hi = torch.where(take_low, lo, mid + 1), torch.where(take_low, mid, hi)
    return _key_to_float(lo, torch.float32)


def _global_median_midpoint(values, mask):
    """Midpoint median of the masked values of all shards `[D, ...]`
    (ndarray-stats Midpoint semantics). f32 takes the counting rounds; any
    other dtype (the CPU's f64 chroma stage) one exact sort-based select
    over the flattened plane, the same value."""
    if values.dtype != torch.float32:
        return masked_quantile_midpoint_all(values.reshape(1, -1), mask.reshape(1, -1))[0]
    n = psum(mask.flatten(1).sum(-1))
    pos = (n - 1).to(torch.float32) * 0.5
    vlo = _global_kth_smallest(values, mask, torch.floor(pos).to(torch.int64))
    vhi = _global_kth_smallest(values, mask, torch.ceil(pos).to(torch.int64))
    return (vlo + vhi) * 0.5


# ---------------------------------------------------------------------------
# chroma
# ---------------------------------------------------------------------------


def _shard_base(d_count: int, shard_len: int, device) -> torch.Tensor:
    """`[D]` global position of each extended shard's first sample."""
    return torch.arange(d_count, device=device) * shard_len - HALO


def _chroma_local_frames(ext, base, f_lo, fps_max, length):
    """One shard's chroma STFT frames `[fps_max, WINDOW]` from its
    `ext [E]` = [left | shard | right], whose first sample lies at global
    position `base`.

    Global frame `f` starts at `f*HOP - _PAD` in reflect-padded
    coordinates; the shard owns frames `[f_lo, f_lo + own)` (ownership by
    sample range), computes `fps_max` frames and masks the tail. The
    reflect indices (around 0 and `length`) are taken on GLOBAL positions
    before the shard offset; they stay within one halo of the owning shard
    since `_PAD + HOP < HALO`. Positions fit int32 for songs up to 12 hours."""
    dev = ext.device
    i32 = torch.int32
    pos = (
        (torch.arange(fps_max, dtype=i32, device=dev) + f_lo.to(i32)).unsqueeze(-1) * HOP
        + torch.arange(WINDOW, dtype=i32, device=dev)
        - _PAD
    )
    idx = torch.where(pos < 0, -pos, pos)
    idx = torch.where(idx >= length, 2 * (length - 1) - idx, idx)
    return ext[torch.clamp(idx - base.to(i32), 0, ext.shape[0] - 1)]


def _chroma_spectrum(ext, shard_len, fps_max, length, dtype, tables):
    """Every shard's chroma STFT magnitudes `[D, 4097, fps_max]` and the
    mask `[D, fps_max]` of the frames it owns that lie inside the song."""
    dev = ext.device
    d_count = ext.shape[0]
    d = torch.arange(d_count, device=dev)
    base = _shard_base(d_count, shard_len, dev)

    # ownership: frame f belongs to shard floor(f*HOP / shard_len)
    f_lo = (d * shard_len + HOP - 1) // HOP
    f_hi = ((d + 1) * shard_len + HOP - 1) // HOP
    j = torch.arange(fps_max, device=dev)
    own = j < (f_hi - f_lo).unsqueeze(-1)

    # one shard's frames alive at a time; each [4097, fps_max] result is a
    # view of frame-major storage, stacked as such
    spectrum = torch.stack([
        ct_frames_mags(
            _chroma_local_frames(ext[i], base[i], f_lo[i], fps_max, length),
            tables["hann_8192"], tables["twiddle_8192"],
        ).transpose(0, 1)
        for i in range(d_count)
    ]).transpose(1, 2).to(dtype)

    frame_ids = j + f_lo.unsqueeze(-1)
    valid = own & (frame_ids < n_frames_stft(length, HOP))
    return spectrum, valid


def _tuning_planes(spectrum, valid):
    """The tuning estimate's per-shard planes: the histogram-bin plane of
    the peaks at or above the GLOBAL median peak magnitude (the input of
    `histogram_int_plane`), and the peak mask."""
    pitches, pmags, peak_mask = chroma_model.pip_track(spectrum, valid, WINDOW)
    pos_mask = peak_mask & (pitches > 0.0)
    threshold = _global_median_midpoint(pmags, pos_mask)
    sel = pos_mask & (pmags >= threshold)
    return chroma_model.tuning_bin_plane(pitches, sel), peak_mask


def _chroma_raw(ext, shard_len, fps_max, length, dtype, tables) -> torch.Tensor:
    """Raw `[10]` interval features of the time-sharded chroma pipeline
    (exact cross-shard reductions; see the module docstring)."""
    d_count = ext.shape[0]
    spectrum, valid = _chroma_spectrum(ext, shard_len, fps_max, length, dtype, tables)

    # --- tuning: local peaks, global median + histogram
    bin_plane, peak_mask = _tuning_planes(spectrum, valid)
    counts = psum(histogram_int_plane(bin_plane, 100))
    any_peak = psum(peak_mask.flatten(1).sum(-1)) > 0
    tuning = (-50.0 + torch.argmax(counts).to(dtype)) / 100.0
    tuning = torch.where(any_peak, tuning, 0.0)
    del bin_plane, peak_mask

    # --- chroma + interval features, local frames then one global mean
    chroma = chroma_model.chroma_stft_from_spectrum(
        spectrum, tuning.expand(d_count), WINDOW, tables
    )
    feats = chroma_model.interval_feature_matrix(
        chroma, tables["interval_indices"]
    )  # [D, 10, fps_max]
    local_sum = torch.where(valid.unsqueeze(1), feats, 0.0).sum(-1)
    total = psum(local_sum)
    count = psum(valid.sum(-1).to(dtype))
    return total / torch.clamp(count, min=1.0)


def _shard_geometry(t: int, d_count: int):
    """(shard_len, t_pad): grain-aligned shard size covering `t`."""
    shard_len = max(
        -(-t // (d_count * _GRAIN)) * _GRAIN,
        -(-(HALO + 1) // _GRAIN) * _GRAIN,
    )
    return shard_len, shard_len * d_count


def _pad_signal(signal: np.ndarray, t_pad: int) -> np.ndarray:
    signal = np.asarray(signal, np.float32).reshape(-1)
    if signal.shape[-1] < t_pad:
        signal = np.concatenate([signal, np.zeros(t_pad - signal.shape[-1], np.float32)])
    return signal


def _extended_shards(signal, length: int, t: int, shards: int, dev):
    """The song as `[D, HALO + shard_len + HALO]` on `dev`, samples past
    `length` zeroed, plus `shard_len`."""
    if shards < 1:
        raise ValueError(f"shards {shards}: at least 1")
    shard_len, t_pad = _shard_geometry(t, shards)
    sig = torch.as_tensor(_pad_signal(signal, t_pad)[:t_pad], device=dev)
    sig = torch.where(torch.arange(t_pad, device=dev) < length, sig, 0.0)
    sig = sig.view(shards, shard_len)
    left, right = halo_exchange(sig)
    return torch.cat([left, sig, right], dim=1), shard_len


def _postprocess_chroma(raw: torch.Tensor, version: int) -> torch.Tensor:
    post = chroma_model._postprocess_v1 if version == 1 else chroma_model._postprocess_v2
    return post(raw.unsqueeze(0))[0]


def sharded_chroma_features(
    signal: np.ndarray,
    length: int,
    version: int = 2,
    shards: int = 8,
    device="cuda",
    dtype=None,
) -> np.ndarray:
    """Chroma features of one long `[T]` signal, time-sharded `shards`
    ways on `device`.

    Any `T`: the signal is zero-padded up to a multiple of `shards` (and to
    the minimum viable shard size); padded samples and frames are masked
    out through `length`, so the result matches the unsharded chroma path.
    """
    dev = resolve_device(device)
    dtype = _resolve_dtype(dev, dtype)
    length = int(length)
    signal = np.asarray(signal, np.float32).reshape(-1)
    ext, shard_len = _extended_shards(signal, length, signal.shape[-1], shards, dev)
    raw = _chroma_raw(
        ext, shard_len, shard_len // HOP + 2, length, dtype, default_tables().on(dev)
    )
    return _postprocess_chroma(raw, version).to(torch.float32).cpu().numpy()


def sharded_analyze_samples(
    signal: np.ndarray,
    length: int,
    version: int = 2,
    shards: int = 8,
    device="cuda",
    dtype=None,
) -> np.ndarray:
    """Full 23-feature (20 for version 1) analysis of ONE long song,
    time-sharded `shards` ways on `device`: the long-song route of
    `io.batch.analyze_paths_batched`. Matches `analyze_samples` to f32
    reduction-order tolerance; every frame transform is local to a shard,
    and only halos, counts and per-frame scalar series cross shards (see
    the module docstring)."""
    dev = resolve_device(device)
    dtype = _resolve_dtype(dev, dtype)
    length = int(length)
    signal = np.asarray(signal, np.float32).reshape(-1)
    t = max(int(signal.shape[-1]), length)
    # the padded length is bucketed like models.analyzer.bucket_length, so a
    # library of long songs meets O(log T) shapes, not one per song
    ext, shard_len = _extended_shards(
        signal, length, bucket_length(t, min_bucket=1 << 17), shards, dev
    )
    tab = default_tables().on(dev)
    d_count = shards
    hps = shard_len // B_HOP  # tempo hops per shard
    fps_t = shard_len // T_HOP  # timbral frames per shard
    cps = shard_len // L_CHUNK  # loudness chunks per shard
    sig = ext[:, HALO : HALO + shard_len]
    left, right = ext[:, :HALO], ext[:, HALO + shard_len :]
    d = torch.arange(d_count, device=dev)

    # ---- chroma (exact cross-shard reductions)
    raw_chroma = _chroma_raw(ext, shard_len, shard_len // HOP + 2, length, dtype, tab)
    chroma = _postprocess_chroma(raw_chroma, version).to(torch.float32)

    # ---- timbral: local per-frame rows, gathered summaries. Frame
    # d*fps_t + j covers global [(d*fps_t + j)*128 - 384, ... + 512), which
    # starts at j*128 + HALO - 384 of the extended shard; shard 0's zero
    # left halo is the zero history.
    rows = timbral_fft(
        ext, fps_t, tab["hann_512"], tab["twiddle_512"], offset=(T_WIN - T_HOP) - HALO
    )  # [D, fps_t, 5]
    cent, roll, flat = timbral_model.frame_descriptors_from_raw(all_gather(rows))
    n_valid_t = n_frames_strided(length, T_WIN, T_HOP)
    mask_t = torch.arange(d_count * fps_t, device=dev) < n_valid_t
    spectral = timbral_model.summarize_spectral(
        cent.reshape(-1), roll.reshape(-1), flat.reshape(-1), mask_t
    )

    # ---- tempo: local novelty + silence, one beat tracker on the gathered
    # series. Frames for hops [h0 - 7, h0 + hps): the onset needs the
    # previous frame's magnitudes, the 7-slot peak-picker window 6 more.
    mags_b = frame_dft_mags(
        ext, B_WIN, B_HOP, (7 * B_HOP + B_WIN - B_HOP) - HALO, hps + 7,
        tab["hann_512"], tab["twiddle_512"],
    )  # [D, hps + 7, 257]
    onset_loc = torch.clamp(mags_b[:, 1:] - mags_b[:, :-1], min=0.0).sum(-1)
    del mags_b  # hops [h0 - 6, h0 + hps)
    windows = torch.stack(
        [onset_loc[:, i : i + hps] for i in range(7)], dim=-1
    )  # [D, hps, 7] = onset[h-6..h]
    proc = tempo_model._filtfilt7(windows)
    thresh_loc = (
        proc[..., 5]
        - torch.median(proc, dim=-1).values
        - proc.mean(-1) * tempo_model._PP_THRESHOLD
    )
    # silence gate: the raw frame at hop h spans [256h, 256h + 512)
    b = (sig.reshape(d_count, hps, B_HOP) ** 2).sum(-1)
    b_next = torch.cat([b[:, 1:], (right[:, :B_HOP] ** 2).sum(-1, keepdim=True)], dim=1)
    level_b = (b + b_next) / B_WIN
    silent_loc = 10.0 * torch.log10(level_b) < tempo_model.SILENCE_DB
    h_valid = torch.as_tensor([n_frames_strided(length, B_WIN, B_HOP)], device=dev)
    tempo = tempo_model.tempo_from_series(
        all_gather(thresh_loc).reshape(1, -1),
        all_gather(silent_loc).reshape(1, -1),
        h_valid,
        tempo_model._bt_constants(dev, tab),
    )[0]

    # ---- loudness: local chunk levels, gathered summaries
    e = (sig.reshape(d_count, cps, L_CHUNK) ** 2).sum(-1)
    starts = torch.arange(d_count * cps, device=dev) * L_CHUNK
    clen = torch.clamp(length - starts, 0, L_CHUNK)
    level = all_gather(e).reshape(-1) / torch.clamp(clen, min=1).to(e.dtype)
    loud = loudness_model.summarize_levels(level, clen)

    # ---- zcr: neighbour-sample sign changes, exact integer count; the
    # previous sample of a shard's first comes from its left halo
    prev = torch.cat([left[:, -1:], sig[:, :-1]], dim=1)
    j = torch.arange(shard_len, device=dev)
    start = (d * shard_len).unsqueeze(-1)  # global position j + start in [1, length)
    change = ((sig > 0) != (prev > 0)) & (j >= 1 - start) & (j < length - start)
    crossings = psum(change.sum(-1))
    rate = crossings.to(torch.float32) / float(np.float32(length))
    zcr = normalize_range(rate, 0.0, 1.0).to(torch.float32)

    out = torch.cat([tempo.reshape(1), zcr.reshape(1), spectral, loud, chroma])
    return out.to(torch.float32).cpu().numpy()
