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

**The mesh axis of the JAX package is a list of devices here.** The
shards are `[D, shard_len]` rows; contiguous groups of `D / len(devices)`
rows lie on each device of the list (entries may repeat), and every
sharded quantity is a list of such per-device pieces. The three
collectives are the three small functions `halo_exchange` (one margin
copied between neighbouring devices), `psum` and `all_gather` (the pieces
brought together in shard order on the first device and, for `psum`,
summed there over the shard axis, so every cross-shard sum keeps the order
of one device's `[D, ...]` tensor). The chroma frames, the one large
intermediate (`[fps_max, 8192]` a shard, 3.7 times the shard's samples),
are gathered and transformed one shard at a time, so only one shard's
frames are alive on a device at once; the other stages run over a device's
shards in one call.

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
from ..models.analyzer import _resolve_dtype, bucket_length, resolve_devices
from ..ops.dft_kernels import ct_frames_mags, frame_dft_mags, timbral_fft
from ..ops.reductions import (
    _float_sort_key,
    _key_to_float,
    batch_free_sum,
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
# the three collectives over the shard axis: lists of per-device pieces
# ---------------------------------------------------------------------------


def halo_exchange(pieces: list):
    """`(left, right)`, each a list of `[d_i, HALO]` pieces beside the
    pieces of shards `[d_i, shard_len]`: the last samples of each shard's
    left neighbour and the first of its right neighbour, one margin copied
    across each boundary between devices; the two global edges read zeros
    (the zero padding / zero history of the unsharded path)."""
    left, right = [], []
    last = len(pieces) - 1
    for i, p in enumerate(pieces):
        before = pieces[i - 1][-1:, -HALO:].to(p.device) if i else p.new_zeros((1, HALO))
        after = pieces[i + 1][:1, :HALO].to(p.device) if i < last else p.new_zeros((1, HALO))
        left.append(torch.cat([before, p[:-1, -HALO:]]))
        right.append(torch.cat([p[1:, :HALO], after]))
    return left, right


def all_gather(pieces: list) -> torch.Tensor:
    """Every shard's piece `[d_i, ...]`, in shard order, on the first
    device: `[D, ...]`."""
    return torch.cat([p.to(pieces[0].device) for p in pieces])


def psum(pieces: list) -> torch.Tensor:
    """Sum of a per-shard quantity over all shards, on the first device, in
    the order of one device's `[D, ...]` tensor."""
    return all_gather(pieces).sum(0)


def _firsts(pieces: list) -> list:
    """The global index of each piece's first shard."""
    return np.cumsum([0] + [p.shape[0] for p in pieces[:-1]]).tolist()


# ---------------------------------------------------------------------------
# exact global selection
# ---------------------------------------------------------------------------


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone mapping of float32 to its unsigned 32-bit sort key (total
    order, IEEE), held in int64."""
    return _float_sort_key(x.to(torch.float32)).to(torch.int64) + (1 << 31)


def _global_kth_smallest(values: list, mask: list, k):
    """Exact k-th smallest masked f32 value across all shards (pieces
    `[d_i, ...]`): 32-round bisection on the float's order-isomorphic
    integer key (the signed int32 form, which orders as `_float_key` does
    and takes half its memory), one `psum` of per-shard counts a round; the
    bounds live on the first device and each round's midpoint goes to every
    device."""
    keys = [_float_sort_key(v.to(torch.float32)).reshape(v.shape[0], -1) for v in values]
    masks = [m.reshape(m.shape[0], -1) for m in mask]
    info = torch.iinfo(torch.int32)
    first = values[0].device
    lo = torch.full((), info.min, dtype=torch.int64, device=first)
    hi = torch.full((), info.max, dtype=torch.int64, device=first)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        cnt = psum([
            ((kp <= mid.to(kp.device, torch.int32)) & mp).sum(-1) for kp, mp in zip(keys, masks)
        ])
        take_low = cnt >= k + 1
        lo, hi = torch.where(take_low, lo, mid + 1), torch.where(take_low, mid, hi)
    return _key_to_float(lo, torch.float32)


def _global_median_midpoint(values: list, mask: list):
    """Midpoint median of the masked values of all shards (pieces
    `[d_i, ...]`), on the first device (ndarray-stats Midpoint semantics).
    f32 takes the counting rounds; any other dtype (the CPU's f64 chroma
    stage) one exact sort-based select over the gathered plane, the same
    value."""
    if values[0].dtype != torch.float32:
        return masked_quantile_midpoint_all(
            all_gather(values).reshape(1, -1), all_gather(mask).reshape(1, -1)
        )[0]
    n = psum([m.flatten(1).sum(-1) for m in mask])
    pos = (n - 1).to(torch.float32) * 0.5
    vlo = _global_kth_smallest(values, mask, torch.floor(pos).to(torch.int64))
    vhi = _global_kth_smallest(values, mask, torch.ceil(pos).to(torch.int64))
    return (vlo + vhi) * 0.5


# ---------------------------------------------------------------------------
# chroma
# ---------------------------------------------------------------------------


def _shard_base(first: int, count: int, shard_len: int, device) -> torch.Tensor:
    """`[count]` global position of the first sample of extended shards
    `first .. first + count - 1`."""
    return torch.arange(first, first + count, device=device) * shard_len - HALO


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


def _chroma_spectrum(ext, first, shard_len, fps_max, length, dtype, tables):
    """The chroma STFT magnitudes `[d, 4097, fps_max]` of one piece's
    extended shards `ext [d, E]` (global shards `first .. first + d - 1`)
    and the mask `[d, fps_max]` of the frames each owns that lie inside the
    song."""
    dev = ext.device
    d_count = ext.shape[0]
    d = torch.arange(first, first + d_count, device=dev)
    base = _shard_base(first, d_count, shard_len, dev)

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


def _tuning_planes(spectra: list, valids: list):
    """The tuning estimate's per-piece planes: the histogram-bin plane of
    the peaks at or above the GLOBAL median peak magnitude (the input of
    `histogram_int_plane`), and the peak mask."""
    tracks = [chroma_model.pip_track(s, v, WINDOW) for s, v in zip(spectra, valids)]
    pos = [peak & (pitches > 0.0) for pitches, _, peak in tracks]
    threshold = _global_median_midpoint([pmags for _, pmags, _ in tracks], pos)
    planes = [
        chroma_model.tuning_bin_plane(pitches, p & (pmags >= threshold.to(pmags.device)))
        for (pitches, pmags, _), p in zip(tracks, pos)
    ]
    return planes, [peak for _, _, peak in tracks]


def _chroma_raw(ext: list, shard_len, fps_max, length, dtype) -> torch.Tensor:
    """Raw `[10]` interval features of the time-sharded chroma pipeline over
    the pieces `ext` (exact cross-shard reductions; see the module
    docstring), on the first device."""
    spectra, valids = zip(*[
        _chroma_spectrum(e, f, shard_len, fps_max, length, dtype, default_tables().on(e.device))
        for e, f in zip(ext, _firsts(ext))
    ])

    # --- tuning: local peaks, global median + histogram
    bin_planes, peak_masks = _tuning_planes(spectra, valids)
    counts = psum([histogram_int_plane(bp, 100) for bp in bin_planes])
    any_peak = psum([pm.flatten(1).sum(-1) for pm in peak_masks]) > 0
    tuning = (-50.0 + torch.argmax(counts).to(dtype)) / 100.0
    tuning = torch.where(any_peak, tuning, 0.0)
    del bin_planes, peak_masks

    # --- chroma + interval features, local frames then one global mean
    sums, frames = [], []
    for spectrum, valid in zip(spectra, valids):
        tab = default_tables().on(spectrum.device)
        chroma = chroma_model.chroma_stft_from_spectrum(
            spectrum, tuning.to(spectrum.device).expand(spectrum.shape[0]), WINDOW, tab
        )
        feats = chroma_model.interval_feature_matrix(
            chroma, tab["interval_indices"]
        )  # [d, 10, fps_max]
        sums.append(batch_free_sum(torch.where(valid.unsqueeze(1), feats, 0.0)))
        frames.append(valid.sum(-1).to(dtype))
    return psum(sums) / torch.clamp(psum(frames), min=1.0)


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


def _extended_shards(signal, length: int, t: int, shards: int, devices):
    """The song as pieces `[D / len(devices), HALO + shard_len + HALO]`, one
    on each device of `devices` (contiguous shard groups), samples past
    `length` zeroed, plus `shard_len`."""
    if shards < 1:
        raise ValueError(f"shards {shards}: at least 1")
    if shards % len(devices):
        raise ValueError(f"shards {shards}: not a multiple of the {len(devices)} devices")
    shard_len, t_pad = _shard_geometry(t, shards)
    sig = _pad_signal(signal, t_pad)[:t_pad]
    per = shards // len(devices) * shard_len
    pieces = []
    for i, dev in enumerate(devices):
        part = torch.as_tensor(sig[i * per : (i + 1) * per], device=dev)
        pos = torch.arange(i * per, (i + 1) * per, device=dev)
        pieces.append(torch.where(pos < length, part, 0.0).view(-1, shard_len))
    left, right = halo_exchange(pieces)
    return [torch.cat(lpr, dim=1) for lpr in zip(left, pieces, right)], shard_len


def _postprocess_chroma(raw: torch.Tensor, version: int) -> torch.Tensor:
    post = chroma_model._postprocess_v1 if version == 1 else chroma_model._postprocess_v2
    return post(raw.unsqueeze(0))[0]


def sharded_chroma_features(
    signal: np.ndarray,
    length: int,
    version: int = 2,
    shards: int = 8,
    device=None,
    dtype=None,
    devices=None,
) -> np.ndarray:
    """Chroma features of one long `[T]` signal, time-sharded `shards`
    ways over `devices` (default: `[device]`, else every visible card).

    Any `T`: the signal is zero-padded up to a multiple of `shards` (and to
    the minimum viable shard size); padded samples and frames are masked
    out through `length`, so the result matches the unsharded chroma path.
    """
    devs = resolve_devices(devices, device)
    dtype = _resolve_dtype(devs[0], dtype)
    length = int(length)
    signal = np.asarray(signal, np.float32).reshape(-1)
    ext, shard_len = _extended_shards(signal, length, signal.shape[-1], shards, devs)
    raw = _chroma_raw(ext, shard_len, shard_len // HOP + 2, length, dtype)
    return _postprocess_chroma(raw, version).to(torch.float32).cpu().numpy()


def _tempo_series(ext: list, shard_len: int, length: int):
    """The beat tracker's inputs of the whole song from the pieces of
    halo-extended shards `ext [d_i, HALO + shard_len + HALO]`: each shard's
    thresholded novelty and silence flags, gathered to `[1, D * hps]` on
    the first device, and `h_valid [1]`."""
    hps = shard_len // B_HOP  # tempo hops per shard
    thresh, silent = [], []
    for piece in ext:
        tab = default_tables().on(piece.device)
        d_count = piece.shape[0]
        sig = piece[:, HALO : HALO + shard_len]
        right = piece[:, HALO + shard_len :]
        # Frames for hops [h0 - 7, h0 + hps): the onset needs the previous
        # frame's magnitudes, the 7-slot peak-picker window 6 more.
        mags_b = frame_dft_mags(
            piece, B_WIN, B_HOP, (7 * B_HOP + B_WIN - B_HOP) - HALO, hps + 7,
            tab["hann_512"], tab["twiddle_512"],
        )  # [d, hps + 7, 257]
        onset_loc = torch.clamp(mags_b[:, 1:] - mags_b[:, :-1], min=0.0).sum(-1)
        del mags_b  # hops [h0 - 6, h0 + hps)
        windows = torch.stack(
            [onset_loc[:, i : i + hps] for i in range(7)], dim=-1
        )  # [d, hps, 7] = onset[h-6..h]
        proc = tempo_model._filtfilt7(windows)
        thresh.append(
            proc[..., 5]
            - torch.median(proc, dim=-1).values
            - proc.mean(-1) * tempo_model._PP_THRESHOLD
        )
        # silence gate: the raw frame at hop h spans [256h, 256h + 512)
        b = (sig.reshape(d_count, hps, B_HOP) ** 2).sum(-1)
        b_next = torch.cat([b[:, 1:], (right[:, :B_HOP] ** 2).sum(-1, keepdim=True)], dim=1)
        level_b = (b + b_next) / B_WIN
        silent.append(10.0 * torch.log10(level_b) < tempo_model.SILENCE_DB)
    h_valid = torch.as_tensor([n_frames_strided(length, B_WIN, B_HOP)], device=ext[0].device)
    return all_gather(thresh).reshape(1, -1), all_gather(silent).reshape(1, -1), h_valid


def sharded_analyze_samples(
    signal: np.ndarray,
    length: int,
    version: int = 2,
    shards: int = 8,
    device=None,
    dtype=None,
    devices=None,
) -> np.ndarray:
    """Full 23-feature (20 for version 1) analysis of ONE long song,
    time-sharded `shards` ways over `devices` (default: `[device]`, else
    every visible card; `shards` a multiple of their count): the long-song
    route of `io.batch.analyze_paths_batched`. Matches `analyze_samples` to
    f32 reduction-order tolerance; every frame transform is local to a
    shard, and only halos, counts and per-frame scalar series cross shards
    (see the module docstring). The summaries run on the first device."""
    devs = resolve_devices(devices, device)
    dtype = _resolve_dtype(devs[0], dtype)
    length = int(length)
    signal = np.asarray(signal, np.float32).reshape(-1)
    t = max(int(signal.shape[-1]), length)
    # the padded length is bucketed like models.analyzer.bucket_length, so a
    # library of long songs meets O(log T) shapes, not one per song
    ext, shard_len = _extended_shards(
        signal, length, bucket_length(t, min_bucket=1 << 17), shards, devs
    )
    first = devs[0]
    tab = default_tables().on(first)
    fps_t = shard_len // T_HOP  # timbral frames per shard
    cps = shard_len // L_CHUNK  # loudness chunks per shard

    # ---- chroma (exact cross-shard reductions)
    raw_chroma = _chroma_raw(ext, shard_len, shard_len // HOP + 2, length, dtype)
    chroma = _postprocess_chroma(raw_chroma, version).to(torch.float32)

    # ---- timbral: local per-frame rows, gathered summaries. Frame
    # d*fps_t + j covers global [(d*fps_t + j)*128 - 384, ... + 512), which
    # starts at j*128 + HALO - 384 of the extended shard; shard 0's zero
    # left halo is the zero history.
    rows = []
    for e in ext:
        tab_e = default_tables().on(e.device)
        rows.append(timbral_fft(
            e, fps_t, tab_e["hann_512"], tab_e["twiddle_512"], offset=(T_WIN - T_HOP) - HALO
        ))  # [d, fps_t, 5]
    cent, roll, flat = timbral_model.frame_descriptors_from_raw(all_gather(rows))
    n_valid_t = n_frames_strided(length, T_WIN, T_HOP)
    mask_t = torch.arange(shards * fps_t, device=first) < n_valid_t
    spectral = timbral_model.summarize_spectral(
        cent.reshape(-1), roll.reshape(-1), flat.reshape(-1), mask_t
    )

    # ---- tempo: one beat tracker on the gathered series
    tempo = tempo_model.tempo_from_series(
        *_tempo_series(ext, shard_len, length), tempo_model._bt_constants(first, tab)
    )[0]

    # ---- loudness: local chunk levels, gathered summaries; zcr:
    # neighbour-sample sign changes, exact integer counts, the previous
    # sample of a shard's first from its left halo
    energy, crossings = [], []
    for e, f in zip(ext, _firsts(ext)):
        d_count = e.shape[0]
        sig = e[:, HALO : HALO + shard_len]
        energy.append((sig.reshape(d_count, cps, L_CHUNK) ** 2).sum(-1))
        prev = torch.cat([e[:, HALO - 1 : HALO], sig[:, :-1]], dim=1)
        j = torch.arange(shard_len, device=e.device)
        # global position j + start in [1, length)
        start = (torch.arange(f, f + d_count, device=e.device) * shard_len).unsqueeze(-1)
        change = ((sig > 0) != (prev > 0)) & (j >= 1 - start) & (j < length - start)
        crossings.append(change.sum(-1))
    starts = torch.arange(shards * cps, device=first) * L_CHUNK
    clen = torch.clamp(length - starts, 0, L_CHUNK)
    energy = all_gather(energy)
    level = energy.reshape(-1) / torch.clamp(clen, min=1).to(energy.dtype)
    loud = loudness_model.summarize_levels(level, clen)
    rate = psum(crossings).to(torch.float32) / float(np.float32(length))
    zcr = normalize_range(rate, 0.0, 1.0).to(torch.float32)

    out = torch.cat([tempo.reshape(1), zcr.reshape(1), spectral, loud, chroma])
    return out.to(torch.float32).cpu().numpy()
