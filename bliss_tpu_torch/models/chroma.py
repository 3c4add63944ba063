"""Chroma / interval-feature descriptor, counterpart of
bliss_tpu/models/chroma.py (bliss-rs src/chroma.rs: librosa chroma_stft
plus the interval features of "Timbre-invariant Audio Features for Style
Analysis of Classical Music").

The 8192/2205 STFT runs in one kernel launch for the whole batch
(`ops/spectral.stft`). The tuning estimate picks its route per bucket as
the JAX package does (`chroma_features`): at f32 the fused estimator
(`tuning_peaks` lists each song's peaks in one pass over the spectrum,
`tuning_select` selects and counts them, one block a song) while the
reference's per-song plane fits its budget, else the unfused one (the
byte-radix median with `bisect8_keys`, then `histogram_int_plane`); all
are kernels of `ops/tuning_kernels.py`. At f64 (the CPU golden path)
tuning takes the unfused route with the sort-based median of the
reference.

Float discipline: FFT magnitudes are f32; everything after is carried in
`dtype` (f64 on the CPU for golden parity, f32 on the card).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..features import SAMPLE_RATE
from ..ops.reductions import (
    _float_sort_key,
    _u32_key_to_float,
    masked_mean,
    masked_quantile_midpoint_all,
)
from ..ops.spectral import stft
from ..ops.tuning_kernels import (
    histogram_int_plane,
    pip_stencil,
    tuning_bins,
    tuning_peaks,
    tuning_select,
)
from ..ops.windows import n_frames_stft
from ..tables import template_product_indices

WINDOW_SIZE = 8192  # src/chroma.rs:39
HOP_SIZE = 2205
N_CHROMA = 12

# Normalization ceilings (src/chroma.rs:47-57)
MAX_L2_INTERVAL = 0.25
MAX_L2_TRIAD = 0.025
MAX_TRIAD_INTERVAL_RATIO = math.pi / 2.0


def hz_to_octs(frequencies: torch.Tensor, tuning, bins_per_octave: int = 12):
    """Octave number of frequencies (src/utils.rs:119-129); `tuning`
    broadcasts against `frequencies`."""
    tuning = torch.as_tensor(tuning, dtype=frequencies.dtype, device=frequencies.device)
    a440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return torch.log2(frequencies / (a440 / 16.0))


def chroma_filter(n_fft: int, tuning: torch.Tensor, dtype, sample_rate: int = SAMPLE_RATE):
    """Log-frequency Gaussian chroma filterbank `[B, 12, n_fft//2 + 1]` for
    per-song `tuning [B]` (src/chroma.rs:197-267, librosa `chroma`)."""
    n_chroma = N_CHROMA
    n_chroma2 = round(n_chroma / 2.0)
    dev = tuning.device
    frequencies = torch.as_tensor(
        np.linspace(0.0, float(sample_rate), n_fft + 1), dtype=dtype, device=dev
    )
    freq_bins = n_chroma * hz_to_octs(
        frequencies, tuning.to(dtype).unsqueeze(-1), n_chroma
    )  # [B, n_fft+1]
    freq_bins = torch.cat(
        [freq_bins[:, 1:2] - 1.5 * n_chroma, freq_bins[:, 1:]], dim=1
    )
    diff = freq_bins[:, 1:] - freq_bins[:, :-1]
    binwidth = torch.cat(
        [torch.clamp(diff, min=1.0), torch.ones_like(diff[:, :1])], dim=1
    )
    d = freq_bins.unsqueeze(1) - torch.arange(n_chroma, dtype=dtype, device=dev).view(1, -1, 1)
    d = torch.remainder(d + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    d = d / binwidth.unsqueeze(1)
    wts = torch.exp(-0.5 * (2.0 * d) * (2.0 * d))
    # L2-normalize columns (src/chroma.rs:240-247)
    norm = torch.sqrt((wts * wts).sum(1, keepdim=True))
    norm = torch.where(norm < torch.finfo(dtype).tiny, 1.0, norm)
    wts = wts / norm
    ctroct, octwidth = 5.0, 2.0
    octweight = torch.exp(-0.5 * ((freq_bins / n_chroma - ctroct) / octwidth) ** 2)
    wts = wts * octweight.unsqueeze(1)
    wts = torch.roll(wts, -3, dims=1)
    return wts[:, :, : 1 + n_fft // 2]


@functools.lru_cache(maxsize=None)
def _pitch_band(n_fft: int, sample_rate: int = SAMPLE_RATE):
    """Static [fmin, fmax) bin range for pip_track (src/chroma.rs:275-287)."""
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    fmax = min(4000.0, sample_rate / 2.0)
    band = (fft_freqs >= 150.0) & (fft_freqs < fmax)
    beginning = int(np.argmax(band))
    end = int(len(band) - 1 - np.argmax(band[::-1]))
    return beginning, end


def peak_band(n_fft: int):
    """pip_track's stencil rows for `n_fft`: `(first, rows, hz_per_bin)`,
    row `i` being spectrum bin `first + 1 + i` (the band's interior)."""
    beginning, end = _pitch_band(n_fft)
    return beginning, end - beginning - 3, SAMPLE_RATE / n_fft


def _pip_stencil(spec_fm: torch.Tensor, n_fft: int):
    """The pip_track stencil over a FRAME-MAJOR spectrum `[B, F, bins]`:
    `(pitches, mags, is_peak)`, each `[B, F, rows]`, over `peak_band`'s
    rows (`ops/tuning_kernels.py:pip_stencil`, contiguous when `spec_fm`
    is, as `stft` makes it)."""
    return pip_stencil(spec_fm, *peak_band(n_fft))


def pip_track(spectrum: torch.Tensor, frame_mask: torch.Tensor, n_fft: int):
    """Parabolic-interpolated spectral peaks (src/chroma.rs:269-331).
    `spectrum` is `[B, bins, F]`; returns `(pitches, mags, mask)`, each
    `[B, rows, F]`, views of `_pip_stencil`'s `[B, F, rows]` tensors."""
    pitches, mags, is_peak = _pip_stencil(spectrum.transpose(1, 2), n_fft)
    mask = is_peak & frame_mask.unsqueeze(-1)
    return pitches.transpose(1, 2), mags.transpose(1, 2), mask.transpose(1, 2)


def _tuning_from_counts(counts: torch.Tensor, any_sel: torch.Tensor, resolution: float, dtype):
    max_index = torch.argmax(counts, dim=-1)
    tuning = (-50.0 + (100.0 * resolution * max_index.to(dtype))) / 100.0
    return torch.where(any_sel, tuning, 0.0)


def pitch_tuning(
    frequencies: torch.Tensor,
    mask: torch.Tensor,
    resolution: float = 0.01,
    bins_per_octave: int = 12,
):
    """Histogram-mode tuning offset `[B]` in [-0.5, 0.5) of the masked
    frequencies of each song; an empty selection yields 0.0. The mask is
    folded into the sentinel bin `n_bins`, which `histogram_int_plane`
    ignores (bliss_tpu/models/chroma.py:261-276)."""
    n_bins = int(round(1.0 / resolution))
    idx_m = tuning_bin_plane(frequencies, mask, resolution, bins_per_octave)
    counts = histogram_int_plane(idx_m, n_bins)
    return _tuning_from_counts(counts, counts.sum(1) > 0, resolution, frequencies.dtype)


def tuning_bin_plane(frequencies, mask, resolution: float = 0.01, bins_per_octave: int = 12):
    """The int32 plane `histogram_int_plane` counts: each selected positive
    frequency's tuning bin, the sentinel `n_bins` elsewhere."""
    n_bins = int(round(1.0 / resolution))
    sel = mask & (frequencies > 0.0)
    idx = tuning_bins(frequencies, resolution, bins_per_octave)
    return torch.where(sel, idx, n_bins).to(torch.int32).contiguous()


def estimate_tuning(
    spectrum: torch.Tensor,
    frame_mask: torch.Tensor,
    n_fft: int,
    resolution: float = 0.01,
    bins_per_octave: int = 12,
):
    """Tuning offset `[B]` from a magnitude spectrogram `[B, bins, F]`
    (src/chroma.rs:361-391), the unfused route: the masked median of the
    peak magnitudes (`bisect8_keys` through the radix select on a CUDA f32
    tensor, a sort otherwise), then the histogram of the peaks above it."""
    # the median and the histogram take a song's elements in any order, so
    # the stage stays on the stencil's frame-major `[B, F, rows]` tensors.
    # The select reads its planes in place and refuses a strided one:
    # `.contiguous()` copies nothing for a spectrum made by `stft` (see
    # `_pip_stencil`), and puts any other layout in order here, in the open.
    pitches, mags, is_peak = _pip_stencil(spectrum.transpose(1, 2), n_fft)
    peak_mask = is_peak & frame_mask.unsqueeze(-1)
    pos_mask = (peak_mask & (pitches > 0.0)).contiguous()
    mags = mags.contiguous()
    threshold = masked_quantile_midpoint_all(mags, pos_mask, 0.5)
    sel = pos_mask & (mags >= threshold.view(-1, 1, 1))
    tuning = pitch_tuning(pitches, sel, resolution, bins_per_octave)
    return torch.where(peak_mask.flatten(1).any(1), tuning, 0.0)


#: The JAX package's budget for the fused estimator's per-song i16 plane
#: (bliss_tpu/models/chroma.py:441); buckets above it take the unfused route.
FUSED_PLANE_BUDGET = 12 << 20


def _fused_plane_bytes(n_frames: int, n_fft: int) -> int:
    """Tile-padded i16 plane of the fused estimator for one song of
    `n_frames` frames: rows padded to 32, columns to 128, 2 bytes each
    (bliss_tpu/models/chroma.py:_fused_plane_bytes)."""
    rows = peak_band(n_fft)[1]
    return (-(-rows // 32) * 32) * (-(-n_frames // 128) * 128) * 2


def uses_fused_tuning(n_frames: int, dtype) -> bool:
    """Whether a bucket of `n_frames` chroma frames per song is tuned by
    the fused estimator: f32 and within the reference's plane budget."""
    return (
        dtype == torch.float32
        and _fused_plane_bytes(n_frames, WINDOW_SIZE) <= FUSED_PLANE_BUDGET
    )


def tuning_planes(
    spectrum: torch.Tensor,
    frame_mask: torch.Tensor,
    n_fft: int,
    resolution: float = 0.01,
    bins_per_octave: int = 12,
) -> dict:
    """The TPU route's single stencil sweep over an f32 spectrum
    `[B, bins, F]`: three contiguous frame-major `[B, F, rows]` planes,
    the i32 order-isomorphic keys of the peak magnitudes (`skey`, INT32_MAX
    where excluded), the int8 tuning bin (`idx8`, n_bins + 1 where
    excluded) and the top 16 key bits (`plane_hi`), plus the midpoint
    median's floor/ceil ranks `ks [B, 2]`. With `level2_plane`,
    `threshold_key` and the plain TPU contracts of `ops/tuning_kernels.py`
    it is the plain composition `tuning_peaks` and `tuning_select` are held
    against; no path of the port runs it."""
    n_bins = int(round(1.0 / resolution))
    spec_fm = spectrum.transpose(1, 2)  # frame-major: the kernel's storage
    pitches, mags, is_peak = _pip_stencil(spec_fm, n_fft)
    pos = is_peak & frame_mask.unsqueeze(-1) & (pitches > 0.0)

    int_max = torch.iinfo(torch.int32).max  # the key of an excluded element
    skey = torch.where(pos, _float_sort_key(mags), int_max).contiguous()
    idx = tuning_bins(pitches, resolution, bins_per_octave)
    idx8 = torch.where(pos, idx, n_bins + 1).to(torch.int8).contiguous()
    n = pos.flatten(1).sum(1).to(torch.int32)
    # midpoint ranks, as in masked_quantile_midpoint
    posk = (n - 1).to(torch.float32) * 0.5
    kf = torch.clamp(torch.floor(posk).to(torch.int32), min=0)
    kc = torch.clamp(torch.ceil(posk).to(torch.int32), min=0)
    return {
        "skey": skey,
        "idx8": idx8,
        "plane_hi": (skey >> 16).to(torch.int16).contiguous(),
        "ks": torch.stack([kf, kc], dim=1).contiguous(),
    }


def level2_plane(skey: torch.Tensor, ks: torch.Tensor, o1: torch.Tensor):
    """The low-16-bit plane of rank f's bucket, the remaining ranks inside
    it, and the minimum low half of rank c's bucket (when the ranks
    straddle a bucket boundary the ceil rank is that minimum)."""
    b = skey.shape[0]
    b_f, b_c = o1[:, 0], o1[:, 1]
    rem = torch.clamp(ks - o1[:, 2:4], min=0).to(torch.int32).contiguous()
    hi16 = (skey >> 16) + 32768
    lo16 = skey & 0xFFFF
    plane_lo = (
        torch.where(hi16 == b_f.view(b, 1, 1), lo16, 0xFFFF) - 32768
    ).to(torch.int16).contiguous()
    min_c = torch.where(hi16 == b_c.view(b, 1, 1), lo16, 0xFFFF).flatten(1).amin(1)
    return plane_lo, rem, min_c


def threshold_key(o1, o2, min_c, dtype) -> torch.Tensor:
    """i32 key `[B]` of the midpoint median t = (x_f + x_c) / 2 assembled
    from both levels; keys order floats except -0.0 < +0.0, so t == 0.0
    takes -0.0's key and `key >= tk` keeps float `>=` semantics."""
    b_f, b_c = o1[:, 0], o1[:, 1]
    v_lo_c = torch.where(b_f == b_c, o2[:, 1], min_c)
    key_f = (b_f.to(torch.int64) << 16) | o2[:, 0].to(torch.int64)
    key_c = (b_c.to(torch.int64) << 16) | v_lo_c.to(torch.int64)
    t = (_u32_key_to_float(key_f, dtype) + _u32_key_to_float(key_c, dtype)) * 0.5
    return torch.where(t == 0.0, -1, _float_sort_key(t)).to(torch.int32).contiguous()


def _estimate_tuning_fused(
    spectrum: torch.Tensor,
    frame_mask: torch.Tensor,
    n_fft: int,
    resolution: float = 0.01,
    bins_per_octave: int = 12,
):
    """Tuning offset `[B]` of an f32 spectrum `[B, bins, F]`
    (bliss_tpu/models/chroma.py:_estimate_tuning_fused): the same estimate
    -> threshold -> histogram semantics and the same integer counts as
    `estimate_tuning`, bit for bit. `tuning_peaks` lists each song's peaks
    (sort key, tuning bin) in one pass over the frame-major storage behind
    `spectrum` (on the card it must be that storage, as `stft` makes it);
    `tuning_select` selects the midpoint median's floor/ceil ranks in key
    space and counts the tuning bins of the peaks at or above it. The TPU
    route's planes (`tuning_planes`, `level2_plane`, `threshold_key`) stay
    as the plain composition the kernels are held against.
    """
    n_bins = int(round(1.0 / resolution))
    keys, bins, n = tuning_peaks(
        spectrum.transpose(1, 2), frame_mask, *peak_band(n_fft), resolution, bins_per_octave
    )
    counts = tuning_select(keys, bins, n, n_bins)["counts"]
    return _tuning_from_counts(counts, counts.sum(1) > 0, resolution, spectrum.dtype)


def _song_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b`, one product a song of the leading axis: cuBLAS picks its
    kernel by the batch's size too, so a batched product would round a
    song otherwise in a batch of another size."""
    if a.dim() == 2:
        return torch.matmul(a, b)
    out = a.new_empty((*a.shape[:-1], b.shape[-1]))
    for x, y, o in zip(a, b, out):
        torch.matmul(x, y, out=o)
    return out


def _compensated_matmul(a: torch.Tensor, b: torch.Tensor, chunk: int = 512):
    """`a @ b` with the K axis split into chunks whose partial products are
    combined with Neumaier compensation (f32 only): the f32 accumulation
    error over K ~ 4097 would otherwise be amplified ~15x by the exp(15x)
    sharpening downstream. Each product is a song's alone
    (`_song_products`)."""
    k = a.shape[-1]
    if a.dtype == torch.float64 or k <= chunk:
        return _song_products(a, b)
    s = _song_products(a[..., :chunk], b[..., :chunk, :])
    comp = torch.zeros_like(s)
    for lo in range(chunk, k, chunk):
        hi = min(lo + chunk, k)
        p = _song_products(a[..., lo:hi], b[..., lo:hi, :])
        t = s + p
        comp = comp + torch.where(torch.abs(s) >= torch.abs(p), (s - t) + p, (p - t) + s)
        s = t
    return s + comp


def chroma_stft_from_spectrum(
    spectrum: torch.Tensor, tuning: torch.Tensor, n_fft: int, tables: dict | None = None
) -> torch.Tensor:
    """L1-normalized chromagram `[B, 12, F]` from |STFT| `[B, bins, F]`
    (src/chroma.rs:393-412)."""
    dtype = spectrum.dtype
    power = spectrum * spectrum
    if dtype == torch.float32:
        # exact host-f64 filter, selected by tuning bin
        from ..tables import default_tables

        table = (tables or default_tables().on(spectrum.device))["chroma_filter"]
        tuning_idx = torch.clamp(
            torch.round(tuning * 100.0 + 50.0).to(torch.int64), 0, 99
        )
        filt = table[tuning_idx].to(torch.float32)
    else:
        filt = chroma_filter(n_fft, tuning, dtype)
    raw = _compensated_matmul(filt, power)
    colsum = torch.abs(raw).sum(1, keepdim=True)
    colsum = torch.where(colsum < torch.finfo(dtype).tiny, 1.0, colsum)
    return raw / colsum


def normalize_feature_sequence(feature: torch.Tensor) -> torch.Tensor:
    """Per-column L1 normalization with small-sum guard (src/chroma.rs:177-188)."""
    colsum = torch.abs(feature).sum(-2, keepdim=True)
    colsum = torch.where(colsum < 1e-4, 1.0, colsum)
    return feature / colsum


def extract_interval_features(chroma: torch.Tensor, indices: torch.Tensor | None = None):
    """`[B, 10, F]` product-of-powers over the rolled template bank
    (src/chroma.rs:157-175) as direct products: each rolled template
    activates only 2-3 pitch classes."""
    if indices is None:
        indices = torch.as_tensor(template_product_indices(), device=chroma.device)
    idx = indices.to(torch.int64)
    ext = torch.cat([chroma, torch.ones_like(chroma[:, :1])], dim=1)  # row 12 = 1
    p = ext[:, idx[:, 0]] * ext[:, idx[:, 1]] * ext[:, idx[:, 2]]  # [B, 120, F]
    return p.reshape(p.shape[0], 10, 12, -1).sum(2)


def interval_feature_matrix(chroma: torch.Tensor, indices=None) -> torch.Tensor:
    """exp(15x)-sharpened, L1-normalized interval features
    (src/chroma.rs:137-153)."""
    return extract_interval_features(
        normalize_feature_sequence(torch.exp(15.0 * chroma)), indices
    )


def chroma_interval_features(chroma, frame_mask, indices=None) -> torch.Tensor:
    """Mean interval features over valid frames -> `[B, 10]`."""
    feats = interval_feature_matrix(chroma, indices)
    return masked_mean(feats, frame_mask.unsqueeze(1), dim=-1)


def _postprocess_v2(raw: torch.Tensor) -> torch.Tensor:
    """Version2 normalization of the 10 raw features -> 13
    (ChromaDesc::get_values, src/chroma.rs:97-126)."""
    f32 = torch.float32
    ic = raw[:, :6]
    triads = raw[:, 6:]
    l2_ic = torch.sqrt((ic * ic).sum(-1, keepdim=True))
    l2_tri = torch.sqrt((triads * triads).sum(-1, keepdim=True))
    ic = torch.where(l2_ic > 0.0, ic / l2_ic, ic)
    triads = torch.where(l2_tri > 0.0, triads / l2_tri, triads)
    normalized = 2.0 * torch.cat([ic, triads], dim=-1).to(f32) - 1.0
    f11 = torch.clamp(2.0 * l2_ic.to(f32) / MAX_L2_INTERVAL - 1.0, max=1.0)
    f12 = torch.clamp(2.0 * l2_tri.to(f32) / MAX_L2_TRIAD - 1.0, max=1.0)
    angle = torch.atan2(20.0 * l2_tri, l2_ic + 1e-12)
    f13 = 2.0 * angle.to(f32) / MAX_TRIAD_INTERVAL_RATIO - 1.0
    return torch.cat([normalized, f11, f12, f13], dim=-1)


def _postprocess_v1(raw: torch.Tensor) -> torch.Tensor:
    """Version1 scaling (src/chroma.rs:128-132)."""
    return (2.0 * raw.to(torch.float32) / 0.12 - 1.0).to(torch.float32)


def chroma_features(
    signal: torch.Tensor,
    lengths: torch.Tensor,
    version: int = 2,
    dtype=torch.float64,
    tables: dict | None = None,
    stft_route: str = "fused",
) -> torch.Tensor:
    """Full chroma descriptor `[B, T] -> [B, 13]` (v2) or `[B, 10]` (v1)
    (ChromaDesc::do_ + get_values, src/chroma.rs:73-126); `stft_route`
    is `ops.spectral.stft`'s `route`."""
    t = signal.shape[-1]
    n_frames_max = int(n_frames_stft(t, HOP_SIZE))
    n_valid = n_frames_stft(lengths, HOP_SIZE)
    frame_mask = torch.arange(n_frames_max, device=signal.device) < n_valid.unsqueeze(-1)
    window = tables["hann_8192"] if tables else None
    twiddle = tables["twiddle_8192"] if tables else None
    spectrum = stft(
        signal, WINDOW_SIZE, HOP_SIZE, lengths=lengths, n_frames=n_frames_max,
        dtype=dtype, window=window, twiddle=twiddle, route=stft_route,
    )  # [B, 4097, F]
    if uses_fused_tuning(n_frames_max, dtype):
        tuning = _estimate_tuning_fused(spectrum, frame_mask, WINDOW_SIZE)
    else:
        tuning = estimate_tuning(spectrum, frame_mask, WINDOW_SIZE)
    chroma = chroma_stft_from_spectrum(spectrum, tuning, WINDOW_SIZE, tables)
    indices = tables["interval_indices"] if tables else None
    raw = chroma_interval_features(chroma, frame_mask, indices)
    if version == 1:
        return _postprocess_v1(raw)
    return _postprocess_v2(raw)
