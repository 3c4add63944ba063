"""Timbral descriptors: spectral centroid / rolloff / flatness + ZCR
(counterpart of bliss_tpu/models/timbral.py; bliss-rs src/timbral.rs and
src/aubio.rs:16-265).

All 512/128 frames of a batch of songs go through one kernel launch that
emits per-frame raw reductions (`ops/dft_kernels.timbral_fft`, or the
kernel of another route of `routes.CHOICES["timbral"]`); the descriptors
and their masked summaries are elementwise work on `[B, F]`.
"""

from __future__ import annotations

import torch

from .. import routes
from ..features import SAMPLE_RATE
from ..ops.dft_kernels import (
    TIMBRAL_OFFSET,
    frame_dft_mags,
    timbral_fft,
    timbral_flat,
    timbral_rows,
)
from ..ops.reductions import (
    masked_mean,
    masked_std,
    normalize_range,
    zero_crossing_count,
)
from ..ops.spectral import _buggy_256_layout, framed_pvoc_mags
from ..ops.windows import n_frames_strided

WINDOW_SIZE = 512  # src/timbral.rs:40
HOP_SIZE = WINDOW_SIZE // 4  # 128, src/timbral.rs:41
N_BINS = WINDOW_SIZE // 2


def spectral_frame_mags(signal: torch.Tensor, n_frames: int) -> torch.Tensor:
    """`[B, n_frames, 256]` buggy pvoc magnitudes of the 512/128 stream
    (the frame at hop h spans `[128h - 384, 128h + 128)`)."""
    return framed_pvoc_mags(
        signal, WINDOW_SIZE, HOP_SIZE, offset=TIMBRAL_OFFSET,
        n_frames=n_frames, buggy=True,
    )


def frame_descriptors_from_raw(raw: torch.Tensor):
    """Per-frame (centroid_hz, rolloff_hz, flatness) from the kernel's
    `[..., F, 5]` rows (total, weighted, below, log2 sum, energy): the
    aubio per-frame math (src/aubio.rs:16-58, src/timbral.rs:196-208), as
    in the fused branch of bliss_tpu/models/timbral.py:118-147."""
    total, weighted, below, logsum, energy = raw.unbind(-1)
    geo = torch.exp2(logsum / N_BINS)
    arith = total / N_BINS
    centroid_bin = torch.where(total == 0.0, 0.0, weighted / total)
    centroid_hz = centroid_bin * (SAMPLE_RATE / WINDOW_SIZE)
    roll_bin = torch.where(energy == 0.0, 0.0, below + 1.0).to(energy.dtype)
    # aubio PR#318 workaround (src/timbral.rs:185-187)
    roll_bin = torch.clamp(roll_bin, max=WINDOW_SIZE / 2.0)
    rolloff_hz = roll_bin * (SAMPLE_RATE / WINDOW_SIZE)
    flatness = torch.where(
        geo == 0.0, 0.0, geo / torch.where(arith == 0.0, 1.0, arith)
    )
    return centroid_hz, rolloff_hz, flatness


def frame_descriptors_from_mags(mags: torch.Tensor):
    """Per-frame descriptors from buggy-256-bin magnitudes `[..., F, 256]`."""
    return frame_descriptors_from_raw(timbral_rows(mags))


def summarize_spectral(centroid_hz, rolloff_hz, flatness, mask) -> torch.Tensor:
    """Normalized mean+std summaries of the three per-frame series over the
    last axis (SpectralDesc getters, src/timbral.rs:57-122) -> `[..., 6]`."""
    half_sr = SAMPLE_RATE / 2.0
    feats = [
        normalize_range(masked_mean(centroid_hz, mask), 0.0, half_sr),
        normalize_range(masked_std(centroid_hz, mask), 0.0, half_sr),
        normalize_range(masked_mean(rolloff_hz, mask), 0.0, half_sr),
        normalize_range(masked_std(rolloff_hz, mask), 0.0, half_sr),
        normalize_range(masked_mean(flatness, mask), 0.0, 1.0),
        normalize_range(masked_std(flatness, mask), 0.0, 1.0),
    ]
    return torch.stack(feats, dim=-1).to(torch.float32)


def spectral_features(
    signal: torch.Tensor,
    lengths: torch.Tensor,
    tables: dict | None = None,
    route: str = "fft",
) -> torch.Tensor:
    """Six timbral features `[B, 6]` of `signal [B, T]` (valid `lengths`);
    `route` picks the kernel (`routes.CHOICES["timbral"]`)."""
    routes.check("timbral", route)
    t = signal.shape[-1]
    n_frames_max = int(n_frames_strided(t, WINDOW_SIZE, HOP_SIZE))
    n_valid = n_frames_strided(lengths, WINDOW_SIZE, HOP_SIZE)
    mask = torch.arange(n_frames_max, device=signal.device) < n_valid.unsqueeze(-1)
    window = tables["hann_512"] if tables else None
    twiddle = tables["twiddle_512"] if tables else None
    if route == "mags":
        mags = frame_dft_mags(
            signal, WINDOW_SIZE, HOP_SIZE, TIMBRAL_OFFSET, n_frames_max, window, twiddle
        )  # [B, F, 257]
        raw = timbral_rows(_buggy_256_layout(mags, WINDOW_SIZE))
    elif route == "flat":
        raw = timbral_flat(signal, n_frames_max, window, twiddle)
    else:
        raw = timbral_fft(signal, n_frames_max, window, twiddle)  # [B, F, 5]
    centroid_hz, rolloff_hz, flatness = frame_descriptors_from_raw(raw)
    return summarize_spectral(centroid_hz, rolloff_hz, flatness, mask)


def zcr_feature(signal: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero-crossing rate over each song, normalized (src/timbral.rs:231-258)."""
    crossings = zero_crossing_count(signal, lengths)
    rate = crossings.to(torch.float32) / lengths.to(torch.float32)
    return normalize_range(rate, 0.0, 1.0).to(torch.float32)
