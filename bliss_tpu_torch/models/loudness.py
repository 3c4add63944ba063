"""Loudness descriptor (mean energy -> dB), counterpart of
bliss_tpu/models/loudness.py (bliss-rs src/misc.rs:43-71)."""

from __future__ import annotations

import torch

from ..ops.reductions import masked_mean, masked_std, normalize_range

WINDOW_SIZE = 1024  # src/misc.rs:44


def summarize_levels(level: torch.Tensor, chunk_len: torch.Tensor) -> torch.Tensor:
    """Mean/std of per-chunk linear levels `[..., C]` -> normalized dB
    features `[..., 2]`."""
    mask = chunk_len > 0
    mean_value = torch.clamp(masked_mean(level, mask), min=1e-9)
    std_value = torch.clamp(masked_std(level, mask), min=1e-9)
    mean_db = 10.0 * torch.log10(mean_value)
    std_db = 10.0 * torch.log10(std_value)
    return torch.stack(
        [normalize_range(mean_db, -90.0, 0.0), normalize_range(std_db, -90.0, 0.0)],
        dim=-1,
    ).to(torch.float32)


def loudness_features(signal: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Two loudness features `[B, 2]` over `chunks(1024)` of each song,
    including the final partial chunk (src/song/mod.rs:476-484)."""
    b, t = signal.shape
    n_chunks = -(-t // WINDOW_SIZE)
    pad = n_chunks * WINDOW_SIZE - t
    signal = torch.nn.functional.pad(signal, (0, pad))
    lengths = lengths.unsqueeze(-1)
    idx = torch.arange(n_chunks, device=signal.device) * WINDOW_SIZE
    # valid samples per chunk: 1024, the remainder, then 0 past the end
    chunk_len = torch.clamp(lengths - idx, 0, WINDOW_SIZE)
    sample_idx = torch.arange(t + pad, device=signal.device)
    masked = torch.where(sample_idx < lengths, signal, 0.0).reshape(
        b, n_chunks, WINDOW_SIZE
    )
    energy = (masked * masked).sum(-1)
    level = energy / torch.clamp(chunk_len, min=1).to(signal.dtype)
    return summarize_levels(level, chunk_len)
