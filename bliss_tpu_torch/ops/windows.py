"""Framing and window functions (counterpart of bliss_tpu/ops/windows.py).

Signals are `[..., T]` tensors; a batch of songs is a leading dimension.
Ragged song lengths are handled with masks over a zero-padded buffer.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _hann_np(window_length: int) -> np.ndarray:
    # Periodic Hann, computed in f32 exactly like the reference
    # (bliss-rs src/utils.rs:36-40, src/aubio.rs:151-154).
    n = np.arange(window_length, dtype=np.float32)
    return (
        np.float32(0.5)
        - np.float32(0.5)
        * np.cos(np.float32(2.0) * n * np.float32(math.pi) / np.float32(window_length))
    ).astype(np.float32)


def hann_periodic(
    window_length: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Periodic Hann window of `window_length` (f32 parity with reference)."""
    return torch.as_tensor(_hann_np(window_length), dtype=dtype, device=device)


def n_frames_strided(length, window_length: int, hop_length: int):
    """Number of complete strided windows (Rust `windows(w).step_by(h)`)."""
    return (length - window_length) // hop_length + 1


def n_frames_stft(length, hop_length: int):
    """Frame count of the reference stft (src/utils.rs:29-32)."""
    return (length - 1) // hop_length + 1


def reflect_pad(array: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis (no edge repeat), src/utils.rs:11-24."""
    prefix = array[..., 1 : pad + 1].flip(-1)
    suffix = array[..., -(pad + 1) : -1].flip(-1)
    return torch.cat([prefix, array, suffix], dim=-1)


def frame_signal(
    signal: torch.Tensor,
    window_length: int,
    hop_length: int,
    offset: int = 0,
    n_frames: int | None = None,
) -> torch.Tensor:
    """Frame `signal [..., T]` into `[..., n_frames, window_length]`.

    Frame `f` covers samples `[f*hop - offset, f*hop - offset + window)`;
    out-of-range positions read as zero (the aubio phase-vocoder sliding
    buffer, src/aubio.rs:198-212). Returns a strided view of a padded copy.
    """
    t = signal.shape[-1]
    if n_frames is None:
        n_frames = int(n_frames_strided(t, window_length, hop_length))
    tail = max((n_frames - 1) * hop_length + window_length - (t + offset), 0)
    padded = torch.nn.functional.pad(signal, (offset, tail))
    return padded.unfold(-1, window_length, hop_length)[..., :n_frames, :]


def reflect_pad_signal(
    signal: torch.Tensor, lengths, window_length: int
) -> torch.Tensor:
    """Reflect-pad `signal [B, T]` around each song's valid length.

    Row `b` becomes `reflect_pad(signal[b, :lengths[b]], window//2)`
    followed by zeros, `T + 2*(window//2) + window` samples long, so that
    frame `f` of the reference stft is `padded[b, f*hop : f*hop + window]`.
    Requires `window//2 <= length - 1` and zeros beyond each length.
    Every row's right-hand reflection is one gather and one scatter, and no
    length is read on the host: a card's work stays queued (and capturable
    in a CUDA graph).
    """
    pad = window_length // 2
    b, t = signal.shape
    padded = signal.new_zeros((b, t + 2 * pad + window_length))
    padded[:, :pad] = signal[:, 1 : pad + 1].flip(-1)
    padded[:, pad : pad + t] = signal
    n = torch.as_tensor(lengths, device=signal.device).to(torch.int64).reshape(-1, 1)
    j = torch.arange(pad, device=signal.device)
    # sample pad + n + j of the row is sample start + pad - 1 - j of the song
    start = torch.clamp(n - 1 - pad, min=0)
    tail = torch.gather(signal, 1, (start + (pad - 1) - j).expand(b, pad))
    return padded.scatter_(1, (n + pad + j).expand(b, pad), tail)


def frame_signal_reflect(
    signal: torch.Tensor,
    lengths,
    window_length: int,
    hop_length: int,
    n_frames: int,
) -> torch.Tensor:
    """Frames `[B, n_frames, window]` of the reflect-padded signal
    (reference stft, src/utils.rs:26-64)."""
    padded = reflect_pad_signal(signal, lengths, window_length)
    return padded.unfold(-1, window_length, hop_length)[:, :n_frames, :]
