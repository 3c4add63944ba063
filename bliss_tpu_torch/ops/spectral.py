"""Spectral transforms (counterpart of bliss_tpu/ops/spectral.py).

`stft` is the chroma STFT; on a CUDA tensor it runs a hand-written
kernel of `ops/dft_kernels.py`, on a CPU tensor that kernel's plain
version. The phase-vocoder helpers below are plain PyTorch on every
device: they are the building blocks of the kernels' plain versions and
of the tests, so no kernel may be reached through them.
"""

from __future__ import annotations

import torch

from .. import routes
from .windows import (
    frame_signal,
    frame_signal_reflect,
    hann_periodic,
    n_frames_stft,
    reflect_pad_signal,
)


def windowed_mags(frames: torch.Tensor, window: torch.Tensor | None = None) -> torch.Tensor:
    """Hann-windowed magnitude spectrum `[..., W] -> [..., W//2+1]` by
    `torch.fft.rfft` (the reference's f32 FFT)."""
    w = frames.shape[-1]
    if window is None:
        window = hann_periodic(w, frames.dtype, frames.device)
    return torch.abs(torch.fft.rfft(frames * window, dim=-1))


def stft(
    signal: torch.Tensor,
    window_length: int,
    hop_length: int,
    lengths=None,
    n_frames: int | None = None,
    dtype=None,
    window: torch.Tensor | None = None,
    twiddle: torch.Tensor | None = None,
    route: str = "fused",
) -> torch.Tensor:
    """Hann-windowed, reflect-padded magnitude STFT of `signal [B, T]`
    (src/utils.rs:26-64): f32 window and FFT, magnitudes optionally cast
    to `dtype`. Returns `[B, window//2 + 1, n_frames]`.

    `lengths` (per song) and `n_frames` allow masked operation over a
    padded buffer; by default the whole buffer is the song. `route`
    (`routes.CHOICES["chroma_stft"]`): `"fused"` frames the padded signal
    inside the kernel, `"framed"` writes the `[B, F, W]` frames to device
    memory first and transforms them with `ct_frames_mags`.
    """
    from . import dft_kernels

    routes.check("chroma_stft", route)
    b, t = signal.shape
    if lengths is None:
        lengths = [t] * b
    if n_frames is None:
        n_frames = int(n_frames_stft(t, hop_length))
    if route == "framed":
        frames = frame_signal_reflect(signal, lengths, window_length, hop_length, n_frames)
        # contiguous: for one song the reshape is a view of overlapping rows
        mags = dft_kernels.ct_frames_mags(
            frames.reshape(b * n_frames, window_length).contiguous(), window, twiddle
        ).unflatten(1, (b, n_frames)).permute(1, 0, 2)
    else:
        padded = reflect_pad_signal(signal, lengths, window_length)
        mags = dft_kernels.ct_stft_mags(
            padded, window_length, hop_length, n_frames, window, twiddle
        )
    if dtype is not None:
        mags = mags.to(dtype)
    return mags


def pvoc_mags(frames: torch.Tensor) -> torch.Tensor:
    """Correct 257-bin phase-vocoder magnitudes (src/aubio.rs:274-426)."""
    return windowed_mags(frames)


def _buggy_256_layout(mags: torch.Tensor, window: int) -> torch.Tensor:
    """aubio's overflow layout: drop true bin half-1, keep the Nyquist in
    its place (src/aubio.rs:237-261)."""
    half = window // 2
    return torch.cat([mags[..., : half - 1], mags[..., half:]], dim=-1)


def pvoc_mags_buggy(frames: torch.Tensor) -> torch.Tensor:
    """Buggy 256-bin phase-vocoder magnitudes (timbral PVoc)."""
    return _buggy_256_layout(windowed_mags(frames), frames.shape[-1])


def framed_pvoc_mags(
    signal: torch.Tensor,
    window: int,
    hop: int,
    offset: int,
    n_frames: int,
    buggy: bool = False,
    window_values: torch.Tensor | None = None,
) -> torch.Tensor:
    """Magnitudes of Hann-windowed strided frames of `signal [..., T]`;
    frame f covers `signal[f*hop - offset, f*hop - offset + window)`."""
    frames = frame_signal(signal, window, hop, offset, n_frames)
    mags = windowed_mags(frames, window_values)
    if buggy:
        mags = _buggy_256_layout(mags, window)
    return mags

