"""DFT kernel wrappers (counterpart of bliss_tpu/ops/pallas_dft.py).

Three kernels, each with its plain PyTorch version in this module:

- `timbral_fft`  (csrc/timbral_fft.cu): per-frame timbral reductions of
  the 512/128 stream, replacing `_make_timbral_fft_kernel`;
- `specflux`     (csrc/specflux.cu): the SpecFlux onset of the 512/256
  stream, replacing `_make_specflux_kernel`;
- `ct_stft_mags` (csrc/ct_stft.cu): STFT magnitudes framed in-kernel from
  the reflect-padded signal, replacing `_make_ct_fused_kernel`.

A wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor; there is no other switch. On CUDA it checks device, dtype, shape
and contiguity, allocates the output with `torch.empty`, launches on the
current stream, counts the launch and raises on a CUDA error.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .spectral import framed_pvoc_mags, windowed_mags
from .windows import _hann_np

TIMBRAL_WINDOW, TIMBRAL_HOP, TIMBRAL_OFFSET = 512, 128, 384
TEMPO_WINDOW, TEMPO_HOP, TEMPO_OFFSET = 512, 256, 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FRAME_ARGS = [_P, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P]


@functools.lru_cache(maxsize=None)
def _constants(window: int, device: str):
    """(Hann window, [2, W/2+1] twiddles) of a power-of-two window."""
    from ..tables import twiddles

    return (
        torch.as_tensor(_hann_np(window), device=device),
        torch.as_tensor(twiddles(window), device=device),
    )


def _resolve(signal, window_len, window, twiddle):
    if window is None or twiddle is None:
        w, tw = _constants(window_len, str(signal.device))
        window = w if window is None else window
        twiddle = tw if twiddle is None else twiddle
    return window, twiddle


def _launch_frames(lib, fn_name, signal, n_frames, hop, offset, window, twiddle, out):
    dev = signal.device
    _build.require("signal", signal, torch.float32, 2, dev)
    _build.require("window", window, torch.float32, 1, dev)
    _build.require("twiddle", twiddle, torch.float32, 2, dev)
    if window.shape[0] != 512 or twiddle.shape != (2, 257):
        raise ValueError("512-point window and twiddles expected")
    fn = _build.function(lib, fn_name, _FRAME_ARGS)
    err = fn(
        _build.ptr(signal), signal.shape[0], signal.shape[1], n_frames, hop,
        offset, _build.ptr(window), _build.ptr(twiddle[0]),
        _build.ptr(twiddle[1]), _build.ptr(out), _build.stream_ptr(dev),
    )
    _build.check(lib, err)
    _build.count_launch(lib)


# --------------------------------------------------------------------------
# timbral: [B, T] -> [B, F, 5] rows (total, weighted, below, log2 sum, energy)
# --------------------------------------------------------------------------


def timbral_rows(mags: torch.Tensor) -> torch.Tensor:
    """The five per-frame reductions `[..., F, 5]` of buggy-256-bin
    magnitudes `[..., F, 256]`: total, bin-weighted total, the count of
    bins whose cumulative energy is below 95% of the frame's, log2 sum,
    energy (src/aubio.rs:16-58)."""
    bins = torch.arange(mags.shape[-1], dtype=mags.dtype, device=mags.device)
    total = mags.sum(-1)
    weighted = (mags * bins).sum(-1)
    cum = torch.cumsum(mags * mags, dim=-1)
    energy = cum[..., -1]
    below = (cum < (energy * 0.95).unsqueeze(-1)).sum(-1).to(mags.dtype)
    logsum = torch.log2(mags).sum(-1)
    return torch.stack([total, weighted, below, logsum, energy], dim=-1)


def timbral_fft_plain(
    signal: torch.Tensor, n_frames: int, window: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain version of `timbral_fft`: `torch.fft.rfft` magnitudes in the
    buggy 256-bin layout, then the five per-frame reductions."""
    return timbral_rows(
        framed_pvoc_mags(
            signal, TIMBRAL_WINDOW, TIMBRAL_HOP, TIMBRAL_OFFSET, n_frames,
            buggy=True, window_values=window,
        )
    )


def timbral_fft(
    signal: torch.Tensor,
    n_frames: int,
    window: torch.Tensor | None = None,
    twiddle: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-frame raw timbral reductions `[B, n_frames, 5]` of the 512/128
    frames of `signal [B, T]`; frame f covers `signal[128f - 384, 128f + 128)`
    with zeros outside the song."""
    window, twiddle = _resolve(signal, TIMBRAL_WINDOW, window, twiddle)
    if not _build.on_cuda(signal):
        return timbral_fft_plain(signal, n_frames, window)
    out = torch.empty(
        (signal.shape[0], n_frames, 5), dtype=torch.float32, device=signal.device
    )
    _launch_frames(
        "timbral_fft", "timbral_fft_launch", signal, n_frames, TIMBRAL_HOP,
        TIMBRAL_OFFSET, window, twiddle, out,
    )
    return out


# --------------------------------------------------------------------------
# SpecFlux: [B, T] -> [B, H] onset
# --------------------------------------------------------------------------


def onset_function(mags: torch.Tensor) -> torch.Tensor:
    """SpecFlux: per-hop sum of positive magnitude deltas against the
    previous frame (zeros before the first), `[..., H, 257] -> [..., H]`
    (src/aubio.rs:432-468)."""
    prev = torch.cat([torch.zeros_like(mags[..., :1, :]), mags[..., :-1, :]], dim=-2)
    return torch.clamp(mags - prev, min=0.0).sum(-1)


def specflux_plain(
    signal: torch.Tensor, n_frames: int, window: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain version of `specflux`: 257-bin `torch.fft.rfft` magnitudes,
    then `onset_function`."""
    return onset_function(
        framed_pvoc_mags(
            signal, TEMPO_WINDOW, TEMPO_HOP, TEMPO_OFFSET, n_frames,
            window_values=window,
        )
    )


def specflux(
    signal: torch.Tensor,
    n_frames: int,
    window: torch.Tensor | None = None,
    twiddle: torch.Tensor | None = None,
) -> torch.Tensor:
    """SpecFlux onset `[B, n_frames]` of the 512/256 frames of
    `signal [B, T]`; frame h covers `signal[256h - 256, 256h + 256)`."""
    window, twiddle = _resolve(signal, TEMPO_WINDOW, window, twiddle)
    if not _build.on_cuda(signal):
        return specflux_plain(signal, n_frames, window)
    out = torch.empty(
        (signal.shape[0], n_frames, 2), dtype=torch.float32, device=signal.device
    )
    _launch_frames(
        "specflux", "specflux_launch", signal, n_frames, TEMPO_HOP,
        TEMPO_OFFSET, window, twiddle, out,
    )
    # aubio's first frame diffs against zeros: onset[0] = total[0]
    return torch.cat([out[:, :1, 1], out[:, 1:, 0]], dim=1)


# --------------------------------------------------------------------------
# chroma STFT: padded [B, Tp] -> [B, W/2+1, F] magnitudes
# --------------------------------------------------------------------------


def ct_stft_mags_plain(
    padded: torch.Tensor,
    window_length: int,
    hop: int,
    n_frames: int,
    window: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of `ct_stft_mags`: framing by `unfold` and
    `torch.fft.rfft` magnitudes, returned as the `[B, bins, F]` view of a
    frame-major `[B, F, bins]` tensor (the kernel's layout)."""
    frames = padded.unfold(-1, window_length, hop)[:, :n_frames]
    return windowed_mags(frames, window).transpose(1, 2)


def ct_stft_mags(
    padded: torch.Tensor,
    window_length: int,
    hop: int,
    n_frames: int,
    window: torch.Tensor | None = None,
    twiddle: torch.Tensor | None = None,
) -> torch.Tensor:
    """|STFT| of `padded [B, Tp]`: frame f is `padded[:, f*hop : f*hop + W]`
    times the Hann window. Returns `[B, W//2+1, n_frames]`, a transposed
    view of frame-major storage."""
    log2w = window_length.bit_length() - 1
    if window_length != 1 << log2w or not 4 <= window_length <= 8192:
        raise ValueError(f"window {window_length}: a power of two in [4, 8192]")
    if (n_frames - 1) * hop + window_length > padded.shape[-1]:
        raise ValueError("padded signal too short for n_frames")
    window, twiddle = _resolve(padded, window_length, window, twiddle)
    if not _build.on_cuda(padded):
        return ct_stft_mags_plain(padded, window_length, hop, n_frames, window)
    dev = padded.device
    _build.require("padded", padded, torch.float32, 2, dev)
    _build.require("window", window, torch.float32, 1, dev)
    _build.require("twiddle", twiddle, torch.float32, 2, dev)
    n_bins = window_length // 2 + 1
    if window.shape[0] != window_length or twiddle.shape != (2, n_bins):
        raise ValueError("window/twiddle size does not match window_length")
    out = torch.empty(
        (padded.shape[0], n_frames, n_bins), dtype=torch.float32, device=dev
    )
    fn = _build.function("ct_stft", "ct_stft_launch", _FRAME_ARGS)
    err = fn(
        _build.ptr(padded), padded.shape[0], padded.shape[1], n_frames, hop,
        log2w, _build.ptr(window), _build.ptr(twiddle[0]),
        _build.ptr(twiddle[1]), _build.ptr(out), _build.stream_ptr(dev),
    )
    _build.check("ct_stft", err)
    _build.count_launch("ct_stft")
    return out.transpose(1, 2)
