"""DFT kernel wrappers (counterpart of bliss_tpu/ops/pallas_dft.py).

Six kernels, each with its plain PyTorch version in this module:

- `timbral_fft`  (csrc/timbral_fft.cu): per-frame timbral reductions of
  the 512/128 stream, replacing `_make_timbral_fft_kernel`;
- `specflux`     (csrc/specflux.cu): the SpecFlux onset of the 512/256
  stream, replacing `_make_specflux_kernel`;
- `ct_stft_mags` (csrc/ct_stft.cu): STFT magnitudes framed in-kernel from
  the reflect-padded signal, replacing `_make_ct_fused_kernel`;
- `ct_frames_mags` (csrc/ct_stft.cu): the same transform over pre-framed
  `[N, W]` input, replacing `_make_ct_kernel` (both run one block FFT of
  16 x 16 x 16 over the 4096 complex points of W = 8192, `ct8192_kernel`,
  the only width on the card);
- `frame_dft_mags` (csrc/frame_dft.cu): DFT magnitudes of the 512-sample
  strided frames of a signal by a warp-level FFT, replacing `_make_kernel`;
- `timbral_flat` (csrc/timbral_flat.cu): the timbral reductions of a
  direct (matrix-product) DFT of the same frames with Neumaier-compensated
  chunk sums, on the tensor cores (wgmma, six bf16 products, one twiddle
  block for the four chunks), replacing `_make_timbral_kernel`.

`timbral_fft`, `specflux` and `frame_dft_mags` are three epilogues of one
staged tile loop (csrc/frame_tiles.cuh) around a 512-point FFT a warp.

A wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor; there is no other switch. On CUDA it checks device, dtype, shape
and contiguity, allocates the output with `torch.empty`, launches on the
current stream, counts the launch and raises on a CUDA error.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref

import torch

from . import _build
from .spectral import framed_pvoc_mags, windowed_mags
from .windows import _hann_np, frame_signal

TIMBRAL_WINDOW, TIMBRAL_HOP, TIMBRAL_OFFSET = 512, 128, 384
TEMPO_WINDOW, TEMPO_HOP, TEMPO_OFFSET = 512, 256, 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FRAME_ARGS = [_P, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P]
_CT_ARGS = [_P, _I, _L, _I, _I, _P, _P, _P, _P, _P]


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


def _launch_frames(
    lib, fn_name, signal, n_frames, hop, offset, window, twiddle, out, counted=None
):
    """Launch one of the 512-point strided-frame kernels of `csrc/<lib>.cu`
    and count it under `counted` (the library's name by default)."""
    dev = signal.device
    _build.require("signal", signal, torch.float32, 2, dev)
    _build.require("window", window, torch.float32, 1, dev)
    _build.require("twiddle", twiddle, torch.float32, 2, dev)
    if window.shape[0] != 512 or twiddle.shape != (2, 257):
        raise ValueError("512-point window and twiddles expected")
    _build.launch(
        counted or lib, _build.function(lib, fn_name, _FRAME_ARGS), dev,
        _build.ptr(signal), signal.shape[0], signal.shape[1], n_frames, hop,
        offset, _build.ptr(window), _build.ptr(twiddle[0]),
        _build.ptr(twiddle[1]), _build.ptr(out),
    )


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
    signal: torch.Tensor,
    n_frames: int,
    window: torch.Tensor | None = None,
    offset: int = TIMBRAL_OFFSET,
) -> torch.Tensor:
    """Plain version of `timbral_fft`: `torch.fft.rfft` magnitudes in the
    buggy 256-bin layout, then the five per-frame reductions."""
    return timbral_rows(
        framed_pvoc_mags(
            signal, TIMBRAL_WINDOW, TIMBRAL_HOP, offset, n_frames,
            buggy=True, window_values=window,
        )
    )


def timbral_fft(
    signal: torch.Tensor,
    n_frames: int,
    window: torch.Tensor | None = None,
    twiddle: torch.Tensor | None = None,
    offset: int = TIMBRAL_OFFSET,
) -> torch.Tensor:
    """Per-frame raw timbral reductions `[B, n_frames, 5]` of the 512/128
    frames of `signal [B, T]`; frame f covers `signal[128f - offset, 128f -
    offset + 512)` with zeros outside the buffer. The default offset gives
    the song's own frames `[128f - 384, 128f + 128)`; a halo-extended shard
    passes the (negative) offset of its first frame."""
    window, twiddle = _resolve(signal, TIMBRAL_WINDOW, window, twiddle)
    if not _build.on_cuda(signal):
        return timbral_fft_plain(signal, n_frames, window, offset)
    out = torch.empty(
        (signal.shape[0], n_frames, 5), dtype=torch.float32, device=signal.device
    )
    _launch_frames(
        "timbral_fft", "timbral_fft_launch", signal, n_frames, TIMBRAL_HOP,
        offset, window, twiddle, out,
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
    view of frame-major storage. On the card an f32 FFT of W = 8192 only,
    a 16 x 16 x 16 block FFT (csrc/ct_stft.cu `ct8192_kernel`); the plain
    version takes any width."""
    log2w = window_length.bit_length() - 1
    if window_length != 1 << log2w or not 4 <= window_length <= 8192:
        raise ValueError(f"window {window_length}: a power of two in [4, 8192]")
    if (n_frames - 1) * hop + window_length > padded.shape[-1]:
        raise ValueError("padded signal too short for n_frames")
    window, twiddle = _resolve(padded, window_length, window, twiddle)
    if not _build.on_cuda(padded):
        return ct_stft_mags_plain(padded, window_length, hop, n_frames, window)
    if window_length != 8192:
        raise ValueError(f"window {window_length}: the card's kernel takes 8192 only")
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
    fn = _build.function("ct_stft", "ct_stft_launch", _CT_ARGS)
    _build.launch(
        "ct_stft", fn, dev, _build.ptr(padded), padded.shape[0], padded.shape[1], n_frames,
        hop, _build.ptr(window), _build.ptr(twiddle[0]), _build.ptr(twiddle[1]),
        _build.ptr(out),
    )
    return out.transpose(1, 2)


def ct_frames_mags_plain(
    frames: torch.Tensor, window: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain version of `ct_frames_mags`: `torch.fft.rfft` magnitudes of
    the windowed rows, returned as the `[bins, N]` view."""
    return windowed_mags(frames, window).transpose(0, 1)


def ct_frames_mags(
    frames: torch.Tensor,
    window: torch.Tensor | None = None,
    twiddle: torch.Tensor | None = None,
) -> torch.Tensor:
    """|rDFT| of the Hann-windowed rows of pre-framed `frames [N, W]`, W a
    power of two in [4, 8192], on the card 8192 only. Returns `[W//2+1, N]`,
    a transposed view of frame-major storage, as `ct_stft_mags` does."""
    if frames.dim() != 2:
        raise ValueError(f"frames: expected [N, W], got shape {tuple(frames.shape)}")
    n, window_length = frames.shape
    log2w = window_length.bit_length() - 1
    if window_length != 1 << log2w or not 4 <= window_length <= 8192:
        raise ValueError(f"window {window_length}: a power of two in [4, 8192]")
    window, twiddle = _resolve(frames, window_length, window, twiddle)
    if not _build.on_cuda(frames):
        return ct_frames_mags_plain(frames, window)
    if window_length != 8192:
        raise ValueError(f"window {window_length}: the card's kernel takes 8192 only")
    dev = frames.device
    _build.require("frames", frames, torch.float32, 2, dev)
    _build.require("window", window, torch.float32, 1, dev)
    _build.require("twiddle", twiddle, torch.float32, 2, dev)
    n_bins = window_length // 2 + 1
    if window.shape[0] != window_length or twiddle.shape != (2, n_bins):
        raise ValueError("window/twiddle size does not match the frame width")
    out = torch.empty((n, n_bins), dtype=torch.float32, device=dev)
    fn = _build.function("ct_stft", "ct_frames_launch", [_P, _I, _P, _P, _P, _P, _P])
    _build.launch(
        "ct_frames", fn, dev, _build.ptr(frames), n, _build.ptr(window),
        _build.ptr(twiddle[0]), _build.ptr(twiddle[1]), _build.ptr(out),
    )
    return out.transpose(0, 1)


# --------------------------------------------------------------------------
# 512-sample strided frames: FFT magnitudes, and the direct-DFT flat timbral rows
# --------------------------------------------------------------------------


def frame_dft_mags_plain(
    signal: torch.Tensor,
    hop: int,
    offset: int,
    n_frames: int,
    window: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of `frame_dft_mags`: `framed_pvoc_mags` (framing by
    `unfold`, `torch.fft.rfft`)."""
    return framed_pvoc_mags(
        signal, TEMPO_WINDOW, hop, offset, n_frames, window_values=window
    )


def frame_dft_mags(
    signal: torch.Tensor,
    window_length: int,
    hop: int,
    offset: int,
    n_frames: int,
    window: torch.Tensor | None = None,
    twiddle: torch.Tensor | None = None,
) -> torch.Tensor:
    """Hann-windowed |DFT| `[B, n_frames, 257]` of the 512-sample strided
    frames of `signal [B, T]`; frame f covers `signal[f*hop - offset, f*hop
    - offset + 512)` with zeros before 0 and past `T`. `hop` is a multiple
    of 4 up to 256 (the analysis uses 128 and 256); `offset` may be
    negative (a halo-extended shard). On the card an f32 FFT, one frame a
    warp (csrc/fft_common.cuh `warp_rfft512_mags`)."""
    if window_length != TEMPO_WINDOW:
        raise ValueError(f"window {window_length}: the kernel is written for 512")
    if hop <= 0 or hop > 256 or hop % 4:
        raise ValueError(f"hop {hop}: a multiple of 4 in (0, 256]")
    window, twiddle = _resolve(signal, window_length, window, twiddle)
    if not _build.on_cuda(signal):
        return frame_dft_mags_plain(signal, hop, offset, n_frames, window)
    out = torch.empty(
        (signal.shape[0], n_frames, window_length // 2 + 1),
        dtype=torch.float32, device=signal.device,
    )
    _launch_frames(
        "frame_dft", "frame_dft_mags_launch", signal, n_frames, hop, offset,
        window, twiddle, out, counted="frame_dft_mags",
    )
    return out


def _flat_dft_matrices(twiddle: torch.Tensor):
    """`[512, 256]` cos and -sin matrices of the flat timbral DFT in the
    buggy layout (column 255 carries the Nyquist phase), looked up by the
    integer phase `(n*k) mod 512` in the `[2, 257]` twiddle table
    (bliss_tpu/ops/pallas_dft.py:464-471)."""
    w = TIMBRAL_WINDOW
    dev = twiddle.device
    cos_t = torch.cat([twiddle[0], twiddle[0][1 : w // 2].flip(0)])
    sin_t = torch.cat([twiddle[1], -twiddle[1][1 : w // 2].flip(0)])
    n = torch.arange(w, device=dev).unsqueeze(1)
    k = torch.arange(w // 2, device=dev)
    k = torch.where(k == w // 2 - 1, w // 2, k).unsqueeze(0)
    phase = (n * k) % w
    return cos_t[phase], sin_t[phase]


def timbral_flat_plain(
    signal: torch.Tensor,
    n_frames: int,
    window: torch.Tensor | None = None,
    twiddle: torch.Tensor | None = None,
    chunk_frames: int = 1 << 16,
) -> torch.Tensor:
    """Plain version of `timbral_flat`: per 128-sample chunk of a frame one
    f32 `torch.matmul` with the chunk's rows of the DFT matrices, the four
    partial sums combined with the Neumaier step of
    bliss_tpu/ops/pallas_dft.py:118-123, then `timbral_rows`; blocks of
    `chunk_frames` frames bound the framed copy."""
    window, twiddle = _resolve(signal, TIMBRAL_WINDOW, window, twiddle)
    cos_m, sin_m = _flat_dft_matrices(twiddle)
    width = TIMBRAL_HOP
    frames = frame_signal(signal, TIMBRAL_WINDOW, TIMBRAL_HOP, TIMBRAL_OFFSET, n_frames)

    def comp_add(s, comp, p):
        t = s + p
        comp = comp + torch.where(torch.abs(s) >= torch.abs(p), (s - t) + p, (p - t) + s)
        return t, comp

    rows = []
    for lo in range(0, n_frames, chunk_frames):
        block = frames[:, lo : lo + chunk_frames] * window
        re = im = re_c = im_c = block.new_zeros(())
        for c in range(TIMBRAL_WINDOW // width):
            piece = block[..., c * width : (c + 1) * width]
            re, re_c = comp_add(re, re_c, torch.matmul(piece, cos_m[c * width : (c + 1) * width]))
            im, im_c = comp_add(im, im_c, torch.matmul(piece, sin_m[c * width : (c + 1) * width]))
        re, im = re + re_c, im + im_c
        rows.append(timbral_rows(torch.sqrt(re * re + im * im)))
    return torch.cat(rows, dim=1)


def timbral_flat_f64(
    signal: torch.Tensor,
    n_frames: int,
    window: torch.Tensor | None = None,
    block: int = 16384,
) -> torch.Tensor:
    """Rows `[B, n_frames, 5]` (f64) of an f64 DFT of the same f32 windowed
    512/128 frames that `timbral_flat` and its plain version transform: the
    truth their log2 sums are held to (`timbral_flat_held`)."""
    window, _ = _resolve(signal, TIMBRAL_WINDOW, window, None)
    rows = []
    for lo in range(0, n_frames, block):
        fr = frame_signal(signal, TIMBRAL_WINDOW, TIMBRAL_HOP,
                          TIMBRAL_OFFSET - TIMBRAL_HOP * lo, min(block, n_frames - lo))
        m = torch.fft.rfft((fr * window).double(), dim=-1).abs()
        rows.append(timbral_rows(torch.cat([m[..., :255], m[..., 256:]], -1)))
    return torch.cat(rows, 1)


def geo_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-frame distance of the geometric means exp2(log2 sum / 256) that
    two sets of rows give, |d log2 sum| * ln 2 / 256 (relative); 0 where
    either is not finite."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    both = torch.isfinite(a[..., 3]) & torch.isfinite(b[..., 3])
    return torch.where(both, (a[..., 3] - b[..., 3]).abs(), 0.0) * (math.log(2.0) / 256)


#: `timbral_flat`'s limits. Against the plain version: total, weighted and
#: energy within relative 1e-5, `below` within +-1 (ties on the 95% energy
#: line), non-finite entries equal. The log2 sum weighs every near-silent
#: bin, where any two f32 products of different order disagree (the plain
#: version's worst frame of chip_smoke.py's batch sits 8.8e-3 from the f64
#: DFT), so it is held to `timbral_flat_f64`: averaged over the frames, the
#: per-frame geometric-mean distance at most 2e-7 above the plain version's;
#: on the worst frame within 1e-5 or no farther than the plain version's
#: worst. On 8 x 5-min noise songs (H100) the kernel reads 1.0e-7 above the
#: plain version, its bf16x3 control 5.6e-7 and one accumulator a chunk
#: 6.3e-7.
FLAT_REL, FLAT_BELOW, FLAT_GEO_EXCESS, FLAT_GEO_WORST = 1e-5, 1, 2e-7, 1e-5


def timbral_flat_held(got, want, exact) -> tuple[dict, list[str]]:
    """`timbral_flat`'s rows `got` held to the plain version's `want` and
    the f64 DFT's `exact` at the limits above: (readings, broken limits)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    fin = torch.isfinite(want)
    same = torch.equal(fin, torch.isfinite(got)) and torch.equal(got[~fin], want[~fin])
    diff = torch.where(fin, (got - want).abs(), 0.0)
    scale = torch.where(fin, want.abs(), 0.0).clamp(min=1e-30)
    r = {
        "rel": max((diff[..., c] / scale[..., c]).max().item() for c in (0, 1, 4)),
        "below": diff[..., 2].max().item(),
        "abs": diff[..., [0, 1, 4]].max().item(),
    }
    for key, a, b in (("plain", got, want), ("f64", got, exact), ("plain_f64", want, exact)):
        gap = geo_gap(a, b)
        r[f"geo_{key}_max"], r[f"geo_{key}_mean"] = gap.max().item(), gap.mean().item()
    broken = []
    if not same:
        broken.append("non-finite entries differ from the plain version's")
    if r["rel"] > FLAT_REL:
        broken.append(f"relative {r['rel']:.3g} (limit {FLAT_REL:g})")
    if r["below"] > FLAT_BELOW:
        broken.append(f"below {r['below']:g} (limit {FLAT_BELOW})")
    mean_limit = r["geo_plain_f64_mean"] + FLAT_GEO_EXCESS
    if r["geo_f64_mean"] > mean_limit:
        broken.append(f"mean geo_mean distance to f64 {r['geo_f64_mean']:.3g} (limit {mean_limit:.3g})")
    worst_limit = max(FLAT_GEO_WORST, r["geo_plain_f64_max"])
    if r["geo_f64_max"] > worst_limit:
        broken.append(f"worst geo_mean distance to f64 {r['geo_f64_max']:.3g} (limit {worst_limit:.3g})")
    return r, broken


#: `_flat_twiddle_block` of each twiddle tensor a caller passed, built once
#: (keyed by id: a tensor's `==` is elementwise), dropped with the tensor.
#: The analyzer's tables and `_constants` keep one tensor a device, so every
#: call of the route after the first finds its block here.
_FLAT_BLOCKS: dict[int, tuple] = {}


def _flat_block(twiddle: torch.Tensor) -> torch.Tensor:
    """`_flat_twiddle_block(twiddle)`, cached by the tensor (and built
    again if it was written in place since)."""
    key = id(twiddle)
    hit = _FLAT_BLOCKS.get(key)
    if hit is None or hit[0]() is not twiddle:
        hit = None
        weakref.finalize(twiddle, _FLAT_BLOCKS.pop, key, None)
    if hit is None or hit[1] != twiddle._version:
        hit = (weakref.ref(twiddle), twiddle._version, _flat_twiddle_block(twiddle))
        _FLAT_BLOCKS[key] = hit
    return hit[2]


def _flat_twiddle_block(twiddle: torch.Tensor) -> torch.Tensor:
    """The flat kernel's B operand: rows n < 128 of `_flat_dft_matrices`
    (chunk 0; chunk c's rows are these turned by (-i)^(ck)), the cos and
    -sin columns of a slot side by side (`[128, 512]`), split into three
    bf16 pieces (each rounded to nearest from the f32 residual of the ones
    before) and laid out as the kernel streams it: for each 32-column
    N-tile and 32-row k-stage the three pieces' no-swizzle K-major tiles,
    8 x 8 core matrices with k fastest (384 KB, bf16)."""
    cos_m, sin_m = _flat_dft_matrices(twiddle)
    w = TIMBRAL_HOP
    rest = torch.stack([cos_m[:w], sin_m[:w]], dim=-1).reshape(w, 2 * cos_m.shape[1])
    pieces = []
    for _ in range(3):
        piece = rest.to(torch.bfloat16)
        pieces.append(piece)
        rest = rest - piece.float()
    # [piece, k-stage, k core, k in core, N-tile, n core, n in core]
    tiles = torch.stack(pieces).reshape(3, 4, 4, 8, 16, 4, 8)
    return tiles.permute(4, 1, 0, 2, 5, 6, 3).contiguous()


def timbral_flat(
    signal: torch.Tensor,
    n_frames: int,
    window: torch.Tensor | None = None,
    twiddle: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-frame raw timbral reductions `[B, n_frames, 5]` of the 512/128
    frames of `signal [B, T]` from a direct DFT (not an FFT): the
    counterpart of the JAX package's flat kernel. On the card the product
    runs on the tensor cores at no less than f32 precision (six bf16
    products, as the TPU's `Precision.HIGHEST`). Its flatness sits farther
    from the f32-FFT reference than `timbral_fft`'s on quiet content, so
    it is not the default route."""
    window, twiddle = _resolve(signal, TIMBRAL_WINDOW, window, twiddle)
    if not _build.on_cuda(signal):
        return timbral_flat_plain(signal, n_frames, window, twiddle)
    dev = signal.device
    _build.require("signal", signal, torch.float32, 2, dev)
    _build.require("window", window, torch.float32, 1, dev)
    _build.require("twiddle", twiddle, torch.float32, 2, dev)
    if window.shape[0] != TIMBRAL_WINDOW or twiddle.shape != (2, 257):
        raise ValueError("512-point window and twiddles expected")
    bmat = _flat_block(twiddle)
    out = torch.empty((signal.shape[0], n_frames, 5), dtype=torch.float32, device=dev)
    fn = _build.function("timbral_flat", "timbral_flat_launch", [_P, _I, _L, _I, _I, _I, _P, _P, _P, _P])
    _build.launch(
        "timbral_flat", fn, dev, _build.ptr(signal), signal.shape[0], signal.shape[1],
        n_frames, TIMBRAL_HOP, TIMBRAL_OFFSET, _build.ptr(window), _build.ptr(bmat),
        _build.ptr(out),
    )
    return out
