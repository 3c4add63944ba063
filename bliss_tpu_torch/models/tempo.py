"""Tempo (BPM) descriptor, counterpart of bliss_tpu/models/tempo.py
(bliss-rs src/temporal.rs + src/aubio.rs:267-1450, aubio's Davies/Plumbley
beat tracker).

The per-hop stages are batched over `[B, H]`: the SpecFlux onset (one
kernel launch, `ops/dft_kernels.specflux`), the adaptive threshold and the
silence gates. The beat tracker runs in three parts, as the JAX package's
`lax.scan` splits its carry from its outputs: the per-block quantities
that do not depend on the hypothesis state, batched over `[B, NB]`
(`_precompute_blocks`, its autocorrelation one kernel launch,
`ops/tempo_kernels.autocorr`); the sequential state machine over blocks of 128
hops (`ops/tempo_kernels.beat_track`: one kernel launch on the card, a
loop over blocks on the CPU); and the per-beat firing and the median BPM,
batched over `[B, NB, 8]` (`_tempo_from_beats`), which feed nothing back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import routes
from ..ops.dft_kernels import (  # noqa: F401 (re-export)
    TEMPO_OFFSET,
    frame_dft_mags,
    onset_function,
    specflux,
)
from ..ops.reductions import masked_quantile_midpoint, normalize_range
from ..ops.tempo_kernels import (  # noqa: F401 (re-export)
    G_VAR,
    _double_slow_tempi,
    _quad_peak_pos,
    _vec_max_elem,
    autocorr,
    beat_track,
)
from ..ops.windows import frame_signal, n_frames_strided
from ..tables import beat_weights, bt_rayparam, tempo_geometry

WINDOW_SIZE = 512  # src/temporal.rs:40
HOP_SIZE = WINDOW_SIZE // 2  # 256
MAX_BPM = 206.0  # src/temporal.rs:80-85
SILENCE_DB = -90.0

# PeakPicker constants (src/aubio.rs:707-727), as exact f32 values
_PP_THRESHOLD = float(np.float32(0.3))  # src/aubio.rs:1347
_BIQUAD = tuple(
    float(np.float32(v)) for v in (0.1599879, 0.31997577, 0.1599879, 0.23484048, 0.0)
)
_BUF = 7  # win_post(5) + win_pre(1) + 1


class _BTConstants(NamedTuple):
    winlen: int
    step: int
    laglen: int
    rayparam_trunc: float
    rwv: torch.Tensor  # [laglen] f32
    dfwv: torch.Tensor  # [winlen] f32
    g_var: float  # f32 value
    g_var2: float  # f32(g_var * g_var)


def _bt_constants(device, tables: dict | None = None, sample_rate: int = 22050):
    """Static constants of BeatTracking::new (src/aubio.rs:909-962)."""
    winlen, step = tempo_geometry(sample_rate)
    if tables is None:
        rwv, dfwv = (torch.as_tensor(a, device=device) for a in beat_weights(sample_rate))
    else:
        rwv, dfwv = tables["bt_rwv"], tables["bt_dfwv"]
    g = np.float32(G_VAR)
    return _BTConstants(
        winlen, step, winlen // 4, bt_rayparam(sample_rate)[1], rwv, dfwv,
        float(g), float(g * g),
    )


# ---------------------------------------------------------------------------
# Parallel stages
# ---------------------------------------------------------------------------


def _filtfilt7(windows: torch.Tensor) -> torch.Tensor:
    """Zero-phase biquad over each 7-sample window `[..., 7]`, in the exact
    forward/mirror/backward float order of Biquad::do_filtfilt
    (src/aubio.rs:659-686)."""
    b0, b1, b2, a1, a2 = _BIQUAD

    def one_pass(x):
        ys = []
        zero = torch.zeros_like(x[..., 0])
        y1 = y2 = x1 = x2 = zero
        for i in range(_BUF):
            x0 = x[..., i]
            y0 = b0 * x0 + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            ys.append(y0)
            x2, x1 = x1, x0
            y2, y1 = y1, y0
        return torch.stack(ys, dim=-1)

    fwd = one_pass(windows)
    return one_pass(fwd.flip(-1)).flip(-1)


def thresholded_series(onset: torch.Tensor) -> torch.Tensor:
    """Adaptive-threshold novelty per hop `[B, H]` (PeakPicker::do_,
    src/aubio.rs:733-768): filtfilt over the last 7 onsets, then
    `proc[5] - median(proc) - mean(proc) * threshold`."""
    h = onset.shape[-1]
    padded = torch.nn.functional.pad(onset, (_BUF - 1, 0))
    windows = torch.stack([padded[..., i : i + h] for i in range(_BUF)], dim=-1)
    proc = _filtfilt7(windows)
    mean = proc.mean(-1)
    median = torch.median(proc, dim=-1).values  # odd length: the middle element
    return proc[..., 5] - median - mean * _PP_THRESHOLD


def silence_flags_blocked(signal: torch.Tensor, h_max: int) -> torch.Tensor:
    """Per-hop `is_silence` `[B, H]` over the raw 512-sample window at hop h,
    `[256h, 256h + 512)` (src/aubio.rs:1258-1276): two 256-sample block
    energies per hop instead of a framed copy."""
    need = (h_max + 1) * HOP_SIZE
    t = signal.shape[-1]
    if t < need:
        signal = torch.nn.functional.pad(signal, (0, need - t))
    b = (signal[..., :need].reshape(*signal.shape[:-1], -1, HOP_SIZE) ** 2).sum(-1)
    level = (b[..., :h_max] + b[..., 1 : h_max + 1]) / WINDOW_SIZE
    return 10.0 * torch.log10(level) < SILENCE_DB


# ---------------------------------------------------------------------------
# Beat tracking: the block inputs, the state machine, the firing
# ---------------------------------------------------------------------------


def _get_timesig(acf: torch.Tensor, gp_int: torch.Tensor) -> torch.Tensor:
    """Time-signature estimate from the autocorrelation (src/aubio.rs:864-907)."""
    n = acf.shape[-1]
    k = torch.arange(-2, 2, device=acf.device)
    gp = gp_int.unsqueeze(-1)

    def gather(mult):
        idx = mult * gp + k
        ok = (idx >= 0) & (idx < n)
        vals = torch.gather(acf, -1, torch.clamp(idx, 0, n - 1))
        return torch.where(ok, vals, 0.0), ok

    a3, ok3 = gather(3)
    a6, ok6 = gather(6)
    a4, ok4 = gather(4)
    a2, ok2 = gather(2)
    in_range = n > 6 * gp_int + 2
    three_small = a3.sum(-1)
    four_small = a4.sum(-1)
    three_big = (torch.where(ok3, a3, 0.0) + torch.where(ok3 & ok6, a6, 0.0)).sum(-1)
    four_big = (torch.where(ok4, a4, 0.0) + torch.where(ok4 & ok2, a2, 0.0)).sum(-1)
    three = torch.where(in_range, three_small, three_big)
    four = torch.where(in_range, four_small, four_big)
    timesig = torch.where(three > four, 3, 4).to(torch.int32)
    return torch.where(gp_int < 2, 4, timesig).to(torch.int32)


def _precompute_blocks(thresh_masked: torch.Tensor, n_blocks: int, consts: _BTConstants):
    """Per-block quantities that do not depend on the hypothesis state,
    batched over `[B, NB]` (see bliss_tpu/models/tempo.py BlockInputs)."""
    winlen, step, laglen = consts.winlen, consts.step, consts.laglen
    dev = thresh_masked.device
    # the detection-function buffer at run k is a strided window of the
    # thresholded series (src/aubio.rs:1389-1416)
    dfframes = frame_signal(
        thresh_masked, winlen, step, offset=winlen - step + 1, n_frames=n_blocks
    )  # [B, NB, winlen]
    acfs = autocorr(dfframes.contiguous())  # [B, NB, winlen]
    dfrevs = (dfframes * consts.dfwv).flip(-1)

    i = torch.arange(laglen, device=dev)
    interior = (i >= 1) & (i < laglen - 1)
    contribs = []
    for a in range(1, 5):
        idx = i.unsqueeze(1) * a + torch.arange(1, 2 * a, device=dev).unsqueeze(0) - 1
        valid = idx < winlen
        vals = acfs[..., torch.clamp(idx, 0, winlen - 1)]  # [B, NB, laglen, 2a-1]
        vals = torch.where(valid, vals, 0.0)
        total = torch.zeros_like(vals[..., 0])
        for t in range(2 * a - 1):  # from 0, left to right, as XLA's reduce adds
            total = total + vals[..., t]
        contribs.append(total * interior)
    c1, c2, c3, c4 = contribs
    w = [float(np.float32(1.0 / (2 * a - 1))) for a in range(1, 5)]
    comb_w3 = c1 * w[0] + c2 * w[1] + c3 * w[2]
    comb_w4 = comb_w3 + c4 * w[3]
    comb_u3 = c1 + c2 + c3
    comb_u4 = comb_u3 + c4

    def rp_of(comb_w):
        rayacf = comb_w * consts.rwv
        maxindex = _vec_max_elem(rayacf)
        interp = _quad_peak_pos(rayacf, maxindex)
        return torch.where(
            (maxindex > 0) & (maxindex < laglen - 1), interp, consts.rayparam_trunc
        )

    rp4 = rp_of(comb_w4)
    rp3 = rp_of(comb_w3)
    j = torch.arange(laglen, dtype=torch.float32, device=dev)

    def gwv_of(rp):
        diff = (j + 1.0) - rp.unsqueeze(-1)
        return torch.exp(-0.5 * diff * diff / consts.g_var2)

    return {
        "dfrev": dfrevs,
        "rp_if4": rp4,
        "rp_if3": rp3,
        "ts_if4": _get_timesig(acfs, rp4.to(torch.int32)),
        "ts_if3": _get_timesig(acfs, rp3.to(torch.int32)),
        "gwv_if4": gwv_of(rp4),
        "gwv_if3": gwv_of(rp3),
        "comb_u3": comb_u3,
        "comb_u4": comb_u4,
    }


def beat_track_inputs(thresh: torch.Tensor, h_valid: torch.Tensor, consts: _BTConstants):
    """The state machine's inputs from the thresholded novelty `thresh
    [B, H]` (hops >= `h_valid [B]` masked): the block inputs `[B, NB, ...]`
    and each song's count of valid blocks, int32 `[B]`. Block k runs at
    hop 127 + 128 k, valid while that hop is below `h_valid`, so the valid
    blocks are the first `h_valid // 128`."""
    step = consts.step
    batch, h_max = thresh.shape
    dev = thresh.device
    n_blocks = (h_max - step) // step + 1
    h_valid = torch.as_tensor(h_valid, device=dev)
    thresh_masked = torch.where(
        torch.arange(h_max, device=dev) < h_valid.unsqueeze(-1), thresh, 0.0
    )
    blocks = _precompute_blocks(thresh_masked, n_blocks, consts)
    n_valid = torch.clamp(h_valid // step, 0, n_blocks).to(torch.int32)
    return blocks, n_valid


def _tempo_from_beats(
    bp: torch.Tensor,
    beats: torch.Tensor,
    fired: torch.Tensor,
    silent: torch.Tensor,
    h_valid: torch.Tensor,
    step: int,
    sample_rate: int = 22050,
) -> torch.Tensor:
    """Median BPM `[B]` from the state machine's outputs (`bp [B, NB]`,
    `beats` and `fired [B, NB, 8]`): a beat fires at hop hk + floor(beat)
    when that hop is in its block, valid and not silent, and frac > 0
    (src/aubio.rs:1419-1438, src/temporal.rs:50-57); -1 without one."""
    batch, h_max = silent.shape
    dev = bp.device
    h_valid = torch.as_tensor(h_valid, device=dev)
    pad_silent = torch.cat(
        [silent, torch.ones((batch, step), dtype=torch.bool, device=dev)], dim=1
    )
    hk = (step - 1) + step * torch.arange(bp.shape[1], device=dev).view(1, -1, 1)
    # 60 sr / (256 bp) rounded once, as the JAX package divides: a Python
    # number over a tensor is PyTorch's reciprocal-then-product, two roundings
    bpm = torch.where(
        bp != 0.0, torch.full_like(bp, 60.0 * sample_rate) / (float(HOP_SIZE) * bp), 0.0
    )
    beat_floor = torch.floor(beats)
    frac = beats - beat_floor
    hop_of_beat = hk + beat_floor.to(torch.int64)  # [B, NB, 8]
    in_block = (beat_floor >= 0) & (beat_floor < step)
    hop_ok = hop_of_beat < h_valid.view(-1, 1, 1)
    not_silent = ~torch.gather(
        pad_silent, 1, torch.clamp(hop_of_beat, 0, h_max + step - 1).reshape(batch, -1)
    ).reshape(hop_of_beat.shape)
    fire = fired & in_block & hop_ok & not_silent & (frac > 0.0)
    bpms = torch.where(fire, bpm.unsqueeze(-1), 0.0).reshape(batch, -1)
    fires = fire.reshape(batch, -1)
    median = masked_quantile_midpoint(bpms, fires, 0.5)
    value = normalize_range(median, 0.0, MAX_BPM)
    return torch.where(fires.any(1), value, -1.0).to(torch.float32)


def tempo_from_series(
    thresh: torch.Tensor,
    silent: torch.Tensor,
    h_valid: torch.Tensor,
    consts: _BTConstants,
    sample_rate: int = 22050,
) -> torch.Tensor:
    """Beat tracking + median BPM `[B]` from the thresholded novelty
    `thresh [B, H]` and silence flags `silent [B, H]`; hops >= `h_valid`
    are masked."""
    if thresh.shape[1] < consts.step:  # not one block
        return torch.full((thresh.shape[0],), -1.0, dtype=torch.float32, device=thresh.device)
    blocks, n_valid = beat_track_inputs(thresh, h_valid, consts)
    bp, beats, fired = beat_track(blocks, n_valid)
    return _tempo_from_beats(bp, beats, fired, silent, h_valid, consts.step, sample_rate)


def tempo_feature(
    signal: torch.Tensor,
    lengths: torch.Tensor,
    tables: dict | None = None,
    sample_rate: int = 22050,
    route: str = "fused",
) -> torch.Tensor:
    """Full tempo pipeline `[B, T] -> [B]`: normalized median BPM
    (BPMDesc, src/temporal.rs:32-85); `route` picks the onset's kernel
    (`routes.CHOICES["tempo"]`)."""
    routes.check("tempo", route)
    t = signal.shape[-1]
    h_max = int(n_frames_strided(t, WINDOW_SIZE, HOP_SIZE))
    h_valid = n_frames_strided(lengths, WINDOW_SIZE, HOP_SIZE)
    window = tables["hann_512"] if tables else None
    twiddle = tables["twiddle_512"] if tables else None
    if route == "mags":
        onset = onset_function(
            frame_dft_mags(signal, WINDOW_SIZE, HOP_SIZE, TEMPO_OFFSET, h_max, window, twiddle)
        )
    else:
        onset = specflux(signal, h_max, window, twiddle)  # [B, H]
    thresh = thresholded_series(onset)
    silent = silence_flags_blocked(signal, h_max)
    consts = _bt_constants(signal.device, tables, sample_rate)
    return tempo_from_series(thresh, silent, h_valid, consts, sample_rate)
