"""Tempo (BPM) descriptor, counterpart of bliss_tpu/models/tempo.py
(bliss-rs src/temporal.rs + src/aubio.rs:267-1450, aubio's Davies/Plumbley
beat tracker).

The per-hop stages are batched over `[B, H]`: the SpecFlux onset (one
kernel launch, `ops/dft_kernels.specflux`), the adaptive threshold and the
silence gates. The beat tracker's hypothesis machine is sequential over
blocks of 128 hops; the JAX package's `lax.scan` becomes a Python loop
over blocks whose state carries a batch axis `[B]`, with every data
dependent branch written as a `torch.where`, so the loop issues the same
work for every song; it reads one flag per block back to the host (does
any song need the rare catch-up additions of the beat phase).
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

_MAX_BEATS = 8  # beats per cycle <= step/min_bp + 2 = 7
_MAX_KMAX = 21  # kmax = floor(winlen / bp) <= floor(512 / 25) = 20
_MAX_PHASE_I = 160  # beat-phase loop bound: i < bp <= ~130


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
    g = np.float32(3.901)
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
# Beat tracking helpers, batched over leading axes
# ---------------------------------------------------------------------------


def _vec_max_elem(data: torch.Tensor) -> torch.Tensor:
    """aubio fvec_max_elem over the last axis: last occurrence of the max,
    0 when every value is negative (src/aubio.rs:787-799)."""
    n = data.shape[-1]
    last_arg = (n - 1) - torch.argmax(data.flip(-1), dim=-1)
    return torch.where(data.amax(-1) >= 0.0, last_arg, 0)


def _quad_peak_pos(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """vec_quadratic_peak_pos (src/aubio.rs:576-604) at per-row `pos`."""
    n = x.shape[-1]
    posc = torch.clamp(pos, 1, n - 2).unsqueeze(-1)
    s0 = torch.gather(x, -1, posc - 1).squeeze(-1)
    s1 = torch.gather(x, -1, posc).squeeze(-1)
    s2 = torch.gather(x, -1, posc + 1).squeeze(-1)
    interp = posc.squeeze(-1).to(torch.float32) + 0.5 * (s0 - s2) / (s0 - 2.0 * s1 + s2)
    return torch.where((pos == 0) | (pos >= n - 1), pos.to(torch.float32), interp)


def _autocorr(df: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """vec_autocorr over the last axis, `acf[i] = sum_j df[j-i] df[j] / (n-i)`
    (src/aubio.rs:819-828), as a Toeplitz matrix-vector product over row
    chunks (bounds the `[rows, n, n]` Toeplitz buffer)."""
    n = df.shape[-1]
    rows = df.reshape(-1, n)
    i = torch.arange(n, device=df.device)
    shift = (i.unsqueeze(0) - i.unsqueeze(1)) % (2 * n)  # [i, j] -> j - i
    out = []
    for lo in range(0, rows.shape[0], chunk):
        r = rows[lo : lo + chunk]
        zp = torch.nn.functional.pad(r, (0, n))  # negative shifts read zeros
        toeplitz = zp[:, shift]  # [rows, n, n]
        out.append(torch.matmul(toeplitz, r.unsqueeze(-1)).squeeze(-1))
    acf = torch.cat(out).reshape(df.shape)
    return acf / (n - torch.arange(n, dtype=df.dtype, device=df.device))


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
    acfs = _autocorr(dfframes)
    dfrevs = (dfframes * consts.dfwv).flip(-1)

    i = torch.arange(laglen, device=dev)
    interior = (i >= 1) & (i < laglen - 1)
    contribs = []
    for a in range(1, 5):
        idx = i.unsqueeze(1) * a + torch.arange(1, 2 * a, device=dev).unsqueeze(0) - 1
        valid = idx < winlen
        vals = acfs[..., torch.clamp(idx, 0, winlen - 1)]  # [B, NB, laglen, 2a-1]
        vals = torch.where(valid, vals, 0.0)
        contribs.append(vals.sum(-1) * interior)
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


def initial_beat_state(batch: int, consts: _BTConstants, device) -> dict:
    f32 = torch.float32

    def full(value, dtype=f32):
        return torch.full((batch,), value, dtype=dtype, device=device)

    return {
        "gwv": torch.zeros((batch, consts.laglen), dtype=f32, device=device),
        "phwv": torch.ones((batch, 2 * consts.laglen), dtype=f32, device=device),
        "timesig": full(0, torch.int32),
        "counter": full(0, torch.int32),
        "flagstep": full(0, torch.int32),
        "gp": full(0.0),
        "bp": full(0.0),
        "rp": full(1.0),
        "rp1": full(0.0),
        "rp2": full(0.0),
        "lastbeat": full(0.0),
    }


def _double_slow_tempi(bp: torch.Tensor) -> torch.Tensor:
    """`while 0 < bp < 25: bp *= 2` (src/aubio.rs:1216-1218), capped at 32
    doublings like the JAX package's unrolled loop. Doubling is exact, so
    the result is bp * 2^k with k the smallest count reaching 25: with
    bp = m * 2^e, m in [0.5, 1), k = 5 - e if m >= 25/32 else 6 - e."""
    m, e = torch.frexp(bp)
    k = torch.where(m >= 0.78125, 5 - e, 6 - e)
    k = torch.clamp(k, 0, 32)
    scale = ((k + 127) << 23).to(torch.int32).view(torch.float32)  # exactly 2^k
    return torch.where((bp > 0.0) & (bp < 25.0), bp * scale, bp)


def _checkstate(state: dict, xs: dict, rp: torch.Tensor, consts: _BTConstants) -> dict:
    """BeatTracking::checkstate (src/aubio.rs:1096-1227), per song."""
    laglen = consts.laglen
    step = float(consts.step)
    g_var = consts.g_var
    sel3 = state["timesig"] == 3

    comb_u = torch.where((state["timesig"] == 4).unsqueeze(-1), xs["comb_u4"], xs["comb_u3"])
    acfout = comb_u * state["gwv"]
    gp_cand = _quad_peak_pos(acfout, _vec_max_elem(acfout))
    gp = torch.where(state["gp"] > 0.0, gp_cand, 0.0)

    at_zero = state["counter"] == 0
    step_change = torch.abs(gp - rp) > float(np.float32(2.0) * np.float32(g_var))
    flagstep = torch.where(at_zero, step_change.to(torch.int32), state["flagstep"])
    counter = torch.where(at_zero & step_change, 3, state["counter"]).to(torch.int32)

    check = (counter == 1) & (flagstep == 1)
    consistent = torch.abs(2.0 * rp - state["rp1"] - state["rp2"]) < g_var
    flagconst = check & consistent
    counter = torch.where(
        check,
        torch.where(consistent, 0, 2),
        torch.where(counter > 0, counter - 1, counter),
    ).to(torch.int32)

    j2 = torch.arange(2 * laglen, dtype=torch.float32, device=rp.device)
    timesig_c = torch.where(sel3, xs["ts_if3"], xs["ts_if4"])
    gwv_c = torch.where(sel3.unsqueeze(-1), xs["gwv_if3"], xs["gwv_if4"])

    # context-dependent model: phase weights around the last beat
    lastbeat = state["lastbeat"].unsqueeze(-1)
    d2 = 1.0 + j2 - step + lastbeat
    phwv_ctx = torch.where(
        step > lastbeat,
        torch.exp(-0.5 * d2 * d2 / (gp.unsqueeze(-1) / 8.0)),
        1.0,
    )
    use_ctx = (~flagconst) & (state["timesig"] > 0)

    bp = torch.where(flagconst, rp, torch.where(use_ctx, gp, rp))
    flag2 = flagconst.unsqueeze(-1)
    phwv = torch.where(flag2, 1.0, torch.where(use_ctx.unsqueeze(-1), phwv_ctx, 1.0))
    return {
        "gwv": torch.where(flag2, gwv_c, state["gwv"]),
        "phwv": phwv,
        "timesig": torch.where(flagconst, timesig_c, state["timesig"]).to(torch.int32),
        "counter": counter,
        "flagstep": flagstep.to(torch.int32),
        "gp": torch.where(flagconst, rp, gp),
        "bp": _double_slow_tempi(bp),
        "rp": rp,
        "rp1": rp,
        "rp2": state["rp1"],
        "lastbeat": state["lastbeat"],
    }


def _bt_do(state: dict, xs: dict, consts: _BTConstants):
    """BeatTracking::do_ (src/aubio.rs:966-1092) for one block of every song.
    Returns (new_state, beats [B, 8], fired [B, 8])."""
    winlen, step = consts.winlen, float(consts.step)
    rp = torch.where(state["timesig"] == 3, xs["rp_if3"], xs["rp_if4"])
    state = _checkstate(state, xs, rp, consts)
    bp_raw = state["bp"]
    has_beats = bp_raw != 0.0
    bp = torch.where(has_beats, bp_raw, 1.0)  # keep the unused lanes finite
    dev = bp.device
    batch = bp.shape[0]

    # beat phase (src/aubio.rs:1017-1091)
    kmax = torch.floor(winlen / bp).to(torch.int32)
    k_idx = torch.arange(_MAX_KMAX, device=dev)
    i_idx = torch.arange(_MAX_PHASE_I, device=dev)
    # ROUND(x) = floor(x + 0.5) (src/aubio.rs:1038-1039)
    offs = torch.floor(bp.unsqueeze(-1) * k_idx.to(torch.float32) + 0.5).to(torch.int64)
    # phout[i] = sum over k of dfrev[i + offs_k], for i < bp, k < kmax,
    # i + offs_k < winlen
    idx = i_idx.view(1, -1, 1) + offs.unsqueeze(1)  # [B, I, K]
    ok = (
        (i_idx.to(torch.float32).view(1, -1, 1) < bp.view(-1, 1, 1))
        & (k_idx.view(1, 1, -1) < kmax.view(-1, 1, 1))
        & (idx < winlen)
    )
    vals = torch.gather(
        xs["dfrev"], 1, torch.clamp(idx, 0, winlen - 1).reshape(batch, -1)
    ).reshape(idx.shape)
    phout_head = torch.where(ok, vals, 0.0).sum(-1)
    phout = torch.nn.functional.pad(phout_head, (0, winlen - _MAX_PHASE_I))
    n_w = state["phwv"].shape[-1]  # vec_weight covers min(len, 2*laglen)
    phout = torch.cat([phout[:, :n_w] * state["phwv"], phout[:, n_w:]], dim=-1)
    maxindex = _vec_max_elem(phout)
    lastbeat = state["lastbeat"]
    phase = torch.where(
        maxindex >= winlen - 1, step - lastbeat, _quad_peak_pos(phout, maxindex)
    )
    phase = phase + 1.0

    beat = bp - phase
    skip = (step - lastbeat - phase) < (-0.40 * bp)
    beat = torch.where(skip, beat + bp, beat)
    # while beat + bp < 0: beat += bp (at most 21 additions for bp >= 25,
    # phase <= 513; the same 24-step bound as the JAX package)
    for _ in range(24):
        behind = (beat + bp < 0.0) & has_beats
        if not bool(behind.any()):
            break
        beat = torch.where(behind, beat + bp, beat)

    # emit: the first beat if beat >= 0, then while beat + bp <= step
    vals_out, fires = [], []
    first_fire = beat >= 0.0
    vals_out.append(beat)
    fires.append(first_fire)
    for _ in range(_MAX_BEATS - 1):
        more = beat + bp <= step
        beat = torch.where(more, beat + bp, beat)
        vals_out.append(beat)
        fires.append(more)
    beats = torch.stack(vals_out, dim=-1)
    fired = torch.stack(fires, dim=-1) & has_beats.unsqueeze(-1)
    beats = torch.where(has_beats.unsqueeze(-1), beats, 0.0)
    # lastbeat is the final `beat` whether or not anything was emitted
    state["lastbeat"] = torch.where(has_beats, beat, lastbeat)
    return state, beats, fired


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
    step = consts.step
    batch, h_max = thresh.shape
    dev = thresh.device
    n_blocks = max((h_max - (step - 1) - 1) // step + 1, 0)
    if n_blocks == 0:
        return torch.full((batch,), -1.0, dtype=torch.float32, device=dev)

    h_valid = h_valid.unsqueeze(-1)
    thresh_masked = torch.where(torch.arange(h_max, device=dev) < h_valid, thresh, 0.0)
    blocks = _precompute_blocks(thresh_masked, n_blocks, consts)
    state = initial_beat_state(batch, consts, dev)
    pad_silent = torch.cat(
        [silent, torch.ones((batch, step), dtype=torch.bool, device=dev)], dim=1
    )

    bpms, fires = [], []
    for k in range(n_blocks):
        hk = (step - 1) + step * k  # hop index of this beat-tracking run
        block_valid = hk < h_valid.squeeze(-1)
        xs = {name: v[:, k] for name, v in blocks.items()}
        new_state, beat_vals, beat_fires = _bt_do(state, xs, consts)
        bp = new_state["bp"]
        bpm = torch.where(
            bp != 0.0, 60.0 * sample_rate / (float(HOP_SIZE) * bp), 0.0
        )
        # a beat fires at hop hk + floor(beat) when that hop is in this
        # block, valid and not silent, and frac > 0
        # (src/aubio.rs:1419-1438, src/temporal.rs:50-57)
        beat_floor = torch.floor(beat_vals)
        frac = beat_vals - beat_floor
        hop_of_beat = hk + beat_floor.to(torch.int64)
        in_block = (beat_floor >= 0) & (beat_floor < step)
        hop_ok = hop_of_beat < h_valid
        not_silent = ~torch.gather(
            pad_silent, 1, torch.clamp(hop_of_beat, 0, h_max + step - 1)
        )
        fire = (
            beat_fires & block_valid.unsqueeze(-1) & in_block & hop_ok
            & not_silent & (frac > 0.0)
        )
        bpms.append(torch.where(fire, bpm.unsqueeze(-1), 0.0))
        fires.append(fire)
        state = {
            name: torch.where(
                block_valid.view(-1, *([1] * (new.dim() - 1))), new, state[name]
            )
            for name, new in new_state.items()
        }

    bpms = torch.cat(bpms, dim=1)
    fires = torch.cat(fires, dim=1)
    median = masked_quantile_midpoint(bpms, fires, 0.5)
    value = normalize_range(median, 0.0, MAX_BPM)
    return torch.where(fires.any(1), value, -1.0).to(torch.float32)


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
