"""The beat tracker's hypothesis machine (counterpart of the `lax.scan`
over `_bt_do`/`_checkstate` in bliss_tpu/models/tempo.py, aubio's
BeatTracking::do_ and ::checkstate, src/aubio.rs:966-1227).

`beat_track` walks every block of every song through the sequential state
machine: on a CUDA tensor one launch of csrc/beat_track.cu (a warp a song,
every block step on the card), on a CPU tensor `beat_track_plain`, a loop
over blocks whose state carries a batch axis `[B]`, with every data
dependent branch written as a `torch.where`. Its inputs are the per-block
quantities that do not depend on the state (`models/tempo.py:
_precompute_blocks`); what it returns feeds the per-beat firing and the
median there.

Every step of the plain version rounds on its own, as eager PyTorch does
on every device, and its one multi-term sum (the beat phase's `phout`,
over the comb's 21 lags) runs left to right: the kernel repeats that
arithmetic op for op, so the two agree bit for bit on the card.

`autocorr` is the block inputs' autocorrelation (the JAX package's
`_autocorr`, an XLA matmul): on a CUDA tensor one launch of
csrc/autocorr.cu, on a CPU tensor `autocorr_plain`. Both sum each lag in
the order XLA's CPU backend compiles that matmul into, so the port's
block inputs equal the JAX package's bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

WINLEN = 512  # detection-function buffer (models/tempo.py:tempo_geometry at 22.05 kHz)
STEP = WINLEN // 4  # hops between two runs of the tracker
LAGLEN = WINLEN // 4
G_VAR = float(np.float32(3.901))  # src/aubio.rs:956

MAX_BEATS = 8  # beats per cycle <= step/min_bp + 2 = 7
MAX_KMAX = 21  # kmax = floor(winlen / bp) <= floor(512 / 25) = 20
MAX_PHASE_I = 160  # beat-phase loop bound: i < bp <= ~130
CATCH_UP = 24  # `while beat + bp < 0` additions, bounded as the JAX package bounds them

#: The per-block inputs, `[B, NB, width]` (width 1 dropped): f32 but the
#: two time signatures (int32).
BLOCK_WIDTHS = {
    "dfrev": WINLEN, "comb_u3": LAGLEN, "comb_u4": LAGLEN,
    "gwv_if3": LAGLEN, "gwv_if4": LAGLEN,
    "rp_if3": 1, "rp_if4": 1, "ts_if3": 1, "ts_if4": 1,
}

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The autocorrelation's partial sums per lag: XLA's CPU dot in 256-bit
#: vectors, 8 f32 lanes.
ACF_LANES = 8


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`fmaf(a, b, c)` of f32 tensors, rounded once. The f64 product of two
    f32 values is exact; their f64 sum with `c` is made round-to-odd (nudged
    one f64 ulp toward TwoSum's error when inexact and even), so the cast
    to f32 rounds the exact value once and not twice."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - c64
    err = (c64 - (s - bb)) + (p - bb)
    bits = s.view(torch.int64)
    nudge = (err != 0.0) & ((bits & 1) == 0) & torch.isfinite(s)
    away = (err > 0.0) == (s > 0.0)  # toward err: up in magnitude when signs agree
    bits = torch.where(nudge, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).to(torch.float32)


def autocorr_plain(df: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """vec_autocorr over the last axis (src/aubio.rs:819-828),
    `acf[i] = sum_{j >= i} df[j-i] df[j] / (n - i)`, in the order of XLA's
    CPU dot for the JAX package's `_autocorr`: 8 partial sums, partial w
    takes the terms j = w (mod 8) in increasing j, each a fused multiply-add
    rounded once; then ((p0+p1)+(p2+p3))+((p4+p5)+(p6+p7)) and one division.
    The terms j < i, which XLA adds as zero products, are skipped: they come
    first in each partial, while it is still +0, and +0 + +-0 is +0 (with
    an inf or NaN at j < i, XLA's 0 * inf would be NaN; aubio's own loop
    skips them too). Other dtypes (the CPU's f64 path) add in the
    same order without the single rounding. Rows in chunks of `chunk`."""
    n = df.shape[-1]
    rows = df.reshape(-1, n)
    dev = df.device
    fma = _fma_f32 if df.dtype == torch.float32 else (lambda a, b, c: c + a * b)
    lag = torch.arange(n, device=dev).unsqueeze(1)  # [n, 1]
    lane = torch.arange(ACF_LANES, device=dev)  # [8]
    out = []
    for lo in range(0, rows.shape[0], chunk):
        r = rows[lo : lo + chunk]
        p = torch.zeros((r.shape[0], n, ACF_LANES), dtype=df.dtype, device=dev)
        for m in range(-(-n // ACF_LANES)):
            j = m * ACF_LANES + lane  # [8]
            top = min(n, (m + 1) * ACF_LANES)  # lags past j take no term
            shift = j - lag[:top]  # [top, 8]: j - i
            take = (shift >= 0) & (j < n)
            a = r[:, torch.clamp(shift, 0, n - 1)]  # [R, top, 8]: df[j - i]
            b = r[:, torch.clamp(j, max=n - 1)].unsqueeze(1)  # [R, 1, 8]: df[j]
            p[:, :top] = torch.where(take, fma(a, b, p[:, :top]), p[:, :top])
        s = ((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])) + (
            (p[..., 4] + p[..., 5]) + (p[..., 6] + p[..., 7])
        )
        out.append(s)
    acf = torch.cat(out).reshape(df.shape)
    return acf / (n - torch.arange(n, dtype=df.dtype, device=dev))


def autocorr(df: torch.Tensor) -> torch.Tensor:
    """`autocorr_plain`'s function over `[..., 512]`: one launch of
    csrc/autocorr.cu on a CUDA f32 tensor (a block a row), the plain version
    on a CPU tensor."""
    if not _build.on_cuda(df):
        return autocorr_plain(df)
    _build.require("autocorr", df, torch.float32, df.dim(), df.device)
    if df.dim() < 1 or df.shape[-1] != WINLEN:
        raise ValueError(f"autocorr: expected rows of {WINLEN}, got shape {tuple(df.shape)}")
    acf = torch.empty_like(df)
    rows = df.numel() // WINLEN
    if rows == 0:
        return acf
    fn = _build.function("autocorr", "autocorr_launch", [_P, _P, ctypes.c_longlong, _P])
    _build.check("autocorr", fn(_build.ptr(df), _build.ptr(acf), rows, _build.stream_ptr(df.device)))
    _build.count_launch("autocorr")
    return acf


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


def initial_beat_state(batch: int, device, laglen: int = LAGLEN) -> dict:
    f32 = torch.float32

    def full(value, dtype=f32):
        return torch.full((batch,), value, dtype=dtype, device=device)

    return {
        "gwv": torch.zeros((batch, laglen), dtype=f32, device=device),
        "phwv": torch.ones((batch, 2 * laglen), dtype=f32, device=device),
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


def _checkstate(state: dict, xs: dict, rp: torch.Tensor) -> dict:
    """BeatTracking::checkstate (src/aubio.rs:1096-1227), per song."""
    laglen = xs["comb_u3"].shape[-1]
    step = float(xs["dfrev"].shape[-1] // 4)
    sel3 = state["timesig"] == 3

    comb_u = torch.where((state["timesig"] == 4).unsqueeze(-1), xs["comb_u4"], xs["comb_u3"])
    acfout = comb_u * state["gwv"]
    gp_cand = _quad_peak_pos(acfout, _vec_max_elem(acfout))
    gp = torch.where(state["gp"] > 0.0, gp_cand, 0.0)

    at_zero = state["counter"] == 0
    step_change = torch.abs(gp - rp) > float(np.float32(2.0) * np.float32(G_VAR))
    flagstep = torch.where(at_zero, step_change.to(torch.int32), state["flagstep"])
    counter = torch.where(at_zero & step_change, 3, state["counter"]).to(torch.int32)

    check = (counter == 1) & (flagstep == 1)
    consistent = torch.abs(2.0 * rp - state["rp1"] - state["rp2"]) < G_VAR
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


def _bt_do(state: dict, xs: dict):
    """BeatTracking::do_ (src/aubio.rs:966-1092) for one block of every song.
    Returns (new_state, beats [B, 8], fired [B, 8])."""
    winlen = xs["dfrev"].shape[-1]
    step = float(winlen // 4)
    rp = torch.where(state["timesig"] == 3, xs["rp_if3"], xs["rp_if4"])
    state = _checkstate(state, xs, rp)
    bp_raw = state["bp"]
    has_beats = bp_raw != 0.0
    bp = torch.where(has_beats, bp_raw, 1.0)  # keep the unused lanes finite
    dev = bp.device
    batch = bp.shape[0]

    # beat phase (src/aubio.rs:1017-1091)
    kmax = torch.floor(winlen / bp).to(torch.int32)
    k_idx = torch.arange(MAX_KMAX, device=dev)
    i_idx = torch.arange(MAX_PHASE_I, device=dev)
    # ROUND(x) = floor(x + 0.5) (src/aubio.rs:1038-1039)
    offs = torch.floor(bp.unsqueeze(-1) * k_idx.to(torch.float32) + 0.5).to(torch.int64)
    # phout[i] = sum over k of dfrev[i + offs_k], for i < bp, k < kmax,
    # i + offs_k < winlen, added left to right over k
    idx = i_idx.view(1, -1, 1) + offs.unsqueeze(1)  # [B, I, K]
    ok = (
        (i_idx.to(torch.float32).view(1, -1, 1) < bp.view(-1, 1, 1))
        & (k_idx.view(1, 1, -1) < kmax.view(-1, 1, 1))
        & (idx < winlen)
    )
    vals = torch.gather(
        xs["dfrev"], 1, torch.clamp(idx, 0, winlen - 1).reshape(batch, -1)
    ).reshape(idx.shape)
    terms = torch.where(ok, vals, 0.0)
    phout_head = terms[..., 0]
    for k in range(1, MAX_KMAX):
        phout_head = phout_head + terms[..., k]
    phout = torch.nn.functional.pad(phout_head, (0, winlen - MAX_PHASE_I))
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
    for _ in range(CATCH_UP):
        behind = (beat + bp < 0.0) & has_beats
        if not bool(behind.any()):
            break
        beat = torch.where(behind, beat + bp, beat)

    # emit: the first beat if beat >= 0, then while beat + bp <= step
    vals_out, fires = [], []
    first_fire = beat >= 0.0
    vals_out.append(beat)
    fires.append(first_fire)
    for _ in range(MAX_BEATS - 1):
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


def beat_track_plain(blocks: dict, n_valid_blocks: torch.Tensor):
    """The hypothesis machine over `blocks` (`BLOCK_WIDTHS`, `[B, NB, ...]`)
    as a loop over blocks. Song b runs its first `n_valid_blocks[b]` blocks;
    past them its state stays frozen. Returns `bp [B, NB]` f32 (the state's
    beat period after each block), `beats [B, NB, 8]` f32 and
    `fired [B, NB, 8]` bool (0 and False past the valid blocks)."""
    dfrev = blocks["dfrev"]
    batch, n_blocks, _ = dfrev.shape
    dev = dfrev.device
    n_valid = n_valid_blocks.to(device=dev)
    state = initial_beat_state(batch, dev, blocks["comb_u3"].shape[-1])
    bps = [torch.empty((batch, 0), dtype=torch.float32, device=dev)]
    beats = [torch.empty((batch, 0, MAX_BEATS), dtype=torch.float32, device=dev)]
    fired = [torch.empty((batch, 0, MAX_BEATS), dtype=torch.bool, device=dev)]
    for k in range(n_blocks):
        valid = k < n_valid
        new_state, beat_vals, beat_fires = _bt_do(state, {n: v[:, k] for n, v in blocks.items()})
        state = {
            name: torch.where(valid.view(-1, *([1] * (new.dim() - 1))), new, state[name])
            for name, new in new_state.items()
        }
        bps.append(state["bp"].unsqueeze(1))
        beats.append(torch.where(valid.unsqueeze(-1), beat_vals, 0.0).unsqueeze(1))
        fired.append((beat_fires & valid.unsqueeze(-1)).unsqueeze(1))
    return torch.cat(bps, 1), torch.cat(beats, 1), torch.cat(fired, 1)


def beat_track(blocks: dict, n_valid_blocks: torch.Tensor):
    """`beat_track_plain`'s function: one launch of csrc/beat_track.cu on
    CUDA tensors (`n_valid_blocks` int32 `[B]`, every block input
    contiguous), the plain loop on CPU tensors."""
    dfrev = blocks["dfrev"]
    if not _build.on_cuda(dfrev):
        return beat_track_plain(blocks, n_valid_blocks)
    dev = dfrev.device
    if set(blocks) != set(BLOCK_WIDTHS):
        raise ValueError(f"beat_track: expected the blocks {sorted(BLOCK_WIDTHS)}")
    batch, n_blocks = dfrev.shape[:2]
    for name, width in BLOCK_WIDTHS.items():
        t = blocks[name]
        dtype = torch.int32 if name.startswith("ts_") else torch.float32
        _build.require(name, t, dtype, 2 if width == 1 else 3, dev)
        want = (batch, n_blocks) if width == 1 else (batch, n_blocks, width)
        if tuple(t.shape) != want:
            raise ValueError(f"beat_track: {name} has shape {tuple(t.shape)}, expected {want}")
    for name in ("dfrev", "comb_u3", "comb_u4", "gwv_if3", "gwv_if4"):
        if blocks[name].data_ptr() % 16:  # the kernel copies their rows 16 bytes at a time
            raise ValueError(f"beat_track: {name} is not 16-byte aligned")
    _build.require("n_valid_blocks", n_valid_blocks, torch.int32, 1, dev)
    if n_valid_blocks.shape[0] != batch:
        raise ValueError(f"beat_track: n_valid_blocks has {n_valid_blocks.shape[0]} songs, expected {batch}")
    bp = torch.empty((batch, n_blocks), dtype=torch.float32, device=dev)
    beats = torch.empty((batch, n_blocks, MAX_BEATS), dtype=torch.float32, device=dev)
    fired = torch.empty((batch, n_blocks, MAX_BEATS), dtype=torch.bool, device=dev)
    if batch == 0 or n_blocks == 0:
        return bp, beats, fired
    fn = _build.function("beat_track", "beat_track_launch", [_P] * 10 + [_I, _I, _P, _P, _P, _P])
    err = fn(
        *(_build.ptr(blocks[name]) for name in BLOCK_WIDTHS), _build.ptr(n_valid_blocks),
        batch, n_blocks, _build.ptr(bp), _build.ptr(beats), _build.ptr(fired),
        _build.stream_ptr(dev),
    )
    _build.check("beat_track", err)
    _build.count_launch("beat_track")
    return bp, beats, fired
