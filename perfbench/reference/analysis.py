"""The plain reference of one song's bliss feature vector (Version2, 23
features), in PyTorch ops on any device, one song at a time.

A frozen copy of the plain path of the port's analysis (bliss-rs
src/song/mod.rs:417-506 and the descriptors it names), written again here
so that it imports nothing of the program: the tempo and timbral stages in
f32 as aubio computes them (`torch.fft.rfft` spectra, the beat tracker as
a loop over blocks, the autocorrelation's fused multiply-adds rounded
once), the chroma stage in f64 after its f32 STFT (the unfused tuning
estimate: a sorted median and a histogram; the filterbank built in f64 for
the song's own tuning). It has no kernels, no buckets and no batches: the
song is its own buffer, so no padding reaches any descriptor.

    features(samples [n] f32 tensor) -> [23] f32 tensor

`features(..., low=True)` is the control in bfloat16: the samples and every
spectrum rounded to bfloat16 where they would be stored (`torch.fft` takes
no bfloat16), the rest as above; `correct` has to reject what it gives.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 22050

# ---------------------------------------------------------------------------
# windows, frames, reductions (src/utils.rs)
# ---------------------------------------------------------------------------


def hann(window: int, device) -> torch.Tensor:
    """Periodic Hann window in f32, as src/utils.rs:36-40 computes it."""
    n = np.arange(window, dtype=np.float32)
    w = np.float32(0.5) - np.float32(0.5) * np.cos(
        np.float32(2.0) * n * np.float32(math.pi) / np.float32(window)
    )
    return torch.as_tensor(w.astype(np.float32), device=device)


def n_frames_strided(length: int, window: int, hop: int) -> int:
    """Complete strided windows (Rust `windows(w).step_by(h)`)."""
    return (length - window) // hop + 1


def frames_at(signal: torch.Tensor, window: int, hop: int, offset: int, n_frames: int):
    """`[n_frames, window]`: frame f is `signal[f*hop - offset, ... + window)`,
    zeros outside the song (aubio's sliding buffer, src/aubio.rs:198-212)."""
    t = signal.shape[-1]
    tail = max((n_frames - 1) * hop + window - (t + offset), 0)
    padded = torch.nn.functional.pad(signal, (offset, tail))
    return padded.unfold(-1, window, hop)[:n_frames]


def to_low(t: torch.Tensor, low: bool) -> torch.Tensor:
    """`t` rounded to bfloat16 (and held in its own dtype) when `low`."""
    return t.to(torch.bfloat16).to(t.dtype) if low else t


def mags_of(frames: torch.Tensor, window: torch.Tensor, low: bool = False) -> torch.Tensor:
    return to_low(torch.abs(torch.fft.rfft(frames * window, dim=-1)), low)


def normalize_range(value, lo: float, hi: float):
    """Min-max normalization into [-1, 1] (src/utils.rs:70-77)."""
    return 2.0 * (value - lo) / (hi - lo) - 1.0


def mean_std(values: torch.Tensor):
    """Mean and population standard deviation, two passes (ndarray's)."""
    mean = values.sum() / values.numel()
    d = values - mean
    return mean, torch.sqrt((d * d).sum() / values.numel())


def midpoint_median(values: torch.Tensor) -> torch.Tensor:
    """ndarray-stats' Midpoint quantile 0.5 of a flat tensor."""
    s = torch.sort(values).values
    pos = (values.numel() - 1) * 0.5
    return (s[math.floor(pos)] + s[math.ceil(pos)]) * 0.5


# ---------------------------------------------------------------------------
# zero crossings, timbral, loudness (src/timbral.rs, src/misc.rs)
# ---------------------------------------------------------------------------


def zcr(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0
    crossings = (pos[1:] != pos[:-1]).sum().to(torch.float32)
    return normalize_range(crossings / float(x.numel()), 0.0, 1.0)


def timbral(x: torch.Tensor, low: bool = False) -> torch.Tensor:
    """Centroid, rolloff and flatness, mean and std of each (src/timbral.rs,
    aubio's SpecDesc over the buggy 256-bin pvoc layout)."""
    n_frames = n_frames_strided(x.numel(), 512, 128)
    mags = mags_of(frames_at(x, 512, 128, 384, n_frames), hann(512, x.device), low)
    mags = torch.cat([mags[:, :255], mags[:, 256:]], dim=-1)  # src/aubio.rs:237-261
    bins = torch.arange(256, dtype=torch.float32, device=x.device)
    total = mags.sum(-1)
    weighted = (mags * bins).sum(-1)
    cum = torch.cumsum(mags * mags, dim=-1)
    energy = cum[:, -1]
    below = (cum < (energy * 0.95).unsqueeze(-1)).sum(-1).to(torch.float32)
    geo = torch.exp2(torch.log2(mags).sum(-1) / 256)
    arith = total / 256
    bin_hz = SAMPLE_RATE / 512
    centroid = torch.where(total == 0.0, 0.0, weighted / total) * bin_hz
    rolloff = torch.clamp(torch.where(energy == 0.0, 0.0, below + 1.0), max=256.0) * bin_hz
    flatness = torch.where(geo == 0.0, 0.0, geo / torch.where(arith == 0.0, 1.0, arith))
    out = []
    for series, hi in ((centroid, SAMPLE_RATE / 2), (rolloff, SAMPLE_RATE / 2), (flatness, 1.0)):
        mean, std = mean_std(series)
        out += [normalize_range(mean, 0.0, hi), normalize_range(std, 0.0, hi)]
    return torch.stack(out)


def loudness(x: torch.Tensor) -> torch.Tensor:
    """Mean and std of the chunks' mean energy in dB (src/misc.rs:43-71),
    the last partial chunk included."""
    n = x.numel()
    chunks = -(-n // 1024)
    padded = torch.nn.functional.pad(x, (0, chunks * 1024 - n)).reshape(chunks, 1024)
    counts = torch.full((chunks,), 1024.0, device=x.device)
    counts[-1] = n - (chunks - 1) * 1024
    mean, std = mean_std((padded * padded).sum(-1) / counts)
    return torch.stack([
        normalize_range(10.0 * torch.log10(torch.clamp(mean, min=1e-9)), -90.0, 0.0),
        normalize_range(10.0 * torch.log10(torch.clamp(std, min=1e-9)), -90.0, 0.0),
    ])


# ---------------------------------------------------------------------------
# tempo: SpecFlux onset, peak picker, aubio's beat tracker (src/aubio.rs)
# ---------------------------------------------------------------------------

WINLEN, STEP, LAGLEN = 512, 128, 128
G_VAR = float(np.float32(3.901))
MAX_BEATS, MAX_KMAX, MAX_PHASE_I, CATCH_UP = 8, 21, 160, 24
MAX_BPM = 206.0
_PP_THRESHOLD = float(np.float32(0.3))
_BIQUAD = tuple(float(np.float32(v)) for v in (0.1599879, 0.31997577, 0.1599879, 0.23484048, 0.0))


def _filtfilt7(windows: torch.Tensor) -> torch.Tensor:
    """Biquad::do_filtfilt over each 7-onset window (src/aubio.rs:659-686)."""
    b0, b1, b2, a1, a2 = _BIQUAD

    def one_pass(x):
        ys = []
        y1 = y2 = x1 = x2 = torch.zeros_like(x[..., 0])
        for i in range(7):
            x0 = x[..., i]
            y0 = b0 * x0 + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            ys.append(y0)
            x2, x1, y2, y1 = x1, x0, y1, y0
        return torch.stack(ys, dim=-1)

    return one_pass(one_pass(windows).flip(-1)).flip(-1)


def _fma_f32(a, b, c):
    """fmaf(a, b, c) rounded once (the product is exact in f64; the sum is
    made round-to-odd before the cast)."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - c64
    err = (c64 - (s - bb)) + (p - bb)
    bits = s.view(torch.int64)
    nudge = (err != 0.0) & ((bits & 1) == 0) & torch.isfinite(s)
    away = (err > 0.0) == (s > 0.0)
    bits = torch.where(nudge, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).to(torch.float32)


def _autocorr(rows: torch.Tensor) -> torch.Tensor:
    """vec_autocorr of each row (src/aubio.rs:819-828): 8 partial sums of
    fused multiply-adds, partial w over the terms j = w (mod 8)."""
    n = rows.shape[-1]
    dev = rows.device
    lag = torch.arange(n, device=dev).unsqueeze(1)
    lane = torch.arange(8, device=dev)
    out = []
    for lo in range(0, rows.shape[0], 256):
        r = rows[lo : lo + 256]
        p = torch.zeros((r.shape[0], n, 8), dtype=rows.dtype, device=dev)
        for m in range(-(-n // 8)):
            j = m * 8 + lane
            top = min(n, (m + 1) * 8)
            shift = j - lag[:top]
            take = (shift >= 0) & (j < n)
            a = r[:, torch.clamp(shift, 0, n - 1)]
            b = r[:, torch.clamp(j, max=n - 1)].unsqueeze(1)
            p[:, :top] = torch.where(take, _fma_f32(a, b, p[:, :top]), p[:, :top])
        out.append(((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3]))
                   + ((p[..., 4] + p[..., 5]) + (p[..., 6] + p[..., 7])))
    acf = torch.cat(out) / (n - torch.arange(n, dtype=rows.dtype, device=dev))
    bad = (~torch.isfinite(rows)).to(torch.int32)
    return torch.where((torch.cumsum(bad, -1) - bad) > 0, float("nan"), acf)


def _sum_lr(vals: torch.Tensor) -> torch.Tensor:
    total = torch.zeros_like(vals[..., 0])
    for t in range(vals.shape[-1]):
        total = total + vals[..., t]
    return total


def _vec_max_elem(data):
    """fvec_max_elem: the last maximum, 0 when all are negative."""
    n = data.shape[-1]
    last = (n - 1) - torch.argmax(data.flip(-1), dim=-1)
    return torch.where(data.amax(-1) >= 0.0, last, 0)


def _quad_peak_pos(x, pos):
    """vec_quadratic_peak_pos (src/aubio.rs:576-604)."""
    n = x.shape[-1]
    posc = torch.clamp(pos, 1, n - 2).unsqueeze(-1)
    s0 = torch.gather(x, -1, posc - 1).squeeze(-1)
    s1 = torch.gather(x, -1, posc).squeeze(-1)
    s2 = torch.gather(x, -1, posc + 1).squeeze(-1)
    interp = posc.squeeze(-1).to(torch.float32) + 0.5 * (s0 - s2) / (s0 - 2.0 * s1 + s2)
    return torch.where((pos == 0) | (pos >= n - 1), pos.to(torch.float32), interp)


def _timesig(acf, gp_int):
    """Time signature from the autocorrelation (src/aubio.rs:864-907)."""
    n = acf.shape[-1]
    k = torch.arange(-2, 2, device=acf.device)
    gp = gp_int.unsqueeze(-1)

    def gather(mult):
        idx = mult * gp + k
        ok = (idx >= 0) & (idx < n)
        return torch.where(ok, torch.gather(acf, -1, torch.clamp(idx, 0, n - 1)), 0.0), ok

    (a3, ok3), (a6, ok6), (a4, ok4), (a2, ok2) = gather(3), gather(6), gather(4), gather(2)
    small = n > 6 * gp_int + 2
    three = torch.where(small, _sum_lr(a3),
                        _sum_lr(torch.where(ok3, a3, 0.0) + torch.where(ok3 & ok6, a6, 0.0)))
    four = torch.where(small, _sum_lr(a4),
                       _sum_lr(torch.where(ok4, a4, 0.0) + torch.where(ok4 & ok2, a2, 0.0)))
    return torch.where(gp_int < 2, 4, torch.where(three > four, 3, 4)).to(torch.int32)


def _gaussian(rp, g_var2):
    j = torch.arange(LAGLEN, dtype=torch.float32, device=rp.device)
    diff = (j + 1.0) - rp.unsqueeze(-1)
    return torch.exp(-0.5 * diff * diff / torch.tensor(g_var2, device=rp.device))


def _beat_weights(device):
    """(rwv, dfwv, rayparam truncated) of BeatTracking::new (src/aubio.rs:909-962)."""
    rayparam = np.float32(60.0 * SAMPLE_RATE / 120.0 / 256)
    norm = np.exp((np.float32(np.log(2.0)) / rayparam) * np.float32(WINLEN + 2))
    i = np.arange(1, LAGLEN + 1, dtype=np.float32)
    rwv = (i / rayparam**2) * np.exp(-(i**2) / (2.0 * rayparam**2))
    j = np.arange(1, WINLEN + 1, dtype=np.float32)
    dfwv = np.exp((np.float32(np.log(2.0)) / rayparam) * j) / norm
    return (torch.as_tensor(rwv.astype(np.float32), device=device),
            torch.as_tensor(dfwv.astype(np.float32), device=device), float(np.uint32(rayparam)))


def _block_inputs(thresh, h_valid: int):
    """Every block's state-free inputs `[NB, ...]` (src/aubio.rs:1389-1416)."""
    rwv, dfwv, ray_trunc = _beat_weights(thresh.device)
    g_var2 = float(np.float32(G_VAR) * np.float32(G_VAR))
    h = thresh.shape[-1]
    masked = torch.where(torch.arange(h, device=thresh.device) < h_valid, thresh, 0.0)
    frames = frames_at(masked, WINLEN, STEP, WINLEN - STEP + 1, (h - STEP) // STEP + 1)
    acfs = _autocorr(frames)
    dev = frames.device
    i = torch.arange(LAGLEN, device=dev)
    interior = (i >= 1) & (i < LAGLEN - 1)
    contribs = []
    for a in range(1, 5):
        idx = i.unsqueeze(1) * a + torch.arange(1, 2 * a, device=dev).unsqueeze(0) - 1
        vals = torch.where(idx < WINLEN, acfs[..., torch.clamp(idx, 0, WINLEN - 1)], 0.0)
        contribs.append(_sum_lr(vals) * interior)
    c1, c2, c3, c4 = contribs
    w = [float(np.float32(1.0 / (2 * a - 1))) for a in range(1, 5)]
    comb_w3 = c1 * w[0] + c2 * w[1] + c3 * w[2]
    comb_w4 = comb_w3 + c4 * w[3]

    def rp_of(comb_w):
        rayacf = comb_w * rwv
        mi = _vec_max_elem(rayacf)
        return torch.where((mi > 0) & (mi < LAGLEN - 1), _quad_peak_pos(rayacf, mi), ray_trunc)

    rp4, rp3 = rp_of(comb_w4), rp_of(comb_w3)
    return {
        "dfrev": (frames * dfwv).flip(-1),
        "rp_if4": rp4, "rp_if3": rp3,
        "ts_if4": _timesig(acfs, rp4.to(torch.int32)),
        "ts_if3": _timesig(acfs, rp3.to(torch.int32)),
        "gwv_if4": _gaussian(rp4, g_var2), "gwv_if3": _gaussian(rp3, g_var2),
        "comb_u3": c1 + c2 + c3, "comb_u4": c1 + c2 + c3 + c4,
    }


def _double_slow(bp):
    """`while 0 < bp < 25: bp *= 2` (src/aubio.rs:1216-1218)."""
    m, e = torch.frexp(bp)
    k = torch.clamp(torch.where(m >= 0.78125, 5 - e, 6 - e), 0, 32)
    scale = ((k + 127) << 23).to(torch.int32).view(torch.float32)
    return torch.where((bp > 0.0) & (bp < 25.0), bp * scale, bp)


def _checkstate(state, xs, rp):
    """BeatTracking::checkstate (src/aubio.rs:1096-1227)."""
    step = float(STEP)
    sel3 = state["timesig"] == 3
    comb_u = torch.where(state["timesig"] == 4, xs["comb_u4"], xs["comb_u3"])
    acfout = comb_u * state["gwv"]
    gp = torch.where(state["gp"] > 0.0, _quad_peak_pos(acfout, _vec_max_elem(acfout)), 0.0)
    at_zero = state["counter"] == 0
    change = torch.abs(gp - rp) > float(np.float32(2.0) * np.float32(G_VAR))
    flagstep = torch.where(at_zero, change.to(torch.int32), state["flagstep"])
    counter = torch.where(at_zero & change, 3, state["counter"]).to(torch.int32)
    check = (counter == 1) & (flagstep == 1)
    consistent = torch.abs(2.0 * rp - state["rp1"] - state["rp2"]) < G_VAR
    flagconst = check & consistent
    counter = torch.where(check, torch.where(consistent, 0, 2),
                          torch.where(counter > 0, counter - 1, counter)).to(torch.int32)
    j2 = torch.arange(2 * LAGLEN, dtype=torch.float32, device=rp.device)
    lastbeat = state["lastbeat"]
    d2 = 1.0 + j2 - step + lastbeat
    ctx = torch.where(step > lastbeat, torch.exp(-0.5 * d2 * d2 / (gp / 8.0)), 1.0)
    use_ctx = (~flagconst) & (state["timesig"] > 0)
    bp = torch.where(flagconst, rp, torch.where(use_ctx, gp, rp))
    return {
        "gwv": torch.where(flagconst, torch.where(sel3, xs["gwv_if3"], xs["gwv_if4"]),
                           state["gwv"]),
        "phwv": torch.where(flagconst, 1.0, torch.where(use_ctx, ctx, 1.0)),
        "timesig": torch.where(flagconst, torch.where(sel3, xs["ts_if3"], xs["ts_if4"]),
                               state["timesig"]).to(torch.int32),
        "counter": counter, "flagstep": flagstep.to(torch.int32),
        "gp": torch.where(flagconst, rp, gp), "bp": _double_slow(bp),
        "rp": rp, "rp1": rp, "rp2": state["rp1"], "lastbeat": lastbeat,
    }


def _bt_do(state, xs):
    """BeatTracking::do_ (src/aubio.rs:966-1092) for one block: the new
    state, the 8 beat slots and which of them fired."""
    step = float(STEP)
    rp = torch.where(state["timesig"] == 3, xs["rp_if3"], xs["rp_if4"])
    state = _checkstate(state, xs, rp)
    has_beats = state["bp"] != 0.0
    bp = torch.where(has_beats, state["bp"], 1.0)
    dev = bp.device
    kmax = torch.floor(WINLEN / bp).to(torch.int32)
    k_idx = torch.arange(MAX_KMAX, device=dev)
    i_idx = torch.arange(MAX_PHASE_I, device=dev)
    offs = torch.floor(bp * k_idx.to(torch.float32) + 0.5).to(torch.int64)
    idx = i_idx.view(-1, 1) + offs.view(1, -1)
    ok = ((i_idx.to(torch.float32).view(-1, 1) < bp) & (k_idx.view(1, -1) < kmax)
          & (idx < WINLEN))
    terms = torch.where(ok, xs["dfrev"][torch.clamp(idx, 0, WINLEN - 1)], 0.0)
    head = terms[:, 0]
    for k in range(1, MAX_KMAX):
        head = head + terms[:, k]
    phout = torch.nn.functional.pad(head, (0, WINLEN - MAX_PHASE_I))
    n_w = state["phwv"].shape[-1]
    phout = torch.cat([phout[:n_w] * state["phwv"], phout[n_w:]])
    mi = _vec_max_elem(phout)
    lastbeat = state["lastbeat"]
    phase = torch.where(mi >= WINLEN - 1, step - lastbeat, _quad_peak_pos(phout, mi)) + 1.0
    beat = bp - phase
    beat = torch.where((step - lastbeat - phase) < (-0.40 * bp), beat + bp, beat)
    for _ in range(CATCH_UP):
        behind = (beat + bp < 0.0) & has_beats
        if not bool(behind):
            break
        beat = torch.where(behind, beat + bp, beat)
    vals, fires = [beat], [beat >= 0.0]
    for _ in range(MAX_BEATS - 1):
        more = beat + bp <= step
        beat = torch.where(more, beat + bp, beat)
        vals.append(beat)
        fires.append(more)
    beats = torch.where(has_beats, torch.stack(vals), 0.0)
    fired = torch.stack(fires) & has_beats
    state["lastbeat"] = torch.where(has_beats, beat, lastbeat)
    return state, beats, fired


def tempo(x: torch.Tensor, low: bool = False) -> torch.Tensor:
    """Normalized median BPM (BPMDesc, src/temporal.rs:32-85)."""
    n = x.numel()
    dev = x.device
    h = n_frames_strided(n, 512, 256)
    mags = mags_of(frames_at(x, 512, 256, 256, h), hann(512, dev), low)
    prev = torch.cat([torch.zeros_like(mags[:1]), mags[:-1]])
    onset = torch.clamp(mags - prev, min=0.0).sum(-1)
    # PeakPicker::do_ (src/aubio.rs:733-768)
    padded = torch.nn.functional.pad(onset, (6, 0))
    proc = _filtfilt7(torch.stack([padded[i : i + h] for i in range(7)], dim=-1))
    thresh = proc[:, 5] - torch.median(proc, dim=-1).values - proc.mean(-1) * _PP_THRESHOLD
    # the silence gate at the raw 512-sample window of each hop
    need = (h + 1) * 256
    xs = torch.nn.functional.pad(x, (0, max(need - n, 0)))[:need].reshape(-1, 256)
    e = (xs * xs).sum(-1)
    silent = 10.0 * torch.log10((e[:h] + e[1 : h + 1]) / 512) < -90.0
    if h < STEP:
        return torch.tensor(-1.0, device=dev)
    blocks = _block_inputs(thresh, h)
    n_blocks = blocks["dfrev"].shape[0]
    n_valid = min(h // STEP, n_blocks)
    f32 = torch.float32
    state = {
        "gwv": torch.zeros(LAGLEN, dtype=f32, device=dev),
        "phwv": torch.ones(2 * LAGLEN, dtype=f32, device=dev),
        "timesig": torch.tensor(0, dtype=torch.int32, device=dev),
        "counter": torch.tensor(0, dtype=torch.int32, device=dev),
        "flagstep": torch.tensor(0, dtype=torch.int32, device=dev),
        **{k: torch.tensor(v, dtype=f32, device=dev)
           for k, v in (("gp", 0.0), ("bp", 0.0), ("rp", 1.0), ("rp1", 0.0), ("rp2", 0.0),
                        ("lastbeat", 0.0))},
    }
    bpms, fired_all = [], []
    for k in range(n_valid):
        state, beats, fired = _bt_do(state, {name: v[k] for name, v in blocks.items()})
        bp = state["bp"]
        bpm = torch.where(bp != 0.0, torch.full_like(bp, 60.0 * SAMPLE_RATE) / (256.0 * bp), 0.0)
        floor = torch.floor(beats)
        hop = (STEP - 1) + STEP * k + floor.to(torch.int64)
        in_block = (floor >= 0) & (floor < STEP)
        not_silent = ~silent[torch.clamp(hop, 0, h - 1)] | (hop >= h)
        fire = fired & in_block & (hop < h) & not_silent & ((beats - floor) > 0.0)
        bpms.append(torch.where(fire, bpm, 0.0))
        fired_all.append(fire)
    if not fired_all:
        return torch.tensor(-1.0, device=dev)
    bpms, fire = torch.cat(bpms), torch.cat(fired_all)
    if not bool(fire.any()):
        return torch.tensor(-1.0, device=dev)
    return normalize_range(midpoint_median(bpms[fire]), 0.0, MAX_BPM)


# ---------------------------------------------------------------------------
# chroma: librosa's chroma_stft with bliss's tuning and interval features
# (src/chroma.rs)
# ---------------------------------------------------------------------------

CHROMA_WINDOW, CHROMA_HOP = 8192, 2205
MAX_L2_INTERVAL, MAX_L2_TRIAD = 0.25, 0.025
_TEMPLATES = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 1, 0, 0, 0, 0, 1, 1, 0],
        [0, 0, 0, 1, 0, 0, 1, 0, 0, 1],
        [0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, 0, 0, 1, 0],
        [0, 0, 0, 0, 0, 0, 1, 1, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
        [0] * 10,
        [0] * 10,
        [0] * 10,
    ],
    dtype=np.float64,
)


def _pitch_band():
    freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, 1 + CHROMA_WINDOW // 2)
    band = (freqs >= 150.0) & (freqs < min(4000.0, SAMPLE_RATE / 2.0))
    return int(np.argmax(band)), int(len(band) - 1 - np.argmax(band[::-1]))


def _chroma_filter(tuning: float, device) -> torch.Tensor:
    """librosa's chroma filterbank `[12, 4097]` in f64 (src/chroma.rs:197-267)."""
    n_fft, n_chroma = CHROMA_WINDOW, 12
    freqs = np.linspace(0.0, float(SAMPLE_RATE), n_fft + 1)
    a440 = 440.0 * 2.0 ** (tuning / n_chroma)
    with np.errstate(divide="ignore"):
        fb = n_chroma * np.log2(freqs / (a440 / 16.0))
    fb[0] = fb[1] - 1.5 * n_chroma
    binwidth = np.concatenate([np.maximum(np.diff(fb), 1.0), [1.0]])
    d = fb[None, :] - np.arange(n_chroma)[:, None]
    d = (np.mod(d + 6 + 10 * n_chroma, n_chroma) - 6) / binwidth
    wts = np.exp(-0.5 * (2.0 * d) ** 2)
    norm = np.sqrt(np.sum(wts * wts, axis=0))
    wts = wts / np.where(norm < np.finfo(np.float64).tiny, 1.0, norm)
    wts = wts * np.exp(-0.5 * ((fb / n_chroma - 5.0) / 2.0) ** 2)
    return torch.as_tensor(np.roll(wts, -3, axis=0)[:, : 1 + n_fft // 2], device=device)


def _spectrum(x: torch.Tensor, low: bool) -> torch.Tensor:
    """|STFT| `[F, 4097]` of the reflect-padded song, f32 (src/utils.rs:26-64)."""
    n = x.numel()
    pad = CHROMA_WINDOW // 2
    padded = torch.cat([x[1 : pad + 1].flip(0), x, x[n - 1 - pad : n - 1].flip(0)])
    n_frames = (n - 1) // CHROMA_HOP + 1
    padded = torch.nn.functional.pad(padded, (0, CHROMA_WINDOW))
    frames = padded.unfold(-1, CHROMA_WINDOW, CHROMA_HOP)[:n_frames]
    return mags_of(frames, hann(CHROMA_WINDOW, x.device), low)


def _tuning(spec: torch.Tensor) -> float:
    """The tuning estimate in the spectrum's dtype (src/chroma.rs:269-391):
    parabolic peaks in the pitch band, the median of their magnitudes, the
    histogram mode of the peaks above it, in 0.01 of a semitone."""
    dt = spec.dtype
    beginning, end = _pitch_band()
    rows = end - beginning - 3
    before = spec[:, beginning : beginning + rows]
    elem = spec[:, beginning + 1 : beginning + 1 + rows]
    after = spec[:, beginning + 2 : beginning + 2 + rows]
    is_peak = (elem > 0.1 * spec.amax(-1, keepdim=True)) & (after <= elem) & (before < elem)
    avg = 0.5 * (after - before)
    den = 2.0 * elem - after - before
    shift = avg / torch.where(torch.abs(den) < torch.finfo(dt).tiny, den + 1.0, den)
    bins = torch.arange(rows, dtype=dt, device=spec.device) + (beginning + 1)
    pitches = (bins + shift) * (SAMPLE_RATE / CHROMA_WINDOW)
    mags = elem + 0.5 * avg * shift
    pos = is_peak & (pitches > 0.0)
    if not bool(pos.any()):
        return 0.0
    sel = pos & (mags >= midpoint_median(mags[pos]))
    a4_16 = torch.full((), 440.0 / 16.0, dtype=dt, device=spec.device)
    octs = torch.log2(torch.clamp(pitches[sel], min=torch.finfo(dt).tiny) / a4_16)
    v = torch.remainder(12 * octs, 1.0)
    v = torch.where(v >= 0.5, v - 1.0, v)
    idx = torch.clamp(((v - (-0.5)) / 0.01).to(torch.int32), 0, 99)
    counts = torch.bincount(idx.to(torch.int64), minlength=100)
    if int(counts.sum()) == 0:
        return 0.0
    return (-50.0 + 100.0 * 0.01 * int(torch.argmax(counts))) / 100.0


def chroma(x: torch.Tensor, low: bool = False) -> torch.Tensor:
    """The 13 Version2 chroma interval features (ChromaDesc, src/chroma.rs:73-126)."""
    spec = _spectrum(x, low).to(torch.float64)
    return _chroma_at(spec, _tuning(spec))


def _chroma_at(spec: torch.Tensor, tuning: float) -> torch.Tensor:
    """The 13 features of an f64 spectrum `[F, 4097]` at `tuning`."""
    f64 = torch.float64
    dev = spec.device
    raw = _chroma_filter(tuning, dev) @ (spec * spec).T  # [12, F]
    colsum = torch.abs(raw).sum(0, keepdim=True)
    chroma_ = raw / torch.where(colsum < torch.finfo(f64).tiny, 1.0, colsum)
    sharp = torch.exp(15.0 * chroma_)
    colsum = torch.abs(sharp).sum(0, keepdim=True)
    sharp = sharp / torch.where(colsum < 1e-4, 1.0, colsum)
    # the interval templates, each rolled over the 12 pitch classes: a
    # product of the powers the template activates (src/chroma.rs:157-175)
    feats = []
    for t in range(10):
        for s in range(12):
            active = np.flatnonzero(np.roll(_TEMPLATES[:, t], s))
            feats.append(torch.prod(sharp[active], dim=0) if len(active) else None)
    per_frame = torch.stack([sum(feats[t * 12 + s] for s in range(12)) for t in range(10)])
    raw10 = per_frame.mean(-1)
    ic, triads = raw10[:6], raw10[6:]
    l2_ic, l2_tri = torch.sqrt((ic * ic).sum()), torch.sqrt((triads * triads).sum())
    ic = torch.where(l2_ic > 0.0, ic / l2_ic, ic)
    triads = torch.where(l2_tri > 0.0, triads / l2_tri, triads)
    out = 2.0 * torch.cat([ic, triads]).to(torch.float32) - 1.0
    f11 = torch.clamp(2.0 * l2_ic.to(torch.float32) / MAX_L2_INTERVAL - 1.0, max=1.0)
    f12 = torch.clamp(2.0 * l2_tri.to(torch.float32) / MAX_L2_TRIAD - 1.0, max=1.0)
    angle = torch.atan2(20.0 * l2_tri, l2_ic + 1e-12)
    f13 = 2.0 * angle.to(torch.float32) / (math.pi / 2.0) - 1.0
    return torch.cat([out, f11.view(1), f12.view(1), f13.view(1)])


def features(samples: torch.Tensor, low: bool = False) -> torch.Tensor:
    """[tempo, zcr, centroid x2, rolloff x2, flatness x2, loudness x2,
    chroma x13] of one song's f32 samples (src/song/mod.rs:493-506)."""
    x = to_low(samples.to(torch.float32).reshape(-1), low)
    parts = [tempo(x, low).view(1), zcr(x).view(1), timbral(x, low), loudness(x),
             chroma(x, low)]
    return torch.cat([p.to(torch.float32) for p in parts])
