"""The warp FFT bodies of the three strided-frame kernels, emulated on the CPU.

`csrc/fft_common.cuh:warp_rfft512_mags` (a 512-point real FFT by one warp:
the 256-point complex FFT `warp_fft256`, 8 x 8 x 4, then the real-input
untangling) carries `frame_dft_mags` (#7) and `specflux` (#2), and
`warp_radix2_512_mags` (fft_radix2_dit's arithmetic on one warp) carries
`timbral_fft` (#1), through the staged tile loop of `csrc/frame_tiles.cuh`.
The windowed samples are rounded to f32 before the first butterfly, as the
card rounds them in both bodies.
No CUDA runs here, so this file copies that arithmetic into numpy f32, lane
by lane (the 32 lanes on an axis of their own): the index splits, the
exchange layouts through shared memory, the integer-phase twiddles, the
shuffles and lane 0's own cases; the tile loop's staging and frame
assignment; and the three epilogues (the timbral rows in the warp layout,
the SpecFlux rows with their lookback across warps, tiles and block runs).
The copy is held against an f64 FFT, torch's f32 FFT, the block-wide
radix-2 body, the port's plain versions and the JAX package's Pallas
kernels in TPU interpret mode.
"""

import pytest

# the JAX package's comparisons: a host without JAX skips this module
pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from bliss_tpu.ops import pallas_dft as JD
from bliss_tpu_torch.ops import dft_kernels as TD
from bliss_tpu_torch.ops.windows import _hann_np
from bliss_tpu_torch.tables import twiddles

torch.set_num_threads(1)

F32 = np.float32
LANE = np.arange(32)
TW = twiddles(512)
HANN = _hann_np(512)
TILE, WARPS = 32, 8
WARP_FRAMES = TILE // WARPS


# ---------------------------------------------------------------------------
# csrc/fft_common.cuh, lane by lane: registers are lists of [..., 32] arrays
# ---------------------------------------------------------------------------


def _dft4(r0, i0, r1, i1, r2, i2, r3, i3):
    """fft_common.cuh:dft4 (natural order in and out)."""
    s0r, s0i, s1r, s1i = r0 + r2, i0 + i2, r0 - r2, i0 - i2
    s2r, s2i, s3r, s3i = r1 + r3, i1 + i3, i1 - i3, r3 - r1
    return (s0r + s2r, s0i + s2i, s1r + s3r, s1i + s3i,
            s0r - s2r, s0i - s2i, s1r - s3r, s1i - s3i)


def _dft8(re, im):
    """fft_common.cuh:dft8: one radix-2 decimation-in-frequency step, the
    turn of the odd half by W_8^j, a 4-point DFT of each half."""
    c = F32(0.70710678118654752440)
    ar = [re[j] + re[j + 4] for j in range(4)]
    ai = [im[j] + im[j + 4] for j in range(4)]
    br = [re[j] - re[j + 4] for j in range(4)]
    bi = [im[j] - im[j + 4] for j in range(4)]
    br[1], bi[1] = c * (br[1] + bi[1]), c * (bi[1] - br[1])
    br[2], bi[2] = bi[2], -br[2]
    br[3], bi[3] = c * (bi[3] - br[3]), -c * (br[3] + bi[3])
    a = _dft4(ar[0], ai[0], ar[1], ai[1], ar[2], ai[2], ar[3], ai[3])
    b = _dft4(br[0], bi[0], br[1], bi[1], br[2], bi[2], br[3], bi[3])
    out_r, out_i = [None] * 8, [None] * 8
    for m in range(4):
        out_r[2 * m], out_i[2 * m] = a[2 * m], a[2 * m + 1]
        out_r[2 * m + 1], out_i[2 * m + 1] = b[2 * m], b[2 * m + 1]
    return out_r, out_i


def _turn(re, im, wr, wi):
    return re * wr - im * wi, re * wi + im * wr


def _twiddle512(p):
    """fft_common.cuh:twiddle<512>: W_512^p by the integer phase p, from the
    table of phases [0, 256]."""
    p = np.asarray(p) & 511
    q = np.where(p <= 256, p, 512 - p)
    return TW[0][q], np.where(p <= 256, TW[1][q], -TW[1][q])


# WarpFftTwiddles::load, lane = 4 hi + lo
_HI, _LO = LANE >> 2, LANE & 3
_A = [_twiddle512(8 * _HI * j) for j in range(8)]
_B = [_twiddle512(2 * _LO * (_HI + 8 * j)) for j in range(8)]
_C = [_twiddle512(LANE + 32 * j) for j in range(8)]


def _warp_fft256(re, im):
    """fft_common.cuh:warp_fft256: lane q holds z[q + 32 j] in register j on
    entry and Z[q + 32 r] in register r on return."""
    shape = re[0].shape[:-1]
    # stage 1: lane (n2, n3) over n1, then W_256^(4 n2 k1)
    re, im = _dft8(re, im)
    for k1 in range(1, 8):
        re[k1], im[k1] = _turn(re[k1], im[k1], *_A[k1])
    xr, xi = np.zeros(shape + (288,), F32), np.zeros(shape + (288,), F32)
    for k1 in range(8):
        xr[..., k1 * 36 + LANE], xi[..., k1 * 36 + LANE] = re[k1], im[k1]
    # stage 2: lane (k1, n3) over n2, then W_256^(n3 (k1 + 8 k2))
    g = (LANE >> 2) * 36 + (LANE & 3)
    re, im = _dft8([xr[..., g + 4 * n2] for n2 in range(8)], [xi[..., g + 4 * n2] for n2 in range(8)])
    t = (LANE & 3) * 68 + (LANE >> 2)
    for k2 in range(8):
        r, i = _turn(re[k2], im[k2], *_B[k2])
        xr[..., t + 8 * k2], xi[..., t + 8 * k2] = r, i
    # stage 3: lane q over n3 for k1 + 8 k2 = q and q + 32: register h + 2 k3
    out_r, out_i = [None] * 8, [None] * 8
    for h in range(2):
        at = LANE + 32 * h
        v = _dft4(*[a for n3 in range(4) for a in (xr[..., 68 * n3 + at], xi[..., 68 * n3 + at])])
        for k3 in range(4):
            out_r[h + 2 * k3], out_i[h + 2 * k3] = v[2 * k3], v[2 * k3 + 1]
    return out_r, out_i


def warp_rfft512_mags(sig):
    """fft_common.cuh:warp_rfft512_mags on raw frames `sig [..., 512]` (the
    window applied inside, as the kernel does): `mag [..., 8, 32]` with
    |X[q + 32 r]| at `[r, q]`, and `nyq [..., 32]`, each lane's view of
    |X[256]| (lane 0's is the bin)."""
    xw = sig.astype(F32) * HANN
    zr, zi = xw[..., 0::2], xw[..., 1::2]
    re, im = _warp_fft256([zr[..., LANE + 32 * n1] for n1 in range(8)],
                          [zi[..., LANE + 32 * n1] for n1 in range(8)])
    partner = (32 - LANE) & 31
    half = F32(0.5)
    mag = []
    for r in range(8):
        c = np.where(LANE == 0, re[(8 - r) & 7][..., :1], re[7 - r][..., partner])
        d = np.where(LANE == 0, im[(8 - r) & 7][..., :1], im[7 - r][..., partner])
        a, b = re[r], im[r]
        er, ei = half * (a + c), half * (b - d)
        pr, pi = half * (b + d), half * (c - a)
        yr = er + (_C[r][0] * pr - _C[r][1] * pi)
        yi = ei + (_C[r][0] * pi + _C[r][1] * pr)
        mag.append(np.sqrt(yr * yr + yi * yi))
    return np.stack(mag, -2), np.abs(re[0] - im[0])


def _bins(mag, nyq):
    """`[..., 257]` magnitudes in bin order from the warp layout."""
    return np.concatenate([mag.reshape(mag.shape[:-2] + (256,)), nyq[..., :1]], -1)


def _warp_sum(v):
    """fft_common.cuh:warp_sum, the xor butterfly over the lane axis."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., LANE ^ o]
    return v


def _rev(v, bits):
    return np.array([int(format(int(x), f"0{bits}b")[::-1], 2) for x in np.atleast_1d(v)])


def _butterfly(ir, ii, jr, ji, wr, wi):
    """fft_common.cuh:radix2_butterfly (fft_radix2_dit's): i + w j, i - w j."""
    xr = jr * wr - ji * wi
    xi = jr * wi + ji * wr
    return ir + xr, ii + xi, ir - xr, ii - xi


def _radix2_stage_twiddle(i):
    """fft_common.cuh:radix2_stage_twiddle: the phase of entry i of the
    stage table of stages 5-9 (stage 5 + b at entries 16 (2^b - 1) + p)."""
    b = 0
    while i >= 16 * ((1 << (b + 1)) - 1):
        b += 1
    return (i - 16 * ((1 << b) - 1)) * (16 >> b)


def warp_radix2_512_mags(sig):
    """fft_common.cuh:warp_radix2_512_mags on raw frames `sig [..., 512]`:
    lane q holds point 16 q + r of the bit-reversed input in register r for
    stages 1-4, lane a + 16 h the points a + 16 r + 256 h for stages 5-8
    (through the padded transpose), stage 9 by the lane ^ 16 exchange, the
    bins back to lane k & 31, register k >> 5 through the second padded
    transpose. Returns `mag [..., 8, 32]` and lane 0's `nyq` on every lane."""
    xw = sig.astype(F32) * HANN
    zero = np.zeros(xw.shape[:-1] + (32,), F32)
    q_rev = _rev(LANE, 5)
    re = [xw[..., 32 * _rev(r, 4)[0] + q_rev] for r in range(16)]
    im = [zero.copy() for _ in range(16)]
    for s in range(1, 5):
        half = 1 << (s - 1)
        for r in range(16):
            if r & half:
                continue
            p = (r & (half - 1)) * (256 >> (s - 1))
            re[r], im[r], re[r + half], im[r + half] = _butterfly(
                re[r], im[r], re[r + half], im[r + half], TW[0][p], TW[1][p])
    xr, xi = np.zeros(zero.shape[:-1] + (544,), F32), np.zeros(zero.shape[:-1] + (544,), F32)
    for r in range(16):
        xr[..., 17 * LANE + r], xi[..., 17 * LANE + r] = re[r], im[r]
    a, h = LANE & 15, LANE >> 4
    re = [xr[..., a + 17 * r + 272 * h] for r in range(16)]
    im = [xi[..., a + 17 * r + 272 * h] for r in range(16)]
    stage_tw = [_radix2_stage_twiddle(i) for i in range(496)]
    for b in range(4):
        for r in range(16):
            if r & (1 << b):
                continue
            i = 16 * ((1 << b) - 1) + a + 16 * (r & ((1 << b) - 1))
            p = np.array([stage_tw[k] for k in i])
            re[r], im[r], re[r + (1 << b)], im[r + (1 << b)] = _butterfly(
                re[r], im[r], re[r + (1 << b)], im[r + (1 << b)], TW[0][p], TW[1][p])
    ms = np.zeros(zero.shape[:-1] + (288,), F32)
    for r in range(8):
        sr, si = np.where(h == 1, re[r], re[r + 8]), np.where(h == 1, im[r], im[r + 8])
        gr, gi = sr[..., LANE ^ 16], si[..., LANE ^ 16]
        ir, ii = np.where(h == 1, gr, re[r]), np.where(h == 1, gi, im[r])
        jr, ji = np.where(h == 1, re[r + 8], gr), np.where(h == 1, im[r + 8], gi)
        p = np.array([stage_tw[k] for k in 240 + a + 16 * (r + 8 * h)])
        ir, ii, jr, ji = _butterfly(ir, ii, jr, ji, TW[0][p], TW[1][p])
        ms[..., a + 16 * r + 144 * h] = np.sqrt(ir * ir + ii * ii)
        if r == 0:
            nyq = np.sqrt(jr * jr + ji * ji)[..., :1] + zero
    k = [LANE + 32 * r for r in range(8)]
    return np.stack([ms[..., kk + 16 * (kk >> 7)] for kk in k], -2), nyq


def _radix2_reference(sig):
    """fft_radix2_dit at 512 points, block-wide (tests/test_torch_kernels.py's
    copy): `[..., 257]` magnitudes."""
    from test_torch_kernels import _bit_reverse, _radix2_emulated

    xw = (sig.astype(F32) * HANN).reshape(-1, 512)
    re, im = _radix2_emulated(xw[:, _bit_reverse(9)].copy(), np.zeros_like(xw), 9, TW, 1)
    return np.sqrt(re * re + im * im)[:, :257].reshape(sig.shape[:-1] + (257,))


# ---------------------------------------------------------------------------
# csrc/frame_tiles.cuh and the three epilogues
# ---------------------------------------------------------------------------


class MagsEpilogue:
    """frame_dft.cu: the 257 magnitudes of every frame."""

    body = staticmethod(warp_rfft512_mags)
    lookback = 0

    def __init__(self, n_frames):
        self.out = np.full((n_frames, 257), np.nan, F32)

    def lookback_frames(self, first_tile, warp):
        return 0

    def frame(self, f, i, warp, mag, nyq):
        self.out[f] = _bins(mag, nyq)

    def tile_done(self, warp):
        pass


class TimbralEpilogue:
    """timbral_fft.cu: [total, weighted, below, log2 sum, energy] over the
    buggy 256-slot layout, from the warp's registers, on the radix-2 body."""

    body = staticmethod(warp_radix2_512_mags)
    lookback = 0

    def __init__(self, n_frames):
        self.out = np.full((n_frames, 5), np.nan, F32)

    def lookback_frames(self, first_tile, warp):
        return 0

    def frame(self, f, i, warp, mag, nyq):
        mag = mag.copy()
        mag[7, 31] = nyq[0]  # slot 255 carries the Nyquist bin
        total = weighted = logsum = energy = np.zeros(32, F32)
        cum = []
        with np.errstate(divide="ignore"):
            for r in range(8):
                m = mag[r]
                total = total + m
                weighted = weighted + m * (LANE + 32 * r).astype(F32)
                logsum = logsum + np.log2(m)
                c = m * m
                for s in (1, 2, 4, 8, 16):
                    y = c[(LANE - s) & 31]
                    c = np.where(LANE >= s, c + y, c)
                cum.append(c + energy)
                energy = energy + c[31]
        below = sum(int((cum[r] < energy * F32(0.95)).sum()) for r in range(8))
        self.out[f] = [_warp_sum(total)[0], _warp_sum(weighted)[0], below,
                       _warp_sum(logsum)[0], energy[0]]

    def tile_done(self, warp):
        pass


class FluxEpilogue:
    """specflux.cu: (flux, total) against the previous frame, the lookback
    of a warp's first frame by the edge buffer between warps and warp 0's
    carry."""

    body = staticmethod(warp_rfft512_mags)
    lookback = 1

    def __init__(self, n_frames):
        self.out = np.full((n_frames, 2), np.nan, F32)
        self.edges = np.full((WARPS, 8, 32), np.nan, F32), np.full((WARPS, 32), np.nan, F32)
        self.prev = [None] * WARPS
        self.first = [None] * WARPS

    def lookback_frames(self, first_tile, warp):
        return 1 if first_tile and warp == 0 else 0

    def emit(self, f, mag, nyq, lb, lb_nyq):
        flux = np.maximum(mag - lb, F32(0)).sum(0, dtype=F32)
        total = mag.sum(0, dtype=F32)
        flux[0] += max(nyq[0] - lb_nyq[0], F32(0))
        total[0] += nyq[0]
        self.out[f] = [_warp_sum(flux)[0], _warp_sum(total)[0]]

    def frame(self, f, i, warp, mag, nyq):
        if i > 0 or (i == 0 and warp == 0):
            self.emit(f, mag, nyq, *self.prev[warp])
        elif i == 0:
            self.first[warp] = (f, mag, nyq)
        self.prev[warp] = (mag, nyq)
        if i == WARP_FRAMES - 1:
            self.edges[0][warp], self.edges[1][warp] = mag, nyq

    def tile_done(self, warp):
        lb = self.edges[0][(warp - 1) % WARPS], self.edges[1][(warp - 1) % WARPS]
        if warp == 0:
            self.prev[0] = lb
        elif self.first[warp] is not None:
            f, mag, nyq = self.first[warp]
            self.emit(f, mag, nyq, *lb)
        self.first[warp] = None


def frame_tiles(x, n_frames, hop, offset, tiles_per_block, ep):
    """frame_tiles.cuh:frame_tiles over one song `x [T]`, every block of the
    grid in turn: a tile's span (and `ep.lookback` frames before it) staged
    with zeros outside [0, T), warp w on frames 4w - n .. 4w + 3 of the tile,
    `ep.tile_done` after the tile's closing barrier."""
    look = ep.lookback
    span = (TILE + look - 1) * hop + 512
    n_tiles = -(-n_frames // TILE)
    for t_begin in range(0, n_tiles, tiles_per_block):
        for t in range(t_begin, min(t_begin + tiles_per_block, n_tiles)):
            start = (t * TILE - look) * hop - offset
            idx = start + np.arange(span)
            buf = np.where((idx >= 0) & (idx < x.shape[0]), x[np.clip(idx, 0, x.shape[0] - 1)], F32(0))
            todo = []  # (warp, i, f, j) in each warp's order
            for w in range(WARPS):
                for i in range(-ep.lookback_frames(t == t_begin, w), WARP_FRAMES):
                    j = w * WARP_FRAMES + i
                    if t * TILE + j >= n_frames:
                        break
                    todo.append((w, i, t * TILE + j, j))
            sigs = np.stack([buf[(j + look) * hop : (j + look) * hop + 512] for *_, j in todo])
            mags, nyqs = ep.body(sigs)
            for (w, i, f, _), mag, nyq in zip(todo, mags, nyqs):
                ep.frame(f, i, w, mag, nyq)
            for w in range(WARPS):
                ep.tile_done(w)
    return ep.out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _song_frames(n_frames, hop=128, seed=0):
    """Raw 512-sample frames of a synthetic song (tones, chords, clicks, noise)."""
    from chip_smoke import synth_song

    x = synth_song(np.random.default_rng(seed), 22050 * 20)
    return np.lib.stride_tricks.sliding_window_view(x, 512)[::hop][:n_frames].copy()


def _notched_frame(rng, k0=100, residue=1e-5):
    """A loud frame (a tone with a windowed peak near 9 over a noise floor)
    whose windowed bin k0 is brought to ~`residue` by a sinusoid at k0: the
    class of the worst timbral frame recorded on the card, one bin near zero
    under a loud peak."""
    n = np.arange(512)
    x = 0.07 * np.sin(2 * np.pi * 20.0 * n / 512 + 0.3) + 0.01 * rng.standard_normal(512)
    basis = np.stack([np.cos(2 * np.pi * k0 * n / 512), np.sin(2 * np.pi * k0 * n / 512)])
    resp = np.fft.rfft(basis * HANN, axis=-1)[:, k0]
    want = np.fft.rfft(x * HANN)[k0] - residue
    a = np.linalg.solve(np.array([[resp[0].real, resp[1].real], [resp[0].imag, resp[1].imag]]),
                        np.array([want.real, want.imag]))
    return (x - a @ basis).astype(F32)


def _special_frames():
    """A quiet frame, a silent frame and a loud frame with one bin near 9e-6
    under a peak near 9 (the worst frame recorded on the card: 8.65e-6
    under 9.15)."""
    raw = _song_frames(3, seed=3)
    raw[0] *= F32(1e-4)
    raw[1] = 0.0
    raw[2] = _notched_frame(np.random.default_rng(9), residue=8.65e-6)
    return raw


def _notched_class(n=200):
    """`n` loud frames with one notched bin each, at bins 30..249 and
    residues 5e-6..2e-5: the class in which two f32 FFTs disagree most on
    the geometric mean."""
    rng = np.random.default_rng(1)
    return np.stack([
        _notched_frame(rng, k0=int(rng.integers(30, 250)), residue=float(rng.uniform(5e-6, 2e-5)))
        for _ in range(n)
    ])


def _geo_err(m, exact):
    """Per-frame distance of the geometric mean exp2(mean log2 m) to f64's,
    relative (the flatness ingredient the timbral log2 sum carries)."""
    with np.errstate(divide="ignore"):
        return np.abs(np.log2(m).mean(-1) - np.log2(exact).mean(-1)) * np.log(2)


# ---------------------------------------------------------------------------
# the body
# ---------------------------------------------------------------------------


def test_warp_rfft512_body_emulated_against_f64_and_torch():
    """The body's magnitudes within 1e-6 of each frame's max of an f64 FFT
    on 2,000 frames of a synthetic song, a quiet, a silent and 200 notched
    loud frames (silence gives zeros); the per-frame geometric mean of the
    buggy 256-slot layout (the flatness ingredient) no farther from f64 than
    torch's f32 FFT, within 2x: its largest distance over the song, and its
    mean and 90th percentile over the notched class."""
    song = _song_frames(2000)
    notched = _notched_class()
    raw = np.concatenate([song, _special_frames()[:2], notched])
    emu = _bins(*warp_rfft512_mags(raw)).astype(np.float64)
    xw = (raw * HANN).astype(F32)
    exact = np.abs(np.fft.rfft(xw.astype(np.float64), axis=-1))
    live = exact.max(1) > 0
    assert np.isfinite(emu).all() and (emu[~live] == 0).all() and live.sum() == len(raw) - 1
    assert (np.abs(emu - exact).max(1)[live] / exact.max(1)[live]).max() < 1e-6
    f32 = torch.abs(torch.fft.rfft(torch.as_tensor(xw))).numpy().astype(np.float64)

    def geo(m, rows):
        buggy = np.concatenate([m[rows, :255], m[rows, 256:]], 1)
        exact_b = np.concatenate([exact[rows, :255], exact[rows, 256:]], 1)
        return _geo_err(buggy, exact_b)

    on_song = slice(0, len(song))
    assert geo(emu, on_song).max() <= 2 * geo(f32, on_song).max() + 1e-7
    on_notch = slice(len(raw) - len(notched), len(raw))
    e_emu, e_f32 = geo(emu, on_notch), geo(f32, on_notch)
    # one notched bin decides a frame's distance, so its largest value over
    # 200 frames moves 2x either way between seeds; its mean and its 90th
    # percentile stay within 25% of torch's
    assert e_emu.mean() <= 2 * e_f32.mean()
    assert np.quantile(e_emu, 0.9) <= 2 * np.quantile(e_f32, 0.9)
    assert exact[on_notch].max(1).min() > 8 and exact[on_notch].min(1).max() < 3e-5


def test_warp_radix2_body_emulated_equals_the_block_radix2():
    """The warp schedule of fft_radix2_dit's arithmetic (its two padded
    transposes, the lane ^ 16 exchange of stage 9, lane 0's Nyquist bin)
    gives the block-wide body's magnitudes bit for bit, on the song's frames
    and on the quiet, silent and notched ones."""
    raw = np.concatenate([_song_frames(500), _special_frames(), _notched_class(20)])
    got = _bins(*warp_radix2_512_mags(raw))
    assert np.array_equal(got, _radix2_reference(raw))


@pytest.mark.parametrize("hop,offset,tiles_per_block", [(256, -1000, 2), (128, 384, 3)])
def test_tile_loop_emulated_stages_every_frame(hop, offset, tiles_per_block):
    """frame_dft_mags through the emulated tile loop (staging with zeros
    outside [0, T), a negative offset, tiles that end inside a block's run,
    frames past the end) == the body on the same frames framed directly, bit
    for bit, and within 1e-5 of each frame's max of the plain version."""
    rng = np.random.default_rng(hop)
    x = (rng.normal(size=hop * 150 + 77) * 0.1).astype(F32)
    n_frames = (x.shape[0] + offset) // hop + 3
    got = frame_tiles(x, n_frames, hop, offset, tiles_per_block, MagsEpilogue(n_frames))
    pad = np.concatenate([np.zeros(max(offset, 0), F32), x[max(-offset, 0):], np.zeros(hop * n_frames + 512, F32)])
    direct = _bins(*warp_rfft512_mags(np.lib.stride_tricks.sliding_window_view(pad, 512)[::hop][:n_frames]))
    assert np.array_equal(got, direct)
    want = TD.frame_dft_mags_plain(torch.as_tensor(x)[None], hop, offset, n_frames)[0].numpy()
    assert (np.abs(got - want).max(1) / np.maximum(want.max(1), 1e-30)).max() < 1e-5


# ---------------------------------------------------------------------------
# timbral rows and SpecFlux against the Pallas kernels and the plain versions
# ---------------------------------------------------------------------------


def _hold_rows(got, want):
    """chip_smoke.py's limits for timbral rows: total, weighted, energy
    relative 1e-5; below +-1; the log2 sum through the geometric mean, 1e-4;
    non-finite entries equal."""
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and np.array_equal(got[~fin], want[~fin])
    with np.errstate(invalid="ignore"):  # -inf - -inf where fin is False
        diff = np.where(fin, np.abs(got - want), 0.0)
    scale = np.maximum(np.where(fin, np.abs(want), 0.0), 1e-30)
    assert (diff[:, [0, 1, 4]] / scale[:, [0, 1, 4]]).max() < 1e-5
    assert diff[:, 2].max() <= 1
    assert (diff[:, 3] * np.log(2) / 256).max() < 1e-4


def test_warp_timbral_rows_emulated_match_pallas_interpret_and_plain():
    """Rows of the emulated timbral_fft (tile loop, warp-layout epilogue) vs
    the FFT-structured Pallas kernel at the tolerances of
    test_torch_kernels.py::test_timbral_plain_matches_pallas_interpret, and
    vs the port's plain version at chip_smoke.py's limits."""
    hop, n_frames, offset = 128, 200, 384
    rng = np.random.default_rng(4)
    sig = (rng.normal(size=hop * (n_frames + 10)) * 0.1).astype(F32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            JD.pallas_frame_dft_timbral(
                jnp.asarray(np.concatenate([np.zeros(offset, F32), sig])), 512, hop, n_frames
            )
        )
    got = frame_tiles(sig, n_frames, hop, offset, 2, TimbralEpilogue(n_frames))
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1)
    np.testing.assert_allclose(np.exp2(got[:, 3] / 256), np.exp2(want[:, 3] / 256), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-4, atol=1e-6)
    _hold_rows(got, TD.timbral_fft_plain(torch.as_tensor(sig)[None], n_frames)[0].numpy())


def test_warp_timbral_rows_emulated_on_special_frames():
    """The quiet, silent and notched frames as a song of their own (hop 512,
    no overlap) through the timbral epilogue: total 0 and log2 sum -inf on
    silence, as the plain version gives; every row at chip_smoke.py's limits
    against the plain version."""
    raw = _special_frames()
    n = raw.shape[0]
    rows = TimbralEpilogue(n)
    mags, nyqs = rows.body(raw)
    for f in range(n):
        rows.frame(f, 0, 0, mags[f], nyqs[f])
    got = rows.out
    plain = TD.framed_pvoc_mags(torch.as_tensor(raw.reshape(-1))[None], 512, 512, 0, n, buggy=True)
    want = TD.timbral_rows(plain)[0].numpy()
    assert got[1, 0] == 0 and got[1, 3] == -np.inf and want[1, 3] == -np.inf
    _hold_rows(got, want)


@pytest.mark.parametrize("tiles_per_block", [1, 2, 3])
def test_warp_specflux_emulated_matches_pallas_interpret_and_plain(tiles_per_block):
    """The emulated specflux (tile loop, lookback across warps by the edge
    buffer, across tiles by warp 0's carry, across block runs by one extra
    transform) vs the Pallas
    SpecFlux kernel at the tolerance of
    test_torch_kernels.py::test_specflux_plain_matches_pallas_interpret,
    and vs the plain version at 1e-5 of the song's largest onset; the first
    frame of every block run and of every warp agrees too."""
    hop, n_frames, offset = 256, 300, 256
    rng = np.random.default_rng(5)
    sig = (rng.normal(size=hop * (n_frames + 5)) * 0.1).astype(F32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            JD.pallas_frame_dft_specflux(
                jnp.asarray(np.concatenate([np.zeros(offset, F32), sig])), 512, hop, n_frames
            )
        )
    rows = frame_tiles(sig, n_frames, hop, offset, tiles_per_block, FluxEpilogue(n_frames))
    assert np.isfinite(rows).all()
    got = np.concatenate([rows[:1, 1], rows[1:, 0]])  # the wrapper's onset[0] = total[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    plain = TD.specflux_plain(torch.as_tensor(sig)[None], n_frames)[0].numpy()
    err = np.abs(got - plain) / np.abs(plain).max()
    assert err.max() < 1e-5
    assert rows[0, 0] == rows[0, 1]  # frame -1 is zeros: flux == total
    firsts = np.arange(0, n_frames, WARP_FRAMES)
    assert err[firsts].max() < 1e-5 and err[np.arange(0, n_frames, TILE * tiles_per_block)].max() < 1e-5


def _notch_statistics() -> None:
    """The statistics PERF.md quotes for the notched class and for the worst
    frame of chip_smoke.py's seed-0 8 x 5-min batch:

        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_warp_fft.py

    (1) over 3 x 1,000 notched loud frames, each transform's per-frame
    geometric-mean distance to an f64 FFT of the same f32 windowed frame
    (mean, 90th and 99th percentile, max), and how often each body sits
    more than 1e-4 from torch's f32 FFT; (2) the smallest bins of frame 6750
    of song 6 of that batch (samples [863616, 864128)), exact and as each
    transform rounds them."""
    from chip_smoke import synth_song

    def buggy(m):
        return np.concatenate([m[..., :255], m[..., 256:]], -1)

    bodies = {
        "8 x 8 x 4": lambda raw: _bins(*warp_rfft512_mags(raw)),
        "radix-2": _radix2_reference,
        "torch f32": lambda raw: torch.abs(torch.fft.rfft(torch.as_tensor((raw * HANN).astype(F32)))).numpy(),
    }
    for seed in (1, 2, 3):
        rng = np.random.default_rng(seed)
        raw = np.stack([_notched_frame(rng, k0=int(rng.integers(30, 250)),
                                       residue=float(rng.uniform(5e-6, 2e-5))) for _ in range(1000)])
        exact = np.abs(np.fft.rfft((raw * HANN).astype(F32).astype(np.float64), axis=-1))
        mags = {name: fn(raw).astype(np.float64) for name, fn in bodies.items()}
        for name, m in mags.items():
            g = _geo_err(buggy(m), buggy(exact))
            apart = np.abs(np.log2(buggy(m)).mean(-1) - np.log2(buggy(mags["torch f32"])).mean(-1)) * np.log(2)
            print(f"seed {seed} {name}: geo-mean distance to f64 mean {g.mean():.3g} p90 "
                  f"{np.quantile(g, 0.9):.3g} p99 {np.quantile(g, 0.99):.3g} max {g.max():.3g}; "
                  f"frames over 1e-4 from torch f32 {(apart > 1e-4).mean():.2%}")
    rng = np.random.default_rng(0)
    for _ in range(7):
        song = synth_song(rng, 300 * 22050)
    raw = song[863616:864128][None]
    exact = np.abs(np.fft.rfft((raw * HANN).astype(F32).astype(np.float64), axis=-1))[0]
    low = np.argsort(exact)[:3]
    print(f"song 6 frame 6750: smallest bins {low.tolist()}, exact {exact[low].tolist()}")
    for name, fn in bodies.items():
        print(f"  {name}: {fn(raw)[0][low].astype(np.float64).tolist()}")


if __name__ == "__main__":
    _notch_statistics()
