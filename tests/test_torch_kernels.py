"""Each kernel module of the port against the JAX Pallas kernel it replaces.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the Pallas kernels run as tests/test_pallas.py runs them (TPU
interpret mode, `interpret=True`, or the plain JAX reference where the
kernel has no interpret guarantee). Tests marked `cuda` hold the
hand-written CUDA kernels against the plain versions on a card and skip
without one.
"""

import numpy as np
import pytest
import torch

from bliss_tpu_torch.models import chroma as TC
from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.ops import dft_kernels as TD
from bliss_tpu_torch.ops import tuning_kernels as TT

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# DFT kernels: plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def test_timbral_plain_matches_pallas_interpret():
    """Rows (total, weighted, below, log2 sum, energy) vs the FFT-structured
    Pallas kernel: 1e-4 relative (two f32 FFTs), below +-1 (ties)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from bliss_tpu.ops import pallas_dft as JD

    hop, n_frames, offset = 128, 200, 384
    rng = np.random.default_rng(4)
    sig = (rng.normal(size=hop * (n_frames + 10)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            JD.pallas_frame_dft_timbral(
                jnp.asarray(np.concatenate([np.zeros(offset, np.float32), sig])),
                512, hop, n_frames,
            )
        )
    got = TD.timbral_fft(_t(sig).reshape(1, -1), n_frames)[0].numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1)
    np.testing.assert_allclose(
        np.exp2(got[:, 3] / 256), np.exp2(want[:, 3] / 256), rtol=1e-4, atol=1e-7
    )
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-4, atol=1e-6)


def test_specflux_plain_matches_pallas_interpret():
    """Onset vs the Pallas SpecFlux kernel (bf16x3 products): 1e-4."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from bliss_tpu.ops import pallas_dft as JD

    hop, n_frames, offset = 256, 300, 256
    rng = np.random.default_rng(5)
    sig = (rng.normal(size=hop * (n_frames + 5)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            JD.pallas_frame_dft_specflux(
                jnp.asarray(np.concatenate([np.zeros(offset, np.float32), sig])),
                512, hop, n_frames,
            )
        )
    got = TD.specflux(_t(sig).reshape(1, -1), n_frames)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ct_plain_matches_pallas_interpret():
    """|STFT| vs the CT Pallas kernel on the same frames: 1e-5 of the max
    (the fused in-kernel-framing variant has no interpret guarantee; this
    one computes the same CT DFT over pre-framed input)."""
    import jax.numpy as jnp

    from bliss_tpu.ops import pallas_dft as JD

    rng = np.random.default_rng(3)
    w, hop, f = 8192, 2205, 37
    padded = (rng.normal(size=(f - 1) * hop + w) * 0.1).astype(np.float32)
    got = TD.ct_stft_mags(_t(padded).reshape(1, -1), w, hop, f)[0].numpy()
    frames = np.lib.stride_tricks.sliding_window_view(padded, w)[::hop][:f]
    want = np.asarray(JD.pallas_stft_mags_ct(jnp.asarray(frames), n_frames=f, interpret=True))
    assert got.shape == want.shape == (w // 2 + 1, f)
    assert np.abs(got - want).max() / want.max() < 1e-5


def test_ct_plain_matches_jax_stft():
    """The chroma STFT path (reflect padding + CT kernel) vs the JAX stft
    on the CPU: 1e-5 of the max."""
    import jax.numpy as jnp

    from bliss_tpu.ops import spectral as JS

    from bliss_tpu_torch.ops.spectral import stft

    rng = np.random.default_rng(6)
    n = 30000
    sig = (rng.normal(size=n) * 0.1).astype(np.float32)
    got = stft(_t(sig).reshape(1, -1), 8192, 2205)[0].numpy()
    want = np.asarray(JS.stft(jnp.asarray(sig), 8192, 2205))
    assert np.abs(got - want).max() / want.max() < 1e-5


def _radix2_emulated(re, im, log2n, tw, tw_scale):
    """numpy f32 copy of csrc/fft_common.cuh:fft_radix2_dit's index and
    butterfly arithmetic, over the last axis (every row at once)."""
    half_n = 1 << (log2n - 1)
    t = np.arange(half_n)
    for s in range(1, log2n + 1):
        half = 1 << (s - 1)
        stride = (half_n >> (s - 1)) * tw_scale
        pos = t & (half - 1)
        i = ((t >> (s - 1)) << s) | pos
        j = i + half
        wr, wi = tw[0][pos * stride], tw[1][pos * stride]
        jr, ji, ir, ii = re[:, j], im[:, j], re[:, i], im[:, i]
        xr = jr * wr - ji * wi
        xi = jr * wi + ji * wr
        re[:, j], im[:, j] = ir - xr, ii - xi
        re[:, i], im[:, i] = ir + xr, ii + xi
    return re, im


def _bit_reverse(n_bits):
    v = np.arange(1 << n_bits)
    return np.array([int(format(k, f"0{n_bits}b")[::-1], 2) for k in v])


def _dft4(r0, i0, r1, i1, r2, i2, r3, i3):
    """csrc/fft_common.cuh:dft4 (natural order in and out)."""
    s0r, s0i, s1r, s1i = r0 + r2, i0 + i2, r0 - r2, i0 - i2
    s2r, s2i, s3r, s3i = r1 + r3, i1 + i3, i1 - i3, r3 - r1
    return [s0r + s2r, s0i + s2i, s1r + s3r, s1i + s3i,
            s0r - s2r, s0i - s2i, s1r - s3r, s1i - s3i]


def _turn(re, im, wr, wi):
    return re * wr - im * wi, re * wi + im * wr


_C1, _S1, _C2 = (np.float32(v) for v in (0.92387953251128675613, 0.38268343236508977173,
                                           0.70710678118654752440))
_W16 = [(np.float32(1), np.float32(0)), (_C1, -_S1), (_C2, -_C2), (_S1, -_C1),
        (np.float32(0), np.float32(-1)), (-_S1, -_C1), (-_C2, -_C2), (-_C1, -_S1),
        (np.float32(-1), np.float32(0)), (-_C1, _S1)]


def _dft16(re, im):
    """csrc/fft_common.cuh:dft16 on 16 register arrays: a 4-point DFT over a
    of x[4a + b] for each b, the turn W_16^(b*c), a 4-point DFT over b."""
    re, im = list(re), list(im)
    for b in range(4):
        out = _dft4(re[b], im[b], re[4 + b], im[4 + b], re[8 + b], im[8 + b], re[12 + b], im[12 + b])
        re[b], im[b], re[4 + b], im[4 + b], re[8 + b], im[8 + b], re[12 + b], im[12 + b] = out
    for b in range(1, 4):
        for c in range(1, 4):
            i = b + 4 * c
            re[i], im[i] = _turn(re[i], im[i], *_W16[b * c])
    tr, ti = [None] * 16, [None] * 16
    for c in range(4):
        out = _dft4(*[v for j in range(4) for v in (re[4 * c + j], im[4 * c + j])])
        for d in range(4):
            tr[c + 4 * d], ti[c + 4 * d] = out[2 * d], out[2 * d + 1]
    return tr, ti


def _twiddle8192(tw, p):
    """csrc/fft_common.cuh:twiddle<8192>: W_8192^p by the integer phase p."""
    p = np.asarray(p) & 8191
    q = np.where(p <= 4096, p, 8192 - p)
    return tw[0][q], np.where(p <= 4096, tw[1][q], -tw[1][q])


def _last_row(tid):
    """csrc/ct_stft.cu:last_row: the bin row q of thread tid."""
    w, lane = tid >> 5, tid & 31
    lo = lane & 15
    mirror = np.where((w == 0) & (lo == 0), 128, 256 - 16 * w - lo)
    return np.where(lane < 16, 16 * w + lo, mirror)


def _ct8192_emulated(fr, tw):
    """numpy f32 copy of csrc/ct_stft.cu:ct8192_kernel (design 0) on
    windowed frames `fr [F, 8192]`: thread by thread (the 256 threads on the
    last axis), the same index split m = 256 n1 + 16 n2 + n3, k = k1 + 16 k2
    + 256 k3, the same three radix-16 passes and exchange layouts, the same
    integer-phase twiddles, the lane layout of the last pass and its
    untangling against the mirror bin found by the lane ^ 16 shuffle."""
    zr, zi = fr[:, 0::2], fr[:, 1::2]
    tid = np.arange(256)
    hi, lo = tid >> 4, tid & 15
    # pass 1: thread (n2, n3) = tid transforms z[256 n1 + tid] over n1
    re, im = _dft16([zr[:, 256 * n1 + tid] for n1 in range(16)],
                    [zi[:, 256 * n1 + tid] for n1 in range(16)])
    p1r, p1i = np.empty_like(zr), np.empty_like(zi)
    for k1 in range(16):
        if k1:
            re[k1], im[k1] = _turn(re[k1], im[k1], *_twiddle8192(tw, 32 * hi * k1))
        p1r[:, 256 * k1 + tid], p1i[:, 256 * k1 + tid] = re[k1], im[k1]
    # pass 2: thread (k1, n3) = (hi, lo) transforms over n2
    at = [256 * hi + 16 * n2 + lo for n2 in range(16)]
    re, im = _dft16([p1r[:, a] for a in at], [p1i[:, a] for a in at])
    lr = np.zeros((zr.shape[0], 256 * 17), np.float32)
    li = np.zeros_like(lr)
    for k2 in range(16):
        re[k2], im[k2] = _turn(re[k2], im[k2], *_twiddle8192(tw, 2 * lo * (hi + 16 * k2)))
        lr[:, (hi + 16 * k2) * 17 + lo], li[:, (hi + 16 * k2) * 17 + lo] = re[k2], im[k2]
    # pass 3: row q transforms over n3, leaving Z[q + 256 k3] in register k3
    q = _last_row(tid)
    re, im = _dft16([lr[:, q * 17 + j] for j in range(16)], [li[:, q * 17 + j] for j in range(16)])
    mags = np.empty((zr.shape[0], 4097), np.float32)
    partner = tid ^ 16
    for k3 in range(16):
        c, d = re[15 - k3][:, partner], im[15 - k3][:, partner]
        c = np.where(q == 0, re[(16 - k3) & 15], np.where(q == 128, re[15 - k3], c))
        d = np.where(q == 0, im[(16 - k3) & 15], np.where(q == 128, im[15 - k3], d))
        a, b = re[k3], im[k3]
        half = np.float32(0.5)
        er, ei, pr, pi = half * (a + c), half * (b - d), half * (b + d), half * (c - a)
        ur, ui = _twiddle8192(tw, q + 256 * (k3 & 7))
        wr, wi = (ur, ui) if k3 < 8 else (ui, -ur)  # W_8192^2048 == -i
        yr, yi = er + (wr * pr - wi * pi), ei + (wr * pi + wi * pr)
        mags[:, q + 256 * k3] = np.sqrt(yr * yr + yi * yi)
    mags[:, 4096] = np.abs(re[0][:, 0] - im[0][:, 0])
    return mags


def _chroma_frames(n_frames=40):
    """Hann-windowed 8192/2205 frames of a synthetic song, f32."""
    from bliss_tpu_torch.ops.windows import _hann_np
    from chip_smoke import synth_song

    x = synth_song(np.random.default_rng(0), 22050 * 20)
    frames = np.lib.stride_tricks.sliding_window_view(x, 8192)[::2205][:n_frames]
    return frames, (frames * _hann_np(8192)).astype(np.float32)


def test_kernel_fft_arithmetic_emulated():
    """The kernels' FFT structure, emulated in numpy f32 on frames of a
    synthetic song: the block-wide radix-2 body of csrc/fft_common.cuh
    (fft_radix2_dit) as a 512-point complex FFT of real frames, and as
    csrc/ct_stft.cu runs it for widths below 8192 (2048 here: a complex FFT
    of half size + even/odd split), and the 8192-point body (16 x 16 x 16),
    each within 1e-6 of the frame's max of an f64 FFT; and the geometric
    mean of the 512-point magnitudes (the flatness ingredient) no farther
    from f64 than torch's f32 FFT, within 2x (the same f32 noise class).
    The warp body of the 512-point kernels: tests/test_torch_warp_fft.py."""
    from bliss_tpu_torch.tables import twiddles
    from bliss_tpu_torch.ops.windows import _hann_np
    from chip_smoke import synth_song

    x = synth_song(np.random.default_rng(0), 22050 * 20)
    # 512: the radix-2 body on 512 complex points
    frames = np.lib.stride_tricks.sliding_window_view(x, 512)[::128][:2000]
    fr = (frames * _hann_np(512)).astype(np.float32)
    rev = _bit_reverse(9)
    re, im = _radix2_emulated(fr[:, rev].copy(), np.zeros_like(fr), 9, twiddles(512), 1)
    emu = np.sqrt(re * re + im * im)[:, :257].astype(np.float64)
    exact = np.abs(np.fft.rfft(fr.astype(np.float64), axis=-1))
    assert (np.abs(emu - exact).max(1) / exact.max(1)).max() < 1e-6
    f32 = torch.abs(torch.fft.rfft(torch.as_tensor(fr))).numpy().astype(np.float64)

    def geo_err(m):
        return np.abs(np.log2(m).mean(1) - np.log2(exact).mean(1)) * np.log(2)

    assert geo_err(emu).max() <= 2 * geo_err(f32).max() + 1e-7
    # 2048: ct_stft.cu's radix-2 body, packed real -> complex half size + split
    w = 2048
    frames = np.lib.stride_tricks.sliding_window_view(x, w)[::512][:200]
    fr = (frames * _hann_np(w)).astype(np.float32)
    tw = twiddles(w)
    rev = _bit_reverse(10)
    re, im = _radix2_emulated(
        fr[:, 0::2][:, rev].copy(), fr[:, 1::2][:, rev].copy(), 10, tw, 2
    )
    m = w // 2
    k = np.arange(m + 1)
    a, b = k & (m - 1), (m - k) & (m - 1)
    ar, ai, br, bi = re[:, a], im[:, a], re[:, b], im[:, b]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    o_r, o_i = 0.5 * (ai + bi), -0.5 * (ar - br)
    xr = er + (tw[0] * o_r - tw[1] * o_i)
    xi = ei + (tw[0] * o_i + tw[1] * o_r)
    emu = np.sqrt(xr * xr + xi * xi).astype(np.float64)
    exact = np.abs(np.fft.rfft(fr.astype(np.float64), axis=-1))
    assert (np.abs(emu - exact).max(1) / exact.max(1)).max() < 1e-6
    # 8192: the chroma transform, ct8192_kernel's 16 x 16 x 16 body
    _, fr = _chroma_frames()
    emu = _ct8192_emulated(fr, twiddles(8192)).astype(np.float64)
    exact = np.abs(np.fft.rfft(fr.astype(np.float64), axis=-1))
    assert (np.abs(emu - exact).max(1) / exact.max(1)).max() < 1e-6


def test_ct8192_body_emulated_matches_pallas_interpret():
    """The 8192-point body, emulated in numpy f32 (`_ct8192_emulated`),
    against the JAX package's CT Pallas kernel on the same frames in
    interpret mode: within 1e-5 of each frame's max; and within 1e-6 of an
    f64 FFT, on quiet and silent frames too."""
    import jax.numpy as jnp

    from bliss_tpu.ops import pallas_dft as JD

    from bliss_tpu_torch.ops.windows import _hann_np
    from bliss_tpu_torch.tables import twiddles

    raw = _chroma_frames(37)[0].copy()
    raw[5] *= 1e-4  # a quiet frame
    raw[6] = 0.0    # silence
    fr = (raw * _hann_np(8192)).astype(np.float32)
    emu = _ct8192_emulated(fr, twiddles(8192))
    want = np.asarray(JD.pallas_stft_mags_ct(jnp.asarray(raw), n_frames=raw.shape[0], interpret=True)).T
    assert emu.shape == want.shape == (37, 4097)
    assert np.isfinite(emu).all() and (emu[6] == 0).all()
    scale = np.maximum(want.max(1), 1e-30)
    assert (np.abs(emu - want).max(1) / scale).max() < 1e-5
    exact = np.abs(np.fft.rfft(fr.astype(np.float64), axis=-1))
    live = exact.max(1) > 0
    assert (np.abs(emu - exact).max(1)[live] / exact.max(1)[live]).max() < 1e-6


@pytest.mark.parametrize("name", ["timbral_fft", "specflux", "ct_stft_mags"])
def test_wrapper_on_cpu_is_the_plain_version(name):
    """On a CPU tensor a wrapper returns its plain version's result and
    launches nothing."""
    rng = np.random.default_rng(7)
    sig = _t((rng.normal(size=(2, 20000)) * 0.1).astype(np.float32))
    _build.reset_launches()
    if name == "ct_stft_mags":
        got = TD.ct_stft_mags(sig, 2048, 512, 20)
        want = TD.ct_stft_mags_plain(sig, 2048, 512, 20)
    else:
        got = getattr(TD, name)(sig, 100)
        want = getattr(TD, name + "_plain")(sig, 100)
    assert torch.equal(got, want)
    assert _build.LAUNCHES == {}


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        TD.timbral_fft(torch.empty((1, 4096), device="meta"), 10)
    with pytest.raises(ValueError):
        TT.tuning_peaks(
            torch.empty((1, 8, 4097), device="meta"),
            torch.empty((1, 8), dtype=torch.bool, device="meta"),
            *TC.peak_band(8192),
        )


# ---------------------------------------------------------------------------
# tuning kernels: exact integers
# ---------------------------------------------------------------------------


def _plane(rng, shape, density, spread):
    u = rng.integers(32768 - spread, 32768 + spread, size=shape)
    u[rng.random(shape) > density] = 0xFFFF  # excluded
    return (u - 32768).astype(np.int16)


@pytest.mark.parametrize(
    "shape,density,spread",
    [((37, 250), 0.3, 300), ((64, 129), 0.02, 30000), ((5, 7), 1.0, 3), ((20, 40), 0.0, 10)],
)
def test_bisect16_pair_matches_pallas_interpret(shape, density, spread):
    import jax.numpy as jnp

    from bliss_tpu.ops.pallas_select import bisect16_pair as j_bisect

    rng = np.random.default_rng(sum(shape))
    plane = _plane(rng, shape, density, spread)
    n = int((plane != 32767).sum())
    for ks in [(0, 0), ((n - 1) // 2, n // 2), (max(n - 1, 0), max(n - 1, 0)), (n + 3, n + 5)]:
        ks = np.asarray([ks], np.int32)
        want = np.asarray(j_bisect(jnp.asarray(plane), jnp.asarray(ks), interpret=True))
        got = TT.bisect16_pair_plain(_t(plane)[None], _t(ks)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_histogram_threshold_matches_pallas_interpret(seed):
    import jax.numpy as jnp

    from bliss_tpu.ops.pallas_hist import histogram_threshold_plane as j_hist

    rng = np.random.default_rng(seed)
    shape = (33, 157)
    idx8 = rng.integers(-3, 105, size=shape).astype(np.int8)
    skey = rng.integers(-(2**31), 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)
    tk = np.int32(rng.integers(-(2**30), 2**30))
    want = np.asarray(j_hist(jnp.asarray(idx8), jnp.asarray(skey), jnp.asarray(tk).reshape(1, 1), 100, interpret=True))
    got = TT.histogram_threshold_plane_plain(_t(idx8)[None], _t(skey)[None], torch.tensor([tk]), 100)
    np.testing.assert_array_equal(got[0].numpy(), want)


def _peaky_spectra(seed, bins=4097, frames=173):
    rng = np.random.default_rng(seed)
    spec = (rng.random((bins, frames)) ** 8).astype(np.float32)
    spec[rng.integers(0, bins, 400), rng.integers(0, frames, 400)] += (
        rng.random(400).astype(np.float32) * 20.0
    )
    return spec


def test_fused_tuning_matches_pallas_interpret():
    """The port's fused estimator (plain kernel versions, f32) == the JAX
    fused estimator under interpret mode, bit for bit; silence gives 0."""
    import jax.numpy as jnp

    from bliss_tpu.models import chroma as JC

    fmask = np.ones(173, bool)
    fmask[-7:] = False
    specs = [_peaky_spectra(0), np.zeros((4097, 173), np.float32)]
    got = TC._estimate_tuning_fused(
        _t(np.stack(specs)), _t(np.stack([fmask, fmask])), 8192
    ).numpy()
    for i, spec in enumerate(specs):
        want = float(JC._estimate_tuning_fused(jnp.asarray(spec), jnp.asarray(fmask), 8192, interpret=True))
        assert float(got[i]) == want
    assert float(got[1]) == 0.0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tuning_estimators_match_jax(seed):
    """Fused (f32, counting kernels) and sort-based (f64) estimators both
    equal the JAX unfused estimate_tuning, exactly."""
    import jax.numpy as jnp

    from bliss_tpu.models import chroma as JC

    spec = _peaky_spectra(seed)
    fmask = np.ones(173, bool)
    fmask[:5] = False
    want32 = float(JC.estimate_tuning(jnp.asarray(spec), jnp.asarray(fmask), 8192))
    got32 = float(TC._estimate_tuning_fused(_t(spec)[None], _t(fmask)[None], 8192)[0])
    assert got32 == want32
    spec64 = spec.astype(np.float64)
    want64 = float(JC.estimate_tuning(jnp.asarray(spec64), jnp.asarray(fmask), 8192))
    got64 = float(TC.estimate_tuning(_t(spec64)[None], _t(fmask)[None], 8192)[0])
    assert got64 == want64


# ---------------------------------------------------------------------------
# on the card: hand-written kernels vs their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_frame_kernels_match_plain(cuda):
    rng = np.random.default_rng(11)
    sig = torch.as_tensor((rng.normal(size=(3, 200000)) * 0.1).astype(np.float32), device=cuda)
    got = TD.timbral_fft(sig, 1500)
    want = TD.timbral_fft_plain(sig, 1500)
    for c in (0, 1, 4):
        assert ((got[..., c] - want[..., c]).abs() / want[..., c].abs().clamp(min=1e-30)).max() < 1e-5
    assert (got[..., 2] - want[..., 2]).abs().max() <= 1
    assert ((got[..., 3] - want[..., 3]).abs() * np.log(2) / 256).max() < 1e-4
    on = TD.specflux(sig, 700)
    on_p = TD.specflux_plain(sig, 700)
    assert ((on - on_p).abs().amax(1) / on_p.abs().amax(1)).max() < 1e-5


def _frame_rel(got, want, dim):
    return ((got - want).abs().amax(dim) / want.amax(dim).clamp(min=1e-30)).max()


@pytest.mark.cuda
def test_cuda_ct_kernel_matches_plain(cuda):
    """Both entries of csrc/ct_stft.cu against their plain versions, 1e-5
    of each frame's max: B = 2 and B = 3 (an odd length, 1,350 frames: no
    multiple of the card's resident blocks), frames past the end of the
    signal (zeros; through the C entry, the wrapper refuses them), N = 1 and
    a ragged N of pre-framed rows, rows at a 4-byte offset, and the widths
    2048 and 4096 of the radix-2 body."""
    rng = np.random.default_rng(12)
    for shape in ((2, 120000), (3, 1_000_003)):
        padded = torch.as_tensor((rng.normal(size=shape) * 0.1).astype(np.float32), device=cuda)
        for w, hop in ((8192, 2205), (2048, 512)):
            nf = (padded.shape[1] - w) // hop + 1
            got = TD.ct_stft_mags(padded, w, hop, nf)
            want = TD.ct_stft_mags_plain(padded, w, hop, nf)
            assert _frame_rel(got, want, 1) < 1e-5
    w, hop = 8192, 2205
    nf = (padded.shape[1] - w) // hop + 5
    win, tw = TD._constants(w, str(padded.device))
    out = torch.empty((3, nf, w // 2 + 1), device=cuda)
    fn = _build.function("ct_stft", "ct_stft_launch", TD._FRAME_ARGS)
    _build.check("ct_stft", fn(
        _build.ptr(padded), 3, padded.shape[1], nf, hop, 13, _build.ptr(win), _build.ptr(tw[0]),
        _build.ptr(tw[1]), _build.ptr(out), _build.stream_ptr(padded.device)))
    ext = torch.nn.functional.pad(padded, (0, (nf - 1) * hop + w - padded.shape[1]))
    assert _frame_rel(out.transpose(1, 2), TD.ct_stft_mags_plain(ext, w, hop, nf), 1) < 1e-5
    for n, width, offset in ((1, 8192, 0), (1001, 8192, 0), (257, 8192, 1), (300, 4096, 0)):
        flat = torch.as_tensor((rng.normal(size=n * width + offset) * 0.1).astype(np.float32), device=cuda)
        frames = flat[offset:].view(n, width)
        got, want = TD.ct_frames_mags(frames), TD.ct_frames_mags_plain(frames)
        assert _frame_rel(got, want, 0) < 1e-5


@pytest.mark.cuda
def test_cuda_tuning_kernels_exact(cuda):
    """The fused route's two kernels against their plain versions on the
    card: the peak list as a multiset, then the select's every output."""
    spec = torch.as_tensor(
        np.stack([_peaky_spectra(s, frames=900).T for s in (13, 14, 15)]), device=cuda
    ).contiguous()
    fmask = torch.ones((3, 900), dtype=torch.bool, device=cuda)
    fmask[1, -50:] = False
    band = TC.peak_band(8192)
    keys, bins, n = TT.tuning_peaks(spec, fmask, *band)
    keys_p, bins_p, n_p = TT.tuning_peaks_plain(spec, fmask, *band)
    assert torch.equal(n, n_p)
    for i in range(3):
        m = int(n[i])
        got = keys[i, :m].to(torch.int64) * 256 + bins[i, :m]
        want = keys_p[i, :m].to(torch.int64) * 256 + bins_p[i, :m]
        assert torch.equal(torch.sort(got).values, torch.sort(want).values)
    got, want = TT.tuning_select(keys, bins, n), TT.tuning_select_plain(keys, bins, n)
    for k in want:
        assert torch.equal(got[k], want[k]), k
