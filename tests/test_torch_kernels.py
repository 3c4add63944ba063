"""Each kernel module of the port against the JAX Pallas kernel it replaces.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the Pallas kernels run as tests/test_pallas.py runs them (TPU
interpret mode, `interpret=True`, or the plain JAX reference where the
kernel has no interpret guarantee). Tests marked `cuda` hold the
hand-written CUDA kernels against the plain versions on a card and skip
without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bliss_tpu.models import chroma as JC
from bliss_tpu.ops import pallas_dft as JD
from bliss_tpu.ops import spectral as JS
from bliss_tpu.ops.pallas_hist import histogram_threshold_plane as j_hist
from bliss_tpu.ops.pallas_select import bisect16_pair as j_bisect
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


def test_kernel_fft_arithmetic_emulated():
    """The kernels' FFT structure, emulated in numpy f32 on frames of a
    synthetic song: the 512-point complex FFT of csrc/timbral_fft.cu and
    csrc/specflux.cu, and the 8192-point real FFT of csrc/ct_stft.cu
    (4096-point complex FFT + even/odd split), each within 1e-6 of the
    frame's max of an f64 FFT; and the geometric mean of the 512-point
    magnitudes (the flatness ingredient) no farther from f64 than
    torch's f32 FFT, within 2x (the same f32 noise class)."""
    from bliss_tpu_torch.tables import twiddles
    from bliss_tpu_torch.ops.windows import _hann_np
    from chip_smoke import synth_song

    x = synth_song(np.random.default_rng(0), 22050 * 20)
    # 512: the timbral/specflux transform
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
    # 8192: the chroma transform, packed real -> complex half size + split
    frames = np.lib.stride_tricks.sliding_window_view(x, 8192)[::2205][:40]
    fr = (frames * _hann_np(8192)).astype(np.float32)
    tw = twiddles(8192)
    rev = _bit_reverse(12)
    re, im = _radix2_emulated(
        fr[:, 0::2][:, rev].copy(), fr[:, 1::2][:, rev].copy(), 12, tw, 2
    )
    m = 4096
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
        TT.bisect16_pair(
            torch.empty((1, 8, 8), dtype=torch.int16, device="meta"),
            torch.empty((1, 2), dtype=torch.int32, device="meta"),
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
    rng = np.random.default_rng(sum(shape))
    plane = _plane(rng, shape, density, spread)
    n = int((plane != 32767).sum())
    for ks in [(0, 0), ((n - 1) // 2, n // 2), (max(n - 1, 0), max(n - 1, 0)), (n + 3, n + 5)]:
        ks = np.asarray([ks], np.int32)
        want = np.asarray(j_bisect(jnp.asarray(plane), jnp.asarray(ks), interpret=True))
        got = TT.bisect16_pair(_t(plane)[None], _t(ks)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_histogram_threshold_matches_pallas_interpret(seed):
    rng = np.random.default_rng(seed)
    shape = (33, 157)
    idx8 = rng.integers(-3, 105, size=shape).astype(np.int8)
    skey = rng.integers(-(2**31), 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)
    tk = np.int32(rng.integers(-(2**30), 2**30))
    want = np.asarray(j_hist(jnp.asarray(idx8), jnp.asarray(skey), jnp.asarray(tk).reshape(1, 1), 100, interpret=True))
    got = TT.histogram_threshold_plane(_t(idx8)[None], _t(skey)[None], torch.tensor([tk]), 100)
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


@pytest.mark.cuda
def test_cuda_ct_kernel_matches_plain(cuda):
    rng = np.random.default_rng(12)
    padded = torch.as_tensor((rng.normal(size=(2, 120000)) * 0.1).astype(np.float32), device=cuda)
    for w, hop in ((8192, 2205), (2048, 512)):
        nf = (padded.shape[1] - w) // hop + 1
        got = TD.ct_stft_mags(padded, w, hop, nf)
        want = TD.ct_stft_mags_plain(padded, w, hop, nf)
        assert ((got - want).abs().amax(1) / want.amax(1)).max() < 1e-5


@pytest.mark.cuda
def test_cuda_tuning_kernels_exact(cuda):
    rng = np.random.default_rng(13)
    plane = torch.as_tensor(_plane(rng, (4, 900, 1400), 0.07, 3000), device=cuda)
    n = (plane != 32767).flatten(1).sum(1).to(torch.int32)
    ks = torch.stack([(n - 1) // 2, n // 2], 1).clamp(min=0).to(torch.int32).contiguous()
    assert torch.equal(TT.bisect16_pair(plane, ks), TT.bisect16_pair_plain(plane, ks))
    idx8 = torch.as_tensor(rng.integers(-3, 105, (4, 900, 1400)).astype(np.int8), device=cuda)
    skey = torch.as_tensor(rng.integers(-(2**31), 2**31 - 1, (4, 900, 1400), dtype=np.int64).astype(np.int32), device=cuda)
    tk = torch.as_tensor(rng.integers(-(2**30), 2**30, 4).astype(np.int32), device=cuda)
    assert torch.equal(
        TT.histogram_threshold_plane(idx8, skey, tk, 100),
        TT.histogram_threshold_plane_plain(idx8, skey, tk, 100),
    )
