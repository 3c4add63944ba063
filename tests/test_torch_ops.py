"""The port's ops (bliss_tpu_torch/ops) against the JAX package's and the
golden fixtures of tests/test_ops.py, on the CPU at f64 where the JAX
function runs at f64. Inputs come from numpy with fixed seeds; each check
states its tolerance."""

import pytest

# the JAX package's comparisons: a host without JAX skips this module
pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from bliss_tpu.ops import reductions as JR
from bliss_tpu.ops import spectral as JS
from bliss_tpu.ops import windows as JW
from bliss_tpu_torch.ops import reductions as TR
from bliss_tpu_torch.ops import spectral as TS
from bliss_tpu_torch.ops import windows as TW

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("n", [512, 2048, 8192])
def test_hann_bit_identical(n):
    np.testing.assert_array_equal(
        TW.hann_periodic(n).numpy(), np.asarray(JW.hann_periodic(n))
    )


@pytest.mark.parametrize("length", [8192, 9000, 30011])
def test_frame_counts(length):
    assert TW.n_frames_strided(length, 512, 128) == int(JW.n_frames_strided(length, 512, 128))
    assert TW.n_frames_stft(length, 2205) == int(JW.n_frames_stft(length, 2205))
    lengths = torch.tensor([length, length + 1])
    assert TW.n_frames_stft(lengths, 2205).tolist() == [
        int(JW.n_frames_stft(v, 2205)) for v in (length, length + 1)
    ]


def test_reflect_pad():
    arr = torch.arange(0.0, 100000.0, dtype=torch.float64)
    out = TW.reflect_pad(arr, 3).numpy()
    np.testing.assert_array_equal(out[:4], [3.0, 2.0, 1.0, 0.0])
    np.testing.assert_array_equal(out[3:100003], np.arange(100000.0))
    np.testing.assert_array_equal(out[100003:], [99998.0, 99997.0, 99996.0])


@pytest.mark.parametrize("offset,hop", [(0, 128), (384, 128), (256, 256), (385, 128)])
def test_frame_signal_matches_jax(offset, hop):
    rng = np.random.default_rng(offset + hop)
    sig = rng.normal(size=5000)
    n_frames = 50  # runs past the end: the tail reads zeros
    want = np.asarray(JW.frame_signal(jnp.asarray(sig), 512, hop, offset, n_frames))
    got = TW.frame_signal(_t(sig), 512, hop, offset, n_frames).numpy()
    np.testing.assert_array_equal(got, want)


def test_reflect_pad_signal_ragged_matches_jax():
    """Each row of a ragged batch == the JAX dynamic-length padding (exact)."""
    rng = np.random.default_rng(1)
    t, w = 12000, 2048
    lengths = [12000, 9001]
    sig = rng.normal(size=(2, t))
    sig[1, lengths[1]:] = 0.0
    got = TW.reflect_pad_signal(_t(sig), lengths, w).numpy()
    for i, n in enumerate(lengths):
        want = np.asarray(JW.reflect_pad_signal(jnp.asarray(sig[i]), n, w))
        np.testing.assert_array_equal(got[i], want)
    frames = TW.frame_signal_reflect(_t(sig), lengths, w, 512, 20).numpy()
    want = np.asarray(JW.frame_signal_reflect(jnp.asarray(sig[1]), lengths[1], w, 512, 20))
    np.testing.assert_array_equal(frames[1], want)


@pytest.mark.parametrize("density", [1.0, 0.6, 0.1])
def test_masked_mean_std_match_jax(density):
    rng = np.random.default_rng(int(density * 10))
    vals = rng.normal(size=(3, 501))
    mask = rng.random((3, 501)) < density
    for port, ref in [(TR.masked_mean, JR.masked_mean), (TR.masked_std, JR.masked_std)]:
        got = port(_t(vals), _t(mask)).numpy()
        want = np.asarray(ref(jnp.asarray(vals), jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_masked_reductions_values():
    vals = torch.tensor([1.0, 2.0, 3.0, 99.0, 98.0], dtype=torch.float64)
    mask = torch.tensor([True, True, True, False, False])
    assert abs(float(TR.masked_mean(vals, mask)) - 2.0) < 1e-12
    assert abs(float(TR.masked_std(vals, mask)) - np.std([1.0, 2.0, 3.0])) < 1e-12


@pytest.mark.parametrize("trial", range(4))
def test_masked_quantile_midpoint_matches_jax(trial):
    """Midpoint median == the JAX sort path exactly, incl. duplicates and
    the empty mask (+inf)."""
    rng = np.random.default_rng(10 + trial)
    vals = rng.normal(size=(2, 333)).astype(np.float32)
    if trial == 1:
        vals = np.round(vals)
    mask = rng.random((2, 333)) < [0.5, 0.9, 0.05, 0.0][trial]
    got = TR.masked_quantile_midpoint(_t(vals), _t(mask)).numpy()
    for i in range(2):
        want = float(JR.masked_quantile_midpoint(jnp.asarray(vals[i]), jnp.asarray(mask[i])))
        assert got[i] == want or (np.isinf(got[i]) and np.isinf(want))


def test_masked_quantile_values():
    vals = torch.tensor([5.0, 1.0, 3.0, 100.0])
    assert float(TR.masked_quantile_midpoint(vals, torch.tensor([True, True, True, False]))) == 3.0
    assert float(TR.masked_quantile_midpoint(vals, torch.ones(4, dtype=torch.bool))) == 4.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_sort_key_matches_jax(dtype):
    """The port's signed key == the JAX unsigned key with its top bit
    flipped, and `_key_to_float` inverts it bit for bit."""
    rng = np.random.default_rng(5)
    x = np.concatenate(
        [rng.normal(size=1000) * 10.0 ** rng.integers(-30, 30, 1000), [0.0, -0.0, np.inf, -np.inf]]
    ).astype(dtype)
    got = TR._float_sort_key(_t(x)).numpy()
    jkey = np.asarray(JR._float_sort_key(jnp.asarray(x)))
    bits = 64 if dtype == np.float64 else 32
    signed = np.int64 if bits == 64 else np.int32
    want = (jkey ^ (np.array(1, jkey.dtype) << (bits - 1))).view(signed)
    np.testing.assert_array_equal(got, want)
    order = np.argsort(got, kind="stable")
    assert np.all(np.diff(x[order].astype(np.float64)) >= 0)
    back = TR._key_to_float(_t(got), torch.float32 if bits == 32 else torch.float64).numpy()
    np.testing.assert_array_equal(back.view(signed), x.view(signed))


def test_geometric_mean_and_zcr_match_jax():
    assert float(TR.geometric_mean(torch.tensor([0.0, 1, 2, 3]))) == 0.0
    vals = torch.tensor([256.0, 4, 2, 1, 4, 2, 1, 2], dtype=torch.float64)
    assert abs(float(TR.geometric_mean(vals)) - 3.668016172818685) < 1e-9
    rng = np.random.default_rng(2)
    sig = rng.normal(size=(2, 4000)).astype(np.float32)
    got = TR.zero_crossing_count(_t(sig), torch.tensor([4000, 2500])).tolist()
    want = [int(JR.zero_crossing_count(jnp.asarray(sig[i]), n)) for i, n in enumerate([4000, 2500])]
    assert got == want
    assert int(TR.zero_crossing_count(torch.tensor([-1.0, 1.0] * 512))) == 1023
    assert TR.normalize_range(5.0, 0.0, 10.0) == 0.0


def test_stft_librosa_fixture(data_dir):
    """STFT vs the librosa golden fixture (src/utils.rs:527-541), 1e-4."""
    from bliss_tpu.io.decoder import FFmpegDecoder

    expected = np.load(data_dir / "librosa-stft.npy").astype(np.float64)
    song = np.asarray(FFmpegDecoder.decode(data_dir / "piano.flac").sample_array)
    out = TS.stft(_t(song).reshape(1, -1), 2048, 512)[0].numpy()
    assert out.shape[0] == expected.shape[0]
    n = min(out.shape[1], expected.shape[1])
    np.testing.assert_allclose(out[:, :n], expected[:, :n], atol=1e-4)


def test_stft_ragged_matches_jax():
    """Masked STFT over a padded ragged batch == the JAX stft of each song
    (f32 FFTs from two libraries: 1e-5 of the spectrum's max)."""
    rng = np.random.default_rng(0)
    lengths = [30011, 22000]
    sig = np.zeros((2, 40960), np.float32)
    for i, n in enumerate(lengths):
        sig[i, :n] = rng.normal(size=n)
    nf = int(TW.n_frames_stft(40960, 2205))
    got = TS.stft(_t(sig), 8192, 2205, lengths=lengths, n_frames=nf).numpy()
    for i, n in enumerate(lengths):
        want = np.asarray(JS.stft(jnp.asarray(sig[i]), 8192, 2205, length=n, n_frames=nf))
        assert got[i].shape == want.shape
        assert np.abs(got[i] - want).max() <= 1e-5 * want.max()


@pytest.mark.parametrize("buggy", [False, True])
def test_pvoc_mags_match_jax(buggy):
    rng = np.random.default_rng(3)
    sig = rng.normal(size=6000).astype(np.float32)
    offset = 384 if buggy else 256
    hop = 128 if buggy else 256
    got = TS.framed_pvoc_mags(_t(sig), 512, hop, offset, 40, buggy=buggy).numpy()
    want = np.asarray(JS.framed_pvoc_mags(jnp.asarray(sig), 512, hop, offset, 40, buggy=buggy))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * want.max())
    frames = TW.frame_signal(_t(sig), 512, hop, offset, 40)
    port = (TS.pvoc_mags_buggy if buggy else TS.pvoc_mags)(frames).numpy()
    np.testing.assert_array_equal(port, got)
