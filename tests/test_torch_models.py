"""The port's descriptor models (bliss_tpu_torch/models) stage by stage
against the JAX package's, on the CPU, with numpy inputs from fixed seeds.
Each check states its tolerance."""

import pytest

# the JAX package's comparisons: a host without JAX skips this module
pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from bliss_tpu.models import chroma as JC
from bliss_tpu.models import loudness as JL
from bliss_tpu.models import tempo as JT
from bliss_tpu.models import timbral as JB
from bliss_tpu_torch.models import chroma as TC
from bliss_tpu_torch.models import loudness as TL
from bliss_tpu_torch.models import tempo as TT
from bliss_tpu_torch.models import timbral as TB

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _signal(seed, n=40000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=n)
    return x.astype(np.float32)


def test_timbral_descriptors_match_jax():
    """Per-frame centroid / rolloff / flatness from magnitudes, f32: 1e-5
    relative (rolloff exact up to the +-1 bin tie tolerance)."""
    x = _signal(0)
    mags_j = JB.spectral_frame_mags(jnp.asarray(x), 200)
    want = [np.asarray(v) for v in JB.frame_descriptors_from_mags(mags_j)]
    mags_t = TB.spectral_frame_mags(_t(x)[None], 200)
    got = [v[0].numpy() for v in TB.frame_descriptors_from_mags(mags_t)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=22050 / 512 + 1e-3)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)


@pytest.mark.parametrize("length", [40000, 31111])
def test_spectral_loudness_zcr_match_jax(length):
    x = _signal(1)
    x[length:] = 0.0
    j = jnp.asarray(x)
    got = TB.spectral_features(_t(x)[None], torch.tensor([length]))[0].numpy()
    want = np.asarray(JB.spectral_features(j, length))
    np.testing.assert_allclose(got[[0, 1, 4, 5]], want[[0, 1, 4, 5]], atol=1e-5)
    # rolloff: a +-1 bin tie on the 95% energy line (cumsum order) in one
    # of ~150 frames moves the normalized mean by ~5e-5
    np.testing.assert_allclose(got[2:4], want[2:4], atol=1e-4)
    got = TL.loudness_features(_t(x)[None], torch.tensor([length]))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(JL.loudness_features(j, length)), atol=1e-6)
    got = float(TB.zcr_feature(_t(x)[None], torch.tensor([length]))[0])
    assert abs(got - float(JB.zcr_feature(j, length))) < 1e-7


def test_tempo_parallel_stages_match_jax():
    """Onset, adaptive threshold and silence gates, f32: the onset to 1e-6
    relative and the threshold to 1e-6 of its scale (sums of 257 and of 7
    terms taken in another order), the silence gates exact."""
    x = _signal(2)
    x[20000:25000] = 0.0
    h = 150
    mags = JT.framed_pvoc_mags(jnp.asarray(x), 512, 256, offset=256, n_frames=h)
    onset_j = np.asarray(JT.onset_function(mags))
    onset_t = TT.onset_function(_t(np.array(mags))).numpy()
    np.testing.assert_allclose(onset_t, onset_j, rtol=1e-6)
    want = np.asarray(JT.thresholded_series(jnp.asarray(onset_j)))
    got = TT.thresholded_series(_t(onset_j)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(
        TT.silence_flags_blocked(_t(x)[None], h)[0].numpy(),
        np.asarray(JT.silence_flags_blocked(jnp.asarray(x), h)),
    )


def test_double_slow_tempi_equals_repeated_doubling():
    """The closed-form doubling == 32 conditional doublings, bit for bit."""
    rng = np.random.default_rng(3)
    bp = np.concatenate(
        [rng.uniform(0, 30, 5000), 10.0 ** rng.uniform(-45, 2, 5000), [0.0, -3.0, 25.0, 24.999998, 1e-40]]
    ).astype(np.float32)
    want = bp.copy()
    for _ in range(32):
        want = np.where((want > 0) & (want < 25), want * np.float32(2), want).astype(np.float32)
    np.testing.assert_array_equal(TT._double_slow_tempi(_t(bp)).numpy(), want)


def test_tempo_from_series_matches_jax():
    """The beat tracker on the same thresholded series: the BPM feature
    exact (a discrete decision chain), per song of a ragged batch."""
    rng = np.random.default_rng(4)
    h = 2600
    period = 43  # hops per beat, ~120 BPM
    onset = (rng.random((2, h)) * 0.1).astype(np.float32)
    onset[:, ::period] += 3.0
    thresh = np.stack([np.asarray(JT.thresholded_series(jnp.asarray(o))) for o in onset])
    silent = np.zeros((2, h), bool)
    silent[1, 1000:1400] = True
    h_valid = np.array([h, 2100])
    consts = TT._bt_constants("cpu")
    got = TT.tempo_from_series(_t(thresh), _t(silent), _t(h_valid), consts).numpy()
    for i in range(2):
        want = float(JT.tempo_from_series(jnp.asarray(thresh[i]), jnp.asarray(silent[i]), int(h_valid[i])))
        assert float(got[i]) == want, (i, got[i], want)


def test_hz_to_octs_fixture():
    out = TC.hz_to_octs(torch.tensor([32.0, 64, 128, 256], dtype=torch.float64), 0.5, 10)
    np.testing.assert_allclose(out.numpy(), [0.16864029, 1.16864029, 2.16864029, 3.16864029], atol=1e-4)


def test_chroma_filter_matches_jax():
    """The f64 in-graph filterbank for two tunings: 1e-12."""
    got = TC.chroma_filter(8192, torch.tensor([0.0, -0.23], dtype=torch.float64), torch.float64).numpy()
    for i, tuning in enumerate([0.0, -0.23]):
        want = np.asarray(JC.chroma_filter(8192, tuning, jnp.float64))
        np.testing.assert_allclose(got[i], want, rtol=1e-12, atol=1e-14)


def test_pip_track_and_chroma_stft_match_jax():
    rng = np.random.default_rng(5)
    spec = (rng.random((4097, 60)) ** 6 * 5.0).astype(np.float64)
    fmask = np.ones(60, bool)
    fmask[-4:] = False
    want = [np.asarray(v) for v in JC.pip_track(jnp.asarray(spec), jnp.asarray(fmask), 8192)]
    got = [v[0].numpy() for v in TC.pip_track(_t(spec)[None], _t(fmask)[None], 8192)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tuning = float(JC.estimate_tuning(jnp.asarray(spec), jnp.asarray(fmask), 8192))
    want = np.asarray(JC.chroma_stft_from_spectrum(jnp.asarray(spec), tuning, 8192))
    got = TC.chroma_stft_from_spectrum(_t(spec)[None], torch.tensor([tuning], dtype=torch.float64), 8192)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("version", [1, 2])
def test_interval_features_and_postprocess_match_jax(version):
    rng = np.random.default_rng(6 + version)
    chroma = rng.random((12, 80))
    chroma /= chroma.sum(0)
    fmask = rng.random(80) < 0.9
    raw_j = np.asarray(JC.chroma_interval_features(jnp.asarray(chroma), jnp.asarray(fmask)))
    raw_t = TC.chroma_interval_features(_t(chroma)[None], _t(fmask)[None])[0].numpy()
    np.testing.assert_allclose(raw_t, raw_j, rtol=1e-12)
    post_j = JC._postprocess_v1 if version == 1 else JC._postprocess_v2
    post_t = TC._postprocess_v1 if version == 1 else TC._postprocess_v2
    np.testing.assert_allclose(
        post_t(_t(raw_j)[None])[0].numpy(), np.asarray(post_j(jnp.asarray(raw_j))), atol=1e-6
    )
