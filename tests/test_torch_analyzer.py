"""The port's analysis path end to end on the CPU: the golden vectors of
tests/test_song.py, side by side with the JAX package's analyzer, ragged
batches, the pinned piano.wav vector of chip_smoke.py and the constant
tables."""

import pytest

# the JAX package's comparisons: a host without JAX skips this module
pytest.importorskip("jax")

import wave

import numpy as np
import torch

from bliss_tpu.io.decoder import FFmpegDecoder
from bliss_tpu.models import analyzer as JA
from bliss_tpu_torch import Song
from bliss_tpu_torch.errors import AnalysisError
from bliss_tpu_torch.models import analyzer as TA
from bliss_tpu_torch.tables import default_tables, tables_from_numpy
from chip_smoke import PIANO_V2
from test_song import GOLDEN_V1, GOLDEN_V2

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)


def _piano_wav(data_dir) -> np.ndarray:
    with wave.open(str(data_dir / "piano.wav")) as w:
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


@pytest.mark.parametrize(
    "version,golden,dtype",
    [
        (2, GOLDEN_V2, torch.float64),
        (1, GOLDEN_V1, torch.float64),
        (2, GOLDEN_V2, torch.float32),  # the card's precision, plain kernels
    ],
)
def test_golden_vectors(decoded_s16_mono, version, golden, dtype):
    """The reference's golden vectors (src/song/mod.rs:524-843) at 1e-5."""
    out = TA.build_analyzer(version, device="cpu", dtype=dtype)(decoded_s16_mono)
    np.testing.assert_allclose(out, golden, atol=1e-5)
    assert abs(out[0] - 0.3846389) < 1e-5  # tempo


def test_song_analyze(decoded_s16_mono):
    a = Song.analyze(decoded_s16_mono, device="cpu")
    np.testing.assert_allclose(a.as_vec(), GOLDEN_V2, atol=1e-5)
    with pytest.raises(AnalysisError, match="too short"):
        Song.analyze([0.0] * 100, device="cpu")


@pytest.mark.parametrize(
    "name,atol",
    [
        ("piano.flac", 1e-5),
        ("white_noise.mp3", 1e-5),
        # a pure synthetic chord: its true spectrum sits below the f32 FFT
        # noise floor, so flatness depends on which f32 FFT rounds it
        # (torch's vs XLA's, ~1e-3 here); the repo's contract for this
        # class is 2e-2 plus the same dominant chroma (PERF §25)
        ("chroma/Cmaj.ogg", 2e-2),
    ],
)
def test_side_by_side_with_jax(data_dir, name, atol):
    """The same samples through both packages' CPU f64 paths."""
    x = np.asarray(FFmpegDecoder.decode(data_dir / name).sample_array)
    want = JA.build_analyzer(2)(x)
    got = TA.build_analyzer(2, device="cpu")(x)
    np.testing.assert_allclose(got, want, atol=atol)
    assert np.argmax(got[10:]) == np.argmax(want[10:])


def test_pinned_piano_vector(data_dir):
    """PIANO_V2 (held by chip_smoke.py on the card) is the JAX package's CPU
    f64 vector of piano.wav, and the port's CPU path reproduces it."""
    x = _piano_wav(data_dir)
    want = JA.build_analyzer(2)(x)
    np.testing.assert_allclose(want, PIANO_V2, rtol=0, atol=1e-6)
    got = TA.analyze_samples(x, x.shape[0], 2, device="cpu").numpy()
    np.testing.assert_allclose(got, PIANO_V2, atol=1e-5)


def test_ragged_batch_matches_single(data_dir, decoded_s16_mono):
    """A ragged `[2, T]` batch == each song analyzed alone (1e-6)."""
    a = _piano_wav(data_dir)
    b = decoded_s16_mono
    t = max(a.shape[0], b.shape[0])
    batch = np.zeros((2, t), np.float32)
    batch[0, : a.shape[0]] = a
    batch[1, : b.shape[0]] = b
    got = TA.analyze_batch(batch, [a.shape[0], b.shape[0]], 2, device="cpu")
    single = TA.build_analyzer(2, device="cpu")
    np.testing.assert_allclose(got[0], single(a), atol=1e-6)
    np.testing.assert_allclose(got[1], single(b), atol=1e-6)
    v1 = TA.analyze_batch(batch, [a.shape[0], b.shape[0]], 1, device="cpu")
    np.testing.assert_array_equal(v1[:, :10], got[:, :10])


def test_batch_rejects_short_songs():
    with pytest.raises(AnalysisError):
        TA.analyze_batch(np.zeros((1, 9000), np.float32), [100], device="cpu")


def _jax_tables() -> dict:
    from bliss_tpu.models.chroma import _chroma_filter_table, _template_product_indices
    from bliss_tpu.models.tempo import _bt_constants
    from bliss_tpu.ops.windows import _hann_np

    bt = _bt_constants(22050)
    return {
        "hann_512": _hann_np(512),
        "hann_8192": _hann_np(8192),
        "chroma_filter": _chroma_filter_table(8192),
        "interval_indices": _template_product_indices(),
        "bt_rwv": bt.rwv,
        "bt_dfwv": bt.dfwv,
    }


def test_tables_equal_jax_bit_for_bit():
    from bliss_tpu.models.tempo import _bt_constants
    from bliss_tpu.ops.pallas_dft import _timbral_fft_consts

    own = default_tables().arrays
    for name, ref in _jax_tables().items():
        assert own[name].dtype == np.asarray(ref).dtype, name
        np.testing.assert_array_equal(own[name], ref, err_msg=name)
    # the radix-4 plane twiddle W_512^n1 (q = 1) of the TPU timbral kernel
    rows, _ = _timbral_fft_consts()
    np.testing.assert_array_equal(own["twiddle_512"][:, :128], rows[2:4])
    from bliss_tpu_torch.models.tempo import _bt_constants as port_bt

    bt, pb = _bt_constants(22050), port_bt("cpu")
    assert (pb.winlen, pb.step, pb.laglen, pb.rayparam_trunc) == (
        bt.winlen, bt.step, bt.laglen, bt.rayparam_trunc,
    )
    assert np.float32(pb.g_var) == np.float32(bt.g_var)


def test_tables_from_jax_give_the_same_vector(decoded_s16_mono):
    tables = tables_from_numpy(_jax_tables())
    x = decoded_s16_mono
    got = TA.build_analyzer(2, device="cpu", dtype=torch.float32, tables=tables)(x)
    own = TA.build_analyzer(2, device="cpu", dtype=torch.float32)(x)
    np.testing.assert_array_equal(got, own)
    with pytest.raises(ValueError):
        tables_from_numpy({"bt_rwv": np.zeros(3, np.float32)})
