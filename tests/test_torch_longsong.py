"""The port's time-sharded long-song analyzer on the CPU: the cases of
tests/test_longsong.py through both packages on the same numpy inputs.

The port (`shards=8, device="cpu"`, shards as a leading tensor axis) is
held against `bliss_tpu.parallel.longsong` on the 8-device CPU mesh and
against the port's own bucketed analyzer, both at `atol=2e-5` (the JAX
tests' tolerance: f32 reduction order across shards)."""

import pytest

# the JAX package's comparisons: a host without JAX skips this module
pytest.importorskip("jax")

import wave

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bliss_tpu.parallel import make_mesh
from bliss_tpu.parallel import longsong as JL
from bliss_tpu_torch.models import analyzer as TA
from bliss_tpu_torch.models import chroma as TC
from bliss_tpu_torch.ops import reductions as TR
from bliss_tpu_torch.parallel import longsong as TL

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

ATOL = 2e-5


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return make_mesh(8, axis="time")


def _noise_tone(t, seed, freq, amp):
    rng = np.random.default_rng(seed)
    sig = (rng.normal(size=t) * 0.1).astype(np.float32)
    if amp:
        sig += amp * np.sin(2 * np.pi * freq * np.arange(t) / 22050.0).astype(np.float32)
    return sig


def _musical(t, seed):
    rng = np.random.default_rng(seed)
    sig = (rng.normal(size=t) * 0.08).astype(np.float32)
    n = np.arange(t, dtype=np.float32)
    sig += 0.3 * np.sin(2 * np.pi * 220.0 * n / 22050.0).astype(np.float32)
    # beats, so the tempo path has real structure
    env = (0.4 + 0.6 * (np.sin(2 * np.pi * 2.0 * n / 22050.0) > 0)).astype(np.float32)
    return sig * env


def _chroma_case(name, decoded):
    """(signal, length) of one chroma case of tests/test_longsong.py."""
    t = 8 * 32768
    if name == "synthetic":
        return _noise_tone(t, 0, 440.0, 0.3), t
    if name == "masked_length":
        length = t - 50000
        sig = np.zeros(t, np.float32)
        sig[:length] = _noise_tone(length, 1, 0.0, 0.0)
        return sig, length
    if name == "real_song":
        sig = np.zeros(t, np.float32)
        sig[: decoded.shape[0]] = decoded
        return sig, decoded.shape[0]
    if name == "non_divisible":
        t = 8 * 32768 + 12345
        return _noise_tone(t, 3, 523.25, 0.2), t
    if name == "short":
        return _noise_tone(30011, 4, 0.0, 0.0), 30011  # < 8 * (8192 + 2205)
    assert name == "45s_regression"
    return _musical(45 * 22050, 12), 45 * 22050


def _bucketed_chroma(sig, length, dtype):
    x = torch.as_tensor(sig).reshape(1, -1)
    return TC.chroma_features(x, torch.tensor([length]), 2, dtype)[0].numpy()


@pytest.mark.parametrize(
    "name",
    ["synthetic", "masked_length", "real_song", "non_divisible", "short", "45s_regression"],
)
def test_sharded_chroma_matches_jax_and_bucketed(mesh, decoded_s16_mono, name):
    sig, length = _chroma_case(name, decoded_s16_mono)
    got = TL.sharded_chroma_features(sig, length, device="cpu", dtype=torch.float32)
    want = JL.sharded_chroma_features(mesh, sig, length)
    assert got.shape == (13,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, _bucketed_chroma(sig, length, torch.float32), atol=ATOL)
    # the CPU default (f64 chroma stage) against the port's f64 bucketed path
    got64 = TL.sharded_chroma_features(sig, length, device="cpu")
    np.testing.assert_allclose(got64, _bucketed_chroma(sig, length, torch.float64), atol=ATOL)


def _full_case(name):
    if name == "45s_v2":
        t = 45 * 22050
        return _musical(t, 10), t, 2
    t = 20 * 22050 + 7777  # masked length + version 1 vectors
    length = t - 31234
    sig = np.zeros(t, np.float32)
    sig[:length] = _musical(length, 11)
    return sig, length, 1


@pytest.mark.parametrize("name", ["45s_v2", "ragged_v1"])
def test_sharded_full_pipeline_matches_jax_and_bucketed(mesh, name):
    """All 23 (20) features: port sharded == JAX sharded == port bucketed.
    45 s exercises frame ownership across every shard boundary."""
    sig, length, version = _full_case(name)
    got = TL.sharded_analyze_samples(sig, length, version, device="cpu", dtype=torch.float32)
    want = JL.sharded_analyze_samples(mesh, sig, length, version=version)
    assert got.shape == ((23,) if version == 2 else (20,)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    # tempo is discrete: the same beats, up to the two packages' rounding
    # of the BPM normalization
    assert abs(got[0] - want[0]) < 1e-6
    own = TA.analyze_samples(sig, length, version, torch.float32, "cpu").numpy()
    np.testing.assert_allclose(got, own, atol=ATOL)
    assert got[0] == own[0]


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_shard_counts_give_the_same_vector(shards):
    """The CPU default (f64 chroma) at any shard count == the bucketed path."""
    t = 30 * 22050 + 4321
    sig = _musical(t, 20)
    got = TL.sharded_analyze_samples(sig, t, shards=shards, device="cpu")
    want = TA.analyze_samples(sig, t, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got[0] == want[0]


def _write_wav(path, sig):
    s16 = np.clip(sig * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(s16.tobytes())


def test_long_song_routed_through_batch_analysis(tmp_path):
    """`analyze_paths_batched(longsong_samples=...)` sends a song above the
    bound through the sharded analyzer (launching nothing bucketed for it),
    and the result matches the bucketed route; below the bound and with the
    default `None` the song stays bucketed."""
    from bliss_tpu_torch import Song
    from bliss_tpu_torch.io import batch as TB
    from bliss_tpu_torch.io.decoder import DefaultDecoder

    wav = tmp_path / "long.wav"
    _write_wav(wav, _musical(70 * 22050, 13))
    calls = []
    real = TL.sharded_analyze_samples

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "sharded_analyze_samples", spy)
        routed = dict(
            TB.analyze_paths_batched(
                DefaultDecoder, [wav], device="cpu", longsong_samples=30 * 22050,
                longsong_shards=4,
            )
        )[wav]
        assert len(calls) == 1 and calls[0]["shards"] == 4
        bucketed = dict(TB.analyze_paths_batched(DefaultDecoder, [wav], device="cpu"))[wav]
        under = dict(
            TB.analyze_paths_batched(
                DefaultDecoder, [wav], device="cpu", longsong_samples=10**9
            )
        )[wav]
        assert len(calls) == 1
    assert isinstance(routed, Song) and isinstance(bucketed, Song)
    np.testing.assert_allclose(
        routed.analysis.as_arr1(), bucketed.analysis.as_arr1(), atol=ATOL
    )
    np.testing.assert_array_equal(under.analysis.as_arr1(), bucketed.analysis.as_arr1())
    assert routed.path == bucketed.path and routed.duration == bucketed.duration


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,d", [(262144, 8), (30011, 8), (992250, 8), (83886080, 8), (5000, 3)])
def test_shard_geometry_matches_jax(t, d):
    assert TL._shard_geometry(t, d) == JL._shard_geometry(t, d)
    assert TL.HALO == JL.HALO == 10397


def test_full_width_shapes():
    """One 60-minute song in 8 shards: the shapes the kernels get."""
    shard_len, t_pad = TL._shard_geometry(TA.bucket_length(79_380_000, 1 << 17), 8)
    assert (shard_len, t_pad) == (10_485_760, 83_886_080)
    assert shard_len // TL.HOP + 2 == 4757
    assert (shard_len // 256, shard_len // 128, shard_len // 1024) == (40_960, 81_920, 10_240)
    assert TL.HALO + shard_len + TL.HALO == 10_506_554


def test_halo_exchange_and_collectives():
    d, n = 4, 2 * TL.HALO
    x = torch.arange(d * n, dtype=torch.float32).reshape(d, n)
    left, right = TL.halo_exchange(x)
    assert left.shape == right.shape == (d, TL.HALO)
    assert not left[0].any() and not right[-1].any()  # zeros at the global edges
    for i in range(1, d):
        assert torch.equal(left[i], x[i - 1, -TL.HALO :])
        assert torch.equal(right[i - 1], x[i, : TL.HALO])
    assert torch.equal(TL.psum(x), x.sum(0))
    assert TL.all_gather(x).reshape(-1).tolist() == x.flatten().tolist()


@pytest.mark.parametrize("seed,density", [(0, 0.3), (1, 1.0), (2, 0.001), (3, 0.0)])
def test_global_median_equals_sort_bit_for_bit(seed, density):
    """The 2 x 32 counting rounds select exactly the sort-based midpoint
    median of all shards' masked values (and agree with the JAX key)."""
    rng = np.random.default_rng(seed)
    vals = (rng.normal(size=(8, 37, 53)) * 10.0 ** rng.integers(-3, 3, (8, 37, 53))).astype(np.float32)
    vals[0, 0, :5] = [0.0, -0.0, 1e-40, -1e-40, 3.0]
    mask = rng.random(vals.shape) < density
    if density == 0.001:
        mask[3, 5, 7] = True
    got = TL._global_median_midpoint(torch.as_tensor(vals), torch.as_tensor(mask))
    if mask.any():
        want = TR.masked_quantile_midpoint(
            torch.as_tensor(vals).reshape(1, -1), torch.as_tensor(mask).reshape(1, -1)
        )[0]
        assert got.dtype == torch.float32 and got.item() == want.item()
    else:
        assert torch.isnan(got)  # as in the JAX package: no peak, tuning 0
    keys = TL._float_key(torch.as_tensor(vals)).numpy()
    jkeys = np.asarray(JL._float_key(jnp.asarray(vals))).astype(np.int64) + (1 << 31)
    np.testing.assert_array_equal(keys, jkeys)


def test_shard_local_strided_frames_are_the_bucketed_frames():
    """The strided frames the analyzer reads from the halo-extended shards
    (a negative frame offset into `[left | shard | right]`) are the frames
    of the whole signal, with zero history before sample 0: the tempo
    magnitudes for hops `[h0 - 7, h0 + hps)` and the timbral rows."""
    from bliss_tpu_torch.ops import dft_kernels as TD

    rng = np.random.default_rng(5)
    d, shard_len = 3, 11264
    sig = torch.as_tensor(rng.normal(size=d * shard_len).astype(np.float32))
    shards = sig.view(d, shard_len)
    left, right = TL.halo_exchange(shards)
    ext = torch.cat([left, shards, right], dim=1)
    hps, fps_t = shard_len // 256, shard_len // 128
    whole = TD.frame_dft_mags(sig[None], 512, 256, 256, d * hps)[0]
    got = TD.frame_dft_mags(ext, 512, 256, 2048 - TL.HALO, hps + 7)
    for i in range(d):
        skip = 7 if i == 0 else 0  # hops before the song: zero history
        assert torch.equal(got[i, skip:], whole[i * hps - 7 + skip : (i + 1) * hps])
    assert not got[0, :6].any()
    rows = TD.timbral_fft(ext, fps_t, offset=384 - TL.HALO)
    assert torch.equal(rows.reshape(-1, 5), TD.timbral_fft(sig[None], d * fps_t)[0])


@pytest.mark.parametrize("entry", ["sharded_analyze_samples", "sharded_chroma_features"])
def test_default_device_raises_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(30000, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(TL, entry)(x, x.shape[0])
    with pytest.raises(ValueError, match="shards"):
        getattr(TL, entry)(x, x.shape[0], shards=0, device="cpu")


@pytest.mark.parametrize("shards,length", [(1, 40000), (3, 61000), (8, 99000)])
def test_shard_local_chroma_frames_are_the_reflect_padded_frames(shards, length):
    """Each shard's gathered chroma frames (one shard at a time, int32
    positions, reflection taken on global positions) are the frames of the
    whole reflect-padded song, for every frame the shard owns."""
    from bliss_tpu_torch.ops.windows import frame_signal_reflect, n_frames_stft

    rng = np.random.default_rng(shards)
    sig = rng.normal(size=length + 500).astype(np.float32)  # 500 samples past the song
    ext, shard_len = TL._extended_shards(sig, length, sig.shape[0], shards, torch.device("cpu"))
    n_frames = int(n_frames_stft(length, TL.HOP))
    whole = frame_signal_reflect(
        torch.as_tensor(sig[:length])[None], [length], TL.WINDOW, TL.HOP, n_frames
    )[0]
    base = TL._shard_base(shards, shard_len, "cpu")
    fps_max = shard_len // TL.HOP + 2
    seen = 0
    for d in range(shards):
        f_lo = (d * shard_len + TL.HOP - 1) // TL.HOP
        f_hi = min(((d + 1) * shard_len + TL.HOP - 1) // TL.HOP, n_frames)
        got = TL._chroma_local_frames(ext[d], base[d], torch.as_tensor(f_lo), fps_max, length)
        assert got.shape == (fps_max, TL.WINDOW) and got.dtype == torch.float32
        assert f_hi - f_lo <= fps_max
        if f_hi > f_lo:
            assert torch.equal(got[: f_hi - f_lo], whole[f_lo:f_hi])
            seen += f_hi - f_lo
    assert seen == n_frames
