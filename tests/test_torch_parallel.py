"""The port's work over a list of devices on the CPU (`[cpu] * n`):
`parallel/mesh.py` against the JAX package's `bliss_tpu.parallel` on its
8-device CPU mesh with the same numpy inputs (equal indices, distances at
rtol 1e-5), the long-song route over a device list, the batch driver's
buckets spread over devices (the counterparts of tests/test_batch.py's
multi-device tests, through the port's own decoder), and the row-sharded
`Library` against a one-device `Library` on one store.

JAX is imported only inside the JAX comparisons: the `cuda` cases run on
the card's host, which has no JAX."""

import pathlib
import sqlite3
import wave

import numpy as np
import pytest
import torch

from bliss_tpu_torch import playlist as TP
from bliss_tpu_torch.features import FeaturesVersion
from bliss_tpu_torch.io import batch as TB
from bliss_tpu_torch.io.fallback import FallbackDecoder
from bliss_tpu_torch.library import BaseConfig, Library
from bliss_tpu_torch.models import analyzer as TA
from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.parallel import longsong as TL
from bliss_tpu_torch.parallel.mesh import (
    make_mesh,
    place_rows,
    sharded_analyze_batch,
    sharded_closest_distances,
    sharded_top_k,
)
from bliss_tpu_torch.song import Song

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def J():
    """The JAX package's `parallel` and its 8-device CPU mesh."""
    jax = pytest.importorskip("jax")
    from bliss_tpu import parallel

    assert len(jax.devices()) >= 8
    return parallel, parallel.make_mesh(8)


def test_make_mesh_and_device_lists(monkeypatch):
    assert make_mesh(devices=["cpu"] * 8) == [CPU] * 8
    assert make_mesh(3, devices=["cpu"] * 8) == [CPU] * 3
    assert TA.resolve_devices(device="cpu") == [CPU]
    with pytest.raises(ValueError, match="not both"):
        TA.resolve_devices(["cpu"], "cpu")
    with pytest.raises(ValueError, match="empty"):
        make_mesh(devices=[])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=["cpu", "cuda"])


# ---------------------------------------------------------------------------
# tests/test_parallel.py's cases, against the JAX package
# ---------------------------------------------------------------------------


def test_sharded_analyze_matches_single_device(mesh, J):
    jp, jmesh = J
    rng = np.random.default_rng(0)
    t = 1 << 14
    batch = (rng.normal(size=(8, t)) * 0.1).astype(np.float32)
    lengths = np.array([t, t - 100, t - 2048, t, t, t - 1, t, t - 5000], np.int32)
    sharded = sharded_analyze_batch(mesh, batch, lengths)
    np.testing.assert_array_equal(sharded, TA.analyze_batch(batch, lengths, device="cpu"))
    # contiguous groups of 3, 3 and 2 rows on three entries
    np.testing.assert_array_equal(sharded_analyze_batch(mesh[:3], batch, lengths), sharded)
    np.testing.assert_allclose(sharded, jp.sharded_analyze_batch(jmesh, batch, lengths), atol=1e-5)


def test_sharded_distances(mesh, J):
    jp, jmesh = J
    rng = np.random.default_rng(1)
    library = rng.normal(size=(64, 23)).astype(np.float32)
    seeds = rng.normal(size=(2, 23)).astype(np.float32)
    out = sharded_closest_distances(mesh, library, seeds)
    expected = sum(np.linalg.norm(library - s, axis=1) for s in seeds)
    np.testing.assert_allclose(out, expected, rtol=1e-5)
    np.testing.assert_allclose(out, jp.sharded_closest_distances(jmesh, library, seeds), rtol=1e-5)
    # 61 rows on 8 devices: padded blocks, the real rows' distances only
    w = np.diag(rng.uniform(0.5, 2.0, 23)).astype(np.float32)
    got = sharded_closest_distances(mesh, library[:61], seeds, w)
    assert got.shape == (61,)
    np.testing.assert_array_equal(got, sharded_closest_distances(mesh[:1], library[:61], seeds, w))


def test_sharded_top_k(mesh, J):
    jp, jmesh = J
    rng = np.random.default_rng(2)
    library = rng.normal(size=(128, 23)).astype(np.float32)
    seeds = library[:1] + 0.001
    idx, dist = sharded_top_k(mesh, library, seeds, k=5)
    expected_d = np.linalg.norm(library - seeds[0], axis=1)
    np.testing.assert_array_equal(np.sort(idx), np.sort(np.argsort(expected_d)[:5]))
    assert (dist[:-1] <= dist[1:]).all()
    jidx, _ = jp.sharded_top_k(jmesh, library, seeds, k=5)
    np.testing.assert_array_equal(idx, jidx)


def _host_top_k(library, seeds, k):
    """Single-device ground truth: summed euclidean + stable argsort."""
    d = np.zeros(library.shape[0], np.float64)
    for s in seeds:
        d += np.linalg.norm(library.astype(np.float64) - s.astype(np.float64), axis=1)
    order = np.argsort(d, kind="stable")[: min(k, library.shape[0])]
    return order, d[order]


def _hold_against_jax(J, mesh, library, seeds, k, **kw):
    jp, jmesh = J
    idx, dist = sharded_top_k(mesh, library, seeds, k=k, **kw)
    jidx, jdist = jp.sharded_top_k(jmesh, library, seeds, k=k, **kw)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(dist, jdist, rtol=1e-5, atol=1e-6)
    return idx, dist


@pytest.mark.parametrize(
    "n,k",
    [
        (128, 20),  # k > n // n_dev (16): spans shard boundaries
        (100, 7),  # n not divisible by the mesh (padding path)
        (61, 61),  # k == n, non-divisible
        (40, 64),  # k > n: clamped
        (8, 3),  # one row per shard
        (5, 5),  # fewer rows than devices
    ],
)
def test_sharded_top_k_matches_host(mesh, J, n, k):
    rng = np.random.default_rng(n * 1000 + k)
    library = rng.normal(size=(n, 23)).astype(np.float32)
    seeds = rng.normal(size=(2, 23)).astype(np.float32)
    idx, dist = _hold_against_jax(J, mesh, library, seeds, k)
    exp_idx, exp_d = _host_top_k(library, seeds, k)
    assert idx.shape[0] == min(k, n)
    np.testing.assert_array_equal(np.sort(idx), np.sort(exp_idx))
    np.testing.assert_allclose(dist, exp_d, rtol=2e-5)


def test_sharded_top_k_clustered_on_one_shard(mesh, J):
    """A nearest cluster larger than n // n_dev on one shard comes back
    whole."""
    rng = np.random.default_rng(7)
    n, n_dev = 128, 8
    shard_n = n // n_dev
    library = rng.normal(size=(n, 23)).astype(np.float32) + 50.0
    seed = rng.normal(size=(1, 23)).astype(np.float32)
    near = 0.01 * rng.normal(size=(shard_n, 23)).astype(np.float32)
    library[shard_n : 2 * shard_n] = seed[0] + near
    idx, _ = _hold_against_jax(J, mesh, library, seed, 24)
    exp_idx, _ = _host_top_k(library, [seed[0]], 24)
    np.testing.assert_array_equal(np.sort(idx), np.sort(exp_idx))
    assert set(range(shard_n, 2 * shard_n)) <= set(idx.tolist())


def test_sharded_top_k_randomized_parity(mesh, J):
    rng = np.random.default_rng(123)
    for _ in range(10):
        n = int(rng.integers(3, 200))
        k = int(rng.integers(1, n + 4))
        library = rng.normal(size=(n, 23)).astype(np.float32)
        seeds = rng.normal(size=(int(rng.integers(1, 4)), 23)).astype(np.float32)
        idx, dist = _hold_against_jax(J, mesh, library, seeds, k)
        exp_idx, exp_d = _host_top_k(library, seeds, k)
        np.testing.assert_array_equal(np.sort(idx), np.sort(exp_idx))
        np.testing.assert_allclose(dist, exp_d, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("n,k", [(64, 20), (100, 37), (30, 30)])
def test_sharded_top_k_exact_ties_across_shards(mesh, J, n, k):
    """Exact duplicate rows in every shard: equal distances, which the
    stable per-shard order and the merge give lowest row first, as
    `lax.top_k` and the JAX merge do (a plain `torch.topk` need not)."""
    rng = np.random.default_rng(n + k)
    base = rng.normal(size=(5, 23)).astype(np.float32)
    library = base[rng.integers(0, 5, n)]
    seeds = base[:2] + 0.25
    idx, dist = _hold_against_jax(J, mesh, library, seeds, k)
    order = np.lexsort((np.arange(n), sharded_closest_distances(mesh[:1], library, seeds)))[:k]
    np.testing.assert_array_equal(idx, order)
    assert len(set(dist.tolist())) < k  # the ties are real


def test_sharded_top_k_pre_padded_and_placed(mesh, J):
    """`n_real` on a pre-padded matrix and a placed one (`place_rows`, used
    as it is) give the unpadded matrix's answer; the JAX contract's
    errors hold."""
    rng = np.random.default_rng(9)
    library = rng.normal(size=(61, 23)).astype(np.float32)
    seeds = rng.normal(size=(2, 23)).astype(np.float32)
    want = _hold_against_jax(J, mesh, library, seeds, 9)
    padded = np.concatenate([library, np.zeros((3, 23), np.float32)])
    for lib in (padded, place_rows(mesh, padded)):
        got = sharded_top_k(mesh, lib, seeds, 9, n_real=61)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    placed = place_rows(mesh, library)  # 61 rows padded to 64
    assert [b.shape[0] for b in placed] == [8] * 8
    np.testing.assert_array_equal(sharded_top_k(mesh, placed, seeds, 9, n_real=61)[0], want[0])
    with pytest.raises(ValueError, match="multiple"):
        sharded_top_k(mesh, library, seeds, 9, n_real=60)
    with pytest.raises(ValueError, match="one block a device"):
        sharded_top_k(mesh[:4], placed, seeds, 9)
    assert sharded_top_k(mesh, library, seeds, 0)[0].shape == (0,)


# ---------------------------------------------------------------------------
# the long-song route over a device list
# ---------------------------------------------------------------------------


def _musical(t, seed):
    rng = np.random.default_rng(seed)
    sig = (rng.normal(size=t) * 0.08).astype(np.float32)
    n = np.arange(t, dtype=np.float32)
    sig += 0.3 * np.sin(2 * np.pi * 220.0 * n / 22050.0).astype(np.float32)
    env = (0.4 + 0.6 * (np.sin(2 * np.pi * 2.0 * n / 22050.0) > 0)).astype(np.float32)
    return sig * env


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_longsong_on_a_device_list_is_the_one_device_route(dtype):
    """8 shards over 4 list entries (two shards a piece, halos across the
    pieces, sums and gathers on the first) == 8 shards on one device, bit
    for bit; a shard count that the list does not divide is refused."""
    t = 25 * 22050 + 999
    sig = _musical(t, 3)
    one = TL.sharded_analyze_samples(sig, t - 777, shards=8, device="cpu", dtype=dtype)
    four = TL.sharded_analyze_samples(sig, t - 777, shards=8, devices=[CPU] * 4, dtype=dtype)
    np.testing.assert_array_equal(four, one)
    with pytest.raises(ValueError, match="multiple"):
        TL.sharded_analyze_samples(sig, t, shards=8, devices=[CPU] * 3)


def test_longsong_on_a_device_list_matches_jax():
    jax = pytest.importorskip("jax")
    from bliss_tpu.parallel import longsong as JL
    from bliss_tpu.parallel import make_mesh as jax_mesh

    assert len(jax.devices()) >= 8
    t = 45 * 22050
    sig = _musical(t, 10)
    got = TL.sharded_analyze_samples(sig, t, shards=8, devices=[CPU] * 4, dtype=torch.float32)
    want = JL.sharded_analyze_samples(jax_mesh(8, axis="time"), sig, t)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert abs(got[0] - want[0]) < 1e-6


# ---------------------------------------------------------------------------
# the batch driver over a device list (tests/test_batch.py:196-300)
# ---------------------------------------------------------------------------


def _long_wav(folder: pathlib.Path) -> pathlib.Path:
    """A ~40 s synthesized s16 WAV: with a lowered LONG_SONG it joins the
    B = batch // 4 = 2 bucket."""
    path = folder / "long_mix.wav"
    rng = np.random.default_rng(11)
    t = np.arange(40 * 22050) / 22050.0
    sig = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.normal(size=t.size)
    pcm = np.clip(np.round(sig * 32767), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(pcm.tobytes())
    return path


def _run(paths, devices):
    out = []
    for p, r in TB.analyze_paths_batched(FallbackDecoder, paths, batch_size=8, devices=devices):
        if isinstance(r, Song):
            out.append((str(p), str(r.path), r.analysis.as_arr1()))
        else:
            out.append((str(p), None, None))
    return sorted(out, key=lambda x: (x[0], x[1] or ""))


@pytest.fixture(scope="module")
def mix(tmp_path_factory):
    """The realistic mix of tests/test_batch.py (several buckets, a CUE
    album, a long song in the small-B bucket, partial final buckets) and
    the one-device driver's results, by song path."""
    long_wav = _long_wav(tmp_path_factory.mktemp("mix"))
    paths = (
        [DATA / "testcue.cue"]  # 3 tracks (one bucket) + 1 error
        + [DATA / "s16_mono_22_5kHz.flac"] * 5  # bucket A, partial
        + [DATA / "piano.flac"] * 3  # bucket B, partial
        + [DATA / "s32_stereo_44_1_kHz.mp3"] * 2
        + [long_wav]  # LONG bucket, B = 2, 1 present (partial)
    )
    mp = pytest.MonkeyPatch()
    mp.setattr(TB, "LONG_SONG", 1 << 19)
    try:
        single = _run(paths, [CPU])
    finally:
        mp.undo()
    return paths, single


def test_batched_multi_device_realistic_mix_bit_identical(mix, monkeypatch):
    """8 entries vs 1 over the realistic mix: the same entries and
    bit-identical features (a row split changes only the batch size)."""
    paths, single = mix
    monkeypatch.setattr(TB, "LONG_SONG", 1 << 19)
    sharded = _run(paths, [CPU] * 8)
    assert len(single) == len(sharded) == len(paths) + 3  # CUE fan-out
    n_songs = 0
    for (p1, sp1, f1), (p8, sp8, f8) in zip(single, sharded):
        assert (p1, sp1) == (p8, sp8)
        if f1 is None:
            assert f8 is None
            continue
        n_songs += 1
        np.testing.assert_array_equal(f8, f1)
    assert n_songs == len(paths) + 2  # all but the CUE error entry


def test_batched_multi_device_matches_single_device(mix):
    """Nine songs (one full 8-row bucket + a partial flush) over 8 entries
    against the one-device driver's vectors of the same files (1e-6)."""
    _, single = mix
    by_path = {sp: f for _, sp, f in single if f is not None}
    paths = [
        DATA / "s16_mono_22_5kHz.flac", DATA / "piano.flac", DATA / "s32_stereo_44_1_kHz.mp3",
        DATA / "s16_mono_22_5kHz.flac", DATA / "piano.flac", DATA / "s32_stereo_44_1_kHz.mp3",
        DATA / "piano.flac", DATA / "s16_mono_22_5kHz.flac", DATA / "piano.flac",
    ]
    sharded = _run(paths, [CPU] * 8)
    assert len(sharded) == len(paths)
    for p, sp, f in sharded:
        assert p == sp
        np.testing.assert_allclose(f, by_path[sp], atol=1e-6)


def test_batched_multi_device_partial_only(mix):
    """A bucket that never fills (3 songs, batch 8) on 8 entries: three
    one-row groups run, five empty ones run nothing."""
    _, single = mix
    by_path = {sp: f for _, sp, f in single if f is not None}
    paths = [DATA / "s16_mono_22_5kHz.flac", DATA / "piano.flac", DATA / "s32_stereo_44_1_kHz.mp3"]
    sharded = _run(paths, [CPU] * 8)
    assert [sp for _, sp, _ in sharded] == sorted(str(p) for p in paths)
    for _, sp, f in sharded:
        np.testing.assert_allclose(f, by_path[sp], atol=1e-6)


def test_usable_device_count():
    assert [TB._usable_ndev(8, n) for n in (1, 2, 3, 5, 8, 16)] == [1, 2, 2, 4, 8, 8]
    assert TB._usable_ndev(2, 8) == 2 and TB._usable_ndev(1, 8) == 1


# ---------------------------------------------------------------------------
# the row-sharded Library
# ---------------------------------------------------------------------------


def _store(folder: pathlib.Path, n: int = 50) -> BaseConfig:
    """A Version2 store of `n` songs written through the port's Library:
    random features, a few exact copies, a few repeated (title, artist)."""
    rng = np.random.default_rng(4)
    feats = rng.uniform(-1.0, 1.0, size=(n, 23)).astype(np.float32)
    feats[[5, 17, 33]] = feats[[40, 2, 34]]
    titles = [f"title {i}" for i in range(n)]
    artists = [f"artist {i % 7}" for i in range(n)]
    for i in (9, 26, 44):
        titles[i], artists[i] = titles[i - 1], artists[i - 1]
    config = BaseConfig(config_path=folder / "config.json", database_path=folder / "songs.db")
    lib = Library(config, device="cpu")
    conn = lib.sqlite_conn
    conn.executemany(
        "insert into song (path, artist, title, album, duration, analyzed, version, extra_info)"
        " values (?,?,?,?,?,?,?,?)",
        ((f"/library/song_{i:03d}.flac", artists[i], titles[i], f"album {i // 6}", 210.0, True, 2,
          "null") for i in range(n)),
    )
    ids = [r[0] for r in conn.execute("select id from song order by id")]
    conn.executemany(
        "insert into feature (song_id, feature, feature_index) values (?,?,?)",
        ((ids[i], float(feats[i, j]), j) for i in range(n) for j in range(23)),
    )
    conn.commit()
    conn.close()
    return config


def test_row_sharded_library_matches_one_device(tmp_path):
    """Over 3 entries (50 rows padded to 51, a block of 17 each) every order
    and dedup verdict of every query equals the one-device Library's."""
    config = _store(tmp_path)
    one = Library(config, create=False, device="cpu")
    three = Library(config, create=False, devices=["cpu"] * 3)
    assert three.device == CPU and three.devices == [CPU] * 3
    three._device_matrix()
    assert [b.shape[0] for b in three._matrix_cache.blocks] == [17] * 3
    assert torch.equal(three._device_matrix()[:50], one._device_matrix())
    paths = [f"/library/song_{i:03d}.flac" for i in (0, 17, 33, 49)]
    metrics = [
        TP.euclidean_distance, TP.cosine_distance, FeaturesVersion.VERSION2.distance_metric(),
    ]
    for path in paths:
        initial = [one.song_from_path(path)]
        mask = np.ones(50, bool)
        mask[one._matrix_cache.path_index[path]] = False
        for metric in metrics:
            a = one._fused_order_dedup(initial, metric, mask)
            b = three._fused_order_dedup(initial, metric, mask)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            for sort_by in (TP.closest_to_songs, TP.song_to_song):
                for dedup in (True, False):
                    want = one.playlist_from_custom([path], metric, sort_by, dedup)
                    got = three.playlist_from_custom([path], metric, sort_by, dedup)
                    assert [str(s.bliss_song.path) for s in got] == [
                        str(s.bliss_song.path) for s in want
                    ]
    with sqlite3.connect(config.database_path) as conn:
        assert conn.execute("select count(*) from song").fetchone()[0] == 50


def test_row_sharded_library_updates_on_its_devices(tmp_path):
    """`update_library` on a device list goes through the batch driver over
    that list; the stored vectors equal the one-device Library's."""
    paths = [DATA / "piano.flac", DATA / "s16_mono_22_5kHz.flac"]
    stored = {}
    for name, kw in (("one", {"device": "cpu"}), ("two", {"devices": ["cpu", "cpu"]})):
        lib = Library(BaseConfig(config_path=tmp_path / name / "config.json",
                                 database_path=tmp_path / name / "songs.db"), **kw)
        lib.update_library(paths)
        stored[name] = {str(s.bliss_song.path): s.bliss_song.analysis.as_arr1()
                        for s in lib.songs_from_library()}
    assert sorted(stored["one"]) == sorted(stored["two"]) == sorted(str(p) for p in paths)
    for key, f in stored["one"].items():
        np.testing.assert_array_equal(stored["two"][key], f)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_launch_on_the_tensors_device():
    """A wrapper's launch runs on its tensors' device, counted there, and
    "cuda" resolves to the indexed device the caches share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bliss_tpu_torch.ops import dft_kernels as DK

    assert TA.resolve_device("cuda") == torch.device("cuda", torch.cuda.current_device())
    x = torch.as_tensor(_musical(1 << 16, 1)[None], device="cuda:0")
    _build.reset_launches()
    got = DK.specflux(x, 250)
    assert _build.LAUNCHES_ON == {("specflux", "cuda:0"): 1}
    want = DK.specflux_plain(x, 250)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


@pytest.mark.cuda
def test_cuda_batch_on_a_second_card():
    """A batch on cuda:1 while cuda:0 is current equals cuda:0's, and its
    kernels launch on cuda:1."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(2, 1 << 16)) * 0.1).astype(np.float32)
    lengths = [1 << 16, 60000]
    want = TA.analyze_batch(batch, lengths, device="cuda:0")
    _build.reset_launches()
    with torch.cuda.device(0):
        got = TA.analyze_batch(batch, lengths, device="cuda:1")
    assert _build.LAUNCHES_ON.get(("ct_stft", "cuda:1")) == 1
    assert not any(dev == "cuda:0" for _, dev in _build.LAUNCHES_ON)
    np.testing.assert_allclose(got, want, atol=1e-6)
    spread = sharded_analyze_batch(make_mesh(), batch, lengths)
    np.testing.assert_allclose(spread, want, atol=1e-6)
