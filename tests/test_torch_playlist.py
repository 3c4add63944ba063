"""The port's playlist engine (bliss_tpu_torch/playlist.py) held against
bliss_tpu.playlist on the same seeded numpy inputs, on the CPU: distances
at rtol 1e-5 / atol 1e-6, orders, dedup verdicts and kept songs equal.
Duplicate pairs sit far from the 0.05 dedup threshold (exact copies, 0.01
and 0.2 apart), since a verdict is a discrete decision. The `cuda` case
holds the graph-replayed greedy walk against its eager step loop on the
card; run it there with

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_playlist.py

(the JAX comparisons need the JAX package and are not `cuda` cases)."""

import pathlib

import numpy as np
import pytest
import torch

import bliss_tpu_torch.playlist as TP
from bliss_tpu_torch import Analysis as TAnalysis
from bliss_tpu_torch import FeaturesVersion as TFV
from bliss_tpu_torch import Song as TSong
from bliss_tpu_torch.errors import ProviderError as TProviderError

DATA = pathlib.Path(__file__).parent / "data"
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def JP():
    import bliss_tpu.playlist

    return bliss_tpu.playlist


def _jax_song(path, vec, **meta):
    from bliss_tpu import Analysis, FeaturesVersion, Song

    return Song(path=pathlib.Path(path), analysis=Analysis(vec, FeaturesVersion.VERSION2), **meta)


def _torch_song(path, vec, **meta):
    return TSong(path=pathlib.Path(path), analysis=TAnalysis(vec, TFV.VERSION2), **meta)


def _songs(vecs, titles=None, artists=None, albums=None, tracks=None):
    """The same songs in both packages."""
    jax_songs, torch_songs = [], []
    for i, v in enumerate(vecs):
        meta = {
            "title": None if titles is None else titles[i],
            "artist": None if artists is None else artists[i],
            "album": None if albums is None else albums[i],
            "track_number": None if tracks is None else tracks[i],
        }
        jax_songs.append(_jax_song(f"/pl/{i}.flac", v, **meta))
        torch_songs.append(_torch_song(f"/pl/{i}.flac", v, **meta))
    return jax_songs, torch_songs


def _paths(songs):
    return [str(s.path) for s in songs]


def _metrics(JP, name):
    """(JAX metric, port metric) by name."""
    if name == "euclidean":
        return JP.euclidean_distance, TP.euclidean_distance
    if name == "cosine":
        return JP.cosine_distance, TP.cosine_distance
    if name == "mahalanobis":
        w = _weights(name)
        return JP.mahalanobis_distance_builder(w), TP.mahalanobis_distance_builder(w)
    from bliss_tpu.features import FeaturesVersion as JFV

    return JFV.VERSION2.distance_metric(), TFV.VERSION2.distance_metric()


METRICS = ["euclidean", "cosine", "mahalanobis", "v2"]


def _planted(n, seed):
    """`n` uniform(-1, 1) vectors with exact copies, pairs 0.01 apart and
    pairs 0.2 apart planted after their originals."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 23)).astype(np.float32)
    for i in range(5, n, 17):
        x[i] = x[i - 1]
    for i in range(11, n, 29):
        x[i] = x[i - 1] + np.float32(0.01 / np.sqrt(23))
    for i in range(7, n, 31):
        x[i] = x[i - 1] + np.float32(0.2 / np.sqrt(23))
    return x


def _f64_pairs(x, name, rows, cols=None):
    """f64 distances by metric `name` between rows `rows` and `cols` of `x`
    (all rows when `cols` is None): `[len(rows), N]`."""
    x = np.asarray(x, np.float64)
    a = x[rows]
    b = x if cols is None else x[cols]
    if name == "cosine":
        na = np.linalg.norm(a, axis=1)
        nb = np.linalg.norm(b, axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            return 1.0 - (a @ b.T) / (na[:, None] * nb[None, :])
    m = np.eye(23) if name == "euclidean" else np.asarray(_weights(name), np.float64)
    d = a[:, None, :] - b[None, :, :]
    return np.sqrt(np.maximum(np.einsum("ijf,fg,ijg->ij", d, m, d), 0.0))


def _weights(name):
    if name == "mahalanobis":
        return np.diag(np.random.default_rng(3).uniform(0.2, 1.0, 23)).astype(np.float32)
    return TFV.VERSION2.feature_weights()


def _rows(paths):
    return np.array([int(pathlib.Path(p).stem) for p in paths])


def _assert_same_order(got, want, dist):
    """Equal orders of rows, except that rows whose f64 distances agree to
    1e-6 (relative) may trade places: both packages round the same f32
    formula, in another order of operations."""
    got, want = np.asarray(got), np.asarray(want)
    assert sorted(got) == sorted(want)
    swap = got != want
    assert swap.sum() <= max(2, len(got) // 100)
    np.testing.assert_allclose(dist[got[swap]], dist[want[swap]], rtol=1e-6)


def _assert_same_walk(got, want, x, name):
    """Equal greedy walks, or walks equal up to a step whose two picks are a
    near tie (1e-6 relative, f64) from the same song; each pick of `got`
    within 1e-5 (relative) of the f64 minimum over the rows still live."""
    got, want = np.asarray(got), np.asarray(want)
    assert sorted(got) == sorted(want)
    diverge = np.flatnonzero(got != want)
    if not len(diverge):
        return
    k = int(diverge[0])
    assert k > 0
    two = _f64_pairs(x, name, [got[k - 1]], [got[k], want[k]])[0]
    np.testing.assert_allclose(two[0], two[1], rtol=1e-6)
    d = _f64_pairs(x, name, got[:-1], got)
    live = np.ones((len(got) - 1, len(got)), bool)
    for t in range(1, len(got)):
        live[t - 1 :, t - 1] = False
    picked = d[np.arange(len(got) - 1), np.arange(1, len(got))]
    best = np.where(live, d, np.inf).min(1)
    assert np.all(picked <= best + 1e-5 * np.abs(best))


@pytest.mark.parametrize("name", METRICS)
def test_scalar_metrics_equal(JP, name):
    jm, tm = _metrics(JP, name)
    rng = np.random.default_rng(1)
    for _ in range(10):
        a, b = rng.uniform(-1, 1, (2, 23)).astype(np.float32)
        assert tm(a, b) == jm(a, b)
    song_a = _torch_song("a", rng.uniform(-1, 1, 23))
    song_b = _torch_song("b", rng.uniform(-1, 1, 23))
    jax_a, jax_b = (_jax_song(s.path, s.analysis.as_arr1()) for s in (song_a, song_b))
    assert song_a.distance(song_b) == jax_a.distance(jax_b)


@pytest.mark.parametrize("version", [1, 2])
def test_analysis_index_and_repr_equal_jax(version):
    """`Analysis` indexing by the version's own index and the reference's
    Debug format, as the JAX package has them (the library's songs print
    and index the same way)."""
    from bliss_tpu import Analysis as JAnalysis
    from bliss_tpu.features import AnalysisIndex as JIndex
    from bliss_tpu_torch.features import AnalysisIndex, AnalysisIndexV1

    vec = np.random.default_rng(21).normal(size=TFV(version).feature_count).astype(np.float32)
    vec[0] = 1.0
    ported, jax_analysis = TAnalysis(vec, version), JAnalysis(vec, version)
    assert repr(ported) == repr(jax_analysis)
    own, other = (AnalysisIndex, AnalysisIndexV1) if version == 2 else (AnalysisIndexV1, AnalysisIndex)
    assert ported[own.TEMPO] == jax_analysis[JIndex.TEMPO if version == 2 else 0] == 1.0
    assert ported[3] == jax_analysis[3]
    with pytest.raises(IndexError, match="incompatible indexes"):
        ported[other.ZCR]


def test_song_distance_errors():
    a = _torch_song("a", np.zeros(23))
    with pytest.raises(TProviderError):
        a.distance(TSong(path=pathlib.Path("b")))
    v1 = TAnalysis(np.zeros(20), TFV.VERSION1)
    with pytest.raises(TProviderError):
        a.analysis.distance(v1)


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("n_seeds", [1, 3])
def test_batched_distances_match_jax(JP, name, n_seeds):
    jm, tm = _metrics(JP, name)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2000, 23)).astype(np.float32)
    seeds = [x[i] for i in (3, 700, 1500)[:n_seeds]]
    want = JP._as_builder(jm).build(seeds).distances(x)
    metric = TP._as_builder(tm, "cpu").build(seeds)
    got = metric.distances(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    as_tensor = metric.distances(torch.from_numpy(x))
    assert isinstance(as_tensor, torch.Tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), got)


@pytest.mark.parametrize("name", ["euclidean", "v2", "cosine"])
def test_batched_distances_round_in_one_fixed_order(name):
    """The batched distances equal numpy f32 arithmetic doing the same
    operations in the same order, each rounded once: the card's
    elementwise operations and square root round once too, so the card and
    the CPU give the same distances, orders and verdicts bit for bit."""
    rng = np.random.default_rng(22)
    x = rng.uniform(-1, 1, (3000, 23)).astype(np.float32)
    seeds = x[[4, 99, 2000]]

    def ordered(t):
        acc = t[..., 0]
        for f in range(1, t.shape[-1]):
            acc = acc + t[..., f]
        return acc

    t = torch.from_numpy
    if name == "cosine":
        xn, sn = np.sqrt(ordered(x * x)), np.sqrt(ordered(seeds * seeds))
        want = ordered(1.0 - ordered(x[:, None] * seeds[None]) / (xn[:, None] * sn[None]))
        got = TP._batched_cosine(t(x), t(seeds))
    else:
        w = np.diag(_weights(name)) if name == "v2" else np.ones(23, np.float32)
        d = x[:, None] - seeds[None]
        want = ordered(np.sqrt(np.maximum(ordered(d * w * d), 0.0)))
        got = TP._batched_mahalanobis(t(x), t(seeds), t(np.diag(w)))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    values = np.abs(x).ravel()
    np.testing.assert_array_equal(TP._sqrt(t(values)).numpy(), np.sqrt(values))


@pytest.mark.parametrize("name", METRICS)
def test_pairwise_matrix_matches_jax(JP, name):
    """Both packages form the squared distance as `q_i + q_j - 2 x_i M x_j`,
    which cancels near the diagonal: the squares are held at rtol 1e-5 plus
    a few f32 rounding steps of `q_i + q_j`."""
    jm, tm = _metrics(JP, name)
    x = np.random.default_rng(4).uniform(-1, 1, (300, 23)).astype(np.float32)
    got = TP._pairwise_matrix(x, tm, "cpu").astype(np.float64)
    want = JP._pairwise_matrix(x, jm).astype(np.float64)
    if name == "cosine":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return
    m = getattr(tm, "weight_matrix", np.eye(23))
    q = ((x @ m) * x).sum(1).astype(np.float64)
    slack = 4 * np.finfo(np.float32).eps * (q[:, None] + q[None, :])
    assert np.all(np.abs(got**2 - want**2) <= RTOL * want**2 + slack)
    far = want > 0.1
    np.testing.assert_allclose(got[far], want[far], rtol=RTOL)


def test_pairwise_matrix_exotic_metric(JP):
    def manhattan(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).sum())

    x = np.random.default_rng(5).uniform(-1, 1, (20, 23)).astype(np.float32)
    np.testing.assert_array_equal(TP._pairwise_matrix(x, manhattan, "cpu"), JP._pairwise_matrix(x, manhattan))


@pytest.mark.parametrize("name", METRICS)
def test_rowwise_distances_match_jax(JP, name):
    jm, tm = _metrics(JP, name)
    a, b = np.random.default_rng(6).uniform(-1, 1, (2, 500, 23)).astype(np.float32)
    np.testing.assert_array_equal(TP._rowwise_distances(a, b, tm), JP._rowwise_distances(a, b, jm))


@pytest.mark.parametrize(
    "seeds,error",
    [
        ([[0.3, 0.8, 0.5], [0.3, 0.2, 0.5]], None),
        ([[0.3, 0.8, 0.5]] * 4, None),
        ("random", None),
        ([[0.3, 0.8, 0.5]], "more than one element"),
        ([[], []], "must not be empty"),
        ([[0.3, 0.8], [0.3, 0.2, 0.5]], "same length"),
    ],
)
def test_variance_based_weight_matrix(JP, seeds, error):
    if seeds == "random":
        seeds = list(np.random.default_rng(7).normal(size=(9, 23)).astype(np.float32))
    if error is not None:
        with pytest.raises(TProviderError, match=error):
            TP.variance_based_weight_matrix(seeds)
        return
    got = TP.variance_based_weight_matrix(seeds)
    np.testing.assert_array_equal(got, JP.variance_based_weight_matrix(seeds))
    assert abs(np.trace(got) - len(seeds[0])) < 1e-4


@pytest.mark.parametrize("name", METRICS)
def test_closest_to_songs_order_matches_jax(JP, name):
    jm, tm = _metrics(JP, name)
    x = _planted(1500, 8)
    jax_songs, torch_songs = _songs(x)
    got = TP.closest_to_songs(torch_songs[:2], torch_songs[2:], tm, device="cpu")
    want = JP.closest_to_songs(jax_songs[:2], jax_songs[2:], jm)
    dist = _f64_pairs(x, name, [0, 1]).sum(0)
    _assert_same_order(_rows(_paths(got)), _rows(_paths(want)), dist)


@pytest.mark.parametrize("name", METRICS)
def test_song_to_song_order_matches_jax(JP, name):
    jm, tm = _metrics(JP, name)
    x = _planted(1200, 9)
    jax_songs, torch_songs = _songs(x)
    got = TP.song_to_song(torch_songs[:1], torch_songs[1:], tm, device="cpu")
    want = JP.song_to_song(jax_songs[:1], jax_songs[1:], jm)
    _assert_same_walk(_rows(_paths(got)), _rows(_paths(want)), x, name)


def test_builder_metric_orders_match_jax(JP):
    """A set metric (the isolation forest) through both sorters: the
    builder protocol, re-trained on each step of the walk."""
    rng = np.random.default_rng(10)
    x = np.concatenate([rng.normal(0.0, 0.05, (40, 23)), rng.normal(2.0, 0.5, (20, 23))]).astype(
        np.float32
    )
    jax_songs, torch_songs = _songs(x)
    for sorter in ("closest_to_songs", "song_to_song"):
        got = getattr(TP, sorter)(
            torch_songs[:5], torch_songs[5:], TP.ForestOptions(n_trees=20, sample_size=16, seed=1),
            device="cpu",
        )
        want = getattr(JP, sorter)(
            jax_songs[:5], jax_songs[5:], JP.ForestOptions(n_trees=20, sample_size=16, seed=1)
        )
        assert _paths(got) == _paths(want), sorter


def test_isolation_forest_scores_equal(JP):
    """tests/data/forest_options_songs.npz (src/playlist.rs test_forest_options):
    the same trees for the same seed, so the same scores, and the five Kind
    Of Blue tracks last."""
    data = np.load(DATA / "forest_options_songs.npz")
    mozart19 = data["mozart_piano_19"]
    songs = np.concatenate([mozart19, data["kind_of_blue"], data["mozart_piano_23"]])
    songs = np.pad(songs, ((0, 0), (0, 23 - songs.shape[1])))
    seeds = list(np.pad(mozart19, ((0, 0), (0, 23 - mozart19.shape[1]))))
    options = dict(n_trees=300, sample_size=200, max_tree_depth=None, extension_level=10, seed=0)
    got = TP.ForestOptions(**options).build(seeds).distances(songs)
    want = JP.ForestOptions(**options).build(seeds).distances(songs)
    np.testing.assert_array_equal(got, want)
    n19, n_kob = len(mozart19), len(data["kind_of_blue"])
    assert set(np.argsort(got, kind="stable")[-n_kob:]) == set(range(n19, n19 + n_kob))


@pytest.mark.parametrize("kind", ["mahalanobis", "cosine"])
def test_order_dedup_matches_jax(JP, kind):
    """`_order_dedup` (from the batched seed distances) against
    `_order_dedup_jit`: the masked stable order and
    every verdict, with planted copies, near and far pairs, metadata twins
    and masked rows."""
    n = 1500
    x = _planted(n, 11)
    rng = np.random.default_rng(12)
    meta = np.arange(n, dtype=np.int32)
    meta[rng.choice(n, 40, replace=False)] = -1
    for i in range(13, n, 37):
        meta[i] = meta[i - 1]
    mask = np.ones(n, bool)
    mask[rng.choice(n, 30, replace=False)] = False
    mask[[3, 900]] = False  # the seeds, as the Library masks them
    seeds = x[[3, 900]]
    name = "cosine" if kind == "cosine" else "mahalanobis"
    m = np.eye(23, dtype=np.float32) if kind == "cosine" else _weights(name)
    j_order, j_same = JP._order_dedup_jit(kind)(x, seeds, m, mask, meta, np.float32(0.05))
    j_order, j_same = np.asarray(j_order), np.asarray(j_same)
    t = torch.from_numpy
    dists = (TP._batched_cosine(t(x), t(seeds)) if kind == "cosine"
             else TP._batched_mahalanobis(t(x), t(seeds), t(m)))
    order, same = TP._order_dedup(kind, t(x), dists, t(m), t(mask), t(meta), 0.05)
    order, same = order.numpy(), same.numpy()
    live = int(mask.sum())
    dist = _f64_pairs(x, name, [3, 900]).sum(0)
    _assert_same_order(order[:live], j_order[:live], dist)
    np.testing.assert_array_equal(np.sort(order[live:]), np.sort(j_order[live:]))
    both = (order[:-1] == j_order[:-1]) & (order[1:] == j_order[1:])
    assert both[: live - 1].mean() > 0.99
    np.testing.assert_array_equal(same[both], j_same[both])
    assert same.any() and not same.all()


def test_dedup_walk_runs_matches_jax(JP):
    rng = np.random.default_rng(13)
    for n in (0, 1, 2, 5, 64, 300):
        base = rng.random(max(n - 1, 0)) < 0.2
        table = rng.random((max(n, 1), max(n, 1))) < 0.4

        def scalar_same(i, j):
            return bool(table[i, j])

        np.testing.assert_array_equal(
            TP._dedup_walk_runs(n, base, scalar_same), JP._dedup_walk_runs(n, base, scalar_same)
        )


@pytest.mark.parametrize("name", ["euclidean", "cosine", "v2", "builder"])
@pytest.mark.parametrize("n", [40, 400])
def test_dedup_playlist_matches_jax(JP, name, n):
    """`dedup_playlist_custom_distance` on planted duplicates (the scalar
    walk at n <= 64 and for a builder metric, the vectorized one above),
    metadata twins and None metadata; and through the matrix/metadata
    inputs the Library uses."""
    x = _planted(n, 14)
    rng = np.random.default_rng(15)
    titles = [f"t{i}" for i in range(n)]
    artists = [None if rng.random() < 0.1 else f"a{i}" for i in range(n)]
    for i in range(3, n, 19):
        titles[i], artists[i] = titles[i - 1], artists[i - 1]
    jax_songs, torch_songs = _songs(x, titles, artists)
    if name == "builder":

        class JaxScalar(JP.DistanceMetricBuilder):
            def build(self, vectors):
                return JP.FunctionDistanceMetric(JP.euclidean_distance, vectors)

        class PortScalar(TP.DistanceMetricBuilder):
            def build(self, vectors):
                return TP.FunctionDistanceMetric(TP.euclidean_distance, vectors, "cpu")

        jm, tm = JaxScalar(), PortScalar()
    else:
        jm, tm = _metrics(JP, name)
    want = _paths(JP.dedup_playlist_custom_distance(jax_songs, None, jm))
    assert len(want) < n
    assert _paths(TP.dedup_playlist_custom_distance(torch_songs, None, tm)) == want
    seam = TP.dedup_playlist_custom_distance(
        torch_songs, None, tm, matrix=x,
        metadata=(np.array(titles, object), np.array(artists, object)),
    )
    assert _paths(seam) == want
    assert _paths(TP.dedup_playlist(torch_songs, 0.3)) == _paths(JP.dedup_playlist(jax_songs, 0.3))


def test_dedup_inputs_validated():
    songs = [_torch_song(f"/v/{i}", np.full(23, i)) for i in range(3)]
    with pytest.raises(TProviderError):
        TP.dedup_playlist_custom_distance(
            songs, None, TP.euclidean_distance, matrix=np.zeros((2, 23), np.float32)
        )
    with pytest.raises(TProviderError):
        TP.dedup_playlist_custom_distance(
            songs, None, TP.euclidean_distance, metadata=(np.empty(2, object), np.empty(3, object))
        )
    assert TP.dedup_playlist([], None) == []


def test_closest_album_to_group_matches_jax(JP):
    rng = np.random.default_rng(16)
    n = 120
    x = rng.uniform(-1, 1, (n, 23)).astype(np.float32)
    albums = [None if i % 17 == 0 else f"album {i // 9}" for i in range(n)]
    tracks = [None if i % 5 == 0 else (i * 7) % 12 for i in range(n)]
    jax_songs, torch_songs = _songs(x, albums=albums, tracks=tracks)
    got = TP.closest_album_to_group(torch_songs[:9], torch_songs)
    assert _paths(got) == _paths(JP.closest_album_to_group(jax_songs[:9], jax_songs))
    with pytest.raises(TProviderError):
        TP.closest_album_to_group([], torch_songs)


@pytest.mark.parametrize("name", ["euclidean", "cosine", "v2"])
@pytest.mark.parametrize("sorter", ["closest_to_songs", "song_to_song"])
def test_edge_cases_match_jax(JP, name, sorter):
    """Zero vectors (NaN cosine distances), exact ties, a pool of one and
    an empty pool."""
    jm, tm = _metrics(JP, name)
    rng = np.random.default_rng(17)
    x = rng.uniform(-1, 1, (80, 23)).astype(np.float32)
    x[[10, 40, 41]] = 0.0
    x[20:25] = x[19]
    x[60] = -x[59]
    jax_songs, torch_songs = _songs(x)
    for seeds, pool in [(slice(0, 1), slice(1, None)), (slice(10, 11), slice(0, 80)),
                        (slice(19, 20), slice(20, 30)), (slice(0, 2), slice(5, 6)),
                        (slice(0, 1), slice(0, 0))]:
        got = getattr(TP, sorter)(torch_songs[seeds], torch_songs[pool], tm, device="cpu")
        want = getattr(JP, sorter)(jax_songs[seeds], jax_songs[pool], jm)
        assert _paths(got) == _paths(want), (seeds, pool)


@pytest.mark.parametrize("name", ["euclidean", "cosine"])
def test_chain_past_the_last_live_row(name):
    """Steps past the last live row pick row 0 and change nothing; the
    chain keeps `steps` indices, each row once."""
    metric = TP.euclidean_distance if name == "euclidean" else TP.cosine_distance
    x = torch.as_tensor(np.random.default_rng(18).uniform(-1, 1, (50, 23)).astype(np.float32))
    alive = torch.ones(50, dtype=torch.bool)
    alive[[0, 7]] = False
    out = TP._greedy_chain_plain(x, 7, metric, alive.clone(), 52)
    assert sorted(out[:48].tolist()) == sorted(set(range(50)) - {0, 7})
    assert out[48:].tolist() == [0, 0, 0, 0]
    chain = TP._device_greedy_chain(x.numpy(), 7, metric, alive.numpy(), "cpu")
    assert chain == out[:48].tolist()
    assert TP._device_greedy_chain(x.numpy(), 7, metric, np.zeros(50, bool), "cpu") == []


@pytest.mark.parametrize("entry", ["closest_to_songs", "song_to_song", "pairwise", "chain", "metric"])
def test_default_device_raises_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(19).uniform(-1, 1, (5, 23)).astype(np.float32)
    songs = [_torch_song(f"/d/{i}", v) for i, v in enumerate(x)]
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "pairwise":
            TP._pairwise_matrix(x, TP.euclidean_distance)
        elif entry == "chain":
            TP._device_greedy_chain(x, 0, TP.euclidean_distance, np.ones(5, bool))
        elif entry == "metric":
            TP._as_builder(TP.cosine_distance).build([x[0]]).distances(x)
        else:
            getattr(TP, entry)(songs[:1], songs, TP.euclidean_distance)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["euclidean", "cosine", "v2"])
@pytest.mark.parametrize("n,block", [(3000, 256), (1000, 7), (5, 256)])
def test_cuda_graph_chain_equals_eager_loop(cuda, name, n, block):
    metric = {
        "euclidean": TP.euclidean_distance,
        "cosine": TP.cosine_distance,
        "v2": TFV.VERSION2.distance_metric(),
    }[name]
    x = torch.as_tensor(_planted(n, 20), device=cuda)
    alive = torch.ones(n, dtype=torch.bool, device=cuda)
    alive[1] = False
    graph = TP._greedy_chain_graph(x, 1, metric, alive.clone(), n - 1, block)
    eager = TP._greedy_chain_plain(x, 1, metric, alive.clone(), n - 1)
    assert torch.equal(graph, eager)
    assert sorted(graph.tolist()) == [i for i in range(n) if i != 1]
