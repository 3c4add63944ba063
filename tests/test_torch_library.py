"""The port's SQLite Library (bliss_tpu_torch/library.py) side by side with
bliss_tpu.library.Library on the CPU: the schema and its migrations, the
stored rows, every query, and the playlists of each sorter and metric
over one store, which either package writes and the other opens. The
port's Library runs with `device="cpu"`; without it, it asks for the card
and raises here."""

import json
import pathlib
import sqlite3
import zlib

import numpy as np
import pytest
import torch

import bliss_tpu_torch.library as TL
import bliss_tpu_torch.playlist as TP
from bliss_tpu_torch import FeaturesVersion as TFV
from bliss_tpu_torch.errors import AnalysisError as TAnalysisError
from bliss_tpu_torch.errors import DecodingError as TDecodingError
from bliss_tpu_torch.errors import ProviderError as TProviderError
from bliss_tpu_torch.io.decoder import Decoder as TDecoder
from bliss_tpu_torch.io.decoder import PreAnalyzedSong as TPre
from test_library_ref import _FEATURES, _SONG_ROWS

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def J():
    """The JAX package's library and playlist modules."""
    import bliss_tpu.library
    import bliss_tpu.playlist

    class NS:
        library = bliss_tpu.library
        playlist = bliss_tpu.playlist

    return NS


def _config(pkg, tmp_path, name="songs.db"):
    return pkg.BaseConfig(config_path=tmp_path / "config.json", database_path=tmp_path / name)


def _pair(J, tmp_path):
    """A JAX Library and a port Library over one store (the JAX one made it)."""
    jlib = J.library.Library(_config(J.library, tmp_path))
    tlib = TL.Library(_config(TL, tmp_path), device="cpu")
    return jlib, tlib


def _jax_song(path, vec, **meta):
    from bliss_tpu import Analysis, Song

    return Song(path=pathlib.Path(path), analysis=Analysis(np.asarray(vec, np.float32)),
                duration=10.0, **meta)


def _torch_song(path, vec, **meta):
    from bliss_tpu_torch import Analysis, Song

    return Song(path=pathlib.Path(path), analysis=Analysis(np.asarray(vec, np.float32)),
                duration=10.0, **meta)


def _paths(songs):
    return [str(s.bliss_song.path) for s in songs]


def _rows(lib):
    """Every song and feature row of a store, ids and stamps left out."""
    conn = lib.sqlite_conn
    songs = conn.execute(
        "select path, duration, album_artist, artist, title, album, track_number,"
        " disc_number, genre, cue_path, audio_file_path, version, analyzed, extra_info,"
        " error from song order by path"
    ).fetchall()
    feats = conn.execute(
        "select song.path, feature_index, feature from feature join song on"
        " song.id = feature.song_id order by song.path, feature_index"
    ).fetchall()
    return songs, feats


def _planted(n, seed):
    """A store's vectors and metadata with dedup work: exact copies, pairs
    0.01 and 0.2 apart, (title, artist) twins far apart, None metadata."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 23)).astype(np.float32)
    for i in range(5, n, 13):
        x[i] = x[i - 1]
    for i in range(9, n, 23):
        x[i] = x[i - 1] + np.float32(0.01 / np.sqrt(23))
    for i in range(7, n, 29):
        x[i] = x[i - 1] + np.float32(0.2 / np.sqrt(23))
    titles = [f"t{i}" for i in range(n)]
    artists = [None if i % 11 == 0 else f"a{i % 37}" for i in range(n)]
    for i in range(3, n, 17):
        titles[i], artists[i] = titles[i - 1], artists[i - 1]
    return x, titles, artists


@pytest.fixture
def filled(J, tmp_path):
    """(JAX Library, port Library) over one 240-song store written by the
    JAX package, albums of 12 with shuffled track numbers."""
    from bliss_tpu.library import LibrarySong

    jlib = J.library.Library(_config(J.library, tmp_path))
    x, titles, artists = _planted(240, 1)
    for i in range(len(x)):
        song = _jax_song(f"/music/{i:03d}.flac", x[i], title=titles[i], artist=artists[i],
                         album=f"album {i // 12}", track_number=(i * 5) % 12 + 1,
                         disc_number=None if i % 7 else 1)
        jlib.store_song(LibrarySong(song, {"n": i}))
    return jlib, TL.Library(_config(TL, tmp_path), device="cpu")


def test_schema_and_migrations_equal_jax(J, tmp_path):
    assert TL.SQLITE_SCHEMA == J.library.SQLITE_SCHEMA
    assert TL.SQLITE_MIGRATIONS == J.library.SQLITE_MIGRATIONS
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jlib = J.library.Library(_config(J.library, tmp_path / "j"))
    tlib = TL.Library(_config(TL, tmp_path / "t"), device="cpu")

    def schema(lib):
        return sorted(lib.sqlite_conn.execute("select type, name, sql from sqlite_master"))

    assert schema(tlib) == schema(jlib)
    version = "pragma user_version"
    assert tlib.sqlite_conn.execute(version).fetchone() == jlib.sqlite_conn.execute(version).fetchone()


def test_old_database_migrations_equal_jax(J, tmp_path):
    """tests/data/old_database.sql and old_config.json, migrated by each
    package from its own copy."""
    for name in ("j", "t"):
        (tmp_path / name).mkdir()
        conn = sqlite3.connect(tmp_path / name / "old.db")
        conn.executescript((DATA / "old_database.sql").read_text())
        conn.commit()
        conn.close()
    old = json.loads((DATA / "old_config.json").read_text())
    configs = {}
    for name, pkg in (("j", J.library), ("t", TL)):
        cfg = dict(old, config_path=str(tmp_path / name / "config.json"),
                   database_path=str(tmp_path / name / "old.db"))
        (tmp_path / name / "config.json").write_text(json.dumps(cfg))
        configs[name] = pkg.BaseConfig.from_path(tmp_path / name / "config.json")
    jlib = J.library.Library(configs["j"])
    tlib = TL.Library(configs["t"], device="cpu")
    assert _rows(tlib) == _rows(jlib)
    assert tlib.sqlite_conn.execute("select track_number from song where id = 1").fetchone() == (1,)
    jd, td = configs["j"].to_dict(), configs["t"].to_dict()
    for d in (jd, td):
        d.pop("config_path"), d.pop("database_path")
    assert td == jd
    assert [s.bliss_song.path for s in tlib.songs_from_library()] == [
        s.bliss_song.path for s in jlib.songs_from_library()
    ]
    # re-opening runs no migration
    again = TL.Library(configs["t"], device="cpu")
    assert again.sqlite_conn.execute("pragma user_version").fetchone()[0] == len(TL.SQLITE_MIGRATIONS)


def test_config_format_and_data_folder_equal_jax(J, tmp_path, monkeypatch):
    jc = J.library.BaseConfig.from_path(DATA / "sample-config.json")
    tc = TL.BaseConfig.from_path(DATA / "sample-config.json")
    assert tc.serialize() == jc.serialize()
    assert tc.analysis_options.features_version == TFV.VERSION1
    for xdg in ("XDG_CONFIG_HOME", "XDG_DATA_HOME"):
        monkeypatch.setenv(xdg, str(tmp_path / xdg))
    assert TL._default_data_folder() == J.library._default_data_folder()
    (tmp_path / "XDG_DATA_HOME" / "bliss-rs").mkdir(parents=True)  # the legacy folder
    assert TL._default_data_folder() == J.library._default_data_folder() == (
        tmp_path / "XDG_DATA_HOME" / "bliss-rs"
    )
    assert TL.BaseConfig().database_path == J.library.BaseConfig().database_path
    config = TL.BaseConfig(config_path=tmp_path / "sub" / "c.json")
    assert config.database_path == tmp_path / "sub" / "songs.db"


@pytest.fixture
def ref_pair(J, tmp_path):
    """The reference's canonical fixture rows (tests/test_library_ref.py),
    written once, opened by both packages."""
    jlib = J.library.Library(_config(J.library, tmp_path, "bliss.db"))
    conn = jlib.sqlite_conn
    conn.executemany(
        "insert into song (id, path, artist, title, album, album_artist,"
        " track_number, disc_number, genre, duration, analyzed, version,"
        " extra_info, cue_path, audio_file_path, error)"
        " values (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
        _SONG_ROWS,
    )
    for song_id, f in _FEATURES.items():
        conn.executemany(
            "insert into feature (song_id, feature, feature_index) values (?, ?, ?)",
            [(song_id, np.float32(f(i)).item(), i) for i in range(23)],
        )
    conn.commit()
    return jlib, TL.Library(_config(TL, tmp_path, "bliss.db"), device="cpu")


def _song_view(s):
    b = s.bliss_song
    return (str(b.path), b.artist, b.title, b.album, b.album_artist, b.track_number,
            b.disc_number, b.genre, b.duration, int(b.features_version),
            None if b.cue_info is None else (str(b.cue_info.cue_path), str(b.cue_info.audio_file_path)),
            b.analysis.as_vec(), s.extra_info)


def test_queries_equal_jax(ref_pair):
    jlib, tlib = ref_pair
    assert [_song_view(s) for s in tlib.songs_from_library()] == [
        _song_view(s) for s in jlib.songs_from_library()
    ]
    for path in ("/path/to/song1001", "/path/to/cuetrack.cue/CUE_TRACK002"):
        assert _song_view(tlib.song_from_path(path)) == _song_view(jlib.song_from_path(path))
    for path in ("/path/to/song3001", "/nope"):
        with pytest.raises(TProviderError, match="has not been analyzed"):
            tlib.song_from_path(path)
    assert [_song_view(s) for s in tlib.songs_from_album("An Album2001")] == [
        _song_view(s) for s in jlib.songs_from_album("An Album2001")
    ]
    with pytest.raises(TProviderError, match="not found"):
        tlib.songs_from_album("no such album")
    tp, tm = tlib.feature_matrix()
    jp, jm = jlib.feature_matrix()
    assert tp == jp
    np.testing.assert_array_equal(tm, jm)
    assert [(f.song_path, f.error, int(f.features_version)) for f in tlib.get_failed_songs()] == [
        (f.song_path, f.error, int(f.features_version)) for f in jlib.get_failed_songs()
    ]
    assert [(e.kind, [int(v) for v in e.versions]) for e in tlib.version_sanity_check()] == [
        (e.kind, [int(v) for v in e.versions]) for e in jlib.version_sanity_check()
    ]
    songs, mat, n = tlib._cached_library()
    assert n == len(jlib.songs_from_library()) and _paths(songs) == _paths(jlib.songs_from_library())


def test_delete_paths_cascade(ref_pair, tmp_path):
    """On a store the port creates, deleting a song deletes its features
    (the schema turns foreign keys on for the creating connection; a
    reopened store keeps them off, as in the JAX package)."""
    (tmp_path / "fresh").mkdir()
    lib = TL.Library(_config(TL, tmp_path / "fresh"), device="cpu")
    for i in range(3):
        lib.store_song(TL.LibrarySong(_torch_song(f"/f/{i}.flac", np.full(23, i)), None))
    lib.delete_path("/f/1.flac")
    assert lib.sqlite_conn.execute("select count(*) from feature").fetchone()[0] == 2 * 23
    assert lib.delete_paths(["/f/0.flac", "/f/2.flac"]) == 2
    assert lib.sqlite_conn.execute("select count(*) from feature").fetchone()[0] == 0

    jlib, tlib = ref_pair
    tlib.delete_path("/path/to/song1001")
    assert "/path/to/song1001" not in _paths(tlib.songs_from_library())
    with pytest.raises(TProviderError, match="not existing in the database"):
        tlib.delete_path("/path/to/song1001")
    assert tlib.delete_paths([]) == 0
    assert tlib.delete_paths(["/path/to/song2001", "/path/to/song5001", "/nope"]) == 2
    # the JAX package reads what the port deleted
    assert "/path/to/song2001" not in _paths(jlib.songs_from_library())
    assert jlib.delete_paths(["/path/to/song6001"]) == 1
    assert "/path/to/song6001" not in _paths(tlib.songs_from_library())


def _metric_pair(J, name):
    jp = J.playlist
    if name == "euclidean":
        return jp.euclidean_distance, TP.euclidean_distance
    if name == "cosine":
        return jp.cosine_distance, TP.cosine_distance
    if name == "v2":
        from bliss_tpu.features import FeaturesVersion as JFV

        return JFV.VERSION2.distance_metric(), TFV.VERSION2.distance_metric()
    return (jp.ForestOptions(n_trees=20, sample_size=32, seed=3),
            TP.ForestOptions(n_trees=20, sample_size=32, seed=3))


@pytest.mark.parametrize("deduplicate", [True, False])
@pytest.mark.parametrize("sorter", ["closest_to_songs", "song_to_song", "custom"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "v2", "forest"])
def test_playlists_equal_jax(J, filled, metric, sorter, deduplicate):
    jlib, tlib = filled
    jm, tm = _metric_pair(J, metric)
    if sorter == "custom":

        def reverse(initial, pool, distance):  # a sorter the Library knows nothing of
            return list(reversed(pool))

        js = ts = reverse
    else:
        js, ts = getattr(J.playlist, sorter), getattr(TP, sorter)
    for seeds in (["/music/004.flac"], ["/music/010.flac", "/music/100.flac", "/music/233.flac"]):
        want = jlib.playlist_from_custom(seeds, jm, js, deduplicate)
        got = tlib.playlist_from_custom(seeds, tm, ts, deduplicate)
        assert _paths(got) == _paths(want), seeds
        if deduplicate and metric != "forest":
            assert len(got) < 240
    assert [s.extra_info for s in got] == [s.extra_info for s in want]


def test_playlist_from_equal_jax(filled):
    jlib, tlib = filled
    for seed in ("/music/000.flac", "/music/004.flac", "/music/117.flac"):
        want = jlib.playlist_from([seed])
        got = tlib.playlist_from([seed])
        assert _paths(got) == _paths(want)
        assert _paths(got)[0] == seed and len(got) < 240
    with pytest.raises(TProviderError, match="has not been analyzed"):
        tlib.playlist_from(["/music/nope.flac"])


def test_album_playlist_equal_jax(filled):
    jlib, tlib = filled
    for album, n in (("album 3", 2), ("album 0", 5), ("album 19", 30)):
        assert _paths(tlib.album_playlist_from(album, n)) == _paths(jlib.album_playlist_from(album, n))
    with pytest.raises(TProviderError):
        tlib.album_playlist_from("no such album", 1)


def test_stores_cross_open(J, tmp_path):
    """Rows the port writes, the JAX package reads, and the other way."""
    from bliss_tpu.library import LibrarySong as JLibrarySong
    from bliss_tpu_torch.song import CueInfo

    jlib, tlib = _pair(J, tmp_path)
    rng = np.random.default_rng(2)
    for i in range(6):
        song = _torch_song(f"/t/{i}.flac", rng.uniform(-1, 1, 23), title=f"T{i}", artist="A",
                           album="X", track_number=i, genre="g")
        if i == 5:
            song.path = pathlib.Path("/t/a.cue/CUE_TRACK001")
            song.cue_info = CueInfo(pathlib.Path("/t/a.cue"), pathlib.Path("/t/a.flac"))
        tlib.store_song(TL.LibrarySong(song, {"i": i}))
        jlib.store_song(JLibrarySong(_jax_song(f"/j/{i}.flac", rng.uniform(-1, 1, 23)), [i]))
    tlib.store_failed_song("/t/bad.flac", TAnalysisError("boom"), TFV.VERSION2)
    jlib.store_failed_song("/j/bad.flac", TDecodingError("bad"))
    assert [_song_view(s) for s in tlib.songs_from_library()] == [
        _song_view(s) for s in jlib.songs_from_library()
    ]
    assert _song_view(jlib.song_from_path("/t/a.cue/CUE_TRACK001"))[10] == ("/t/a.cue", "/t/a.flac")
    assert [str(f.song_path) for f in jlib.get_failed_songs()] == ["/t/bad.flac", "/j/bad.flac"]
    assert [f.error for f in tlib.get_failed_songs()] == [f.error for f in jlib.get_failed_songs()]
    assert _paths(tlib.playlist_from(["/j/3.flac"])) == _paths(jlib.playlist_from(["/j/3.flac"]))
    # the port's store_song overrides a JAX row in place
    tlib.store_song(TL.LibrarySong(_torch_song("/j/0.flac", np.full(23, 0.5)), None))
    assert jlib.song_from_path("/j/0.flac").bliss_song.analysis.as_vec() == [0.5] * 23
    assert tlib.sqlite_conn.execute("select count(*) from feature").fetchone()[0] == 12 * 23


class _DummyDecoder(TDecoder):
    """Empty samples: analysis fails with 'too short'."""

    @classmethod
    def decode(cls, path):
        return TPre(path=pathlib.Path(path))


def _noise(path):
    s = str(path)
    if s.startswith("/path/to/") or "non-existing" in s:
        return None
    rng = np.random.default_rng(zlib.crc32(s.encode()))
    return (rng.normal(size=22050) * 0.1).astype(np.float32)


class _NoiseDecoder(TDecoder):
    """One second of seeded noise for real-looking paths, a decoding error
    for /path/to/* ghosts and non-existing entries (test_library_ref.py's
    NoiseDecoder, seeded by the path's CRC)."""

    @classmethod
    def decode(cls, path):
        samples = _noise(path)
        if samples is None:
            raise TDecodingError(f"while opening format for file '{path}'")
        return TPre(path=pathlib.Path(path), duration=1.0, sample_array=samples)


def _jax_decoders():
    from bliss_tpu.errors import DecodingError
    from bliss_tpu.io.decoder import Decoder, PreAnalyzedSong

    class Dummy(Decoder):
        @classmethod
        def decode(cls, path):
            return PreAnalyzedSong(path=pathlib.Path(path))

    class Noise(Decoder):
        @classmethod
        def decode(cls, path):
            samples = _noise(path)
            if samples is None:
                raise DecodingError(f"while opening format for file '{path}'")
            return PreAnalyzedSong(path=pathlib.Path(path), duration=1.0, sample_array=samples)

    return Dummy, Noise


def test_update_library_equal_jax(J, ref_pair, tmp_path):
    """`update_library_extra_info` with the noise decoder on the reference
    fixture in both packages (each on its own copy): the same rows (the
    features at the analyzers' CPU tolerance), the same failures, the old
    version pruned."""
    jlib, tlib = ref_pair
    (tmp_path / "copy").mkdir()
    dst = sqlite3.connect(tmp_path / "copy" / "bliss.db")
    tlib.sqlite_conn.backup(dst)
    dst.close()
    tlib = TL.Library(_config(TL, tmp_path / "copy", "bliss.db"), _NoiseDecoder, device="cpu")
    jlib.decoder_cls = _jax_decoders()[1]
    paths = [("/songs/a.flac", True), ("/songs/b.flac", {"x": 1}), ("/path/to/song4001", False),
             ("non-existing", None), ("/path/to/song1001", None)]
    jlib.update_library_extra_info(paths, True, False)
    tlib.update_library_extra_info(paths, True, False)
    (jsongs, jfeats), (tsongs, tfeats) = _rows(jlib), _rows(tlib)
    assert tsongs == jsongs
    assert [r[:2] for r in tfeats] == [r[:2] for r in jfeats]
    np.testing.assert_allclose([r[2] for r in tfeats], [r[2] for r in jfeats], atol=1e-5)
    failed = {str(f.song_path) for f in tlib.get_failed_songs()}
    assert {"/path/to/song4001", "non-existing"} <= failed
    assert not any(v == int(TFV.VERSION1) for (v,) in tlib.sqlite_conn.execute(
        "select version from song where analyzed = true"))
    assert tlib.song_from_path("/songs/b.flac").extra_info == {"x": 1}
    # nothing new: no decode
    tlib.decoder_cls = _DummyDecoder
    tlib.update_library(["/songs/a.flac", "/songs/b.flac"])
    assert tlib.song_from_path("/songs/a.flac").extra_info is True


def test_update_library_dummy_decoder(J, tmp_path):
    """The dummy decoder's songs fail in both packages alike; a song stored
    at the current version is not decoded again, and delete_everything_else
    keeps only the given paths."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jlib = J.library.Library(_config(J.library, tmp_path / "j"), _jax_decoders()[0])
    tlib = TL.Library(_config(TL, tmp_path / "t"), _DummyDecoder, device="cpu")
    from bliss_tpu.library import LibrarySong as JLibrarySong

    jlib.store_song(JLibrarySong(_jax_song("/tmp/old.flac", np.full(23, 0.1)), None))
    jlib.store_song(JLibrarySong(_jax_song("/tmp/gone.flac", np.full(23, 0.2)), None))
    tlib.store_song(TL.LibrarySong(_torch_song("/tmp/old.flac", np.full(23, 0.1)), None))
    tlib.store_song(TL.LibrarySong(_torch_song("/tmp/gone.flac", np.full(23, 0.2)), None))
    attempted = []

    class Tracking(_DummyDecoder):
        @classmethod
        def decode(cls, path):
            attempted.append(str(path))
            return super().decode(path)

    tlib.decoder_cls = Tracking
    for lib in (jlib, tlib):
        lib.update_library(["/tmp/old.flac", "/tmp/new.flac"], delete_everything_else=True)
    assert attempted == ["/tmp/new.flac"]
    assert _rows(tlib) == _rows(jlib)
    assert [(str(f.song_path), f.error) for f in tlib.get_failed_songs()] == [
        (str(f.song_path), f.error) for f in jlib.get_failed_songs()
    ]


def test_custom_analysis_driver_gets_the_device(tmp_path):
    calls = []

    class CustomDriver(TDecoder):
        @classmethod
        def decode(cls, path):
            return TPre(path=pathlib.Path(path))

        @classmethod
        def analyze_paths_with_options(cls, paths, analysis_options, device="cuda"):
            calls.append(([str(p) for p in paths], str(device)))
            return iter(())

    lib = TL.Library(_config(TL, tmp_path), CustomDriver, device="cpu")
    lib.analyze_paths(["/tmp/x.flac"])
    assert calls == [(["/tmp/x.flac"], "cpu")]


def test_analyze_paths_batched_driver(J, tmp_path):
    """`analyze_paths_extra_info` through the batch driver: the stored
    vectors equal the decoder's own per-song analysis on the CPU."""
    lib = TL.Library(_config(TL, tmp_path), _NoiseDecoder, device="cpu")
    lib.analyze_paths_extra_info([("/songs/a.flac", {"mood": "calm"}), ("non-existing", None)], False)
    got = lib.song_from_path("/songs/a.flac")
    assert got.extra_info == {"mood": "calm"}
    want = _NoiseDecoder.song_from_path("/songs/a.flac", device="cpu").analysis.as_arr1()
    np.testing.assert_allclose(got.bliss_song.analysis.as_arr1(), want, atol=1e-6)
    assert [str(f.song_path) for f in lib.get_failed_songs()] == ["non-existing"]
    lib.analyze_paths_convert_extra_info(
        [("/songs/c.flac", "x")], False, lambda extra, song, l: extra * 2,
        lib.config.analysis_options,
    )
    assert lib.song_from_path("/songs/c.flac").extra_info == "xx"


def test_matrix_cache(filled):
    """Padded rows carry meta id -1; the device form is uploaded once per
    cache; every writer drops the cache."""
    _, lib = filled
    songs, mat, n = lib._cached_library()
    assert lib._cached_library()[0] is songs and n == 240
    cache = lib._matrix_cache
    dev = lib._device_matrix()
    assert lib._device_matrix() is dev and lib._matrix_cache.dev_meta is not None
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    assert cache.meta_ids[:n].max() >= 0 and (cache.meta_ids[:n] == -1).sum() > 0
    for write in (
        lambda: lib.store_song(TL.LibrarySong(_torch_song("/music/new.flac", np.zeros(23)), None)),
        lambda: lib.delete_path("/music/new.flac"),
        lambda: lib.store_failed_song("/music/bad.flac", TAnalysisError("x")),
        lambda: lib.delete_paths(["/music/000.flac"]),
    ):
        lib._cached_library()
        write()
        assert lib._matrix_cache is None
    assert lib._cached_library()[2] == 239


def test_empty_library(tmp_path):
    lib = TL.Library(_config(TL, tmp_path), device="cpu")
    songs, mat, n = lib._cached_library()
    assert songs == [] and n == 0 and mat.shape == (1, 23)
    assert lib._matrix_cache.meta_ids.tolist() == [-1]
    assert lib.feature_matrix()[1].shape == (0, 23)
    lib.store_song(TL.LibrarySong(_torch_song("/one.flac", np.ones(23)), None))
    for sorter in (TP.closest_to_songs, TP.song_to_song):
        assert _paths(lib.playlist_from_custom(["/one.flac"], TP.cosine_distance, sorter, True)) == [
            "/one.flac"
        ]


@pytest.mark.parametrize("entry", ["init", "new", "new_from_base", "from_config_path"])
def test_default_device_raises_without_cuda(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _config(TL, tmp_path)
    config.write()
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "init":
            TL.Library(config)
        elif entry == "new":
            TL.Library.new(config)
        elif entry == "new_from_base":
            TL.Library.new_from_base(config.config_path, config.database_path)
        else:
            TL.Library.from_config_path(config.config_path)


def test_tf32_stays_off_after_import():
    import bliss_tpu_torch.library  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
