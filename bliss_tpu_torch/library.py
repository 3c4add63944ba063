"""SQLite-backed Library: persistence, incremental updates, playlists
(counterpart of bliss_tpu/library.py; bliss-rs src/library.rs).

Same table layout, migrations and config JSON as the reference, so either
package, or a blissify-style client, opens the other's store. Playlist
queries run on one cached `[N, F]` feature matrix, uploaded once to the
library's `device` (the card unless the caller asks for the CPU) and
handed to the playlist engine (`playlist.py`); `feature_matrix` exposes
the matrix without building `LibrarySong`s.

The SQLite database is also the checkpoint/resume story
(src/library.rs:1000-1093): `update_library` only analyzes the
set-difference against already-analyzed paths at the current features
version, and every song commits in its own transaction.

On a list of devices (`devices=`; the default is every visible card) the
matrix is row-sharded as the JAX package shards it (bliss_tpu/library.py:
1385-1395, 1446-1482): `N` padded to a multiple of the device count, one
row block a device. A query computes each block's seed distances on its
own device and gathers the `[N]` distances on the first device, which
holds the whole matrix too and the dedup metadata; there the stable order,
the dedup verdicts and `song_to_song`'s walk run as on one device, so
every order and verdict equals the one-device `Library`'s.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, NamedTuple, Sequence

import numpy as np
import torch

from .errors import BlissError, ProviderError
from .features import NUMBER_FEATURES, FeaturesVersion
from .models.analyzer import resolve_devices
from .parallel.mesh import block_distances, gather, place_rows
from .playlist import (
    DistanceMetricBuilder,
    FunctionDistanceMetric,
    _as_builder,
    _dedup_walk_runs,
    _device_greedy_chain,
    _gemm_form,
    _order_dedup,
    _same_meta,
    closest_album_to_group,
    closest_to_songs,
    dedup_playlist_custom_distance,
    euclidean_distance,
    song_to_song,
)
from .song import Analysis, AnalysisOptions, CueInfo, Song

logger = logging.getLogger("bliss_tpu_torch")

SQLITE_SCHEMA = """
    create table song (
            id integer primary key,
            path text not null unique,
            duration float,
            album_artist text,
            artist text,
            title text,
            album text,
            track_number integer,
            disc_number integer,
            genre text,
            cue_path text,
            audio_file_path text,
            stamp timestamp default current_timestamp,
            version integer not null,
            analyzed boolean default false,
            extra_info json,
            error text
        );
        pragma foreign_keys = on;
        create table feature (
            id integer primary key,
            song_id integer not null,
            feature real not null,
            feature_index integer not null,
            unique(song_id, feature_index),
            foreign key(song_id) references song(id) on delete cascade
        );
        -- Deviation from the reference: training_triplet is part of the
        -- fresh schema too (the reference only creates it via migration 4,
        -- so its *fresh* databases lack it — src/library.rs:500-529 vs
        -- :546-560).
        create table training_triplet (
            id integer primary key,
            song_1_id integer not null,
            song_2_id integer not null,
            odd_one_out_id integer not null,
            stamp timestamp default current_timestamp,
            foreign key(song_1_id) references song(id) on delete cascade,
            foreign key(song_2_id) references song(id) on delete cascade,
            foreign key(odd_one_out_id) references song(id) on delete cascade
        )
    """

#: Same migration list as the reference (src/library.rs:530-591); the
#: database `pragma user_version` is the number of applied migrations.
SQLITE_MIGRATIONS = [
    "",
    """
        alter table song add column track_number_1 integer;
        update song set track_number_1 = s1.cast_track_number from (
            select cast(track_number as int) as cast_track_number, id from song
        ) as s1 where s1.id = song.id and cast(track_number as int) != 0;
        alter table song drop column track_number;
        alter table song rename column track_number_1 to track_number;
    """,
    "alter table song add column disc_number integer;",
    """
        create table training_triplet (
            id integer primary key,
            song_1_id integer not null,
            song_2_id integer not null,
            odd_one_out_id integer not null,
            stamp timestamp default current_timestamp,
            foreign key(song_1_id) references song(id) on delete cascade,
            foreign key(song_2_id) references song(id) on delete cascade,
            foreign key(odd_one_out_id) references song(id) on delete cascade
        )
    """,
    """
        create table song_bak (
            id integer primary key,
            path text not null unique,
            duration float,
            album_artist text,
            artist text,
            title text,
            album text,
            track_number integer,
            disc_number integer,
            genre text,
            cue_path text,
            audio_file_path text,
            stamp timestamp default current_timestamp,
            version integer not null,
            analyzed boolean default false,
            extra_info json,
            error text
        );
        insert into song_bak (
            id, path, duration, album_artist, artist, title, album, track_number,
            disc_number,genre, cue_path, audio_file_path, stamp, version,
            analyzed, extra_info, error
        ) select
            id, path, duration, album_artist, artist, title, album, track_number,
            disc_number,genre, cue_path, audio_file_path, stamp,
            coalesce(version, 1), analyzed, extra_info, error
        from song;
        drop table song;
        alter table song_bak rename to song;
    """,
]


def _default_data_folder() -> pathlib.Path:
    """XDG_CONFIG_HOME with XDG_DATA_HOME legacy fallback
    (src/library.rs:287-326)."""
    xdg_config = os.environ.get("XDG_CONFIG_HOME")
    if xdg_config:
        default = pathlib.Path(xdg_config) / "bliss-rs"
    else:
        default = pathlib.Path.home() / ".config" / "bliss-rs"
    if default.exists():
        return default
    xdg_data = os.environ.get("XDG_DATA_HOME")
    if xdg_data:
        legacy = pathlib.Path(xdg_data) / "bliss-rs"
    else:
        legacy = pathlib.Path.home() / ".local" / "share" / "bliss-rs"
    if legacy.exists():
        return legacy
    return default


@dataclass
class BaseConfig:
    """Minimum configuration for a [Library] (src/library.rs:263-401).

    Serializes to the same flattened JSON as the reference, including the
    ndarray-style `m` matrix encoding
    `{"v": 1, "dim": [F, F], "data": [...]}`.
    """

    config_path: pathlib.Path = None  # type: ignore[assignment]
    database_path: pathlib.Path = None  # type: ignore[assignment]
    analysis_options: AnalysisOptions = field(default_factory=AnalysisOptions)
    m: np.ndarray = None  # type: ignore[assignment]
    extra: dict = field(default_factory=dict)  # app-defined flattened fields

    def __post_init__(self):
        provided_config = self.config_path is not None
        provided_db = self.database_path is not None
        if not provided_config:
            self.config_path = _default_data_folder() / "config.json"
        self.config_path = pathlib.Path(self.config_path)
        if not provided_db:
            self.database_path = _default_data_folder() / "songs.db"
        self.database_path = pathlib.Path(self.database_path)
        if provided_db and not provided_config:
            self.config_path = self.database_path.parent / "config.json"
        elif provided_config and not provided_db:
            self.database_path = self.config_path.parent / "songs.db"
        if self.m is None:
            self.m = np.eye(NUMBER_FEATURES, dtype=np.float32)
        self.m = np.asarray(self.m, dtype=np.float32)

    # --- (de)serialization, flattened like the reference's serde layout
    def to_dict(self) -> dict:
        n = self.m.shape[0]
        out = {
            "config_path": str(self.config_path),
            "database_path": str(self.database_path),
            "features_version": int(self.analysis_options.features_version),
            "number_cores": int(self.analysis_options.number_cores),
            **self.extra,
            "m": {
                "v": 1,
                "dim": [n, n],
                "data": [float(x) for x in self.m.ravel()],
            },
        }
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "BaseConfig":
        data = dict(data)
        config_path = data.pop("config_path")
        database_path = data.pop("database_path")
        version = data.pop("features_version", int(FeaturesVersion.latest()))
        cores = data.pop("number_cores", 0)
        m_raw = data.pop("m", None)
        if m_raw is not None:
            dim = m_raw["dim"]
            m = np.asarray(m_raw["data"], np.float32).reshape(dim)
        else:
            m = np.eye(NUMBER_FEATURES, dtype=np.float32)
        return cls(
            config_path=pathlib.Path(config_path),
            database_path=pathlib.Path(database_path),
            analysis_options=AnalysisOptions(
                features_version=FeaturesVersion.from_int(version),
                number_cores=cores,
            ),
            m=m,
            extra=data,
        )

    def serialize(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def write(self) -> None:
        self.config_path.parent.mkdir(parents=True, exist_ok=True)
        self.config_path.write_text(self.serialize())

    @classmethod
    def from_path(cls, path) -> "BaseConfig":
        return cls.from_dict(json.loads(pathlib.Path(path).read_text()))

    # reference AppConfigTrait setters (src/library.rs:199-224)
    def set_number_cores(self, number_cores: int) -> None:
        self.analysis_options.number_cores = number_cores
        self.write()

    def set_features_version(self, features_version: FeaturesVersion) -> None:
        self.analysis_options.features_version = features_version
        self.write()

    def get_features_version(self) -> FeaturesVersion:
        return self.analysis_options.features_version

    def get_number_cores(self) -> int:
        return self.analysis_options.number_cores


@dataclass
class LibrarySong:
    """A bliss song + user-defined extra info (src/library.rs:463-476)."""

    bliss_song: Song
    extra_info: object = None

    @property
    def analysis(self):
        return self.bliss_song.analysis

    # playlist functions access metadata through the wrapped song
    @property
    def title(self):
        return self.bliss_song.title

    @property
    def artist(self):
        return self.bliss_song.artist

    @property
    def album(self):
        return self.bliss_song.album

    @property
    def track_number(self):
        return self.bliss_song.track_number

    @property
    def disc_number(self):
        return self.bliss_song.disc_number


@dataclass
class ProcessingError:
    """An error stored for a song whose analysis failed
    (src/library.rs:436-444)."""

    song_path: pathlib.Path
    error: str
    features_version: FeaturesVersion


@dataclass
class SanityError:
    """Database/feature-version sanity findings (src/library.rs:479-496)."""

    kind: str  # "multiple_versions" | "old_version"
    versions: list


_SONG_COLUMNS = (
    "path, artist, title, album, album_artist, "
    "track_number, disc_number, genre, duration, version, extra_info, "
    "cue_path, audio_file_path"
)


def _path_str(song_path) -> str:
    """Path -> UTF-8 string for SQLite, rejecting non-UTF-8 paths.

    Mirrors the reference's `path.to_str().ok_or(ProviderError(...))`
    (src/library.rs:1418-1423): a POSIX path with invalid UTF-8 bytes
    (surfacing in Python as surrogate escapes) is a ProviderError, not a
    mangled DB row.
    """
    s = os.fspath(song_path)
    if isinstance(s, bytes):
        try:
            s = s.decode("utf-8")
        except UnicodeDecodeError:
            raise ProviderError(
                f"Could not convert path {song_path!r} to valid unicode"
            ) from None
        return s
    try:
        s.encode("utf-8")
    except UnicodeEncodeError:
        raise ProviderError(
            f"Could not convert path {song_path!r} to valid unicode"
        ) from None
    return s


class _LibCache(NamedTuple):
    """Cached query-side view of the library (see `_cached_library`)."""

    version: int
    songs: list
    mat: np.ndarray  # [N_pad, F], rows >= n are zero padding
    dev: object  # `mat` on the first device, gathered on first query
    n: int
    path_index: dict  # str(path) -> row
    titles: np.ndarray  # [N] object
    artists: np.ndarray  # [N] object
    #: [N_pad] int32 dedup-metadata ids: rows with equal non-null
    #: (title, artist) share an id, any-None rows (and padding) are -1,
    #: so the dedup metadata test is one integer compare per pair
    #: (src/playlist.rs:377-383)
    meta_ids: np.ndarray
    dev_meta: object  # `meta_ids` on the first device, uploaded with `dev`
    blocks: object  # `mat`'s row blocks, one a device, uploaded with `dev`


class Library:
    """A collection of analyzed [Song]s backed by SQLite
    (src/library.rs:426-1750). Analysis and playlist queries run on
    `devices` (default: `[device]`, else every visible card, raising
    without one); `device` is the first of them."""

    def __init__(self, config: BaseConfig, decoder_cls=None, create: bool = True, device=None,
                 devices=None):
        self.devices = resolve_devices(devices, device)
        self.device = self.devices[0]
        if decoder_cls is None:
            from .io.decoder import DefaultDecoder

            decoder_cls = DefaultDecoder
        self.config = config
        self.decoder_cls = decoder_cls
        config.database_path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        #: the cached song list + [N, F] feature matrix behind playlist
        #: queries (`_LibCache`), dropped on every song/feature write (see
        #: `_invalidate_matrix_cache`); its device form is uploaded on the
        #: first query and reused, so a 100k-song library's 9 MB matrix
        #: crosses to the card once, not per playlist.
        self._matrix_cache = None
        # timeout: several writers may interleave per-song transactions on
        # one database file; wait out the file lock instead of surfacing
        # "database is locked"
        self.sqlite_conn = sqlite3.connect(
            str(config.database_path), check_same_thread=False, timeout=30.0
        )
        self._upgrade()
        if create:
            config.write()

    # --- construction -----------------------------------------------------

    @classmethod
    def new(cls, config: BaseConfig, decoder_cls=None, device=None, devices=None) -> "Library":
        return cls(config, decoder_cls, create=True, device=device, devices=devices)

    @classmethod
    def new_from_base(
        cls,
        config_path=None,
        database_path=None,
        analysis_options=None,
        decoder_cls=None,
        device=None,
        devices=None,
    ) -> "Library":
        """Create a Library from a minimal configuration
        (src/library.rs:741-752)."""
        config = BaseConfig(
            config_path=config_path,
            database_path=database_path,
            analysis_options=analysis_options or AnalysisOptions(),
        )
        return cls(config, decoder_cls, create=True, device=device, devices=devices)

    @classmethod
    def from_config_path(cls, config_path=None, decoder_cls=None, device=None,
                         devices=None) -> "Library":
        if config_path is None:
            config_path = BaseConfig().config_path
        config = BaseConfig.from_path(config_path)
        return cls(config, decoder_cls, create=False, device=device, devices=devices)

    def _upgrade(self) -> None:
        """Schema creation / `pragma user_version` migrations
        (src/library.rs:631-681)."""
        conn = self.sqlite_conn
        version = conn.execute("pragma user_version").fetchone()[0]
        n_migrations = len(SQLITE_MIGRATIONS)
        if version == n_migrations:
            return
        if version > n_migrations:
            raise ProviderError(
                f"bliss version {version} is older than the schema version "
                f"{n_migrations}"
            )
        n_tables = conn.execute("select count(*) from pragma_table_list").fetchone()[0]
        is_new = n_tables <= 2  # sqlite_schema + sqlite_temp_schema
        try:
            if version == 0 and is_new:
                conn.executescript(SQLITE_SCHEMA)
            else:
                for migration in SQLITE_MIGRATIONS[version:]:
                    if migration.strip():
                        conn.executescript(migration)
        except sqlite3.Error as e:
            # e.g. opening a non-bliss sqlite file: keep the BlissError
            # surface like the reference (src/library.rs:673-677)
            raise ProviderError(f"could not upgrade database: {e}")
        conn.execute(f"pragma user_version = {n_migrations}")
        conn.commit()

    # --- sanity ------------------------------------------------------------

    def version_sanity_check(self) -> List[SanityError]:
        with self._lock:
            rows = self.sqlite_conn.execute("select distinct version from song").fetchall()
        versions = sorted(FeaturesVersion.from_int(r[0]) for r in rows)
        errors = []
        if len(versions) > 1:
            errors.append(SanityError("multiple_versions", versions))
        if any(v != FeaturesVersion.latest() for v in versions):
            errors.append(SanityError("old_version", [versions[0]]))
        return errors

    # --- playlists ----------------------------------------------------------

    def playlist_from(self, song_paths: Sequence[str]) -> List[LibrarySong]:
        """Playlist by euclidean distance from already-analyzed songs
        (src/library.rs:762-767)."""
        return self.playlist_from_custom(song_paths, euclidean_distance, closest_to_songs, True)

    def playlist_from_custom(
        self,
        initial_song_paths: Sequence[str],
        distance,
        sort_by: Callable,
        deduplicate: bool,
    ) -> List[LibrarySong]:
        """Custom-metric, custom-sort playlist (src/library.rs:805-842).

        The package's own sorters run on the cached feature matrix on the
        library's device; another `sort_by(initial, pool, distance)` gets
        the pool of songs, as in the reference."""
        initial = []
        for p in initial_song_paths:
            try:
                initial.append(self.song_from_path(p))
            except BlissError:
                raise ProviderError(f"song '{p}' has not been analyzed")
        path_set = set(str(p) for p in initial_song_paths)
        songs, mat, n_real = self._cached_library()
        cache = self._matrix_cache
        mask = np.ones(len(songs), bool)
        for p in path_set:
            i = cache.path_index.get(p)
            if i is not None:
                mask[i] = False
        if deduplicate and sort_by is closest_to_songs and initial:
            fused = self._fused_order_dedup(initial, distance, mask)
            if fused is not None:
                return self._materialize_deduped(initial, distance, fused, songs)
        ordered = None
        playlist_matrix = None
        playlist_meta = None
        if sort_by is closest_to_songs or sort_by is song_to_song:
            order = self._device_query_order(sort_by, initial, distance, mask)
            if order is not None:
                order = np.asarray(order, np.int64)
                ordered = [songs[i] for i in order]
                initial_vecs = (
                    np.stack(
                        [np.asarray(s.bliss_song.analysis.as_arr1(), np.float32) for s in initial]
                    )
                    if initial
                    else np.zeros((0, mat.shape[1]), np.float32)
                )
                playlist_matrix = np.concatenate([initial_vecs, mat[order]])
                init_titles = np.array([s.bliss_song.title for s in initial], object)
                init_artists = np.array([s.bliss_song.artist for s in initial], object)
                playlist_meta = (
                    np.concatenate([init_titles, cache.titles[order]]),
                    np.concatenate([init_artists, cache.artists[order]]),
                )
        if ordered is None:
            pool = [s for s, m in zip(songs, mask) if m]
            ordered = list(sort_by(initial, pool, distance))
        playlist = initial + ordered
        if deduplicate:
            playlist = dedup_playlist_custom_distance(
                playlist, None, distance, matrix=playlist_matrix, metadata=playlist_meta,
            )
        return playlist

    def _batched_metric(self, initial, distance):
        """(metric trained on `initial`, its batched form or None)."""
        metric = _as_builder(distance, self.device).build(
            [np.asarray(s.bliss_song.analysis.as_arr1(), np.float32) for s in initial]
        )
        if not isinstance(metric, FunctionDistanceMetric):
            return metric, None
        return metric, _gemm_form(metric.func, self._matrix_cache.mat.shape[1])

    def _device_mask(self, mask: np.ndarray) -> torch.Tensor:
        """`mask` over the real rows as a `[N_pad]` bool tensor on the
        device; padded rows stay excluded."""
        full = np.zeros(self._matrix_cache.mat.shape[0], bool)
        full[: len(mask)] = mask
        return torch.from_numpy(full).to(self.device)

    def _fused_order_dedup(self, initial, distance, mask, threshold=0.05):
        """(order, base_same) for the dedup path of `playlist_from[_custom]`:
        the seed distances of each row block on its device
        (`_seed_distances`), then `playlist._order_dedup` on the first: the
        masked stable sort, the row gather, consecutive-pair distances and
        the dedup verdicts (distance < threshold OR equal non-null metadata
        ids); only the order and the verdicts come back. Returns
        None when the metric has no batched form (the caller then follows
        the generic pool + list-dedup path)."""
        songs, mat, n_real = self._cached_library()
        if not songs:
            return np.arange(0), np.zeros(0, bool)
        metric, form = self._batched_metric(initial, distance)
        if form is None:
            return None
        kind, m = form
        x = self._device_matrix()
        cache = self._matrix_cache
        order, base_same = _order_dedup(
            kind,
            x,
            self._seed_distances(form, metric.vectors),
            None if m is None else torch.as_tensor(m, device=self.device),
            self._device_mask(mask),
            cache.dev_meta,
            threshold,
        )
        n_alive = int(mask.sum())
        order = order[:n_alive].cpu().numpy()
        base_same = base_same[: max(n_alive - 1, 0)].cpu().numpy()
        return order, base_same

    def _materialize_deduped(self, initial, distance, fused, songs, threshold=0.05):
        """Walk the device dedup verdicts over the virtual playlist
        `initial + ordered` (initial's few pairs resolved on the host) and
        materialize the surviving songs once. Scalar rechecks after a drop
        (where `current` stays put and the device pair no longer applies)
        run on the cached host matrix, with the reference's semantics
        (src/playlist.rs:367-402)."""
        order, base_same = fused
        mat = self._matrix_cache.mat
        k = len(initial)
        n_total = k + len(order)
        builder = _as_builder(distance, self.device)

        def vec(i):
            if i < k:
                return np.asarray(initial[i].bliss_song.analysis.as_arr1(), np.float32)
            return mat[order[i - k]]

        def song_at(i):
            return initial[i] if i < k else songs[order[i - k]]

        def scalar_same(i, j):
            if builder.build([vec(i)]).distance(vec(j)) < threshold:
                return True
            return _same_meta(song_at(i), song_at(j))

        base = np.zeros(max(n_total - 1, 0), bool)
        for i in range(k - 1):
            base[i] = scalar_same(i, i + 1)
        if k and len(order):
            base[k - 1] = scalar_same(k - 1, k)
        base[k:] = base_same
        kept = _dedup_walk_runs(n_total, base, scalar_same)
        head = kept[kept < k]
        tail_rows = order[kept[kept >= k] - k]
        out = [initial[int(i)] for i in head]
        out.extend(songs[i] for i in tail_rows.tolist())
        return out

    def _device_query_order(self, sort_by, initial, distance, mask):
        """Row order (into the cached matrix) for the package's sorters:
        the distances and the sort on the device for the metrics with a
        batched form, on the host for the others (e.g. the isolation
        forest). Returns None for a function metric with no batched form
        under `song_to_song` (the caller then follows the generic pool
        path)."""
        songs, mat, n_real = self._cached_library()
        if not songs:
            return []
        metric, form = self._batched_metric(initial, distance)
        if form is not None:
            x = self._device_matrix()
            alive = self._device_mask(mask)
            dists = self._seed_distances(form, metric.vectors)
        else:
            x = mat
            alive = self._device_mask(mask).cpu()
            dists = torch.from_numpy(np.asarray(metric.distances(mat), np.float32))
        masked = torch.where(alive, dists, torch.inf)
        n_alive = int(mask.sum())
        if sort_by is not song_to_song:
            return torch.argsort(masked, stable=True)[:n_alive].cpu().numpy()
        # song_to_song: greedy chain seeded by the closest-to-seeds row
        if n_alive == 0:
            return []
        first = int(torch.argmin(masked))
        order = [first]
        if not isinstance(distance, DistanceMetricBuilder):
            if n_alive > 1:
                alive[first] = False
                # the walk runs over the matrix gathered on the first
                # device; a per-step argmin across the row blocks' devices
                # is later work
                chain = _device_greedy_chain(x, first, distance, alive, self.device)
                if chain is None:
                    return None  # a function metric with no batched form
                order.extend(chain)
            return order
        # builder metrics re-train on each step (src/playlist.rs:278-298)
        builder = _as_builder(distance, self.device)
        alive = alive.cpu().numpy()
        alive[first] = False
        while alive.any():
            step_metric = builder.build([mat[order[-1]]])
            d = np.where(alive, step_metric.distances(mat), np.inf)
            nxt = int(np.argmin(d))
            alive[nxt] = False
            order.append(nxt)
        return order

    def album_playlist_from(self, album_title: str, number_albums: int) -> List[LibrarySong]:
        """Album-level playlist (src/library.rs:850-875)."""
        album = self.songs_from_album(album_title)
        songs, _, _ = self._cached_library()
        playlist = closest_album_to_group(album, songs)

        album_count = 0
        index = 0
        current_album = album_title
        for song in playlist:
            if song.bliss_song.album != current_album:
                album_count += 1
                if album_count > number_albums:
                    break
                current_album = song.bliss_song.album
            index += 1
        return playlist[:index]

    # --- analysis drivers ----------------------------------------------------

    def analyze_paths(self, paths, show_progress_bar: bool = False) -> None:
        self.analyze_paths_with_options(
            paths, show_progress_bar, self.config.analysis_options
        )

    def analyze_paths_with_options(
        self, paths, show_progress_bar, analysis_options
    ) -> None:
        self.analyze_paths_convert_extra_info(
            [(p, None) for p in paths],
            show_progress_bar,
            lambda extra, song, lib: extra,
            analysis_options,
        )

    def analyze_paths_extra_info(
        self, paths_extra_info, show_progress_bar, analysis_options=None
    ) -> None:
        self.analyze_paths_convert_extra_info(
            paths_extra_info,
            show_progress_bar,
            lambda extra, song, lib: extra,
            analysis_options or self.config.analysis_options,
        )

    def _analysis_results(self, paths, analysis_options):
        """The analysis driver behind every `analyze_paths*`/
        `update_library*` call, on the library's device.

        Decoders that only implement the `decode` protocol method get the
        batch driver (`io.batch.analyze_paths_batched`: bucketed `[B, T]`
        batches on the device); a decoder that overrides
        `analyze_paths_with_options` keeps its own driver (the reference's
        trait-default split, src/song/decoder.rs:115-333).
        """
        from .io.batch import analyze_paths_batched
        from .io.decoder import Decoder as _DecoderProtocol

        impl = self.decoder_cls.analyze_paths_with_options
        base = _DecoderProtocol.analyze_paths_with_options
        if getattr(impl, "__func__", impl) is getattr(base, "__func__", base):
            return analyze_paths_batched(
                self.decoder_cls, paths, analysis_options, devices=self.devices
            )
        return impl(paths, analysis_options, device=self.device)

    def analyze_paths_convert_extra_info(
        self,
        paths_extra_info,
        show_progress_bar,
        convert_extra_info,
        analysis_options,
    ) -> None:
        """Analyze + store songs with optional extra info
        (src/library.rs:1187-1293)."""
        paths_extra_info = {
            pathlib.Path(p): extra for p, extra in paths_extra_info
        }
        if not paths_extra_info:
            logger.info("No (new) songs found.")
            return
        logger.info(
            "Analyzing %d song(s), this might take some time…",
            len(paths_extra_info),
        )
        progress = None
        if show_progress_bar:
            try:
                from tqdm import tqdm

                progress = tqdm(total=len(paths_extra_info))
            except ImportError:
                progress = None

        cue_extra_info: dict = {}
        success, failure = 0, 0
        results = self._analysis_results(
            list(paths_extra_info.keys()), analysis_options
        )
        for path, result in results:
            if isinstance(result, Song):
                song = result
                is_cue = song.cue_info is not None
                key = song.cue_info.cue_path if is_cue else path
                if is_cue and key in paths_extra_info:
                    extra = convert_extra_info(
                        paths_extra_info.pop(key), song, self
                    )
                    cue_extra_info[key] = json.dumps(extra)
                elif is_cue:
                    extra = json.loads(cue_extra_info.get(key, "null"))
                else:
                    extra = convert_extra_info(
                        paths_extra_info.pop(key, None), song, self
                    )
                self.store_song(LibrarySong(song, extra))
                success += 1
            else:
                logger.error(
                    "Analysis of song '%s' failed: %s The error has been "
                    "stored.", path, result,
                )
                self.store_failed_song(
                    path, result, analysis_options.features_version
                )
                failure += 1
            if progress is not None:
                progress.update(1)
        if progress is not None:
            progress.close()
        logger.info(
            "Analyzed %d song(s) successfully. %d Failure(s).",
            success, failure,
        )
        self.config.analysis_options = analysis_options
        self.config.write()

    # --- incremental updates ---------------------------------------------------

    def update_library(
        self, paths, delete_everything_else=False, show_progress_bar=False
    ) -> None:
        self.update_library_with_options(
            paths,
            delete_everything_else,
            show_progress_bar,
            self.config.analysis_options,
        )

    def update_library_with_options(
        self, paths, delete_everything_else, show_progress_bar, analysis_options
    ) -> None:
        self.update_library_convert_extra_info(
            [(p, None) for p in paths],
            delete_everything_else,
            show_progress_bar,
            lambda extra, song, lib: extra,
            analysis_options,
        )

    def update_library_extra_info(
        self, paths_extra_info, delete_everything_else, show_progress_bar
    ) -> None:
        self.update_library_convert_extra_info(
            paths_extra_info,
            delete_everything_else,
            show_progress_bar,
            lambda extra, song, lib: extra,
            self.config.analysis_options,
        )

    def update_library_convert_extra_info(
        self,
        paths_extra_info,
        delete_everything_else,
        show_progress_bar,
        convert_extra_info,
        analysis_options,
    ) -> None:
        """Incremental set-difference update (src/library.rs:1000-1093)."""
        paths_extra_info = [
            (pathlib.Path(p), e) for p, e in paths_extra_info
        ]
        to_analyze = self._set_difference(
            paths_extra_info, delete_everything_else, analysis_options
        )
        self.analyze_paths_convert_extra_info(
            to_analyze, show_progress_bar, convert_extra_info, analysis_options
        )

    def _set_difference(self, paths_extra_info, delete_everything_else, analysis_options):
        """The `(path, extra)` pairs whose path is not analyzed at the
        options' features version. First, with `delete_everything_else`,
        every analyzed path not among them is deleted; when some are left
        to analyze, every song of another version is."""
        version = int(analysis_options.features_version)
        with self._lock:
            existing = {
                pathlib.Path(r[0])
                for r in self.sqlite_conn.execute(
                    "select path from song where analyzed = true and "
                    "version = ? order by id",
                    (version,),
                )
            }
        if delete_everything_else:
            with self._lock:
                all_existing = {
                    pathlib.Path(r[0])
                    for r in self.sqlite_conn.execute(
                        "select path from song where analyzed = true "
                        "order by id"
                    )
                }
            self.delete_paths(all_existing - {p for p, _ in paths_extra_info})

        to_analyze = [
            (p, e) for p, e in paths_extra_info if p not in existing
        ]
        if to_analyze:
            with self._lock:
                self.sqlite_conn.execute("delete from song where version != ?", (version,))
                self.sqlite_conn.commit()
            self._invalidate_matrix_cache()
        return to_analyze

    def update_library_recycled(
        self,
        paths,
        delete_everything_else: bool = False,
        show_progress_bar: bool = False,
        segment_songs: int = 256,
        child_timeout_s: float | None = None,
        prespawn: bool = True,
    ) -> None:
        """`update_library` with the analysis in worker processes of
        ``segment_songs`` songs each, a fresh interpreter a segment
        (`python -m bliss_tpu_torch.io.ingest_worker`, started with
        `subprocess.Popen`: a CUDA context cannot live in a forked child),
        so no process holds more than one segment's memory for long
        (counterpart of bliss_tpu/library.py:959-1144).

        The parent does the set difference, the version purge and the
        deletions, holds no write transaction while a worker writes, and
        never touches the devices: each worker analyzes on this library's
        `devices`, passed to it explicitly. A segment whose worker fails or
        runs past ``child_timeout_s`` (default ``max(900, 10 *
        segment_songs)`` s) is retried once on a fresh process, whose own
        set difference analyzes only what the first attempt did not land;
        a second failure raises `ProviderError`. With ``prespawn`` the next
        segment's worker starts while this one runs, does its start-up and
        waits on a gate file until this segment's worker has exited, so one
        worker analyzes at a time.

        Reference analog: the update loop src/library.rs:1000-1093
        (single-process)."""
        import shutil
        import subprocess
        import sys
        import tempfile

        to_analyze = [
            p for p, _ in self._set_difference(
                [(pathlib.Path(p), None) for p in paths],
                delete_everything_else,
                self.config.analysis_options,
            )
        ]
        if not to_analyze:
            return
        if not self.config.config_path.exists():
            self.config.write()

        decoder = f"{self.decoder_cls.__module__}:{self.decoder_cls.__qualname__}"
        if self.decoder_cls.__module__ == "__main__" or "<locals>" in decoder:
            raise ValueError(f"decoder {decoder} cannot be imported by a worker process")
        from .errors import DecodingError
        from .io import _native
        from .io.decoder import FFmpegDecoder

        if isinstance(self.decoder_cls, type) and issubclass(self.decoder_cls, FFmpegDecoder):
            try:  # built here, so that the workers only load it
                _native.decoder_library()
            except DecodingError:
                pass  # each worker's decodes fail with it, song by song
        timeout = child_timeout_s or max(900.0, 10.0 * segment_songs)
        segments = [
            to_analyze[i : i + segment_songs]
            for i in range(0, len(to_analyze), segment_songs)
        ]
        logger.info(
            "Analyzing %d song(s) in %d recycled segment(s) of <=%d",
            len(to_analyze), len(segments), segment_songs,
        )
        staging = tempfile.mkdtemp(prefix="bliss_recycle_")
        list_paths = []
        for idx, seg in enumerate(segments):
            list_path = os.path.join(staging, f"seg_{idx}.paths")
            with open(list_path, "w") as f:
                f.write("\n".join(str(p) for p in seg))
            list_paths.append(list_path)
        # the worker starts from the package's parent folder, so that
        # `-m bliss_tpu_torch...` resolves, and reads song paths from ours
        pkg_parent = str(pathlib.Path(__file__).resolve().parents[1])
        cwd = os.getcwd()

        def spawn(idx: int, gate):
            cmd = [
                sys.executable, "-m", "bliss_tpu_torch.io.ingest_worker",
                str(pathlib.Path(self.config.config_path).resolve()), list_paths[idx],
                "--devices", ",".join(str(d) for d in self.devices),
                "--decoder", decoder,
                "--cwd", cwd,
                "--log-level", logging.getLevelName(logger.getEffectiveLevel()),
            ]
            if show_progress_bar:
                cmd.append("--progress")
            if gate is not None:
                cmd += ["--gate", gate]
            return subprocess.Popen(cmd, cwd=pkg_parent)

        next_proc = next_gate = None
        try:
            for idx in range(len(segments)):
                if next_proc is not None:
                    proc, gate = next_proc, next_gate
                    next_proc = next_gate = None
                    # segment idx - 1's worker has exited: open the gate
                    pathlib.Path(gate).touch()
                else:
                    proc = spawn(idx, None)
                if prespawn and idx + 1 < len(segments):
                    next_gate = os.path.join(staging, f"gate_{idx + 1}")
                    next_proc = spawn(idx + 1, next_gate)
                rc = None
                for attempt in (1, 2):
                    if attempt == 2:
                        # a fresh ungated process; the pre-spawned worker
                        # of the next segment keeps waiting on its gate
                        proc = spawn(idx, None)
                    t0 = time.perf_counter()
                    try:
                        # the clock starts at the gate's opening: a gated
                        # worker's wait is not charged against it
                        rc = proc.wait(timeout=timeout)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
                        rc = "timeout"
                    logger.debug(
                        "recycled segment %d/%d attempt %d: rc %s, %.3f s",
                        idx + 1, len(segments), attempt, rc, time.perf_counter() - t0,
                    )
                    if rc == 0:
                        break
                    logger.warning(
                        "ingest worker segment %d/%d attempt %d failed (rc=%s)%s",
                        idx + 1, len(segments), attempt, rc,
                        "" if attempt == 2 else "; retrying on a fresh process",
                    )
                if rc != 0:
                    raise ProviderError(
                        f"ingest worker for segment {idx + 1}/{len(segments)} "
                        f"failed twice (rc={rc})"
                    )
        finally:
            if next_proc is not None:
                next_proc.kill()
                next_proc.wait()
            shutil.rmtree(staging, ignore_errors=True)
        self._invalidate_matrix_cache()

    # --- queries -------------------------------------------------------------

    def _songs_from_statement(
        self, songs_statement, features_statement, params
    ) -> List[LibrarySong]:
        with self._lock:
            song_rows = self.sqlite_conn.execute(
                songs_statement, params
            ).fetchall()
            feature_rows = self.sqlite_conn.execute(
                features_statement, params
            ).fetchall()
        feats: dict = {}
        for feature, song_id in feature_rows:
            feats.setdefault(song_id, []).append(feature)
        songs = []
        for row in song_rows:
            song_id = row[13]
            song = self._song_from_row(row)
            chunk = feats.get(song_id, [])
            try:
                song.bliss_song.analysis = Analysis(
                    chunk, song.bliss_song.features_version
                )
            except ProviderError:
                raise ProviderError(
                    f"Song with ID {song_id} and path "
                    f"{song.bliss_song.path} has a different feature number "
                    "than expected. Please rescan or update the song library."
                )
            songs.append(song)
        return songs

    def songs_from_library(self) -> List[LibrarySong]:
        """All analyzed songs at the configured features version
        (src/library.rs:1356-1373)."""
        songs_statement = f"""
            select {_SONG_COLUMNS}, id
                from song where analyzed = true and version = ? order by id
            """
        features_statement = """
            select feature, song.id from feature
                join song on song.id = feature.song_id
                where song.analyzed = true and song.version = ?
                order by song_id, feature_index
            """
        version = int(self.config.analysis_options.features_version)
        return self._songs_from_statement(
            songs_statement, features_statement, (version,)
        )

    def songs_from_album(self, album_title: str) -> List[LibrarySong]:
        """All analyzed songs of an album, by (disc, track) order
        (src/library.rs:1379-1411)."""
        songs_statement = f"""
            select {_SONG_COLUMNS}, id
                from song where album = ? and analyzed = true and version = ?
                order by disc_number, track_number
            """
        features_statement = """
            select feature, song.id from feature
                join song on song.id = feature.song_id
                where album = ? and analyzed = true and version = ?
                order by disc_number, track_number, feature_index
            """
        version = int(self.config.analysis_options.features_version)
        songs = self._songs_from_statement(
            songs_statement, features_statement, (album_title, version)
        )
        if not songs:
            raise ProviderError(
                "target album was not found in the database."
            )
        return songs

    def song_from_path(self, song_path) -> LibrarySong:
        """One analyzed song by exact path (src/library.rs:1414-1463)."""
        song_path = _path_str(song_path)
        with self._lock:
            row = self.sqlite_conn.execute(
                f"""
                select {_SONG_COLUMNS}
                    from song where path=? and analyzed = true
                """,
                (str(song_path),),
            ).fetchone()
            if row is None:
                raise ProviderError(
                    f"song '{song_path}' has not been analyzed"
                )
            features = [
                r[0]
                for r in self.sqlite_conn.execute(
                    """
                    select feature from feature
                        join song on song.id = feature.song_id
                        where song.path = ? order by feature_index
                    """,
                    (str(song_path),),
                )
            ]
        song = self._song_from_row(row)
        try:
            song.bliss_song.analysis = Analysis(
                features, song.bliss_song.features_version
            )
        except ProviderError:
            raise ProviderError(
                f"song has more or less than {NUMBER_FEATURES} features"
            )
        return song

    def _song_from_row(
        self, row, features=None, features_version=None
    ) -> LibrarySong:
        (
            path, artist, title, album, album_artist, track_number,
            disc_number, genre, duration, version, extra_info, cue_path,
            audio_file_path,
        ) = row[:13]
        cue_info = None
        if cue_path is not None:
            cue_info = CueInfo(
                cue_path=pathlib.Path(cue_path),
                audio_file_path=pathlib.Path(audio_file_path),
            )
        if features_version is not None:
            fv = features_version
            # bulk loader: `features` is a validated row of the cached
            # matrix — skip the per-song conversion/validation
            analysis = Analysis._unchecked(features, fv)
        else:
            fv = FeaturesVersion.from_int(version)
            if features is None:
                features = np.zeros(fv.feature_count, np.float32)
            analysis = Analysis(features, fv)
        song = Song(
            path=pathlib.Path(path),
            artist=artist,
            title=title,
            album=album,
            album_artist=album_artist,
            track_number=track_number,
            disc_number=disc_number,
            genre=genre,
            analysis=analysis,
            duration=duration or 0.0,
            features_version=fv,
            cue_info=cue_info,
        )
        # sqlite's NUMERIC affinity on the `json` column can hand back
        # ints/floats, and legacy rows may hold non-JSON text — be lenient
        if extra_info is None or extra_info == "null":
            extra = None
        elif isinstance(extra_info, str):
            try:
                extra = json.loads(extra_info)
            except json.JSONDecodeError:
                extra = extra_info
        else:
            extra = extra_info
        return LibrarySong(song, extra)

    # --- the feature matrix -------------------------------------------------

    def feature_matrix(self) -> tuple:
        """(paths, [N, F] matrix) of all analyzed songs at the configured
        version, without building `LibrarySong`s."""
        version = int(self.config.analysis_options.features_version)
        with self._lock:
            rows = self.sqlite_conn.execute(
                """
                select song.path, feature.feature from feature
                    join song on song.id = feature.song_id
                    where song.analyzed = true and song.version = ?
                    order by song.id, feature.feature_index
                """,
                (version,),
            ).fetchall()
        n_features = FeaturesVersion.from_int(version).feature_count
        paths: List[str] = []
        feats: List[float] = []
        count = 0
        prev = None
        for path, feature in rows:
            if path != prev:
                if prev is not None and count != n_features:
                    raise ProviderError(
                        f"Song with path {prev} has a different feature "
                        "number than expected. Please rescan or update "
                        "the song library."
                    )
                paths.append(path)
                prev = path
                count = 0
            count += 1
            feats.append(feature)
        if prev is not None and count != n_features:
            raise ProviderError(
                f"Song with path {prev} has a different feature number "
                "than expected. Please rescan or update the song library."
            )
        mat = np.asarray(feats, np.float32).reshape(-1, n_features)
        return paths, mat

    def _invalidate_matrix_cache(self) -> None:
        """Drop the cached song list / feature matrix. Called by every
        writer of the song/feature tables (store_song, store_failed_song,
        delete_path(s), the update_library version prune). External
        writers of the same SQLite file are not detected — same contract
        as the reference's in-process Library."""
        self._matrix_cache = None

    def _cached_library(self):
        """(songs, [N_pad, F] matrix, n_real) of all analyzed songs at the
        configured version, cached. N_pad = max(N, 1): an empty library
        keeps one padded row, and padded rows are masked out of every
        query.

        Bulk-loads the feature column straight into the `[N, F]` matrix
        (one reshape, no per-song Python lists): at a 100k-song library
        the per-row zipper the generic `songs_from_library` uses costs
        more than the whole device query."""
        version = int(self.config.analysis_options.features_version)
        cache = self._matrix_cache
        if cache is not None and cache.version == version:
            return cache.songs, cache.mat, cache.n
        n_features = FeaturesVersion.from_int(version).feature_count
        with self._lock:
            song_rows = self.sqlite_conn.execute(
                f"""
                select {_SONG_COLUMNS}, id
                    from song where analyzed = true and version = ?
                    order by id
                """,
                (version,),
            ).fetchall()
            feat_rows = self.sqlite_conn.execute(
                """
                select song_id, feature from feature
                    join song on song.id = feature.song_id
                    where song.analyzed = true and song.version = ?
                    order by song_id, feature_index
                """,
                (version,),
            ).fetchall()
        n = len(song_rows)
        n_dev = len(self.devices)
        n_pad = -(-max(n, 1) // n_dev) * n_dev
        mat = np.zeros((n_pad, n_features), np.float32)
        if feat_rows or song_rows:
            pairs = np.asarray(feat_rows, np.float64)
            song_ids = np.asarray([r[13] for r in song_rows], np.int64)
            # count + block-start alignment: any per-song feature-count
            # drift shifts some block start, so checking every
            # n_features-th id is equivalent to the full per-row check
            ok = pairs.shape[0] == n * n_features and (
                n == 0
                or bool(
                    np.all(
                        pairs[::n_features, 0].astype(np.int64) == song_ids
                    )
                )
            )
            if not ok:
                # fall back to the per-song zipper purely to produce the
                # reference's precise per-song error
                self.songs_from_library()
                raise ProviderError(
                    "Library features are inconsistent. Please rescan or "
                    "update the song library."
                )
            if n:
                mat[:n] = pairs[:, 1].reshape(n, n_features)
        fv = FeaturesVersion.from_int(version)
        songs = [
            self._song_from_row(row, features=mat[i], features_version=fv)
            for i, row in enumerate(song_rows)
        ]
        path_index = {
            str(s.bliss_song.path): i for i, s in enumerate(songs)
        }
        titles = np.empty(n, object)
        artists = np.empty(n, object)
        meta_ids = np.full(n_pad, -1, np.int32)
        pair_ids: dict = {}
        for i, s in enumerate(songs):
            t = s.bliss_song.title
            a = s.bliss_song.artist
            titles[i] = t
            artists[i] = a
            if t is not None and a is not None:
                meta_ids[i] = pair_ids.setdefault((t, a), len(pair_ids))
        self._matrix_cache = _LibCache(
            version, songs, mat, None, n, path_index, titles, artists,
            meta_ids, None, None,
        )
        return songs, mat, n

    def _device_matrix(self) -> torch.Tensor:
        """The cached feature matrix on the first device, uploaded once per
        cache as one row block a device and gathered there (with the dedup
        metadata ids)."""
        self._cached_library()
        cache = self._matrix_cache
        if cache.dev is None:
            blocks = place_rows(self.devices, cache.mat)
            cache = cache._replace(
                dev=blocks[0] if len(blocks) == 1 else gather(blocks, self.device),
                dev_meta=torch.from_numpy(cache.meta_ids).to(self.device),
                blocks=blocks,
            )
            self._matrix_cache = cache
        return cache.dev

    def _seed_distances(self, form, vectors) -> torch.Tensor:
        """`[N_pad]` distances of every row to the seed `vectors` by the
        batched metric `form` (`_gemm_form`'s pair): each row block's on its
        own device, gathered in row order on the first device."""
        self._device_matrix()
        kind, m = form
        blocks = self._matrix_cache.blocks
        return gather(block_distances(kind, blocks, np.stack(vectors), m), self.device)

    # --- storage ----------------------------------------------------------------

    def store_song(self, library_song: LibrarySong) -> None:
        """Transactional upsert of song + features
        (src/library.rs:1544-1633)."""
        song = library_song.bliss_song
        song_path = _path_str(song.path)
        cue_path = (
            str(song.cue_info.cue_path) if song.cue_info else None
        )
        audio_file_path = (
            str(song.cue_info.audio_file_path) if song.cue_info else None
        )
        with self._lock:
            cur = self.sqlite_conn.cursor()
            try:
                cur.execute("begin")
                cur.execute(
                    """
                    insert into song (
                        path, artist, title, album, album_artist,
                        duration, track_number, disc_number, genre, analyzed,
                        version, extra_info, cue_path, audio_file_path
                    ) values (?,?,?,?,?,?,?,?,?,?,?,?,?,?)
                    on conflict(path) do update set
                        artist=excluded.artist,
                        title=excluded.title,
                        album=excluded.album,
                        track_number=excluded.track_number,
                        disc_number=excluded.disc_number,
                        album_artist=excluded.album_artist,
                        duration=excluded.duration,
                        genre=excluded.genre,
                        analyzed=excluded.analyzed,
                        version=excluded.version,
                        extra_info=excluded.extra_info,
                        cue_path=excluded.cue_path,
                        audio_file_path=excluded.audio_file_path
                    """,
                    (
                        song_path,
                        song.artist,
                        song.title,
                        song.album,
                        song.album_artist,
                        float(song.duration),
                        song.track_number,
                        song.disc_number,
                        song.genre,
                        True,
                        int(song.features_version),
                        json.dumps(library_song.extra_info),
                        cue_path,
                        audio_file_path,
                    ),
                )
                cur.execute(
                    "delete from feature where song_id in "
                    "(select id from song where path = ?)",
                    (song_path,),
                )
                cur.executemany(
                    """
                    insert into feature (song_id, feature, feature_index)
                    values ((select id from song where path = ?), ?, ?)
                    on conflict(song_id, feature_index)
                    do update set feature=excluded.feature
                    """,
                    [
                        (song_path, float(f), i)
                        for i, f in enumerate(song.analysis.as_vec())
                    ],
                )
                self.sqlite_conn.commit()
            except Exception:
                self.sqlite_conn.rollback()
                raise
        self._invalidate_matrix_cache()

    def store_failed_song(
        self, song_path, error: BlissError, features_version=None
    ) -> None:
        """Persist a failed analysis in the error ledger
        (src/library.rs:1639-1668)."""
        if features_version is None:
            features_version = FeaturesVersion.latest()
        with self._lock:
            self.sqlite_conn.execute(
                "insert or replace into song (path, error, version) "
                "values (?, ?, ?)",
                (_path_str(song_path), str(error), int(features_version)),
            )
            self.sqlite_conn.commit()
        self._invalidate_matrix_cache()

    def get_failed_songs(self) -> List[ProcessingError]:
        with self._lock:
            rows = self.sqlite_conn.execute(
                "select path, error, version from song "
                "where error is not null order by id"
            ).fetchall()
        return [
            ProcessingError(
                pathlib.Path(p), e, FeaturesVersion.from_int(v)
            )
            for p, e, v in rows
        ]

    def delete_path(self, song_path) -> None:
        song_path = _path_str(song_path)
        with self._lock:
            cur = self.sqlite_conn.execute(
                "delete from song where path = ?", (song_path,)
            )
            self.sqlite_conn.commit()
        self._invalidate_matrix_cache()
        if cur.rowcount == 0:
            raise ProviderError(
                f"tried to delete song {song_path}, not existing in the "
                "database."
            )

    def delete_paths(self, paths: Iterable) -> int:
        paths = [_path_str(p) for p in paths]
        if not paths:
            return 0
        placeholders = ",".join("?" * len(paths))
        with self._lock:
            cur = self.sqlite_conn.execute(
                f"delete from song where path in ({placeholders})", paths
            )
            self.sqlite_conn.commit()
        self._invalidate_matrix_cache()
        return cur.rowcount
