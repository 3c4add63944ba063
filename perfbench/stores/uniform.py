"""The query traffic's store "uniform": a Version2 library of `n` songs,
each of whose 23 features is drawn uniform in [-1, 1); 1% of the rows are
an exact copy of another row's features and 0.1% repeat their
predecessor's (title, artist), so the playlist's dedup has work of both
kinds. A copy of the rows of the port's `benches/playlist_bench.py`
(`library_features`, `build_library`), which is BASELINE.json's 100k-song
library.

`rows(seed, n)` is what both sides are handed: the program gets them
written into its SQLite store (`write`), the reference reads them here.
"""

from __future__ import annotations

import pathlib

import numpy as np


def song_path(i: int) -> str:
    return f"/library/{i // 1000:03d}/song_{i:06d}.flac"


def rows(seed: int, n: int):
    """(`[n, 23]` f32 features, titles, artists) of the store."""
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-1.0, 1.0, size=(n, 23)).astype(np.float32)
    copies = rng.choice(n, n // 100, replace=False)
    feats[copies] = feats[(copies + rng.integers(1, n, copies.shape[0])) % n]
    titles = [f"title {i}" for i in range(n)]
    artists = [f"artist {i % 997}" for i in range(n)]
    for i in rng.choice(np.arange(1, n), n // 1000, replace=False):
        titles[i], artists[i] = titles[i - 1], artists[i - 1]
    return feats, titles, artists


def write(folder: pathlib.Path, feats, titles, artists, device) -> pathlib.Path:
    """Write the store through the port's `Library` under `folder`; returns
    its config's path."""
    from bliss_tpu_torch.library import BaseConfig, Library

    n = len(feats)
    config = BaseConfig(config_path=folder / "config.json", database_path=folder / "songs.db")
    lib = Library(config, device=device)
    conn = lib.sqlite_conn
    conn.execute("begin")
    conn.executemany(
        "insert into song (path, artist, title, album, duration, analyzed, version, extra_info)"
        " values (?,?,?,?,?,?,?,?)",
        ((song_path(i), artists[i], titles[i], f"album {i // 12}", 210.0, True, 2, "null")
         for i in range(n)),
    )
    ids = [r[0] for r in conn.execute("select id from song order by id")]
    conn.executemany(
        "insert into feature (song_id, feature, feature_index) values (?,?,?)",
        ((ids[i], float(feats[i, j]), j) for i in range(n) for j in range(23)),
    )
    conn.commit()
    lib.config.write()
    conn.close()
    return config.config_path
