"""Playlist queries on a large library: p50 latencies through the SQLite
`Library` and the playlist engine (counterpart of
benches/playlist_bench.py; BASELINE.json's second metric).

    python -m bliss_tpu_torch.benches.playlist_bench [--device cuda]
        [--n 100000] [--queries 9] [--seed 0] [--folder DIR]

Writes an `--n`-song Version2 store through the port's `Library` (the
rows of `build_library`, which chip_smoke.py's library phase uses too),
then measures over `--queries` seeds: `playlist_from` (closest_to_songs
and dedup, the user's call), `closest_to_songs` without dedup, the top-k
(`parallel.mesh.sharded_top_k`, k = 100, the matrix already on the
device), and a 50-step `song_to_song` walk over the whole store (the walk
`song_to_song` runs, cut at 50 picks); once each, the cold first query and,
on a card, the whole `song_to_song` playlist (an `--n`-step walk, minutes
on the CPU). Prints one JSON line with the p50s and
the card's name and power limit. The store goes under tmp/ and is removed.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import statistics
import time

import numpy as np

from . import card, emit

REPO = pathlib.Path(__file__).resolve().parents[2]

#: BASELINE.json's playlist configuration.
LIBRARY_SONGS = 100_000
CHAIN_STEPS = 50
TOP_K = 100


def library_features(seed: int, n: int = LIBRARY_SONGS):
    """The store's `[n, 23]` features (uniform(-1, 1), 1% of the rows an
    exact copy of another's) and the generator, drawn on."""
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-1.0, 1.0, size=(n, 23)).astype(np.float32)
    copies = rng.choice(n, n // 100, replace=False)
    feats[copies] = feats[(copies + rng.integers(1, n, copies.shape[0])) % n]
    return feats, rng


def song_path(i: int) -> str:
    return f"/library/{i // 1000:03d}/song_{i:06d}.flac"


def build_library(folder: pathlib.Path, seed: int, n: int = LIBRARY_SONGS, device="cuda"):
    """An `n`-song Version2 SQLite store written through the port's
    `Library` (benches/playlist_bench.py's rows): features uniform(-1, 1)
    from `seed`, 1% of the rows an exact copy of another row's features,
    0.1% repeating their predecessor's (title, artist). Returns the config
    and each row's feature-vector group (equal vectors, equal group)."""
    from ..library import BaseConfig, Library

    feats, rng = library_features(seed, n)
    titles = [f"title {i}" for i in range(n)]
    artists = [f"artist {i % 997}" for i in range(n)]
    for i in rng.choice(np.arange(1, n), n // 1000, replace=False):
        titles[i], artists[i] = titles[i - 1], artists[i - 1]
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
    _, group = np.unique(feats, axis=0, return_inverse=True)
    return config, group.ravel()


def run(device="cuda", n=LIBRARY_SONGS, queries=9, seed=0, folder=None) -> dict:
    import torch

    from .. import playlist as P
    from ..library import BaseConfig, Library
    from ..models.analyzer import resolve_device
    from ..parallel.mesh import sharded_top_k

    device = resolve_device(device)
    folder = pathlib.Path(folder or REPO / "tmp" / f"playlist_bench_{n}")
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)

    def timed(fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    try:
        (config, _), build_s = timed(lambda: build_library(folder, seed, n, device))
        lib = Library(BaseConfig.from_path(config.config_path), device=device)
        rows = np.random.default_rng(seed + 1).choice(n, queries + 1, replace=False)
        seeds = [song_path(int(i)) for i in rows]
        out, cold_s = timed(lambda: lib.playlist_from([seeds[0]]))
        if len(out) < n // 2:
            raise RuntimeError(f"playlist_from kept {len(out)} of {n} songs")

        def p50(fn) -> float:
            fn(seeds[0])  # warm
            return statistics.median(timed(lambda: fn(s))[1] for s in seeds[1:])

        playlist_from = p50(lambda s: lib.playlist_from([s]))
        closest = p50(lambda s: lib.playlist_from_custom(
            [s], P.euclidean_distance, P.closest_to_songs, False))
        x = lib._device_matrix()
        index = lib._matrix_cache.path_index
        top_k = p50(lambda s: sharded_top_k([device], [x], x[index[s]][None].cpu().numpy(),
                                            TOP_K, n_real=n))
        chain = P._greedy_chain_graph if device.type == "cuda" else P._greedy_chain_plain

        def walk(s):
            alive = torch.ones(n, dtype=torch.bool, device=device)
            alive[index[s]] = False
            return chain(x, index[s], P.euclidean_distance, alive, CHAIN_STEPS).tolist()

        song_to_song_50 = p50(walk)
        full_s = None
        if device.type == "cuda":
            full, full_s = timed(lambda: lib.playlist_from_custom(
                [seeds[1]], P.euclidean_distance, P.song_to_song, False))
            if len(full) != n:
                raise RuntimeError(f"song_to_song returned {len(full)} of {n} songs")
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return {
        "metric": "playlist_from_p50_ms",
        "value": playlist_from * 1e3,
        "unit": f"ms @ {n}-song library (end to end)",
        "n": n,
        "queries": queries,
        "playlist_from_p50_ms": playlist_from * 1e3,
        "closest_to_songs_p50_ms": closest * 1e3,
        "top_k_p50_ms": top_k * 1e3,
        "top_k": TOP_K,
        "song_to_song_50_p50_ms": song_to_song_50 * 1e3,
        "song_to_song_full_s": full_s,
        "cold_ms": cold_s * 1e3,
        "build_s": build_s,
        "device": str(device),
        "card": card(device),
        "torch": torch.__version__,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.benches.playlist_bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=LIBRARY_SONGS)
    ap.add_argument("--queries", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--folder", default=None, help="where the store is written (removed after)")
    args = ap.parse_args(argv)
    emit(run(args.device, args.n, args.queries, args.seed, args.folder))


if __name__ == "__main__":
    main()
