"""Traffic kind "query": playlists asked of a stored library, one client in
a closed loop, through the port's `Library.playlist_from` (euclidean
distance, `closest_to_songs`, dedup; src/library.rs:762-767), the call
behind every `blissify playlist`.

Parameters (the traffic file): `store`, the store writer's module under
`perfbench/stores/`; `warm_songs`, the size of the store that set-up warms
the device path on; `sample_queries`, the warm queries checked against
the reference besides the cold one; `limits`, the largest
`playlist_errors` and `order_gap` the check allows (`reference.playlist.judge`;
the `order_gap` limit is also the width within which two distances tie).

Set-up writes the configuration's `library_songs`-song store under TMPDIR,
and warms the device path (the card's context, the kernels, cuBLAS) with
one query of a Library over a `warm_songs`-song store of the same rows'
kind, which is then closed and deleted. The window opens the Library on the
stored config and asks its first playlist (`cold_query_s`: the SQLite
load, the songs, the upload and the query), then asks for playlists back to
back until the window closes, each seed drawn uniformly from the store by
`--seed`. The garbage collections that ran in the window are reported on an
earlier line.
"""

from __future__ import annotations

import gc
import importlib
import pathlib
import shutil
import tempfile
import time

import numpy as np
import torch

from ..trace import Spans, View, Window


def run(ctx) -> dict:
    from bliss_tpu_torch.errors import BlissError
    from bliss_tpu_torch.library import BaseConfig, Library

    from ..reference import playlist as reference

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    store = importlib.import_module(f"perfbench.stores.{traffic['store']}")
    spans = Spans(ctx.trace)
    n = int(cfg["library_songs"])

    t = time.perf_counter()
    feats, titles, artists = store.rows(ctx.seed, n)
    t = ctx.part("rows", t)
    folder = pathlib.Path(tempfile.mkdtemp(prefix="perfbench-store-"))
    try:
        config_path = store.write(folder, feats, titles, artists, dev)
        t = ctx.part("store write", t)
        small = folder / "warm"
        small.mkdir()
        lib = Library(BaseConfig.from_path(
            store.write(small, *store.rows(ctx.seed + 1, int(traffic["warm_songs"])), dev)), device=dev)
        lib.playlist_from([store.song_path(0)])
        lib.sqlite_conn.close()
        del lib
        shutil.rmtree(small)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        ctx.part("warm-up", t)

        draws = np.random.default_rng([ctx.seed, 3])
        keep = np.random.default_rng([ctx.seed, 4])
        k = int(traffic["sample_queries"])
        sample: list = []  # (row, playlist) of a reservoir of the warm queries
        latencies, failed = [], 0
        collections = []  # (generation, seconds) of each collection in the window
        gc_start = {}

        def on_gc(phase, info):
            if phase == "start":
                gc_start["t"] = time.perf_counter()
            else:
                collections.append((info["generation"], time.perf_counter() - gc_start["t"]))

        gc.callbacks.append(on_gc)
        window = Window(ctx.trace, dev)
        with window:
            window_start = time.perf_counter()
            cpu_start = time.process_time()
            end = window_start + ctx.seconds
            first = int(draws.integers(n))
            with spans.span("cold_open"):
                lib = Library(BaseConfig.from_path(config_path), device=dev)
                cold = lib.playlist_from([store.song_path(first)])
            cold_s = time.perf_counter() - window_start
            warm_lo = time.time_ns()
            while time.perf_counter() < end:
                row = int(draws.integers(n))
                t0 = time.perf_counter()
                try:
                    with spans.span("playlist_from"):
                        out = lib.playlist_from([store.song_path(row)])
                except BlissError as e:
                    failed += 1
                    ctx.lines.append(f"failed query {row}: {e!r}")
                    continue
                latencies.append(time.perf_counter() - t0)
                if len(sample) < k:
                    sample.append((row, out))
                elif (j := int(keep.integers(len(latencies)))) < k:
                    sample[j] = (row, out)
                del out
            window.close()
            cpu_s = time.process_time() - cpu_start
        gc.callbacks.remove(on_gc)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        lib.sqlite_conn.close()
        del lib
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.lines.append(f"the process's CPU seconds in the window: {cpu_s:.3f} of {window.seconds:.3f}")
    for g in range(3):
        secs = [s for gen, s in collections if gen == g]
        ctx.lines.append(f"garbage collections of generation {g} in the window: {len(secs)}, "
                         f"{sum(secs):.3f} s")
    view = View(window.t0_ns, window.t1_ns, window.device_ops(), spans.items, {
        "warm": (warm_lo, window.t1_ns), "warm_queries": len(latencies),
    })

    t = time.perf_counter()
    limits = traffic["limits"]
    errors, gap = 0, 0.0
    for row, songs in [(first, cold), *sample]:
        got = [int(pathlib.PurePath(s.bliss_song.path).stem.rsplit("_", 1)[1]) for s in songs]
        e, g = reference.judge(feats, titles, artists, row, got, float(limits["order_gap"]))
        errors, gap = errors + e, max(gap, g)
    ctx.lines.append(f"reference: {1 + len(sample)} playlists of {n} songs in "
                     f"{time.perf_counter() - t:.2f} s")
    lat = np.asarray(latencies) * 1e3
    return {
        "window_start": window_start,
        "e2e": {
            "query_p50_ms": float(np.percentile(lat, 50)) if len(lat) else float("nan"),
            "query_p95_ms": float(np.percentile(lat, 95)) if len(lat) else float("nan"),
            "cold_query_s": cold_s,
        },
        "attempted": 1 + len(latencies) + failed,
        "failed": failed,
        "memory_peak_bytes": peak,
        "view": view,
        "checks": {"playlist_errors": (float(errors), float(limits["playlist_errors"])),
                   "order_gap": (gap, float(limits["order_gap"]))},
    }
