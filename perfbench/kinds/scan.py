"""Traffic kind "scan": the library scan as a closed loop through the
port's batch driver, `bliss_tpu_torch.io.batch.analyze_paths_batched`
(which every `Library.update_library` call goes through), with its default
batch, in-flight depth and long-song route, on one card.

Parameters (the traffic file): `source`, the PCM source's module under
`perfbench/sources/`; `period`, the songs of one block of the library,
whose lengths are the configuration's length distribution at `period`
evenly spaced quantiles, shuffled by the seed block by block, so every
seed scans the same lengths in another order; `paths_per_second`, the
paths handed to the driver per second of window, more than it can take;
`sample_songs`, the songs of the window checked against the reference;
`limits`, the largest gap each group of features may show (`GROUPS`).

Set-up makes the PCM pool on the card and runs one block of the lengths,
in another seeded order, through the driver, which forms its buckets as in
the window and runs each at its full batch shape (a bucket left part-full
at the end is padded to it): every shape of the window is then built and
loaded. The window is one call of the driver over the paths; what it
yields before the window closes is counted.
"""

from __future__ import annotations

import importlib
import math
import pathlib
import statistics
import time

import numpy as np
import torch

from ..trace import Spans, View, Window

ROOT = pathlib.Path(__file__).resolve().parents[2]

#: The numbers compared, each the widest gap over a group of the Version2
#: vector's columns: the chroma stage, whose product the TF32 control
#: breaks; tempo, zero crossings, timbral and loudness, which only the bfloat16
#: control breaks (a tempo is a median of beat periods that rounding below
#: the beat tracker's resolution does not move, so alone it has no upper
#: reading).
GROUPS = {"chroma_gap": list(range(10, 23)), "tempo_timbral_loudness_gap": list(range(0, 10))}


def quantile_lengths(dist: dict, period: int, rate: int) -> np.ndarray:
    """Samples of `period` songs at the distribution's evenly spaced
    quantiles: "lognormal" (`mean` seconds, log-space `sigma`, clipped to
    `min`..`max`), "fixed" (`seconds`) or "table" (the durations in seconds
    of a library's tracks, one a line, in the file `path` relative to the
    checkout's root)."""
    if dist["dist"] == "fixed":
        seconds = np.full(period, float(dist["seconds"]))
    elif dist["dist"] == "table":
        durations = np.loadtxt(ROOT / dist["path"], dtype=np.float64, ndmin=1)
        seconds = np.quantile(durations, (np.arange(period) + 0.5) / period)
    elif dist["dist"] == "lognormal":
        sigma = float(dist["sigma"])
        mu = math.log(float(dist["mean"])) - sigma * sigma / 2
        normal = statistics.NormalDist()
        seconds = np.array([math.exp(mu + sigma * normal.inv_cdf((q + 0.5) / period))
                            for q in range(period)])
        seconds = np.clip(seconds, float(dist["min"]), float(dist["max"]))
    else:
        raise ValueError(f"length distribution {dist['dist']!r}: lognormal, fixed or table")
    return np.round(seconds * rate).astype(np.int64)


def song_table(lengths: np.ndarray, n_songs: int, pool_shape, seed: int) -> np.ndarray:
    """`[n_songs, 3]` rows `(track, offset, samples)`: block after block of
    `lengths` in a seeded order, each song at a seeded place in the pool."""
    rng = np.random.default_rng([seed, 1])
    tracks, track_len = pool_shape
    blocks = -(-n_songs // len(lengths))
    n = np.concatenate([lengths[rng.permutation(len(lengths))] for _ in range(blocks)])[:n_songs]
    track = rng.integers(tracks, size=n_songs)
    offset = np.floor(rng.random(n_songs) * (track_len - n + 1)).astype(np.int64)
    return np.stack([track, offset, n], axis=1)


def widest(got: np.ndarray, want: np.ndarray) -> float:
    """The widest |got - want| (a NaN on either side: inf)."""
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float(np.where(np.isnan(gap), np.inf, gap).max())


def gaps(got: np.ndarray, want: np.ndarray) -> dict:
    """Each group's widest gap."""
    return {name: widest(got[cols], want[cols]) for name, cols in GROUPS.items()}


def run(ctx) -> dict:
    from bliss_tpu_torch.io.batch import analyze_paths_batched
    from bliss_tpu_torch.ops import _build

    from .. import roofline
    from ..reference import analysis as reference

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    rate = int(cfg["sample_rate"])
    source = importlib.import_module(f"perfbench.sources.{traffic['source']}")
    spans = Spans(ctx.trace)

    t = time.perf_counter()
    pool_cfg = cfg["pcm_pool"]
    pool = source.make_pool(int(pool_cfg["tracks"]), float(pool_cfg["track_seconds"]),
                            ctx.seed, dev, int(pool_cfg["detune_cents"]))
    t = ctx.part("synthesis", t)

    lengths = quantile_lengths(cfg["track_seconds"], int(traffic["period"]), rate)
    if lengths.max() > pool.shape[1]:
        raise ValueError("a song is longer than the pool's tracks")
    # warm-up: one block of the lengths through the driver, which buckets it
    warm = song_table(lengths, len(lengths), pool.shape, ctx.seed + 1)
    decoder = source.decoder_class(pool, warm)
    for _, r in analyze_paths_batched(decoder, [source.song_path(i) for i in range(len(warm))],
                                      device=dev):
        if not hasattr(r, "analysis"):
            raise RuntimeError(f"warm-up song failed: {r!r}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = ctx.part("warm-up (kernel load included)", t)

    n_paths = int(traffic["paths_per_second"] * ctx.seconds) + int(traffic["period"])
    table = song_table(lengths, n_paths, pool.shape, ctx.seed)
    decoder = source.decoder_class(pool, table, spans)
    paths = [source.song_path(i) for i in range(n_paths)]
    ctx.part("song table", t)

    _build.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    feats, failed = {}, 0
    window = Window(ctx.trace, dev)
    with window:
        window_start = time.perf_counter()
        end = window_start + ctx.seconds
        results = iter(analyze_paths_batched(decoder, paths, device=dev))
        while True:
            with spans.span("driver_next"):
                item = next(results, None)
            if item is None or time.perf_counter() >= end:
                break
            path, r = item
            if hasattr(r, "analysis"):
                feats[source.song_index(path)] = r.analysis.as_arr1()
            else:
                failed += 1
                ctx.lines.append(f"failed {path}: {r!r}")
        window.close()
        results.close()
    if item is None:
        raise RuntimeError(f"the driver ran out of its {n_paths} paths inside the window")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = dict(_build.LAUNCHES_ON)
    ctx.lines.append(f"launches in the window by (kernel, device): {launches}")
    del results
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    songs = len(feats)
    done = np.array(sorted(feats), np.int64)
    view = View(window.t0_ns, window.t1_ns, window.device_ops(), spans.items, {
        "songs": songs,
        "least_s": roofline.least_seconds(table[done, 2]) if songs else 0.0,
    })

    # the reference, over a sample drawn from the seed, with the longest song
    rng = np.random.default_rng([ctx.seed, 2])
    k = min(int(traffic["sample_songs"]), songs)
    checks = dict.fromkeys(GROUPS, 0.0)
    if k:
        longest = int(done[np.argmax(table[done, 2])])
        others = rng.choice(np.setdiff1d(done, [longest]), k - 1, replace=False)
        t = time.perf_counter()
        for i in [longest, *others.tolist()]:
            x = torch.from_numpy(np.ascontiguousarray(source.samples(pool, table[i]))).to(dev)
            want = reference.features(x).cpu().numpy()
            # the bfloat16 control: the reference in bfloat16 in the program's place
            got = reference.features(x, low=True).cpu().numpy() if ctx.control == "bf16" else feats[i]
            song = gaps(got, want)
            ctx.lines.append(f"song {i} ({table[i, 2] / rate:.1f} s): {song}")
            for name, gap in song.items():
                checks[name] = max(checks[name], gap)
        ctx.lines.append(f"reference: {k} songs (the longest {table[longest, 2] / rate:.1f} s) "
                         f"in {time.perf_counter() - t:.2f} s")
    limits = traffic["limits"]
    return {
        "window_start": window_start,
        "e2e": {"scan_songs_per_s": songs / window.seconds},
        "attempted": songs + failed,
        "failed": failed,
        "memory_peak_bytes": peak,
        "view": view,
        "checks": {name: (value, float(limits[name])) for name, value in checks.items()},
    }
