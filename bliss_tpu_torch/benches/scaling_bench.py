"""Weak scaling of the device-list paths, and a gloo group's cost a round
(counterpart of benches/scaling_bench.py).

    python -m bliss_tpu_torch.benches.scaling_bench [--device cuda] [--entries 8] [--small]

Over device lists of 1, 2 and `--entries` entries (on a card: every visible
card in turn, repeated to the length; `--device cuda:K` repeats card K; on
the CPU: `cpu` repeated), each entry's work fixed while the list grows, it
times the three sharded paths of the JAX bench:

  * `parallel.mesh.sharded_analyze_batch`: one batch of `songs` songs an
    entry (the same rows in every entry's group);
  * `parallel.mesh.sharded_top_k` (k = 100) over `rows` library rows an
    entry, the matrix already placed on the list (`place_rows`), as a
    `Library` holds it;
  * `parallel.longsong.sharded_chroma_features` and
    `sharded_analyze_samples` on one song of `long_samples` samples an
    entry, one shard an entry.

Sizes on a card: 8 x 5-min songs an entry (bucket 7,340,032, the JAX
package's batch shape), 100,000 rows an entry, 7.5 minutes of the song an
entry (the 60-minute song at 8 entries). With `--small` or on the CPU: the
JAX bench's sizes, one song of `1 << 17` samples, 4,096 rows and `1 << 16`
samples an entry.

Each path's time is the median of `REPEAT` warm calls after one untimed
call, each ended by a synchronize (the paths return numpy). Per list it
prints those seconds, `weak_scaling_efficiency_analyze` = t(1)/t(N) (the
JAX bench's metric), `per_entry_overhead` = t(N) / (N t(1)) for each path
(entries of one card run in turn, so 1.0 is ideal there) and
`distinct_cards`. Each list's features, top-k and long-song outputs must
equal the one-entry run's bit for bit (the one-entry top-k and long song
on the same inputs); otherwise the bench exits 1 after its JSON line.

Then the gloo group's cost a round (the JAX bench's `_dcn_overhead_bench`):
two processes of one `parallel.distributed` group on 127.0.0.1 (this
module with `--worker RANK --port P`; on a card both on the same card),
each timing `ROUNDS` rounds of three entries on the same rows, 4 songs a
process (5 minutes on a card, 16,384 samples with `--small` or on the
CPU): `analyze_batch_distributed`, `sharded_analyze_batch` over the
process's one device on the rows already at the global length (the
distributed round without its exchange and its padded copy) and local
`analyze_batch`; then the round's one exchange alone (`process_allgather`
of its two integers). A warm round of each first and a barrier before and
after every timed round; medians a rank, each rank's distributed round
above its local one (`overhead_ms`), and whether the three entries'
features are equal. The data come from `SEED`.

Prints one JSON line last, with the card's name and power limit (`card`).
`--device cuda` without a card raises.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

from . import card, emit

REPO = pathlib.Path(__file__).resolve().parents[2]
SR = 22050
TOP_K = 100

#: Each entry's work on a card and on the CPU (`--small`).
CARD_SIZES = {"songs": 8, "song_samples": 300 * SR, "rows": 100_000,
              "long_samples": 450 * SR, "gloo_song_samples": 300 * SR}
SMALL_SIZES = {"songs": 1, "song_samples": (1 << 17) - 17, "rows": 4096,
               "long_samples": 1 << 16, "gloo_song_samples": 16384 - 11}
#: Songs a process in the gloo rounds, and how long a worker may take.
GLOO_SONGS = 4
#: Warm calls a path, timed gloo rounds an entry, and the data's seed.
REPEAT = 3
ROUNDS = 5
SEED = 0
GLOO_TIMEOUT_S = 600.0


def sizes_for(device: str, small: bool) -> dict:
    return SMALL_SIZES if small or device == "cpu" else CARD_SIZES


def device_list(device: str, entries: int) -> list:
    """`entries` entries: `cpu` or one card repeated, or (`cuda`) every
    visible card in turn. Raises for `cuda` without a card."""
    import torch

    from ..models.analyzer import resolve_device

    first = resolve_device(device)
    if first.type == "cuda" and torch.device(device).index is None:
        return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(entries)]
    return [first] * entries


def songs(rng: np.random.Generator, count: int, n: int) -> np.ndarray:
    """`[count, n]` f32 songs: noise, a tone and a 2 Hz beat envelope."""
    t = np.arange(n, dtype=np.float32) / np.float32(SR)
    env = (0.4 + 0.6 * (np.sin(2 * np.pi * 2.0 * t) > 0)).astype(np.float32)
    out = np.empty((count, n), np.float32)
    for i in range(count):
        tone = np.sin(np.float32(2 * np.pi * rng.uniform(110.0, 880.0)) * t)
        out[i] = (rng.standard_normal(n, dtype=np.float32) * np.float32(0.08)
                  + np.float32(0.3) * tone) * env
    return out


def make_inputs(sizes: dict, max_entries: int, seed: int) -> dict:
    """One entry's batch (padded to its bucket) and lengths, the library
    rows and the long song of `max_entries` entries; a list of N entries
    takes the first N entries' rows and samples."""
    from ..models.analyzer import bucket_length

    rng = np.random.default_rng(seed)
    n = sizes["song_samples"]
    batch = np.zeros((sizes["songs"], bucket_length(n)), np.float32)
    batch[:, :n] = songs(rng, sizes["songs"], n)
    library = rng.uniform(-1.0, 1.0, size=(max_entries * sizes["rows"], 23)).astype(np.float32)
    long_song = songs(rng, 1, max_entries * sizes["long_samples"])[0]
    return {"batch": batch, "lengths": np.full(sizes["songs"], n, np.int64),
            "library": library, "long_song": long_song}


def _timed(fn, repeat: int, devs) -> tuple:
    """(first output, median seconds of `repeat` warm calls)."""
    import torch

    def sync():
        for d in set(devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    out = fn()
    times = []
    for _ in range(repeat):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def run_list(devs: list, inputs: dict, sizes: dict, repeat: int, one: dict | None) -> dict:
    """Time the three paths over `devs`; hold each output against `one`
    (the one-entry run's features) or the one-entry route on the same
    inputs. Returns the list's seconds, outputs and `bit_for_bit`."""
    from ..parallel.longsong import sharded_analyze_samples, sharded_chroma_features
    from ..parallel.mesh import place_rows, sharded_analyze_batch, sharded_top_k

    n = len(devs)
    batch = np.tile(inputs["batch"], (n, 1))
    lengths = np.tile(inputs["lengths"], n)
    feats, analyze_s = _timed(lambda: sharded_analyze_batch(devs, batch, lengths), repeat, devs)
    del batch

    library = inputs["library"][: n * sizes["rows"]]
    seeds = (feats if one is None else one["features"])[:1]
    blocks = place_rows(devs, library)
    top, top_k_s = _timed(lambda: sharded_top_k(devs, blocks, seeds, TOP_K, n_real=len(library)),
                          repeat, devs)
    del blocks

    song = inputs["long_song"][: n * sizes["long_samples"]]
    length = song.shape[0]
    chroma, chroma_s = _timed(
        lambda: sharded_chroma_features(song, length, shards=n, devices=devs), repeat, devs)
    vector, longsong_s = _timed(
        lambda: sharded_analyze_samples(song, length, shards=n, devices=devs), repeat, devs)

    held = {}
    if one is not None:
        first = devs[:1]
        want_top = sharded_top_k(first, library, seeds, TOP_K)
        held = {
            "features": np.array_equal(feats, np.tile(one["features"], (n, 1))),
            "top_k": all(np.array_equal(a, b) for a, b in zip(top, want_top)),
            "chroma": np.array_equal(
                chroma, sharded_chroma_features(song, length, shards=n, devices=first)),
            "longsong": np.array_equal(
                vector, sharded_analyze_samples(song, length, shards=n, devices=first)),
        }
    return {
        "entries": n,
        "distinct_cards": len({d for d in devs if d.type == "cuda"}),
        "analyze_s": analyze_s, "top_k_s": top_k_s, "chroma_s": chroma_s,
        "longsong_s": longsong_s,
        "bit_for_bit": all(held.values()), "held": held,
        "features": feats, "finite": bool(np.isfinite(feats).all() and np.isfinite(vector).all()),
    }


PATHS = ("analyze", "top_k", "chroma", "longsong")


def run_lists(device: str, entries, sizes: dict, repeat: int = REPEAT, seed: int = SEED,
              log=print) -> list:
    """`run_list` over lists of each count in `entries` (the first 1), each
    list's efficiency and overheads against the one-entry list's seconds."""
    entries = list(entries)
    lists = [device_list(device, n) for n in entries]
    inputs = make_inputs(sizes, max(entries), seed)
    one, out = None, []
    for n, devs in zip(entries, lists):
        row = run_list(devs, inputs, sizes, repeat, one)
        if one is None:
            one = row
        row["weak_scaling_efficiency_analyze"] = one["analyze_s"] / row["analyze_s"]
        row["per_entry_overhead"] = {
            p: row[f"{p}_s"] / (n * one[f"{p}_s"]) for p in PATHS}
        log(f"entries={n} ({row['distinct_cards']} distinct cards): "
            + " | ".join(f"{p} {row[f'{p}_s'] * 1e3:.1f} ms (x{row['per_entry_overhead'][p]:.3f} "
                         "an entry)" for p in PATHS)
            + f"; efficiency {row['weak_scaling_efficiency_analyze']:.3f}; held {row['held']}",
            flush=True)
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# the gloo group's cost a round
# ---------------------------------------------------------------------------


def gloo_worker(rank: int, port: int, device: str, small: bool) -> None:
    """One process of the two-process group: `ROUNDS` rounds of each entry
    on the same rows; rank 0 prints `SCALING_GLOO {json}`."""
    import torch

    from ..models.analyzer import analyze_batch, bucket_length, resolve_device
    from ..parallel import distributed as D
    from ..parallel.mesh import sharded_analyze_batch

    dev = resolve_device(device)
    sizes = sizes_for(device, small)
    n = sizes["gloo_song_samples"]
    rng = np.random.default_rng(SEED + 7 + rank)
    sigs = np.zeros((GLOO_SONGS, bucket_length(n)), np.float32)
    sigs[:, :n] = songs(rng, GLOO_SONGS, n)
    lens = np.full(GLOO_SONGS, n, np.int64)
    D.initialize(f"tcp://127.0.0.1:{port}", 2, rank, timeout_seconds=GLOO_TIMEOUT_S)
    try:
        def distributed():
            return D.analyze_batch_distributed([dev], sigs, lens)

        def sharded():
            # both ranks' rows share one bucket: `sigs` is at the global length
            return sharded_analyze_batch([dev], sigs, lens)

        def local():
            return analyze_batch(sigs, lens, device=dev)

        def exchange():
            return D.process_allgather(np.array([GLOO_SONGS, sigs.shape[1]], np.int64))

        got, plain, want = distributed(), sharded(), local()  # warm rounds
        exchange()
        entries = (("distributed", distributed), ("sharded", sharded), ("local", local),
                   ("exchange", exchange))
        times = {}
        for name, fn in entries:
            times[name] = []
            for _ in range(ROUNDS):
                D.barrier()
                t0 = time.perf_counter()
                fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                times[name].append(time.perf_counter() - t0)
                D.barrier()
        same = np.array_equal(got, want) and np.array_equal(plain, want)
        mine = np.array([statistics.median(times[name]) for name, _ in entries] + [float(same)])
        every = D.process_allgather(mine)
    finally:
        D.shutdown()
    if rank == 0:
        print("SCALING_GLOO " + json.dumps({
            "processes": 2, "songs_a_process": GLOO_SONGS, "song_samples": n, "rounds": ROUNDS,
            **{f"{name}_ms": [float(r[i] * 1e3) for r in every]
               for i, (name, _) in enumerate(entries)},
            "overhead_ms": [float((r[0] - r[2]) * 1e3) for r in every],
            "bit_for_bit": bool(every[:, -1].all()),
        }), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gloo_overhead(device: str, small: bool) -> dict:
    """Start the two workers (a card: both on `cuda:0`, or the card of
    `cuda:K`), wait for both at most `GLOO_TIMEOUT_S` seconds, and return
    rank 0's report; raises if a worker fails."""
    if device == "cuda":
        device = "cuda:0"
    port = _free_port()
    cmd = [sys.executable, "-m", "bliss_tpu_torch.benches.scaling_bench", "--device", device,
           "--port", str(port)]
    if small:
        cmd.append("--small")
    procs = [subprocess.Popen(cmd + ["--worker", str(rank)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GLOO_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"gloo worker {rank} exited {p.returncode}:\n{out[-3000:]}")
    for line in outs[0].splitlines():
        if line.startswith("SCALING_GLOO "):
            return json.loads(line[len("SCALING_GLOO "):])
    raise RuntimeError(f"gloo worker 0 printed no report:\n{outs[0][-3000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.benches.scaling_bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entries", type=int, default=8)
    ap.add_argument("--small", action="store_true", help="the CPU sizes on any device")
    ap.add_argument("--worker", type=int, metavar="RANK", help="run as one gloo worker")
    ap.add_argument("--port", type=int, help="the gloo group's port (with --worker)")
    args = ap.parse_args(argv)
    if args.worker is not None:
        gloo_worker(args.worker, args.port, args.device, args.small)
        return 0
    sizes = sizes_for(args.device, args.small)
    entries = sorted({1, 2, args.entries})
    rows = run_lists(args.device, entries, sizes, REPEAT, SEED)
    gloo = gloo_overhead(args.device, args.small)
    print(f"gloo: distributed {gloo['distributed_ms']} ms, sharded on pre-padded rows "
          f"{gloo['sharded_ms']} ms, local {gloo['local_ms']} ms a round, distributed above "
          f"local {gloo['overhead_ms']} ms, the exchange alone {gloo['exchange_ms']} ms, "
          f"bit for bit {gloo['bit_for_bit']}", flush=True)
    held = all(r["bit_for_bit"] for r in rows) and gloo["bit_for_bit"]
    last = rows[-1]
    emit({
        "metric": "weak_scaling_efficiency_analyze",
        "value": last["weak_scaling_efficiency_analyze"],
        "unit": f"t(1 entry) / t({last['entries']} entries), sharded_analyze_batch, "
                "each entry's work fixed",
        "lists": [{k: v for k, v in r.items() if k not in ("features",)} for r in rows],
        "gloo": gloo,
        "bit_for_bit": held,
        "finite": all(r["finite"] for r in rows),
        "sizes": sizes,
        "device": args.device,
        "card": card(device_list(args.device, 1)[0]),
    })
    return 0 if held and all(r["finite"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
