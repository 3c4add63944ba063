#!/usr/bin/env python3
"""The time-sharded long-song route beside another checkout's.

    python3 bliss_tpu_torch/benches/longsong_route.py [--against DIR] [--minutes 60]
                                                      [--reps 7] [--seed 0]

Makes one synthetic song of `--minutes` (chip_smoke.py's, from `--seed`)
and times `parallel.longsong.sharded_analyze_samples(shards=8)` on it, each
checkout in a process of its own (this tree; with `--against DIR`, a
checkout that holds `bliss_tpu_torch`, e.g. the parent unpacked with
`git archive HEAD~1 bliss_tpu_torch | tar -x -C tmp/parent`), in the order
other, this, this, other: the first call (the kernels' build included),
then `--reps` warm calls, each ended by the vector's copy to the host, and
as many after `torch.cuda.empty_cache()` (as chip_smoke.py times the route:
every buffer from `cudaMalloc` again); their medians. The vectors of one tree's processes must be equal (exit 1
otherwise); the largest distance between the two trees' is printed.

Needs a GPU and nvcc. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]


def child(root: pathlib.Path, song_path: pathlib.Path, reps: int) -> None:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from bliss_tpu_torch.parallel.longsong import sharded_analyze_samples

    song = np.load(song_path)
    n = song.shape[0]
    t0 = time.perf_counter()
    vec = sharded_analyze_samples(song, n, 2, shards=8, device="cuda")
    first = time.perf_counter() - t0
    warm, emptied = [], []
    for times in (warm, emptied):
        for _ in range(reps):
            if times is emptied:
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharded_analyze_samples(song, n, 2, shards=8, device="cuda")
            times.append(time.perf_counter() - t0)
    print(json.dumps({"first": first, "warm": warm, "emptied": emptied,
                      "vector": np.asarray(vec).tolist()}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path, help="another checkout to time beside this one")
    ap.add_argument("--minutes", type=float, default=60.0)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--song", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.song, args.reps)
        return

    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    card = chip_smoke.card_line()
    print(card, flush=True)
    n = int(round(args.minutes * 60 * 22050))
    song = chip_smoke.synth_song(np.random.default_rng(args.seed), n)
    out = REPO / "bliss_tpu_torch" / "build"
    out.mkdir(parents=True, exist_ok=True)
    song_path = out / f"longsong_{args.seed}_{n}.npy"
    np.save(song_path, song)
    del song

    trees = {"this": REPO}
    order = ["this", "this"]
    if args.against:
        trees["other"] = args.against.resolve()
        order = ["other", *order, "other"]
    vectors = {}
    for i, key in enumerate(order):
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(trees[key]), "--song", str(song_path),
             "--reps", str(args.reps)], capture_output=True, text=True,
        )
        if proc.returncode:
            sys.exit(f"{key} failed:\n{proc.stderr[-4000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        vectors.setdefault(key, []).append(r["vector"])
        print(f"{key} (run {i}): sharded_analyze_samples, {args.minutes:g}-min song, 8 shards: "
              f"first {r['first']:.3f} s, warm median {statistics.median(r['warm']):.3f} s "
              f"(min {min(r['warm']):.3f}, max {max(r['warm']):.3f}, {len(r['warm'])} calls), "
              f"after empty_cache median {statistics.median(r['emptied']):.3f} s (min "
              f"{min(r['emptied']):.3f}, max {max(r['emptied']):.3f}) [{card}]", flush=True)
    song_path.unlink()
    if "other" in vectors:
        gap = max(abs(a - b) for a, b in zip(vectors["this"][0], vectors["other"][0]))
        print(f"largest distance between the two trees' vectors: {gap:.3g}", flush=True)
    if any(v != runs[0] for runs in vectors.values() for v in runs):
        sys.exit("one tree's vectors differ between its processes")


if __name__ == "__main__":
    main()
