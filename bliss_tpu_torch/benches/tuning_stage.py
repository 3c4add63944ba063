#!/usr/bin/env python3
"""The chroma stage's tuning on the card, this checkout beside another.

    python3 bliss_tpu_torch/benches/tuning_stage.py [--against DIR] [--seed N]

Makes `chip_smoke.py`'s synthetic main-path batch (8 songs of 5 minutes
from `--seed`, by that checkout's `synth_song`) and times, on its STFT spectra:
the fused tuning stage (`models/chroma.py:_estimate_tuning_fused`, the
route a bucket of this length takes), the unfused one (`estimate_tuning`),
the whole chroma stage (`chroma_features`, V2, f32) and the fused stage's
peak device memory above what it was handed. Times are CUDA-event times of
back-to-back calls after a warm-up (`chip_smoke.time_ms`); a torch.profiler
trace of ten fused stages gives each device op's time a call.

`--against DIR` runs another checkout the same way (DIR holds its
`bliss_tpu_torch/` and `chip_smoke.py`; e.g. the parent, unpacked by
`git archive HEAD~1 | tar -x -C tmp/parent`). Each checkout runs in a
process of its own, in the order other, this, this, other, and the script
prints whether their tunings are equal.

Needs a GPU and nvcc. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
SONGS, SECONDS = 8, 300.0  # chip_smoke.py's 8 x 5-min batch


def measure(root: pathlib.Path, seed: int) -> dict:
    """One checkout's numbers, in this process."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as CS
    from bliss_tpu_torch.models import chroma as CH
    from bliss_tpu_torch.models.analyzer import bucket_length
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.ops.spectral import stft
    from bliss_tpu_torch.ops.windows import n_frames_stft
    from bliss_tpu_torch.tables import default_tables

    _build.build_all()
    rng = np.random.default_rng(seed)
    n = int(round(SECONDS * 22050))
    tpad = bucket_length(n)
    batch = np.zeros((SONGS, tpad), np.float32)
    for i in range(SONGS):
        batch[i, :n] = CS.synth_song(rng, n)
    dev = torch.device("cuda", 0)
    x = torch.as_tensor(batch, device=dev)
    lens = torch.full((SONGS,), n, device=dev)
    nfc = int(n_frames_stft(tpad, 2205))
    frame_mask = torch.arange(nfc, device=dev) < n_frames_stft(lens, 2205).unsqueeze(-1)
    spectrum = stft(x, 8192, 2205, lens, nfc)
    tables = default_tables().on(dev)

    def fused():
        return CH._estimate_tuning_fused(spectrum, frame_mask, 8192)

    def unfused():
        return CH.estimate_tuning(spectrum, frame_mask, 8192)

    tuning = fused()
    same_routes = bool(torch.equal(tuning, unfused()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fused()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    # device time of each kernel of the fused stage, per call
    from torch.profiler import ProfilerActivity, profile

    reps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fused()
        torch.cuda.synchronize()
    device = {}
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            device[e.key[:70]] = dt / reps / 1e3
    return {
        "root": str(root),
        "device_ms": dict(sorted(device.items(), key=lambda kv: -kv[1])),
        "fused_ms": CS.time_ms(fused, 10),
        "unfused_ms": CS.time_ms(unfused, 5),
        "chroma_ms": CS.time_ms(lambda: CH.chroma_features(x, lens, 2, torch.float32, tables), 5),
        "fused_peak_mb": peak / 1e6,
        "tuning": tuning.tolist(),
        "unfused_equal": same_routes,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=pathlib.Path, help="another checkout to run beside this one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(args.child, args.seed)), flush=True)
        return

    import torch

    if not torch.cuda.is_available():
        sys.exit("tuning_stage: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    order = [REPO, REPO]
    if args.against:
        other = args.against.resolve()
        order = [other, REPO, REPO, other]
    runs = []
    for root in order:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(root), "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            sys.exit(f"tuning_stage: the run of {root} failed:\n{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        label = "this" if root == REPO else "other"
        print(f"{label}: fused tuning {run['fused_ms']:.4f} ms, unfused {run['unfused_ms']:.4f} ms, "
              f"chroma stage {run['chroma_ms']:.4f} ms, fused stage peak {run['fused_peak_mb']:.1f} MB "
              f"above its inputs; unfused == fused: {run['unfused_equal']}; tuning {run['tuning']}",
              flush=True)
        dev = run["device_ms"]
        print(f"  fused stage, device time a call (torch.profiler): {sum(dev.values()):.4f} ms in "
              f"{len(dev)} kinds of device op; longest: "
              + "; ".join(f"{k} {v:.4f}" for k, v in list(dev.items())[:6]), flush=True)
    equal = all(r["tuning"] == runs[0]["tuning"] for r in runs)
    print(f"tunings equal across runs: {equal} [{card}]", flush=True)
    if not equal or not all(r["unfused_equal"] for r in runs):
        sys.exit(1)


if __name__ == "__main__":
    main()
