#!/usr/bin/env python3
"""Where a block step of `beat_track` (#11, `csrc/beat_track.cu`) spends its time.

    python3 bliss_tpu_torch/benches/beat_track_step.py [--against DIR] [--seed N]
                                                        [--minutes 60]

Builds this tree's `beat_track.cu` as it ships and with `-DBLISS_BT_PROBE`
(clock64() stamps between the parts of a step, summed a part over each
song's steps) and, with `--against DIR` (a checkout that holds
`bliss_tpu_torch/csrc`, e.g. an earlier commit unpacked with `git archive
<commit> bliss_tpu_torch | tar -x -C tmp/other`), that tree's source the
same two ways if it has the probe, else as it ships. One nvcc each, all
started together, `-Xptxas -v`: registers, spills and stack printed; then
each shipped build's SASS (`cuobjdump -sass`): its instructions and its
MOVs, of which a step's copy of the next block's registers would be most.

On 8 synthetic 5-minute songs (chip_smoke.py's, from `--seed`) and on one
synthetic song of `--minutes` (its gathered series, as the time-sharded
analyzer forms it), every build's outputs must equal this tree's
`ops/tempo_kernels.beat_track` bit for bit (exit 1 otherwise). It prints
the cycles a step of each part, per build with the probe: the block's
inputs (their load and, for the shipped design, the wait for them), the
comb's reductions and peak, the counter and flags, the context weights,
the doublings, the phase sum, phout's reductions and peak, the catch-up
loop, the emit and stores. It times the shipped builds in the order other,
this, this, other (CUDA events, 20 calls back to back), as ms and us a step
of the longest song.

The latency floor: the dependent chain of a step in this tree's design,
`CRITICAL_PATH`, as counts of operations, times the cycles of each kind
measured here (the probe build's `latency_kernel`: a launch of 2^20
dependent repetitions of a kind, timed with CUDA events, at the clock the
probe build's own cycles and time give), times the longest song's blocks.

Needs a GPU and nvcc. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from bliss_tpu_torch.models import tempo as TP  # noqa: E402
from bliss_tpu_torch.models.analyzer import bucket_length  # noqa: E402
from bliss_tpu_torch.ops import _build  # noqa: E402
from bliss_tpu_torch.ops import tempo_kernels as TK  # noqa: E402
from bliss_tpu_torch.parallel import longsong as LS  # noqa: E402
from bliss_tpu_torch.tables import default_tables  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int
PROBE_FLAGS = ["-DBLISS_BT_PROBE"]

#: The probe's parts, in the order of its columns: the register-prefetch design has 9, this
#: tree's 10 (the ring's copy and its wait apart; the weights' quotients and
#: exponentials run beside the phase sum and count there).
PARTS = {
    9: ("block inputs", "comb reductions + peak", "counter + flags", "context weights",
        "doublings", "phase sum", "phout reductions + peak", "catch-up", "emit + stores"),
    10: ("copy ahead", "block wait", "comb reductions + peak", "counter + flags",
         "weights set-up", "doublings", "phase sum + weights", "phout reductions + peak",
         "catch-up", "emit + stores"),
}

#: `latency_kernel`'s kinds, by their index there.
LATENCY_KINDS = ("shfl", "fadd", "lds", "fdiv", "expf", "ballot", "offset", "div_rn_by")

#: The dependent chain of one block step of this tree's kernel, as counts of
#: each kind of operation (`LATENCY_KINDS`; "fadd" stands for every simple
#: float or integer operation, a comparison or a select), when bp != 0, with
#: no doubling and no catch-up, the block already in the ring:
#:   - the comb: its load, the product, the last maximum (3 `fmaxf` in the
#:     lane, 5 shuffle levels each with its `fmaxf`, a ballot, 3 integer
#:     operations), the quadratic peak (a load, 3 operations, a division, an
#:     addition) and the choice of gp: 1 load, 1 + 11 + 5 simple, 5 shuffles,
#:     a ballot, 2 loads, a division;
#:   - the flags and the choice of bp, the doubling's test: 6 simple;
#:   - kmax (a reciprocal, counted as a division) beside the offsets: a lane's
#:     round(bp k), 3 simple to clamp and choose it, a shuffle, an address,
#:     the first load, 20 dependent additions, the weight's product: 1
#:     offset, 25 simple, a shuffle, a load, a division;
#:   - phout: the last maximum (4 in the lane, 5 levels, a ballot, 3
#:     operations) and the peak, the phase: 18 simple, 5 shuffles, a ballot,
#:     a load, a division;
#:   - the beat, the skip test, the catch-up's test and the emit's 7
#:     dependent additions with their tests: 28 simple.
#: The weights' quotients and exponentials run beside the phase sum and stay
#: off the chain.
CRITICAL_PATH = {
    "fadd": 17 + 6 + 25 + 18 + 28,
    "shfl": 5 + 1 + 5,
    "ballot": 2,
    "lds": 2 + 1 + 1,
    "fdiv": 1 + 1 + 1,
    "offset": 1,
}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def build(jobs: dict) -> dict:
    """`{key: (source, extra nvcc flags)}` -> `{key: (library, path)}`, one
    nvcc each, all started together; prints registers, spills and stack."""
    out_dir = _build.BUILD / "bt_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (src, flags) in jobs.items():
        lib = out_dir / f"lib{key}.so"
        cmd = [_build.nvcc(), "-Xptxas", "-v", *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)]
        procs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lines = log.splitlines()
        for n, line in enumerate(lines):
            if "beat_track_kernel" in line and "Compiling entry" in line:
                for follow in lines[n + 1 : n + 4]:
                    if any(w in follow for w in ("registers", "spill", "stack")):
                        print(f"build {key}: {follow.strip()}", flush=True)
        libs[key] = (ctypes.CDLL(str(lib)), lib)
    return libs


def sass_counts(lib: pathlib.Path) -> str:
    """The shipped kernel's SASS: instructions and MOVs."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists() and not shutil.which(tool):
        return "SASS not read (no cuobjdump)"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    body, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "beat_track_kernel" in line
        elif inside and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            body.append(line)
    movs = sum(1 for line in body if re.search(r"\bMOV\b", line))
    return f"SASS of beat_track_kernel: {len(body)} instructions, {movs} MOV"


def time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launcher(lib, blocks, n_valid, probe=None):
    """One call of a build's launch on the block inputs, into fresh
    outputs; with `probe` the probe entry, writing the step cycles there."""
    batch, n_blocks = blocks["dfrev"].shape[:2]
    dev = blocks["dfrev"].device
    out = (torch.empty((batch, n_blocks), device=dev),
           torch.empty((batch, n_blocks, TK.MAX_BEATS), device=dev),
           torch.empty((batch, n_blocks, TK.MAX_BEATS), dtype=torch.bool, device=dev))
    head = [_build.ptr(blocks[name]) for name in TK.BLOCK_WIDTHS] + [_build.ptr(n_valid)]
    tail = [_build.ptr(t) for t in out]
    if probe is None:
        fn = lib.beat_track_launch
        fn.argtypes = [P] * 10 + [I, I, P, P, P, P]
    else:
        fn = lib.beat_track_probe_launch
        fn.argtypes = [P] * 10 + [I, I, P, P, P, P, P]
        tail.append(_build.ptr(probe))

    def run():
        _build.launch("beat_track", fn, dev, *head, batch, n_blocks, *tail)
        return out

    return run


def latencies(lib, dev, mhz: float) -> dict:
    """Cycles a dependent operation of each kind: `latency_kernel`'s chain of
    2^20 (a launch timed with CUDA events, less a launch of 16) at `mhz`."""
    seed = torch.cat([torch.full((32,), 1.0 + 2.0 ** -20), torch.full((32,), 1.5),
                      torch.arange(32.0)]).to(dev)
    out = torch.zeros(32, device=dev)
    fn = lib.beat_track_latency_launch
    fn.argtypes = [P, I, I, P, P]

    def run(kind, reps):
        return lambda: _build.launch("latency", fn, dev, _build.ptr(seed), kind, reps, _build.ptr(out))

    cycles = {}
    for kind, name in enumerate(LATENCY_KINDS):
        ms = time_ms(run(kind, 1 << 16), 3) - time_ms(run(kind, 1), 3)
        cycles[name] = ms * 1e-3 * mhz * 1e6 / (1 << 20)
    return cycles


def series_5min(seed: int, dev):
    rng = np.random.default_rng(seed)
    n = 300 * 22050
    x = np.zeros((8, bucket_length(n)), np.float32)
    for i in range(8):
        x[i, :n] = chip_smoke.synth_song(rng, n)
    xt = torch.as_tensor(x, device=dev)
    return chip_smoke.tempo_series(xt, torch.full((8,), n, device=dev))


def series_long(seed: int, minutes: float, dev):
    rng = np.random.default_rng(seed + 1)
    n = int(round(minutes * 60 * 22050))
    song = chip_smoke.synth_song(rng, n)
    ext, shard_len = LS._extended_shards(song, n, bucket_length(n, 1 << 17), 8, [dev])
    return LS._tempo_series(ext, shard_len, n)


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path, help="another checkout to build and compare")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--minutes", type=float, default=60.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)

    src = _build.CSRC / "beat_track.cu"
    jobs = {"this": (src, []), "this_probe": (src, PROBE_FLAGS)}
    if args.against:
        other = args.against.resolve() / "bliss_tpu_torch" / "csrc" / "beat_track.cu"
        jobs["other"] = (other, [])
        if "beat_track_probe_launch" in other.read_text():
            jobs["other_probe"] = (other, PROBE_FLAGS)
    libs = build(jobs)
    for key in ("this", "other"):
        if key in libs:
            print(f"{key}: {sass_counts(libs[key][1])}", flush=True)
    lat = None

    consts = TP._bt_constants(dev, default_tables().on(dev))
    failed = False
    for label, make in (("8 x 5-min", lambda: series_5min(args.seed, dev)),
                        (f"{args.minutes:g}-min song, gathered series",
                         lambda: series_long(args.seed, args.minutes, dev))):
        thresh, _, h_valid = make()
        blocks, n_valid = TP.beat_track_inputs(thresh, h_valid, consts)
        want = TK.beat_track(blocks, n_valid)
        batch, n_blocks = blocks["dfrev"].shape[:2]
        longest = int(n_valid.max())
        print(f"{label}: B = {batch}, {n_blocks} blocks, {int(n_valid.sum())} valid, the "
              f"longest song {longest}", flush=True)
        runs = {}
        for key, (lib, _) in libs.items():
            probe, parts = None, ()
            if key.endswith("_probe"):
                count = lib.beat_track_probe_parts() if hasattr(lib, "beat_track_probe_parts") else 9
                parts = PARTS[count]
                probe = torch.zeros((batch, count + 1), dtype=torch.int64, device=dev)
            runs[key] = launcher(lib, blocks, n_valid, probe)
            got = runs[key]()
            torch.cuda.synchronize()
            same = all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
            print(f"  {key}: bit for bit with this tree's beat_track: {same}", flush=True)
            failed |= not same
            if probe is not None:
                ms = time_ms(runs[key])
                steps = n_valid.to(torch.int64).clamp(min=1)
                per_step = (probe[:, : len(parts)].double() / steps.unsqueeze(1).double()).mean(0)
                total = probe[:, -1].double() / steps.double()
                mhz = float(probe[:, -1].max()) / (ms * 1e3)
                print(f"  {key}: {ms:.4f} ms ({ms * 1e3 / longest:.3f} us a step), "
                      f"{float(total.mean()):.0f} cycles a step in all, clock {mhz:.0f} MHz; a step "
                      "by part (cycles, mean over songs): "
                      + ", ".join(f"{n} {v:.0f}" for n, v in zip(parts, per_step.tolist())),
                      flush=True)
                if key == "this_probe":
                    if lat is None:
                        lat = latencies(lib, dev, mhz)
                        print("  latency, cycles a dependent operation: "
                              + ", ".join(f"{k} {v:.1f}" for k, v in lat.items()), flush=True)
                    floor_cycles = sum(n * lat[k] for k, n in CRITICAL_PATH.items())
                    floor_ms = floor_cycles * longest / (mhz * 1e3)
                    print(f"  latency floor: {floor_cycles:.0f} cycles a step x {longest} blocks at "
                          f"{mhz:.0f} MHz = {floor_ms:.4f} ms ({floor_cycles / mhz:.3f} us a step) "
                          f"[{card}]", flush=True)
        order = ["this", "this"]
        if "other" in runs:
            order = ["other", *order, "other"]
        for i, key in enumerate(order):
            ms = time_ms(runs[key])
            print(f"  {key} (run {i}): {ms:.4f} ms = {ms * 1e3 / longest:.3f} us a step of "
                  f"{longest} [{card}]", flush=True)
        del blocks, thresh, want, runs
        torch.cuda.empty_cache()
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
