#!/usr/bin/env python3
"""`timbral_flat` (#8, `csrc/timbral_flat.cu`) beside another checkout's.

    python3 bliss_tpu_torch/benches/flat_dft.py [--against DIR] [--seed N]

Builds this tree's `timbral_flat.cu` and `timbral_fft.cu`, the flat kernel's
bf16x3 control (the same source with `-DBLISS_FLAT_PRODUCTS=3`: hh, hm and
mh only) and, with `--against DIR` (a checkout that holds
`bliss_tpu_torch/csrc`, e.g. the parent unpacked with `git archive HEAD~1
bliss_tpu_torch | tar -x -C tmp/parent`), the same entries of that checkout:
its `timbral_flat_launch` from `csrc/timbral_flat.cu` if it has one, else
from `csrc/frame_dft.cu` (the direct DFT on the CUDA cores, with the twiddle
table's two rows in place of the tensor-core twiddle block). One nvcc each,
all started together, `-Xptxas -v`: registers, spills and ptxas warnings
printed.

On 8 synthetic-noise songs of 5 minutes (the batch's bucket, 57,341 frames
a song) it holds each build's rows at `dft_kernels.timbral_flat_held`'s
limits, the ones chip_smoke.py holds the kernel to (the sums against the
plain version, the log2 sum's geometric mean against an f64 DFT beside the
plain version's), says whether `timbral_fft`'s rows of the two trees are
equal bit for bit, and times the builds in the order other, this, control,
control, this, other (CUDA events, 10 calls back to back) beside the
design's floor (six bf16 passes at 989 TFLOP/s). It exits 1 if this tree's
kernel breaks a limit or the control does not.

Needs a GPU and nvcc. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from bliss_tpu_torch.ops import _build  # noqa: E402
from bliss_tpu_torch.ops import dft_kernels as DK  # noqa: E402

SONGS, T, N_FRAMES = 8, 7_340_032, 57_341
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: The bf16x3 control: the kernel's source with three products a k step.
CONTROL_FLAGS = ["-DBLISS_FLAT_PRODUCTS=3"]


def build(jobs: dict) -> dict:
    """`{key: (source path, extra nvcc flags)}` -> `{key: loaded library}`,
    one nvcc each, all started together; prints each build's registers,
    spills and warnings."""
    out_dir = _build.BUILD / "flat_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (src, flags) in jobs.items():
        lib = out_dir / f"lib{key}.so"
        cmd = [_build.nvcc(), "-Xptxas", "-v", *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)]
        procs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "arning")):
                print(f"build {key}: {line.strip()}", flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def held(key: str, got, want, exact) -> bool:
    """Prints `got`'s readings at timbral_flat_held's limits; True if it
    meets them."""
    r, broken = DK.timbral_flat_held(got, want, exact)
    print(f"{key}: relative {r['rel']:.3g}, below {r['below']:g}; per-frame geo_mean distance "
          f"mean (max) to f64 {r['geo_f64_mean']:.3g} ({r['geo_f64_max']:.3g}), plain to f64 "
          f"{r['geo_plain_f64_mean']:.3g} ({r['geo_plain_f64_max']:.3g}), to plain "
          f"{r['geo_plain_mean']:.3g} ({r['geo_plain_max']:.3g}); limits broken: "
          f"{'; '.join(broken) or 'none'}", flush=True)
    return not broken


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path, help="another checkout to build and compare")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    jobs = {
        "flat": (_build.CSRC / "timbral_flat.cu", []),
        "fft": (_build.CSRC / "timbral_fft.cu", []),
        "control": (_build.CSRC / "timbral_flat.cu", CONTROL_FLAGS),
    }
    other_csrc = args.against.resolve() / "bliss_tpu_torch" / "csrc" if args.against else None
    if other_csrc:
        flat = other_csrc / "timbral_flat.cu"
        jobs["other_flat"] = (flat if flat.exists() else other_csrc / "frame_dft.cu", [])
        jobs["other_fft"] = (other_csrc / "timbral_fft.cu", [])
    libs = build(jobs)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((SONGS, T), generator=gen, device=dev) * 0.1
    win, tw = DK._constants(512, "cuda:0")
    bmat = DK._flat_block(tw)
    outs = {k: torch.empty((SONGS, N_FRAMES, 5), device=dev) for k in libs}
    head = (x, SONGS, T, N_FRAMES, DK.TIMBRAL_HOP, DK.TIMBRAL_OFFSET)

    def launcher(key):
        fn = libs[key].timbral_fft_launch if key.endswith("fft") else libs[key].timbral_flat_launch
        tensor_cores = jobs[key][0].name == "timbral_flat.cu"
        fn.restype = I
        if tensor_cores:  # (x, B, T, F, hop, offset, win, twiddle block, out, stream)
            fn.argtypes = [P, I, L, I, I, I, P, P, P, P]
            tail = (win, bmat, outs[key])
        else:  # (x, B, T, F, hop, offset, win, tw_re, tw_im, out, stream)
            fn.argtypes = [P, I, L, I, I, I, P, P, P, P, P]
            tail = (win, tw[0], tw[1], outs[key])

        def run():
            ptrs = [_build.ptr(t) for t in (head[0], *tail)]
            _build.launch(key, fn, dev, ptrs[0], *head[1:], *ptrs[1:])

        return run

    runs = {k: launcher(k) for k in libs}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    want = DK.timbral_flat_plain(x, N_FRAMES)
    exact = DK.timbral_flat_f64(x, N_FRAMES)
    ok = held("this tree's timbral_flat", outs["flat"], want, exact)
    refused = not held("bf16x3 control", outs["control"], want, exact)
    print(f"the limits refuse the bf16x3 control: {refused}", flush=True)
    if other_csrc:
        held(f"other tree's timbral_flat ({jobs['other_flat'][0].name})", outs["other_flat"], want,
             exact)
        gap = DK.geo_gap(outs["flat"], outs["other_flat"])
        print(f"this tree's timbral_flat vs the other's: equal bit for bit "
              f"{torch.equal(outs['flat'], outs['other_flat'])}, per-frame geo_mean distance max "
              f"{gap.max().item():.3g}", flush=True)
        print(f"timbral_fft rows of the two trees equal bit for bit: "
              f"{torch.equal(outs['fft'], outs['other_fft'])}", flush=True)
    del want, exact
    floor_ms = SONGS * N_FRAMES * 512 * 512 * 2 * 6 / 989e12 * 1e3
    order = ["flat", "control", "control", "flat"]
    if other_csrc:
        order = ["other_flat", *order, "other_flat"]
    for i, key in enumerate(order):
        name = {"flat": "this tree", "control": "bf16x3 control", "other_flat": "other tree"}[key]
        print(f"timbral_flat [{SONGS}, {T}], {N_FRAMES} frames, {name} (run {i}): "
              f"{time_ms(runs[key]):.4f} ms; six bf16 passes at 989 TFLOP/s: {floor_ms:.4f} ms",
              flush=True)
    if not (ok and refused):
        sys.exit(1)


if __name__ == "__main__":
    main()
