#!/usr/bin/env python3
"""Where the time of the three strided-frame kernels goes on the card.

    python3 bliss_tpu_torch/benches/frame_fft_variants.py [--against DIR]

`frame_dft_mags` (#7, `csrc/frame_dft.cu`), `timbral_fft` (#1) and
`specflux` (#2) share one staged tile loop (`csrc/frame_tiles.cuh`) around
the warp FFT. Each source is built once per setting of its compile-time
switches (one nvcc each, all in parallel, into the ignored build directory;
`-Xptxas -v`, registers and spills printed) and timed, in two rounds, at the
shapes the analysis gives it, beside copies PyTorch makes of the same bytes:

- `base`: the kernel as the package builds it;
- `no_epilogue`: the transform without its epilogue (#7's stores, #1's
  reductions, #2's flux);
- `no_fft`: staging and the epilogue without the transform (wrong output);
- `staging`: staging alone;
- #7 only: `plain_store` (ordinary stores instead of streaming ones),
  `tile16` (16-frame tiles), `waves1`, `waves8` (shorter and longer runs of
  tiles a block).

`--against DIR` also builds the three sources of another checkout (DIR holds
its `bliss_tpu_torch/csrc`; same entry points and argument lists) as
`other`, times it in the order other, this, ..., this, other, and prints
whether its output equals this tree's bit for bit and, column by column
(#1: total, weighted, below, log2 sum, energy; #2: flux, total), how far
it sits from this tree's.

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

PROBES = {
    "base": [],
    "no_epilogue": ["-DBLISS_FRAME_FFT_PROBE=1"],
    "no_fft": ["-DBLISS_FRAME_FFT_PROBE=2"],
    "staging": ["-DBLISS_FRAME_FFT_PROBE=4"],
}
VARIANTS = {
    "frame_dft": {
        **PROBES,
        "plain_store": ["-DBLISS_FRAME_FFT_PROBE=3"],
        "tile16": ["-DBLISS_FRAME_FFT_TILE=16"],
        "waves1": ["-DBLISS_FRAME_FFT_WAVES=1"],
        "waves8": ["-DBLISS_FRAME_FFT_WAVES=8"],
    },
    "timbral_fft": PROBES,
    "specflux": PROBES,
}
ENTRY = {
    "frame_dft": "frame_dft_mags_launch",
    "timbral_fft": "timbral_fft_launch",
    "specflux": "specflux_launch",
}
HALO = 8192 + 2205
# (source, label, batch, samples a row, hop, offset, frames, output floats a frame)
SHAPES = [
    ("frame_dft", "long song's 8 shards", 8, 10_485_760 + 2 * HALO, 256, 2048 - HALO, 40_967, 257),
    ("frame_dft", "8 x 5-min", 8, 7_340_032, 128, 384, 57_341, 257),
    ("timbral_fft", "8 x 5-min", 8, 7_340_032, 128, 384, 57_341, 5),
    ("timbral_fft", "long song's 8 shards", 8, 10_485_760 + 2 * HALO, 128, 384 - HALO, 81_920, 5),
    ("specflux", "8 x 5-min", 8, 7_340_032, 256, 256, 28_671, 2),
]


def build(jobs: dict) -> dict:
    """`{key: (source path, defines)}` -> `{key: loaded library}`, one nvcc
    each, all started together; prints each build's registers and spills."""
    out_dir = _build.BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (src, defines) in jobs.items():
        lib = out_dir / f"lib{'-'.join(key)}.so"
        cmd = [_build.nvcc(), "-Xptxas", "-v", *_build.NVCC_FLAGS, *defines, "-o", str(lib), str(src)]
        procs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines() if "registers" in line]
        print(f"build {'/'.join(key)}: {'; '.join(regs)}", flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    return libs


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=pathlib.Path, help="another checkout to build and compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    jobs = {(src, name): (_build.CSRC / f"{src}.cu", d) for src, v in VARIANTS.items() for name, d in v.items()}
    if args.against:
        for src in VARIANTS:
            jobs[(src, "other")] = (args.against.resolve() / "bliss_tpu_torch" / "csrc" / f"{src}.cu", [])
    libs = build(jobs)
    dev = torch.device("cuda", 0)
    win, tw = DK._constants(512, "cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for src, label, batch, t, hop, offset, n_frames, width in SHAPES:
        x = torch.randn((batch, t), generator=gen, device=dev) * 0.1
        out = torch.empty((batch, n_frames, width), device=dev)

        def run(lib, dst=out):
            fn = getattr(lib, ENTRY[src])
            fn.argtypes, fn.restype = [p, i, ll, i, i, i, p, p, p, p, p], i
            _build.launch("variant", fn, dev,
                _build.ptr(x), batch, t, n_frames, hop, offset, _build.ptr(win),
                _build.ptr(tw[0]), _build.ptr(tw[1]), _build.ptr(dst))

        head = f"{src} {label} [{batch}, {t}] hop {hop} offset {offset}, {n_frames} frames"
        names = list(VARIANTS[src])
        if args.against:
            other = torch.empty_like(out)
            run(libs[(src, "base")])
            run(libs[(src, "other")], other)
            torch.cuda.synchronize()
            fin = torch.isfinite(out) & torch.isfinite(other)
            rel = torch.where(fin, (out - other).abs() / other.abs().clamp(min=1e-30), 0.0)
            cols = rel.amax((0, 1)).tolist() if width < 257 else [rel.max().item()]
            print(f"{head}: this tree vs other, bit for bit {torch.equal(out, other)}, largest relative "
                  f"difference of finite entries {[float(f'{c:.3g}') for c in cols]}, same non-finite "
                  f"entries {torch.equal(torch.isfinite(out), torch.isfinite(other))}", flush=True)
            del other
            names = ["other", *names]
        for rnd, order in enumerate((names, names[::-1])):
            for name in order:
                print(f"{head} round {rnd} {name}: {time_ms(lambda: run(libs[(src, name)])):.4f} ms",
                      flush=True)
        print(f"{head}: fill of the output {time_ms(lambda: out.fill_(1.0)):.4f} ms, clone of the "
              f"input {time_ms(lambda: x.clone()):.4f} ms", flush=True)
        del x, out


if __name__ == "__main__":
    main()
