#!/usr/bin/env python3
"""Which part of `frame_dft_mags_kernel` holds its time on the card.

    python3 bliss_tpu_torch/benches/frame_fft_variants.py

Builds `csrc/frame_dft.cu` once per setting of its compile-time switches
(`BLISS_FRAME_FFT_PROBE`, `_TILE`, `_WAVES`; one nvcc each, in parallel, into
the ignored build directory), and times each at the long song's shape
(`[8, 10,506,554]`, hop 256, 40,967 frames a shard) and at 8 x 5-min, hop
128, in two rounds, beside two copies PyTorch makes of the same bytes:

- `base`: the kernel as the package builds it;
- `no_store`: the transform without its output stores;
- `no_fft`: staging and stores without the transform (wrong output);
- `plain_store`: ordinary stores instead of streaming ones;
- `tile16`: 16-frame tiles (half the staging buffers);
- `waves1`, `waves8`: shorter and longer runs of tiles a block.

Needs a GPU and nvcc. Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from bliss_tpu_torch.ops import _build  # noqa: E402
from bliss_tpu_torch.ops import dft_kernels as DK  # noqa: E402

VARIANTS = {
    "base": [],
    "no_store": ["-DBLISS_FRAME_FFT_PROBE=1"],
    "no_fft": ["-DBLISS_FRAME_FFT_PROBE=2"],
    "plain_store": ["-DBLISS_FRAME_FFT_PROBE=3"],
    "tile16": ["-DBLISS_FRAME_FFT_TILE=16"],
    "waves1": ["-DBLISS_FRAME_FFT_WAVES=1"],
    "waves8": ["-DBLISS_FRAME_FFT_WAVES=8"],
}
SHAPES = [(8, 10_506_554, 256, 2048 - 10_397, 40_967), (8, 7_340_032, 128, 384, 57_341)]


def build_variants() -> dict:
    out_dir = _build.BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in VARIANTS.items():
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-o",
               str(out_dir / f"lib{name}.so"), str(_build.CSRC / "frame_dft.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
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
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    libs = build_variants()
    dev = torch.device("cuda", 0)
    win, tw = DK._constants(512, "cuda:0")
    rng = np.random.default_rng(0)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for batch, t, hop, offset, n_frames in SHAPES:
        x = torch.as_tensor((rng.normal(size=(batch, t)) * 0.1).astype(np.float32), device=dev)
        out = torch.empty((batch, n_frames, 257), device=dev)

        def run(lib):
            fn = lib.frame_dft_mags_launch
            fn.argtypes, fn.restype = [p, i, ll, i, i, i, p, p, p, p, p], i
            _build.check("variant", fn(
                _build.ptr(x), batch, t, n_frames, hop, offset, _build.ptr(win),
                _build.ptr(tw[0]), _build.ptr(tw[1]), _build.ptr(out), _build.stream_ptr(dev)))

        for rnd in range(2):
            for name, lib in libs.items():
                print(f"[{batch}, {t}] hop {hop} round {rnd} {name}: "
                      f"{time_ms(lambda: run(lib)):.4f} ms", flush=True)
        print(f"[{batch}, {t}] hop {hop} copies of the same bytes: fill of the output "
              f"{time_ms(lambda: out.fill_(1.0)):.4f} ms, clone of the input "
              f"{time_ms(lambda: x.clone()):.4f} ms", flush=True)
        del x, out


if __name__ == "__main__":
    main()
