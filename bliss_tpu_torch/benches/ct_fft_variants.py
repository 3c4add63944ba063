#!/usr/bin/env python3
"""Which part of the 8192-point body of `csrc/ct_stft.cu` holds its time.

    python3 bliss_tpu_torch/benches/ct_fft_variants.py [--rounds 2]

Builds `csrc/ct_stft.cu` once per setting of its compile-time switches
(`BLISS_CT_FFT_DESIGN`, `BLISS_CT_FFT_PROBE`; one nvcc each, in parallel,
with `-Xptxas -v`, into the ignored build directory), prints each build's
registers and spills, holds every variant that computes the function
against the plain version (1e-5 of each frame's max), and times each in
turns at the path's shapes: `ct_stft_mags` at 8 x 5-min (`[8, 7,348,224]`,
hop 2205, 3,329 frames a song) and `ct_frames_mags` at one shard of the
60-minute song (`[4,757, 8192]`) and at the framed route's `[26,632, 8192]`,
beside PyTorch's copy of the same bytes and the library call:

- `base`: the kernel as the package builds it (16 x 16 x 16 block FFT);
- `no_store`: the transform without its output stores;
- `no_fft`: staging and stores without the transform (wrong output);
- `no_load`: the transform and stores without loads (wrong output);
- `design_a`: 256 x 16, the warp FFT core of `frame_dft_mags` on each
  stride-16 subsequence, then radix 16 across warps (the design not kept;
  its loads are not overlapped with the transform);
- `radix2`: the block-wide radix-2 body of the first design at 8192 too.

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

VARIANTS = {
    "base": [],
    "no_store": ["-DBLISS_CT_FFT_PROBE=1"],
    "no_fft": ["-DBLISS_CT_FFT_PROBE=2"],
    "no_load": ["-DBLISS_CT_FFT_PROBE=3"],
    "design_a": ["-DBLISS_CT_FFT_DESIGN=1"],
    "radix2": ["-DBLISS_CT_FFT_DESIGN=2"],
}
#: variants whose output is the function (the others are probes)
COMPUTES = ("base", "design_a", "radix2")
W, HOP = 8192, 2205


def build_variants() -> dict:
    out_dir = _build.BUILD / "ct_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in VARIANTS.items():
        cmd = [_build.nvcc(), "-Xptxas", "-v", *_build.NVCC_FLAGS, *defines, "-o",
               str(out_dir / f"lib{name}.so"), str(_build.CSRC / "ct_stft.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
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


def frame_rel(got, want, dim) -> float:
    """Largest error of a frame over that frame's largest magnitude."""
    return ((got - want).abs().amax(dim) / want.amax(dim).clamp(min=1e-30)).max().item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    libs = build_variants()
    dev = torch.device("cuda", 0)
    win, tw = DK._constants(W, "cuda:0")
    hann = torch.hann_window(W, periodic=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    # ct_stft at 8 x 5-min
    batch, t_len, n_frames = 8, 7_348_224, 3329
    padded = torch.randn((batch, t_len), generator=gen, device=dev) * 0.1
    out = torch.empty((batch, n_frames, W // 2 + 1), device=dev)
    used = padded[:, : (n_frames - 1) * HOP + W]

    def run_stft(lib):
        fn = lib.ct_stft_launch
        fn.argtypes, fn.restype = [p, i, ll, i, i, i, p, p, p, p, p], i
        _build.check("variant", fn(
            _build.ptr(padded), batch, t_len, n_frames, HOP, 13, _build.ptr(win),
            _build.ptr(tw[0]), _build.ptr(tw[1]), _build.ptr(out), _build.stream_ptr(dev)))

    want = DK.ct_stft_mags_plain(padded, W, HOP, n_frames).transpose(1, 2)
    label = f"ct_stft [{batch}, {t_len}] hop {HOP}, {batch * n_frames} frames"
    for name in COMPUTES:
        run_stft(libs[name])
        torch.cuda.synchronize()
        print(f"{label} {name}: {frame_rel(out, want, -1):.3g} of each frame's max vs plain",
              flush=True)
    del want
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            print(f"{label} round {rnd} {name}: {time_ms(lambda: run_stft(lib)):.4f} ms", flush=True)
    print(f"{label}: torch.stft + abs "
          f"{time_ms(lambda: torch.stft(used, W, HOP, window=hann, center=False, return_complex=True).abs(), 5):.4f} ms, "
          f"copies of the same bytes: clone of the padded signal "
          f"{time_ms(lambda: padded.clone()):.4f} ms, fill of the output "
          f"{time_ms(lambda: out.fill_(1.0)):.4f} ms", flush=True)
    del padded, out, used
    torch.cuda.empty_cache()

    # ct_frames at one shard of the 60-minute song and at the framed route
    for n in (4757, 26_632):
        frames = torch.randn((n, W), generator=gen, device=dev) * 0.1
        out = torch.empty((n, W // 2 + 1), device=dev)

        def run_frames(lib):
            fn = lib.ct_frames_launch
            fn.argtypes, fn.restype = [p, i, i, p, p, p, p, p], i
            _build.check("variant", fn(
                _build.ptr(frames), n, 13, _build.ptr(win), _build.ptr(tw[0]),
                _build.ptr(tw[1]), _build.ptr(out), _build.stream_ptr(dev)))

        want = DK.ct_frames_mags_plain(frames).transpose(0, 1)
        label = f"ct_frames [{n}, {W}]"
        for name in COMPUTES:
            run_frames(libs[name])
            torch.cuda.synchronize()
            print(f"{label} {name}: {frame_rel(out, want, -1):.3g} of each frame's max vs plain",
                  flush=True)
        del want
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                print(f"{label} round {rnd} {name}: {time_ms(lambda: run_frames(lib)):.4f} ms",
                      flush=True)
        print(f"{label}: torch.fft.rfft + abs "
              f"{time_ms(lambda: torch.fft.rfft(frames * hann).abs(), 5):.4f} ms, copies of the "
              f"same bytes: clone of the frames {time_ms(lambda: frames.clone()):.4f} ms, fill of "
              f"the output {time_ms(lambda: out.fill_(1.0)):.4f} ms", flush=True)
        del frames, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
