"""Build and load the hand-written CUDA kernels of `bliss_tpu_torch/csrc`.

Each `csrc/<name>.cu` is compiled on first use by its own `nvcc` call
into `bliss_tpu_torch/build/lib<name>-<hash>.so` (a plain C interface,
no PyTorch headers, so a build takes seconds) and loaded with `ctypes`.
`build_all()` starts every compiler at once. A failed build raises.

Launch counts live here too: every kernel wrapper calls
`count_launch(name)` right where it launches its kernel, so a caller can
reset the counts, drive the analysis and see which kernels ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

PACKAGE = pathlib.Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"

#: The card's target: Hopper with its architecture-specific features.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

#: Every kernel source, `csrc/<name>.cu`.
SOURCES = (
    "timbral_flat", "timbral_fft", "specflux", "ct_stft", "frame_dft", "tuning", "beat_track",
    "autocorr",
)

LAUNCHES: dict[str, int] = {}

_loaded: dict[str, ctypes.CDLL] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _tmp(out: pathlib.Path) -> str:
    # per process: two processes building the same library never share a file
    return f"{out}.{os.getpid()}.tmp"


def _start(name: str, verbose: bool):
    out = _target(name)
    if out.exists():
        return out, None
    BUILD.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", _tmp(out), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, proc


def _finish(name: str, out: pathlib.Path, proc) -> str:
    log = ""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(_tmp(out), out)
    _loaded[name] = ctypes.CDLL(str(out))
    return log


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel source in parallel (one `nvcc` each) and load
    the libraries. Returns each compiler's output."""
    started = {n: _start(n, verbose) for n in SOURCES if n not in _loaded}
    return {n: _finish(n, *started[n]) for n in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    if name not in _loaded:
        _finish(name, *_start(name, False))
    return _loaded[name]


def function(lib: str, name: str, argtypes: list):
    """C entry point `name` of `csrc/<lib>.cu` with its ctypes signature
    (pointers and the stream as `c_void_p`, so none is cut to 32 bits)."""
    fn = getattr(load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def on_cuda(t) -> bool:
    """Whether a wrapper launches its kernel for tensor `t` (CUDA) or runs
    its plain version (CPU); any other device is refused."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def require(name: str, t, dtype, ndim: int, device) -> None:
    """Check what a kernel takes: device, dtype, rank, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
