"""Build and load the hand-written CUDA kernels of `bliss_tpu_torch/csrc`.

Each `csrc/<name>.cu` is compiled on first use by its own `nvcc` call
into `bliss_tpu_torch/build/lib<name>-<hash>.so` (a plain C interface,
no PyTorch headers, so a build takes seconds) and loaded with `ctypes`.
`build_all()` starts every compiler at once. A failed build raises.

Every kernel wrapper launches through `launch`, which makes the tensors'
device the current one around the call (the `<<<>>>` launch and the
entries' attribute calls act on the calling thread's current device) and
counts the launch, by kernel and by device, so a caller can reset the
counts, drive the analysis and see which kernels ran where. A launch made
while a CUDA graph is captured runs only when the graph replays: inside
`counting_capture` it is counted into the capture's own dict, which
`add_launches` adds to the counts at each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

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
#: The same counts by (kernel, device), e.g. ("ct_stft", "cuda:0").
LAUNCHES_ON: dict[tuple[str, str], int] = {}

_loaded: dict[str, ctypes.CDLL] = {}

#: This thread's capture counts (`counting_capture`), else None.
_capture = threading.local()


def count_launch(name: str, device) -> None:
    counts = getattr(_capture, "counts", None)
    key = (name, str(device))
    if counts is not None:
        counts[key] = counts.get(key, 0) + 1
        return
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    LAUNCHES_ON[key] = LAUNCHES_ON.get(key, 0) + 1


@contextlib.contextmanager
def counting_capture():
    """Count this thread's launches in the block into the dict it yields,
    by (kernel, device), and not into `LAUNCHES`: the block is a CUDA
    graph's capture, whose launches run at each replay."""
    prev, _capture.counts = getattr(_capture, "counts", None), {}
    try:
        yield _capture.counts
    finally:
        _capture.counts = prev


def add_launches(counts: dict) -> None:
    """Count the launches of one replay of a graph whose capture counted
    `counts`."""
    for (name, device), n in counts.items():
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n
        LAUNCHES_ON[(name, device)] = LAUNCHES_ON.get((name, device), 0) + n


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES_ON.clear()


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


def launch(name: str, fn, device, *args) -> None:
    """Call C entry point `fn` (from `function`) with `args` and, last, the
    current stream of `device`, with `device` made the calling thread's
    current device around the call; raise on a CUDA error and count one
    launch of `name` on `device`."""
    import torch

    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = fn(*args, stream)
    check(name, err)
    count_launch(name, device)


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
