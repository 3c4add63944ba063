"""Build the native libav decoder and encoder of `io/native/`.

`native/bliss_decode.cpp` (the decoder's C ABI) and
`native/bliss_encode.cpp` (the fixture encoder) are compiled on first use
with g++ and the system's libav libraries, with the flags of
`native/Makefile`, into `bliss_tpu_torch/build/`, each named by a hash of
its source and flags. A compile writes a name of its own process and is
then renamed into place, so processes that build at once (test workers,
the recycled ingest's workers, the command-line examples) never load a
half-written file; a lock keeps the threads of one process to one compile.
A failed build raises `DecodingError`, naming the libav libraries that
pkg-config cannot find, or the compiler's first error line.

    python -m bliss_tpu_torch.io._native   # builds both, prints the probe
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

from ..errors import DecodingError
from ..ops._build import _tmp

NATIVE = pathlib.Path(__file__).resolve().parent / "native"
BUILD = NATIVE.parents[1] / "build"

#: native/Makefile's CXXFLAGS and LDLIBS.
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
LDLIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"]
#: The Makefile's recipes: the shared decoder and the encoder executable.
DECODER_FLAGS = [*CXXFLAGS, "-shared"]
ENCODER_FLAGS = ["-O2", "-std=c++17", "-Wall"]
#: The pkg-config names of the libraries LDLIBS links.
LIBAV = ("libavformat", "libavcodec", "libavutil", "libswresample")

_lock = threading.Lock()
_built: dict[str, pathlib.Path] = {}
_failed: dict[str, DecodingError] = {}


def _target(stem: str, source: pathlib.Path, flags: list, suffix: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(flags + LDLIBS).encode())
    h.update(source.read_bytes())
    return BUILD / f"{stem}-{h.hexdigest()[:12]}{suffix}"


def libav_versions() -> dict:
    """pkg-config's version of each libav library, None where it finds
    none (all None without pkg-config)."""
    pkg = shutil.which("pkg-config")
    out = {}
    for lib in LIBAV:
        proc = (subprocess.run([pkg, "--modversion", lib], capture_output=True, text=True)
                if pkg else None)
        out[lib] = proc.stdout.strip() if proc is not None and proc.returncode == 0 else None
    return out


def _failure(what: str, log: str) -> DecodingError:
    missing = [lib for lib, v in libav_versions().items() if v is None]
    first = next((line.strip() for line in log.splitlines() if "error" in line.lower()),
                 log.strip().splitlines()[0] if log.strip() else "no output")
    if missing:
        return DecodingError(f"cannot build the native {what}: libav missing "
                             f"({', '.join(missing)}): {first}")
    return DecodingError(f"cannot build the native {what}: {first}")


def _build(what: str, stem: str, source: str, flags: list, suffix: str) -> pathlib.Path:
    with _lock:
        if stem in _built:
            return _built[stem]
        if stem in _failed:
            raise _failed[stem]
        src = NATIVE / source
        out = _target(stem, src, flags, suffix)
        if not out.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                _failed[stem] = DecodingError(f"cannot build the native {what}: g++ not found")
                raise _failed[stem]
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = _tmp(out)
            proc = subprocess.run([cxx, *flags, "-o", tmp, str(src), *LDLIBS],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                pathlib.Path(tmp).unlink(missing_ok=True)
                _failed[stem] = _failure(what, proc.stderr + proc.stdout)
                raise _failed[stem]
            os.replace(tmp, out)
        _built[stem] = out
        return out


def decoder_library() -> pathlib.Path:
    """The path of the built `libbliss_decode` (built on first call)."""
    return _build("decoder", "libbliss_decode", "bliss_decode.cpp", DECODER_FLAGS, ".so")


def encoder() -> pathlib.Path:
    """The path of the built `bliss_encode` executable (built on first
    call): `bliss_encode IN.f32le OUT RATE CHANNELS CODEC [BITRATE]`."""
    return _build("encoder", "bliss_encode", "bliss_encode.cpp", ENCODER_FLAGS, "")


def probe() -> dict:
    """What the native build needs and whether it built: each libav
    library's version, the path of g++, each build's path or error, and
    `ok`, whether the decoder built and loads."""
    from .decoder import _load_lib

    out = {"libav": libav_versions(), "g++": shutil.which("g++"), "ok": False}
    for name, build in (("decoder", decoder_library), ("encoder", encoder)):
        try:
            out[name] = str(build().relative_to(BUILD.parent.parent))
        except DecodingError as e:
            out[name] = f"not built: {e.args[0]}"
    if not out["decoder"].startswith("not built"):
        try:
            _load_lib()
            out["ok"] = True
        except DecodingError as e:
            out["decoder"] += f" (not loadable: {e.args[0]})"
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(probe()))
