"""Segment worker for `Library.update_library_recycled` (counterpart of
bliss_tpu/io/ingest_worker.py).

Analyzes ONE segment of paths into an existing library database on the
devices it is given, then exits, so every byte the process held goes
back to the system. Invoked as:

    python -m bliss_tpu_torch.io.ingest_worker CONFIG_PATH LIST_PATH \\
        --devices cuda:0[,cuda:1] [--decoder module:ClassName] [--progress] \\
        [--gate PATH] [--cwd DIR] [--log-level LEVEL]

LIST_PATH is a newline-separated file of song paths (one segment). The
worker runs the ordinary incremental `update_library` on it with
``delete_everything_else=False`` (the parent owns deletions), so a retried
segment re-analyzes only what its first attempt did not land
(set-difference, reference src/library.rs:1000-1093).

`--devices` is the parent's `Library.devices`: a worker told to use a card
on a host without one exits non-zero with `resolve_device`'s error and
stores nothing; it never analyzes on the CPU instead. With `--gate` the
worker does its start-up first (imports, opening the store, a CUDA context
on each of its cards, loading the kernels), launches nothing, and waits
until the gate file exists. `--cwd` is the folder relative song paths are
read from (the parent's working folder). On exit it logs one debug line,
`ingest worker report {...}`: its start-up seconds, the part of them that
ran before the gate opened, the segment's seconds, its peak RSS and its
kernel launches by (kernel, device).
"""

import argparse
import importlib
import json
import logging
import os
import pathlib
import resource
import sys
import time

#: Seconds a gated worker waits for its gate before giving up.
GATE_TIMEOUT_S = 7200.0

logger = logging.getLogger("bliss_tpu_torch")


def _resolve_decoder(spec: str):
    mod_name, _, cls_name = spec.partition(":")
    return getattr(importlib.import_module(mod_name), cls_name)


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.io.ingest_worker")
    ap.add_argument("config_path")
    ap.add_argument("list_path")
    ap.add_argument("--devices", required=True,
                    help="comma-separated devices, e.g. cuda:0,cuda:1 or cpu")
    ap.add_argument("--decoder", default=None, help="module:ClassName of the decoder")
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--gate", default=None,
                    help="start up, then wait for this file before analyzing")
    ap.add_argument("--cwd", default=None, help="folder relative song paths are read from")
    ap.add_argument("--log-level", default="WARNING")
    return ap.parse_args(argv)


def _start_devices(devices) -> None:
    """A CUDA context on each card and the kernels loaded: everything a
    card's first launch would otherwise pay for, with no launch."""
    import torch

    from ..ops import _build

    cards = [d for d in devices if d.type == "cuda"]
    if not cards:
        return
    torch.cuda.init()
    for d in cards:
        torch.empty(0, device=d)
    _build.build_all()


def _launch_counts() -> dict:
    from ..ops import _build

    return {f"{k}@{d}": n for (k, d), n in sorted(_build.LAUNCHES_ON.items())}


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.cwd:
        os.chdir(args.cwd)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(args.log_level)

    from ..library import Library
    from ..models.analyzer import resolve_devices
    from ..utils.profiling import process_age_s

    decoder_cls = _resolve_decoder(args.decoder) if args.decoder else None
    try:
        devices = resolve_devices(args.devices.split(","))
    except (RuntimeError, ValueError) as e:
        print(f"ingest worker: {e}", file=sys.stderr)
        return 2
    lib = Library.from_config_path(args.config_path, decoder_cls, devices=devices)
    paths = [line for line in pathlib.Path(args.list_path).read_text().splitlines() if line]
    _start_devices(devices)
    ready_s = process_age_s()
    started = time.time() - ready_s
    gate_wait_s = hidden_s = 0.0
    if args.gate is not None:
        deadline = time.time() + GATE_TIMEOUT_S
        while not os.path.exists(args.gate):
            if time.time() > deadline:
                print("ingest worker: gate never opened", file=sys.stderr)
                return 3
            time.sleep(0.05)
        gate_wait_s = process_age_s() - ready_s
        # the start-up that ran before the gate opened, beside the segment
        # before this one
        hidden_s = min(ready_s, max(0.0, os.stat(args.gate).st_mtime - started))
    t0 = time.perf_counter()
    lib.update_library(paths, False, args.progress)
    segment_s = time.perf_counter() - t0
    report = {
        "pid": os.getpid(),
        "paths": len(paths),
        "devices": [str(d) for d in devices],
        "ready_s": ready_s,
        "gate_wait_s": gate_wait_s,
        "hidden_s": hidden_s,
        "segment_s": segment_s,
        # ru_maxrss is in KiB on Linux
        "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "launches": _launch_counts(),
    }
    logger.debug("ingest worker report %s", json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
