"""Long-run soak of the ingest path (counterpart of benches/soak.py).

    python -m bliss_tpu_torch.benches.soak [--phase gen|run|kill-resume|all]
        [--n 1000] [--unique U] [--durations 150 280] [--device cuda]
        [--recycle N] [--dir DIR] [--rss-cap-mb 8192] [--period 5]
        [--decoder native|fallback]

`gen` synthesizes `--n` full-length mono 22.05 kHz WAV songs (tiled noise
beds, gated tones, a beat; 150-280 s each from seed 42), plus a missing, a
corrupt and a too-short input, under `--dir` (default tmp/soak). With
`--unique U` only the first U songs are synthesized and the rest are hard
links to them: every path is still analyzed on its own.

`run` drives `Library.update_library` over all of them on `--device` (with
`--recycle N`, `update_library_recycled` in N-song worker processes),
decoding with the native decoder (`--decoder fallback`: `FallbackDecoder`,
for a host without libav), while
a thread samples, every `--period` seconds, the resident memory of this
process and of every process whose parent chain leads to it (from /proc).
It checks that every input lands in the song table or the failed-song
ledger, the three bad ones on the ledger and no good one (a fault there
raises), then whether a process's peak RSS passed `--rss-cap-mb` (a sum
over processes would count the shared libraries once a process). It prints
one JSON line: sustained songs/s, the peak RSS (the sum over the
processes, this process, each worker), this process's RSS slope over the
run's last three quarters, the counts, and `ok`; a breach of the cap exits
1 after the line.

`kill-resume` starts `run` in a child process that SIGKILLs itself right
after its K-th stored song (K = n / 8), then resumes in this process with
`update_library` over the same inputs, which must analyze exactly the set
difference (the inputs not analyzed when the child died) and end with full
coverage; it prints one JSON line. `all` runs the three and prints one
line with the resume's numbers under "resume".
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import signal
import sqlite3
import subprocess
import sys
import time
import wave

import numpy as np

from . import DECODERS, bench_decoder, card, emit

REPO = pathlib.Path(__file__).resolve().parents[2]
SAMPLE_RATE = 22050


def song_paths(folder: pathlib.Path, n: int) -> list:
    return [folder / f"songs/{i // 100:02d}/song_{i:04d}.wav" for i in range(n)]


def bad_paths(folder: pathlib.Path) -> dict:
    return {
        "missing": folder / "songs/bad_missing.wav",
        "corrupt": folder / "songs/bad_corrupt.wav",
        "short": folder / "songs/bad_short.wav",
    }


def all_inputs(folder: pathlib.Path, n: int) -> list:
    return [str(p) for p in song_paths(folder, n)] + [str(p) for p in bad_paths(folder).values()]


def _write(path: pathlib.Path, pcm) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def phase_gen(args) -> None:
    """The library (benches/soak.py:phase_gen's synthesis): per song a
    tiled noise bed, three gated tones and a beat, with a fade-in."""
    rng = np.random.default_rng(42)
    paths = song_paths(args.dir, args.n)
    unique = args.unique or args.n
    lo, hi = args.durations
    t0 = time.time()
    made = 0
    for i, p in enumerate(paths):
        p.parent.mkdir(parents=True, exist_ok=True)
        if i >= unique:
            if not p.exists():
                os.link(paths[i % unique], p)
            continue
        dur = int(rng.integers(lo, hi + 1))
        n = dur * SAMPLE_RATE
        base = (rng.normal(size=SAMPLE_RATE) * 0.05).astype(np.float32)
        f0 = 110.0 * 2.0 ** float(rng.uniform(0, 3))
        bpm = float(rng.uniform(70, 180))
        if p.exists():
            continue
        sig = np.tile(base, n // SAMPLE_RATE + 1)[:n]
        tt = np.arange(n, dtype=np.float32) / SAMPLE_RATE
        for mult, amp in ((1.0, 0.25), (1.5, 0.12), (2.0, 0.08)):
            sig += amp * np.sin(2 * np.pi * f0 * mult * tt).astype(np.float32)
        beat = ((tt * bpm / 60.0) % 1.0 < 0.12).astype(np.float32)
        sig *= 0.35 + 0.65 * beat
        sig[: n // 50] *= np.linspace(0, 1, n // 50, dtype=np.float32)
        _write(p, np.clip(sig * 20000.0, -32768, 32767).astype("<i2"))
        made += 1
    bad = bad_paths(args.dir)
    bad["corrupt"].write_bytes(b"RIFFgarbage not a wav" * 64)
    _write(bad["short"], np.zeros(2000, "<i2"))
    bad["missing"].unlink(missing_ok=True)
    print(f"gen: {made} new songs ({unique} unique of {args.n}) in {time.time() - t0:.1f} s, "
          f"dir={args.dir}", file=sys.stderr, flush=True)


def open_library(args, fresh: bool):
    from ..library import BaseConfig, Library

    decoder = bench_decoder(args.decoder)
    db, cfg = args.dir / "soak.db", args.dir / "soak_config.json"
    if fresh:
        for f in (db, cfg):
            f.unlink(missing_ok=True)
    return Library(BaseConfig(config_path=cfg, database_path=db), decoder,
                   device=args.device)


def coverage(lib, inputs, bad) -> tuple:
    """(analyzed count, failed paths); raises if an input is in neither
    table, a bad input is not on the ledger, or a good one is."""
    conn = lib.sqlite_conn
    ok = {r[0] for r in conn.execute("select path from song where analyzed = true")}
    failed = {str(e.song_path) for e in lib.get_failed_songs()}
    missing = [p for p in inputs if p not in ok and p not in failed]
    if missing:
        raise AssertionError(f"{len(missing)} inputs in neither table: {missing[:4]}")
    for name, p in bad.items():
        if str(p) not in failed:
            raise AssertionError(f"the {name} input is not on the failed ledger: {p}")
    good_failed = sorted((set(inputs) - {str(p) for p in bad.values()}) & failed)
    if good_failed:
        raise AssertionError(f"good inputs on the failed ledger: {good_failed[:4]}")
    return len(ok), failed


def phase_run(args) -> dict:
    from ..utils.profiling import RssSampler

    inputs = all_inputs(args.dir, args.n)
    lib = open_library(args, fresh=not args.resume)
    if args.kill_after:
        store, stored = lib.store_song, [0]

        def store_then_die(song):
            store(song)
            stored[0] += 1
            if stored[0] >= args.kill_after:
                os.kill(os.getpid(), signal.SIGKILL)

        lib.store_song = store_then_die
    with RssSampler(args.period) as rss:
        t0 = time.time()
        if args.recycle:
            lib.update_library_recycled(inputs, False, False, segment_songs=args.recycle)
        else:
            lib.update_library(inputs, False, False)
        elapsed = time.time() - t0
    n_ok, failed = coverage(lib, inputs, bad_paths(args.dir))
    largest = max(rss.root_peak_mb, rss.child_peak_mb)
    failures = [f"a process's peak RSS {largest:.0f} MB over the {args.rss_cap_mb:g} MB cap"
                ] if largest >= args.rss_cap_mb else []
    return {
        "metric": "soak_songs_per_sec",
        "value": n_ok / elapsed,
        "unit": f"songs/s sustained over {elapsed:.0f} s (N={n_ok})",
        "elapsed_s": elapsed,
        "analyzed": n_ok,
        "failed": len(failed),
        "inputs": len(inputs),
        "unique_songs": args.unique or args.n,
        "peak_rss_mb": rss.peak_mb,
        "parent_peak_rss_mb": rss.root_peak_mb,
        "worker_peak_rss_mb": rss.child_peak_mb,
        "worker_peaks_rss_mb": list(rss.child_peaks.values()),
        "rss_slope_mb_per_min": rss.slope_mb_per_min(),
        "rss_first_mb": rss.samples[0][2],
        "rss_last_mb": rss.samples[-1][2],
        "rss_samples": len(rss.samples),
        "rss_cap_mb": args.rss_cap_mb,
        "recycle_segment_songs": args.recycle,
        "decoder": lib.decoder_cls.__name__,
        "ok": not failures,
        "failures": failures,
        "device": args.device,
        "card": card(args.device),
    }


def phase_kill_resume(args) -> dict:
    """A run killed after its K-th stored song, then resumed here."""
    db = args.dir / "soak.db"
    for f in (db, args.dir / "soak_config.json"):
        f.unlink(missing_ok=True)
    kill_after = min(max(1, args.n // 8), max(1, args.n - 1))
    cmd = [sys.executable, "-m", "bliss_tpu_torch.benches.soak", "--phase", "run",
           "--n", str(args.n), "--dir", str(args.dir), "--device", args.device, "--resume",
           "--kill-after", str(kill_after), "--decoder", args.decoder]
    child = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=3600)
    if child.returncode != -signal.SIGKILL:
        raise AssertionError(f"the run was not killed (rc={child.returncode}):\n"
                             f"{child.stderr[-2000:]}")
    with sqlite3.connect(f"file:{db}?mode=ro", uri=True) as conn:
        done = conn.execute("select count(*) from song where analyzed = true").fetchone()[0]
    counts = []

    class Counter(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("Analyzing") and "song(s)" in msg:
                counts.append(int(msg.split()[1]))

    log = logging.getLogger("bliss_tpu_torch")
    handler = Counter()
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)  # the "Analyzing N song(s)" line
    try:
        lib = open_library(args, fresh=False)
        inputs = all_inputs(args.dir, args.n)
        t0 = time.time()
        lib.update_library(inputs, False, False)
        elapsed = time.time() - t0
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    n_ok, _ = coverage(lib, inputs, bad_paths(args.dir))
    expected = len(inputs) - done
    if n_ok != args.n or counts[:1] != [expected]:
        raise AssertionError(f"resume analyzed {counts[:1]} of {expected} expected, "
                             f"{n_ok} of {args.n} stored")
    return {
        "metric": "soak_resume",
        "killed_at": done,
        "resume_analyzed": counts[0],
        "expected": expected,
        "resume_elapsed_s": elapsed,
        "total_in_db": n_ok,
        "device": args.device,
        "card": card(args.device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.benches.soak")
    ap.add_argument("--phase", default="all", choices=["gen", "run", "kill-resume", "all"])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--unique", type=int, default=None,
                    help="synthesize this many songs; the other paths link to them")
    ap.add_argument("--durations", type=int, nargs=2, default=(150, 280), metavar=("LO", "HI"),
                    help="song lengths in seconds, drawn uniformly")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dir", type=pathlib.Path, default=REPO / "tmp" / "soak")
    ap.add_argument("--rss-cap-mb", type=float, default=8192.0)
    ap.add_argument("--period", type=float, default=5.0, help="seconds between RSS samples")
    ap.add_argument("--recycle", type=int, default=0, metavar="N",
                    help="run through Library.update_library_recycled in N-song segments")
    ap.add_argument("--resume", action="store_true",
                    help="keep the existing soak store (used by kill-resume)")
    ap.add_argument("--kill-after", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--decoder", choices=DECODERS, default="native")
    args = ap.parse_args(argv)
    args.dir = args.dir.resolve()

    out = None
    if args.phase in ("gen", "all"):
        phase_gen(args)
    if args.phase in ("run", "all"):
        out = phase_run(args)
    if args.phase in ("kill-resume", "all"):
        resume = phase_kill_resume(args)
        out = resume if out is None else {**out, "resume": resume}
    if out is not None:
        emit(out)
        if not out.get("ok", True):
            sys.exit(1)


if __name__ == "__main__":
    main()
