"""The accuracy audit over the drift corpus: the card's f32 vectors against
the port's CPU f64 path, Version2 and Version1 (counterpart of
benches/tpu_drift.py).

    python -m bliss_tpu_torch.benches.drift [--device cuda] [--dtype float32]
        [--paths FILE ...] [--decoder native|fallback]

Every file is decoded once, by the native decoder (`--decoder fallback`:
by `FallbackDecoder`, for a host without libav); the same decoded
samples go through `io.batch.analyze_paths_batched` on `--device` at
`--dtype` and on the CPU at f64, in this one process. V2 runs over
`CORPUS` (every decodable fixture: the chroma dyads and triads, the
boundary tones and silences, the resampled MP3/AAC/Vorbis set, the
21-minute medley and the CUE album), V1 over `V1_SUBSET`; `--paths`
puts those files in place of both sets.

The contract: at most 1e-4 per feature on real content; on the pure-tone
and dyad synthetics (`DEGENERATE`), whose true spectra sit below the f32
DFT's noise floor, at most 2e-2 and the same dominant chroma feature; a
file fails on both routes or on neither. Prints a line a file, the
per-feature drift histogram of the real content, then one JSON line with
the verdict; exits 1 on a breach. `--device cpu --dtype float32` runs the
same audit on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from . import DECODERS, bench_decoder, card, decode_once, emit

REPO = pathlib.Path(__file__).resolve().parents[2]
DATA = REPO / "tests" / "data"

#: benches/tpu_drift.py:CORPUS.
CORPUS = sorted(
    [
        p
        for p in list(DATA.glob("*.flac"))
        + list(DATA.glob("*.mp3"))
        + list(DATA.glob("*.ogg"))
        + list(DATA.glob("*.wav"))
        + list((DATA / "chroma").glob("*.ogg"))
        + list((DATA / "drift").iterdir())
        if p.name not in ("empty.wav",)
    ]
) + [DATA / "testcue.cue"]

#: benches/tpu_drift.py:V1_SUBSET: old and new content, every codec family
#: (reference src/chroma.rs:128-132, Version1 golden src/song/mod.rs:595-633).
V1_SUBSET = sorted(
    [
        DATA / "s16_mono_22_5kHz.flac",
        DATA / "piano.flac",
        DATA / "white_noise.mp3",
        DATA / "drift" / "band_mp3_192k.mp3",
        DATA / "drift" / "perc_vorbis_64k.ogg",
        DATA / "drift" / "vox_aac_64k.m4a",
        DATA / "drift" / "band_quiet_-42dB.flac",
        DATA / "drift" / "perc48_mp3_128k.mp3",
    ]
)

#: The pure-tone and dyad synthetics (tests/test_tpu_drift.py:_degenerate).
DEGENERATE = {
    str(p)
    for p in sorted((DATA / "chroma").glob("*.ogg"))
    + [DATA / "tone_11080Hz.flac", DATA / "capacity_fix.ogg", DATA / "silence.ogg"]
}

REAL_LIMIT = 1e-4
DEGENERATE_LIMIT = 2e-2
HISTOGRAM_EDGES = [0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1]


def analyze(decoder, paths, version: int, device, dtype) -> dict:
    """Each song's vector (None for a failure) by its path (a CUE track by
    its track path)."""
    from ..io.batch import analyze_paths_batched
    from ..song import AnalysisOptions, Song

    out = {}
    options = AnalysisOptions(features_version=version)
    for path, r in analyze_paths_batched(decoder, paths, options, device=device, dtype=dtype):
        if isinstance(r, Song):
            out[str(r.path)] = np.asarray(r.analysis.as_arr1(), np.float64)
        else:
            out.setdefault(str(path), None)
    return out


def compare(got: dict, ref: dict) -> tuple:
    """(per-file rows, real-content errors, failures) of one version."""
    rows, real, failures = [], [], []
    for key in sorted(set(got) | set(ref)):
        g, r = got.get(key), ref.get(key)
        if g is None or r is None:
            if (g is None) != (r is None):
                failures.append(f"{key}: fails on one route only")
            rows.append({"path": key, "max": None, "kind": "failed on both"})
            continue
        err = np.abs(g - r)
        degenerate = key in DEGENERATE
        limit = DEGENERATE_LIMIT if degenerate else REAL_LIMIT
        if degenerate and int(np.argmax(g[10:20])) != int(np.argmax(r[10:20])):
            failures.append(f"{key}: dominant chroma differs")
        if err.max() > limit:
            failures.append(f"{key}: feature {int(err.argmax())} drift {err.max():.3g} > {limit:g}")
        if not degenerate:
            real.append(err)
        rows.append({"path": key, "max": float(err.max()), "feature": int(err.argmax()),
                     "kind": "degenerate" if degenerate else "real"})
    return rows, real, failures


def audit(v2_paths=CORPUS, v1_paths=V1_SUBSET, device="cuda", dtype=None, log=print,
          decoded=None, decoder=None) -> dict:
    """Both versions' audit; the result dict of the JSON line. `decoded`
    (decoded songs by path) spares decoding those files again; `decoder`
    decodes the others (default: the native decoder)."""
    import torch

    from ..models.analyzer import _resolve_dtype, resolve_device

    device = resolve_device(device)
    dtype = _resolve_dtype(device, getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    base = decoder or bench_decoder()
    decoder, decode_s = decode_once(list(v2_paths) + list(v1_paths), decoded, base)
    result = {"metric": "drift_max_real", "device": str(device), "dtype": str(dtype).split(".")[-1],
              "reference": "cpu float64", "decoder": base.__name__, "card": card(device),
              "decode_s": sum(decode_s.values())}
    failures, worst = [], 0.0
    for name, version, paths in (("v2", 2, v2_paths), ("v1", 1, v1_paths)):
        if not paths:
            continue
        got = analyze(decoder, paths, version, device, dtype)
        ref = analyze(decoder, paths, version, "cpu", torch.float64)
        rows, real, bad = compare(got, ref)
        failures += [f"{name} {b}" for b in bad]
        errs = np.concatenate(real) if real else np.zeros(1)
        hist, _ = np.histogram(errs, bins=HISTOGRAM_EDGES)
        deg = [r["max"] for r in rows if r["kind"] == "degenerate"]
        worst = max(worst, float(errs.max()))
        for r in rows:
            where = pathlib.Path(r["path"])
            where = where.relative_to(DATA) if where.is_relative_to(DATA) else where
            if r["max"] is None:
                note = "failed on both routes"
            else:
                note = f"max drift {r['max']:.3g} (feature {r['feature']})"
                note += " (degenerate)" if r["kind"] == "degenerate" else ""
            log(f"  {name} {where}: {note}")
        log(f"{name}: {len(rows)} entries, {len(real)} real content, max {errs.max():.3g}, p99 "
            f"{np.percentile(errs, 99):.3g}, median {np.median(errs):.3g} (limit {REAL_LIMIT:g}); "
            f"degenerate max {max(deg, default=0.0):.3g} (limit {DEGENERATE_LIMIT:g})")
        log(f"{name} per-feature drift histogram (real content): "
            + ", ".join(f"[{lo:.0e}, {hi:.0e}) {c}" for lo, hi, c in
                        zip(HISTOGRAM_EDGES, HISTOGRAM_EDGES[1:], hist)))
        result[name] = {
            "entries": len(rows), "real": len(real), "degenerate": len(deg),
            "failed_on_both": sum(r["max"] is None for r in rows),
            "max_real": float(errs.max()), "p99_real": float(np.percentile(errs, 99)),
            "median_real": float(np.median(errs)), "max_degenerate": max(deg, default=None),
            "histogram": {f"[{lo:g}, {hi:g})": int(c)
                          for lo, hi, c in zip(HISTOGRAM_EDGES, HISTOGRAM_EDGES[1:], hist)},
        }
    result.update(value=worst, ok=not failures, failures=failures,
                  contract={"real": REAL_LIMIT, "degenerate": DEGENERATE_LIMIT,
                            "degenerate_dominant_chroma": "equal"})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.benches.drift")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"),
                    help="the audited route's dtype (default: f32 on a card, f64 on the CPU)")
    ap.add_argument("--paths", nargs="+", default=None,
                    help="audit these files in place of the corpus and the V1 subset")
    ap.add_argument("--decoder", choices=DECODERS, default="native")
    args = ap.parse_args(argv)
    v2 = CORPUS if args.paths is None else [pathlib.Path(p).resolve() for p in args.paths]
    v1 = V1_SUBSET if args.paths is None else v2
    result = audit(v2, v1, args.device, args.dtype, decoder=bench_decoder(args.decoder))
    emit(result)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
