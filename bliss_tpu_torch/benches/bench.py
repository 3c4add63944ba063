"""Files to features: decode + analyze songs/s through the batch driver
(counterpart of the repo's bench.py).

    python -m bliss_tpu_torch.benches.bench [--device cuda] [--mix encoded|repo]
        [--songs 24] [--passes N] [--fixtures DIR] [--seconds S]
        [--decoder native|fallback]

`--mix encoded` (default): `--songs` full-length songs cycling over the
six fixtures of `fixtures.py` (the JAX repo's mix: FLAC, MP3 at 192 and
256 kb/s and Ogg Vorbis of 44.1 kHz stereo, mean 215.8 s), encoded once
under tmp/; `--seconds S` makes each fixture S seconds long instead (a
quick run). `--mix repo`: the repo's own codec mix, the 55 paths of the
drift corpus (`drift.py:CORPUS`: FLAC, MP3, Vorbis, AAC, WAV, the chroma
synthetics, a 21-minute Vorbis medley and a CUE album), each once.

Songs are decoded by `FFmpegDecoder`, the native libav decoder, as the
JAX bench decodes them (`--decoder fallback`: the FFI-free
`FallbackDecoder`, for a host without libav; the encoded mix is written
by the native encoder all the same). One analysis of a synthetic 30-s song warms up
(kernel builds, the first launches) and is not counted. Then `--passes`
timed passes of `io.batch.analyze_paths_batched` with decoding (default 3
for the encoded mix, 1 for the repo mix); the first keeps a copy of each
decoded song, and one more pass analyzes the kept songs without decoding:
`decode_share` is the part of the median pass that decoding adds, and
`decode_s_summed` the seconds of a pass's decodes summed over the
driver's threads. Prints one JSON line: songs/s and audio-seconds/s,
median and best, the decode share, the decoded sample count, the decoder,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import time

from . import DECODERS, bench_decoder, card, decode_once, emit

def repo_mix() -> list:
    from .drift import CORPUS

    return list(CORPUS)


def timed_pass(decoder, paths, device):
    """(results, seconds) of one driver pass, ended when the last feature
    vector is on the host."""
    from ..io.batch import analyze_paths_batched

    t0 = time.perf_counter()
    out = list(analyze_paths_batched(decoder, paths, device=device))
    return out, time.perf_counter() - t0


def recording_decoder(base):
    """Decoder `base`, keeping each song it decodes by path and the seconds
    of every decode (in the driver's threads, so they overlap)."""
    import dataclasses

    class Recording(base):
        kept: dict = {}
        seconds: list = []

        @classmethod
        def decode(cls, path):
            t0 = time.perf_counter()
            song = base.decode(path)
            cls.seconds.append(time.perf_counter() - t0)
            cls.kept[str(path)] = dataclasses.replace(song)
            return song

    return Recording


def warm_up(device) -> None:
    """One 30-s synthetic song through the analysis: kernel builds, CUDA
    context, the libraries' handles."""
    import numpy as np

    from ..models.analyzer import analyze_batch

    n = 30 * 22050
    x = np.sin(np.arange(n) * 0.05, dtype=np.float64).astype(np.float32)[None]
    analyze_batch(x, [n], device=device)


def run(device="cuda", mix="encoded", songs=24, passes=None, fixtures=None, seconds=None,
        decoder="native") -> dict:
    import torch

    from ..models.analyzer import resolve_device
    from ..song import Song
    from .fixtures import MIX, ensure_bench_fixtures

    device = resolve_device(device)
    base = bench_decoder(decoder)
    if mix == "encoded":
        table = MIX if seconds is None else [(f"{seconds:g}s_{n}", c, seconds) for n, c, _ in MIX]
        files = ensure_bench_fixtures(fixtures, table)
        paths = [files[i % len(files)] for i in range(songs)]
        passes = passes or 3
    else:
        paths = repo_mix()
        passes = passes or 1
    warm_up(device)
    recording = recording_decoder(base)
    times, results = [], None
    for _ in range(passes):
        results, s = timed_pass(recording, paths, device)
        times.append(s)
    kept = recording.kept
    _, analysis_s = timed_pass(decode_once(paths, kept, base)[0], paths, device)
    ok = [r for _, r in results if isinstance(r, Song)]
    audio = sum(r.duration for r in ok)
    median, best = statistics.median(times), min(times)
    samples = sum(len(kept[str(p)].sample_array) for p in paths if str(p) in kept)
    return {
        "metric": "songs_per_sec",
        "value": len(ok) / median,
        "unit": "songs/s",
        "songs_per_sec_median": len(ok) / median,
        "songs_per_sec_best": len(ok) / best,
        "audio_secs_per_sec_median": audio / median,
        "audio_secs_per_sec_best": audio / best,
        "decode_share": max(0.0, 1.0 - analysis_s / median),
        "analysis_songs_per_sec": len(ok) / analysis_s,
        "decode_s_summed": sum(recording.seconds) / passes,
        "samples": samples,
        "songs": len(ok),
        "failed": len(results) - len(ok),
        "mean_song_secs": audio / max(len(ok), 1),
        "passes": passes,
        "pass_s": times,
        "mix": mix,
        "decoder": base.__name__,
        "device": str(device),
        "card": card(device),
        "torch": torch.__version__,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.benches.bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mix", choices=("encoded", "repo"), default="encoded")
    ap.add_argument("--songs", type=int, default=24, help="songs a pass (encoded mix)")
    ap.add_argument("--passes", type=int, default=None)
    ap.add_argument("--fixtures", default=None, help="folder of the encoded fixtures")
    ap.add_argument("--seconds", type=float, default=None,
                    help="each fixture this long (a quick run)")
    ap.add_argument("--decoder", choices=DECODERS, default="native")
    args = ap.parse_args(argv)
    emit(run(args.device, args.mix, args.songs, args.passes, args.fixtures, args.seconds,
             args.decoder))


if __name__ == "__main__":
    main()
