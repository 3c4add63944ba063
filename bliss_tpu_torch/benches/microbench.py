"""Stage microbenchmarks (counterpart of benches/microbench.py; the
reference's criterion groups: descriptors, chroma, decoder, pipeline).

    python -m bliss_tpu_torch.benches.microbench [--device cuda] [--repeat 5]
        [--decoder native|fallback]

Decodes tests/data/s16_mono_22_5kHz.flac (the golden fixture), pads it to
its analysis bucket on `--device`, and times each descriptor stage alone,
the chroma stage's parts, decoding on the host (by the native decoder;
`--decoder fallback`: by `FallbackDecoder`) and the whole analysis of
the song: warm medians of `--repeat` calls after one untimed call (kernel
builds and first launches excluded), each ended by a synchronize on a
card. Prints a line a stage, then one JSON line with every median and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import time

from . import DECODERS, bench_decoder, card, emit

REPO = pathlib.Path(__file__).resolve().parents[2]
SONG = REPO / "tests" / "data" / "s16_mono_22_5kHz.flac"


def run(device="cuda", repeat=5, decoder="native") -> dict:
    import torch

    from ..models import chroma as CH
    from ..models import loudness as LD
    from ..models import tempo as TP
    from ..models import timbral as TB
    from ..models.analyzer import _resolve_dtype, analyze_samples, bucket_length, resolve_device
    from ..ops.spectral import stft
    from ..ops.windows import n_frames_stft
    from ..tables import default_tables

    device = resolve_device(device)
    base = bench_decoder(decoder)
    dtype = _resolve_dtype(device, None)
    decoded = base.decode(SONG)
    n = len(decoded.sample_array)
    tpad = bucket_length(n)
    x = torch.zeros((1, tpad), dtype=torch.float32, device=device)
    x[0, :n] = torch.as_tensor(decoded.sample_array, device=device)
    lens = torch.tensor([n], device=device)
    tab = default_tables().on(device)
    nfc = int(n_frames_stft(tpad, CH.HOP_SIZE))
    frame_mask = torch.arange(nfc, device=device) < n_frames_stft(lens, CH.HOP_SIZE).unsqueeze(-1)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(repeat):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    def spectrum():
        return stft(x, CH.WINDOW_SIZE, CH.HOP_SIZE, lens, nfc, dtype, tab["hann_8192"],
                    tab["twiddle_8192"])

    spec = spectrum()
    fused = CH.uses_fused_tuning(nfc, dtype)
    tuning_fn = CH._estimate_tuning_fused if fused else CH.estimate_tuning
    tuning = tuning_fn(spec, frame_mask, CH.WINDOW_SIZE)
    chroma = CH.chroma_stft_from_spectrum(spec, tuning, CH.WINDOW_SIZE, tab)
    stages = {
        "timbral (centroid/rolloff/flat)": lambda: TB.spectral_features(x, lens, tab),
        "zcr": lambda: TB.zcr_feature(x, lens),
        "loudness": lambda: LD.loudness_features(x, lens),
        "tempo (full)": lambda: TP.tempo_feature(x, lens, tab),
        "chroma (full)": lambda: CH.chroma_features(x, lens, 2, dtype, tab),
        "chroma: stft 8192/2205": spectrum,
        "chroma: estimate_tuning": lambda: tuning_fn(spec, frame_mask, CH.WINDOW_SIZE),
        "chroma: chroma_stft": lambda: CH.chroma_stft_from_spectrum(
            spec, tuning, CH.WINDOW_SIZE, tab),
        "chroma: interval features": lambda: CH.chroma_interval_features(
            chroma, frame_mask, tab["interval_indices"]),
        "decode (host)": lambda: base.decode(SONG),
        "full analysis (1 song)": lambda: analyze_samples(
            decoded.sample_array, n, 2, device=device).cpu(),
    }
    out = {}
    for name, fn in stages.items():
        out[name] = median_ms(fn)
        print(f"{name:32s} {out[name]:10.3f} ms", flush=True)
    return {
        "metric": "microbench_ms",
        "stages_ms": out,
        "song": str(SONG),
        "samples": n,
        "bucket": tpad,
        "repeat": repeat,
        "decoder": base.__name__,
        "tuning_route": "fused" if fused else "unfused",
        "device": str(device),
        "card": card(device),
        "torch": torch.__version__,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.benches.microbench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--decoder", choices=DECODERS, default="native")
    args = ap.parse_args(argv)
    emit(run(args.device, args.repeat, args.decoder))


if __name__ == "__main__":
    main()
