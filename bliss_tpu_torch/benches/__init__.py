"""The port's benches. The end-to-end ones print one JSON line each, with
the card's name and power limit (`card`, null off a card):

- `bench`: files to features, songs/s with decoding (the encoded mix or
  the repo's codec mix), `python -m bliss_tpu_torch.benches.bench`;
- `playlist_bench`: the queries of a 100k-song library;
- `drift`: the card's f32 vectors against the CPU f64 path over the drift
  corpus, V2 and V1;
- `soak`: `update_library` (or `update_library_recycled`) over a
  synthesized library, with the process tree's resident memory;
- `microbench`: warm medians of decoding and of each descriptor stage.
- `scaling_bench`: weak scaling of the device-list paths over 1, 2 and N
  entries, bit for bit against one entry, and a gloo group's cost a round.

`fixtures` encodes the headline's full-length mix. The benches decode
with `FFmpegDecoder`, the native libav decoder, as the JAX ones do;
`--decoder fallback` names the FFI-free `FallbackDecoder` instead, for a
host without libav (`bench_decoder`).
"""

import json
import subprocess
import sys


def card(device) -> str | None:
    """`nvidia-smi`'s name and power limit of the card `device` is on
    (None for the CPU)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def emit(result: dict) -> None:
    """The bench's one JSON line, last on standard output."""
    print(json.dumps(result), flush=True)
    sys.stdout.flush()


#: The benches' `--decoder` choices.
DECODERS = ("native", "fallback")


def bench_decoder(name: str = "native"):
    """The decoder a bench decodes with. "native" (the default) is
    `FFmpegDecoder`, as the JAX benches decode, loaded first: where it
    cannot be built, a bench stops here with the `DecodingError` that says
    why, and counts no song as failed for it. "fallback" is the FFI-free
    `FallbackDecoder`, which a host without libav names explicitly."""
    if name == "fallback":
        from ..io.fallback import FallbackDecoder

        return FallbackDecoder
    from ..io.decoder import FFmpegDecoder, _load_lib

    _load_lib()
    return FFmpegDecoder


def decode_once(paths, known=None, decoder=None):
    """Decode each of `paths` once with `decoder` (default: the native
    decoder), timed (a path in `known`, a dict of decoded songs by path, is
    taken from there and not decoded). Returns a decoder class that hands
    out those decoded songs again without decoding (a path that failed
    fails again the same way; `Decoded.kept` holds them by path), and the
    seconds each decode took, by path."""
    import dataclasses
    import time

    base = decoder or bench_decoder()
    kept, seconds = {}, {}
    for path in dict.fromkeys(str(p) for p in paths):
        if known and path in known:
            kept[path] = known[path]
            continue
        t0 = time.perf_counter()
        try:
            kept[path] = base.decode(path)
        except Exception as e:  # noqa: BLE001 - kept and raised again on use
            kept[path] = e
        seconds[path] = time.perf_counter() - t0

    class Decoded(base):
        @classmethod
        def decode(cls, path):
            song = kept.get(str(path))
            if song is None:
                return base.decode(path)
            if isinstance(song, Exception):
                raise song
            return dataclasses.replace(song)

    Decoded.kept = kept
    return Decoded, seconds
