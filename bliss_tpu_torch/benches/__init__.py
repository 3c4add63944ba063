"""The port's benches. The end-to-end ones print one JSON line each, with
the card's name and power limit (`card`, null off a card):

- `bench`: files to features, songs/s with decoding (WAV mix or the
  repo's codec mix), `python -m bliss_tpu_torch.benches.bench`;
- `playlist_bench`: the queries of a 100k-song library;
- `drift`: the card's f32 vectors against the CPU f64 path over the drift
  corpus, V2 and V1;
- `soak`: `update_library` (or `update_library_recycled`) over a
  synthesized library, with the process tree's resident memory;
- `microbench`: warm medians of decoding and of each descriptor stage.
- `scaling_bench`: weak scaling of the device-list paths over 1, 2 and N
  entries, bit for bit against one entry, and a gloo group's cost a round.

`fixtures` writes the headline's full-length WAV mix. The other files
here compare kernels or routes beside another checkout.
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


def decode_once(paths, known=None):
    """Decode each of `paths` once with the default decoder, timed (a path
    in `known`, a dict of decoded songs by path, is taken from there and
    not decoded). Returns
    a decoder class that hands out those decoded songs again without
    decoding (a path that failed fails again the same way; `Decoded.kept`
    holds them by path), and the seconds each decode took, by path."""
    import dataclasses
    import time

    from ..io.fallback import FallbackDecoder

    kept, seconds = {}, {}
    for path in dict.fromkeys(str(p) for p in paths):
        if known and path in known:
            kept[path] = known[path]
            continue
        t0 = time.perf_counter()
        try:
            kept[path] = FallbackDecoder.decode(path)
        except Exception as e:  # noqa: BLE001 - kept and raised again on use
            kept[path] = e
        seconds[path] = time.perf_counter() - t0

    class Decoded(FallbackDecoder):
        @classmethod
        def decode(cls, path):
            song = kept.get(str(path))
            if song is None:
                return FallbackDecoder.decode(path)
            if isinstance(song, Exception):
                raise song
            return dataclasses.replace(song)

    Decoded.kept = kept
    return Decoded, seconds
