"""The scan's PCM source "pool": songs served from memory as decoded PCM.

A few long tracks are synthesized on the card from the seed (the port's
`benches/fixtures.py:music_like`, chord pads, bass, hats and snare, here
at 22,050 Hz mono, each track tuned off A440 by its own detune) and held
in host memory as one array. Each song of the
library is a slice of one track at its own offset and of its own length.
`decoder_class` wraps them in a `Decoder` subclass, the port's pluggable
decoder trait (`bliss_tpu_torch/io/decoder.py:Decoder`), so the batch
driver reads songs as it reads decoded files; decoding itself is factored
out, since the card's host cannot build the port's libav decoder.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch

RATE = 22050


def music_like(n: int, seed: int, device, detune_cents: int) -> torch.Tensor:
    """`[n]` f32 on `device`: 110 BPM chord pads with a 0.2% vibrato, an
    eighth-note bass, hats on every eighth and a snare on 2 and 4,
    normalized, faded in and out, over a 1e-4 noise floor. Every pitch is
    detuned from equal temperament at A440 by the centre of a 1-cent bin
    drawn within +-`detune_cents` (the 0.01-semitone bins of the chroma
    stage's tuning estimate, so the track's tuning lies mid-bin, as
    recordings' tunings spread). The vibrato modulates the frequency
    (`benches/fixtures.py` scales the accumulated phase instead, which makes
    the swing grow in proportion to time, until over a long track the pads
    spread across the whole band). The draws come from `seed` alone."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    f64 = torch.float64
    t = torch.arange(n, dtype=f64, device=device) / RATE
    root = float(rng.choice([57, 60, 62, 64]))  # A3/C4/D4/E4
    progression = torch.as_tensor(rng.permutation([0, 5, 7, 3]), dtype=f64, device=device)
    bar = 60.0 / 110.0 * 4
    seg = 2 * bar
    detune = (int(rng.integers(-detune_cents, detune_cents)) + 0.5) / 100
    chord_root = root + detune + progression[(t // seg).long() % 4]
    out = torch.zeros(n, dtype=f64, device=device)
    vib = 1.0 + 0.002 * torch.sin(2 * math.pi * 5.0 * t)
    swell = 0.8 + 0.2 * torch.sin(2 * math.pi * t / seg)
    for interval in (0, 4, 7, 12):
        freq = 440.0 * 2 ** ((chord_root + interval - 69) / 12.0)
        phase = torch.cumsum(2 * math.pi * freq * vib / RATE, 0)
        out += 0.08 * torch.sin(phase) * swell
    eighth = bar / 8
    bass_freq = 440.0 * 2 ** ((chord_root - 24 - 69) / 12.0)
    bass_phase = torch.cumsum(2 * math.pi * bass_freq / RATE, 0)
    on_beat = ((t // eighth).long() % 2 == 0).to(f64)
    out += 0.22 * torch.sign(torch.sin(bass_phase)) * torch.exp(-4.0 * ((t % eighth) / eighth)) * on_beat
    noise = torch.randn(n, generator=gen, dtype=f64, device=device)
    out += 0.05 * noise * torch.exp(-60.0 * ((t % eighth) / eighth))
    beat = bar / 4
    snare = ((t // beat).long() % 4 % 2 == 1).to(f64)
    out += 0.15 * noise * torch.exp(-25.0 * ((t % beat) / beat)) * snare
    out *= 0.9 / torch.clamp(out.abs().max(), min=1e-9)
    fade = min(n // 2, RATE)
    ramp = torch.linspace(0.0, 1.0, fade, dtype=f64, device=device)
    out[:fade] *= ramp
    out[n - fade :] *= ramp.flip(0)
    out += 1e-4 * torch.randn(n, generator=gen, dtype=f64, device=device)
    return out.to(torch.float32)


def make_pool(tracks: int, track_seconds: float, seed: int, device,
              detune_cents: int) -> np.ndarray:
    """`[tracks, samples]` f32 in host memory, track k from `(seed, k)`."""
    n = int(track_seconds * RATE)
    pool = np.empty((tracks, n), np.float32)
    for k in range(tracks):
        track_seed = int(np.random.default_rng([seed, k]).integers(1 << 62))
        pool[k] = music_like(n, track_seed, device, detune_cents).cpu().numpy()
    return pool


def song_path(i: int) -> str:
    return f"/perfbench/pool/{i:07d}.pcm"


def song_index(path) -> int:
    return int(pathlib.PurePath(path).stem)


def decoder_class(pool: np.ndarray, table: np.ndarray, spans=None):
    """A `Decoder` over `pool` whose song i (`song_path(i)`) is
    `pool[table[i, 0], table[i, 1] : table[i, 1] + table[i, 2]]`, a view:
    the driver copies it once into its pinned staging buffer. Each decode
    is a `pcm_source` span of `spans` when given."""
    from bliss_tpu_torch.io.decoder import Decoder, PreAnalyzedSong

    def decode_one(path):
        track, offset, n = (int(v) for v in table[song_index(path)])
        return PreAnalyzedSong(
            path=pathlib.Path(path), duration=n / RATE,
            sample_array=pool[track, offset : offset + n],
        )

    class PoolDecoder(Decoder):
        @classmethod
        def decode(cls, path):
            if spans is None:
                return decode_one(path)
            with spans.span("pcm_source"):
                return decode_one(path)

    return PoolDecoder


def samples(pool: np.ndarray, row) -> np.ndarray:
    """The PCM of one row `(track, offset, n)` of a song table."""
    track, offset, n = (int(v) for v in row)
    return pool[track, offset : offset + n]
