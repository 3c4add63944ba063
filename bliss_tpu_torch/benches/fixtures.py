"""Full-length bench fixtures: the headline's synthesized library mix,
encoded through the port's native libav encoder (counterpart of
benches/fixtures.py).

The same six songs as the JAX repo's mix (names, codecs, bit rates,
durations 170-280 s, mean 215.8 s, seeds 1000 + i, chords + bass +
percussion at 44.1 kHz stereo), encoded to FLAC, MP3 and Ogg Vorbis by
`io/native/bliss_encode.cpp` (built on first use by `io/_native.py`), so
the decoders work as they do on a real library. Written once into a
versioned folder under the repository's ignored tmp/ and reused.

    python -m bliss_tpu_torch.benches.fixtures [DIR]
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import numpy as np

#: Bump when the synthesis or the mix changes, so stale caches regenerate.
VERSION = "v2"

#: (name, (codec, bit rate), duration_s): benches/fixtures.py's MIX.
MIX = [
    ("song_170s.flac", ("flac", ""), 170),
    ("song_250s.mp3", ("libmp3lame", "192000"), 250),
    ("song_180s.ogg", ("libvorbis", ""), 180),
    ("song_280s.mp3", ("libmp3lame", "256000"), 280),
    ("song_175s.flac", ("flac", ""), 175),
    ("song_240s.ogg", ("libvorbis", ""), 240),
]

RATE = 44100

#: The default cache folder, under the repository's ignored tmp/.
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / "tmp" / f"bench_fixtures_{VERSION}"


def music_like(duration_s: float, seed: int, rate: int = RATE) -> np.ndarray:
    """[T, 2] f32 stereo: chord pads + bass + hats/snare noise bursts
    (benches/fixtures.py:music_like)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * rate)
    t = np.arange(n, dtype=np.float64) / rate
    out = np.zeros(n)

    # chord pad: 2-bar chord changes from a small progression
    root_midi = rng.choice([57, 60, 62, 64])  # A3/C4/D4/E4
    progression = rng.permutation([0, 5, 7, 3])
    bar = 60.0 / 110.0 * 4  # 110 BPM, 4/4
    seg = 2 * bar
    seg_idx = (t // seg).astype(np.int64) % len(progression)
    chord_root = root_midi + np.asarray(progression)[seg_idx]
    for interval in (0, 4, 7, 12):
        freq = 440.0 * 2 ** ((chord_root + interval - 69) / 12.0)
        phase = np.cumsum(2 * np.pi * freq / rate)
        vib = 1.0 + 0.002 * np.sin(2 * np.pi * 5.0 * t)
        out += 0.08 * np.sin(phase * vib) * (0.8 + 0.2 * np.sin(2 * np.pi * t / seg))

    # bass: eighth notes on the chord root, one octave down
    eighth = bar / 8
    step = (t // eighth).astype(np.int64)
    bass_freq = 440.0 * 2 ** ((chord_root - 24 - 69) / 12.0)
    bass_phase = np.cumsum(2 * np.pi * bass_freq / rate)
    bass_env = np.exp(-4.0 * ((t % eighth) / eighth))
    out += 0.22 * np.sign(np.sin(bass_phase)) * bass_env * (step % 2 == 0)

    # percussion: hats every eighth, snare-ish burst on 2 and 4
    noise = rng.normal(size=n)
    hat_env = np.exp(-60.0 * ((t % eighth) / eighth))
    out += 0.05 * noise * hat_env
    beat = bar / 4
    beat_pos = (t // beat).astype(np.int64) % 4
    snare_env = np.exp(-25.0 * ((t % beat) / beat))
    out += 0.15 * noise * snare_env * ((beat_pos == 1) | (beat_pos == 3))

    # gentle master envelope + fade in/out
    out *= 0.9 / max(1e-9, np.abs(out).max())
    fade = min(n // 2, rate)
    ramp = np.linspace(0.0, 1.0, fade)
    out[:fade] *= ramp
    out[-fade:] *= ramp[::-1]

    # stereo: slight delay + independent noise floor per channel
    right = np.roll(out, 31)
    st = np.stack([out, right], axis=1)
    st += 1e-4 * rng.normal(size=st.shape)
    return st.astype(np.float32)


def encode(path: pathlib.Path, pcm: np.ndarray, rate: int, codec: tuple) -> None:
    """`pcm` ([T, C] f32) encoded by `bliss_encode` with `codec` (name,
    bit rate or ""), written to a temporary name of this process first, so
    a reader never sees half a file and two processes never share one."""
    from ..io._native import encoder

    name, bit_rate = codec
    pid = os.getpid()
    raw = path.with_name(f"{path.name}.{pid}.f32le")
    tmp = path.with_name(f"{path.stem}.{pid}.part{path.suffix}")  # the format is the suffix's
    pcm = np.ascontiguousarray(pcm, dtype="<f4")
    pcm.tofile(raw)
    try:
        cmd = [str(encoder()), str(raw), str(tmp), str(rate), str(pcm.shape[1]), name]
        subprocess.run(cmd + ([bit_rate] if bit_rate else []), check=True,
                       capture_output=True)
    finally:
        raw.unlink(missing_ok=True)
    tmp.replace(path)


def ensure_bench_fixtures(cache_dir=None, mix=MIX) -> list[pathlib.Path]:
    """Write (once) and return the full-length fixture paths; `mix` may be
    a shorter list of (name, codec, seconds) for a quick run."""
    from concurrent.futures import ThreadPoolExecutor

    cache = pathlib.Path(cache_dir or DEFAULT_DIR)
    cache.mkdir(parents=True, exist_ok=True)
    paths = [cache / name for name, _, _ in mix]
    todo = [i for i, p in enumerate(paths) if not (p.exists() and p.stat().st_size > 0)]

    def make(i):
        _, codec, seconds = mix[i]
        encode(paths[i], music_like(seconds, seed=1000 + i), RATE, codec)

    # numpy's large element-wise ops and the encoder processes run at once
    with ThreadPoolExecutor(max_workers=max(len(todo), 1)) as pool:
        list(pool.map(make, todo))
    return paths


if __name__ == "__main__":
    import sys

    for p in ensure_bench_fixtures(sys.argv[1] if len(sys.argv) > 1 else None):
        print(p, p.stat().st_size)
