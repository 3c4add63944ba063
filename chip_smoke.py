#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--songs 8] [--seconds 300] [--profile]
                          [--corpus default|full]
    python3 chip_smoke.py --distributed-worker RANK --port P --workdir DIR [--decoder C]
        (one process of phase 12's cluster; the phase starts both)

1. prints the card's name and power limit (nvidia-smi), then the native
   decoder's probe line: pkg-config's version of libavformat, libavcodec,
   libavutil and libswresample, the path of g++, and whether the port's
   native decoder and encoder (`bliss_tpu_torch/io/native/`) built into
   `bliss_tpu_torch/build/`. Where they built, every phase that decodes
   uses the default decoder, `FFmpegDecoder`; where not, each passes
   `FallbackDecoder` explicitly, the examples' CLIs run under a `-c` stub
   that makes it their `DefaultDecoder`, and the native-decode phase does
   not run (the line says so);
2. builds every CUDA kernel of `bliss_tpu_torch/csrc` (one nvcc each, in
   parallel) into `bliss_tpu_torch/build/`; then the native-decode phase:
   the reference's golden adler32 hashes of seven fixtures and the tags of
   s16_mono_22_5kHz.flac through `FFmpegDecoder` (a mismatch fails the run
   under libavformat 59.27.100, and is printed with the largest PCM
   distance to `FallbackDecoder` under another);
3. makes a batch of synthetic songs from `--seed` (tones, chords, clicks
   and noise), 8 x 5 minutes by default, padded to `bucket_length`;
4. holds each kernel against its plain PyTorch version on the card, at
   the shapes the analysis gives it, and times both (a `FAULT:` line names
   a kernel that is not under its library call); `timbral_fft` also prints,
   for the 8 frames where it and its plain version differ most, each one's
   geometric-mean distance to an f64 FFT of the frame, and holds the
   song-level flatness features of its rows at 1e-5; `ct_stft_mags` and
   `ct_frames_mags` also off the path's shapes (B = 3, frames past the end
   of the signal, ragged frame counts, N = 1, rows at a 4-byte offset); the
   fused tuning route's `tuning_peaks` and `tuning_select` are held bit for
   bit against the plane composition of the TPU contracts they replace
   (each song's sorted (key, bin) list and `n` against the planes, `o1`,
   `o2`, `min_c`, `tk`, the counts and the tuning against `bisect16_pair`
   twice, `level2_plane`, `threshold_key` and `histogram_threshold_plane`);
   the beat tracker's `beat_track` against its plain loop over blocks, bit for bit (each
   block's bp, beats and fired, and the tempo feature from each), at the
   batch's series and on edge cases (an all-silent song, a series with no
   positive value, a song cut mid-way, one block, no valid block); the
   block inputs' kernel `block_inputs` against its plain version, every
   field bit for bit (a NaN beside a NaN) in one launch, at the batch's
   series and on edge series (`block_input_edge_series`), timed beside
   the plain version;
5. drives `analyze_batch` (V2, then V1) on the card with the launch
   counts reset just before each, fails if any kernel of the path did not
   run or `block_inputs` ran other than once, and times each descriptor
   stage alone (the beat tracker's block inputs and its kernel apart; the
   block inputs' device ops, at most 5, and their peak memory) and both
   tuning routes on the batch's spectra, equal bit for bit (`--profile`
   adds a torch.profiler trace of one batch: device busy share and the
   longest-running kernels);
6. holds the card's f32 vectors against the port's CPU f64 path: on
   tests/data/piano.wav (<= 1e-4 per feature, and against the pinned
   PIANO_V2) and on one synthetic song (<= 2e-2, same dominant chroma);
7. long buckets, whose tuning takes the unfused route: on 8 synthetic
   7-minute songs (bucket 10,485,760) and 2 synthetic 21-minute songs
   (bucket 29,360,128, B = 2; on this one `beat_track` and `block_inputs`
   too, as in 4) holds `bisect8_keys` (every level, both ranks, bit for
   bit) and `histogram_int_plane` against their plain versions at full
   width and times them, the whole radix select (4 launches, counted)
   beside `torch.nanquantile` and `torch.kthvalue`, drives `analyze_batch`
   with the counts reset (`bisect8_keys` and `histogram_int_plane` must
   launch, `block_inputs` and `beat_track` once, the fused route's two
   must not), holds the unfused tuning
   equal to the fused route's on the same spectra, and one 7-minute song's
   vector against the CPU f64 path (<= 2e-2, same dominant chroma);
8. files: `io.batch.analyze_paths_batched` on the card over the drift
   fixtures (all but the 21-minute medley), piano.flac,
   s16_mono_22_5kHz.flac and testcue.cue (`--corpus full`: every fixture
   of the drift corpus), with decoding (the probe's decoder; the batch
   driver's decode threads, then one decode worker) and from the decoded
   songs, and holds each vector against the port's CPU f64 path on the
   same decoded samples: <= 1e-4 per feature on real content, <= 2e-2 and
   the same dominant chroma on the pure-tone and dyad synthetics; then
   the `timbral="flat"` route on the same decoded real-content songs and
   the MP3 golden fixture, its drift beside the default route's (reported);
9. routes: holds `frame_dft_mags` (hops 128 and 256), `timbral_flat` and
   `ct_frames_mags` (the framed route's `[8 F, 8192]`) against their plain
   versions on the 8 x 5-minute batch (`timbral_flat` called with the
   route's tables, its log2 sum against an f64 DFT of the same frames at
   `dft_kernels.timbral_flat_held`'s limits, and its song-level flatness
   features against the plain rows' at 1e-5; it is also printed beside
   its design's floor at the bf16 tensor-core peak and six bf16
   `torch.matmul` calls of the same GEMM shape as a yardstick, and held on
   its edge cases: B = 3 at T = 200,000, 1 and 1,501 frames, a ragged
   frame count, frames past T, an all-zero and a near-silent song), then
   drives one `analyze_batch` per non-default route (`timbral="flat"`;
   `timbral="mags"` with `tempo="mags"`; `chroma_stft="framed"`) with the
   counts reset,
   checks each route's launches, prints each vector's distance to the
   default route's (tempo must be equal, chroma within 1e-5; the timbral
   features of the `"flat"` and `"mags"` routes are reported), and the
   flatness drift of `"flat"` against `timbral_fft` and the CPU f64 path on
   piano.wav and the batch;
10. long song, full width: one synthetic 60-minute song (79,380,000
   samples, 8 shards of 10,485,760): holds every kernel of the sharded
   path at the shapes that path gives it: `beat_track` and `block_inputs` on
   the song's gathered series (B = 1, 2,560 blocks) as in 4, `ct_frames_mags` at one shard's
   `[4,757, 8192]` (first, middle and last shard), `frame_dft_mags` at
   `[8, 10,506,554]` and `timbral_fft` on the same halo-extended shards
   with its negative frame offset, each against its plain version (the
   first two against library calls too; the worst `timbral_fft` frame is
   printed with its shard and RMS, the 8 farthest with their distances to
   f64, and the song's flatness features are held), the global median's counting rounds
   against a sort and timed alone beside the sharded chroma stage and the
   radix select on the same plane, and `histogram_int_plane` on the sharded
   tuning plane; drives `parallel.longsong.sharded_analyze_samples` with the
   counts reset (the six must launch, `block_inputs` once), holds the vector against the
   bucketed `analyze_batch` (B = 1) of the same song (<= 2e-5 per feature,
   tempo equal; up to the 1e-4 contract a gap is printed as a fault, above
   it the run fails), prints warm seconds and peak memory of both routes
   and the bucketed route's time by stage, holds a 21-minute song's
   sharded vector against the CPU f64 path (<= 2e-2, same dominant
   chroma), and runs `analyze_paths_batched` over that song as a WAV file
   with the default long-song route: over [cuda:0, cuda:0] it must take
   the sharded route in 2 shards (the song is above the 20-minute bound),
   over [cuda:0] the bucket, the two vectors within 2e-5, tempo equal;
11. library: a 100k-song Version2 SQLite store written through the port's
   `Library` (features uniform(-1, 1) from `--seed`, 1% of the rows an
   exact copy of another's features, 0.1% repeating their predecessor's
   title and artist); `playlist_from` cold (SQLite load and the 100k
   `LibrarySong`s apart from the upload and the device query) and warm
   over 9 seeds, `playlist_from_custom(closest_to_songs, dedup)` with the
   V2 Mahalanobis metric and with cosine, each query held against the
   same store opened with `device="cpu"` (the order before dedup, its
   verdicts and the playlist equal, each position's f64 distance within
   1e-5); `song_to_song`
   over the whole store (p50 of 2; the CUDA-graph walk equal to the eager
   step loop on the card index for index, its first 2,000 picks within
   1e-5 of the f64 minimum over the live rows, and how many steps the
   card's and the CPU's walks agree for); `album_playlist_from` against
   the CPU route; then `update_library` on piano.flac,
   s16_mono_22_5kHz.flac and testcue.cue (the path's kernels must launch,
   the stored vectors within 1e-4 of the files phase's, the CUE's missing
   file among the failed songs) and `playlist_from` on one of them; peak
   device memory;
12. multi-device, on the one card (its lines start "multi-device:"; the
   times beside the one-entry route's): right after the main path,
   `parallel.mesh.sharded_analyze_batch` of the 8 x 5-min batch over
   `make_mesh()` and over [cuda:0, cuda:0], bit for bit against
   `analyze_batch`, every kernel launched once an entry; in 10, the
   60-minute song's 8 shards over [cuda:0, cuda:0] against one entry
   (tempo equal, <= 2e-5, the per-piece kernels launched once a piece);
   in 8, the driver over [cuda:0, cuda:0] from the decoded songs, bit for
   bit against one entry, every kernel once a group and more groups than
   one entry; last, `sharded_top_k` (k = 100) and
   `sharded_closest_distances` over the library's 100k matrix on 1 and 3
   entries against the CPU (the same indices, distances within 1e-5), and
   a two-process gloo group on 127.0.0.1, both on cuda:0 (this script
   with `--distributed-worker`, each with a timeout): a ragged
   `analyze_batch_distributed` (3 + 5 of the 5-min songs, bit for bit),
   `top_k_distributed` over the 100k matrix split 60k/40k (equal), and
   `update_library_distributed` of the files set into one store (every
   song within 1e-6 of the files phase's vector, the CUE's missing file
   failed); then the scaling phase (its lines start "scaling:"):
   `bliss_tpu_torch/benches/scaling_bench.py:run_lists` at the bench's
   card sizes over 1, 2 and 4 entries of cuda:0, each list's features,
   top-k, chroma and long-song vector bit for bit against one entry's;
13. recycled: the files set through `Library.update_library_recycled` on
   the card in worker processes of 4 songs, the next one pre-spawned,
   against `update_library` in this process on the same decoded songs
   (every vector within 2e-7, tempo equal, the same failed ledger), each
   worker's launches by (kernel, device) from its debug report (every
   kernel of the path on cuda:0), a second call that starts no process;
   each segment's wall time, the start-up seconds pre-spawning hid, the
   peak RSS of this process and of the workers;
14. examples: ci_check.sh's example sequence on the port's CLIs
   (`python3 -m bliss_tpu_torch.examples.<name> ... --device cuda`, four
   chains at once, the extra-info library in a folder of its own; where
   the native decoder did not build, each CLI through a `-c` stub that sets
   `io.decoder.DefaultDecoder = FallbackDecoder` and then runs the module):
   every exit 0, the .m3u not empty, the printed vector within 1e-6 of
   the files phase's;
15. V1 audit: `bliss_tpu_torch/benches/drift.py` over its V1 subset on the
   card against the CPU f64 path, at most 1e-4 per feature.

Prints each phase's seconds and the whole run's, one JSON line of
per-kernel numbers, the nvidia-smi line, then the result line. Any failed phase exits non-zero. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
import wave

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent

#: The pinned V2 vector of tests/data/piano.wav (samples / 32768 as f32),
#: computed by the JAX package's CPU f64 path and held by
#: tests/test_torch_analyzer.py.
PIANO_V2 = [
    0.186997, -0.9421521, -0.8771694, -0.9097559, -0.84661067,
    -0.8806664, -0.965025, -0.95719546, 0.701856, 0.7115821,
    -0.110660076, -0.15158701, -0.21284789, -0.21377605, -0.20373529,
    -0.21420372, 0.0001308918, 0.00009226799, -0.000012934208,
    -0.00021022558, -0.47165334, -0.6606562, 0.15777446,
]

#: The kernels of the fused tuning route (buckets up to 8,388,608 samples)
#: and of the unfused one (longer buckets).
FUSED_ROUTE = ("tuning_peaks", "tuning_select")
UNFUSED_ROUTE = ("bisect8_keys", "histogram_int_plane")
#: Every kernel of a batch in a bucket of the fused tuning route.
FUSED_PATH = ("timbral_fft", "specflux", "ct_stft", "beat_track", "block_inputs") + FUSED_ROUTE

#: Fixtures whose true spectra sit below the f32 DFT noise floor (pure
#: tones and dyads, tests/test_tpu_drift.py:_degenerate): held at 2e-2 and
#: the same dominant chroma instead of 1e-4.
DATA = REPO / "tests" / "data"
DEGENERATE = {
    str(p) for p in sorted((DATA / "chroma").glob("*.ogg"))
    + [DATA / "tone_11080Hz.flac", DATA / "capacity_fix.ogg", DATA / "silence.ogg"]
}

#: Card peaks used for the bounds (NVIDIA H100 SXM data sheet): HBM rate
#: and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: The tensor cores' dense bf16 rate (same data sheet), for the floor of
#: `timbral_flat`'s six-pass design.
BF16_TENSOR_OPS_PER_S = 989e12

#: The beat tracker's work for a valid block: its 1,028 input words read
#: once, bp, 8 beats and 8 flags written (44 bytes), and the f32 operations
#: of one step (acfout and its maximum over 128 lags, the context model's
#: weights over 256, phout's 21 terms over 160 rows, its weighting and
#: maximum over 256): bytes bound it by four orders of magnitude.
BT_BLOCK_BYTES = 1028 * 4
BT_OUT_BYTES = 4 + 8 * 4 + 8
BT_BLOCK_OPS = 128 * 2 + 256 * 6 + 160 * 21 + 256 * 2
#: The block inputs' f32 operations a block row: the autocorrelation's
#: 131,328 multiply-adds and 512 divisions, dfrev's 512 products, the comb
#: (16 additions and 4 interior products a lag, the weighted sums' 7, the
#: unweighted sums' 3, rayacf's 2, the maxima's 2) and both Gaussian weight
#: vectors (6 a value, `exp` one). Their bytes: the series read once, 1,028
#: words a row written.
BI_ROW_OPS = 512 * 513 + 512 * 2 + 128 * (16 + 4 + 7 + 3 + 2 + 2) + 256 * 6
BI_ROW_OUT_BYTES = 1028 * 4


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    """nvidia-smi's name and power limit of card 0."""
    from bliss_tpu_torch.benches import card

    return card("cuda:0")


# ---------------------------------------------------------------------------
# synthetic songs
# ---------------------------------------------------------------------------


def synth_song(rng: np.random.Generator, n: int, sr: int = 22050) -> np.ndarray:
    """Tones, a chord progression, a click track and noise, `n` samples."""
    t = np.arange(n) / sr
    x = np.zeros(n)
    # chords: a triad every 2-4 s with 3 harmonics per note
    pos = 0
    while pos < n:
        dur = int(sr * rng.uniform(2.0, 4.0))
        root = 110.0 * 2.0 ** (rng.integers(0, 24) / 12.0)
        seg = slice(pos, min(pos + dur, n))
        tt = t[seg] - t[pos]
        env = np.exp(-tt * rng.uniform(0.3, 1.5))
        for semis in (0, rng.choice([3, 4]), 7):
            f = root * 2.0 ** (semis / 12.0)
            for h in (1, 2, 3):
                x[seg] += 0.08 / h * env * np.sin(2 * np.pi * f * h * tt + rng.uniform(0, 6.3))
        pos += dur
    # a melody of pure tones
    pos = 0
    while pos < n:
        dur = int(sr * rng.uniform(0.2, 0.6))
        f = 440.0 * 2.0 ** (rng.integers(-12, 13) / 12.0)
        seg = slice(pos, min(pos + dur, n))
        x[seg] += 0.05 * np.sin(2 * np.pi * f * (t[seg] - t[pos]))
        pos += dur
    # clicks at a steady tempo
    bpm = rng.uniform(80.0, 160.0)
    period = int(sr * 60.0 / bpm)
    click = 0.6 * np.exp(-np.arange(400) / 60.0) * rng.standard_normal(400)
    for start in range(int(rng.integers(0, period)), n - 400, period):
        x[start : start + 400] += click
    x += 0.01 * rng.standard_normal(n)
    return (x / max(1.0, np.abs(x).max())).astype(np.float32)


def piano_samples() -> np.ndarray:
    with wave.open(str(REPO / "tests" / "data" / "piano.wav")) as w:
        if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (1, 2, 22050):
            fail("piano.wav is not 22.05 kHz mono s16")
        raw = w.readframes(w.getnframes())
    return (np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn()` over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph and replayed between CUDA events, so that the wrapper's host work,
    which `time_ms` of back-to-back calls measures whenever it is the
    slower, stays out of the window."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, 3) / reps
    del graph
    return ms


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rfft_ops(n: int) -> float:
    """Operations of an n-point real FFT, the conventional 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def timbral_frame_ops() -> float:
    """Operations the timbral rows need per 512-sample frame: the window
    product, an FFT, 256 magnitudes and the five reductions over them."""
    return 512 + rfft_ops(512) + 256 * 4 + 256 * 8


def hold_timbral_fft(x, n_frames: int, offset: int, label: str, mask) -> float:
    """`timbral_fft` against its plain version on `x [B, T]` with the first
    frame at `-offset`; returns the largest absolute error of the total,
    weighted and energy columns.

    Total, weighted, energy: relative 1e-5; below within +-1 (ties on the
    95% energy line). The log2 sum can sit near 0, so it is held through
    the geometric mean exp2(sum / 256) it gives, |d sum| * ln 2 / 256:
    that sum weighs every near-silent bin, whose magnitude two different
    f32 FFTs round differently (both sit ~3e-6 from f64 on typical
    frames, more on the rare frame with a bin near zero), so its limit is
    the 1e-4 feature contract; its max and mean are printed, and for the 8
    frames farthest apart, each version's distance to an f64 FFT of the same
    frame. The song-level flatness features (mean and std, over the frames
    `mask [S, F']` keeps of the rows viewed as S songs) of the kernel's rows
    are held against the plain rows' at 1e-5."""
    from bliss_tpu_torch.models.timbral import frame_descriptors_from_raw, summarize_spectral
    from bliss_tpu_torch.ops import dft_kernels as DK

    got = DK.timbral_fft(x, n_frames, offset=offset)
    want = DK.timbral_fft_plain(x, n_frames, offset=offset)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[~fin], want[~fin]):
        fail(f"timbral_fft {label}: non-finite entries differ from the plain version")
    diff = torch.where(fin, (got - want).abs(), 0.0)
    scale = torch.clamp(torch.where(fin, want.abs(), 0.0), min=1e-30)
    geo = diff[..., 3] * math.log(2.0) / 256
    rels = {
        "total": (diff[..., 0] / scale[..., 0]).max().item(),
        "weighted": (diff[..., 1] / scale[..., 1]).max().item(),
        "energy": (diff[..., 4] / scale[..., 4]).max().item(),
    }
    rel = max(rels.values())
    below = diff[..., 2].max().item()
    geo_max = geo.max().item()
    print(f"  timbral_fft {label} {list(got.shape)}, offset {offset}: relative errors {rels}, "
          f"geo_mean max {geo_max:.3g} mean {geo.mean().item():.3g}, below max diff {below}",
          flush=True)
    # the frame behind that maximum: where it lies, how loud it is, and how
    # far its spectrum reaches down (a bin near zero moves the log2 sum)
    row, f = divmod(int(geo.argmax()), n_frames)
    start = f * DK.TIMBRAL_HOP - offset
    seg = x[row, max(start, 0) : max(start + DK.TIMBRAL_WINDOW, 0)]
    rms = math.sqrt(float((seg * seg).sum()) / DK.TIMBRAL_WINDOW)
    row_rms = x[row].square().mean().sqrt().item()
    fm = DK.frame_dft_mags_plain(x[row : row + 1], DK.TIMBRAL_HOP, offset - f * DK.TIMBRAL_HOP, 1)
    print(f"  timbral_fft {label}: worst geo_mean frame {f} of row (song or shard) {row}, samples "
          f"[{start}, {start + DK.TIMBRAL_WINDOW}): frame RMS {rms:.6g} (row RMS {row_rms:.6g}), "
          f"magnitudes min {fm.min().item():.3g} median {fm.median().item():.3g} max "
          f"{fm.max().item():.3g}", flush=True)
    # which of the two f32 FFTs exact arithmetic lies nearer, on the frames
    # where they differ most: an f64 FFT of the same f32 windowed frame
    win = DK._constants(DK.TIMBRAL_WINDOW, str(x.device))[0]
    worst = []
    for idx in torch.topk(geo.flatten(), 8).indices.tolist():
        r, fr = divmod(idx, n_frames)
        s0 = fr * DK.TIMBRAL_HOP - offset
        lo, hi = max(s0, 0), min(s0 + DK.TIMBRAL_WINDOW, x.shape[1])
        frame = torch.zeros(DK.TIMBRAL_WINDOW, device=x.device)
        if hi > lo:
            frame[lo - s0 : hi - s0] = x[r, lo:hi]
        m = torch.fft.rfft((frame * win).double()).abs()
        exact = torch.log2(torch.cat([m[:255], m[256:]])).sum().item()
        to64 = [abs(v[r, fr, 3].item() - exact) * math.log(2.0) / 256 for v in (got, want)]
        worst.append(f"({r}, {fr}): kernel {to64[0]:.3g} plain {to64[1]:.3g}")
    print(f"  timbral_fft {label}: the 8 frames farthest apart, geo_mean distance to f64 (row, "
          f"frame): {'; '.join(worst)}", flush=True)

    def flatness(rows):
        c, ro, fl = frame_descriptors_from_raw(rows.reshape(mask.shape + (5,)))
        return summarize_spectral(c, ro, fl, mask)[..., 4:6]

    d_flat = (flatness(got) - flatness(want)).abs().max().item()
    print(f"  timbral_fft {label}: flatness mean and std of the kernel's rows vs the plain rows' "
          f"max {d_flat:.3g} (limit 1e-5)", flush=True)
    if rel > 1e-5 or below > 1 or geo_max > 1e-4 or d_flat > 1e-5:
        fail(f"timbral_fft {label} vs plain: relative {rel:.3g} (limit 1e-5), geo_mean "
             f"{geo_max:.3g} (limit 1e-4), below {below} (limit 1), flatness features "
             f"{d_flat:.3g} (limit 1e-5)")
    return diff[..., [0, 1, 4]].max().item()


def stage_breakdown(x, lens, frame_mask, warm_up: bool = True) -> None:
    """Warm host-clock time of each descriptor stage alone on the batch,
    synchronized before and after, plus the batch's upload from pageable
    host memory. `warm_up=False` times the first call of each stage (for a
    batch whose stages already ran and take seconds)."""
    from bliss_tpu_torch.models import chroma as CH
    from bliss_tpu_torch.models import loudness as LD
    from bliss_tpu_torch.models import tempo as TP
    from bliss_tpu_torch.models import timbral as TB
    from bliss_tpu_torch.ops.spectral import stft
    from bliss_tpu_torch.ops.tempo_kernels import beat_track
    from bliss_tpu_torch.tables import default_tables

    dev = x.device
    tab = default_tables().on(dev)
    xs = torch.where(torch.arange(x.shape[1], device=dev) < lens.unsqueeze(-1), x, 0.0)
    thresh, silent, h_valid = tempo_series(xs, lens)
    consts = TP._bt_constants(dev, tab)
    blocks, n_valid = TP.beat_track_inputs(thresh, h_valid, consts)
    spectrum = stft(xs, 8192, 2205, lens, frame_mask.shape[1])
    fused = CH.uses_fused_tuning(frame_mask.shape[1], torch.float32)
    tuning = CH._estimate_tuning_fused if fused else CH.estimate_tuning
    host = x.cpu().numpy()

    def wall_ms(fn) -> float:
        if warm_up:
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    stages = {
        "tempo": wall_ms(lambda: TP.tempo_feature(xs, lens, tab)),
        "tempo.beat_tracker": wall_ms(lambda: TP.tempo_from_series(thresh, silent, h_valid, consts)),
        "tempo.beat_tracker.precompute": wall_ms(lambda: TP.beat_track_inputs(thresh, h_valid, consts)),
        "tempo.beat_tracker.kernel": wall_ms(lambda: beat_track(blocks, n_valid)),
        "timbral+zcr": wall_ms(lambda: (TB.spectral_features(xs, lens, tab), TB.zcr_feature(xs, lens))),
        "loudness": wall_ms(lambda: LD.loudness_features(xs, lens)),
        "chroma": wall_ms(lambda: CH.chroma_features(xs, lens, 2, torch.float32, tab)),
        "chroma.stft": wall_ms(lambda: stft(xs, 8192, 2205, lens, frame_mask.shape[1])),
        "chroma.tuning": wall_ms(lambda: tuning(spectrum, frame_mask, 8192)),
        "upload": wall_ms(lambda: torch.as_tensor(host, device=dev)),
    }
    print("stages (ms, warm, each alone): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ops(fn, calls: int = 3) -> float:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request") / calls

    n_ops = device_ops(lambda: TP.beat_track_inputs(thresh, h_valid, consts))
    print(f"  the block inputs: {n_ops:g} device ops a call; peak device memory above the series: "
          f"{peak_extra_gb(lambda: TP.beat_track_inputs(thresh, h_valid, consts)) * 1e3:.1f} MB",
          flush=True)
    if n_ops > 5:
        fail(f"the block inputs took {n_ops:g} device ops (at most 5: the kernel and n_valid's)")


def profile_batch(batch, lengths) -> None:
    """torch.profiler over one warm V2 batch: the device's busy share (the
    union of its kernels' and copies' spans over the batch's wall time) and
    the device ops that hold it longest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bliss_tpu_torch.models.analyzer import analyze_batch

    analyze_batch(batch, lengths, version=2, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        analyze_batch(batch, lengths, version=2, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6

    # device rows only: an operator's row repeats the time of the kernels it
    # launched, and the profiler's own buffer request is no device work
    def on_device(e):
        return e.device_type == DeviceType.CUDA and e.key != "Activity Buffer Request"

    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request"
    )
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    rows = sorted(
        ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages() if on_device(e)),
        reverse=True,
    )
    print(f"profile: wall {wall / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / wall:.1f}%), {len(spans)} device ops", flush=True)
    for dt, count, key in rows[:15]:
        print(f"  {dt / 1e3:9.3f} ms {count:7d}x {key[:90]}")


def tempo_series(x, lens):
    """The beat tracker's inputs of a zero-padded batch `x [B, T]`, as
    `tempo_feature` forms them: the thresholded novelty and the silence
    flags `[B, H]` and `h_valid [B]`."""
    from bliss_tpu_torch.models import tempo as TP
    from bliss_tpu_torch.ops.dft_kernels import specflux
    from bliss_tpu_torch.ops.windows import n_frames_strided

    n_hops = int(n_frames_strided(x.shape[1], 512, 256))
    return (
        TP.thresholded_series(specflux(x, n_hops)),
        TP.silence_flags_blocked(x, n_hops),
        n_frames_strided(lens, 512, 256),
    )


def hold_beat_track(thresh, silent, h_valid, label: str, card: str, plain_reps: int = 0) -> dict:
    """`beat_track` against its plain loop on the same block inputs: bp,
    beats and fired bit for bit over every block (past a song's valid
    blocks both freeze its state), and the tempo feature from each equal.
    Times the kernel (mean of 20 launches) and the plain loop (`plain_reps`
    warm calls, or the host clock of the comparison's one call), and
    returns what `record` takes."""
    from bliss_tpu_torch.models import tempo as TP
    from bliss_tpu_torch.ops import tempo_kernels as TK
    from bliss_tpu_torch.tables import default_tables

    dev = thresh.device
    consts = TP._bt_constants(dev, default_tables().on(dev))
    blocks, n_valid = TP.beat_track_inputs(thresh, h_valid, consts)
    got = TK.beat_track(blocks, n_valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = TK.beat_track_plain(blocks, n_valid)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    broken = []
    for name, g, w in zip(("bp", "beats", "fired"), got, want):
        gb = g.view(torch.int32) if g.dtype == torch.float32 else g
        wb = w.view(torch.int32) if w.dtype == torch.float32 else w
        if g.shape != w.shape or not torch.equal(gb, wb):
            at = tuple((gb != wb).nonzero()[0].tolist()) if g.shape == w.shape else ()
            broken.append(f"{name} first differs at (song, block, beat) {at}: kernel "
                          f"{g[at].item()!r}, plain {w[at].item()!r}" if at else f"{name} shape")
    tempo_k = TP._tempo_from_beats(*got, silent, h_valid, consts.step)
    tempo_p = TP._tempo_from_beats(*want, silent, h_valid, consts.step)
    if not torch.equal(tempo_k, tempo_p):
        broken.append(f"tempo {tempo_k.tolist()} vs plain {tempo_p.tolist()}")
    if broken:
        fail(f"beat_track {label} vs plain: " + "; ".join(broken))
    err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
    ms = time_ms(lambda: TK.beat_track(blocks, n_valid), 20)
    if plain_reps:
        plain_ms = time_ms(lambda: TK.beat_track_plain(blocks, n_valid), plain_reps)
    batch, n_blocks = blocks["dfrev"].shape[:2]
    n_run = int(n_valid.sum())
    longest = int(n_valid.max())
    nbytes = n_run * BT_BLOCK_BYTES + batch * n_blocks * BT_OUT_BYTES + batch * 4
    ops = n_run * BT_BLOCK_OPS
    bnd = bound(nbytes, ops)
    step_us = ms * 1e3 / max(longest, 1)
    print(f"  beat_track {label}: B = {batch}, {n_blocks} blocks ({n_run} valid, the longest song "
          f"{longest}), bit for bit with the plain loop, tempo {[round(v, 7) for v in tempo_k.tolist()]} "
          f"equal; kernel {ms:.4f} ms = {step_us:.3f} us a block step, plain loop {plain_ms:.1f} ms, "
          f"bound {bnd[0]:.4f} ms by {bnd[1]} [{card}]", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "nbytes": nbytes, "ops": ops,
            "step_us": step_us}


def block_input_edge_series(dev) -> dict:
    """Thresholded series `[B, 1100]` f32 and `h_valid [B]` (8 blocks) that
    reach the block inputs' rare paths: "nan and inf" (a NaN, an inf, a -inf
    beside a NaN, and an inf past h_valid, which the mask removes: XLA's
    zero products make every lag past the first non-finite value NaN);
    "silent" (zeros, and a series masked whole by h_valid 0: a zero comb,
    its last maximum at lag 127); "lag 1" (three adjacent spikes, (1, 2, 1),
    and two: the comb's maximum at lag 1, rp < 2); "long period" (a spike
    every 88 hops over a faint floor: rp >= 85, so 6 gp + 2 >= 512 and the
    time signature's wide sums); "overflow" (values near 1e20, one song of
    either sign: inf and NaN sums, the interior multiply's NaN at lags 0
    and 127, rayacf's NaN); "signed" (Gaussian noise: negative comb totals,
    -0 at lags 0 and 127)."""
    rng = np.random.default_rng(12)
    h = 1100

    def noise(b, scale=1.0):
        return (rng.standard_normal((b, h)) * scale).astype(np.float32)

    cases = {}
    x = np.abs(noise(4)) * 0.1
    x[:, ::43] += 3.0
    x[0, 300] = np.nan
    x[1, 520] = np.inf
    x[2, 700], x[2, 701] = -np.inf, np.nan
    x[3, 1050] = np.inf
    cases["nan and inf"] = (x, [h, h, h, 1000])
    x = np.zeros((2, h), np.float32)
    x[1] = np.abs(noise(1)[0])
    cases["silent"] = (x, [h, 0])
    x = np.zeros((2, h), np.float32)
    x[0, 124:127] = (1.0, 2.0, 1.0)
    x[1, 125:127] = (1.5, 0.5)
    cases["lag 1"] = (x, [h, h])
    x = np.abs(noise(2)) * 1e-3
    x[0, 5::88] += 2.0
    x[1, 40::88] += 1.0
    cases["long period"] = (x, [h, h - 200])
    x = noise(2, 1e20)
    x[0] = np.abs(x[0])
    cases["overflow"] = (x, [h, h])
    cases["signed"] = (noise(3), [h, 900, 333])
    return {k: (torch.as_tensor(v, device=dev), torch.as_tensor(hv, device=dev))
            for k, (v, hv) in cases.items()}


def peak_extra_gb(fn) -> float:
    """Device memory `fn()` takes above what was held before it, at its peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def block_args(thresh, h_valid):
    """`ops/tempo_kernels.block_inputs`' arguments for a series on the card,
    as `models/tempo.py:beat_track_inputs` passes them."""
    from bliss_tpu_torch.models import tempo as TP
    from bliss_tpu_torch.tables import default_tables

    dev = thresh.device
    consts = TP._bt_constants(dev, default_tables().on(dev))
    return (thresh, h_valid, consts.rwv, consts.dfwv, consts.rayparam_trunc, consts.g_var2)


def same_blocks(got, want) -> list:
    """The block inputs' fields that differ (a NaN beside a NaN is equal),
    each with the first index where it does."""
    broken = []
    for name in want:
        g, w = got[name], want[name]
        if g.shape != w.shape or g.dtype != w.dtype:
            broken.append(f"{name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
            continue
        same = (g.view(torch.int32) == w.view(torch.int32)) if g.dtype == torch.float32 else g == w
        if g.dtype == torch.float32:
            same |= torch.isnan(g) & torch.isnan(w)
        if not bool(same.all()):
            at = tuple((~same).nonzero()[0].tolist())
            broken.append(f"{name} first differs at {at}: kernel {g[at].item()!r}, plain {w[at].item()!r}")
    return broken


def hold_block_inputs(thresh, h_valid, label: str, card: str, plain_reps: int = 2) -> dict:
    """`block_inputs` against its plain version on the card, every field bit
    for bit (a NaN beside a NaN), in one launch; timed on the device
    (`graph_ms`) and a call at a time (`time_ms`, the wrapper's host work
    included) beside the plain version (the eager ops and `autocorr_plain`)
    and its bound; returns what `record` takes."""
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.ops import tempo_kernels as TK

    args = block_args(thresh, h_valid)
    _build.reset_launches()
    got = TK.block_inputs(*args)
    launched = dict(_build.LAUNCHES)
    want = TK.block_inputs_plain(*args)
    torch.cuda.synchronize()
    broken = same_blocks(got, want)
    if launched != {"block_inputs": 1}:
        broken.append(f"launches {launched}")
    if broken:
        fail(f"block_inputs {label} vs plain: " + "; ".join(broken))
    err = 0.0  # every field bit for bit
    call_ms = time_ms(lambda: TK.block_inputs(*args), 20)
    ms = graph_ms(lambda: TK.block_inputs(*args))
    plain_ms = time_ms(lambda: TK.block_inputs_plain(*args), plain_reps)
    batch, n_blocks = got["dfrev"].shape[:2]
    rows = batch * n_blocks
    nbytes = thresh.numel() * 4 + batch * 8 + (128 + 512) * 4 + rows * BI_ROW_OUT_BYTES
    ops = rows * BI_ROW_OPS
    bnd = bound(nbytes, ops)
    print(f"  block_inputs {label}: {rows} rows, every field bit for bit with the plain version, "
          f"one launch; kernel {ms:.4f} ms on the device, {call_ms:.4f} ms a call, plain "
          f"{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms by {bnd[1]} [{card}]", flush=True)
    return {"err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "nbytes": nbytes, "ops": ops, "rows": rows}


def hold_block_input_edges(dev) -> None:
    """`block_inputs` on `block_input_edge_series`, bit for bit with the
    plain version."""
    from bliss_tpu_torch.ops import tempo_kernels as TK

    series = block_input_edge_series(dev)
    for name, (thresh, h_valid) in series.items():
        args = block_args(thresh, h_valid)
        broken = same_blocks(TK.block_inputs(*args), TK.block_inputs_plain(*args))
        if broken:
            fail(f"block_inputs edge series {name!r} vs plain: " + "; ".join(broken))
    print(f"  block_inputs edge series ({', '.join(series)}): every field bit for bit with the "
          "plain version", flush=True)


def hold_beat_track_edges(dev, card: str) -> None:
    """`beat_track` on edge cases (B = 6, 3,000 hops): an all-silent song
    (its series 0, every hop silent), a song with no positive value in its
    series, a click train, the same cut at 1,500 hops, one block, and no
    valid block."""
    from bliss_tpu_torch.models import tempo as TP

    rng = np.random.default_rng(7)
    h = 3000
    onset = (rng.random((6, h)) * 0.1).astype(np.float32)
    onset[2:, ::43] += 3.0
    thresh = TP.thresholded_series(torch.as_tensor(onset, device=dev))
    thresh[0] = 0.0
    thresh[1] = -(0.1 + 0.01 * torch.rand(h, generator=torch.Generator().manual_seed(7))).to(dev)
    silent = torch.zeros((6, h), dtype=torch.bool, device=dev)
    silent[0] = True
    h_valid = torch.tensor([h, h, h, 1500, 200, 100], device=dev)
    hold_beat_track(thresh, silent, h_valid, "edge cases", card)


def hold_fused_tuning(record, spectrum, frame_mask, label: str) -> None:
    """The fused tuning route's two kernels on the spectra `[B, bins, F]`
    (the frame-major storage's view) against the plane composition of the
    TPU contracts they replace, bit for bit: `n` and each song's sorted
    (key, bin) list against the planes' `skey` and `idx8` where `idx8 < 100`;
    `o1`, `o2`, `min_c`, `tk` and the counts against `bisect16_pair` twice,
    `level2_plane`, `threshold_key` and `histogram_threshold_plane`; the
    tuning of both. Records both kernels with their plain versions' times
    and their bounds by bytes: the spectrum's valid frames once, the list
    and the outputs."""
    from bliss_tpu_torch.models import chroma as CH
    from bliss_tpu_torch.ops import tuning_kernels as TK

    b = spectrum.shape[0]
    spec_fm = spectrum.transpose(1, 2)
    band = CH.peak_band(8192)
    keys, bins, n = TK.tuning_peaks(spec_fm, frame_mask, *band)
    sel = TK.tuning_select(keys, bins, n)
    planes = CH.tuning_planes(spectrum, frame_mask, 8192)
    o1 = TK.bisect16_pair_plain(planes["plane_hi"], planes["ks"])
    plane_lo, rem, min_c = CH.level2_plane(planes["skey"], planes["ks"], o1)
    o2 = TK.bisect16_pair_plain(plane_lo, rem)
    tk = CH.threshold_key(o1, o2, min_c, torch.float32)
    counts = TK.histogram_threshold_plane_plain(planes["idx8"], planes["skey"], tk, 100)
    torch.cuda.synchronize()
    valid = planes["idx8"].reshape(b, -1) < 100
    skey = planes["skey"].reshape(b, -1)
    idx8 = planes["idx8"].reshape(b, -1)
    if not torch.equal(n, valid.sum(1).to(torch.int32)):
        fail(f"tuning_peaks {label}: n {n.tolist()} != the planes' {valid.sum(1).tolist()}")
    for s in range(b):
        m = int(n[s])
        got_l = torch.sort(keys[s, :m].to(torch.int64) * 256 + bins[s, :m]).values
        want_l = torch.sort(skey[s][valid[s]].to(torch.int64) * 256 + idx8[s][valid[s]]).values
        if not torch.equal(got_l, want_l):
            fail(f"tuning_peaks {label}: song {s}'s (key, bin) list differs from the planes'")
    want = {"counts": counts, "o1": o1, "o2": o2, "min_c": min_c.to(torch.int32), "tk": tk}
    for k, v in want.items():
        if not torch.equal(sel[k], v):
            fail(f"tuning_select {label}: {k} {sel[k].tolist()} != composition {v.tolist()}")
    tuning = CH._tuning_from_counts(sel["counts"], sel["counts"].sum(1) > 0, 0.01, torch.float32)
    tuning_c = CH._tuning_from_counts(counts, counts.sum(1) > 0, 0.01, torch.float32)
    fused = CH._estimate_tuning_fused(spectrum, frame_mask, 8192)
    if not (torch.equal(tuning, tuning_c) and torch.equal(fused, tuning_c)):
        fail(f"fused tuning {label}: {fused.tolist()} != composition {tuning_c.tolist()}")
    n_peaks = int(n.sum())
    n_frames = int(frame_mask.sum())
    print(f"  tuning {label}: {n_peaks} peaks ({n.tolist()}) in {n_frames} valid frames; lists, "
          f"n, o1, o2, min_c, tk, counts and tuning {tuning.tolist()} equal to the plane "
          f"composition, bit for bit", flush=True)
    rows = planes["skey"].shape[2]
    del planes, o1, o2, plane_lo, rem, min_c, tk, counts, valid, skey, idx8, want
    torch.cuda.empty_cache()
    # bytes: the valid frames of the spectrum and the frame mask once, 5 bytes
    # a peak and the counters out; then the list in, ~450 bytes a song out
    record(
        "tuning_peaks", "bliss_tpu_torch/csrc/tuning.cu",
        "bliss_tpu/ops/pallas_select.py:129", 0.0,
        time_ms(lambda: TK.tuning_peaks(spec_fm, frame_mask, *band), 20),
        time_ms(lambda: TK.tuning_peaks_plain(spec_fm, frame_mask, *band), 3),
        n_frames * spectrum.shape[1] * 4 + frame_mask.numel() + n_peaks * 5 + b * 4,
        n_frames * (spectrum.shape[1] + 3 * rows) + 40 * n_peaks, None,
    )
    record(
        "tuning_select", "bliss_tpu_torch/csrc/tuning.cu",
        "bliss_tpu/ops/pallas_hist.py:93", 0.0,
        time_ms(lambda: TK.tuning_select(keys, bins, n), 20),
        time_ms(lambda: TK.tuning_select_plain(keys, bins, n), 3),
        n_peaks * 5 + b * 4 + b * (100 + 4 + 4 + 2) * 4, 5 * n_peaks, None,
    )
    whole = bound(n_frames * spectrum.shape[1] * 4, 0)[0]
    print(f"  tuning {label}: the whole spectrum's valid frames once {whole:.4f} ms by bytes "
          f"({spectrum.numel() * 4 / 1e6:.1f} MB with the padding frames)", flush=True)


def hold_tuning_routes(spectrum, frame_mask, label: str) -> None:
    """The unfused tuning estimate against the fused route's on the same
    spectra, bit for bit, and the device time of both."""
    from bliss_tpu_torch.models import chroma as CH

    unfused = CH.estimate_tuning(spectrum, frame_mask, 8192)
    fused = CH._estimate_tuning_fused(spectrum, frame_mask, 8192)
    if not torch.equal(unfused, fused):
        fail(f"{label}: unfused tuning {unfused.tolist()} != fused {fused.tolist()}")
    unfused_ms = time_ms(lambda: CH.estimate_tuning(spectrum, frame_mask, 8192), 3)
    fused_ms = time_ms(lambda: CH._estimate_tuning_fused(spectrum, frame_mask, 8192), 3)
    route = "fused" if CH.uses_fused_tuning(frame_mask.shape[1], torch.float32) else "unfused"
    print(f"  {label}: unfused tuning == fused route's, bit for bit: {unfused.tolist()}; "
          f"tuning stage {unfused_ms:.3f} ms unfused, {fused_ms:.3f} ms fused (this bucket's "
          f"route: {route})", flush=True)


def plain_radix_select(values, mask, q: float = 0.5):
    """The whole radix select by the plain version of its key entry."""
    from bliss_tpu_torch.ops import tuning_kernels as TK

    b = values.shape[0]
    state = torch.zeros((b, 5), dtype=torch.int64, device=values.device)
    median = torch.empty(b, dtype=torch.float32, device=values.device)
    for level in range(4):
        TK.bisect8_keys_plain(values.view(b, -1), mask.view(b, -1), level, state, q, median)
    return median


def long_phase(rng, results, card, n_songs: int, seconds: float, record_json: bool) -> np.ndarray:
    """One long bucket on the card: the unfused route's kernels at full
    width against their plain versions (times, bounds, library calls),
    the batch through `analyze_batch` with the launch counts reset, the
    unfused tuning against the fused route's on the same spectra, and (for
    the 7-minute batch) one song against the CPU f64 path. Returns the
    batch's first song."""
    from bliss_tpu_torch.models import chroma as CH
    from bliss_tpu_torch.models.analyzer import analyze_batch, analyze_samples, bucket_length
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.ops import reductions as RD
    from bliss_tpu_torch.ops import tuning_kernels as TK
    from bliss_tpu_torch.ops.spectral import stft
    from bliss_tpu_torch.ops.windows import n_frames_stft

    label = f"{n_songs} x {seconds / 60:g}-min"
    t0 = time.perf_counter()
    n = int(round(seconds * 22050))
    tpad = bucket_length(n)
    batch = np.zeros((n_songs, tpad), np.float32)
    for i in range(n_songs):
        batch[i, :n] = synth_song(rng, n)
    lengths = np.full(n_songs, n, np.int64)
    print(f"long bucket {label}: {n} samples (buffer {tpad}), data in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    dev = torch.device("cuda", 0)
    x = torch.as_tensor(batch, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    if not record_json:
        series = tempo_series(x, lens)
        held = hold_beat_track(*series, label, card)
        results["beat_track"][f"{n_songs}x{seconds / 60:g}min"] = {
            k: held[k] for k in ("ms", "plain_ms", "step_us")}
        held = hold_block_inputs(series[0], series[2], label, card)
        results["block_inputs"][f"{n_songs}x{seconds / 60:g}min"] = {
            k: held[k] for k in ("ms", "call_ms", "plain_ms", "rows")}
        del series, held
    nfc = int(n_frames_stft(tpad, 2205))
    if CH.uses_fused_tuning(nfc, torch.float32):
        fail(f"{label}: bucket {tpad} ({nfc} frames) is within the fused budget")
    frame_mask = torch.arange(nfc, device=dev) < n_frames_stft(lens, 2205).unsqueeze(-1)
    spectrum = stft(x, 8192, 2205, lens, nfc)

    # the unfused route's planes, as estimate_tuning builds them
    pitches, mags, peak = CH.pip_track(spectrum, frame_mask, 8192)
    pos = peak & (pitches > 0.0)
    _, _, n_peaks, ranks = TK.radix_keys(mags, pos)
    # the key entry: every level, both ranks, and the state it carries, over
    # the frame-major storage behind the `[B, rows, F]` views, which the
    # select reads in place (as `estimate_tuning` hands it over)
    mags_fm, pos_fm = mags.transpose(1, 2), pos.transpose(1, 2)
    vals = mags_fm.view(n_songs, -1)
    mflat = pos_fm.view(n_songs, -1)
    state_k = torch.zeros((n_songs, 5), dtype=torch.int64, device=dev)
    state_p = state_k.clone()
    med_k = torch.empty(n_songs, dtype=torch.float32, device=dev)
    med_p = torch.empty_like(med_k)
    states = []
    for level in range(4):
        states.append(state_k.clone())
        got = TK.bisect8_keys(vals, mflat, level, state_k, 0.5, med_k)
        want = TK.bisect8_keys_plain(vals, mflat, level, state_p, 0.5, med_p)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(state_k, state_p)):
            fail(f"{label}: bisect8_keys level {level} != plain: {got.tolist()} {want.tolist()} "
                 f"state {state_k.tolist()} {state_p.tolist()}")
    if not torch.equal(med_k, med_p) or not torch.equal(state_k[:, 4], n_peaks.to(torch.int64)):
        fail(f"{label}: bisect8_keys median {med_k.tolist()} != plain {med_p.tolist()}")
    _build.reset_launches()
    thr = TK.masked_quantile_midpoint_radix(mags_fm, pos_fm)
    select_launches = dict(_build.LAUNCHES)
    if select_launches != {"bisect8_keys": 4}:
        fail(f"{label}: one radix select launched {select_launches}, expected 4 x bisect8_keys")
    thr_sort = RD.masked_quantile_midpoint(vals, mflat)
    if not (torch.equal(thr, thr_sort) and torch.equal(thr, med_k)):
        fail(f"{label}: radix median != sort median: {thr.tolist()} {thr_sort.tolist()}")
    sel = pos & (mags >= thr.view(-1, 1, 1))
    idx_m = CH.tuning_bin_plane(pitches, sel)
    hist, histp = TK.histogram_int_plane(idx_m, 100), TK.histogram_int_plane_plain(idx_m, 100)
    if not torch.equal(hist, histp):
        fail(f"{label}: histogram_int_plane != plain")
    n_el = mflat.numel()
    n_valid = int(n_peaks.sum())
    print(f"  {label}: {n_valid} peaks in {n_el} plane elements; bisect8_keys (4 levels x 2 ranks), "
          f"the radix median (4 launches) and histogram_int_plane exact", flush=True)

    # times: the kernels, their plain versions, and the library calls
    key_ms = [
        time_ms(lambda: TK.bisect8_keys(vals, mflat, level, states[level].clone(), 0.5, med_k), 20)
        for level in range(4)
    ]
    key_plain = time_ms(lambda: TK.bisect8_keys_plain(vals, mflat, 1, states[1].clone()), 3)
    select_ms = time_ms(lambda: TK.masked_quantile_midpoint_radix(mags_fm, pos_fm), 20)
    select_plain = time_ms(lambda: plain_radix_select(mags_fm, pos_fm), 2)
    inf_vals = torch.where(mflat, vals, float("inf"))
    kf = [int(r) + 1 for r in ranks[0].tolist()]
    kc = [int(r) + 1 for r in ranks[1].tolist()]

    def kthvalue_select():
        for i in range(n_songs):
            torch.kthvalue(inf_vals[i], kf[i])
            torch.kthvalue(inf_vals[i], kc[i])

    kth_ms = time_ms(kthvalue_select, 3)
    nanq_ms = None
    if vals.shape[1] <= 1 << 24:  # torch.quantile's input size limit
        nan_vals = torch.where(mflat, vals, float("nan"))
        nanq = torch.nanquantile(nan_vals, 0.5, dim=1, interpolation="midpoint")
        if not torch.equal(nanq, thr):
            print(f"  note: nanquantile differs from the exact median by "
                  f"{(nanq - thr).abs().max().item():.3g}")
        nanq_ms = time_ms(lambda: torch.nanquantile(nan_vals, 0.5, dim=1, interpolation="midpoint"), 3)
        del nan_vals
    hi_ms = time_ms(lambda: TK.histogram_int_plane(idx_m, 100), 20)
    hi_plain = time_ms(lambda: TK.histogram_int_plane_plain(idx_m, 100), 3)
    song_id = torch.arange(n_songs, device=dev).view(-1, 1, 1)
    offsets = torch.where(idx_m < 100, song_id * 100 + idx_m, n_songs * 100).reshape(-1)
    bincount_ms = time_ms(lambda: torch.bincount(offsets, minlength=n_songs * 100 + 1), 5)
    hi_bound = bound(idx_m.numel() * 4 + n_songs * 400, idx_m.numel())
    # one key launch reads the mask once and the value of each valid element
    # (what this run's data needs), and writes 16 bytes a song. The masked
    # median as a function needs no more: the mask once, each valid value
    # once and 4 bytes a song out (a first pass could compact the valid keys
    # and the later levels walk those). What this design's four passes over
    # the mask move is the algorithm's own cost, printed under its own name.
    key_bytes = n_el + 4 * n_valid + n_songs * (40 + 16)
    key_bound = bound(key_bytes, n_el + 4 * n_valid)
    sel_bound = bound(n_el + 4 * n_valid + n_songs * 4, n_el + 4 * n_valid)
    four_pass = bound(4 * key_bytes + n_songs * 4, 4 * (n_el + 4 * n_valid))
    print(f"  {label} bisect8_keys: {sum(key_ms) / 4:.4f} ms a launch (levels 0-3: "
          f"{', '.join(f'{t:.4f}' for t in key_ms)}, each with a clone of its state and its own "
          f"zeroed counters; plain, one level, {key_plain:.4f}; bound {key_bound[0]:.4f} by "
          f"{key_bound[1]}); whole radix select {select_ms:.4f} ms, 4 launches (plain {select_plain:.4f}, bound "
          f"{sel_bound[0]:.4f} by {sel_bound[1]}: the mask and the valid values once; its own four "
          f"passes over the mask alone {four_pass[0]:.4f}) vs torch.kthvalue x {2 * n_songs} {kth_ms:.4f} "
          f"ms, torch.nanquantile {nanq_ms} ms", flush=True)
    if nanq_ms is not None and select_ms >= nanq_ms:
        print(f"  FAULT: the radix select ({select_ms:.4f} ms) is not under torch.nanquantile "
              f"({nanq_ms:.4f} ms)", flush=True)
    print(f"  {label} histogram_int_plane: {hi_ms:.4f} ms (plain {hi_plain:.4f}, bound "
          f"{hi_bound[0]:.4f} by {hi_bound[1]}); torch.bincount {bincount_ms:.4f} ms", flush=True)
    if record_json:
        # row 9 is the whole select as the path runs it (4 launches of the
        # key entry), so that its time, bound, plain and library columns
        # speak of one function; one launch rides along
        for name, err_ms, plain_ms, bnd, lib in (
            ("bisect8_keys", select_ms, select_plain, sel_bound, nanq_ms),
            ("histogram_int_plane", hi_ms, hi_plain, hi_bound, bincount_ms),
        ):
            results[name] = {
                "name": name, "route": "cuda", "source": "bliss_tpu_torch/csrc/tuning.cu",
                "replaces": ("bliss_tpu/ops/pallas_select.py:39" if name == "bisect8_keys"
                             else "bliss_tpu/ops/pallas_hist.py:45"),
                "launches": 0, "max_abs_err": 0.0, "ms": err_ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
            }
        results["bisect8_keys"].update({
            "what": "whole radix select, 4 launches",
            "launch_ms": sum(key_ms) / 4, "launch_plain_ms": key_plain,
            "launch_bound_ms": key_bound[0], "four_pass_ms": four_pass[0],
        })

    hold_tuning_routes(spectrum, frame_mask, label)
    del spectrum, pitches, mags, peak, pos, idx_m, inf_vals, vals, mflat, offsets, sel
    del states, state_k, state_p, mags_fm, pos_fm
    del x, lens, frame_mask
    torch.cuda.empty_cache()

    # the batch through the entry point, counts reset just before
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = analyze_batch(batch, lengths, version=2, device="cuda")
    first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    analyze_batch(batch, lengths, version=2, device="cuda")
    warm_s = time.perf_counter() - t0
    print(f"  {label} batch V2: first {first_s:.3f} s, warm {warm_s:.3f} s = "
          f"{n_songs / warm_s:.2f} songs/s; launches {launches} [{card}]", flush=True)
    need = ("timbral_fft", "specflux", "ct_stft") + UNFUSED_ROUTE
    if (any(launches.get(k, 0) < 1 for k in need) or any(launches.get(k, 0) for k in FUSED_ROUTE)
            or launches.get("block_inputs") != 1 or launches.get("beat_track") != 1):
        fail(f"{label}: wrong kernels on the long bucket (counts {launches})")
    if record_json:
        for name in UNFUSED_ROUTE:
            results[name]["launches"] = launches[name]
    if feats.shape != (n_songs, 23) or not np.isfinite(feats).all():
        fail(f"{label}: features {feats.shape}, finite {np.isfinite(feats).all()}")
    if record_json:
        t0 = time.perf_counter()
        cpu0 = analyze_samples(batch[0, :n], n, 2, device="cpu").cpu().numpy()
        d = np.abs(feats[0] - cpu0).max()
        same_argmax = int(np.argmax(feats[0, 10:])) == int(np.argmax(cpu0[10:]))
        print(f"  {label} song 0: CUDA f32 vs CPU f64 max {d:.3g} (limit 2e-2), dominant chroma "
              f"{'agrees' if same_argmax else 'DIFFERS'} (CPU run {time.perf_counter() - t0:.1f} s)",
              flush=True)
        if d > 2e-2 or not same_argmax:
            fail(f"{label}: synthetic song drift")
    return batch[0, :n].copy()


# ---------------------------------------------------------------------------
# the native decoder
# ---------------------------------------------------------------------------

#: The decoder of every phase that decodes, set by `native_probe` before any
#: phase decodes: the default decoder, FFmpegDecoder, where the native
#: decoder built; else FallbackDecoder, passed explicitly.
DECODER = None

#: The reference's golden adler32 hashes of the decoded PCM (bliss-rs
#: src/song/decoder/ffmpeg.rs:379-527, tests/test_decoder.py).
GOLDEN_HASHES = {
    "s16_mono_22_5kHz.flac": 0x5E01930B,
    "s32_mono_44_1_kHz.flac": 0xA0F8B8AF,
    "s32_stereo_44_1_kHz.flac": 0xBBCBA1CF,
    "s16_stereo_22_5kHz.flac": 0x1D7B2D6D,
    "s32_stereo_44_1_kHz.mp3": 0x69CA6906,
    "no_channel.wav": 0xD594429C,
    "piano.wav": 0xDE831E82,
}
#: The tags of s16_mono_22_5kHz.flac (tests/test_decoder.py:test_tags).
GOLDEN_TAGS = {
    "artist": "David TMX", "album_artist": "David TMX - Album Artist",
    "title": "Renaissance", "album": "Renaissance", "track_number": 2, "disc_number": 1,
    "genre": "Pop",
}
#: The libavformat against which the CPU tests hold the golden hashes: under
#: it a mismatch fails the run, under another it is reported.
GOLDEN_LIBAVFORMAT = "59.27.100"


def native_probe() -> dict:
    """What the native decoder needs on this host (each libav library's
    pkg-config version, the path of g++) and whether the decoder and the
    encoder built; sets DECODER from it, and says which phases it changes."""
    global DECODER
    from bliss_tpu_torch.io import _native
    from bliss_tpu_torch.io.decoder import DefaultDecoder
    from bliss_tpu_torch.io.fallback import FallbackDecoder

    t0 = time.perf_counter()
    probe = _native.probe()
    DECODER = DefaultDecoder if probe["ok"] else FallbackDecoder
    libav = ", ".join(f"{k} {v or 'MISSING'}" for k, v in probe["libav"].items())
    use = ("every phase that decodes uses the default decoder, FFmpegDecoder" if probe["ok"] else
           "every phase that decodes passes FallbackDecoder explicitly, the examples' CLIs run "
           "under a stub that makes it their DefaultDecoder; the native-decode phase does not run")
    print(f"native decoder probe: pkg-config: {libav}; g++ {probe['g++']}; decoder "
          f"{probe['decoder']}; encoder {probe['encoder']} ({time.perf_counter() - t0:.2f} s); "
          f"{use}", flush=True)
    return probe


def native_decode_phase(probe: dict, card: str) -> None:
    """The port's FFmpegDecoder on the host: the golden adler32 hashes of
    seven fixtures and the tags of s16_mono_22_5kHz.flac, each decode
    timed. Under GOLDEN_LIBAVFORMAT a mismatch fails the run; under another
    libav each differing hash is printed beside its golden value with the
    largest PCM distance to FallbackDecoder, and the run goes on."""
    import zlib

    from bliss_tpu_torch.io.decoder import FFmpegDecoder
    from bliss_tpu_torch.io.fallback import FallbackDecoder

    if DECODER is not FFmpegDecoder:
        print("native decode: not run, the native decoder did not build (see the probe line)",
              flush=True)
        return
    pinned = probe["libav"]["libavformat"] == GOLDEN_LIBAVFORMAT
    rows, bad = [], []
    for name, want in GOLDEN_HASHES.items():
        t0 = time.perf_counter()
        x = FFmpegDecoder.decode(DATA / name).sample_array
        ms = (time.perf_counter() - t0) * 1e3
        got = zlib.adler32(x.tobytes())
        row = f"{name} {got:#010x} {'==' if got == want else '!='} {want:#010x} ({ms:.1f} ms)"
        if got != want:
            bad.append(name)
            ref = FallbackDecoder.decode(DATA / name).sample_array
            m = min(len(x), len(ref))
            row += (f", largest PCM distance to FallbackDecoder {np.abs(x[:m] - ref[:m]).max():.3g}"
                    f" ({len(x)} samples, FallbackDecoder {len(ref)})")
        rows.append(row)
    song = FFmpegDecoder.decode(DATA / "s16_mono_22_5kHz.flac")
    tags = [f"{k} {getattr(song, k)!r}" for k, v in GOLDEN_TAGS.items() if getattr(song, k) != v]
    print(f"native decode: golden adler32 of {len(rows)} fixtures under libavformat "
          f"{probe['libav']['libavformat']} ("
          f"{'the pinned one' if pinned else f'not the pinned {GOLDEN_LIBAVFORMAT}: reported'}): "
          f"{len(rows) - len(bad)} equal; tags of "
          f"s16_mono_22_5kHz.flac {'equal' if not tags else 'DIFFER: ' + ', '.join(tags)} "
          f"[{card}]", flush=True)
    for row in rows:
        print(f"  {row}", flush=True)
    if pinned and (bad or tags):
        fail(f"native decode: {bad} hashes, tags {tags} differ from the reference's")


def files_set(corpus: str = "default") -> list:
    """The files phase's paths: the drift fixtures but the 21-minute medley,
    piano.flac, s16_mono_22_5kHz.flac and testcue.cue; `full`, every
    fixture of the drift corpus."""
    drift = sorted((DATA / "drift").iterdir())
    if corpus == "full":
        # benches/tpu_drift.py:CORPUS
        return sorted(
            p for p in list(DATA.glob("*.flac")) + list(DATA.glob("*.mp3"))
            + list(DATA.glob("*.ogg")) + list(DATA.glob("*.wav"))
            + list((DATA / "chroma").glob("*.ogg")) + drift
            if p.name != "empty.wav"
        ) + [DATA / "testcue.cue"]
    return [p for p in drift if "medley" not in p.name] + [
        DATA / "piano.flac", DATA / "s16_mono_22_5kHz.flac", DATA / "testcue.cue",
    ]


def files_phase(corpus: str, card: str) -> dict:
    """Files to features on the card through the batch driver, timed with
    and without decoding, held against the port's CPU f64 path on the
    same decoded samples; then the driver over two entries of the card.
    Returns the card's results by path and the decoded songs by path."""
    from bliss_tpu_torch.io import batch as IB
    from bliss_tpu_torch.io.batch import analyze_paths_batched
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.song import Song

    paths = files_set(corpus)
    decoded: dict = {}
    decode_s: dict = {}

    class Recording(DECODER):
        """Decodes, and keeps a copy of each decoded song."""

        @classmethod
        def decode(cls, path):
            t0 = time.perf_counter()
            song = DECODER.decode(path)
            decode_s[str(path)] = time.perf_counter() - t0
            decoded[str(path)] = dataclasses.replace(song, sample_array=song.sample_array.copy())
            return song

    class Decoded(DECODER):
        """Hands out the kept songs: the same samples without decoding."""

        @classmethod
        def decode(cls, path):
            song = decoded.get(str(path))
            if song is None:  # a file that failed to decode fails again
                return DECODER.decode(path)
            return dataclasses.replace(song, sample_array=song.sample_array.copy())

    def run(decoder, device, workers=None, devices=None, longsong_samples=None):
        t0 = time.perf_counter()
        out = {
            str(p): r
            for p, r in analyze_paths_batched(
                decoder, paths, device=device, decode_workers=workers, devices=devices,
                longsong_samples=longsong_samples,
            )
        }
        if device != "cpu":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    gpu, with_s = run(Recording, "cuda")
    threads_s = sum(decode_s.values())
    gpu1, one_worker_s = run(Recording, "cuda", workers=1)
    serial_s = sum(decode_s.values())
    # the driver's groups: one analyze_replayed call each (the shape's first
    # eager, then its graph's replays), with its device and rows; every
    # kernel of the path launches once a group
    groups = []
    analyze_replayed = IB.analyze_replayed

    def counted(x, *args, **kwargs):
        groups.append((str(x.device), x.shape[0]))
        return analyze_replayed(x, *args, **kwargs)

    IB.analyze_replayed = counted
    try:
        _build.reset_launches()
        gpu2, without_s = run(Decoded, "cuda")
        one = (list(groups), dict(_build.LAUNCHES_ON))
        groups.clear()
        _build.reset_launches()
        dev0 = torch.device("cuda", 0)
        # every song in the buckets (`--corpus full`'s 21-minute medley would
        # take the default long-song route over two entries)
        two, two_s = run(Decoded, None, devices=[dev0, dev0], longsong_samples=10**9)
        listed = (list(groups), dict(_build.LAUNCHES_ON))
    finally:
        IB.analyze_replayed = analyze_replayed
    cpu, cpu_s = run(Decoded, "cpu")
    songs = sorted(k for k, r in gpu.items() if isinstance(r, Song))
    n_songs = len(songs)
    share = (with_s - without_s) / with_s
    print(f"files ({corpus}, {DECODER.__name__}): {len(paths)} paths -> {n_songs} songs; with "
          f"decode {with_s:.2f} s = "
          f"{n_songs / with_s:.3f} songs/s, from decoded songs {without_s:.2f} s = "
          f"{n_songs / without_s:.3f} songs/s; decode share {share:.3f} (decode time summed over "
          f"threads {threads_s:.1f} s); with one decode worker {one_worker_s:.2f} s = "
          f"{n_songs / one_worker_s:.3f} songs/s (decode {serial_s:.1f} s); CPU f64 reference "
          f"{cpu_s:.1f} s [{card}]", flush=True)
    failures = []
    if not sorted(gpu) == sorted(gpu1) == sorted(gpu2) == sorted(cpu):
        failures.append(f"different results: {sorted(set(gpu) ^ set(cpu))}")
    worst = {"real": (0.0, ""), "degenerate": (0.0, "")}
    for key in sorted(set(gpu) & set(cpu)):
        g, c = gpu[key], cpu[key]
        if type(g) is not type(c):
            failures.append(f"{key}: {type(g).__name__} on the card, {type(c).__name__} on the CPU")
            continue
        if not isinstance(g, Song):
            continue
        gv, cv = g.analysis.as_arr1(), c.analysis.as_arr1()
        err = np.abs(gv - cv)
        if not np.isfinite(gv).all():
            failures.append(f"{key}: non-finite features")
        rerun = np.abs(gv - gpu2[key].analysis.as_arr1()).max()
        if key in DEGENERATE:
            kind, limit = "degenerate", 2e-2
            if int(np.argmax(gv[10:20])) != int(np.argmax(cv[10:20])):
                failures.append(f"{key}: dominant chroma differs")
        else:
            kind, limit = "real", 1e-4
        if err.max() > worst[kind][0]:
            worst[kind] = (float(err.max()), key)
        print(f"  {pathlib.Path(key).relative_to(DATA)}: max {err.max():.3g} (feature "
              f"{int(err.argmax())}, limit {limit:g}); rerun from decoded songs {rerun:.3g}")
        if err.max() > limit:
            failures.append(f"{key}: feature {int(err.argmax())} drift {err.max():.3g} > {limit:g}")
    print(f"  worst real content {worst['real'][0]:.3g} ({worst['real'][1]}), worst degenerate "
          f"{worst['degenerate'][0]:.3g} ({worst['degenerate'][1]})", flush=True)
    failures += hold_listed_driver(gpu2, without_s, one, two, two_s, listed, card)
    if failures:
        fail("files phase: " + "; ".join(failures))
    flat_audit(decoded, gpu, cpu)
    return gpu, decoded


def hold_listed_driver(one_out, one_s, one, listed_out, listed_s, listed, card) -> list:
    """The multi-device phase's driver check: `analyze_paths_batched` over
    [cuda:0, cuda:0] against the one-entry driver on the same decoded
    songs, every vector bit for bit; every kernel of the path launched once
    a group on the card, and more groups than on one entry (a bucket's
    second half ran on the second entry)."""
    from bliss_tpu_torch.song import Song

    failures = []
    if sorted(one_out) != sorted(listed_out):
        failures.append("driver over [cuda:0, cuda:0]: other paths than over one entry")
    gaps = {}
    for key, r in one_out.items():
        g = listed_out.get(key)
        if isinstance(r, Song) != isinstance(g, Song):
            failures.append(f"driver over [cuda:0, cuda:0]: {key} {type(g).__name__}")
        elif isinstance(r, Song):
            gaps[key] = np.abs(r.analysis.as_arr1() - g.analysis.as_arr1())
    worst = max(gaps.values(), key=lambda a: a.max())
    exact = sum(not a.any() for a in gaps.values())
    for label, (groups, counts) in (("one entry", one), ("[cuda:0, cuda:0]", listed)):
        for k in FUSED_PATH:
            if counts.get((k, "cuda:0"), 0) != len(groups):
                failures.append(f"driver over {label}: {k} launched {counts.get((k, 'cuda:0'), 0)} "
                                f"times for {len(groups)} groups")
    if len(listed[0]) <= len(one[0]):
        failures.append(f"driver over [cuda:0, cuda:0]: {len(listed[0])} groups, one entry "
                        f"{len(one[0])}: no bucket was split")
    print(f"multi-device: analyze_paths_batched over [cuda:0, cuda:0] from decoded songs "
          f"{listed_s:.3f} s ({len(listed[0])} groups of {sorted({b for _, b in listed[0]})} rows), "
          f"one entry {one_s:.3f} s ({len(one[0])} groups); {exact} of {len(gaps)} vectors bit for "
          f"bit, largest gap {worst.max():.3g} (feature {int(worst.argmax())}); every path kernel "
          f"once a group [{card}]", flush=True)
    if exact != len(gaps):
        failures.append(f"driver over [cuda:0, cuda:0]: {len(gaps) - exact} vectors differ from "
                        f"one entry's, up to {worst.max():.3g} (feature {int(worst.argmax())})")
    return failures


def flat_audit(decoded: dict, gpu: dict, cpu: dict) -> None:
    """The `timbral="flat"` route (the direct-DFT rows) on every decoded
    real-content song of the files phase and on the MP3 golden fixture:
    its drift from the CPU f64 path beside the default route's, per song
    the worst feature and the worst of the two flatness features (6, 7).
    Reported against the 1e-4 contract, not failed."""
    from bliss_tpu_torch.models.analyzer import analyze_samples
    from bliss_tpu_torch.routes import Routes
    from bliss_tpu_torch.song import Song

    rows = []  # (flat max, flat flatness, fft max, fft flatness, name)
    flat = Routes(timbral="flat")
    for key in sorted(decoded):
        if key in DEGENERATE or not isinstance(gpu.get(key), Song):
            continue
        x = decoded[key].sample_array
        f = analyze_samples(x, x.shape[0], 2, device="cuda", routes=flat).cpu().numpy()
        c, g = cpu[key].analysis.as_arr1(), gpu[key].analysis.as_arr1()
        rows.append((np.abs(f - c).max(), np.abs(f - c)[6:8].max(), np.abs(g - c).max(),
                     np.abs(g - c)[6:8].max(), str(pathlib.Path(key).relative_to(DATA))))
    x = DECODER.decode(DATA / "s16_mono_22_5kHz.mp3").sample_array
    c = analyze_samples(x, x.shape[0], 2, device="cpu").cpu().numpy()
    f = analyze_samples(x, x.shape[0], 2, device="cuda", routes=flat).cpu().numpy()
    g = analyze_samples(x, x.shape[0], 2, device="cuda").cpu().numpy()
    rows.append((np.abs(f - c).max(), np.abs(f - c)[6:8].max(), np.abs(g - c).max(),
                 np.abs(g - c)[6:8].max(), "s16_mono_22_5kHz.mp3"))
    worst = max(rows)
    over = [r[4] for r in rows if r[0] > 1e-4]
    print(f"flat route vs CPU f64 over {len(rows)} real-content songs: worst feature drift "
          f"{worst[0]:.3g} ({worst[4]}; the default route there {worst[2]:.3g}), worst flatness "
          f"drift {max(r[1] for r in rows):.3g} (default route {max(r[3] for r in rows):.3g}); "
          f"s16_mono_22_5kHz.mp3: flat {rows[-1][0]:.3g}, default {rows[-1][2]:.3g}; songs over "
          f"the 1e-4 contract: {over or 'none'}", flush=True)


def frame_span_stft(signal, hop: int, offset: int, n_frames: int, hann):
    """One library call computing `frame_dft_mags`: `torch.stft` over the
    span of the frames (zero history prepended where the offset is
    positive), as `[B, F, 257]`."""
    need = (n_frames - 1) * hop + 512
    if offset > 0:
        span = torch.nn.functional.pad(signal, (offset, max(need - offset - signal.shape[1], 0)))
    else:
        span = signal[:, -offset:]
    return torch.stft(span[:, :need], 512, hop, window=hann, center=False,
                      return_complex=True).abs().transpose(1, 2)


def hold_frame_dft(x, hop: int, offset: int, n_frames: int, label: str) -> dict:
    """`frame_dft_mags` against its plain version (1e-5 of each frame's
    max) and `torch.stft`, with times and the bound of this shape (what
    the function needs: its bytes, or an FFT a frame)."""
    from bliss_tpu_torch.ops import dft_kernels as DK

    got = DK.frame_dft_mags(x, 512, hop, offset, n_frames)
    want = DK.frame_dft_mags_plain(x, hop, offset, n_frames)
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = (err.amax(-1) / want.amax(-1).clamp(min=1e-30)).max().item()
    if not torch.isfinite(got).all() or rel > 1e-5:
        fail(f"frame_dft_mags {label}: {rel:.3g} of each frame's max (limit 1e-5)")
    hann = torch.hann_window(512, periodic=True, device=x.device)
    lib = frame_span_stft(x, hop, offset, n_frames, hann)
    lib_rel = ((lib - want).abs().amax(-1) / want.amax(-1).clamp(min=1e-30)).max().item()
    if lib_rel > 1e-5:
        fail(f"frame_dft_mags {label}: the library call computes another function ({lib_rel:.3g})")
    n_fr = x.shape[0] * n_frames
    out = {
        "err": err.max().item(), "rel": rel,
        "ms": time_ms(lambda: DK.frame_dft_mags(x, 512, hop, offset, n_frames), 10),
        "plain_ms": time_ms(lambda: DK.frame_dft_mags_plain(x, hop, offset, n_frames), 3),
        "library_ms": time_ms(lambda: frame_span_stft(x, hop, offset, n_frames, hann), 3),
        "nbytes": x.numel() * 4 + n_fr * 257 * 4,
        "ops": n_fr * (512 + rfft_ops(512) + 257 * 4),
    }
    bms, by = bound(out["nbytes"], out["ops"])
    print(f"  frame_dft_mags {label} {list(got.shape)}: relative error {rel:.3g}, {out['ms']:.4f} ms "
          f"(plain {out['plain_ms']:.4f}, torch.stft {out['library_ms']:.4f}, bound {bms:.4f} by "
          f"{by})", flush=True)
    if out["ms"] >= out["library_ms"]:
        print(f"  FAULT: frame_dft_mags {label} is not under torch.stft + abs", flush=True)
    return out


def hold_ct_frames(frames, label: str) -> dict:
    """`ct_frames_mags` on `frames [N, 8192]` against its plain version
    (1e-5 of each frame's max), with times, `torch.fft.rfft` as the library
    call and the bytes and operations of this shape."""
    from bliss_tpu_torch.ops import dft_kernels as DK

    got = DK.ct_frames_mags(frames)
    want = DK.ct_frames_mags_plain(frames)
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = (err.amax(0) / want.amax(0).clamp(min=1e-30)).max().item()
    if not torch.isfinite(got).all() or rel > 1e-5:
        fail(f"ct_frames_mags {label} vs plain: {rel:.3g} of each frame's max (limit 1e-5)")
    n_fr, w = frames.shape
    hann = torch.hann_window(w, periodic=True, device=frames.device)
    out = {
        "err": err.max().item(), "rel": rel,
        "ms": time_ms(lambda: DK.ct_frames_mags(frames), 5),
        "plain_ms": time_ms(lambda: DK.ct_frames_mags_plain(frames), 3),
        "library_ms": time_ms(lambda: torch.fft.rfft(frames * hann).abs(), 3),
        "nbytes": n_fr * w * 4 + n_fr * (w // 2 + 1) * 4,
        "ops": n_fr * (w + rfft_ops(w) + (w // 2 + 1) * 4),
    }
    bms, by = bound(out["nbytes"], out["ops"])
    print(f"  ct_frames {label} {list(frames.shape)}: relative error {rel:.3g} of the frame max, "
          f"{out['ms']:.4f} ms (plain {out['plain_ms']:.4f}, torch.fft.rfft {out['library_ms']:.4f}, "
          f"bound {bms:.4f} by {by})", flush=True)
    if out["ms"] >= out["library_ms"]:
        print(f"  FAULT: ct_frames {label} is not under torch.fft.rfft + abs", flush=True)
    return out


def hold_ct_edge_cases(dev) -> None:
    """`ct_stft_mags` and `ct_frames_mags` against their plain versions
    (1e-5 of each frame's max) where the path's shapes do not reach: B = 3
    songs of an odd length (1,350 frames, no multiple of the blocks the
    card holds), frames that run past the end of the signal (zeros there;
    the wrapper refuses them, so through the C entry point), N = 1 and a
    ragged N of pre-framed rows, and rows at a 4-byte offset (no 8-byte
    loads)."""
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.ops import dft_kernels as DK

    gen = torch.Generator(device=dev).manual_seed(5)
    held = []

    def check(label, got, want, dim):
        torch.cuda.synchronize()
        rel = ((got - want).abs().amax(dim) / want.amax(dim).clamp(min=1e-30)).max().item()
        if not torch.isfinite(got).all() or rel > 1e-5:
            fail(f"{label} vs plain: {rel:.3g} of each frame's max (limit 1e-5)")
        held.append(f"{label} {rel:.2g}")

    padded = torch.randn((3, 1_000_003), generator=gen, device=dev) * 0.1
    w, hop = 8192, 2205
    nf = (padded.shape[1] - w) // hop + 1
    check(f"ct_stft [3, 1000003] W {w} hop {hop} ({nf} frames a song)",
          DK.ct_stft_mags(padded, w, hop, nf), DK.ct_stft_mags_plain(padded, w, hop, nf), 1)
    nf = (padded.shape[1] - w) // hop + 5
    win, tw = DK._constants(w, str(dev))
    out = torch.empty((3, nf, w // 2 + 1), device=dev)
    fn = _build.function("ct_stft", "ct_stft_launch", DK._CT_ARGS)
    _build.launch(
        "ct_stft", fn, dev, _build.ptr(padded), 3, padded.shape[1], nf, hop, _build.ptr(win),
        _build.ptr(tw[0]), _build.ptr(tw[1]), _build.ptr(out))
    ext = torch.nn.functional.pad(padded, (0, (nf - 1) * hop + w - padded.shape[1]))
    check(f"ct_stft, the last 4 of {nf} frames past the end", out.transpose(1, 2),
          DK.ct_stft_mags_plain(ext, w, hop, nf), 1)
    for n in (1, 1001):
        frames = torch.randn((n, w), generator=gen, device=dev) * 0.1
        check(f"ct_frames [{n}, {w}]", DK.ct_frames_mags(frames), DK.ct_frames_mags_plain(frames), 0)
    frames = (torch.randn(257 * w + 1, generator=gen, device=dev) * 0.1)[1:].view(257, w)
    check(f"ct_frames [257, {w}] at a 4-byte offset", DK.ct_frames_mags(frames),
          DK.ct_frames_mags_plain(frames), 0)
    print("  ct edge cases vs plain, of each frame's max: " + "; ".join(held), flush=True)


def hold_flat(got, want, label: str, sig, nf: int):
    """`timbral_flat`'s rows against its plain version's and an f64 DFT's of
    the same frames at `dft_kernels.timbral_flat_held`'s limits (the log2 sum
    through the mean and worst per-frame geometric-mean distance to the f64
    DFT, beside the plain version's own); the per-frame distance to the
    plain version is printed too. Returns the largest absolute error of the
    total, weighted and energy columns."""
    from bliss_tpu_torch.ops import dft_kernels as DK

    r, broken = DK.timbral_flat_held(got, want, DK.timbral_flat_f64(sig, nf))
    print(f"  timbral_flat {label}: relative error {r['rel']:.3g}, below max diff {r['below']:g}; "
          f"per-frame geo_mean distance mean (max): to f64 {r['geo_f64_mean']:.3g} "
          f"({r['geo_f64_max']:.3g}), plain to f64 {r['geo_plain_f64_mean']:.3g} "
          f"({r['geo_plain_f64_max']:.3g}), limit {r['geo_plain_f64_mean'] + DK.FLAT_GEO_EXCESS:.3g} "
          f"({max(DK.FLAT_GEO_WORST, r['geo_plain_f64_max']):.3g}); to plain {r['geo_plain_mean']:.3g} "
          f"({r['geo_plain_max']:.3g})", flush=True)
    if broken:
        fail(f"timbral_flat {label}: " + "; ".join(broken))
    return r["abs"]


def hold_flat_edge_cases(dev) -> None:
    """`timbral_flat` off the batch's shapes, at the batch's limits: B = 3 at
    T = 200,000 (no multiple of 128), one frame, 1,501 frames, a frame count
    no multiple of the 128-frame tile, frames past T, an all-zero song and a
    near-silent one."""
    from bliss_tpu_torch.ops import dft_kernels as DK

    rng = np.random.default_rng(23)
    noise = torch.as_tensor((rng.normal(size=(3, 200000)) * 0.1).astype(np.float32), device=dev)
    quiet = torch.as_tensor((rng.normal(size=(2, 200000)) * 1e-6).astype(np.float32), device=dev)
    cases = {
        "B = 3, 1,501 frames": (noise, 1501),
        "1 frame": (noise, 1),
        "1,000 frames": (noise[:1], 1000),
        "frames past T": (noise, (200000 + 384) // 128 + 40),
        "all-zero song": (torch.zeros((2, 70000), device=dev), 550),
        "near-silent song": (quiet, 1563),
    }
    for label, (sig, nf) in cases.items():
        got = DK.timbral_flat(sig, nf)
        want = DK.timbral_flat_plain(sig, nf)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"timbral_flat {label}: shape {tuple(got.shape)}, plain {tuple(want.shape)}")
        hold_flat(got, want, label, sig, nf)


def routes_phase(record, results, x, batch, lengths, v2, cpu0, piano, tpad: int, card: str) -> None:
    """The non-default routes on the 8 x 5-minute batch: their kernels
    against the plain versions, one `analyze_batch` per route with the
    launch counts reset, each vector's distance to the default route's."""
    from bliss_tpu_torch.models.analyzer import analyze_batch, analyze_samples
    from bliss_tpu_torch.models.timbral import frame_descriptors_from_raw, summarize_spectral
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.ops import dft_kernels as DK
    from bliss_tpu_torch.ops.windows import (
        frame_signal_reflect,
        n_frames_stft,
        n_frames_strided,
    )
    from bliss_tpu_torch.routes import Routes
    from bliss_tpu_torch.tables import default_tables

    b = x.shape[0]
    nf = int(n_frames_strided(tpad, 512, 128))
    nh = int(n_frames_strided(tpad, 512, 256))
    hold_frame_dft(x, 128, 384, nf, "8 x 5-min hop 128")
    hold_frame_dft(x, 256, 256, nh, "8 x 5-min hop 256")
    # the chroma_stft="framed" route's frames, as ops.spectral.stft makes them
    nfc = int(n_frames_stft(tpad, 2205))
    frames = frame_signal_reflect(x, lengths, 8192, 2205, nfc).reshape(b * nfc, 8192)
    hold_ct_frames(frames, "8 x 5-min, framed route")
    del frames

    # timbral_flat, called as the route calls it (the tables' window and
    # twiddles): [B, F, 5] (hold_flat), and the song-level flatness
    # features of its rows against the plain rows' at 1e-5, as timbral_fft's
    tab = default_tables().on(x.device)
    win, tw = tab["hann_512"], tab["twiddle_512"]
    got = DK.timbral_flat(x, nf, win, tw)
    want = DK.timbral_flat_plain(x, nf, win, tw)
    torch.cuda.synchronize()
    flat_err = hold_flat(got, want, f"{b} x 5-min", x, nf)
    mask = torch.arange(nf, device=x.device) < n_frames_strided(
        torch.as_tensor(lengths, device=x.device), 512, 128).unsqueeze(-1)
    c_g, ro_g, fl_g = frame_descriptors_from_raw(got)
    c_w, ro_w, fl_w = frame_descriptors_from_raw(want)
    d_flat = (summarize_spectral(c_g, ro_g, fl_g, mask)[..., 4:6]
              - summarize_spectral(c_w, ro_w, fl_w, mask)[..., 4:6]).abs().max().item()
    print(f"  timbral_flat: flatness mean and std of the kernel's rows vs the plain rows' max "
          f"{d_flat:.3g} (limit 1e-5)", flush=True)
    if d_flat > 1e-5:
        fail(f"timbral_flat: flatness features {d_flat:.3g} from the plain rows' (limit 1e-5)")
    record(
        "timbral_flat", "bliss_tpu_torch/csrc/timbral_flat.cu", "bliss_tpu/ops/pallas_dft.py:80",
        flat_err,
        time_ms(lambda: DK.timbral_flat(x, nf, win, tw), 10),
        time_ms(lambda: DK.timbral_flat_plain(x, nf, win, tw), 2),
        x.numel() * 4 + b * nf * 5 * 4,
        b * nf * timbral_frame_ops(), None,
    )
    direct_ms = b * nf * (512 + 512 * 256 * 2 * 2 + 256 * 4 + 256 * 8) / F32_OPS_PER_S * 1e3
    print(f"  timbral_flat: the direct DFT's own operations at the f32 peak {direct_ms:.4f} ms "
          f"(the bound above counts an FFT a frame, as timbral_fft's)", flush=True)
    rows = b * nf
    floor_ms = rows * 512 * 512 * 2 * 6 / BF16_TENSOR_OPS_PER_S * 1e3
    print(f"  timbral_flat: the design's floor, six bf16 passes of the direct DFT at the tensor "
          f"cores' bf16 peak, {floor_ms:.4f} ms", flush=True)
    a16 = torch.randn((rows, 512), device=x.device).to(torch.bfloat16)
    b16 = torch.randn((512, 512), device=x.device).to(torch.bfloat16)
    gemm_ms = time_ms(lambda: [torch.matmul(a16, b16) for _ in range(6)], 5)
    print(f"  timbral_flat: GEMM yardstick, six bf16 torch.matmul of [{rows}, 512] x [512, 512] "
          f"{gemm_ms:.4f} ms (not called by the port; not the table's library column)", flush=True)
    del a16, b16
    hold_flat_edge_cases(x.device)
    # the frame-level flatness ingredient of the two timbral kernels
    gap = DK.geo_gap(got, DK.timbral_fft(x, nf))
    print(f"  timbral_flat vs timbral_fft, per-frame geometric mean: max {gap.max().item():.3g}, "
          f"mean {gap.mean().item():.3g} (relative)", flush=True)
    del got, want, gap
    torch.cuda.empty_cache()

    groups = {"tempo": slice(0, 1), "zcr": slice(1, 2), "timbral": slice(2, 8),
              "loudness": slice(8, 10), "chroma": slice(10, 23)}
    for routes, need in (
        (Routes(timbral="flat"), {"timbral_flat": 1}),
        (Routes(timbral="mags", tempo="mags"), {"frame_dft_mags": 2}),
        (Routes(chroma_stft="framed"), {"ct_frames": 1}),
    ):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = analyze_batch(batch, lengths, version=2, device="cuda", routes=routes)
        first_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        analyze_batch(batch, lengths, version=2, device="cuda", routes=routes)
        warm_s = time.perf_counter() - t0
        dist = {k: float(np.abs(out[:, sl] - v2[:, sl]).max()) for k, sl in groups.items()}
        print(f"route {routes}: first {first_s:.3f} s, warm {warm_s:.3f} s; launches {launches}; "
              f"max distance to the default route {dist} [{card}]", flush=True)
        if any(launches.get(k, 0) != v for k, v in need.items()):
            fail(f"route {routes}: launches {launches}, expected {need}")
        if out.shape != v2.shape or not np.isfinite(out).all():
            fail(f"route {routes}: features {out.shape}, finite {np.isfinite(out).all()}")
        if dist["tempo"] != 0.0 or dist["zcr"] != 0.0 or dist["loudness"] != 0.0:
            fail(f"route {routes}: tempo, zcr or loudness differ from the default route's")
        if dist["chroma"] > 1e-5:
            fail(f"route {routes}: chroma {dist['chroma']:.3g} from the default route's (limit 1e-5)")
        if routes.timbral == "fft" and dist["timbral"] != 0.0:
            fail(f"route {routes}: timbral features changed")
        if routes.timbral == "flat":
            results["timbral_flat"]["launches"] = launches["timbral_flat"]
            flat_batch = out
    # flatness (features 6, 7: mean and std) of the "flat" route against the
    # FFT-structured default and the CPU f64 path
    d_fft = np.abs(flat_batch[:, 6:8] - v2[:, 6:8]).max()
    d_cpu = np.abs(flat_batch[0, 6:8] - cpu0[6:8]).max()
    d_cpu_fft = np.abs(v2[0, 6:8] - cpu0[6:8]).max()
    print(f"flatness drift, 8 x 5-min: flat vs fft route max {d_fft:.3g} over the batch; song 0 vs "
          f"CPU f64: flat {d_cpu:.3g}, fft {d_cpu_fft:.3g}", flush=True)
    n = piano.shape[0]
    p_fft = analyze_samples(piano, n, 2, device="cuda").cpu().numpy()
    p_flat = analyze_samples(piano, n, 2, device="cuda", routes=Routes(timbral="flat")).cpu().numpy()
    p_cpu = analyze_samples(piano, n, 2, device="cpu").cpu().numpy()
    print(f"flatness drift, piano.wav: flat vs fft route {np.abs(p_flat[6:8] - p_fft[6:8]).max():.3g}; "
          f"vs CPU f64: flat {np.abs(p_flat[6:8] - p_cpu[6:8]).max():.3g}, fft "
          f"{np.abs(p_fft[6:8] - p_cpu[6:8]).max():.3g}; all timbral features, flat vs CPU f64 "
          f"{np.abs(p_flat[2:8] - p_cpu[2:8]).max():.3g} (contract 1e-4, reported)", flush=True)


def longsong_phase(rng, record, results, song21, card: str, minutes: float = 60.0,
                   shards: int = 8) -> None:
    """The time-sharded analyzer at full width (see the module docstring)."""
    import tempfile

    from bliss_tpu_torch.io.batch import analyze_paths_batched
    from bliss_tpu_torch.models import chroma as CH
    from bliss_tpu_torch.models.analyzer import analyze_batch, analyze_samples, bucket_length
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.ops import dft_kernels as DK
    from bliss_tpu_torch.ops import reductions as RD
    from bliss_tpu_torch.ops import tuning_kernels as TK
    from bliss_tpu_torch.ops.windows import n_frames_stft, n_frames_strided
    from bliss_tpu_torch.parallel import longsong as LS
    from bliss_tpu_torch.song import Song
    from bliss_tpu_torch.tables import default_tables

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    n = int(round(minutes * 60 * 22050))
    song = synth_song(rng, n)
    tpad = bucket_length(n, 1 << 17)
    print(f"long song: {minutes:g} min = {n} samples (bucket {tpad}), {shards} shards, data in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- the sharded path's kernels at this song's shapes ------------------
    tab = default_tables().on(dev)
    (ext,), shard_len = LS._extended_shards(song, n, tpad, shards, [dev])
    fps_max, hps, fps_t = shard_len // LS.HOP + 2, shard_len // LS.B_HOP, shard_len // LS.T_HOP
    base = LS._shard_base(0, shards, shard_len, dev)
    # the beat tracker on the song's gathered series (B = 1), as the sharded
    # path runs it
    series = LS._tempo_series([ext], shard_len, n)
    held = hold_beat_track(*series, f"{minutes:g}-min song, gathered series", card)
    results["beat_track"][f"{minutes:g}min_song"] = {k: held[k] for k in ("ms", "plain_ms", "step_us")}
    held = hold_block_inputs(series[0], series[2], f"{minutes:g}-min song, gathered series", card)
    results["block_inputs"][f"{minutes:g}min_song"] = {
        k: held[k] for k in ("ms", "call_ms", "plain_ms", "rows")}
    del series, held
    f_lo = (torch.arange(shards, device=dev) * shard_len + LS.HOP - 1) // LS.HOP
    # one launch a shard: the first shard (reflection around sample 0), the
    # last (reflection around the song's end), and one inside
    for i in (0, shards // 2, shards - 1):
        frames = LS._chroma_local_frames(ext[i], base[i], f_lo[i], fps_max, n)
        held = hold_ct_frames(frames, f"shard {i} of {shards}")
        del frames
    record(
        "ct_frames", "bliss_tpu_torch/csrc/ct_stft.cu", "bliss_tpu/ops/pallas_dft.py:862",
        held["err"], held["ms"], held["plain_ms"], held["nbytes"], held["ops"], held["library_ms"],
    )
    held = hold_frame_dft(ext, LS.B_HOP, 2048 - LS.HALO, hps + 7, f"{shards} shards hop 256")
    record(
        "frame_dft_mags", "bliss_tpu_torch/csrc/frame_dft.cu", "bliss_tpu/ops/pallas_dft.py:53",
        held["err"], held["ms"], held["plain_ms"], held["nbytes"], held["ops"], held["library_ms"],
    )
    # timbral_fft over the halo-extended shards: the first frame of a shard
    # starts HALO - 384 samples into it
    n_valid_t = int(n_frames_strided(n, LS.T_WIN, LS.T_HOP))
    hold_timbral_fft(ext, fps_t, (LS.T_WIN - LS.T_HOP) - LS.HALO, f"{shards} shards",
                     torch.arange(shards * fps_t, device=dev).unsqueeze(0) < n_valid_t)
    t_ms = time_ms(lambda: DK.timbral_fft(ext, fps_t, offset=(LS.T_WIN - LS.T_HOP) - LS.HALO), 10)
    t_bound = bound(ext.numel() * 4 + shards * fps_t * 5 * 4, shards * fps_t * timbral_frame_ops())
    print(f"  timbral_fft {shards} shards: {t_ms:.4f} ms (bound {t_bound[0]:.4f} by {t_bound[1]})",
          flush=True)
    # the tuning planes of the sharded chroma stage: the global median by
    # counting rounds against a sort of all shards' peaks, and the histogram
    spectrum, valid = LS._chroma_spectrum(ext, 0, shard_len, fps_max, n, torch.float32, tab)
    pitches, pmags, peak = CH.pip_track(spectrum, valid, LS.WINDOW)
    pos = peak & (pitches > 0.0)
    med = LS._global_median_midpoint([pmags], [pos])
    med_sort = RD.masked_quantile_midpoint(pmags.reshape(1, -1), pos.reshape(1, -1))[0]
    if not torch.equal(med, med_sort):
        fail(f"long song: global median {med.item()!r} != sort median {med_sort.item()!r}")
    # what the sharded path pays for that median (2 x 32 eager counting
    # rounds over the whole plane) beside its whole chroma stage, and what
    # the radix select's key entry takes for the same plane as one song
    one_v, one_m = pmags.transpose(1, 2).view(1, -1), pos.transpose(1, 2).view(1, -1)
    if not torch.equal(TK.masked_quantile_midpoint_radix(one_v, one_m)[0], med):
        fail("long song: radix select over the sharded plane != the global median")
    gm_ms = time_ms(lambda: LS._global_median_midpoint([pmags], [pos]), 3)
    radix_ms = time_ms(lambda: TK.masked_quantile_midpoint_radix(one_v, one_m), 10)
    n_plane = pmags.numel()
    del pitches, pmags, peak, pos, one_v, one_m
    chroma_ms = time_ms(lambda: LS._chroma_raw([ext], shard_len, fps_max, n, torch.float32), 2)
    print(f"  sharded chroma stage {chroma_ms:.3f} ms, of it _global_median_midpoint alone "
          f"{gm_ms:.3f} ms ({100 * gm_ms / chroma_ms:.1f}%; 64 counting rounds over {n_plane} "
          f"elements); the radix select (4 x bisect8_keys) on the same plane {radix_ms:.4f} ms "
          f"[{card}]", flush=True)
    (bin_plane,), _ = LS._tuning_planes([spectrum], [valid])
    hist, histp = TK.histogram_int_plane(bin_plane, 100), TK.histogram_int_plane_plain(bin_plane, 100)
    if not torch.equal(hist, histp):
        fail("long song: histogram_int_plane != plain on the sharded tuning plane")
    h_ms = time_ms(lambda: TK.histogram_int_plane(bin_plane, 100), 10)
    h_bound = bound(bin_plane.numel() * 4 + shards * 400, bin_plane.numel())
    print(f"  sharded tuning plane {list(bin_plane.shape)}: global median == sort median "
          f"({med.item():.6g}), histogram_int_plane exact ({int(hist.sum())} peaks), {h_ms:.4f} ms "
          f"(bound {h_bound[0]:.4f} by {h_bound[1]})", flush=True)
    del ext, spectrum, valid, bin_plane, hist, histp
    torch.cuda.empty_cache()

    # ---- the sharded analyzer through its entry point ----------------------
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        first = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        warm = time.perf_counter() - t0
        return out, first, warm, torch.cuda.max_memory_allocated() / 1e9, launches

    _build.reset_launches()
    sharded, first_s, warm_s, peak, launches = timed(
        lambda: LS.sharded_analyze_samples(song, n, 2, shards=shards, device="cuda")
    )
    print(f"  sharded ({shards} shards): first {first_s:.3f} s, warm {warm_s:.3f} s, peak "
          f"{peak:.2f} GB; launches {launches} [{card}]", flush=True)
    need = ("ct_frames", "frame_dft_mags", "timbral_fft", "histogram_int_plane", "beat_track",
            "block_inputs")
    if any(launches.get(k, 0) < 1 for k in need) or launches["block_inputs"] != 1:
        fail(f"long song: kernels not launched on the sharded path (counts {launches})")
    for k in ("ct_frames", "frame_dft_mags"):
        results[k]["launches"] = launches[k]
    buf = np.zeros((1, tpad), np.float32)
    buf[0, :n] = song
    _build.reset_launches()
    bucketed, b_first, b_warm, b_peak, b_launches = timed(
        lambda: analyze_batch(buf, [n], version=2, device="cuda")[0]
    )
    print(f"  bucketed (B = 1): first {b_first:.3f} s, warm {b_warm:.3f} s, peak {b_peak:.2f} GB; "
          f"launches {b_launches} [{card}]", flush=True)
    if b_launches.get("beat_track", 0) != 1 or b_launches.get("block_inputs", 0) != 1:
        fail(f"long song: the bucketed route launched beat_track {b_launches.get('beat_track', 0)} and "
             f"block_inputs {b_launches.get('block_inputs', 0)} times")
    x1 = torch.as_tensor(buf, device=dev)
    lens1 = torch.as_tensor([n], device=dev)
    nfc = int(n_frames_stft(tpad, LS.HOP))
    mask1 = torch.arange(nfc, device=dev) < n_frames_stft(lens1, LS.HOP).unsqueeze(-1)
    print(f"  the bucketed route's {b_warm:.3f} s by stage:", flush=True)
    stage_breakdown(x1, lens1, mask1, warm_up=False)
    del x1, lens1, mask1
    gap = np.abs(sharded - bucketed)
    print(f"  sharded vs bucketed: max {gap.max():.3g} (feature {int(gap.argmax())}), tempo "
          f"{sharded[0]:.7f} vs {bucketed[0]:.7f}; per feature {[float(f'{g:.2g}') for g in gap]}",
          flush=True)
    if sharded.shape != (23,) or not np.isfinite(sharded).all():
        fail(f"long song: features {sharded.shape}, finite {np.isfinite(sharded).all()}")
    if sharded[0] != bucketed[0]:
        fail("long song: sharded tempo differs from the bucketed analyzer's")
    if gap.max() > 1e-4:
        fail(f"long song: sharded vs bucketed {gap.max():.3g} > 1e-4 (feature {int(gap.argmax())})")
    if gap.max() > 2e-5:
        print(f"  FAULT (within the 1e-4 contract): feature {int(gap.argmax())} is {gap.max():.3g} "
              f"from the bucketed analyzer's, above the 2e-5 of the CPU tests", flush=True)
    del buf

    # ---- the multi-device phase: the song's shards over [cuda:0, cuda:0] ---
    _build.reset_launches()
    listed, l_first, l_warm, l_peak, l_launches = timed(
        lambda: LS.sharded_analyze_samples(song, n, 2, shards=shards, devices=[dev, dev])
    )
    # a launch a piece of shards, a launch a shard, a launch a song
    want = {k: 2 * launches[k] for k in ("frame_dft_mags", "timbral_fft", "histogram_int_plane")}
    want.update({k: launches[k] for k in ("ct_frames", "beat_track", "block_inputs")})
    gap = np.abs(listed - sharded)
    print(f"multi-device: {minutes:g}-min song, {shards} shards over [cuda:0, cuda:0] "
          f"({shards // 2} an entry): first {l_first:.3f} s, warm {l_warm:.3f} s, peak {l_peak:.2f} "
          f"GB (one entry: warm {warm_s:.3f} s, peak {peak:.2f} GB); tempo "
          f"{'equal' if listed[0] == sharded[0] else 'DIFFERS'}, "
          f"{'bit for bit' if not gap.any() else 'NOT bit for bit'}, largest gap {gap.max():.3g} "
          f"(feature {int(gap.argmax())}); launches {l_launches} [{card}]", flush=True)
    if any(l_launches.get(k, 0) != v for k, v in want.items()):
        fail(f"long song over [cuda:0, cuda:0]: launches {l_launches}, expected {want}")
    if listed[0] != sharded[0] or gap.max() > 2e-5:
        fail(f"long song over [cuda:0, cuda:0]: {gap.max():.3g} from one entry's (limit 2e-5, "
             "tempo equal)")
    del song, listed

    # ---- a 21-minute song: the card's sharded vector vs the CPU f64 path ---
    n21 = song21.shape[0]
    got21 = LS.sharded_analyze_samples(song21, n21, 2, shards=shards, device="cuda")
    t0 = time.perf_counter()
    cpu21 = analyze_samples(song21, n21, 2, device="cpu").cpu().numpy()
    d = np.abs(got21 - cpu21).max()
    same_argmax = int(np.argmax(got21[10:])) == int(np.argmax(cpu21[10:]))
    print(f"  21-min song sharded on the card vs CPU f64: max {d:.3g} (limit 2e-2), dominant chroma "
          f"{'agrees' if same_argmax else 'DIFFERS'} (CPU run {time.perf_counter() - t0:.1f} s)",
          flush=True)
    if d > 2e-2 or not same_argmax:
        fail("long song: 21-minute synthetic song drift")

    # ---- the driver's default long-song route over a file -----------------
    # no `longsong_samples`: over two entries the 21-minute song (above the
    # JAX driver's 20-minute bound) is sharded one shard an entry, over one
    # entry it joins a bucket
    calls = []
    sharded_entry = LS.sharded_analyze_samples

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return sharded_entry(*args, **kwargs)

    LS.sharded_analyze_samples = spy
    try:
        with tempfile.TemporaryDirectory() as tmp:
            wav = pathlib.Path(tmp) / "long.wav"
            with wave.open(str(wav), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(22050)
                w.writeframes(np.clip(song21 * 32767, -32768, 32767).astype("<i2").tobytes())
            _build.reset_launches()
            t0 = time.perf_counter()
            routed = dict(analyze_paths_batched(DECODER, [wav], devices=[dev, dev]))[wav]
            routed_s = time.perf_counter() - t0
            r_launches, r_calls = dict(_build.LAUNCHES), list(calls)
            _build.reset_launches()
            t0 = time.perf_counter()
            plain = dict(analyze_paths_batched(DECODER, [wav], devices=[dev]))[wav]
            plain_s = time.perf_counter() - t0
            p_launches, p_calls = dict(_build.LAUNCHES), calls[len(r_calls):]
    finally:
        LS.sharded_analyze_samples = sharded_entry
    if not isinstance(routed, Song) or not isinstance(plain, Song):
        fail(f"long-song file route: {routed!r} {plain!r}")
    rv, pv = routed.analysis.as_arr1(), plain.analysis.as_arr1()
    d = np.abs(rv - pv).max()
    r_shards = [c.get("shards") for c in r_calls]
    print(f"  analyze_paths_batched over a 21-min WAV ({n21} samples), default route: over "
          f"[cuda:0, cuda:0] {len(r_calls)} sharded call(s) of {r_shards} shards in {routed_s:.2f} s, "
          f"over [cuda:0] {len(p_calls)} sharded call(s), bucketed in {plain_s:.2f} s (decode "
          f"included); vectors max {d:.3g} (limit 2e-5), tempo "
          f"{'equal' if rv[0] == pv[0] else 'DIFFERS'} [{card}]", flush=True)
    if r_shards != [2] or p_calls:
        fail(f"default long-song route: sharded calls over two entries {r_shards}, over one "
             f"{len(p_calls)}")
    if r_launches.get("ct_frames", 0) < 1 or p_launches.get("ct_frames", 0):
        fail(f"long-song file route: launches routed {r_launches}, bucketed {p_launches}")
    if d > 2e-5 or rv[0] != pv[0]:
        fail(f"long-song file route: routed vs bucketed {d:.3g} (limit 2e-5, tempo equal)")



# ---------------------------------------------------------------------------
# the library and its playlists
# ---------------------------------------------------------------------------

#: The library phase's size: BASELINE.json's playlist configuration.
LIBRARY_SONGS = 100_000
LIBRARY_SEEDS = 9


def library_features(seed: int):
    """The library phase's `[100k, 23]` features and the generator, drawn on
    (`bliss_tpu_torch/benches/playlist_bench.py:library_features`)."""
    from bliss_tpu_torch.benches.playlist_bench import library_features as features

    return features(seed, LIBRARY_SONGS)


def build_library(folder: pathlib.Path, seed: int):
    """The 100k-song Version2 store of the playlist bench
    (`bliss_tpu_torch/benches/playlist_bench.py:build_library`), written
    through the port's `Library` on the card: the config and each row's
    feature-vector group."""
    from bliss_tpu_torch.benches.playlist_bench import build_library as build

    return build(folder, seed, LIBRARY_SONGS, device="cuda")


def f64_seed_distances(mat: torch.Tensor, seed_rows, kind: str, m=None) -> np.ndarray:
    """Each row's f64 distance to the seed rows, summed over the seeds."""
    x = mat.double()
    out = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    for r in seed_rows:
        s = x[r]
        if kind == "cosine":
            out += 1.0 - (x @ s) / (x.norm(dim=1) * s.norm())
        else:
            d = x - s
            out += torch.sqrt(((d @ torch.as_tensor(m, dtype=torch.float64, device=x.device)) * d).sum(1))
    return out.cpu().numpy()


def hold_query(label, lib, cpu_lib, path, distance, d64, failures) -> int:
    """One query on the card against the CPU route over the same store.
    Both sum each distance in one order and round each square root once,
    so the order before dedup (`_fused_order_dedup`), its verdicts and the
    playlist must be equal; at each position the two orders' f64
    distances within 1e-5 (relative), and the card's order must not step
    back by more than that in f64. Returns the card's verdict count."""
    from bliss_tpu_torch import playlist as P

    index = lib._matrix_cache.path_index
    initial = [lib.song_from_path(path)]
    mask = np.ones(lib._matrix_cache.n, bool)
    mask[index[path]] = False
    go, gs = lib._fused_order_dedup(initial, distance, mask)
    co, cs = cpu_lib._fused_order_dedup(initial, distance, mask)
    if len(go) != len(co) or set(go.tolist()) != set(co.tolist()):
        failures.append(f"{label}: the card's and the CPU's orders hold other rows")
        return int(gs.sum())
    if not np.array_equal(go, co) or not np.array_equal(gs, cs):
        failures.append(f"{label}: the order differs at {int((go != co).sum())} positions, "
                        f"the verdicts at {int((gs != cs).sum())}")
    a, b = d64[go], d64[co]
    if (np.abs(a - b) > 1e-5 * np.maximum(np.abs(a), np.abs(b))).any():
        failures.append(f"{label}: positions apart by more than 1e-5 in f64")
    if (a[:-1] - a[1:] > 1e-5 * np.abs(a[:-1])).any():
        failures.append(f"{label}: the card's order steps back by more than 1e-5 in f64")
    got = lib.playlist_from_custom([path], distance, P.closest_to_songs, True)
    want = cpu_lib.playlist_from_custom([path], distance, P.closest_to_songs, True)
    if [str(s.bliss_song.path) for s in got] != [str(s.bliss_song.path) for s in want]:
        failures.append(f"{label}: the playlists differ ({len(got)} songs on the card, "
                        f"{len(want)} on the CPU)")
    return int(gs.sum())


def hold_chain(lib, rows, failures, check_steps: int = 2000) -> str:
    """The song_to_song walk the query returned (`rows`: the first pick,
    then the chain) against the eager step loop on the card, index for
    index; its first `check_steps` picks against the f64 minimum over the
    rows still live; and the CPU's eager loop over as many steps."""
    from bliss_tpu_torch import playlist as P

    x = lib._device_matrix()
    rows_t = torch.as_tensor(rows, device=x.device)
    first, chain = rows[0], rows_t[1:]
    live = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    live[rows_t] = True
    live[first] = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = P._greedy_chain_plain(x, first, P.euclidean_distance, live.clone(), len(rows) - 1)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    if not torch.equal(eager, chain):
        k = int((eager != chain).nonzero()[0])
        failures.append(f"song_to_song: the graph chain leaves the eager loop at step {k}")
    # f64 minimum over the live rows, a block of steps at a time
    pos = torch.full((x.shape[0],), -1, dtype=torch.int64, device=x.device)
    pos[rows_t] = torch.arange(len(rows), device=x.device)
    x64 = x.double()
    worst = 0.0
    steps = min(check_steps, len(rows) - 1)
    for start in range(1, steps + 1, 250):
        t = torch.arange(start, min(start + 250, steps + 1), device=x.device)
        d = torch.cdist(x64[rows_t[t - 1]], x64, compute_mode="donot_use_mm_for_euclid_dist")
        d = torch.where(pos[None, :] >= t[:, None], d, torch.inf)
        best = d.min(1).values
        picked = d.gather(1, rows_t[t][:, None])[:, 0]
        rel = ((picked - best) / best.clamp_min(1e-300)).max().item()
        worst = max(worst, rel)
    if worst > 1e-5:
        failures.append(f"song_to_song: a pick {worst:.3g} above the f64 minimum (limit 1e-5)")
    cpu = P._greedy_chain_plain(x.cpu(), first, P.euclidean_distance, live.cpu(), steps)
    differ = (cpu != chain[:steps].cpu()).nonzero()
    agree = steps if len(differ) == 0 else int(differ[0])
    return (f"graph == eager loop over {len(rows) - 1} steps (eager {eager_s:.2f} s); first "
            f"{steps} picks within {worst:.3g} of the f64 minimum; card and CPU chains agree "
            f"for the first {agree} of {steps} steps")


def library_phase(seed: int, card: str, files: dict) -> None:
    """The playlist engine and the SQLite Library on the card at a 100k-song
    store (BASELINE.json's playlist configuration), each query held
    against the same store opened with device="cpu"; then the user's round
    trip `update_library` -> `playlist_from` on three fixture files."""
    import gc
    import shutil

    from bliss_tpu_torch import playlist as P
    from bliss_tpu_torch.features import FeaturesVersion
    from bliss_tpu_torch.library import BaseConfig, Library
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.song import Song

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    folder = REPO / "tmp" / "smoke_library"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    failures: list = []
    try:
        t0 = time.perf_counter()
        config, group = build_library(folder, seed)
        build_s = time.perf_counter() - t0
        paths = [f"/library/{i // 1000:03d}/song_{i:06d}.flac" for i in range(LIBRARY_SONGS)]
        seeds = [paths[int(i)] for i in np.random.default_rng(seed + 1).choice(
            LIBRARY_SONGS, LIBRARY_SEEDS, replace=False)]

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        # cold: SQLite load, 100k LibrarySongs, upload, query; then the
        # host load and the upload alone, on the cache dropped and built again
        lib = Library(BaseConfig.from_path(config.config_path), device="cuda")
        cold_s = timed(lambda: lib.playlist_from([seeds[0]]))[1]  # no song kept alive
        lib._invalidate_matrix_cache()
        gc.collect()
        _, load_s = timed(lib._cached_library)
        _, upload_s = timed(lib._device_matrix)
        cpu_lib = Library(BaseConfig.from_path(config.config_path), device="cpu")
        cpu_lib._cached_library()
        initial = [lib.song_from_path(seeds[0])]
        mask = np.ones(LIBRARY_SONGS, bool)
        mask[lib._matrix_cache.path_index[seeds[0]]] = False
        fused, device_s = timed(lambda: lib._fused_order_dedup(initial, P.euclidean_distance, mask))
        _, walk_s = timed(lambda: lib._materialize_deduped(
            initial, P.euclidean_distance, fused, lib._matrix_cache.songs))
        print(f"library: {LIBRARY_SONGS} songs x 23 features written in {build_s:.2f} s; cold "
              f"playlist_from {cold_s:.3f} s, of it on the host SQLite + {LIBRARY_SONGS} "
              f"LibrarySongs {load_s:.3f} s, upload {upload_s * 1e3:.2f} ms; a warm query: "
              f"device order + dedup verdicts {device_s * 1e3:.2f} ms, host dedup walk + "
              f"playlist {walk_s * 1e3:.2f} ms [{card}]", flush=True)

        dev = lib._device_matrix()
        index = lib._matrix_cache.path_index
        # exact f32 ties between unrelated rows' seed distances: a tie inside
        # an exact-copy pair's index range splits the pair in the stable
        # order, so a route that rounded a distance otherwise would dedup
        # otherwise
        i0 = index[seeds[0]]
        d32 = P._batched_mahalanobis(dev, dev[i0 : i0 + 1], torch.eye(23, device=dev.device))
        d32 = d32[: lib._matrix_cache.n].cpu().numpy()
        by = np.lexsort((group, d32))
        ties = int(((d32[by][1:] == d32[by][:-1]) & (group[by][1:] != group[by][:-1])).sum())
        print(f"  f32 euclidean distances to {seeds[0]} on the card: {ties} equal pairs of rows "
              "with unequal vectors (adjacent in a sort by distance)", flush=True)
        queries = [
            ("playlist_from", P.euclidean_distance, "mahalanobis", np.eye(23)),
            ("mahalanobis (V2)", FeaturesVersion.VERSION2.distance_metric(), "mahalanobis",
             FeaturesVersion.VERSION2.feature_weights()),
            ("cosine", P.cosine_distance, "cosine", None),
        ]
        for label, distance, kind, m in queries:
            times, kept, verdicts = [], [], []
            for path in seeds:
                got, s = timed(lambda: lib.playlist_from_custom(
                    [path], distance, P.closest_to_songs, True))
                times.append(s)
                kept.append(len(got))
                d64 = f64_seed_distances(dev, [index[path]], kind, m)
                verdicts.append(hold_query(f"{label} from {path}", lib, cpu_lib, path, distance,
                                           d64, failures))
            print(f"  {label}: p50 {np.median(times) * 1e3:.2f} ms over {len(times)} seeds (min "
                  f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); {min(kept)}-{max(kept)} "
                  f"songs kept, {min(verdicts)}-{max(verdicts)} dedup verdicts a query; order, "
                  f"verdicts and playlist equal to the CPU route's [{card}]", flush=True)

        times, rows = [], None
        for path in seeds[:2]:
            got, s = timed(lambda: lib.playlist_from_custom(
                [path], P.euclidean_distance, P.song_to_song, False))
            times.append(s)
            if rows is None:
                rows = [index[str(x.bliss_song.path)] for x in got[1:]]
                if len(got) != LIBRARY_SONGS or len(set(rows)) != LIBRARY_SONGS - 1:
                    failures.append(f"song_to_song: {len(got)} songs, {len(set(rows))} distinct")
        chain_note = hold_chain(lib, rows, failures)
        print(f"  song_to_song (euclidean, no dedup): p50 {np.median(times):.3f} s over "
              f"{len(times)} seeds ({', '.join(f'{t:.3f}' for t in times)}); {chain_note} "
              f"[{card}]", flush=True)

        album = f"album {LIBRARY_SONGS // 24}"
        got, album_s = timed(lambda: lib.album_playlist_from(album, 3))
        want = cpu_lib.album_playlist_from(album, 3)
        if [str(s.bliss_song.path) for s in got] != [str(s.bliss_song.path) for s in want]:
            failures.append("album_playlist_from: the card's playlist differs from the CPU's")
        print(f"  album_playlist_from({album!r}, 3): {len(got)} songs in {album_s:.3f} s, "
              f"equal to the CPU route's", flush=True)
        del lib, cpu_lib, dev

        # the user's round trip: update_library on files, then a playlist
        trip = [DATA / "piano.flac", DATA / "s16_mono_22_5kHz.flac", DATA / "testcue.cue"]
        user = Library(BaseConfig(config_path=folder / "user" / "config.json",
                                  database_path=folder / "user" / "songs.db"), DECODER,
                       device="cuda")
        _build.reset_launches()
        _, update_s = timed(lambda: user.update_library(trip))
        launches = dict(_build.LAUNCHES)
        if any(launches.get(k, 0) < 1 for k in FUSED_PATH):
            failures.append(f"update_library did not launch every kernel of the path: {launches}")
        stored = user.songs_from_library()
        worst = 0.0
        for s in stored:
            key = str(s.bliss_song.path)
            ref = files.get(key)
            if not isinstance(ref, Song):
                failures.append(f"round trip: {key} has no vector from the files phase")
                continue
            worst = max(worst, float(np.abs(s.bliss_song.analysis.as_arr1()
                                            - ref.analysis.as_arr1()).max()))
        if len(stored) != 5 or worst > 1e-4:
            failures.append(f"round trip: {len(stored)} songs stored, {worst:.3g} from the "
                            "files phase's vectors (limit 1e-4)")
        failed = [str(f.song_path) for f in user.get_failed_songs()]
        if failed != [str(DATA / "testcue.cue")]:
            failures.append(f"round trip: failed songs {failed}")
        playlist, pl_s = timed(lambda: user.playlist_from([str(trip[0])]))
        if str(playlist[0].bliss_song.path) != str(trip[0]) or not all(
            np.isfinite(s.bliss_song.analysis.as_arr1()).all() for s in playlist
        ):
            failures.append("round trip: playlist_from does not start at its seed")
        print(f"  update_library on piano.flac, s16_mono_22_5kHz.flac, testcue.cue: "
              f"{update_s:.2f} s, {len(stored)} songs within {worst:.3g} of the files phase, "
              f"failed {[pathlib.Path(p).name for p in failed]}, launches {launches}; "
              f"playlist_from {pl_s * 1e3:.2f} ms -> {len(playlist)} songs", flush=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"  library phase: {time.perf_counter() - t_phase:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({base_gb:.3f} GB held before "
          f"the phase) [{card}]", flush=True)
    if failures:
        fail("library phase: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# the multi-device phase: device lists on the one card, and two processes
# ---------------------------------------------------------------------------

#: Feature gap allowed where the cluster's rounds pad a song to another
#: length than the files phase's buckets (a few f32 ulps of a feature in
#: [-1, 1]); row groups, shard pieces and processes are held bit for bit.
LISTED_ATOL = 1e-6


def wall_s(fn):
    """(result, seconds) of `fn()`, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hold_per_entry(label: str, one: dict, many: dict, entries: int, kernels) -> None:
    """Each kernel of a path launched once for every list entry: over
    `entries` entries of cuda:0 its count is `entries` times the one-entry
    run's (which must be at least one)."""
    bad = {
        k: (one.get((k, "cuda:0"), 0), many.get((k, "cuda:0"), 0)) for k in kernels
        if not one.get((k, "cuda:0")) or many.get((k, "cuda:0"), 0) != entries * one[(k, "cuda:0")]
    }
    if bad:
        fail(f"{label}: launches (one entry, {entries} entries) {bad}")


def multidevice_batch(batch, lengths, card: str) -> None:
    """`sharded_analyze_batch` on the 8 x 5-min batch over `make_mesh()` and
    over [cuda:0, cuda:0] against `analyze_batch`, each kernel counted on
    each entry."""
    from bliss_tpu_torch.models.analyzer import analyze_batch
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.parallel.mesh import make_mesh, sharded_analyze_batch

    dev0 = torch.device("cuda", 0)
    _build.reset_launches()
    want, one_s = wall_s(lambda: analyze_batch(batch, lengths, device="cuda"))
    one = dict(_build.LAUNCHES_ON)
    again = analyze_batch(batch, lengths, device="cuda")
    repeat = np.abs(again - want).max()
    for label, mesh in (("make_mesh()", make_mesh()), ("[cuda:0, cuda:0]", [dev0, dev0])):
        sharded_analyze_batch(mesh, batch, lengths)  # warm
        _build.reset_launches()
        got, s = wall_s(lambda: sharded_analyze_batch(mesh, batch, lengths))
        hold_per_entry(f"sharded_analyze_batch over {label}", one, _build.LAUNCHES_ON, len(mesh),
                       FUSED_PATH)
        gap = np.abs(got - want)
        print(f"multi-device: sharded_analyze_batch over {label} ({len(mesh)} entries, "
              f"{batch.shape[0] // len(mesh)} rows each): {s:.3f} s, analyze_batch {one_s:.3f} s; "
              f"{'bit for bit' if not gap.any() else 'NOT bit for bit'}, largest gap "
              f"{gap.max():.3g} (feature {int(gap.argmax()) % gap.shape[1]}; analyze_batch against "
              f"itself {repeat:.3g}); every kernel once an entry [{card}]", flush=True)
        if gap.any():
            fail(f"sharded_analyze_batch over {label}: not bit for bit ({gap.max():.3g})")


def multidevice_top_k(seed: int, card: str) -> None:
    """`sharded_top_k` (k = 100) and `sharded_closest_distances` over the
    library phase's 100k-row matrix on 1 and 3 entries of cuda:0 (100k is
    no multiple of 3), against the CPU: the same indices, distances within
    1e-5 (relative)."""
    from bliss_tpu_torch.parallel.mesh import place_rows, sharded_closest_distances, sharded_top_k

    feats, _ = library_features(seed)
    seeds = feats[[11, 70_001]]
    cpu = [torch.device("cpu")]
    want_idx, want_d = sharded_top_k(cpu, feats, seeds, 100)
    want_all = sharded_closest_distances(cpu, feats, seeds)
    dev0 = torch.device("cuda", 0)
    for mesh in ([dev0], [dev0] * 3):
        sharded_top_k(mesh, feats, seeds, 100)  # warm
        (idx, d), s = wall_s(lambda: sharded_top_k(mesh, feats, seeds, 100))
        dist, dist_s = wall_s(lambda: sharded_closest_distances(mesh, feats, seeds))
        placed = place_rows(mesh, feats)
        (pidx, _), placed_s = wall_s(
            lambda: sharded_top_k(mesh, placed, seeds, 100, n_real=LIBRARY_SONGS))
        rel = max(np.abs(d - want_d).max() / np.abs(want_d).max(),
                  np.abs(dist - want_all).max() / np.abs(want_all).max())
        print(f"multi-device: sharded_top_k (k = 100) over {len(mesh)} entries of cuda:0: "
              f"{s * 1e3:.2f} ms with the upload, {placed_s * 1e3:.2f} ms on the placed matrix; "
              f"sharded_closest_distances {dist_s * 1e3:.2f} ms; indices "
              f"{'equal to' if np.array_equal(idx, want_idx) and np.array_equal(pidx, want_idx) else 'NOT'} "
              f"the CPU's, distances within {rel:.3g} [{card}]", flush=True)
        if not (np.array_equal(idx, want_idx) and np.array_equal(pidx, want_idx)) or rel > 1e-5:
            fail(f"sharded_top_k over {len(mesh)} entries: other rows than the CPU's or {rel:.3g} > 1e-5")


def scaling_phase(seed: int, card: str) -> None:
    """The scaling bench's lists (`bliss_tpu_torch/benches/scaling_bench.py`,
    its card sizes: 8 x 5-min songs, 100,000 library rows and 7.5 minutes of
    one song an entry, made from `seed`) over 1, 2 and 4 entries of cuda:0,
    one warm call a path: every list's features, top-k, chroma and
    long-song vector bit for bit against one entry's, finite."""
    from bliss_tpu_torch.benches import scaling_bench as SB

    rows = SB.run_lists("cuda:0", (1, 2, 4), SB.CARD_SIZES, repeat=1, seed=seed,
                        log=lambda line, **_: print(f"scaling: {line} [{card}]", flush=True))
    bad = [r["entries"] for r in rows if not (r["bit_for_bit"] and r["finite"])]
    if bad:
        fail(f"scaling: lists of {bad} entries not bit for bit with one entry, or not finite "
             f"({[r['held'] for r in rows]})")


def cluster_phase(seed: int, batch, lengths, files: dict, card: str, timeout: float = 400.0) -> None:
    """Two processes of one gloo group on tcp://127.0.0.1, both on cuda:0,
    each `python3 chip_smoke.py --distributed-worker RANK`: a ragged
    `analyze_batch_distributed` (3 and 5 of the 5-min songs),
    `top_k_distributed` over the 100k matrix split 60k/40k, and
    `update_library_distributed` of the default files into one store; each
    held against the one-process route."""
    import shutil
    import socket
    import sqlite3

    from bliss_tpu_torch.models.analyzer import analyze_batch
    from bliss_tpu_torch.parallel.mesh import sharded_top_k
    from bliss_tpu_torch.song import Song

    work = REPO / "tmp" / "smoke_cluster"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        np.save(work / "batch.npy", batch)
        np.save(work / "lengths.npy", lengths)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--distributed-worker", str(rank),
                 "--port", str(port), "--workdir", str(work), "--seed", str(seed),
                 "--decoder", DECODER.__name__],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in range(2)
        ]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            fail(f"cluster: a worker ran past {timeout:g} s")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        cluster_s = time.perf_counter() - t0
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            if proc.returncode != 0 or f"WORKER_OK rank={rank}" not in out:
                fail(f"cluster: worker {rank} exited {proc.returncode}:\n{out[-3000:]}")
        reports = [json.loads(out.split("WORKER_REPORT ", 1)[1].splitlines()[0]) for out in outs]

        # the ragged batch against one process's analyze_batch of the 8 rows
        want, one_s = wall_s(lambda: analyze_batch(batch, lengths, device="cuda"))
        got = np.concatenate([np.load(work / f"ragged_{rank}.npy") for rank in range(2)])
        gap = np.abs(got - want)
        # the top-k against one process's over the whole matrix
        feats, _ = library_features(seed)
        seeds = feats[[11, 70_001]]
        (want_idx, want_d), topk_s = wall_s(
            lambda: sharded_top_k([torch.device("cuda", 0)], feats, seeds, 100))
        tops = [np.load(work / f"topk_{rank}.npz") for rank in range(2)]
        same_topk = all(np.array_equal(t["idx"], want_idx) and np.array_equal(t["dist"], want_d)
                        for t in tops)
        # the shared store against the files phase's one-process vectors
        with sqlite3.connect(work / "lib" / "songs.db") as conn:
            rows = conn.execute(
                "select song.path, feature.feature from feature join song on song.id = "
                "feature.song_id order by song.id, feature.feature_index").fetchall()
            failed = [r[0] for r in conn.execute("select path from song where error is not null")]
        stored: dict = {}
        for path, f in rows:
            stored.setdefault(path, []).append(f)
        songs = {k: r for k, r in files.items() if isinstance(r, Song)}
        worst = max(float(np.abs(np.asarray(stored[str(s.path)], np.float32)
                                 - s.analysis.as_arr1()).max())
                    for s in songs.values() if str(s.path) in stored) if stored else float("inf")
        print(f"multi-device: 2-process gloo cluster on cuda:0: {cluster_s:.1f} s with both "
              f"processes' start; ragged analyze_batch_distributed (3 + 5 songs) "
              f"{max(r['ragged_s'] for r in reports):.3f} s against one process's analyze_batch "
              f"{one_s:.3f} s, {'bit for bit' if not gap.any() else 'NOT bit for bit'}, largest gap "
              f"{gap.max():.3g}; top_k_distributed (60k + 40k rows, k = 100) "
              f"{max(r['topk_s'] for r in reports) * 1e3:.2f} ms against one process's "
              f"{topk_s * 1e3:.2f} ms, {'equal' if same_topk else 'NOT equal'} on both; "
              f"update_library_distributed of {len(files)} files {max(r['update_s'] for r in reports):.1f} s "
              f"(stored {[r['stored'] for r in reports]}, failed {[r['failed'] for r in reports]}), "
              f"{len(stored)} songs within {worst:.3g} of the files phase's vectors; launches "
              f"{[r['launches'] for r in reports]} [{card}]", flush=True)
        if gap.any():
            fail(f"cluster: the ragged batch is not bit for bit one process's ({gap.max():.3g})")
        if not same_topk:
            fail("cluster: top_k_distributed differs from one process's sharded_top_k")
        if sorted(stored) != sorted(str(s.path) for s in songs.values()) or worst > LISTED_ATOL:
            fail(f"cluster: the store holds {len(stored)} songs, {worst:.3g} from the files phase's "
                 f"{len(songs)} vectors (limit {LISTED_ATOL:g})")
        if len(failed) != 1 or not failed[0].endswith("testcue.cue"):
            fail(f"cluster: failed songs {failed}")
        for r in reports:
            if any(r["launches"].get(k, 0) < 1 for k in FUSED_PATH):
                fail(f"cluster: worker {r['rank']} did not launch every kernel of the path: "
                     f"{r['launches']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def distributed_worker(rank: int, port: int, workdir: str, seed: int, decoder: str) -> None:
    """One process of `cluster_phase`'s group, on cuda:0, decoding with the
    parent's decoder (`decoder`, its class name)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this worker needs a GPU")
    from bliss_tpu_torch.io.decoder import FFmpegDecoder
    from bliss_tpu_torch.io.fallback import FallbackDecoder
    from bliss_tpu_torch.library import BaseConfig, Library
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.parallel import distributed as D

    work = pathlib.Path(workdir)
    mesh = [torch.device("cuda", 0)]
    D.initialize(f"127.0.0.1:{port}", 2, rank, timeout_seconds=300)
    report = {"rank": rank}
    _build.reset_launches()
    batch = np.load(work / "batch.npy", mmap_mode="r")
    lengths = np.load(work / "lengths.npy")
    lo, hi = ((0, 3), (3, batch.shape[0]))[rank]
    D.analyze_batch_distributed(mesh, batch[lo:hi], lengths[lo:hi])  # warm
    feats, report["ragged_s"] = wall_s(
        lambda: D.analyze_batch_distributed(mesh, batch[lo:hi], lengths[lo:hi]))
    np.save(work / f"ragged_{rank}.npy", feats)

    mat, _ = library_features(seed)
    seeds = mat[[11, 70_001]]
    lo, hi = ((0, 60_000), (60_000, LIBRARY_SONGS))[rank]
    D.top_k_distributed(mesh, mat[lo:hi], lo, LIBRARY_SONGS, seeds, 100)  # warm
    (idx, dist), report["topk_s"] = wall_s(
        lambda: D.top_k_distributed(mesh, mat[lo:hi], lo, LIBRARY_SONGS, seeds, 100))
    np.savez(work / f"topk_{rank}.npz", idx=idx, dist=dist)

    config = BaseConfig(config_path=work / "lib" / "config.json",
                        database_path=work / "lib" / "songs.db")
    decoder_cls = {c.__name__: c for c in (FFmpegDecoder, FallbackDecoder)}[decoder]
    if rank == 0:
        lib = Library(config, decoder_cls, devices=mesh)
        D.barrier()
    else:
        D.barrier()
        lib = Library(config, decoder_cls, create=False, devices=mesh)
    (report["stored"], report["failed"]), report["update_s"] = wall_s(
        lambda: D.update_library_distributed(lib, files_set(), mesh, rank, 2))
    report["launches"] = dict(_build.LAUNCHES)
    print("WORKER_REPORT " + json.dumps(report), flush=True)
    D.barrier()
    D.shutdown()
    print(f"WORKER_OK rank={rank}", flush=True)


# ---------------------------------------------------------------------------
# the recycled ingest, the command-line examples, the V1 audit
# ---------------------------------------------------------------------------

#: Feature gap allowed between the recycled store and the in-process one:
#: other segments put a song beside other songs (a few f32 ulps, as the
#: cluster's rounds; tempo is held equal).
RECYCLED_ATOL = 2e-7


@contextlib.contextmanager
def stderr_to(path: pathlib.Path):
    """File descriptor 2 (this process's and every child's standard error)
    into `path` for the block."""
    import os

    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "wb") as f:
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def stored_vectors(lib) -> dict:
    return {str(s.bliss_song.path): s.bliss_song.analysis.as_arr1()
            for s in lib.songs_from_library()}


def recycled_phase(files: dict, decoded: dict, card: str, segment_songs: int = 4) -> None:
    """The files phase's default set through `Library.update_library_recycled`
    on the card in worker processes of `segment_songs` songs, the next one
    pre-spawned, against `update_library` in this process on the same
    decoded songs, both with DECODER (with FallbackDecoder on one decode
    thread, `number_cores = 1`: the pure-Python decoders hold the GIL, and
    decode the set faster with one worker than with threads): every vector
    within RECYCLED_ATOL (tempo equal), the same failed ledger, each
    worker's kernel launches on cuda:0 (read from its debug report on
    standard error), and a second call that starts no process. Prints each
    segment's wall time, the start-up seconds that pre-spawning hid, and
    the peak resident memory of this process and of the workers."""
    import logging
    import shutil

    from bliss_tpu_torch.benches import decode_once
    from bliss_tpu_torch.io.fallback import FallbackDecoder
    from bliss_tpu_torch.library import BaseConfig, Library
    from bliss_tpu_torch.song import AnalysisOptions, Song
    from bliss_tpu_torch.utils.profiling import RssSampler

    work = REPO / "tmp" / "smoke_recycled"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    paths = [str(p) for p in files_set()]
    failures = []
    try:
        known, _ = decode_once(paths, decoded, DECODER)
        options = AnalysisOptions(number_cores=1 if DECODER is FallbackDecoder else 0)
        ref = Library(BaseConfig(config_path=work / "inproc" / "config.json",
                                 database_path=work / "inproc" / "songs.db",
                                 analysis_options=options), known, device="cuda")
        ref.update_library(paths)
        want = stored_vectors(ref)
        want_failed = sorted(str(e.song_path) for e in ref.get_failed_songs())

        lib = Library(BaseConfig(config_path=work / "rec" / "config.json",
                                 database_path=work / "rec" / "songs.db",
                                 analysis_options=options), DECODER, device="cuda")
        log = logging.getLogger("bliss_tpu_torch")
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
        level = log.level
        log.addHandler(handler)
        log.setLevel(logging.DEBUG)  # the workers' reports are debug lines
        try:
            with stderr_to(work / "stderr.log"), RssSampler(period=0.5) as rss:
                t0 = time.perf_counter()
                lib.update_library_recycled(paths, segment_songs=segment_songs)
                rec_s = time.perf_counter() - t0
        finally:
            log.removeHandler(handler)
            log.setLevel(level)
        err = (work / "stderr.log").read_text(errors="replace")
        reports = [json.loads(line.split("ingest worker report ", 1)[1])
                   for line in err.splitlines() if "ingest worker report " in line]
        segments = [line.split("recycled segment ", 1)[1] for line in err.splitlines()
                    if "recycled segment " in line]

        got = stored_vectors(lib)
        got_failed = sorted(str(e.song_path) for e in lib.get_failed_songs())
        worst = 0.0
        if sorted(got) != sorted(want):
            failures.append(f"the recycled store holds {sorted(set(got) ^ set(want))} apart")
        for key in sorted(set(got) & set(want)):
            gap = np.abs(got[key] - want[key])
            worst = max(worst, float(gap.max()))
            if gap[0] != 0:
                failures.append(f"{key}: tempo {got[key][0]} recycled, {want[key][0]} in process")
        if worst > RECYCLED_ATOL:
            failures.append(f"a recycled vector {worst:.3g} from the in-process one "
                            f"(limit {RECYCLED_ATOL:g})")
        if got_failed != want_failed:
            failures.append(f"failed ledger {got_failed}, in process {want_failed}")
        n_seg = -(-len(paths) // segment_songs)
        if len(reports) != n_seg:
            failures.append(f"{len(reports)} worker reports for {n_seg} segments")
        for i, r in enumerate(reports):
            seg = paths[i * segment_songs : (i + 1) * segment_songs]
            songs = [p for p in seg if isinstance(files.get(p), Song)]
            devices = {k.split("@", 1)[1] for k in r["launches"]}
            if devices - {"cuda:0"}:
                failures.append(f"worker {i}: launches on {sorted(devices)}")
            if songs and any(r["launches"].get(f"{k}@cuda:0", 0) < 1 for k in FUSED_PATH):
                failures.append(f"worker {i}: not every kernel of the path on cuda:0: "
                                f"{r['launches']}")
            if r["devices"] != [str(lib.device)]:
                failures.append(f"worker {i} analyzed on {r['devices']}, not {lib.device}")

        # a second call over the paths that landed (a failed path is tried
        # again, as by update_library): nothing to analyze, no process
        landed = [p for p in paths if p not in got_failed]
        started = []
        popen = subprocess.Popen

        def counting(*a, **k):
            started.append(a)
            return popen(*a, **k)

        subprocess.Popen = counting
        try:
            lib.update_library_recycled(landed, segment_songs=segment_songs)
        finally:
            subprocess.Popen = popen
        if started:
            failures.append(f"a second call started {len(started)} processes")
        print(f"recycled: {len(paths)} files in {n_seg} segments of <= {segment_songs} through "
              f"update_library_recycled in {rec_s:.2f} s; {len(got)} songs within {worst:.3g} of "
              f"update_library in this process (limit {RECYCLED_ATOL:g}, tempo equal), failed "
              f"{[pathlib.Path(p).name for p in got_failed]}; segments: {'; '.join(segments)}; "
              f"worker start-up {', '.join(f'{r['ready_s']:.2f}' for r in reports)} s, of it "
              f"hidden by pre-spawn {', '.join(f'{r['hidden_s']:.2f}' for r in reports)} s; "
              f"peak RSS this process {rss.root_peak_mb:.0f} MB, largest worker "
              f"{max((r['peak_rss_mb'] for r in reports), default=0.0):.0f} MB, all processes "
              f"{rss.peak_mb:.0f} MB; a second call over the {len(landed)} files that landed started "
              f"{len(started)} processes [{card}]",
              flush=True)
        for i, r in enumerate(reports):
            print(f"  worker {i}: {r['paths']} paths, segment {r['segment_s']:.2f} s, launches "
                  f"{r['launches']}", flush=True)
        if failures:
            print(err[-4000:], file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        fail("recycled phase: " + "; ".join(failures))


def example_command(name: str) -> list:
    """The command that starts the command-line example `name` with
    DECODER as its DefaultDecoder: `python3 -m` where DECODER is the
    default; else a `-c` stub that makes DECODER (FallbackDecoder) the
    DefaultDecoder of `io.decoder` (the examples import it, and `Library`
    resolves it, after the stub ran) and then runs the module as
    `__main__`."""
    from bliss_tpu_torch.io.decoder import DefaultDecoder

    module = f"bliss_tpu_torch.examples.{name}"
    if DECODER is DefaultDecoder:
        return [sys.executable, "-m", module]
    return [sys.executable, "-c",
            f"import runpy, bliss_tpu_torch.io.decoder as d, {DECODER.__module__} as m; "
            f"d.DefaultDecoder = m.{DECODER.__qualname__}; "
            f"runpy.run_module({module!r}, run_name='__main__', alter_sys=True)"]


def examples_phase(files: dict, card: str) -> None:
    """ci_check.sh's example sequence on the port's command-line examples
    (`python3 -m bliss_tpu_torch.examples.<name> ... --device cuda`), in
    four chains that run at once (each library's init, then its playlist;
    the extra-info library in a folder of its own, so the two stores do
    not share a file): every exit 0, the .m3u not empty, the printed
    vector of s16_mono_22_5kHz.flac within 1e-6 of the files phase's.
    The CLIs decode with DefaultDecoder, as the JAX ones do; where the
    native decoder did not build, each runs through `example_command`'s
    stub, with FallbackDecoder as their DefaultDecoder."""
    import shutil

    from bliss_tpu_torch.io.decoder import DefaultDecoder

    via = ("" if DECODER is DefaultDecoder else
           ", each through a stub making FallbackDecoder their DefaultDecoder (no native decoder)")
    work = REPO / "tmp" / "smoke_examples"
    shutil.rmtree(work, ignore_errors=True)
    music = work / "music"
    music.mkdir(parents=True)
    for name in ("s16_mono_22_5kHz.flac", "piano.flac", "s32_stereo_44_1_kHz.mp3"):
        shutil.copy(DATA / name, music / name)
    seed = str(music / "s16_mono_22_5kHz.flac")
    chains = [
        [("analyze", ["tests/data/s16_mono_22_5kHz.flac"]),
         ("distance", ["tests/data/s16_mono_22_5kHz.flac", "tests/data/piano.flac"])],
        [("playlist", [str(music), "-o", str(work / "playlist.m3u"),
                       "-a", str(work / "analysis.json")])],
        [("library", ["init", str(music), "-c", str(work / "config.json"),
                      "-d", str(work / "songs.db")]),
         ("library", ["playlist", "-c", str(work / "config.json"), seed, "2"])],
        [("library_extra_info", ["init", str(music), "-c",
                                 str(work / "extra" / "config_extra.json")]),
         ("library_extra_info", ["playlist", "-c", str(work / "extra" / "config_extra.json"),
                                 seed, "2"])],
    ]
    outs: dict = {}

    def run_chain(chain):
        for name, args in chain:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [*example_command(name), *args, "--device", "cuda"],
                cwd=REPO, capture_output=True, text=True, timeout=600,
            )
            label = name if args[0] not in ("init", "playlist") else f"{name} {args[0]}"
            outs[label] = (proc, time.perf_counter() - t0)
            if proc.returncode != 0:
                return

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(chains)) as pool:
            list(pool.map(run_chain, chains))
        wall = time.perf_counter() - t0
        failures = [f"{k} exited {p.returncode}: {p.stderr[-1500:]}"
                    for k, (p, _) in outs.items() if p.returncode != 0]
        if len(outs) != sum(map(len, chains)):
            failures.append(f"{len(outs)} of {sum(map(len, chains))} steps ran")
        m3u = work / "playlist.m3u"
        if not m3u.exists() or not m3u.read_text().strip():
            failures.append("the .m3u is empty")
        gap = None
        analyze = outs.get("analyze")
        ref = files.get(str(DATA / "s16_mono_22_5kHz.flac"))
        if analyze and analyze[0].returncode == 0:
            vec = np.asarray(json.loads(analyze[0].stdout.strip().split(": ", 1)[1]), np.float32)
            gap = float(np.abs(vec - ref.analysis.as_arr1()).max())
            if gap > 1e-6:
                failures.append(f"analyze's vector {gap:.3g} from the files phase's (limit 1e-6)")
        print(f"examples: ci_check.sh's {sum(map(len, chains))} steps with --device cuda{via} in "
              f"{wall:.1f} s ({', '.join(f'{k} {s:.1f} s' for k, (_, s) in outs.items())}); "
              f"every exit {'0' if not failures else 'NOT 0'}, playlist.m3u "
              f"{len(m3u.read_text().splitlines()) if m3u.exists() else 0} lines, analyze's vector "
              f"{gap} from the files phase's [{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        fail("examples phase: " + "; ".join(failures))


def v1_audit(decoded: dict, card: str) -> None:
    """`bliss_tpu_torch/benches/drift.py`'s audit at V1 over its V1_SUBSET
    on the card against the CPU f64 path (the files phase's decoded songs
    reused): at most 1e-4 per feature on real content."""
    from bliss_tpu_torch.benches import drift

    t0 = time.perf_counter()
    result = drift.audit([], drift.V1_SUBSET, "cuda", decoded=decoded, decoder=DECODER,
                         log=lambda line: print(f"  {line}", flush=True))
    v1 = result["v1"]
    print(f"V1 audit: {v1['entries']} files of V1_SUBSET on the card at f32 against the CPU f64 "
          f"path in {time.perf_counter() - t0:.1f} s: {v1['real']} real content, max "
          f"{v1['max_real']:.3g}, p99 {v1['p99_real']:.3g} (limit {drift.REAL_LIMIT:g}); "
          f"{'meets' if result['ok'] else 'BREAKS'} the contract [{card}]", flush=True)
    if not result["ok"] or v1["real"] != len(drift.V1_SUBSET):
        fail("V1 audit: " + "; ".join(result["failures"] or [f"{v1['real']} real-content files"]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--songs", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm batch with torch.profiler")
    ap.add_argument("--corpus", choices=("default", "full"), default="default",
                    help="files phase: the default set, or every fixture of the drift corpus")
    ap.add_argument("--distributed-worker", type=int, metavar="RANK",
                    help="run as process RANK of the multi-device phase's two-process cluster")
    ap.add_argument("--port", type=int, help="the cluster's port on 127.0.0.1 (with the above)")
    ap.add_argument("--workdir", help="the cluster's work folder (with the above)")
    ap.add_argument("--decoder", default="FFmpegDecoder",
                    help="the cluster's decoder class (with the above)")
    args = ap.parse_args()
    if args.distributed_worker is not None:
        distributed_worker(args.distributed_worker, args.port, args.workdir, args.seed,
                           args.decoder)
        return
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")

    from bliss_tpu_torch.models.analyzer import (
        analyze_batch,
        analyze_samples,
        bucket_length,
    )
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.ops import dft_kernels as DK
    from bliss_tpu_torch.ops.spectral import stft
    from bliss_tpu_torch.ops.windows import (
        n_frames_stft,
        n_frames_strided,
        reflect_pad_signal,
    )

    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    probe = native_probe()
    phase_s: dict = {}
    phase_t0 = [time.perf_counter()]

    def lap(name: str) -> None:
        """Close phase `name`: its seconds since the last lap."""
        now = time.perf_counter()
        phase_s[name] = round(now - phase_t0[0], 1)
        phase_t0[0] = now

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"build: {len(logs)} kernel sources in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    lap("build")
    native_decode_phase(probe, card)
    lap("native decode")

    # ---- data ------------------------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    n = int(round(args.seconds * 22050))
    tpad = bucket_length(n)
    batch = np.zeros((args.songs, tpad), np.float32)
    for i in range(args.songs):
        batch[i, :n] = synth_song(rng, n)
    lengths = np.full(args.songs, n, np.int64)
    print(f"data: {args.songs} songs x {n} samples (buffer {tpad}) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    x = torch.as_tensor(batch, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    b = args.songs
    results = {}

    # ---- kernels vs plain versions, at the main path's shapes ------------
    def record(name, source, replaces, err, ms, plain_ms, nbytes, ops, library_ms):
        bms, by = bound(nbytes, ops)
        results[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
        }
        print(f"kernel {name}: max_abs_err {err:.3g}, {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms by {by}, library {library_ms})", flush=True)

    # timbral: [B, F, 5]
    nf = int(n_frames_strided(tpad, 512, 128))
    timbral_err = hold_timbral_fft(
        x, nf, DK.TIMBRAL_OFFSET, f"{b} x {args.seconds / 60:g}-min",
        torch.arange(nf, device=dev) < n_frames_strided(lens, 512, 128).unsqueeze(-1),
    )
    record(
        "timbral_fft", "bliss_tpu_torch/csrc/timbral_fft.cu",
        "bliss_tpu/ops/pallas_dft.py:195", timbral_err,
        time_ms(lambda: DK.timbral_fft(x, nf), 20),
        time_ms(lambda: DK.timbral_fft_plain(x, nf), 3),
        b * tpad * 4 + b * nf * 5 * 4,
        b * nf * timbral_frame_ops(), None,
    )

    # SpecFlux: [B, H]
    nh = int(n_frames_strided(tpad, 512, 256))
    got = DK.specflux(x, nh)
    want = DK.specflux_plain(x, nh)
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = (err.amax(1) / want.abs().amax(1)).max().item()
    if not torch.isfinite(got).all() or rel > 1e-5:
        fail(f"specflux vs plain: relative {rel:.3g} of each song's largest onset (limit 1e-5)")
    record(
        "specflux", "bliss_tpu_torch/csrc/specflux.cu",
        "bliss_tpu/ops/pallas_dft.py:501", err.max().item(),
        time_ms(lambda: DK.specflux(x, nh), 20),
        time_ms(lambda: DK.specflux_plain(x, nh), 3),
        b * tpad * 4 + b * nh * 4,
        b * nh * (512 + rfft_ops(512) + 257 * 4 + 257 * 4), None,
    )
    print(f"  specflux relative error {rel:.3g}")
    del got, want, err

    # chroma STFT: [B, 4097, F]
    nfc = int(n_frames_stft(tpad, 2205))
    padded = reflect_pad_signal(x, lengths, 8192)
    got = DK.ct_stft_mags(padded, 8192, 2205, nfc)
    want = DK.ct_stft_mags_plain(padded, 8192, 2205, nfc)
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = (err.amax(1) / torch.clamp(want.amax(1), min=1e-30)).max().item()
    if not torch.isfinite(got).all() or rel > 1e-5:
        fail(f"ct_stft vs plain: {rel:.3g} of each frame's max (limit 1e-5)")
    used = padded[:, : (nfc - 1) * 2205 + 8192]
    hann = torch.hann_window(8192, periodic=True, device=dev)

    def library_stft():
        return torch.stft(used, 8192, 2205, window=hann, center=False,
                          return_complex=True).abs()

    record(
        "ct_stft", "bliss_tpu_torch/csrc/ct_stft.cu",
        "bliss_tpu/ops/pallas_dft.py:778", err.max().item(),
        time_ms(lambda: DK.ct_stft_mags(padded, 8192, 2205, nfc), 10),
        time_ms(lambda: DK.ct_stft_mags_plain(padded, 8192, 2205, nfc), 3),
        b * padded.shape[1] * 4 + b * nfc * 4097 * 4,
        b * nfc * (8192 + rfft_ops(8192) + 4097 * 4),
        time_ms(library_stft, 5),
    )
    print(f"  ct_stft relative error {rel:.3g} of the frame max")
    if results["ct_stft"]["ms"] >= results["ct_stft"]["library_ms"]:
        print("  FAULT: ct_stft at the main path's shape is not under torch.stft + abs", flush=True)
    hold_ct_edge_cases(dev)

    # the fused tuning route at this batch's spectrum, against the plane
    # composition of the TPU contracts it replaces
    frame_mask = torch.arange(nfc, device=dev) < n_frames_stft(lens, 2205).unsqueeze(-1)
    del want, err, padded
    hold_fused_tuning(record, got, frame_mask, f"{b} x {args.seconds / 60:g}-min")
    del got
    torch.cuda.empty_cache()

    # the beat tracker at this batch's series, and on its edge cases
    xs = torch.where(torch.arange(tpad, device=dev) < lens.unsqueeze(-1), x, 0.0)
    held = hold_beat_track(*tempo_series(xs, lens), f"{b} x {args.seconds / 60:g}-min", card,
                           plain_reps=2)
    record(
        "beat_track", "bliss_tpu_torch/csrc/beat_track.cu",
        "bliss_tpu/models/tempo.py:760 (lax.scan, no Pallas kernel)", held["err"], held["ms"],
        held["plain_ms"], held["nbytes"], held["ops"], None,
    )
    results["beat_track"]["step_us"] = held["step_us"]
    hold_beat_track_edges(dev, card)
    series = tempo_series(xs, lens)
    held = hold_block_inputs(series[0], series[2], f"{b} x {args.seconds / 60:g}-min", card)
    record(
        "block_inputs", "bliss_tpu_torch/csrc/autocorr.cu",
        "bliss_tpu/models/tempo.py:341 (_precompute_blocks with _autocorr :236 and _get_timesig "
        ":289, XLA, no Pallas kernel)", held["err"], held["ms"], held["plain_ms"], held["nbytes"],
        held["ops"], None,
    )
    results["block_inputs"].update(call_ms=held["call_ms"])
    del xs, series, held
    hold_block_input_edges(dev)
    lap("data and kernels")

    # ---- the main path ---------------------------------------------------
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v2 = analyze_batch(batch, lengths, version=2, device="cuda")
    first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    missing = [k for k in results if launches.get(k, 0) < 1]
    if missing:
        fail(f"kernels not launched on the main path: {missing} (counts {launches})")
    if any(launches.get(k, 0) for k in UNFUSED_ROUTE):
        fail(f"the 5-min bucket took the unfused tuning route (counts {launches})")
    if launches.get("block_inputs") != 1:
        fail(f"the 5-min batch launched block_inputs {launches.get('block_inputs')} times, not once")
    for k in results:
        results[k]["launches"] = launches.get(k, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v2b = analyze_batch(batch, lengths, version=2, device="cuda")
    warm_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _build.reset_launches()
    t0 = time.perf_counter()
    v1 = analyze_batch(batch, lengths, version=1, device="cuda")
    v1_s = time.perf_counter() - t0
    if _build.LAUNCHES.get("block_inputs") != 1 or _build.LAUNCHES.get("beat_track") != 1:
        fail(f"the V1 batch launched the beat tracker's kernels {_build.LAUNCHES}")
    print(f"main path V2: {b} x {args.seconds:g} s songs, first {first_s:.3f} s, "
          f"warm {warm_s:.3f} s = {b / warm_s:.2f} songs/s, peak {peak_gb:.2f} GB; "
          f"V1 {v1_s:.3f} s; launches {launches} [{card}]", flush=True)
    if v2.shape != (b, 23) or v1.shape != (b, 20):
        fail(f"output shapes {v2.shape} {v1.shape}")
    if not (np.isfinite(v2).all() and np.isfinite(v1).all()):
        fail("non-finite features")
    if not np.array_equal(v2, v2b):
        print(f"  note: V2 repeat differs by {np.abs(v2 - v2b).max():.3g} (atomics order)")
    if np.abs(v2[:, :10] - v1[:, :10]).max() > 1e-6:
        fail("V1 and V2 disagree on the shared first 10 features")
    multidevice_batch(batch, lengths, card)
    stage_breakdown(x, lens, frame_mask)
    # both tuning routes below the gate that picks one by the bucket's length
    hold_tuning_routes(
        stft(x, 8192, 2205, lens, nfc), frame_mask, f"{b} x {args.seconds / 60:g}-min"
    )
    if args.profile:
        profile_batch(batch, lengths)
    lap("main path")

    # ---- against the CPU f64 path ----------------------------------------
    piano = piano_samples()
    gpu = analyze_samples(piano, piano.shape[0], 2, device="cuda").cpu().numpy()
    cpu = analyze_samples(piano, piano.shape[0], 2, device="cpu").cpu().numpy()
    d_cpu = np.abs(gpu - cpu).max()
    d_pin = np.abs(gpu - np.asarray(PIANO_V2, np.float32)).max()
    print(f"piano.wav: CUDA f32 vs CPU f64 max {d_cpu:.3g}, vs PIANO_V2 max {d_pin:.3g} "
          f"(limit 1e-4)", flush=True)
    if d_cpu > 1e-4 or d_pin > 1e-4:
        fail(f"piano.wav drift: per feature {np.abs(gpu - cpu).tolist()}")

    t0 = time.perf_counter()
    cpu0 = analyze_samples(batch[0, :n], n, 2, device="cpu").cpu().numpy()
    d_syn = np.abs(v2[0] - cpu0).max()
    same_argmax = int(np.argmax(v2[0, 10:])) == int(np.argmax(cpu0[10:]))
    print(f"synthetic song 0: CUDA f32 vs CPU f64 max {d_syn:.3g} (limit 2e-2), "
          f"dominant chroma {'agrees' if same_argmax else 'DIFFERS'} "
          f"(CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    if d_syn > 2e-2 or not same_argmax:
        fail("synthetic song drift")
    del lens, frame_mask, v2b, v1

    # ---- the non-default routes -------------------------------------------
    lap("against CPU f64")
    routes_phase(record, results, x, batch, lengths, v2, cpu0, piano, tpad, card)
    lap("routes")
    cluster_batch = batch
    del x, v2, batch
    torch.cuda.empty_cache()

    # ---- long buckets: the unfused tuning route --------------------------
    long_phase(rng, results, card, 8, 420.0, record_json=True)
    song21 = long_phase(rng, results, card, 2, 1260.0, record_json=False)
    lap("long buckets")

    # ---- one 60-minute song, time-sharded ---------------------------------
    longsong_phase(rng, record, results, song21, card)
    del song21
    lap("long song")

    # ---- files -----------------------------------------------------------
    files, decoded = files_phase(args.corpus, card)
    lap("files")

    # ---- the library and its playlists -----------------------------------
    library_phase(args.seed, card, files)
    lap("library")

    # ---- the rest of the multi-device phase --------------------------------
    multidevice_top_k(args.seed, card)
    cluster_phase(args.seed, cluster_batch, lengths, files, card)
    del cluster_batch
    lap("multi-device")
    torch.cuda.empty_cache()
    scaling_phase(args.seed, card)
    lap("scaling")

    # ---- the recycled ingest, the command-line examples, the V1 audit ------
    torch.cuda.empty_cache()
    recycled_phase(files, decoded, card)
    lap("recycled")
    examples_phase(files, card)
    lap("examples")
    v1_audit(decoded, card)
    lap("V1 audit")

    print(f"smoke run: phase seconds {json.dumps(phase_s)}; "
          f"{time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": list(results.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
