#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--songs 8] [--seconds 300] [--profile]
                          [--corpus default|full]

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of `bliss_tpu_torch/csrc` (one nvcc each, in
   parallel) into `bliss_tpu_torch/build/`;
3. makes a batch of synthetic songs from `--seed` (tones, chords, clicks
   and noise), 8 x 5 minutes by default, padded to `bucket_length`;
4. holds each kernel against its plain PyTorch version on the card, at
   the shapes the analysis gives it, and times both (a `FAULT:` line names
   a kernel that is not under its library call); `timbral_fft` also prints,
   for the 8 frames where it and its plain version differ most, each one's
   geometric-mean distance to an f64 FFT of the frame, and holds the
   song-level flatness features of its rows at 1e-5; `ct_stft_mags` and
   `ct_frames_mags` also off the path's shapes (B = 3, frames past the end
   of the signal, ragged frame counts, N = 1, rows at a 4-byte offset, the
   radix-2 body's widths 2048 and 4096); the fused tuning route's
   `tuning_peaks` and `tuning_select` are held bit for bit against the
   plane composition of the TPU contracts they replace (each song's sorted
   (key, bin) list and `n` against the planes, `o1`, `o2`, `min_c`, `tk`,
   the counts and the tuning against `bisect16_pair` twice, `level2_plane`,
   `threshold_key` and `histogram_threshold_plane`);
5. drives `analyze_batch` (V2, then V1) on the card with the launch
   counts reset just before, fails if any kernel did not run, and times
   each descriptor stage alone and both tuning routes on the batch's
   spectra, equal bit for bit (`--profile` adds a torch.profiler trace of
   one batch: device busy share and the longest-running kernels);
6. holds the card's f32 vectors against the port's CPU f64 path: on
   tests/data/piano.wav (<= 1e-4 per feature, and against the pinned
   PIANO_V2) and on one synthetic song (<= 2e-2, same dominant chroma);
7. long buckets, whose tuning takes the unfused route: on 8 synthetic
   7-minute songs (bucket 10,485,760) and 2 synthetic 21-minute songs
   (bucket 29,360,128, B = 2) holds `bisect8_keys` (every level, both
   ranks, bit for bit), `bisect8` (the int8-plane entry of the same
   counting pass) and `histogram_int_plane` against their plain versions at
   full width and times them, the whole radix select (4 launches, counted)
   beside `torch.nanquantile` and `torch.kthvalue`, drives `analyze_batch`
   with the counts reset (`bisect8_keys` and `histogram_int_plane` must
   launch, the fused route's two must not), holds the unfused tuning
   equal to the fused route's on the same spectra, and one 7-minute song's
   vector against the CPU f64 path (<= 2e-2, same dominant chroma);
8. files: `io.batch.analyze_paths_batched` on the card over the drift
   fixtures (all but the 21-minute medley), piano.flac,
   s16_mono_22_5kHz.flac and testcue.cue (`--corpus full`: every fixture
   of the drift corpus), with decoding (the batch driver's decode threads, then
   one decode worker) and from the decoded songs, and holds each vector against the port's CPU f64 path on the
   same decoded samples: <= 1e-4 per feature on real content, <= 2e-2 and
   the same dominant chroma on the pure-tone and dyad synthetics; then
   the `timbral="flat"` route on the same decoded real-content songs and
   the MP3 golden fixture, its drift beside the default route's (reported);
9. routes: holds `frame_dft_mags` (hops 128 and 256), `timbral_flat` and
   `ct_frames_mags` (the framed route's `[8 F, 8192]`) against their plain
   versions on the 8 x 5-minute batch, then drives one
   `analyze_batch` per non-default route (`timbral="flat"`; `timbral="mags"`
   with `tempo="mags"`; `chroma_stft="framed"`) with the counts reset,
   checks each route's launches, prints each vector's distance to the
   default route's (tempo must be equal, chroma within 1e-5; the timbral
   features of the `"flat"` and `"mags"` routes are reported), and the
   flatness drift of `"flat"` against `timbral_fft` and the CPU f64 path on
   piano.wav and the batch;
10. long song, full width: one synthetic 60-minute song (79,380,000
   samples, 8 shards of 10,485,760): holds every kernel of the sharded
   path at the shapes that path gives it: `ct_frames_mags` at one shard's
   `[4,757, 8192]` (first, middle and last shard), `frame_dft_mags` at
   `[8, 10,506,554]` and `timbral_fft` on the same halo-extended shards
   with its negative frame offset, each against its plain version (the
   first two against library calls too; the worst `timbral_fft` frame is
   printed with its shard and RMS, the 8 farthest with their distances to
   f64, and the song's flatness features are held), the global median's counting rounds
   against a sort and timed alone beside the sharded chroma stage and the
   radix select on the same plane, and `histogram_int_plane` on the sharded
   tuning plane; drives `parallel.longsong.sharded_analyze_samples` with the
   counts reset (the four must launch), holds the vector against the
   bucketed `analyze_batch` (B = 1) of the same song (<= 2e-5 per feature,
   tempo equal; up to the 1e-4 contract a gap is printed as a fault, above
   it the run fails), prints warm seconds and peak memory of both routes
   and the bucketed route's time by stage, holds a 21-minute song's
   sharded vector against the CPU f64 path (<= 2e-2, same dominant
   chroma), and runs `analyze_paths_batched` over that song as a WAV file
   with `longsong_samples` set, equal to the bucketed result at 2e-5.

Prints one JSON line of per-kernel numbers, the nvidia-smi line, then the
result line. Any failed phase exits non-zero. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
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


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def stage_breakdown(x, lens, frame_mask, n_hops: int, warm_up: bool = True) -> None:
    """Warm host-clock time of each descriptor stage alone on the batch,
    synchronized before and after, plus the batch's upload from pageable
    host memory. `warm_up=False` times the first call of each stage (for a
    batch whose stages already ran and take seconds)."""
    from bliss_tpu_torch.models import chroma as CH
    from bliss_tpu_torch.models import loudness as LD
    from bliss_tpu_torch.models import tempo as TP
    from bliss_tpu_torch.models import timbral as TB
    from bliss_tpu_torch.ops.dft_kernels import specflux
    from bliss_tpu_torch.ops.spectral import stft
    from bliss_tpu_torch.ops.windows import n_frames_strided
    from bliss_tpu_torch.tables import default_tables

    dev = x.device
    tab = default_tables().on(dev)
    xs = torch.where(torch.arange(x.shape[1], device=dev) < lens.unsqueeze(-1), x, 0.0)
    thresh = TP.thresholded_series(specflux(xs, n_hops))
    silent = TP.silence_flags_blocked(xs, n_hops)
    consts = TP._bt_constants(dev, tab)
    h_valid = n_frames_strided(lens, 512, 256)
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
        "timbral+zcr": wall_ms(lambda: (TB.spectral_features(xs, lens, tab), TB.zcr_feature(xs, lens))),
        "loudness": wall_ms(lambda: LD.loudness_features(xs, lens)),
        "chroma": wall_ms(lambda: CH.chroma_features(xs, lens, 2, torch.float32, tab)),
        "chroma.stft": wall_ms(lambda: stft(xs, 8192, 2205, lens, frame_mask.shape[1])),
        "chroma.tuning": wall_ms(lambda: tuning(spectrum, frame_mask, 8192)),
        "upload": wall_ms(lambda: torch.as_tensor(host, device=dev)),
    }
    print("stages (ms, warm, each alone): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)


def profile_batch(batch, lengths) -> None:
    """torch.profiler over one warm V2 batch: device busy share and the
    kernels that hold the device longest."""
    from torch.profiler import ProfilerActivity, profile

    from bliss_tpu_torch.models.analyzer import analyze_batch

    analyze_batch(batch, lengths, version=2, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        analyze_batch(batch, lengths, version=2, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt, e.count, e.key))
    busy = sum(r[0] for r in rows)
    print(f"profile: wall {wall / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / wall:.1f}%), {sum(r[1] for r in rows)} device ops", flush=True)
    for dt, count, key in sorted(rows, reverse=True)[:15]:
        print(f"  {dt / 1e3:9.3f} ms {count:7d}x {key[:90]}")


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
    nfc = int(n_frames_stft(tpad, 2205))
    if CH.uses_fused_tuning(nfc, torch.float32):
        fail(f"{label}: bucket {tpad} ({nfc} frames) is within the fused budget")
    frame_mask = torch.arange(nfc, device=dev) < n_frames_stft(lens, 2205).unsqueeze(-1)
    spectrum = stft(x, 8192, 2205, lens, nfc)

    # the unfused route's planes, as estimate_tuning builds them
    pitches, mags, peak = CH.pip_track(spectrum, frame_mask, 8192)
    pos = peak & (pitches > 0.0)
    u, m, n_peaks, ranks = TK.radix_keys(mags, pos)
    plane = TK.radix_plane(u, m, 0, torch.zeros(n_songs, dtype=torch.int64, device=dev))
    k = ranks[0]
    got, want = TK.bisect8(plane, k), TK.bisect8_plain(plane, k)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{label}: bisect8 != plain: {got.tolist()} {want.tolist()}")
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
    n_el = plane.numel()
    n_valid = int(n_peaks.sum())
    print(f"  {label}: {n_valid} peaks in {n_el} plane elements; bisect8_keys (4 levels x 2 ranks), "
          f"bisect8, the radix median (4 launches) and histogram_int_plane exact", flush=True)

    # times: the kernels, their plain versions, and the library calls
    b8_ms = time_ms(lambda: TK.bisect8(plane, k), 20)
    b8_plain = time_ms(lambda: TK.bisect8_plain(plane, k), 3)
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
    b8_bound = bound(n_el + n_songs * 12, n_el)
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
          f"ms, torch.nanquantile {nanq_ms} ms; bisect8 (int8 plane, one rank) {b8_ms:.4f} ms "
          f"(plain {b8_plain:.4f}, bound {b8_bound[0]:.4f} by {b8_bound[1]})", flush=True)
    if nanq_ms is not None and select_ms >= nanq_ms:
        print(f"  FAULT: the radix select ({select_ms:.4f} ms) is not under torch.nanquantile "
              f"({nanq_ms:.4f} ms)", flush=True)
    print(f"  {label} histogram_int_plane: {hi_ms:.4f} ms (plain {hi_plain:.4f}, bound "
          f"{hi_bound[0]:.4f} by {hi_bound[1]}); torch.bincount {bincount_ms:.4f} ms", flush=True)
    if record_json:
        # row 9 is the whole select as the path runs it (4 launches of the
        # key entry), so that its time, bound, plain and library columns
        # speak of one function; one launch and the int8 entry ride along
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
            "int8_entry": {"name": "bisect8", "ms": b8_ms, "plain_ms": b8_plain,
                           "bound_ms": b8_bound[0], "bound_by": b8_bound[1]},
        })

    hold_tuning_routes(spectrum, frame_mask, label)
    del spectrum, pitches, mags, peak, pos, u, m, plane, idx_m, inf_vals, vals, mflat, offsets, sel
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
    if any(launches.get(k, 0) < 1 for k in need) or any(launches.get(k, 0) for k in FUSED_ROUTE):
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


def files_phase(corpus: str, card: str) -> None:
    """Files to features on the card through the batch driver, timed with
    and without decoding, held against the port's CPU f64 path on the
    same decoded samples."""
    from bliss_tpu_torch.io.batch import analyze_paths_batched
    from bliss_tpu_torch.io.fallback import FallbackDecoder
    from bliss_tpu_torch.song import Song

    drift = sorted((DATA / "drift").iterdir())
    if corpus == "full":
        # benches/tpu_drift.py:CORPUS
        paths = sorted(
            p for p in list(DATA.glob("*.flac")) + list(DATA.glob("*.mp3"))
            + list(DATA.glob("*.ogg")) + list(DATA.glob("*.wav"))
            + list((DATA / "chroma").glob("*.ogg")) + drift
            if p.name != "empty.wav"
        ) + [DATA / "testcue.cue"]
    else:
        paths = [p for p in drift if "medley" not in p.name] + [
            DATA / "piano.flac", DATA / "s16_mono_22_5kHz.flac", DATA / "testcue.cue",
        ]
    decoded: dict = {}
    decode_s: dict = {}

    class Recording(FallbackDecoder):
        """Decodes, and keeps a copy of each decoded song."""

        @classmethod
        def decode(cls, path):
            t0 = time.perf_counter()
            song = FallbackDecoder.decode(path)
            decode_s[str(path)] = time.perf_counter() - t0
            decoded[str(path)] = dataclasses.replace(song, sample_array=song.sample_array.copy())
            return song

    class Decoded(FallbackDecoder):
        """Hands out the kept songs: the same samples without decoding."""

        @classmethod
        def decode(cls, path):
            song = decoded.get(str(path))
            if song is None:  # a file that failed to decode fails again
                return FallbackDecoder.decode(path)
            return dataclasses.replace(song, sample_array=song.sample_array.copy())

    def run(decoder, device, workers=None):
        t0 = time.perf_counter()
        out = {
            str(p): r
            for p, r in analyze_paths_batched(decoder, paths, device=device, decode_workers=workers)
        }
        if device == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    gpu, with_s = run(Recording, "cuda")
    threads_s = sum(decode_s.values())
    gpu1, one_worker_s = run(Recording, "cuda", workers=1)
    serial_s = sum(decode_s.values())
    gpu2, without_s = run(Decoded, "cuda")
    cpu, cpu_s = run(Decoded, "cpu")
    songs = sorted(k for k, r in gpu.items() if isinstance(r, Song))
    n_songs = len(songs)
    share = (with_s - without_s) / with_s
    print(f"files ({corpus}): {len(paths)} paths -> {n_songs} songs; with decode {with_s:.2f} s = "
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
    if failures:
        fail("files phase: " + "; ".join(failures))
    flat_audit(decoded, gpu, cpu)


def flat_audit(decoded: dict, gpu: dict, cpu: dict) -> None:
    """The `timbral="flat"` route (the direct-DFT rows) on every decoded
    real-content song of the files phase and on the MP3 golden fixture:
    its drift from the CPU f64 path beside the default route's, per song
    the worst feature and the worst of the two flatness features (6, 7).
    Reported against the 1e-4 contract, not failed."""
    from bliss_tpu_torch.io.fallback import FallbackDecoder
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
    x = FallbackDecoder.decode(DATA / "s16_mono_22_5kHz.mp3").sample_array
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
    ragged N of pre-framed rows, rows at a 4-byte offset (no 8-byte
    loads), and the widths 2048 and 4096, which take the radix-2 body."""
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
    for w, hop in ((8192, 2205), (2048, 512)):
        nf = (padded.shape[1] - w) // hop + 1
        check(f"ct_stft [3, 1000003] W {w} hop {hop} ({nf} frames a song)",
              DK.ct_stft_mags(padded, w, hop, nf), DK.ct_stft_mags_plain(padded, w, hop, nf), 1)
    w, hop = 8192, 2205
    nf = (padded.shape[1] - w) // hop + 5
    win, tw = DK._constants(w, str(dev))
    out = torch.empty((3, nf, w // 2 + 1), device=dev)
    fn = _build.function("ct_stft", "ct_stft_launch", DK._FRAME_ARGS)
    _build.check("ct_stft", fn(
        _build.ptr(padded), 3, padded.shape[1], nf, hop, 13, _build.ptr(win), _build.ptr(tw[0]),
        _build.ptr(tw[1]), _build.ptr(out), _build.stream_ptr(dev)))
    ext = torch.nn.functional.pad(padded, (0, (nf - 1) * hop + w - padded.shape[1]))
    check(f"ct_stft, the last 4 of {nf} frames past the end", out.transpose(1, 2),
          DK.ct_stft_mags_plain(ext, w, hop, nf), 1)
    for n in (1, 1001):
        frames = torch.randn((n, w), generator=gen, device=dev) * 0.1
        check(f"ct_frames [{n}, {w}]", DK.ct_frames_mags(frames), DK.ct_frames_mags_plain(frames), 0)
    frames = (torch.randn(257 * w + 1, generator=gen, device=dev) * 0.1)[1:].view(257, w)
    check(f"ct_frames [257, {w}] at a 4-byte offset", DK.ct_frames_mags(frames),
          DK.ct_frames_mags_plain(frames), 0)
    frames = torch.randn((300, 4096), generator=gen, device=dev) * 0.1
    check("ct_frames [300, 4096]", DK.ct_frames_mags(frames), DK.ct_frames_mags_plain(frames), 0)
    print("  ct edge cases vs plain, of each frame's max: " + "; ".join(held), flush=True)


def routes_phase(record, results, x, batch, lengths, v2, cpu0, piano, tpad: int, card: str) -> None:
    """The non-default routes on the 8 x 5-minute batch: their kernels
    against the plain versions, one `analyze_batch` per route with the
    launch counts reset, each vector's distance to the default route's."""
    from bliss_tpu_torch.models.analyzer import analyze_batch, analyze_samples
    from bliss_tpu_torch.ops import _build
    from bliss_tpu_torch.ops import dft_kernels as DK
    from bliss_tpu_torch.ops.windows import (
        frame_signal_reflect,
        n_frames_stft,
        n_frames_strided,
    )
    from bliss_tpu_torch.routes import Routes

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

    # timbral_flat: [B, F, 5], held like timbral_fft (relative 1e-5, below
    # +-1 on ties, the log2 sum through the geometric mean it gives; the
    # plain version is the same near-exact DFT, so that too holds 1e-5)
    got = DK.timbral_flat(x, nf)
    want = DK.timbral_flat_plain(x, nf)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[~fin], want[~fin]):
        fail("timbral_flat: non-finite entries differ from the plain version")
    diff = torch.where(fin, (got - want).abs(), 0.0)
    scale = torch.clamp(torch.where(fin, want.abs(), 0.0), min=1e-30)
    rel = max((diff[..., c] / scale[..., c]).max().item() for c in (0, 1, 4))
    below = diff[..., 2].max().item()
    geo = (diff[..., 3] * math.log(2.0) / 256).max().item()
    print(f"  timbral_flat relative error {rel:.3g}, geo_mean max {geo:.3g}, below max diff {below}",
          flush=True)
    if rel > 1e-5 or below > 1 or geo > 1e-5:
        fail(f"timbral_flat vs plain: relative {rel:.3g}, geo_mean {geo:.3g} (limits 1e-5), "
             f"below {below} (limit 1)")
    record(
        "timbral_flat", "bliss_tpu_torch/csrc/frame_dft.cu", "bliss_tpu/ops/pallas_dft.py:80",
        diff[..., [0, 1, 4]].max().item(),
        time_ms(lambda: DK.timbral_flat(x, nf), 10),
        time_ms(lambda: DK.timbral_flat_plain(x, nf), 2),
        x.numel() * 4 + b * nf * 5 * 4,
        b * nf * timbral_frame_ops(), None,
    )
    direct_ms = b * nf * (512 + 512 * 256 * 2 * 2 + 256 * 4 + 256 * 8) / F32_OPS_PER_S * 1e3
    print(f"  timbral_flat: the direct DFT's own operations at the f32 peak {direct_ms:.4f} ms "
          f"(the bound above counts an FFT a frame, as timbral_fft's)", flush=True)
    # the frame-level flatness ingredient of the two timbral kernels
    fft_rows = DK.timbral_fft(x, nf)
    both = torch.isfinite(got[..., 3]) & torch.isfinite(fft_rows[..., 3])
    gap = torch.where(both, (got[..., 3] - fft_rows[..., 3]).abs(), 0.0) * math.log(2.0) / 256
    print(f"  timbral_flat vs timbral_fft, per-frame geometric mean: max {gap.max().item():.3g}, "
          f"mean {gap.mean().item():.3g} (relative)", flush=True)
    del got, want, diff, scale, fin, fft_rows, both, gap
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
    from bliss_tpu_torch.io.fallback import FallbackDecoder
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
    ext, shard_len = LS._extended_shards(song, n, tpad, shards, dev)
    fps_max, hps, fps_t = shard_len // LS.HOP + 2, shard_len // LS.B_HOP, shard_len // LS.T_HOP
    base = LS._shard_base(shards, shard_len, dev)
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
    spectrum, valid = LS._chroma_spectrum(ext, shard_len, fps_max, n, torch.float32, tab)
    pitches, pmags, peak = CH.pip_track(spectrum, valid, LS.WINDOW)
    pos = peak & (pitches > 0.0)
    med = LS._global_median_midpoint(pmags, pos)
    med_sort = RD.masked_quantile_midpoint(pmags.reshape(1, -1), pos.reshape(1, -1))[0]
    if not torch.equal(med, med_sort):
        fail(f"long song: global median {med.item()!r} != sort median {med_sort.item()!r}")
    # what the sharded path pays for that median (2 x 32 eager counting
    # rounds over the whole plane) beside its whole chroma stage, and what
    # the radix select's key entry takes for the same plane as one song
    one_v, one_m = pmags.transpose(1, 2).view(1, -1), pos.transpose(1, 2).view(1, -1)
    if not torch.equal(TK.masked_quantile_midpoint_radix(one_v, one_m)[0], med):
        fail("long song: radix select over the sharded plane != the global median")
    gm_ms = time_ms(lambda: LS._global_median_midpoint(pmags, pos), 3)
    radix_ms = time_ms(lambda: TK.masked_quantile_midpoint_radix(one_v, one_m), 10)
    n_plane = pmags.numel()
    del pitches, pmags, peak, pos, one_v, one_m
    chroma_ms = time_ms(lambda: LS._chroma_raw(ext, shard_len, fps_max, n, torch.float32, tab), 2)
    print(f"  sharded chroma stage {chroma_ms:.3f} ms, of it _global_median_midpoint alone "
          f"{gm_ms:.3f} ms ({100 * gm_ms / chroma_ms:.1f}%; 64 counting rounds over {n_plane} "
          f"elements); the radix select (4 x bisect8_keys) on the same plane {radix_ms:.4f} ms "
          f"[{card}]", flush=True)
    bin_plane, _ = LS._tuning_planes(spectrum, valid)
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
    need = ("ct_frames", "frame_dft_mags", "timbral_fft", "histogram_int_plane")
    if any(launches.get(k, 0) < 1 for k in need):
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
    x1 = torch.as_tensor(buf, device=dev)
    lens1 = torch.as_tensor([n], device=dev)
    nfc = int(n_frames_stft(tpad, LS.HOP))
    mask1 = torch.arange(nfc, device=dev) < n_frames_stft(lens1, LS.HOP).unsqueeze(-1)
    print(f"  the bucketed route's {b_warm:.3f} s by stage:", flush=True)
    stage_breakdown(x1, lens1, mask1, int(n_frames_strided(tpad, 512, 256)), warm_up=False)
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
    del buf, song

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

    # ---- the long-song route of analyze_paths_batched over a file ----------
    with tempfile.TemporaryDirectory() as tmp:
        wav = pathlib.Path(tmp) / "long.wav"
        with wave.open(str(wav), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(22050)
            w.writeframes(np.clip(song21 * 32767, -32768, 32767).astype("<i2").tobytes())
        _build.reset_launches()
        t0 = time.perf_counter()
        routed = dict(analyze_paths_batched(
            FallbackDecoder, [wav], device="cuda", longsong_samples=20 * 60 * 22050,
            longsong_shards=shards,
        ))[wav]
        routed_s = time.perf_counter() - t0
        r_launches = dict(_build.LAUNCHES)
        _build.reset_launches()
        plain = dict(analyze_paths_batched(FallbackDecoder, [wav], device="cuda"))[wav]
        p_launches = dict(_build.LAUNCHES)
    if not isinstance(routed, Song) or not isinstance(plain, Song):
        fail(f"long-song file route: {routed!r} {plain!r}")
    d = np.abs(routed.analysis.as_arr1() - plain.analysis.as_arr1()).max()
    print(f"  analyze_paths_batched over a 21-min WAV: long-song route {routed_s:.2f} s (decode included), vs the "
          f"bucketed route max {d:.3g} (limit 2e-5)", flush=True)
    if r_launches.get("ct_frames", 0) < 1 or p_launches.get("ct_frames", 0):
        fail(f"long-song file route: launches routed {r_launches}, bucketed {p_launches}")
    if d > 2e-5:
        fail(f"long-song file route: routed vs bucketed {d:.3g} > 2e-5")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--songs", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm batch with torch.profiler")
    ap.add_argument("--corpus", choices=("default", "full"), default="default",
                    help="files phase: the default set, or every fixture of the drift corpus")
    args = ap.parse_args()
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

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"build: {len(logs)} kernel sources in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

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
    for k in results:
        results[k]["launches"] = launches[k]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v2b = analyze_batch(batch, lengths, version=2, device="cuda")
    warm_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    v1 = analyze_batch(batch, lengths, version=1, device="cuda")
    v1_s = time.perf_counter() - t0
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
    stage_breakdown(x, lens, frame_mask, nh)
    # both tuning routes below the gate that picks one by the bucket's length
    hold_tuning_routes(
        stft(x, 8192, 2205, lens, nfc), frame_mask, f"{b} x {args.seconds / 60:g}-min"
    )
    if args.profile:
        profile_batch(batch, lengths)

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
    routes_phase(record, results, x, batch, lengths, v2, cpu0, piano, tpad, card)
    del x, v2, batch
    torch.cuda.empty_cache()

    # ---- long buckets: the unfused tuning route --------------------------
    long_phase(rng, results, card, 8, 420.0, record_json=True)
    song21 = long_phase(rng, results, card, 2, 1260.0, record_json=False)

    # ---- one 60-minute song, time-sharded ---------------------------------
    longsong_phase(rng, record, results, song21, card)
    del song21

    # ---- files -----------------------------------------------------------
    files_phase(args.corpus, card)

    print(f"smoke run: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": list(results.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
