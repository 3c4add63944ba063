"""The least time the card could take for one song's analysis, stage by
stage, at the song's valid length.

Each descriptor stage needs its operations at the chip's f32 rate and its
bytes at the HBM rate: its input read once, its output written once,
whatever kernel does it. The arithmetic is `chip_smoke.py`'s kernel bounds
(`bound`, `rfft_ops`, `timbral_frame_ops`, `BT_*`, `BI_ROW_*`), counted here
per stage at the valid frames, hops and blocks of the song and not at the
padded shape of a kernel's launch, so a later kernel that replaces another
leaves the count as it was. Work that depends on the data (the tuning's
peak count) is left out, so each stage's time is a lower bound.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit:
#: the HBM rate and the f32 rate outside the tensor cores.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12}

SAMPLE_BYTES = 4

# beat tracker (chip_smoke.py:250-263)
BT_BLOCK_BYTES = 1028 * 4
BT_OUT_BYTES = 4 + 8 * 4 + 8
BT_BLOCK_OPS = 128 * 2 + 256 * 6 + 160 * 21 + 256 * 2
BI_ROW_OPS = 512 * 513 + 512 * 2 + 128 * (16 + 4 + 7 + 3 + 2 + 2) + 256 * 6
BI_ROW_OUT_BYTES = 1028 * 4

CHROMA_BINS = 8192 // 2 + 1
#: pip_track's stencil rows (models/chroma.py:peak_band at n_fft 8192)
TUNING_ROWS = 1427


def rfft_ops(n: int) -> float:
    """Operations of an n-point real FFT, the conventional 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def timbral_frame_ops() -> float:
    """A 512-sample frame: the window product, an FFT, 256 magnitudes and
    the five reductions over them."""
    return 512 + rfft_ops(512) + 256 * 4 + 256 * 8


def stage_work(n: int) -> dict:
    """`{stage: (operations, bytes)}` of one song of `n` valid samples."""
    signal = n * SAMPLE_BYTES
    frames = (n - 512) // 128 + 1
    hops = (n - 512) // 256 + 1
    blocks = max((hops - 128) // 128 + 1, 0)
    chroma_frames = (n - 1) // 2205 + 1
    padded = n + 2 * 4096 + 8192
    return {
        "timbral": (frames * timbral_frame_ops(), signal + frames * 5 * 4),
        "onset": (hops * (512 + rfft_ops(512) + 257 * 4 + 257 * 4), signal + hops * 4),
        "block_inputs": (blocks * BI_ROW_OPS,
                         hops * 4 + 8 + (128 + 512) * 4 + blocks * BI_ROW_OUT_BYTES),
        "beat_track": (blocks * BT_BLOCK_OPS, blocks * (BT_BLOCK_BYTES + BT_OUT_BYTES) + 4),
        "chroma_stft": (chroma_frames * (8192 + rfft_ops(8192) + CHROMA_BINS * 4),
                        padded * SAMPLE_BYTES + chroma_frames * CHROMA_BINS * 4),
        "tuning": (chroma_frames * (CHROMA_BINS + 3 * TUNING_ROWS),
                   chroma_frames * CHROMA_BINS * 4),
        "chroma_product": (chroma_frames * (CHROMA_BINS + 2 * 12 * CHROMA_BINS + 120 * 3),
                           chroma_frames * CHROMA_BINS * 4 + 13 * 4),
        "zcr_loudness": (4 * n, 2 * signal + 3 * 4),
    }


def bound_s(ops: float, nbytes: float) -> float:
    """The larger of the operations' time and the bytes' time."""
    return max(ops / PEAKS["f32_ops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])


def least_seconds(lengths) -> float:
    """Σ over songs and stages of each stage's bound."""
    return sum(bound_s(ops, nbytes) for n in lengths for ops, nbytes in stage_work(int(n)).values())
