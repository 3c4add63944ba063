"""The stage counts of `perfbench/roofline.py`, pinned for an 8 x 5-min
batch against the per-kernel bounds of `chip_smoke.py` (lines 243-263,
362-375 and its `record` calls), which count at the padded shape: at a
song whose valid length is its bucket the two agree."""

import math

from perfbench import roofline

N = 7_340_032  # bucket_length(300 * 22050)
B = 8


def rfft_ops(n):
    return 2.5 * n * math.log2(n)


def test_counts_match_chip_smoke_at_the_bucket():
    work = {k: (B * ops, B * nbytes) for k, (ops, nbytes) in roofline.stage_work(N).items()}
    nf = (N - 512) // 128 + 1
    nh = (N - 512) // 256 + 1
    nfc = (N - 1) // 2205 + 1
    timbral_frame_ops = 512 + rfft_ops(512) + 256 * 4 + 256 * 8
    assert work["timbral"] == (B * nf * timbral_frame_ops, B * N * 4 + B * nf * 5 * 4)
    assert work["onset"] == (B * nh * (512 + rfft_ops(512) + 257 * 4 + 257 * 4),
                             B * N * 4 + B * nh * 4)
    assert work["chroma_stft"] == (B * nfc * (8192 + rfft_ops(8192) + 4097 * 4),
                                   B * (N + 16384) * 4 + B * nfc * 4097 * 4)
    n_blocks = nh // 128
    bi_ops = 512 * 513 + 512 * 2 + 128 * (16 + 4 + 7 + 3 + 2 + 2) + 256 * 6
    assert work["block_inputs"][0] == B * n_blocks * bi_ops
    bt_ops = 128 * 2 + 256 * 6 + 160 * 21 + 256 * 2
    assert work["beat_track"] == (B * n_blocks * bt_ops,
                                  B * n_blocks * (1028 * 4 + 44) + B * 4)
    # the tuning: the valid frames of the spectrum read once
    assert work["tuning"][1] == B * nfc * 4097 * 4


def test_numbers_of_the_batch():
    # chip_smoke.py's bounds at this shape (PERF.md's kernel table): timbral
    # 0.1034 ms by operations, specflux 0.0704 and ct_stft 0.2006 by bytes
    work = roofline.stage_work(N)
    assert round(B * roofline.bound_s(*work["timbral"]) * 1e3, 4) == 0.1034
    assert round(B * roofline.bound_s(*work["onset"]) * 1e3, 4) == 0.0704
    assert round(B * roofline.bound_s(*work["chroma_stft"]) * 1e3, 4) == 0.2006
    assert roofline.least_seconds([N] * B) == B * sum(
        roofline.bound_s(ops, nbytes) for ops, nbytes in work.values())


def test_counts_follow_the_valid_length():
    short, long = roofline.stage_work(30 * 22050), roofline.stage_work(900 * 22050)
    for stage in short:
        assert 0 < short[stage][0] < long[stage][0]
        assert 0 < short[stage][1] < long[stage][1]
