"""The generators repeat exactly by seed, and the scan's lengths match the
configuration file's distribution and route shares."""

import json
import pathlib

import numpy as np
import torch

from perfbench.kinds import scan
from perfbench.sources import pool
from perfbench.stores import uniform

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
BIG_SEED = 2**31 + 12345


def test_pcm_repeats_by_seed():
    a = pool.make_pool(2, 3.0, BIG_SEED, torch.device("cpu"), 25)
    b = pool.make_pool(2, 3.0, BIG_SEED, torch.device("cpu"), 25)
    c = pool.make_pool(2, 3.0, BIG_SEED + 1, torch.device("cpu"), 25)
    assert a.shape == (2, 3 * pool.RATE) and a.dtype == np.float32
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])
    assert np.abs(a).max() <= 0.91


def test_a_detuned_track_has_one_tuning():
    # the tuning estimate lands in the bin whose centre the detune drew, in
    # f64 and in f32 alike, so the reference holds a single tuning
    from perfbench.reference import analysis

    for seed in (BIG_SEED, 7, 2**40 + 3):
        rng = np.random.default_rng(seed)
        rng.integers(1 << 62), rng.choice(4), rng.permutation(4)  # the draws before the detune
        cents = int(rng.integers(-25, 25))
        x = pool.music_like(20 * pool.RATE, seed, torch.device("cpu"), 25)
        spec = analysis._spectrum(x, False)
        assert round(analysis._tuning(spec.to(torch.float64)) * 100) == cents
        assert round(analysis._tuning(spec) * 100) == cents


def test_song_table_repeats_and_keeps_the_lengths():
    lengths = scan.quantile_lengths({"dist": "lognormal", "mean": 278, "sigma": 0.5,
                                     "min": 30, "max": 900}, 256, 22050)
    shape = (7, 960 * 22050)
    a = scan.song_table(lengths, 1000, shape, BIG_SEED)
    assert np.array_equal(a, scan.song_table(lengths, 1000, shape, BIG_SEED))
    b = scan.song_table(lengths, 1000, shape, BIG_SEED + 1)
    assert not np.array_equal(a, b)
    # every seed scans the same lengths, block by block, in another order
    for block in range(3):
        rows = slice(256 * block, 256 * (block + 1))
        assert np.array_equal(np.sort(a[rows, 2]), np.sort(lengths))
        assert np.array_equal(np.sort(b[rows, 2]), np.sort(lengths))
    assert (a[:, 1] >= 0).all() and (a[:, 1] + a[:, 2] <= shape[1]).all()


def test_lengths_from_a_table_of_durations(tmp_path, monkeypatch):
    monkeypatch.setattr(scan, "ROOT", tmp_path)
    (tmp_path / "durations.txt").write_text("\n".join(str(s) for s in range(30, 630)) + "\n")
    lengths = scan.quantile_lengths({"dist": "table", "path": "durations.txt"}, 6, 100)
    # the evenly spaced quantiles of 30..629 s, between neighbours linearly
    assert lengths.tolist() == [round((30 + 599 * (k + 0.5) / 6) * 100) for k in range(6)]


def test_lengths_match_the_configuration():
    from bliss_tpu_torch.io.batch import LONG_SONG
    from bliss_tpu_torch.models.analyzer import bucket_length
    from bliss_tpu_torch.models.chroma import uses_fused_tuning
    from bliss_tpu_torch.ops.windows import n_frames_stft

    cfg = json.loads((CONFIGS / "fma_full-v2.json").read_text())
    lengths = scan.quantile_lengths(cfg["track_seconds"], 256, cfg["sample_rate"])
    mean_s = lengths.mean() / cfg["sample_rate"]
    assert abs(mean_s - cfg["track_seconds"]["mean"]) < 0.01 * cfg["track_seconds"]["mean"]
    padded = np.array([bucket_length(int(n)) for n in lengths])
    unfused = np.mean([not uses_fused_tuning(int(n_frames_stft(p, 2205)), torch.float32)
                       for p in padded])
    assert abs(unfused - cfg["routes"]["unfused_tuning_share"]) < 0.02
    assert abs(np.mean(padded > LONG_SONG) - cfg["routes"]["long_bucket_share"]) < 0.005
    assert lengths.max() <= cfg["pcm_pool"]["track_seconds"] * cfg["sample_rate"]


def test_store_rows_repeat_by_seed():
    f1, t1, a1 = uniform.rows(BIG_SEED, 5000)
    f2, t2, a2 = uniform.rows(BIG_SEED, 5000)
    assert np.array_equal(f1, f2) and t1 == t2 and a1 == a2
    assert not np.array_equal(f1, uniform.rows(BIG_SEED + 1, 5000)[0])
    assert 5000 - 50 <= len(np.unique(f1, axis=0)) < 5000 - 40  # ~1% exact copies
    assert sum(t1[i] == t1[i - 1] for i in range(1, 5000)) == 5  # 0.1% repeats


def test_the_reference_playlist_passes_its_judge():
    from perfbench.reference import playlist

    feats, titles, artists = uniform.rows(BIG_SEED, 4000)
    for seed_row in (0, 1234, 3999):
        rows = playlist.playlist(feats, titles, artists, seed_row)
        assert rows[0] == seed_row and len(rows) < 4000
        assert playlist.judge(feats, titles, artists, seed_row, rows, 1e-6) == (0, 0.0)
        assert playlist.judge(feats, titles, artists, seed_row, rows[:-1], 1e-6)[0] == 1
