"""The port's benches (bliss_tpu_torch/benches/) at a tiny size on the CPU:
each prints one JSON line with its documented keys; and the profiling
helpers (bliss_tpu_torch/utils/profiling.py)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from bliss_tpu_torch.benches import bench, drift, microbench, playlist_bench, soak
from bliss_tpu_torch.utils.profiling import RssSampler, device_trace

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"


def _one_json_line(capsys) -> dict:
    lines = capsys.readouterr().out.splitlines()
    parsed = []
    for line in lines:
        try:
            parsed.append(json.loads(line))
        except ValueError:
            continue
    assert len(parsed) == 1, lines
    assert lines[-1] == json.dumps(parsed[0])  # the last line
    return parsed[0]


def _has(out: dict, keys: str) -> None:
    missing = [k for k in keys.split() if k not in out]
    assert not missing, missing
    assert out["card"] is None  # no card here


def test_bench_wav_mix(tmp_path, capsys):
    """The default mix, now the encoded one (FLAC, MP3, Ogg Vorbis) at 12 s
    a song, decoded by the native decoder."""
    bench.main(["--device", "cpu", "--songs", "2", "--passes", "1", "--seconds", "12",
                "--fixtures", str(tmp_path)])
    out = _one_json_line(capsys)
    _has(out, "metric value unit songs_per_sec_median songs_per_sec_best audio_secs_per_sec_median "
              "audio_secs_per_sec_best decode_share analysis_songs_per_sec decode_s_summed samples "
              "songs failed mean_song_secs passes pass_s mix device card")
    assert out["songs"] == 2 and out["failed"] == 0 and out["passes"] == 1
    assert out["mix"] == "encoded"
    # the FLAC song to the sample; the MP3 one within the codec's frame padding
    assert 2 * 12 * 22050 <= out["samples"] <= 2 * 12 * 22050 + 2 * 1152
    assert out["mean_song_secs"] == pytest.approx(12.0, abs=0.1)
    assert 0.0 <= out["decode_share"] < 1.0 and out["songs_per_sec_best"] >= out["value"] > 0
    # the fixtures are written once: a second run reuses them
    stamps = {p.name: p.stat().st_mtime_ns for p in tmp_path.iterdir()}
    assert sorted(stamps) == sorted(f"12s_{n}" for n, _, _ in bench_mix())
    bench.run("cpu", "encoded", 1, 1, tmp_path, 12)
    assert stamps == {p.name: p.stat().st_mtime_ns for p in tmp_path.iterdir()}


def test_fixture_mix_is_the_repo_mix():
    """The JAX repo's mix (benches/fixtures.py): the same names, codecs, bit
    rates and durations, mean 215.8 s, and the same synthesized PCM."""
    import sys

    sys.path.insert(0, str(REPO))
    from benches import fixtures as jax_fixtures

    from bliss_tpu_torch.benches import fixtures

    assert bench_mix() == jax_fixtures.MIX
    assert [d for _, _, d in bench_mix()] == [170, 250, 180, 280, 175, 240]
    assert abs(np.mean([d for _, _, d in bench_mix()]) - 215.8) < 0.1
    assert fixtures.RATE == jax_fixtures.RATE
    assert np.array_equal(fixtures.music_like(3.0, 1001), jax_fixtures.music_like(3.0, 1001))


def bench_mix():
    from bliss_tpu_torch.benches.fixtures import MIX

    return MIX


def test_playlist_bench(capsys):
    playlist_bench.main(["--device", "cpu", "--n", "2000", "--queries", "3"])
    out = _one_json_line(capsys)
    _has(out, "metric value unit n queries playlist_from_p50_ms closest_to_songs_p50_ms "
              "top_k_p50_ms song_to_song_50_p50_ms song_to_song_full_s cold_ms build_s device card")
    assert out["n"] == 2000 and out["value"] > 0 and out["song_to_song_full_s"] is None


def test_drift_on_three_files(capsys):
    paths = [DATA / "piano.flac", DATA / "chroma" / "Cmaj.ogg", DATA / "empty.cue"]
    rc = drift.main(["--device", "cpu", "--dtype", "float32", "--paths"] + [str(p) for p in paths])
    out = _one_json_line(capsys)
    _has(out, "metric value ok failures contract device dtype reference card v2 v1")
    assert rc == 0 and out["ok"] and out["dtype"] == "float32"
    for v in ("v2", "v1"):
        assert out[v]["entries"] == 3 and out[v]["real"] == 1 and out[v]["degenerate"] == 1
        assert out[v]["failed_on_both"] == 1 and sum(out[v]["histogram"].values()) > 0
    assert out["value"] <= drift.REAL_LIMIT


def test_drift_breach_fails():
    """A route that is off on one file breaks the contract."""
    got = {"a": np.zeros(23), "b": None, "c": np.zeros(23)}
    ref = {"a": np.full(23, 2e-4), "b": np.zeros(23), "c": np.zeros(23)}
    _, real, failures = drift.compare(got, ref)
    assert len(failures) == 2 and len(real) == 2
    deg = sorted(drift.DEGENERATE)[0]
    g, r = np.zeros(23), np.zeros(23)
    g[12], r[14] = 1.0, 1.0
    assert drift.compare({deg: g}, {deg: r})[2]  # dominant chroma differs


def test_drift_sets_are_the_repo_sets():
    names = {p.name for p in drift.CORPUS}
    assert len(drift.CORPUS) >= 55 and "testcue.cue" in names and "empty.wav" not in names
    assert "medley_21min_vorbis_96k.ogg" in names and len(drift.V1_SUBSET) == 8
    assert all(p.exists() for p in drift.CORPUS + drift.V1_SUBSET)


def test_soak_with_bad_inputs_and_kill_resume(tmp_path, capsys):
    soak.main(["--phase", "all", "--n", "4", "--durations", "10", "12", "--device", "cpu",
               "--dir", str(tmp_path), "--period", "1"])
    out = _one_json_line(capsys)
    _has(out, "metric value elapsed_s analyzed failed inputs peak_rss_mb parent_peak_rss_mb "
              "worker_peak_rss_mb worker_peaks_rss_mb rss_slope_mb_per_min rss_samples ok failures "
              "device card resume")
    assert out["analyzed"] == 4 and out["failed"] == 3 and out["inputs"] == 7
    assert out["peak_rss_mb"] > 0 and out["ok"] and out["failures"] == []
    resume = out["resume"]
    assert resume["resume_analyzed"] == resume["expected"] == 7 - resume["killed_at"]
    assert 1 <= resume["killed_at"] < 4 and resume["total_in_db"] == 4
    # a process over the cap: the line, then exit 1
    with pytest.raises(SystemExit) as stop:
        soak.main(["--phase", "run", "--n", "4", "--device", "cpu", "--dir", str(tmp_path),
                   "--rss-cap-mb", "1"])
    out = _one_json_line(capsys)
    assert stop.value.code == 1 and not out["ok"] and "cap" in out["failures"][0]


def test_microbench(capsys):
    microbench.main(["--device", "cpu", "--repeat", "1"])
    out = _one_json_line(capsys)
    _has(out, "metric stages_ms song samples bucket repeat device card")
    for stage in ("tempo (full)", "chroma (full)", "chroma: estimate_tuning", "decode (host)",
                  "full analysis (1 song)"):
        assert out["stages_ms"][stage] > 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path / "trace") as prof:
        torch.fft.rfft(torch.ones(4096)).abs().sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("rfft" in e.get("name", "") for e in trace["traceEvents"])
    assert prof.key_averages()


def test_rss_sampler_sees_children():
    import subprocess
    import sys

    with RssSampler(period=0.05) as rss:
        proc = subprocess.Popen([sys.executable, "-c", "import time; x = bytearray(64 << 20); "
                                 "time.sleep(1)"])
        proc.wait()
    assert rss.child_peak_mb > 60 and rss.peak_mb >= rss.root_peak_mb + 60


@pytest.mark.parametrize("name", ["microbench", "drift"])
def test_bench_decodes_with_the_fallback_decoder(name, capsys, monkeypatch):
    """`--decoder fallback` names FallbackDecoder and never loads the
    native decoder, so a host without libav runs the bench; the JSON line
    names the decoder."""
    from bliss_tpu_torch.io import decoder

    def no_native():
        raise AssertionError("the native decoder was loaded")

    monkeypatch.setattr(decoder, "_load_lib", no_native)
    if name == "microbench":
        microbench.main(["--device", "cpu", "--repeat", "1", "--decoder", "fallback"])
    else:
        assert drift.main(["--device", "cpu", "--dtype", "float32", "--decoder", "fallback",
                           "--paths", str(DATA / "piano.flac")]) == 0
    out = _one_json_line(capsys)
    assert out["decoder"] == "FallbackDecoder"
    if name == "microbench":
        assert out["stages_ms"]["decode (host)"] > 0
    else:
        assert out["ok"] and out["v2"]["real"] == 1
