"""The port's command-line examples (bliss_tpu_torch/examples/) on the CPU:
ci_check.sh's example sequence with `--device cpu`, the printed vector
against tests/test_song.py's golden, and the playlist's order against the
JAX package's `closest_to_songs` over the same songs."""

import pytest

# the JAX package's comparisons: a host without JAX skips this module
pytest.importorskip("jax")

import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

from bliss_tpu_torch.examples import analyze, distance, library, library_extra_info, playlist
from test_song import GOLDEN_V2

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"


def _vector(line: str) -> list:
    return json.loads(line.split(": ", 1)[1])


def test_analyze_as_a_module_matches_golden():
    """`python -m bliss_tpu_torch.examples.analyze --device cpu` prints the
    golden vector (1e-5, as tests/test_song.py holds the JAX package)."""
    proc = subprocess.run(
        [sys.executable, "-m", "bliss_tpu_torch.examples.analyze", "--device", "cpu",
         "tests/data/s16_mono_22_5kHz.flac"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    (line,) = proc.stdout.splitlines()
    assert line.startswith("tests/data/s16_mono_22_5kHz.flac: ")
    np.testing.assert_allclose(_vector(line), GOLDEN_V2, atol=1e-5)


def test_usage_errors_exit_one(capsys):
    assert analyze.main(["--device", "cpu"]) == 1
    assert distance.main(["--device", "cpu", str(DATA / "piano.flac")]) == 1
    assert "usage" in capsys.readouterr().err


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """ci_check.sh's example sequence on the port's CLIs, `--device cpu`;
    each step's exit code and standard output."""
    tmp = tmp_path_factory.mktemp("examples")
    music = tmp / "music"
    music.mkdir()
    for name in ("s16_mono_22_5kHz.flac", "piano.flac", "s32_stereo_44_1_kHz.mp3"):
        shutil.copy(DATA / name, music / name)
    seed = str(music / "s16_mono_22_5kHz.flac")
    steps = [
        ("analyze", analyze, [str(DATA / "s16_mono_22_5kHz.flac")]),
        ("distance", distance, [str(DATA / "s16_mono_22_5kHz.flac"), str(DATA / "piano.flac")]),
        ("playlist", playlist, [str(music), "-o", str(tmp / "playlist.m3u"),
                                "-a", str(tmp / "analysis.json")]),
        ("library init", library, ["init", str(music), "-c", str(tmp / "config.json"),
                                   "-d", str(tmp / "songs.db")]),
        ("library playlist", library, ["playlist", "-c", str(tmp / "config.json"), seed, "2"]),
        ("extra init", library_extra_info, ["init", str(music), "-c",
                                            str(tmp / "config_extra.json")]),
        ("extra playlist", library_extra_info, ["playlist", "-c", str(tmp / "config_extra.json"),
                                                seed, "2"]),
    ]
    return tmp, music, {name: _run(module, args + ["--device", "cpu"]) for name, module, args in steps}


def _run(module, argv):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    return rc, out.getvalue()


def test_sequence_exits_zero(sequence):
    tmp, _, runs = sequence
    assert {name: rc for name, (rc, _) in runs.items()} == {name: 0 for name in runs}
    assert (tmp / "playlist.m3u").stat().st_size > 0


def test_sequence_vectors_match_golden(sequence):
    tmp, music, runs = sequence
    np.testing.assert_allclose(_vector(runs["analyze"][1].strip()), GOLDEN_V2, atol=1e-5)
    cache = json.loads((tmp / "analysis.json").read_text())
    np.testing.assert_allclose(cache[str(music / "s16_mono_22_5kHz.flac")], GOLDEN_V2, atol=1e-5)
    assert runs["distance"][1].startswith("d(") and float(runs["distance"][1].split("= ")[1]) > 0


def test_playlist_order_matches_jax(sequence):
    from bliss_tpu import Analysis, FeaturesVersion, Song
    from bliss_tpu.playlist import closest_to_songs, euclidean_distance

    tmp, _, runs = sequence
    cache = json.loads((tmp / "analysis.json").read_text())
    songs = [Song(path=p, analysis=Analysis(cache[p], FeaturesVersion.latest()))
             for p in sorted(cache)]
    want = [str(s.path) for s in closest_to_songs([songs[0]], songs, euclidean_distance)]
    assert (tmp / "playlist.m3u").read_text().splitlines() == want


def test_library_playlists(sequence):
    _, music, runs = sequence
    seed = str(music / "s16_mono_22_5kHz.flac")
    lines = runs["library playlist"][1].splitlines()
    assert len(lines) == 2 and lines[0] == seed
    extra = runs["extra playlist"][1].splitlines()
    assert len(extra) == 2 and extra[0].startswith(seed + " {'size': ")


def test_chip_smoke_runs_the_examples_on_its_decoder(monkeypatch):
    """Where the native decoder does not build, chip_smoke.py starts each
    example through a stub that makes FallbackDecoder its DefaultDecoder:
    the printed vector is FallbackDecoder's, not FFmpegDecoder's, on a file
    where the two decoders' features differ."""
    import chip_smoke
    from bliss_tpu_torch.io.decoder import FFmpegDecoder
    from bliss_tpu_torch.io.fallback import FallbackDecoder

    song = "tests/data/white_noise.mp3"
    monkeypatch.setattr(chip_smoke, "DECODER", FallbackDecoder)
    proc = subprocess.run([*chip_smoke.example_command("analyze"), song, "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    (line,) = proc.stdout.splitlines()
    vec = np.asarray(_vector(line), np.float32)
    fallback = FallbackDecoder.song_from_path(song, device="cpu").analysis.as_arr1()
    native = FFmpegDecoder.song_from_path(song, device="cpu").analysis.as_arr1()
    assert np.abs(vec - fallback).max() <= 1e-6 < np.abs(vec - native).max()
    monkeypatch.setattr(chip_smoke, "DECODER", FFmpegDecoder)
    assert chip_smoke.example_command("analyze")[1:] == ["-m", "bliss_tpu_torch.examples.analyze"]
