"""The port's `Library.update_library_recycled` and its segment worker
(`python -m bliss_tpu_torch.io.ingest_worker`) on the CPU: the five cases
of tests/test_recycled.py, each worker on `--devices cpu`, and a worker
told to use a card on a host without one."""

import pathlib
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from bliss_tpu_torch.errors import BlissError
from bliss_tpu_torch.io.fallback import FallbackDecoder
from bliss_tpu_torch.library import BaseConfig, Library

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"


def _paths(tmp):
    return [DATA / "s16_mono_22_5kHz.flac", DATA / "piano.flac", tmp / "missing.wav"]


def _library(folder, decoder=FallbackDecoder):
    config = BaseConfig(config_path=folder / "config.json", database_path=folder / "songs.db")
    return Library(config, decoder, device="cpu")


def _vectors(lib):
    return {str(s.bliss_song.path): s.bliss_song.analysis.as_arr1()
            for s in lib.songs_from_library()}


def _analyzed(db):
    with sqlite3.connect(db) as conn:
        return {r[0] for r in conn.execute("select path from song where analyzed = true")}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The recycled store (two segments of two, the second pre-spawned) and
    the in-process store of the same paths."""
    tmp = tmp_path_factory.mktemp("recycled")
    paths = [str(p) for p in _paths(tmp)]
    recycled = _library(tmp / "recycled")
    recycled.update_library_recycled(paths, False, False, segment_songs=2)
    inproc = _library(tmp / "inproc")
    inproc.update_library(paths, False, False)
    return tmp, paths, recycled, inproc


def test_recycled_matches_update_library(stores):
    tmp, paths, recycled, inproc = stores
    assert _analyzed(recycled.config.database_path) == set(paths[:-1])
    assert {str(e.song_path) for e in recycled.get_failed_songs()} == {paths[-1]}
    assert {str(e.song_path) for e in inproc.get_failed_songs()} == {paths[-1]}
    got, want = _vectors(recycled), _vectors(inproc)
    assert sorted(got) == sorted(want) == sorted(paths[:-1])
    for key in want:
        assert np.array_equal(got[key], want[key]), key  # bit for bit on the CPU


def test_recycled_matches_jax_update_library(stores):
    """The JAX package's in-process `update_library` on the same files, at
    the tolerance of tests/test_torch_library.py (the analyzers' CPU gap)."""
    pytest.importorskip("jax")
    from bliss_tpu.io.fallback import FallbackDecoder as JaxFallback
    from bliss_tpu.library import BaseConfig as JaxConfig
    from bliss_tpu.library import Library as JaxLibrary

    tmp, paths, recycled, _ = stores
    jlib = JaxLibrary(JaxConfig(config_path=tmp / "jax" / "config.json",
                                database_path=tmp / "jax" / "songs.db"), JaxFallback)
    jlib.update_library(paths, False, False)
    got = _vectors(recycled)
    want = {str(s.bliss_song.path): s.bliss_song.analysis.as_arr1()
            for s in jlib.songs_from_library()}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)
    assert {str(e.song_path) for e in jlib.get_failed_songs()} == {paths[-1]}


def test_recycled_second_call_spawns_nothing(stores, monkeypatch):
    _, paths, recycled, _ = stores
    calls = []
    real_popen = subprocess.Popen

    def counting_popen(*a, **k):
        calls.append(a)
        return real_popen(*a, **k)

    monkeypatch.setattr(subprocess, "Popen", counting_popen)
    recycled.update_library_recycled(paths[:-1], False, False, segment_songs=8)
    assert calls == []  # set difference: nothing left to analyze
    assert len(_analyzed(recycled.config.database_path)) == 2


class _FakeProc:
    killed = 0

    def wait(self, timeout=None):
        return 3

    def kill(self):
        _FakeProc.killed += 1


def test_recycled_failed_segment_raises(tmp_path, monkeypatch):
    spawned = []

    def failing_popen(cmd, **k):
        spawned.append(cmd)
        return _FakeProc()

    monkeypatch.setattr(subprocess, "Popen", failing_popen)
    lib = _library(tmp_path)
    with pytest.raises(BlissError, match="failed twice"):
        lib.update_library_recycled([str(DATA / "piano.flac")], False, False, segment_songs=4)
    assert len(spawned) == 2  # one fresh retry, then give up
    # each worker gets the library's devices, explicitly
    assert all(cmd[cmd.index("--devices") + 1] == "cpu" for cmd in spawned)
    assert all(cmd[cmd.index("--decoder") + 1] == "bliss_tpu_torch.io.fallback:FallbackDecoder"
               for cmd in spawned)


def test_recycled_parent_builds_the_native_decoder(tmp_path, monkeypatch):
    """With the default decoder the parent builds the native decoder before
    it starts a worker, so the workers only load it."""
    from bliss_tpu_torch.io import _native

    events = []
    build = _native.decoder_library
    monkeypatch.setattr(_native, "decoder_library", lambda: events.append("build") or build())

    def recording_popen(cmd, **k):
        events.append(cmd[cmd.index("--decoder") + 1])
        return _FakeProc()

    monkeypatch.setattr(subprocess, "Popen", recording_popen)
    with pytest.raises(BlissError, match="failed twice"):
        _library(tmp_path, None).update_library_recycled([str(DATA / "piano.flac")], False,
                                                         False, segment_songs=4)
    assert events == ["build"] + ["bliss_tpu_torch.io.decoder:FFmpegDecoder"] * 2


def test_recycled_prespawn_gates_next_segment(tmp_path, monkeypatch):
    """With more than one segment the next segment's worker is started with a
    gate before this segment's result is known; the retry is ungated, and a
    failing run reaps the waiting worker. Without `prespawn` nothing is
    started ahead."""
    gates = []

    def recording_popen(cmd, **k):
        gates.append(cmd[cmd.index("--gate") + 1] if "--gate" in cmd else None)
        return _FakeProc()

    monkeypatch.setattr(subprocess, "Popen", recording_popen)
    paths = [str(DATA / name) for name in ("piano.flac", "s16_mono_22_5kHz.flac",
                                           "s16_stereo_22_5kHz.flac", "s32_mono_44_1_kHz.flac")]
    _FakeProc.killed = 0
    with pytest.raises(BlissError, match="failed twice"):
        _library(tmp_path / "a").update_library_recycled(paths, False, False, segment_songs=2)
    assert gates[0] is None and gates[1] is not None and gates[2] is None
    assert _FakeProc.killed >= 1  # the waiting pre-spawned worker was reaped
    gates.clear()
    with pytest.raises(BlissError, match="failed twice"):
        _library(tmp_path / "b").update_library_recycled(paths, False, False, segment_songs=2,
                                                         prespawn=False)
    assert gates == [None, None]


def test_recycled_delete_everything_else(stores, tmp_path):
    _, paths, recycled, _ = stores
    (tmp_path / "copy").mkdir()
    dst = sqlite3.connect(tmp_path / "copy" / "songs.db")
    recycled.sqlite_conn.backup(dst)
    dst.close()
    lib = _library(tmp_path / "copy")
    lib.update_library_recycled(paths[:1], True, False, segment_songs=8)
    assert _analyzed(lib.config.database_path) == set(paths[:1])


def test_worker_without_a_card_fails_and_stores_nothing(tmp_path):
    """A worker told `--devices cuda` on a host without a card exits
    non-zero with the device error; it does not analyze on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    lib = _library(tmp_path)
    segment = tmp_path / "seg.paths"
    segment.write_text(str(DATA / "piano.flac"))
    proc = subprocess.run(
        [sys.executable, "-m", "bliss_tpu_torch.io.ingest_worker", str(lib.config.config_path),
         str(segment), "--devices", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA requested" in proc.stderr
    with sqlite3.connect(lib.config.database_path) as conn:
        assert conn.execute("select count(*) from song").fetchone()[0] == 0
