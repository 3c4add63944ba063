"""The port's native libav decoder (`bliss_tpu_torch.io.decoder.FFmpegDecoder`):
the reference's adler32 golden hashes and tag cases (bliss-rs
src/song/decoder/ffmpeg.rs:379-527, as tests/test_decoder.py holds them for
the JAX package), PCM and tags bit for bit against bliss_tpu's
FFmpegDecoder on every audio fixture, sources that are copies of
bliss_tpu/io/native/, a build that processes may start at once, and a
missing compiler or libav that raises instead of falling back."""

import pathlib
import shutil
import subprocess
import sys
import zlib

import numpy as np
import pytest

from bliss_tpu_torch.errors import AnalysisError, DecodingError
from bliss_tpu_torch.io import _native
from bliss_tpu_torch.io import decoder as TD
from bliss_tpu_torch.io.decoder import FFmpegDecoder, PreAnalyzedSong, _parse_track_number

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"

#: Every file of tests/data, tests/data/chroma and tests/data/drift (the
#: audio fixtures, the CUE sheets and a picture), and two missing paths.
FIXTURES = sorted(
    str(p.relative_to(DATA))
    for d in (DATA, DATA / "chroma", DATA / "drift")
    for p in d.iterdir()
    if p.is_file()
) + ["nonexistent", "nonexistent.flac"]


def _decode_hash(path):
    song = FFmpegDecoder.decode(path)
    return zlib.adler32(np.asarray(song.sample_array, np.float32).tobytes())


@pytest.mark.parametrize(
    "name,expected",
    [
        ("s16_mono_22_5kHz.flac", 0x5E01930B),
        ("s32_mono_44_1_kHz.flac", 0xA0F8B8AF),
        ("s32_stereo_44_1_kHz.flac", 0xBBCBA1CF),
        ("s16_stereo_22_5kHz.flac", 0x1D7B2D6D),
        ("s32_stereo_44_1_kHz.mp3", 0x69CA6906),
        ("no_channel.wav", 0xD594429C),
        ("piano.wav", 0xDE831E82),
    ],
)
def test_decode_hashes(name, expected):
    assert _decode_hash(DATA / name) == expected


def test_tags():
    song = FFmpegDecoder.decode(DATA / "s16_mono_22_5kHz.flac")
    assert song.artist == "David TMX"
    assert song.album_artist == "David TMX - Album Artist"
    assert song.title == "Renaissance"
    assert song.album == "Renaissance"
    assert song.track_number == 2
    assert song.disc_number == 1
    assert song.genre == "Pop"
    assert abs(song.duration * 1000 - 11070.0) < 10.0


def test_special_tags():
    song = FFmpegDecoder.decode(DATA / "special-tags.mp3")
    assert song.disc_number == 2
    assert song.track_number == 6


def test_unsupported_tags():
    song = FFmpegDecoder.decode(DATA / "unsupported-tags.mp3")
    assert song.track_number is None


def test_empty_tags():
    song = FFmpegDecoder.decode(DATA / "no_tags.flac")
    assert song.artist is None
    assert song.title is None
    assert song.album is None
    assert song.track_number is None
    assert song.disc_number is None
    assert song.genre is None


def test_decode_errors():
    with pytest.raises(DecodingError):
        FFmpegDecoder.decode("nonexistent")
    with pytest.raises(DecodingError, match="No audio stream"):
        FFmpegDecoder.decode(DATA / "picture.png")


def test_parse_track_number():
    assert _parse_track_number("02") == 2
    assert _parse_track_number("06/24") == 6
    assert _parse_track_number("02test/05") is None
    assert _parse_track_number(None) is None


def test_decode_capacity_fix_ogg():
    """ffmpeg.rs test_decode_right_capacity_vec: the ~10 s capacity_fix.ogg
    decodes fully."""
    song = FFmpegDecoder.decode(DATA / "capacity_fix.ogg")
    n = np.asarray(song.sample_array).shape[0]
    assert n > 5 * 22050
    assert abs(n / 22050 - song.duration) < 1.0


def test_pre_analyzed_song_to_song_empty_fails():
    """ffmpeg.rs test_try_from: a sample-less PreAnalyzedSong is no Song."""
    with pytest.raises(AnalysisError):
        PreAnalyzedSong().to_song(device="cpu")


def test_analyze_paths_mixed_results():
    """ffmpeg.rs test_analyze_paths: a missing path errors, a song analyzes."""
    from bliss_tpu_torch.song import Song

    results = {
        str(p): r
        for p, r in FFmpegDecoder.analyze_paths(
            [DATA / "nonexistent", DATA / "piano.flac"], device="cpu"
        )
    }
    assert isinstance(results[str(DATA / "nonexistent")], DecodingError)
    assert isinstance(results[str(DATA / "piano.flac")], Song)


def test_analyze_paths_with_cores():
    """ffmpeg.rs test_analyze_paths_with_cores: a core count far above the
    machine's works, and a missing CUE errors."""
    from bliss_tpu_torch.song import AnalysisOptions, Song

    results = {
        str(p): r
        for p, r in FFmpegDecoder.analyze_paths_with_options(
            [DATA / "nonexistent", DATA / "piano.flac", DATA / "nonexistent.cue"],
            AnalysisOptions(number_cores=2**62),
            device="cpu",
        )
    }
    assert isinstance(results[str(DATA / "piano.flac")], Song)
    assert not isinstance(results[str(DATA / "nonexistent")], Song)
    assert not isinstance(results[str(DATA / "nonexistent.cue")], Song)


def test_analyze_paths_empty():
    """ffmpeg.rs test_analyze_paths_with_cores_empty_paths."""
    from bliss_tpu_torch.song import AnalysisOptions

    assert list(FFmpegDecoder.analyze_paths_with_options([], AnalysisOptions(), "cpu")) == []


TAGS = ("title", "artist", "album", "album_artist", "genre", "track_number",
        "disc_number", "duration", "path")


@pytest.mark.parametrize("name", FIXTURES)
def test_bit_for_bit_with_jax_ffmpeg_decoder(name):
    """The port's PCM and tags equal bliss_tpu's FFmpegDecoder's bit for
    bit; a file that fails fails with the same class and message."""
    from bliss_tpu.io.decoder import FFmpegDecoder as JaxFFmpegDecoder

    path = DATA / name
    try:
        want = JaxFFmpegDecoder.decode(path)
    except Exception as e:  # noqa: BLE001 - compared below
        with pytest.raises(Exception) as got:
            FFmpegDecoder.decode(path)
        assert (type(got.value).__name__, str(got.value)) == (type(e).__name__, str(e))
        return
    got = FFmpegDecoder.decode(path)
    assert got.sample_array.dtype == np.float32 == want.sample_array.dtype
    assert got.sample_array.tobytes() == want.sample_array.tobytes()
    for tag in TAGS:
        assert getattr(got, tag) == getattr(want, tag), tag


@pytest.mark.parametrize(
    "name", ["bliss_decode.cpp", "bliss_encode.cpp", "Makefile", "asan_smoke.cpp",
             "tsan_smoke.cpp", "tsan.supp"],
)
def test_native_sources_are_copies(name):
    ours = REPO / "bliss_tpu_torch" / "io" / "native" / name
    assert ours.read_bytes() == (REPO / "bliss_tpu" / "io" / "native" / name).read_bytes()


def test_no_binary_beside_the_sources():
    """The build goes into the git-ignored build folder; a file the
    Makefile's own targets leave beside the sources is git-ignored too."""
    native = REPO / "bliss_tpu_torch" / "io" / "native"
    ignored = (REPO / ".gitignore").read_text().splitlines()
    sources = {"bliss_decode.cpp", "bliss_encode.cpp", "Makefile", "asan_smoke.cpp",
               "tsan_smoke.cpp", "tsan.supp"}
    for name in ("bliss_encode", "bliss_decode_asan", "bliss_decode_tsan"):
        assert f"bliss_tpu_torch/io/native/{name}" in ignored, name
    for p in native.iterdir():
        assert p.name in sources or p.suffix == ".so" or (
            f"bliss_tpu_torch/io/native/{p.name}" in ignored), p.name
    assert _native.BUILD == REPO / "bliss_tpu_torch" / "build"
    assert "bliss_tpu_torch/build/" in ignored and "*.so" in ignored
    assert _native.decoder_library().parent == _native.BUILD
    assert _native.encoder().parent == _native.BUILD


#: One process of the race test: start up, wait for the gate, then decode
#: the golden fixture through a build folder that no one has built in.
RACER = """
import pathlib, sys, time, zlib
sys.path.insert(0, sys.argv[1])
from bliss_tpu_torch.io.decoder import FFmpegDecoder
gate = pathlib.Path(sys.argv[2])
pathlib.Path(sys.argv[3]).touch()
while not gate.exists():
    time.sleep(0.01)
song = FFmpegDecoder.decode(sys.argv[4])
print(hex(zlib.adler32(song.sample_array.tobytes())))
"""


def test_processes_build_at_once(tmp_path):
    """Four processes load the decoder at once over an empty build folder
    (a copy of the package): each decodes the golden fixture right, and the
    folder ends with one library and no half-written file."""
    root = tmp_path / "copy"
    shutil.copytree(REPO / "bliss_tpu_torch", root / "bliss_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    gate = tmp_path / "go"
    procs = []
    for i in range(4):
        ready = tmp_path / f"ready{i}"
        procs.append((ready, subprocess.Popen(
            [sys.executable, "-c", RACER, str(root), str(gate), str(ready),
             str(DATA / "s16_mono_22_5kHz.flac")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    try:
        import time

        deadline = time.monotonic() + 120
        while not all(r.exists() for r, _ in procs) and time.monotonic() < deadline:
            assert all(p.poll() is None for _, p in procs), [p.communicate() for _, p in procs]
            time.sleep(0.05)
        assert not (root / "bliss_tpu_torch" / "build").exists()
        gate.touch()
        outs = [p.communicate(timeout=120) for _, p in procs]
    finally:
        for _, p in procs:
            p.kill()
    assert [o.strip() for o, _ in outs] == ["0x5e01930b"] * 4, outs
    built = sorted(p.name for p in (root / "bliss_tpu_torch" / "build").iterdir())
    assert len(built) == 1 and built[0].startswith("libbliss_decode-"), built
    assert built[0].endswith(".so")


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The native build with no library built or loaded in this process,
    into `tmp_path`."""
    monkeypatch.setattr(_native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_native, "_built", {})
    monkeypatch.setattr(_native, "_failed", {})
    monkeypatch.setattr(TD, "_lib", None)
    return tmp_path


def test_no_compiler_raises(fresh_build, monkeypatch):
    """Without g++ the first decode raises DecodingError, and so does every
    later one: no decode falls back to the FFI-free stack."""
    real = shutil.which
    monkeypatch.setattr(_native.shutil, "which", lambda n: None if n == "g++" else real(n))
    for _ in range(2):
        with pytest.raises(DecodingError, match="g\\+\\+ not found"):
            FFmpegDecoder.decode(DATA / "piano.wav")


def test_missing_libav_names_it(fresh_build, monkeypatch):
    """A compile that fails names the libav libraries pkg-config lacks and
    the compiler's first error; the batch driver hands that error back for
    the song instead of decoding it another way."""
    from bliss_tpu_torch.io.batch import analyze_paths_batched

    native = fresh_build / "native"
    native.mkdir()
    (native / "bliss_decode.cpp").write_text("#include <libavnone/avnone.h>\n")
    monkeypatch.setattr(_native, "NATIVE", native)
    monkeypatch.setattr(_native, "LIBAV", _native.LIBAV + ("libavnone",))
    with pytest.raises(DecodingError) as err:
        FFmpegDecoder.decode(DATA / "piano.wav")
    assert "libav missing (libavnone)" in str(err.value)
    assert "libavnone/avnone.h" in str(err.value)
    ((path, result),) = list(analyze_paths_batched(FFmpegDecoder, [DATA / "piano.wav"],
                                                   device="cpu"))
    assert isinstance(result, DecodingError) and str(result) == str(err.value)
    assert not (fresh_build / "build").exists() or not list((fresh_build / "build").iterdir())
