"""The port's file-to-features path against the JAX package on the CPU:
its own copy of the FFI-free decoders (bit-identical PCM and tags), the
per-song entry points, and the batch driver `analyze_paths_batched`
(features within 1e-5, the same tracks, metadata and error classes)."""

import pathlib

import numpy as np
import pytest
import torch

from bliss_tpu_torch import errors as TE
from bliss_tpu_torch.cue import BlissCue
from bliss_tpu_torch.io import batch as TB
from bliss_tpu_torch.io import fallback as TF
from bliss_tpu_torch.io.decoder import DefaultDecoder, FFmpegDecoder
from bliss_tpu_torch.song import AnalysisOptions, Song

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    """The fixtures' folder, as tests/conftest.py gives it: this module's
    own, so that its `cuda` case runs with `--noconftest` too."""
    return DATA

TAGS = (
    "title", "artist", "album", "album_artist", "genre", "track_number",
    "disc_number", "duration",
)


@pytest.mark.parametrize(
    "name,decoder",
    [
        ("s16_mono_22_5kHz.flac", "FlacDecoder"),
        ("s32_stereo_44_1_kHz.flac", "FlacDecoder"),
        ("no_tags.flac", "FlacDecoder"),
        ("s16_mono_22_5kHz.mp3", "Mp3Decoder"),
        ("special-tags.mp3", "Mp3Decoder"),
        ("capacity_fix.ogg", "OggDecoder"),
        ("chroma/Cmaj.ogg", "OggDecoder"),
        ("piano.wav", "WavDecoder"),
        ("flush_test_52000.wav", "WavDecoder"),
        ("drift/vox_aac_64k.m4a", "M4aDecoder"),
    ],
)
def test_decoders_match_jax_fallback(data_dir, name, decoder):
    """Each decoder of the port, and its FallbackDecoder dispatch, gives
    the PCM and tags of the JAX package's FallbackDecoder exactly."""
    from bliss_tpu.io import fallback as JF

    path = data_dir / name
    want = JF.FallbackDecoder.decode(path)
    got = getattr(TF, decoder).decode(path)
    assert got.sample_array.dtype == np.float32
    assert np.array_equal(got.sample_array, want.sample_array)
    for tag in TAGS:
        assert getattr(got, tag) == getattr(want, tag), tag
    if name.endswith(".wav"):
        routed = TF.FallbackDecoder.decode(path)
        assert np.array_equal(routed.sample_array, want.sample_array)
    assert DefaultDecoder is FFmpegDecoder


@pytest.mark.parametrize("name", ["nonexistent.flac", "nonexistent", "picture.png"])
def test_decode_errors_match_jax(data_dir, name):
    from bliss_tpu.io import fallback as JF

    path = data_dir / name
    with pytest.raises(Exception) as want:
        JF.FallbackDecoder.decode(path)
    with pytest.raises(TE.BlissError) as got:
        TF.FallbackDecoder.decode(path)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_song_from_path_on_cpu(data_dir):
    """Decoder.song_from_path(device="cpu") == the JAX package's within
    1e-5, with the same record; too short songs raise AnalysisError."""
    from bliss_tpu.io import fallback as JF

    path = data_dir / "piano.flac"
    want = JF.FallbackDecoder.song_from_path(path)
    got = TF.FallbackDecoder.song_from_path(path, device="cpu")
    assert isinstance(got, Song)
    np.testing.assert_allclose(got.analysis.as_arr1(), want.analysis.as_arr1(), atol=1e-5)
    for tag in TAGS + ("path",):
        assert getattr(got, tag) == getattr(want, tag), tag
    with pytest.raises(TE.AnalysisError):
        TF.FallbackDecoder.song_from_path(data_dir / "empty.wav", device="cpu")


def test_analyze_paths_and_cue_on_cpu(data_dir):
    """The per-song driver and BlissCue on the CPU: the CUE's three
    tracks, its missing audio file as a DecodingError, a missing path."""
    cue = BlissCue.songs_from_path(
        TF.FallbackDecoder, data_dir / "testcue.cue", AnalysisOptions(), "cpu"
    )
    assert [type(r).__name__ for r in cue] == ["Song"] * 3 + ["DecodingError"]
    assert [s.title for s in cue[:3]] == ["Renaissance", "Piano", "Tone"]
    assert all(s.cue_info.audio_file_path.name == "testcue.flac" for s in cue[:3])
    results = list(
        TF.FallbackDecoder.analyze_paths(
            [data_dir / "s16_mono_22_5kHz.flac", data_dir / "nonexistent.flac"],
            device="cpu",
        )
    )
    assert isinstance(results[0][1], Song)
    assert isinstance(results[1][1], TE.DecodingError)


def _by_path(results) -> dict:
    return {str(p): r for p, r in results}


#: The files on which the FFI-free decoders put features up to 6.53e-4
#: from the native decoder's (white_noise.mp3, feature 1).
NATIVE_DRIFT = ["s32_stereo_44_1_kHz.flac", "s32_stereo_44_1_kHz.mp3", "white_noise.mp3"]


@pytest.mark.parametrize(
    "version,decoders",
    [(2, "fallback"), (1, "fallback"), (2, "default"), (1, "default")],
    ids=["2", "1", "default-2", "default-1"],
)
def test_batched_matches_jax_on_cpu(data_dir, version, decoders):
    """analyze_paths_batched(device="cpu") vs the JAX batch driver on the
    JAX CPU backend, both with the FFI-free decoders or both with their
    default (native libav) decoders: features within 1e-5 per feature, the
    same CUE tracks and metadata, the same error classes for a too-short
    song and a missing file."""
    from bliss_tpu.io import batch as JB
    from bliss_tpu.io import decoder as JD
    from bliss_tpu.io import fallback as JF
    from bliss_tpu.song import AnalysisOptions as JOptions

    paths = [
        data_dir / "piano.flac",
        data_dir / "s16_mono_22_5kHz.flac",
        data_dir / "testcue.cue",
        data_dir / "empty.wav",
        data_dir / "nonexistent.flac",
    ]
    jax_decoder, port_decoder = JF.FallbackDecoder, TF.FallbackDecoder
    if decoders == "default":
        paths = [data_dir / name for name in NATIVE_DRIFT] + paths[3:]
        jax_decoder, port_decoder = JD.DefaultDecoder, DefaultDecoder
        assert jax_decoder is JD.FFmpegDecoder and port_decoder is FFmpegDecoder
    want = _by_path(
        JB.analyze_paths_batched(
            jax_decoder, paths, JOptions(features_version=version), batch_size=4
        )
    )
    got = _by_path(
        TB.analyze_paths_batched(
            port_decoder, paths, AnalysisOptions(features_version=version),
            batch_size=4, device="cpu",
        )
    )
    assert sorted(got) == sorted(want)
    # 3 files, 3 CUE tracks, the CUE's missing file, an error; or 5 files
    assert len(got) == (8 if decoders == "fallback" else 5)
    for key, w in want.items():
        g = got[key]
        assert type(g).__name__ == type(w).__name__, key
        if type(w).__name__ != "Song":
            assert str(g) == str(w)
            continue
        assert g.features_version == version
        np.testing.assert_allclose(g.analysis.as_arr1(), w.analysis.as_arr1(), atol=1e-5)
        for tag in TAGS + ("path",):
            assert getattr(g, tag) == getattr(w, tag), (key, tag)
        assert (g.cue_info is None) == (w.cue_info is None)
        if w.cue_info is not None:
            assert g.cue_info.cue_path == w.cue_info.cue_path
            assert g.cue_info.audio_file_path == w.cue_info.audio_file_path


def test_batched_buckets_and_long_batch(data_dir, monkeypatch):
    """Songs are grouped by bucket; a bucket above LONG_SONG takes a
    quarter of the batch; a partial bucket is flushed at the end."""
    seen = []
    real = TB.analyze_tensor

    def spy(x, lengths, version, dtype):
        seen.append((tuple(x.shape), lengths.tolist()))
        return real(x, lengths, version, dtype)

    monkeypatch.setattr(TB, "analyze_tensor", spy)
    monkeypatch.setattr(TB, "LONG_SONG", 1 << 16)  # piano's bucket is 131,072
    paths = [data_dir / "piano.wav", data_dir / "piano.flac", data_dir / "flush_test_52000.wav"]
    out = _by_path(TB.analyze_paths_batched(TF.FallbackDecoder, paths, batch_size=4, device="cpu"))
    assert all(isinstance(r, Song) for r in out.values())
    shapes = sorted(s for s, _ in seen)
    assert shapes == [(1, 131072), (1, 131072), (4, 24576)]
    np.testing.assert_array_equal(
        out[str(paths[0])].analysis.as_arr1(), out[str(paths[1])].analysis.as_arr1()
    )


@pytest.mark.cuda
def test_batched_on_the_card_matches_cpu(data_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    paths = [data_dir / "piano.flac", data_dir / "testcue.cue"]
    cpu = _by_path(TB.analyze_paths_batched(TF.FallbackDecoder, paths, device="cpu"))
    gpu = _by_path(TB.analyze_paths_batched(TF.FallbackDecoder, paths, device="cuda"))
    assert sorted(cpu) == sorted(gpu)
    for key, c in cpu.items():
        if isinstance(c, Song) and "CUE_TRACK003" not in key:  # track 3 is a pure tone
            np.testing.assert_allclose(gpu[key].analysis.as_arr1(), c.analysis.as_arr1(), atol=1e-4)


def test_port_decoders_are_copies():
    """The decoders are the JAX package's files apart from import lines."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    for name in ("wav", "flac", "mp3", "mp3_tables", "vorbis", "mp4", "aac", "aac_tables", "alac", "fallback"):
        ours = (repo / "bliss_tpu_torch" / "io" / f"{name}.py").read_text().splitlines()
        theirs = (repo / "bliss_tpu" / "io" / f"{name}.py").read_text().splitlines()
        assert ours == theirs, name
