"""FFI-free fallback decode stack:
FLAC + MP3 + OGG Vorbis + WAV + M4A/MP4 (AAC-LC, ALAC) + ADTS AAC.

Mirrors the reference's Symphonia-based alternative decoder at full
format parity (bliss-rs src/song/decoder/symphonia.rs:86-403, features
symphonia-all incl. aac/isomp4/alac — Cargo.toml:55-66): pure in-process
decoding with no native dependencies, the same canonical output
(f32/mono/22050 Hz), the same stereo downmix ((L+R)·√2/2,
symphonia.rs:278-288), and the documented cross-decoder tolerance story
(symphonia.rs:701-750) instead of bit-parity with FFmpeg.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Optional

import numpy as np

from ..errors import DecodingError
from ..features import SAMPLE_RATE
from .decoder import Decoder, PreAnalyzedSong, _parse_track_number
from .flac import read_flac
from .mp3 import read_mp3
from .vorbis import read_vorbis
from .wav import WavDecoder, _downmix, resample_sinc


def _tag(tags: Dict[str, str], *keys: str) -> Optional[str]:
    for k in keys:
        if k in tags:
            return tags[k]
    return None


def _song_from_frames(
    path: pathlib.Path, frames: np.ndarray, rate: int, tags: Dict[str, str]
) -> PreAnalyzedSong:
    """[N, C] float frames + vorbis-comment-style tags → canonical
    PreAnalyzedSong (downmix + resample to f32/mono/22050 Hz)."""
    mono = _downmix(frames)
    samples = resample_sinc(mono, rate, SAMPLE_RATE)
    return PreAnalyzedSong(
        path=path,
        title=_tag(tags, "TITLE"),
        artist=_tag(tags, "ARTIST"),
        album=_tag(tags, "ALBUM"),
        album_artist=_tag(tags, "ALBUMARTIST", "ALBUM_ARTIST", "ALBUM ARTIST"),
        genre=_tag(tags, "GENRE"),
        track_number=_parse_track_number(
            _tag(tags, "TRACKNUMBER", "TRACK")
        ),
        disc_number=_parse_track_number(
            _tag(tags, "DISCNUMBER", "DISC")
        ),
        duration=round(samples.shape[0] / SAMPLE_RATE, 9),
        sample_array=np.asarray(samples, np.float32),
    )


class FlacDecoder(Decoder):
    """Pure-Python FLAC → canonical PCM (f32/mono/22050 Hz)."""

    @classmethod
    def decode(cls, path) -> PreAnalyzedSong:
        path = pathlib.Path(path)
        pcm, rate, bps, tags, _total = read_flac(path)
        frames = (pcm.astype(np.float64) / float(1 << (bps - 1))).astype(
            np.float32
        )
        return _song_from_frames(path, frames, rate, tags)


class Mp3Decoder(Decoder):
    """Pure-Python MP3 → canonical PCM (f32/mono/22050 Hz)."""

    @classmethod
    def decode(cls, path) -> PreAnalyzedSong:
        path = pathlib.Path(path)
        pcm, rate, tags, _total = read_mp3(path)
        return _song_from_frames(path, pcm, rate, tags)


class OggDecoder(Decoder):
    """Pure-Python Ogg Vorbis → canonical PCM (f32/mono/22050 Hz)."""

    @classmethod
    def decode(cls, path) -> PreAnalyzedSong:
        path = pathlib.Path(path)
        pcm, rate, tags, _total = read_vorbis(path)
        return _song_from_frames(path, pcm, rate, tags)


class M4aDecoder(Decoder):
    """Pure-Python MP4/M4A (AAC-LC or ALAC) → canonical PCM."""

    @classmethod
    def decode(cls, path) -> PreAnalyzedSong:
        from .mp4 import read_mp4

        path = pathlib.Path(path)
        track, samples, tags = read_mp4(path)
        if track.codec == "aac":
            from .aac import decode_aac

            pcm, _cfg = decode_aac(track.config, samples)
        elif track.codec == "alac":
            from .alac import decode_alac

            pcm, _cfg = decode_alac(track.config, samples)
        else:
            raise DecodingError(
                f"unsupported mp4 audio codec '{track.codec}' "
                f"(AAC-LC and ALAC are supported)."
            )
        # edit-list trim: encoder delay + true output length (gapless)
        start = track.edit_start
        end = len(pcm)
        if track.edit_duration is not None:
            end = min(end, start + track.edit_duration)
        pcm = pcm[start:end]
        return _song_from_frames(path, pcm, track.sample_rate, tags)


class AdtsDecoder(Decoder):
    """Raw .aac (ADTS) streams → canonical PCM."""

    @classmethod
    def decode(cls, path) -> PreAnalyzedSong:
        from .aac import decode_aac, read_adts

        path = pathlib.Path(path)
        try:
            data = path.read_bytes()
        except FileNotFoundError:
            raise DecodingError(
                f"while opening format for file '{path}': "
                "No such file or directory."
            ) from None
        config, aus = read_adts(data)
        pcm, cfg = decode_aac(config, aus)
        # ADTS carries no encoder-delay metadata; like libav, emit the
        # decoder's priming output rather than guessing a trim
        return _song_from_frames(path, pcm, cfg.sample_rate, {})


class FallbackDecoder(Decoder):
    """Dispatch to the FFI-free decoder for the file's container."""

    @classmethod
    def decode(cls, path) -> PreAnalyzedSong:
        path = pathlib.Path(path)
        suffix = path.suffix.lower()
        if suffix == ".flac":
            return FlacDecoder.decode(path)
        if suffix in (".ogg", ".oga"):
            return OggDecoder.decode(path)
        if suffix == ".mp3":
            return Mp3Decoder.decode(path)
        if suffix in (".wav", ".wave"):
            return WavDecoder.decode(path)
        if suffix in (".m4a", ".mp4", ".m4b"):
            return M4aDecoder.decode(path)
        if suffix == ".aac":
            return AdtsDecoder.decode(path)
        # sniff the magic for extensionless/mislabeled files
        try:
            head = path.open("rb").read(4)
        except FileNotFoundError:
            raise DecodingError(
                f"while opening format for file '{path}': "
                "No such file or directory."
            ) from None
        except OSError as e:
            raise DecodingError(
                f"while opening format for file '{path}': {e}."
            ) from None
        if head == b"fLaC":
            return FlacDecoder.decode(path)
        if head == b"OggS":
            return OggDecoder.decode(path)
        if head == b"RIFF":
            return WavDecoder.decode(path)
        if head[:3] == b"ID3" or (
            len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE6) == 0xE2
        ):
            return Mp3Decoder.decode(path)
        try:
            head8 = path.open("rb").read(12)
        except OSError:
            head8 = b""
        if len(head8) >= 12 and head8[4:8] == b"ftyp":
            return M4aDecoder.decode(path)
        if (
            len(head) >= 2
            and head[0] == 0xFF
            and (head[1] & 0xF6) == 0xF0
        ):
            return AdtsDecoder.decode(path)
        raise DecodingError(
            f"unsupported format for the FFI-free fallback decoder: "
            f"'{path}' (FLAC, MP3, OGG Vorbis, WAV, M4A/MP4 and ADTS AAC "
            "are supported)."
        )
