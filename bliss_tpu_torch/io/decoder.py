"""Audio decoding to the canonical bliss PCM format (f32/mono/22050 Hz)
(counterpart of bliss_tpu/io/decoder.py).

`DefaultDecoder` is `FFmpegDecoder`, the native C++ library over
libavformat/libavcodec/libswresample of `native/bliss_decode.cpp`
(bit-identical to `ffmpeg -ar 22050 -ac 1 -c:a pcm_f32le`, held against
the reference's adler32 golden hashes, bliss-rs
src/song/decoder/ffmpeg.rs:379-527), built on first use by `_native.py`
with g++ and the system's libav into `bliss_tpu_torch/build/`; where it
cannot be built, the first decode raises `DecodingError`. The FFI-free
stack of `io/fallback.py` is `FallbackDecoder`, which a caller passes
explicitly. Decoding runs on the host (the ctypes call releases the GIL,
so the batch driver's decode threads overlap); analysis runs on `device`,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import ctypes
import logging
import os
import pathlib
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from ..errors import BlissError, DecodingError
from ..features import SAMPLE_RATE
from . import _native

logger = logging.getLogger("bliss_tpu_torch")

_lib_lock = threading.Lock()
_lib = None


class _DecodeResult(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.POINTER(ctypes.c_float)),
        ("n_samples", ctypes.c_int64),
        ("title", ctypes.c_char_p),
        ("artist", ctypes.c_char_p),
        ("album", ctypes.c_char_p),
        ("album_artist", ctypes.c_char_p),
        ("genre", ctypes.c_char_p),
        ("track", ctypes.c_char_p),
        ("disc", ctypes.c_char_p),
        ("error", ctypes.c_char_p),
    ]


def _load_lib():
    """The native decoder, built on first use and loaded by its full path."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _native.decoder_library()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise DecodingError(f"cannot load the native decoder {path}: {e}") from e
        lib.bliss_decode.restype = ctypes.POINTER(_DecodeResult)
        lib.bliss_decode.argtypes = [ctypes.c_char_p]
        lib.bliss_decode_free.argtypes = [ctypes.POINTER(_DecodeResult)]
        _lib = lib
        return lib


def _opt_str(b: Optional[bytes]) -> Optional[str]:
    if not b:
        return None
    return b.decode("utf-8", errors="replace")


def _parse_track_number(raw: Optional[str]) -> Optional[int]:
    """Parse "N" or "N/M" track/disc tags (ffmpeg.rs:224-241)."""
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    if "/" in raw:
        head = raw.split("/", 1)[0]
        try:
            return int(head)
        except ValueError:
            return None
    return None


@dataclass
class PreAnalyzedSong:
    """A decoded-but-not-yet-analyzed song (src/song/decoder.rs:34-65)."""

    path: pathlib.Path = field(default_factory=lambda: pathlib.Path(""))
    artist: Optional[str] = None
    album_artist: Optional[str] = None
    title: Optional[str] = None
    album: Optional[str] = None
    track_number: Optional[int] = None
    disc_number: Optional[int] = None
    genre: Optional[str] = None
    duration: float = 0.0  # seconds
    sample_array: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.float32)
    )

    def to_song(self, analysis_options=None, device="cuda"):
        from ..song import AnalysisOptions, Song

        options = analysis_options or AnalysisOptions()
        analysis = Song.analyze_with_options(self.sample_array, options, device)
        return Song(
            path=self.path,
            artist=self.artist,
            album_artist=self.album_artist,
            title=self.title,
            album=self.album,
            track_number=self.track_number,
            disc_number=self.disc_number,
            genre=self.genre,
            duration=self.duration,
            analysis=analysis,
            features_version=options.features_version,
            cue_info=None,
        )


class Decoder:
    """Decoder protocol: implement `decode`, inherit the drivers.

    Mirrors the reference `Decoder` trait (src/song/decoder.rs:115-333).
    """

    @classmethod
    def decode(cls, path) -> PreAnalyzedSong:
        raise NotImplementedError

    @classmethod
    def song_from_path(cls, path, analysis_options=None, device="cuda"):
        return cls.decode(pathlib.Path(path)).to_song(analysis_options, device)

    # alias matching the reference name
    @classmethod
    def song_from_path_with_options(cls, path, analysis_options, device="cuda"):
        return cls.song_from_path(path, analysis_options, device)

    @classmethod
    def analyze_paths(cls, paths, analysis_options=None, device="cuda"):
        from ..song import AnalysisOptions

        return cls.analyze_paths_with_options(
            paths, analysis_options or AnalysisOptions(), device
        )

    @classmethod
    def analyze_paths_with_options(
        cls, paths: Iterable, analysis_options, device="cuda"
    ) -> Iterator[Tuple[pathlib.Path, "object"]]:
        """Decode on a host thread pool, analyze song by song, stream
        results. Yields `(path, Song | BlissError)` tuples in input order.
        CUE sheets fan out into one result per track
        (src/song/decoder.rs:310-323). `io.batch.analyze_paths_batched`
        is the batched driver."""
        from ..cue import BlissCue
        from ..models.analyzer import resolve_device

        resolve_device(device)  # a missing card raises here, not per song
        paths = [pathlib.Path(p) for p in paths]
        if not paths:
            return iter(())

        cores = os.cpu_count() or 1
        workers = min(cores, int(analysis_options.number_cores))

        def work(path):
            logger.info("Analyzing file '%s'", path)
            results = []
            try:
                if path.suffix.lower() == ".cue":
                    for song_or_err in BlissCue.songs_from_path(
                        cls, path, analysis_options, device
                    ):
                        results.append((path, song_or_err))
                else:
                    results.append(
                        (path, cls.song_from_path(path, analysis_options, device))
                    )
            except BlissError as e:
                results.append((path, e))
            except Exception as e:  # pragma: no cover - defensive
                results.append((path, DecodingError(str(e))))
            return results

        def generate():
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for results in pool.map(work, paths):
                    yield from results

        return generate()


class FFmpegDecoder(Decoder):
    """Native libav*-backed decoder (the default decoder)."""

    @classmethod
    def decode(cls, path) -> PreAnalyzedSong:
        path = pathlib.Path(path)
        lib = _load_lib()
        res = lib.bliss_decode(str(path).encode())
        try:
            c = res.contents
            if c.error:
                raise DecodingError(c.error.decode("utf-8", errors="replace"))
            n = int(c.n_samples)
            if n > 0:
                # a copy: the library's buffer is freed below
                samples = np.ctypeslib.as_array(c.samples, shape=(n,)).copy()
            else:
                samples = np.zeros(0, dtype=np.float32)
            return PreAnalyzedSong(
                path=path,
                title=_opt_str(c.title),
                artist=_opt_str(c.artist),
                album=_opt_str(c.album),
                album_artist=_opt_str(c.album_artist),
                genre=_opt_str(c.genre),
                track_number=_parse_track_number(_opt_str(c.track)),
                disc_number=_parse_track_number(_opt_str(c.disc)),
                duration=round(n / SAMPLE_RATE, 9),
                sample_array=samples,
            )
        finally:
            lib.bliss_decode_free(res)


#: The default decoder (reference src/song/decoder.rs:67-74: FFmpeg when
#: the feature is on). The FFI-free stack is `io.fallback.FallbackDecoder`.
DefaultDecoder = FFmpegDecoder
