"""The decoder protocol and the decoded-song record (counterpart of
bliss_tpu/io/decoder.py, without its native libav decoder).

Decoding yields canonical PCM (f32/mono/22050 Hz) on the host; analysis
runs on `device`, the card unless the caller asks for the CPU. The port's
decoders are the FFI-free stack of `io/fallback.py`, and
`DefaultDecoder` is its `FallbackDecoder`.
"""

from __future__ import annotations

import logging
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from ..errors import BlissError, DecodingError
from ..features import SAMPLE_RATE  # noqa: F401 (bliss_tpu.io.decoder's name)

logger = logging.getLogger("bliss_tpu_torch")


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


def __getattr__(name):
    """`DefaultDecoder`, the port's default decoder: the FFI-free stack
    (the reference's Symphonia-style alternative,
    src/song/decoder.rs:67-74). Resolved on first use, since
    `io/fallback.py` imports this module."""
    if name == "DefaultDecoder":
        from .fallback import FallbackDecoder

        return FallbackDecoder
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
