"""CUE sheet handling: split one large audio file into analyzed tracks.

Reference: bliss-rs src/cue.rs. The audio file is decoded ONCE; each track
is a slice of the decoded sample array delimited by the INDEX timestamps
(src/cue.rs:208-245). Track slices are natural batch candidates: they all
come from one decode, so the batch analyzer gets them nearly for free.
Analysis runs on `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .errors import BlissError, DecodingError
from .features import SAMPLE_RATE
from .song import AnalysisOptions, CueInfo, Song


@dataclass
class CueTrack:
    number: str = ""
    title: Optional[str] = None
    performer: Optional[str] = None
    indices: List[Tuple[str, float]] = field(default_factory=list)  # (no, seconds)


@dataclass
class CueFileEntry:
    file: str = ""
    tracks: List[CueTrack] = field(default_factory=list)


@dataclass
class CueSheet:
    performer: Optional[str] = None
    title: Optional[str] = None
    comments: List[Tuple[str, str]] = field(default_factory=list)
    files: List[CueFileEntry] = field(default_factory=list)


def _unquote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        return s[1:-1]
    return s


def _index_seconds(value: str) -> float:
    """INDEX timestamps are MM:SS:FF with 75 frames per second."""
    parts = value.strip().split(":")
    if len(parts) != 3:
        raise ValueError(f"bad INDEX timestamp {value!r}")
    mm, ss, ff = (int(p) for p in parts)
    return mm * 60.0 + ss + ff / 75.0


def parse_cue(path) -> CueSheet:
    """Minimal CUE parser covering the subset rcue handles for bliss."""
    sheet = CueSheet()
    current_file: Optional[CueFileEntry] = None
    current_track: Optional[CueTrack] = None
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            head, _, rest = line.partition(" ")
            key = head.upper()
            if key == "REM":
                ckey, _, cval = rest.partition(" ")
                sheet.comments.append((ckey, cval.strip()))
            elif key == "PERFORMER":
                if current_track is not None:
                    current_track.performer = _unquote(rest)
                else:
                    sheet.performer = _unquote(rest)
            elif key == "TITLE":
                if current_track is not None:
                    current_track.title = _unquote(rest)
                else:
                    sheet.title = _unquote(rest)
            elif key == "FILE":
                # strip the trailing type token (WAVE/MP3/...)
                value = rest.rsplit(" ", 1)[0] if " " in rest else rest
                current_file = CueFileEntry(file=_unquote(value))
                sheet.files.append(current_file)
                current_track = None
            elif key == "TRACK":
                number = rest.split(" ", 1)[0]
                current_track = CueTrack(number=number)
                if current_file is None:
                    raise ValueError("TRACK before FILE in CUE sheet")
                current_file.tracks.append(current_track)
            elif key == "INDEX":
                no, _, ts = rest.partition(" ")
                if current_track is not None:
                    current_track.indices.append((no, _index_seconds(ts)))
    return sheet


class BlissCue:
    """Analyze all songs referenced by a CUE sheet (src/cue.rs:46-107)."""

    @staticmethod
    def songs_from_path(decoder_cls, path, analysis_options=None, device="cuda") -> list:
        """Return a list whose items are `Song` or `BlissError`, one per
        track (or one per undecodable FILE entry)."""
        options = analysis_options or AnalysisOptions()
        path = pathlib.Path(path)
        try:
            sheet = parse_cue(path)
        except OSError as e:
            raise DecodingError(
                f"when opening CUE file '{path}': {e}"
            ) from None
        except ValueError as e:
            raise DecodingError(
                f"when opening CUE file '{path}': {e}"
            ) from None

        genre = next(
            (v for c, v in sheet.comments if c.upper() == "GENRE"), None
        )
        disc_raw = next(
            (
                v
                for c, v in sheet.comments
                if c.upper() in ("DISCNUMBER", "DISC")
            ),
            None,
        )
        try:
            disc_number = int(disc_raw) if disc_raw is not None else None
        except ValueError:
            disc_number = None

        out = []
        for entry in sheet.files:
            audio_path = path.parent / entry.file
            try:
                raw = decoder_cls.decode(audio_path)
            except BlissError as e:
                out.append(e)
                continue
            if raw.sample_array.size == 0:
                out.append(
                    DecodingError("empty audio file associated to CUE sheet")
                )
                continue
            out.extend(
                _songs_from_file(
                    raw.sample_array,
                    entry,
                    sheet,
                    genre,
                    disc_number,
                    path,
                    audio_path,
                    options,
                    device,
                )
            )
        return out


def _songs_from_file(
    samples,
    entry: CueFileEntry,
    sheet: CueSheet,
    genre,
    disc_number,
    cue_path,
    audio_path,
    options,
    device="cuda",
) -> list:
    """Slice + analyze each track of one FILE entry (src/cue.rs:208-245)."""
    import numpy as np

    out = []
    tracks = entry.tracks

    def make(index, track, start, end):
        duration = (end - start) / SAMPLE_RATE
        try:
            analysis = Song.analyze_with_options(samples[start:end], options, device)
        except BlissError as e:
            return e
        try:
            track_number = int(track.number)
        except ValueError:
            track_number = None
        return Song(
            path=pathlib.Path(f"{cue_path}/CUE_TRACK{index:03d}"),
            album=sheet.title,
            artist=track.performer,
            album_artist=sheet.performer,
            analysis=analysis,
            duration=duration,
            genre=genre,
            title=track.title,
            track_number=track_number,
            disc_number=disc_number,
            features_version=options.features_version,
            cue_info=CueInfo(
                cue_path=pathlib.Path(cue_path),
                audio_file_path=pathlib.Path(audio_path),
            ),
        )

    samples = np.asarray(samples)
    for index, (cur, nxt) in enumerate(zip(tracks, tracks[1:])):
        if cur.indices and nxt.indices:
            start = int(np.float32(cur.indices[0][1]) * np.float32(SAMPLE_RATE))
            end = int(np.float32(nxt.indices[0][1]) * np.float32(SAMPLE_RATE))
            out.append(make(index + 1, cur, start, end))
    if tracks and tracks[-1].indices:
        start = int(
            np.float32(tracks[-1].indices[0][1]) * np.float32(SAMPLE_RATE)
        )
        out.append(make(len(tracks), tracks[-1], start, len(samples)))
    return out
