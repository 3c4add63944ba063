"""Pure-Python MP4/M4A (ISO-BMFF) demuxer for the FFI-free fallback
decode stack.

Closes the `isomp4` row of the reference's symphonia-all format matrix
(bliss-rs Cargo.toml:55-66, src/song/decoder/symphonia.rs:18-27): walks
the box tree, locates the first audio track, rebuilds the per-sample
(access-unit) byte ranges from the stbl sample tables, and returns the
codec's decoder configuration (esds AudioSpecificConfig for AAC, the
magic cookie for ALAC) plus iTunes-style tags and the edit-list trim
needed for gapless AAC.

Format reference: ISO/IEC 14496-12 (boxes, sample tables) and
ISO/IEC 14496-14 (esds). Clean-room implementation from the published
specifications.
"""

from __future__ import annotations

import pathlib
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..errors import DecodingError

_CONTAINERS = {
    b"moov", b"trak", b"mdia", b"minf", b"stbl", b"udta", b"edts",
    b"mvex", b"moof", b"traf",
}


@dataclass
class Mp4Track:
    codec: str  # "aac" | "alac" | other fourcc (unsupported)
    config: bytes  # AudioSpecificConfig (aac) / magic cookie (alac)
    sample_rate: int
    channels: int
    timescale: int
    sample_sizes: List[int] = field(default_factory=list)
    sample_offsets: List[int] = field(default_factory=list)
    #: edit-list trim: (media start in samples, total output samples)
    edit_start: int = 0
    edit_duration: Optional[int] = None
    duration: int = 0  # in timescale units (mdhd)


def _read_boxes(buf: bytes, start: int, end: int):
    """Yield (fourcc, body_start, body_end) for the boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size = struct.unpack_from(">I", buf, pos)[0]
        fourcc = buf[pos + 4 : pos + 8]
        header = 8
        if size == 1:
            if pos + 16 > end:
                break
            size = struct.unpack_from(">Q", buf, pos + 8)[0]
            header = 16
        elif size == 0:
            size = end - pos
        if size < header or pos + size > end:
            break
        yield fourcc, pos + header, pos + size
        pos += size


def _full_box(buf: bytes, start: int) -> Tuple[int, int, int]:
    """(version, flags, body_start) of a FullBox."""
    version = buf[start]
    flags = int.from_bytes(buf[start + 1 : start + 4], "big")
    return version, flags, start + 4


def _parse_esds(buf: bytes, start: int, end: int) -> Optional[bytes]:
    """Extract the AudioSpecificConfig from an esds box
    (ISO 14496-14 §3.1: ES_Descriptor → DecoderConfig → DecSpecificInfo)."""
    _, _, pos = _full_box(buf, start)

    def read_descr(pos):
        if pos >= end:
            return None, 0, pos
        tag = buf[pos]
        pos += 1
        size = 0
        for _ in range(4):
            b = buf[pos]
            pos += 1
            size = (size << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        return tag, size, pos

    tag, size, pos = read_descr(pos)
    if tag != 0x03:  # ES_Descriptor
        return None
    es_end = pos + size
    pos += 2  # ES_ID
    flags = buf[pos]
    pos += 1
    if flags & 0x80:
        pos += 2  # dependsOn_ES_ID
    if flags & 0x40:
        pos += 1 + buf[pos]  # URL
    if flags & 0x20:
        pos += 2  # OCR ES id
    tag, size, pos = read_descr(pos)
    if tag != 0x04:  # DecoderConfigDescriptor
        return None
    dc_end = pos + size
    pos += 13  # objectType(1) streamType(1) bufferSize(3) maxBr(4) avgBr(4)
    if pos >= dc_end:
        return None
    tag, size, pos = read_descr(pos)
    if tag != 0x05:  # DecoderSpecificInfo = AudioSpecificConfig
        return None
    return bytes(buf[pos : pos + size])


def _parse_stsd(buf: bytes, start: int, end: int):
    """First audio sample entry → (codec, config, rate, channels)."""
    _, _, pos = _full_box(buf, start)
    count = struct.unpack_from(">I", buf, pos)[0]
    pos += 4
    for fourcc, body, bend in _read_boxes(buf, pos, end):
        name = fourcc.decode("latin1")
        # AudioSampleEntry: 6 reserved + 2 data_ref_index + 8 reserved +
        # 2 channelcount + 2 samplesize + 4 predefined/reserved + 4 rate
        if bend - body < 28:
            continue
        channels = struct.unpack_from(">H", buf, body + 16)[0]
        rate = struct.unpack_from(">I", buf, body + 24)[0] >> 16
        child_start = body + 28
        if name == "mp4a":
            for cc, cb, ce in _read_boxes(buf, child_start, bend):
                if cc == b"esds":
                    cfg = _parse_esds(buf, cb, ce)
                    if cfg is not None:
                        return "aac", cfg, rate, channels
            return "aac", b"", rate, channels
        if name == "alac":
            for cc, cb, ce in _read_boxes(buf, child_start, bend):
                if cc == b"alac":
                    # FullBox header then the 24-byte magic cookie
                    return (
                        "alac",
                        bytes(buf[cb + 4 : ce]),
                        rate,
                        channels,
                    )
            return "alac", b"", rate, channels
        return name, b"", rate, channels
    raise DecodingError("mp4: stsd holds no sample entries")


def _chunk_layout(
    sizes: List[int], stsc: List[Tuple[int, int]], offsets: List[int]
) -> List[int]:
    """Per-sample absolute file offsets from stsz/stsc/stco."""
    out = []
    n_chunks = len(offsets)
    si = 0
    for i, (first_chunk, per_chunk) in enumerate(stsc):
        last = (
            stsc[i + 1][0] - 1 if i + 1 < len(stsc) else n_chunks
        )
        for chunk in range(first_chunk, last + 1):
            if chunk - 1 >= n_chunks:
                break
            pos = offsets[chunk - 1]
            for _ in range(per_chunk):
                if si >= len(sizes):
                    return out
                out.append(pos)
                pos += sizes[si]
                si += 1
    return out


def _parse_ilst(buf: bytes, start: int, end: int, tags: Dict[str, str]):
    """iTunes metadata list → vorbis-comment-style tag names."""
    names = {
        b"\xa9nam": "TITLE",
        b"\xa9ART": "ARTIST",
        b"\xa9alb": "ALBUM",
        b"aART": "ALBUMARTIST",
        b"\xa9gen": "GENRE",
        b"gnre": "GENRE",
        b"trkn": "TRACKNUMBER",
        b"disk": "DISCNUMBER",
    }
    for fourcc, body, bend in _read_boxes(buf, start, end):
        key = names.get(fourcc)
        if key is None:
            continue
        for cc, cb, ce in _read_boxes(buf, body, bend):
            if cc != b"data":
                continue
            dtype = int.from_bytes(buf[cb : cb + 4], "big") & 0xFFFFFF
            payload = buf[cb + 8 : ce]
            if dtype == 1:  # UTF-8
                tags[key] = payload.decode("utf-8", errors="replace")
            elif fourcc in (b"trkn", b"disk") and len(payload) >= 4:
                num = struct.unpack_from(">H", payload, 2)[0]
                total = (
                    struct.unpack_from(">H", payload, 4)[0]
                    if len(payload) >= 6
                    else 0
                )
                tags[key] = f"{num}/{total}" if total else str(num)


def read_mp4(path: pathlib.Path):
    """Parse an MP4/M4A file.

    Returns `(track, samples, tags)` where `samples` is a list of the
    audio access units (bytes) in decode order.
    """
    try:
        buf = pathlib.Path(path).read_bytes()
    except FileNotFoundError:
        raise DecodingError(
            f"while opening format for file '{path}': "
            "No such file or directory."
        ) from None
    except OSError as e:
        raise DecodingError(
            f"while opening format for file '{path}': {e}."
        ) from None
    top = list(_read_boxes(buf, 0, len(buf)))
    if not any(f == b"ftyp" for f, _, _ in top):
        raise DecodingError(f"mp4: '{path}' has no ftyp box")
    moov = next(((s, e) for f, s, e in top if f == b"moov"), None)
    if moov is None:
        raise DecodingError(f"mp4: '{path}' has no moov box")

    tags: Dict[str, str] = {}
    movie_timescale = 0
    track: Optional[Mp4Track] = None

    def walk_udta(start, end):
        for f, s, e in _read_boxes(buf, start, end):
            if f == b"meta":
                # FullBox header precedes child boxes
                for f2, s2, e2 in _read_boxes(buf, s + 4, e):
                    if f2 == b"ilst":
                        _parse_ilst(buf, s2, e2, tags)

    for f, s, e in _read_boxes(buf, *moov):
        if f == b"mvhd":
            v, _, p = _full_box(buf, s)
            movie_timescale = struct.unpack_from(
                ">I", buf, p + (16 if v == 1 else 8)
            )[0]
        elif f == b"udta":
            walk_udta(s, e)
        elif f == b"trak" and track is None:
            track = _parse_trak(buf, s, e, movie_timescale)
    if track is None:
        raise DecodingError(f"mp4: '{path}' has no audio track")

    samples = []
    offsets = track.sample_offsets
    for off, size in zip(offsets, track.sample_sizes):
        if off + size > len(buf):
            break  # truncated file: keep what we have
        samples.append(buf[off : off + size])
    return track, samples, tags


def _parse_trak(
    buf: bytes, start: int, end: int, movie_timescale: int
) -> Optional[Mp4Track]:
    stbl = None
    mdhd_timescale = 0
    mdhd_duration = 0
    handler = None
    elst = None

    def walk(s, e):
        nonlocal stbl, mdhd_timescale, mdhd_duration, handler, elst
        for f, bs, be in _read_boxes(buf, s, e):
            if f == b"stbl":
                stbl = (bs, be)
            elif f in _CONTAINERS:
                walk(bs, be)
            elif f == b"mdhd":
                v, _, p = _full_box(buf, bs)
                if v == 1:
                    mdhd_timescale = struct.unpack_from(">I", buf, p + 16)[0]
                    mdhd_duration = struct.unpack_from(">Q", buf, p + 20)[0]
                else:
                    mdhd_timescale = struct.unpack_from(">I", buf, p + 8)[0]
                    mdhd_duration = struct.unpack_from(">I", buf, p + 12)[0]
            elif f == b"hdlr":
                handler = buf[bs + 8 : bs + 12]
            elif f == b"elst":
                v, _, p = _full_box(buf, bs)
                n = struct.unpack_from(">I", buf, p)[0]
                p += 4
                entries = []
                for _ in range(n):
                    if v == 1:
                        seg, media = struct.unpack_from(">Qq", buf, p)
                        p += 20
                    else:
                        seg, media = struct.unpack_from(">Ii", buf, p)
                        p += 12
                    entries.append((seg, media))
                elst = entries
    walk(start, end)
    if handler != b"soun" or stbl is None:
        return None

    codec = config = rate = channels = None
    sizes: List[int] = []
    stsc: List[Tuple[int, int]] = []
    offsets: List[int] = []
    for f, bs, be in _read_boxes(buf, *stbl):
        if f == b"stsd":
            codec, config, rate, channels = _parse_stsd(buf, bs, be)
        elif f == b"stsz":
            _, _, p = _full_box(buf, bs)
            uniform = struct.unpack_from(">I", buf, p)[0]
            count = struct.unpack_from(">I", buf, p + 4)[0]
            if uniform:
                sizes = [uniform] * count
            else:
                sizes = list(
                    struct.unpack_from(f">{count}I", buf, p + 8)
                )
        elif f == b"stsc":
            _, _, p = _full_box(buf, bs)
            n = struct.unpack_from(">I", buf, p)[0]
            p += 4
            for _ in range(n):
                first, per, _desc = struct.unpack_from(">III", buf, p)
                p += 12
                stsc.append((first, per))
        elif f in (b"stco", b"co64"):
            _, _, p = _full_box(buf, bs)
            n = struct.unpack_from(">I", buf, p)[0]
            p += 4
            fmt = ">Q" if f == b"co64" else ">I"
            width = 8 if f == b"co64" else 4
            offsets = [
                struct.unpack_from(fmt, buf, p + i * width)[0]
                for i in range(n)
            ]
    if codec is None:
        return None

    track = Mp4Track(
        codec=codec,
        config=config,
        sample_rate=rate or mdhd_timescale,
        channels=channels or 0,
        timescale=mdhd_timescale,
        sample_sizes=sizes,
        sample_offsets=_chunk_layout(sizes, stsc, offsets),
        duration=mdhd_duration,
    )
    if elst:
        # single-entry edit list: media_time = encoder delay (media
        # timescale units == samples for audio); segment_duration is in
        # MOVIE timescale units → output sample count
        seg, media = elst[0]
        if media > 0:
            track.edit_start = media
        if seg > 0 and movie_timescale:
            track.edit_duration = round(
                seg * track.timescale / movie_timescale
            )
    return track
