"""Pure-Python FLAC decoder for the FFI-free fallback decode stack.

The reference ships Symphonia as its FFI-free alternative to FFmpeg
(bliss-rs src/song/decoder/symphonia.rs); FLAC is its flagship lossless
codec. This is a clean-room decoder of the FLAC bitstream format
(https://xiph.org/flac/format.html) built on numpy:

  * rice residuals are decoded with a one-positions index over the
    whole file's unpacked bit array (the per-code scan is a cheap
    pointer walk; remainders/zigzag/prediction are vectorized),
  * fixed predictors invert as repeated integer cumsums (the order-n
    fixed predictor is exactly the n-th forward difference),
  * LPC synthesis is the only per-sample Python loop (exact integer
    shift semantics), bounded by the subframe order.

Error handling mirrors the reference's decode-retry semantics
(symphonia.rs:86 MAX_DECODE_RETRIES = 3): a corrupt frame (bad CRC or
malformed header) resynchronizes to the next frame sync code, up to 3
failures; a truncated final frame yields the samples decoded so far
(ffmpeg.rs:290-298 premature-EOF tolerance).
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import DecodingError

MAX_DECODE_RETRIES = 3  # symphonia.rs:86

_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_RATES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        table[i] = c & mask
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    t = _CRC8_TABLE
    for b in data:
        crc = int(t[crc ^ b])
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    t = _CRC16_TABLE
    for b in data:
        crc = int(t[((crc >> 8) ^ b) & 0xFF]) ^ ((crc << 8) & 0xFFFF)
    return crc


class _Corrupt(Exception):
    """A malformed frame — resync and retry (internal)."""


class _Truncated(Exception):
    """Ran past end of file mid-frame (internal)."""


class _Bits:
    """Bit reader over the whole file: int-slicing for header/warmup
    fields, a one-positions index for unary/rice scans."""

    def __init__(self, data: bytes):
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = 0
        bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.bits = bits
        self.ones = np.flatnonzero(bits).astype(np.int64)

    def read(self, n: int) -> int:
        """Read n (≤ 57) bits as an unsigned int."""
        pos = self.pos
        if pos + n > self.nbits:
            raise _Truncated()
        byte0 = pos >> 3
        take = ((pos & 7) + n + 7) >> 3
        chunk = int.from_bytes(self.data[byte0 : byte0 + take], "big")
        self.pos = pos + n
        return (chunk >> (8 * take - (pos & 7) - n)) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count zeros up to the next 1 bit; consumes the terminator."""
        i = int(np.searchsorted(self.ones, self.pos))
        if i >= self.ones.shape[0]:
            raise _Truncated()
        p = int(self.ones[i])
        q = p - self.pos
        self.pos = p + 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _read_utf8_coded(br: _Bits) -> int:
    """FLAC's UTF-8-style coded frame/sample number (up to 36 bits)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_extra = 0
    mask = 0x40
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    if n_extra < 1 or n_extra > 6:
        raise _Corrupt()
    val = b0 & (mask - 1)
    for _ in range(n_extra):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise _Corrupt()
        val = (val << 6) | (b & 0x3F)
    return val


def _read_residual(br: _Bits, blocksize: int, pred_order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise _Corrupt()
    k_bits, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    porder = br.read(4)
    n_parts = 1 << porder
    part_len = blocksize >> porder
    if part_len * n_parts != blocksize or part_len <= 0:
        raise _Corrupt()
    out: List[np.ndarray] = []
    for p in range(n_parts):
        n = part_len - (pred_order if p == 0 else 0)
        if n < 0:
            raise _Corrupt()
        k = br.read(k_bits)
        if k == escape:
            width = br.read(5)
            if width == 0:
                out.append(np.zeros(n, np.int64))
            else:
                vals = np.empty(n, np.int64)
                for i in range(n):
                    vals[i] = br.read_signed(width)
                out.append(vals)
        elif n:
            out.append(_rice_decode(br, n, k))
        else:
            out.append(np.zeros(0, np.int64))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _rice_decode(br: _Bits, n: int, k: int) -> np.ndarray:
    """Decode n rice(k) codes starting at br.pos."""
    ones = br.ones
    n_ones = ones.shape[0]
    oi = int(np.searchsorted(ones, br.pos))
    pos = np.empty(n, np.int64)
    starts = np.empty(n, np.int64)
    start = br.pos
    step = 1 + k
    for i in range(n):
        while True:
            if oi >= n_ones:
                raise _Truncated()
            p = ones[oi]
            oi += 1
            if p >= start:
                break
        pos[i] = p
        starts[i] = start
        start = p + step
    if start > br.nbits:
        raise _Truncated()
    br.pos = int(start)
    u = (pos - starts) << k
    if k:
        idx = pos[:, None] + 1 + np.arange(k, dtype=np.int64)[None, :]
        rem = br.bits[idx].astype(np.int64)
        u = u + (
            rem << np.arange(k - 1, -1, -1, dtype=np.int64)[None, :]
        ).sum(axis=1)
    return (u >> 1) ^ -(u & 1)


def _undo_fixed(warmup: np.ndarray, res: np.ndarray, order: int) -> np.ndarray:
    """Invert the order-n fixed predictor: n integer cumsum passes
    (the encoder stores the n-th forward difference)."""
    w = warmup.astype(np.int64)
    diffs = [w]
    for _ in range(order):
        diffs.append(np.diff(diffs[-1]))
    x = res.astype(np.int64)
    for lvl in range(order, 0, -1):
        init = diffs[lvl - 1][-1]
        x = np.cumsum(np.concatenate(([init], x)))[1:]
    return np.concatenate([w, x])


class _LpcPending:
    """A deferred LPC subframe: synthesized in a cross-frame batch.

    FLAC frames are independent (each subframe carries its own warmup),
    so every LPC subframe in the file with the same predictor order can
    step through sample positions together — one vectorized int64
    multiply-add (exact `>> shift` semantics) per position instead of a
    per-sample Python loop. ~50x faster on LPC-heavy files.
    """

    __slots__ = ("warmup", "res", "coefs", "shift", "wasted", "out")

    def __init__(self, warmup, res, coefs, shift, wasted):
        self.warmup = warmup
        self.res = res
        self.coefs = coefs
        self.shift = shift
        self.wasted = wasted
        self.out: Optional[np.ndarray] = None


def _solve_lpc_batch(pending: List[_LpcPending]) -> None:
    """Synthesize all deferred LPC subframes, grouped by order."""
    by_order: Dict[int, List[_LpcPending]] = {}
    for p in pending:
        by_order.setdefault(len(p.coefs), []).append(p)
    for order, group in by_order.items():
        max_n = max(p.res.shape[0] for p in group)
        f = len(group)
        s = np.zeros((f, order + max_n), np.int64)
        res = np.zeros((f, max_n), np.int64)
        coefs_rev = np.zeros((f, order), np.int64)  # c[order-1] .. c[0]
        shift = np.zeros((f, 1), np.int64)
        for i, p in enumerate(group):
            s[i, :order] = p.warmup
            res[i, : p.res.shape[0]] = p.res
            coefs_rev[i] = p.coefs[::-1]
            shift[i, 0] = p.shift
        shift = shift[:, 0]
        for i in range(max_n):
            acc = np.einsum(
                "fo,fo->f", coefs_rev, s[:, i : i + order]
            )
            s[:, order + i] = res[:, i] + (acc >> shift)
        for i, p in enumerate(group):
            p.out = s[i, : order + p.res.shape[0]]
            if p.wasted:
                p.out = p.out << p.wasted


def _read_subframe(br: _Bits, blocksize: int, bps: int, pending: list):
    """Parse one subframe → ndarray, or an _LpcPending queued in
    `pending` for the batched synthesis pass."""
    if br.read(1):
        raise _Corrupt()  # padding bit must be 0
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    eff_bps = bps - wasted
    if eff_bps <= 0 or eff_bps > 33:
        raise _Corrupt()

    if sf_type == 0:  # CONSTANT
        v = br.read_signed(eff_bps)
        samples = np.full(blocksize, v, np.int64)
    elif sf_type == 1:  # VERBATIM
        samples = np.empty(blocksize, np.int64)
        for i in range(blocksize):
            samples[i] = br.read_signed(eff_bps)
    elif 8 <= sf_type <= 12:  # FIXED, order 0-4
        order = sf_type - 8
        if order > blocksize:
            raise _Corrupt()
        warmup = np.empty(order, np.int64)
        for i in range(order):
            warmup[i] = br.read_signed(eff_bps)
        res = _read_residual(br, blocksize, order)
        samples = (
            _undo_fixed(warmup, res, order) if order else res.copy()
        )
    elif sf_type >= 32:  # LPC, order 1-32
        order = sf_type - 31
        if order > blocksize:
            raise _Corrupt()
        warmup = np.empty(order, np.int64)
        for i in range(order):
            warmup[i] = br.read_signed(eff_bps)
        precision = br.read(4) + 1
        if precision == 16:  # 0b1111 + 1 is invalid
            raise _Corrupt()
        shift = br.read_signed(5)
        if shift < 0:
            raise _Corrupt()
        coefs = np.array(
            [br.read_signed(precision) for _ in range(order)], np.int64
        )
        res = _read_residual(br, blocksize, order)
        p = _LpcPending(warmup, res, coefs, shift, wasted)
        pending.append(p)
        return p
    else:
        raise _Corrupt()  # reserved type

    if wasted:
        samples = samples << wasted
    return samples


def _finalize_frame(ch_code: int, entries: list) -> np.ndarray:
    """Resolve deferred subframes + stereo decorrelation → [bs, C]."""
    chans = [e.out if isinstance(e, _LpcPending) else e for e in entries]
    if ch_code < 8:
        pass
    elif ch_code == 8:  # left/side: R = L - side
        chans = [chans[0], chans[0] - chans[1]]
    elif ch_code == 9:  # right/side: L = R + side (ch0 is the side)
        chans = [chans[1] + chans[0], chans[1]]
    else:  # mid/side
        side = chans[1]
        m2 = (chans[0] << 1) | (side & 1)
        chans = [(m2 + side) >> 1, (m2 - side) >> 1]
    return np.stack(chans, axis=1)


def _parse_frame(br: _Bits, info: dict, pending: list):
    """Parse one frame at br.pos (byte-aligned, at a sync code).
    Returns (ch_code, [subframe entries]) — finalize after the LPC batch."""
    start_byte = br.pos >> 3
    if br.read(14) != 0x3FFE:
        raise _Corrupt()
    br.read(1)  # reserved
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise _Corrupt()  # reserved bit must be 0
    _read_utf8_coded(br)
    if bs_code == 0:
        raise _Corrupt()
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = _BLOCK_SIZES[bs_code]
    if sr_code == 0:
        rate = info["sample_rate"]
    elif sr_code == 12:
        rate = br.read(8) * 1000
    elif sr_code == 13:
        rate = br.read(16)
    elif sr_code == 14:
        rate = br.read(16) * 10
    elif sr_code == 15:
        raise _Corrupt()
    else:
        rate = _SAMPLE_RATES[sr_code]
    if ss_code == 0:
        bps = info["bps"]
    elif ss_code == 3:
        raise _Corrupt()
    else:
        bps = _SAMPLE_SIZES[ss_code]
    header_end = (br.pos + 7) >> 3
    if _crc8(br.data[start_byte:header_end]) != br.read(8):
        raise _Corrupt()

    local_pending: list = []
    if ch_code < 8:
        n_ch = ch_code + 1
        entries = [
            _read_subframe(br, blocksize, bps, local_pending)
            for _ in range(n_ch)
        ]
    elif ch_code in (8, 9, 10):
        extra0 = 1 if ch_code == 9 else 0  # right/side: ch0 is the side
        extra1 = 1 if ch_code in (8, 10) else 0
        entries = [
            _read_subframe(br, blocksize, bps + extra0, local_pending),
            _read_subframe(br, blocksize, bps + extra1, local_pending),
        ]
    else:
        raise _Corrupt()

    br.align()
    crc_byte = br.pos >> 3
    stored = br.read(16)
    if _crc16(br.data[start_byte:crc_byte]) != stored:
        raise _Corrupt()
    if rate != info["sample_rate"]:
        # variable-rate streams are out of scope; treat as corruption
        raise _Corrupt()
    pending.extend(local_pending)  # only a valid frame contributes work
    return ch_code, entries


def _parse_metadata(data: bytes) -> Tuple[dict, Dict[str, str], int]:
    if data[:4] != b"fLaC":
        raise DecodingError("unsupported format: missing fLaC marker.")
    off = 4
    info: Optional[dict] = None
    tags: Dict[str, str] = {}
    while True:
        if off + 4 > len(data):
            raise DecodingError("unexpected end of file in FLAC metadata.")
        header = int.from_bytes(data[off : off + 4], "big")
        last = header >> 31
        btype = (header >> 24) & 0x7F
        length = header & 0xFFFFFF
        body = data[off + 4 : off + 4 + length]
        if btype == 0:  # STREAMINFO
            if length < 34:
                raise DecodingError("truncated FLAC STREAMINFO.")
            raw = int.from_bytes(body[:18], "big")
            # layout (bits): 16 min_bs | 16 max_bs | 24 min_fs | 24 max_fs
            #              | 20 rate | 3 channels-1 | 5 bps-1 | 36 total
            info = {
                "sample_rate": (raw >> (144 - 80 - 20)) & 0xFFFFF,
                "channels": ((raw >> (144 - 100 - 3)) & 0x7) + 1,
                "bps": ((raw >> (144 - 103 - 5)) & 0x1F) + 1,
                "total_samples": raw & ((1 << 36) - 1),
                "md5": body[18:34],
            }
        elif btype == 4:  # VORBIS_COMMENT
            try:
                p = 0
                vlen = int.from_bytes(body[p : p + 4], "little")
                p += 4 + vlen
                count = int.from_bytes(body[p : p + 4], "little")
                p += 4
                for _ in range(count):
                    clen = int.from_bytes(body[p : p + 4], "little")
                    p += 4
                    entry = body[p : p + clen].decode("utf-8", "replace")
                    p += clen
                    if "=" in entry:
                        key, val = entry.split("=", 1)
                        tags[key.upper()] = val
            except Exception:
                pass  # tags are best-effort
        off += 4 + length
        if last:
            break
    if info is None:
        raise DecodingError("FLAC file has no STREAMINFO.")
    if info["sample_rate"] == 0:
        raise DecodingError("FLAC STREAMINFO has a zero sample rate.")
    return info, tags, off


def _resync(br: _Bits, from_byte: int) -> bool:
    """Advance to the next plausible frame sync code; False at EOF."""
    data = br.data
    i = from_byte
    while True:
        i = data.find(b"\xFF", i)
        if i < 0 or i + 1 >= len(data):
            return False
        if (data[i + 1] & 0xFE) == 0xF8:
            br.pos = 8 * i
            return True
        i += 1


def read_flac(path) -> Tuple[np.ndarray, int, int, Dict[str, str], int]:
    """Decode a FLAC file → (samples [N, C] int64, rate, bps, tags, total).

    Raises DecodingError on unusable files; tolerates a truncated final
    frame and up to MAX_DECODE_RETRIES corrupt frames (resync).
    """
    path = pathlib.Path(path)
    try:
        data = path.read_bytes()
    except FileNotFoundError:
        raise DecodingError(
            f"while opening format for file '{path}': "
            "No such file or directory."
        ) from None
    except OSError as e:
        raise DecodingError(
            f"while opening format for file '{path}': {e}."
        ) from None

    info, tags, off = _parse_metadata(data)
    br = _Bits(data)
    br.pos = 8 * off
    plans: List[tuple] = []
    pending: List[_LpcPending] = []
    errors = 0
    while (br.pos >> 3) < len(data) - 2:
        frame_byte = br.pos >> 3
        try:
            plans.append(_parse_frame(br, info, pending))
        except _Corrupt:
            errors += 1
            if errors > MAX_DECODE_RETRIES:
                raise DecodingError(
                    f"corrupt FLAC stream in '{path}': too many bad frames."
                ) from None
            if not _resync(br, frame_byte + 1):
                break
        except _Truncated:
            break  # premature EOF: keep what we have (ffmpeg.rs:290-298)
    if not plans:
        raise DecodingError(f"no decodable audio frames in '{path}'.")
    _solve_lpc_batch(pending)
    pcm = np.concatenate(
        [_finalize_frame(ch, entries) for ch, entries in plans], axis=0
    )
    total = info["total_samples"]
    if total and pcm.shape[0] > total:
        pcm = pcm[:total]
    return pcm, info["sample_rate"], info["bps"], tags, total


def verify_md5(path) -> bool:
    """Decode `path` and check the PCM against STREAMINFO's MD5.

    The MD5 covers the raw interleaved little-endian samples at the
    stream's bit depth — an end-to-end correctness oracle for the
    decoder itself (independent of any other decode stack)."""
    import hashlib

    data = pathlib.Path(path).read_bytes()
    info, _tags, off = _parse_metadata(data)
    br = _Bits(data)
    br.pos = 8 * off
    plans = []
    pending: List[_LpcPending] = []
    while (br.pos >> 3) < len(data) - 2:
        plans.append(_parse_frame(br, info, pending))
    _solve_lpc_batch(pending)
    pcm = np.concatenate(
        [_finalize_frame(ch, entries) for ch, entries in plans], axis=0
    )
    if info["total_samples"]:
        pcm = pcm[: info["total_samples"]]
    nbytes = (info["bps"] + 7) // 8
    dt = {1: "<i1", 2: "<i2", 3: None, 4: "<i4"}[nbytes]
    if dt is None:  # 24-bit: pack 3 LE bytes per sample
        as32 = pcm.astype("<i4").reshape(-1)
        raw = as32.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    else:
        raw = pcm.astype(dt).reshape(-1).tobytes()
    return hashlib.md5(raw).digest() == info["md5"]
