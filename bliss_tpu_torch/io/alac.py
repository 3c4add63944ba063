"""Pure-Python ALAC (Apple Lossless) decoder for the FFI-free fallback
stack.

Closes the `alac` row of the reference's symphonia-all format matrix
(bliss-rs Cargo.toml:55-66). Clean-room implementation of the ALAC
bitstream format (frame elements, adaptive Rice entropy coding with the
zero-run escape, the adaptive FIR predictor, matrixed-stereo
decorrelation and the shifted-low-byte path), validated against libav
decode output by the cross-decoder tests (tests/test_m4a.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List

import numpy as np

from ..errors import DecodingError

# frame element ids (shared numbering with MPEG-4 audio syntax)
_ID_SCE = 0
_ID_CPE = 1
_ID_CCE = 2
_ID_LFE = 3
_ID_DSE = 4
_ID_PCE = 5
_ID_FIL = 6
_ID_END = 7


@dataclass
class AlacConfig:
    frame_length: int
    bit_depth: int
    pb: int  # rice history multiplier
    mb: int  # rice initial history
    kb: int  # rice parameter limit
    channels: int
    max_run: int
    sample_rate: int


def parse_cookie(cookie: bytes) -> AlacConfig:
    """The 24-byte ALACSpecificConfig ('magic cookie')."""
    if len(cookie) < 24:
        raise DecodingError("alac: magic cookie too short")
    (
        frame_length, _compat, bit_depth, pb, mb, kb, channels, max_run,
        _max_frame_bytes, _avg_bitrate, sample_rate,
    ) = struct.unpack(">IBBBBBBHIII", cookie[:24])
    return AlacConfig(
        frame_length, bit_depth, pb, mb, kb, channels, max_run, sample_rate
    )


class _Bits:
    """MSB-first bit reader."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        pos = self.pos
        if pos + n > self.nbits:
            raise DecodingError("alac: bitstream overrun")
        self.pos = pos + n
        out = 0
        data = self.data
        while n > 0:
            byte_i = pos >> 3
            bit_i = pos & 7
            take = min(8 - bit_i, n)
            chunk = (data[byte_i] >> (8 - bit_i - take)) & ((1 << take) - 1)
            out = (out << take) | chunk
            pos += take
            n -= take
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def unary_ones(self, limit: int) -> int:
        """Count consecutive 1-bits (terminated by a 0 which is consumed,
        unless the limit is hit first)."""
        count = 0
        while count < limit:
            if self.read(1) == 0:
                return count
            count += 1
        return count


def _lg(value: int) -> int:
    """floor(log2(value)) with lg(0) == 0 (av_log2 semantics)."""
    return value.bit_length() - 1 if value > 0 else 0


def _decode_scalar(br: _Bits, k: int, bps: int) -> int:
    x = br.unary_ones(9)
    if x > 8:
        return br.read(bps)
    if k != 1:
        # Golomb with divisor 2^k - 1: suffix in {0,1} consumes k-1 bits
        extra = br.read(k)
        x = (x << k) - x
        if extra > 1:
            x += extra - 1
        else:
            br.pos -= 1
    return x


def _rice_decompress(
    br: _Bits, n: int, bps: int, history_mult: int, initial_history: int,
    k_limit: int,
) -> np.ndarray:
    out = np.zeros(n, np.int64)
    history = initial_history
    sign_modifier = 0
    i = 0
    while i < n:
        k = _lg((history >> 9) + 3)
        k = min(k, k_limit)
        x = _decode_scalar(br, k, bps) + sign_modifier
        sign_modifier = 0
        out[i] = (x >> 1) ^ -(x & 1)
        if x > 0xFFFF:
            history = 0xFFFF
        else:
            history += x * history_mult - ((history * history_mult) >> 9)
        # compressed runs of zeros
        if history < 128 and i + 1 < n:
            k = 7 - _lg(history) + ((history + 16) >> 6)
            k = min(k, k_limit)
            block = _decode_scalar(br, k, 16)
            if block > 0:
                if block > n - i - 1:
                    raise DecodingError("alac: zero run overruns frame")
                i += block  # out[] is zero-initialized
            if block <= 0xFFFF:
                sign_modifier = 1
            history = 0
        i += 1
    return out


def _sign_extend(vals: np.ndarray, bits: int) -> np.ndarray:
    m = np.int64(1) << (bits - 1)
    return ((vals & ((np.int64(1) << bits) - 1)) ^ m) - m


def _lpc_prediction(
    err: np.ndarray, n: int, bps: int, coefs: List[int], order: int,
    quant: int,
) -> np.ndarray:
    out = np.zeros(n, np.int64)
    out[0] = err[0]
    if order == 31:
        # first-order "prediction type 15" pre-pass predictor
        prev = int(err[0])
        e = err.tolist()
        o = [0] * n
        o[0] = prev
        mask = (1 << bps) - 1
        half = 1 << (bps - 1)
        for i in range(1, n):
            prev = (prev + e[i]) & mask
            if prev & half:
                prev -= 1 << bps
            o[i] = prev
        return np.asarray(o, np.int64)
    e = err.tolist()
    o = [0] * n
    o[0] = int(e[0])
    mask = (1 << bps) - 1
    half = 1 << (bps - 1)

    def sext(v):
        v &= mask
        return v - (1 << bps) if v & half else v

    upper = min(order, n - 1)
    for i in range(1, upper + 1):
        o[i] = sext(o[i - 1] + e[i])
    c = list(coefs)
    # adaptive FIR: coefs[k] pairs with tap o[i-1-k] (newest-first), the
    # base sample is d = o[i-order-1]; adaptation visits the oldest tap
    # first (k descending) with weight (order-k), flipping each coef by
    # the tap delta's sign until the residual's sign is consumed. The
    # error update uses the SIGNED arithmetic shift (-|v| >> q), which
    # rounds toward -inf — using floor(|v|/2^q) instead desynchronizes
    # the coefficient state from the encoder within a few dozen samples.
    for i in range(order + 1, n):
        d = o[i - order - 1]
        val = 0
        for k in range(order):
            val += (o[i - 1 - k] - d) * c[k]
        val = (val + (1 << (quant - 1))) >> quant
        error_val = e[i]
        o[i] = sext(val + d + error_val)
        if error_val:
            es = 1 if error_val > 0 else -1
            for k in range(order - 1, -1, -1):
                if error_val * es <= 0:
                    break
                v = d - o[i - 1 - k]
                s = ((v > 0) - (v < 0)) * es
                c[k] -= s
                v *= s
                error_val -= (v >> quant) * (order - k)
    return np.asarray(o, np.int64)


def decode_packet(cfg: AlacConfig, packet: bytes) -> np.ndarray:
    """One ALAC packet → `[n, channels]` int32-range samples at
    `cfg.bit_depth` significance."""
    br = _Bits(packet)
    outputs = []
    channels_done = 0
    n_out = cfg.frame_length
    while channels_done < cfg.channels:
        tag = br.read(3)
        if tag == _ID_END:
            break
        if tag in (_ID_SCE, _ID_LFE):
            ch = 1
        elif tag == _ID_CPE:
            ch = 2
        else:
            raise DecodingError(f"alac: unsupported element {tag}")
        br.read(4)  # element instance tag
        if br.read(12) != 0:
            raise DecodingError("alac: bad element header")
        has_size = br.read(1)
        extra_bits = br.read(2) * 8
        is_compressed = br.read(1) == 0
        if has_size:
            n_out = br.read(32)
        bps = cfg.bit_depth - extra_bits + ch - 1
        chans = np.zeros((ch, n_out), np.int64)
        decorr_shift = 0
        decorr_weight = 0
        extra = None
        if is_compressed:
            decorr_shift = br.read(8)
            decorr_weight = br.read_signed(8)
            pred_type = [0] * ch
            quant = [0] * ch
            hist_mult = [0] * ch
            order = [0] * ch
            coefs = [[] for _ in range(ch)]
            for c in range(ch):
                pred_type[c] = br.read(4)
                quant[c] = br.read(4)
                hist_mult[c] = br.read(3)
                order[c] = br.read(5)
                coefs[c] = [br.read_signed(16) for _ in range(order[c])]
            if extra_bits:
                extra = np.zeros((ch, n_out), np.int64)
                for i in range(n_out):
                    for c in range(ch):
                        extra[c, i] = br.read(extra_bits)
            for c in range(ch):
                err = _rice_decompress(
                    br, n_out, bps,
                    (cfg.pb * hist_mult[c]) // 4, cfg.mb, cfg.kb,
                )
                if pred_type[c] == 15:
                    err = _lpc_prediction(err, n_out, bps, [], 31, 0)
                chans[c] = _lpc_prediction(
                    err, n_out, bps, coefs[c], order[c], quant[c]
                )
        else:
            for i in range(n_out):
                for c in range(ch):
                    chans[c, i] = br.read_signed(cfg.bit_depth)
            extra_bits = 0
        if ch == 2 and decorr_weight != 0:
            a = chans[0]
            b = chans[1]
            a = a - ((b * decorr_weight) >> decorr_shift)
            chans = np.stack([a + b, a])
        if extra_bits:
            chans = (chans << extra_bits) | extra
        outputs.append(chans)
        channels_done += ch
    if not outputs:
        raise DecodingError("alac: empty packet")
    return np.concatenate(outputs, axis=0).T[:, : cfg.channels]


def decode_alac(cookie: bytes, packets: List[bytes]) -> np.ndarray:
    """All packets → `[N, channels]` float32 in [-1, 1]."""
    cfg = parse_cookie(cookie)
    chunks = [decode_packet(cfg, p) for p in packets if p]
    pcm = (
        np.concatenate(chunks, axis=0)
        if chunks
        else np.zeros((0, max(cfg.channels, 1)), np.int64)
    )
    scale = float(1 << (cfg.bit_depth - 1))
    return (pcm.astype(np.float64) / scale).astype(np.float32), cfg
