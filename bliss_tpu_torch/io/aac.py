"""Pure-Python AAC-LC decoder for the FFI-free fallback stack.

Closes the `aac` row of the reference's symphonia-all format matrix
(bliss-rs Cargo.toml:55-66). Implements the MPEG-4 AAC Low Complexity
profile decode path (ISO/IEC 14496-3 §4): raw_data_block elements
(SCE/CPE/LFE/DSE/PCE/FIL), section + scalefactor + spectral Huffman
decoding, pulse data, M/S and intensity stereo, PNS, TNS all-pole
filtering, and the long/short (sine/KBD) IMDCT filterbank with
overlap-add. Handles raw AUs with an AudioSpecificConfig (the MP4/M4A
path) and ADTS streams.

PNS noise is spec-compliant but decoder-specific (a seeded LCG), so PNS
bands match other decoders in energy, not samples — the cross-decoder
tests use the reference's tolerance methodology
(src/song/decoder/symphonia.rs:701-750) accordingly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..errors import DecodingError
from .aac_tables import (
    SAMPLE_RATES,
    SCALEFACTOR_CODES,
    SCALEFACTOR_LENGTHS,
    SPECTRAL_CODEBOOKS,
    SWB_LONG_BY_INDEX,
    SWB_OFFSET_128,
    SWB_OFFSET_1024,
    SWB_SHORT_BY_INDEX,
    TNS_MAX_BANDS_128,
    TNS_MAX_BANDS_1024,
)

# window sequences
ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3
# special codebooks
ZERO_HCB = 0
NOISE_HCB = 13
INTENSITY_HCB2 = 14
INTENSITY_HCB = 15


class _Bits:
    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        pos = self.pos
        if pos + n > self.nbits:
            raise DecodingError("aac: bitstream overrun")
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


class _Vlc:
    """Prefix-code decoder: an 8-bit first-stage lookup with per-prefix
    subtables for longer codes."""

    def __init__(self, lengths: List[int], codes: List[int]):
        self.max_len = max(lengths)
        table = {}
        for sym, (l, c) in enumerate(zip(lengths, codes)):
            table[(c, l)] = sym
        self.first = [None] * 256
        self.long_codes = {}
        for (c, l), sym in table.items():
            if l <= 8:
                base = c << (8 - l)
                for i in range(1 << (8 - l)):
                    self.first[base + i] = (sym, l)
            else:
                self.long_codes[(c, l)] = sym

    def decode(self, br: _Bits) -> int:
        avail = br.nbits - br.pos
        peek_n = min(8, avail)
        peek = br.read(peek_n)
        br.pos -= peek_n
        peek <<= 8 - peek_n
        hit = self.first[peek]
        if hit is not None and hit[1] <= avail:
            br.pos += hit[1]
            return hit[0]
        # long code: extend bit by bit
        c = 0
        for l in range(1, self.max_len + 1):
            c = (c << 1) | br.read(1)
            sym = self.long_codes.get((c, l))
            if sym is not None:
                return sym
        raise DecodingError("aac: invalid Huffman code")


_SF_VLC = _Vlc(SCALEFACTOR_LENGTHS, SCALEFACTOR_CODES)
_SPEC_VLC = {
    cb: _Vlc(lens, codes) for cb, (lens, codes) in SPECTRAL_CODEBOOKS.items()
}

#: (dimension, signed, lav) per spectral codebook
_CB_INFO = {
    1: (4, True, 1), 2: (4, True, 1), 3: (4, False, 2), 4: (4, False, 2),
    5: (2, True, 4), 6: (2, True, 4), 7: (2, False, 7), 8: (2, False, 7),
    9: (2, False, 12), 10: (2, False, 12), 11: (2, False, 16),
}


def _cb_tuple(cb: int, idx: int) -> Tuple[int, ...]:
    dim, signed, lav = _CB_INFO[cb]
    span = 2 * lav + 1 if signed else lav + 1
    vals = []
    for _ in range(dim):
        vals.append(idx % span)
        idx //= span
    vals.reverse()
    if signed:
        vals = [v - lav for v in vals]
    return tuple(vals)


_CB_TUPLES = {
    cb: [_cb_tuple(cb, i) for i in range(len(SPECTRAL_CODEBOOKS[cb][0]))]
    for cb in SPECTRAL_CODEBOOKS
}


@dataclass
class AscConfig:
    object_type: int
    rate_index: int
    sample_rate: int
    channels: int
    frame_length: int = 1024


def parse_asc(config: bytes) -> AscConfig:
    """AudioSpecificConfig (ISO 14496-3 §1.6.2.1)."""
    br = _Bits(config)
    aot = br.read(5)
    if aot == 31:
        aot = 32 + br.read(6)
    rate_index = br.read(4)
    if rate_index == 15:
        rate = br.read(24)
    else:
        rate = SAMPLE_RATES[rate_index]
    channels = br.read(4)
    if aot not in (2,):  # LC only (no SBR/PS/Main/LTP)
        raise DecodingError(f"aac: unsupported object type {aot} (LC only)")
    if rate_index == 15:
        rate_index = min(
            range(len(SAMPLE_RATES)),
            key=lambda i: abs(SAMPLE_RATES[i] - rate),
        )
    # GASpecificConfig
    frame_len_flag = br.read(1)
    depends_on_coupler = br.read(1)
    if depends_on_coupler:
        br.read(14)
    ext_flag = br.read(1)
    if frame_len_flag:
        raise DecodingError("aac: 960-sample frames not supported")
    del ext_flag
    return AscConfig(aot, rate_index, rate, channels)


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


def _sine_window(n: int) -> np.ndarray:
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


def _kbd_window(n: int, alpha: float) -> np.ndarray:
    # Kaiser-Bessel derived window (ISO 14496-3 §4.6.11.3.2)
    m = n // 2
    t = np.arange(m + 1) / m
    kernel = np.i0(np.pi * alpha * np.sqrt(1.0 - (2.0 * t - 1.0) ** 2))
    cum = np.cumsum(kernel)
    w = np.sqrt(cum[:m] / cum[m])
    return np.concatenate([w, w[::-1]])


_WINDOWS = {
    (0, 2048): _sine_window(2048),
    (0, 256): _sine_window(256),
    (1, 2048): _kbd_window(2048, 4.0),
    (1, 256): _kbd_window(256, 6.0),
}


_IMDCT_BASIS = {}


def _imdct(spec: np.ndarray) -> np.ndarray:
    """N/2-point spectrum → N time samples:
    x[t] = 2/N · Σ_k X[k] cos(2π/N (t + 1/2 + N/4)(k + 1/2)).
    The cos basis is cached per size (1024-pt: 16 MB, built once)."""
    n2 = spec.shape[0]
    basis = _IMDCT_BASIS.get(n2)
    if basis is None:
        n = 2 * n2
        k = np.arange(n2)
        t = np.arange(n)
        ang = (2.0 * np.pi / n) * np.outer(t + 0.5 + n2 / 2.0, k + 0.5)
        basis = (2.0 / n) * np.cos(ang)
        _IMDCT_BASIS[n2] = basis
    return basis @ spec


def _filterbank(
    spec: np.ndarray, window_sequence: int, shape: int, prev_shape: int,
    overlap: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """One channel's 1024 coefficients → 1024 output samples + new
    overlap, per ISO 14496-3 §4.6.11."""
    w_long_cur = _WINDOWS[(shape, 2048)]
    w_long_prev = _WINDOWS[(prev_shape, 2048)]
    w_short_cur = _WINDOWS[(shape, 256)]
    w_short_prev = _WINDOWS[(prev_shape, 256)]

    if window_sequence != EIGHT_SHORT:
        x = _imdct(spec)  # 2048
        if window_sequence == ONLY_LONG:
            first = x[:1024] * w_long_prev[:1024]
            second = x[1024:] * w_long_cur[1024:]
        elif window_sequence == LONG_START:
            first = x[:1024] * w_long_prev[:1024]
            second = np.concatenate(
                [
                    x[1024:1472],
                    x[1472:1600] * w_short_cur[128:],
                    np.zeros(448),
                ]
            )
        else:  # LONG_STOP
            first = np.concatenate(
                [
                    np.zeros(448),
                    x[448:576] * w_short_prev[:128],
                    x[576:1024],
                ]
            )
            second = x[1024:] * w_long_cur[1024:]
        out = overlap + first
        return out, second

    # EIGHT_SHORT: 8 x 128-coefficient IMDCTs overlap-added at offset 448
    buf = np.zeros(2048)
    for w in range(8):
        x = _imdct(spec[w * 128 : (w + 1) * 128])  # 256
        wp = w_short_prev if w == 0 else w_short_cur
        x = x * np.concatenate([wp[:128], w_short_cur[128:]])
        start = 448 + 128 * w
        buf[start : start + 256] += x
    out = overlap + buf[:1024]
    return out, buf[1024:]


# ---------------------------------------------------------------------------
# per-channel ICS state
# ---------------------------------------------------------------------------


@dataclass
class IcsInfo:
    window_sequence: int = ONLY_LONG
    window_shape: int = 0
    max_sfb: int = 0
    num_windows: int = 1
    num_window_groups: int = 1
    group_len: List[int] = field(default_factory=lambda: [1])
    swb_offset: List[int] = field(default_factory=list)
    num_swb: int = 0
    tns_max_bands: int = 0


@dataclass
class ChannelData:
    ics: IcsInfo = None
    band_cb: List[List[int]] = None  # [group][sfb]
    band_sf: List[List[float]] = None  # linear gains
    band_sf_int: List[List[int]] = None
    coeffs: np.ndarray = None  # [1024] dequantized
    tns = None
    pulse = None


def _parse_ics_info(br: _Bits, cfg: AscConfig) -> IcsInfo:
    info = IcsInfo()
    br.read(1)  # ics_reserved_bit
    info.window_sequence = br.read(2)
    info.window_shape = br.read(1)
    ri = cfg.rate_index
    if info.window_sequence == EIGHT_SHORT:
        info.max_sfb = br.read(4)
        grouping = br.read(7)
        info.num_windows = 8
        groups = [1]
        for b in range(6, -1, -1):
            if (grouping >> b) & 1:
                groups[-1] += 1
            else:
                groups.append(1)
        info.num_window_groups = len(groups)
        info.group_len = groups
        offs = SWB_OFFSET_128[SWB_SHORT_BY_INDEX[ri]]
        info.swb_offset = offs
        info.num_swb = len(offs) - 1
        info.tns_max_bands = TNS_MAX_BANDS_128[ri]
    else:
        info.max_sfb = br.read(6)
        predictor = br.read(1)
        if predictor:
            raise DecodingError("aac: predictor data in LC stream")
        info.num_windows = 1
        info.num_window_groups = 1
        info.group_len = [1]
        offs = SWB_OFFSET_1024[SWB_LONG_BY_INDEX[ri]]
        info.swb_offset = offs
        info.num_swb = len(offs) - 1
        info.tns_max_bands = TNS_MAX_BANDS_1024[ri]
    if info.max_sfb > info.num_swb:
        raise DecodingError("aac: max_sfb exceeds num_swb")
    return info


def _parse_section_data(br: _Bits, info: IcsInfo) -> List[List[int]]:
    bits = 3 if info.window_sequence == EIGHT_SHORT else 5
    esc = (1 << bits) - 1
    out = []
    for _g in range(info.num_window_groups):
        cbs = [0] * info.max_sfb
        k = 0
        while k < info.max_sfb:
            cb = br.read(4)
            sect_len = 0
            while True:
                inc = br.read(bits)
                sect_len += inc
                if inc != esc:
                    break
            if k + sect_len > info.max_sfb:
                raise DecodingError("aac: section overruns max_sfb")
            for i in range(sect_len):
                cbs[k + i] = cb
            k += sect_len
        out.append(cbs)
    return out


def _parse_scale_factors(
    br: _Bits, info: IcsInfo, band_cb, global_gain: int
) -> List[List[int]]:
    sf = global_gain
    is_pos = 0
    noise = global_gain - 90
    noise_first = True
    out = []
    for g in range(info.num_window_groups):
        row = [0] * info.max_sfb
        for b in range(info.max_sfb):
            cb = band_cb[g][b]
            if cb == ZERO_HCB:
                continue
            if cb in (INTENSITY_HCB, INTENSITY_HCB2):
                is_pos += _SF_VLC.decode(br) - 60
                row[b] = is_pos
            elif cb == NOISE_HCB:
                if noise_first:
                    noise += br.read(9) - 256
                    noise_first = False
                else:
                    noise += _SF_VLC.decode(br) - 60
                row[b] = noise
            else:
                sf += _SF_VLC.decode(br) - 60
                if not 0 <= sf <= 255:
                    raise DecodingError("aac: scalefactor out of range")
                row[b] = sf
        out.append(row)
    return out


def _parse_pulse(br: _Bits):
    n = br.read(2) + 1
    start_sfb = br.read(6)
    offs = []
    amps = []
    for _ in range(n):
        offs.append(br.read(5))
        amps.append(br.read(4))
    return start_sfb, offs, amps


def _parse_tns(br: _Bits, info: IcsInfo):
    short = info.window_sequence == EIGHT_SHORT
    n_filt_bits, len_bits, order_bits = (1, 4, 3) if short else (2, 6, 5)
    filters = []
    for _w in range(info.num_windows):
        n_filt = br.read(n_filt_bits)
        coef_res = br.read(1) if n_filt else 0
        wf = []
        for _ in range(n_filt):
            length = br.read(len_bits)
            order = br.read(order_bits)
            if order:
                direction = br.read(1)
                compress = br.read(1)
                coef_bits = coef_res + 3 - compress
                coefs = [br.read_signed(coef_bits) for _ in range(order)]
                wf.append((length, order, direction, coef_res, coefs))
            else:
                wf.append((length, 0, 0, 0, []))
        filters.append(wf)
    return filters


def _tns_lpc(coefs: List[int], coef_res: int) -> np.ndarray:
    coef_res_bits = coef_res + 3
    iqfac = ((1 << (coef_res_bits - 1)) - 0.5) / (np.pi / 2.0)
    iqfac_m = ((1 << (coef_res_bits - 1)) + 0.5) / (np.pi / 2.0)
    tmp = np.array(
        [math.sin(c / (iqfac if c >= 0 else iqfac_m)) for c in coefs]
    )
    order = len(coefs)
    a = np.zeros(order + 1)
    a[0] = 1.0
    for m in range(1, order + 1):
        b = a.copy()
        for i in range(1, m):
            b[i] = a[i] + tmp[m - 1] * a[m - i]
        b[m] = tmp[m - 1]
        a = b
    return a  # a[0]=1, filter y[n] = x[n] - sum a[k] y[n-k]


def _apply_tns(cd: ChannelData, cfg: AscConfig):
    if not cd.tns:
        return
    info = cd.ics
    mmm = min(info.tns_max_bands, info.max_sfb)
    n_per_win = 128 if info.window_sequence == EIGHT_SHORT else 1024
    for w, wf in enumerate(cd.tns):
        bottom = info.num_swb
        for (length, order, direction, coef_res, coefs) in wf:
            top = bottom
            bottom = max(top - length, 0)
            if order == 0:
                continue
            a = _tns_lpc(coefs, coef_res)
            start_b = min(bottom, mmm)
            end_b = min(top, mmm)
            start = info.swb_offset[start_b]
            end = info.swb_offset[end_b]
            if start >= end:
                continue
            seg = cd.coeffs[w * n_per_win + start : w * n_per_win + end]
            if direction:
                seg = seg[::-1]
            y = seg.copy()
            for i in range(len(y)):
                acc = seg[i]
                for k in range(1, min(order, i) + 1):
                    acc -= a[k] * y[i - k]
                y[i] = acc
            if direction:
                y = y[::-1]
            cd.coeffs[
                w * n_per_win + start : w * n_per_win + end
            ] = y


def _decode_spectrum(br: _Bits, info: IcsInfo, band_cb) -> np.ndarray:
    """Quantized coefficients, deinterleaved to [1024] window order."""
    quant = np.zeros(1024, np.float64)
    win_base = 0
    for g in range(info.num_window_groups):
        glen = info.group_len[g]
        n_per_win = 128 if info.window_sequence == EIGHT_SHORT else 1024
        for b in range(info.max_sfb):
            cb = band_cb[g][b]
            lo = info.swb_offset[b]
            hi = info.swb_offset[b + 1]
            if cb == ZERO_HCB or cb in (
                NOISE_HCB, INTENSITY_HCB, INTENSITY_HCB2,
            ):
                continue
            vlc = _SPEC_VLC[cb]
            tuples = _CB_TUPLES[cb]
            dim, signed, lav = _CB_INFO[cb]
            for w in range(glen):
                out_off = (win_base + w) * n_per_win
                k = lo
                while k < hi:
                    vals = list(tuples[vlc.decode(br)])
                    if not signed:
                        for i, v in enumerate(vals):
                            if v and br.read(1):
                                vals[i] = -v
                    if cb == 11:
                        for i, v in enumerate(vals):
                            if abs(v) == 16:
                                n_pre = 0
                                while br.read(1):
                                    n_pre += 1
                                word = br.read(n_pre + 4)
                                mag = (1 << (n_pre + 4)) + word
                                vals[i] = mag if v > 0 else -mag
                    for i, v in enumerate(vals):
                        quant[out_off + k + i] = v
                    k += dim
        win_base += glen
    return quant


def _dequant(quant: np.ndarray) -> np.ndarray:
    return np.sign(quant) * np.abs(quant) ** (4.0 / 3.0)


def _apply_scalefactors(cd: ChannelData):
    info = cd.ics
    n_per_win = 128 if info.window_sequence == EIGHT_SHORT else 1024
    win_base = 0
    for g in range(info.num_window_groups):
        for b in range(info.max_sfb):
            cb = cd.band_cb[g][b]
            if cb in (ZERO_HCB, NOISE_HCB, INTENSITY_HCB, INTENSITY_HCB2):
                continue
            gain = 2.0 ** (0.25 * (cd.band_sf_int[g][b] - 100))
            lo = info.swb_offset[b]
            hi = info.swb_offset[b + 1]
            for w in range(info.group_len[g]):
                off = (win_base + w) * n_per_win
                cd.coeffs[off + lo : off + hi] *= gain
        win_base += info.group_len[g]


class _Lcg:
    """Deterministic noise source for PNS (decoder-specific per spec)."""

    def __init__(self, seed: int = 0x1F2E3D4C):
        self.state = seed

    def next(self) -> int:
        self.state = (self.state * 1664525 + 1013904223) & 0xFFFFFFFF
        return self.state


def _apply_pns_and_intensity(
    pair: List[ChannelData], ms_mask, lcg: _Lcg
):
    """PNS band fill + intensity stereo (CPE right channel) + M/S."""
    for ci, cd in enumerate(pair):
        info = cd.ics
        n_per_win = 128 if info.window_sequence == EIGHT_SHORT else 1024
        win_base = 0
        for g in range(info.num_window_groups):
            for b in range(info.max_sfb):
                if cd.band_cb[g][b] != NOISE_HCB:
                    continue
                lo = info.swb_offset[b]
                hi = info.swb_offset[b + 1]
                for w in range(info.group_len[g]):
                    off = (win_base + w) * n_per_win
                    n = hi - lo
                    noise = np.array(
                        [lcg.next() for _ in range(n)], np.float64
                    )
                    noise = (noise / 2**31) - 1.0
                    energy = np.sqrt(np.sum(noise * noise))
                    if energy > 0:
                        scale = 2.0 ** (
                            0.25 * cd.band_sf_int[g][b]
                        ) / energy
                        cd.coeffs[off + lo : off + hi] = noise * scale
            win_base += info.group_len[g]

    if len(pair) != 2:
        return
    left, right = pair
    info = right.ics
    if left.ics.num_window_groups != info.num_window_groups:
        return
    n_per_win = 128 if info.window_sequence == EIGHT_SHORT else 1024
    win_base = 0
    for g in range(info.num_window_groups):
        for b in range(info.max_sfb):
            cb = right.band_cb[g][b]
            if cb not in (INTENSITY_HCB, INTENSITY_HCB2):
                continue
            lo = info.swb_offset[b]
            hi = info.swb_offset[b + 1]
            sign = 1.0 if cb == INTENSITY_HCB else -1.0
            if ms_mask is not None and ms_mask[g][b]:
                sign = -sign
            scale = sign * 0.5 ** (0.25 * right.band_sf_int[g][b])
            for w in range(info.group_len[g]):
                off = (win_base + w) * n_per_win
                right.coeffs[off + lo : off + hi] = (
                    left.coeffs[off + lo : off + hi] * scale
                )
        win_base += info.group_len[g]


def _apply_ms(pair: List[ChannelData], ms_mask):
    if ms_mask is None:
        return
    left, right = pair
    info = left.ics
    n_per_win = 128 if info.window_sequence == EIGHT_SHORT else 1024
    win_base = 0
    for g in range(info.num_window_groups):
        for b in range(info.max_sfb):
            if not ms_mask[g][b]:
                continue
            if right.band_cb[g][b] in (INTENSITY_HCB, INTENSITY_HCB2):
                continue  # handled by intensity sign flip
            if left.band_cb[g][b] == NOISE_HCB or right.band_cb[g][b] == NOISE_HCB:
                continue
            lo = info.swb_offset[b]
            hi = info.swb_offset[b + 1]
            for w in range(info.group_len[g]):
                off = (win_base + w) * n_per_win
                m = left.coeffs[off + lo : off + hi].copy()
                s = right.coeffs[off + lo : off + hi].copy()
                left.coeffs[off + lo : off + hi] = m + s
                right.coeffs[off + lo : off + hi] = m - s
        win_base += info.group_len[g]


class AacDecoder:
    def __init__(self, cfg: AscConfig):
        self.cfg = cfg
        self.lcg = _Lcg()
        n_ch = max(cfg.channels, 1)
        self.overlap = [np.zeros(1024) for _ in range(n_ch)]
        self.prev_shape = [0] * n_ch
        self.prev_seq = [ONLY_LONG] * n_ch

    def _decode_ics(
        self, br: _Bits, common_info: Optional[IcsInfo]
    ) -> ChannelData:
        cd = ChannelData()
        global_gain = br.read(8)
        if common_info is not None:
            cd.ics = common_info
        else:
            cd.ics = _parse_ics_info(br, self.cfg)
        cd.band_cb = _parse_section_data(br, cd.ics)
        cd.band_sf_int = _parse_scale_factors(
            br, cd.ics, cd.band_cb, global_gain
        )
        pulse_present = br.read(1)
        if pulse_present:
            if cd.ics.window_sequence == EIGHT_SHORT:
                raise DecodingError("aac: pulse data in short window")
            cd.pulse = _parse_pulse(br)
        tns_present = br.read(1)
        if tns_present:
            cd.tns = _parse_tns(br, cd.ics)
        if br.read(1):
            raise DecodingError("aac: gain control not supported in LC")
        quant = _decode_spectrum(br, cd.ics, cd.band_cb)
        if cd.pulse is not None:
            start_sfb, offs, amps = cd.pulse
            k = cd.ics.swb_offset[start_sfb]
            for o, a in zip(offs, amps):
                k += o
                if quant[k] > 0:
                    quant[k] += a
                else:
                    quant[k] -= a
        cd.coeffs = _dequant(quant)
        _apply_scalefactors(cd)
        return cd

    def _finish_channel(self, ch: int, cd: ChannelData) -> np.ndarray:
        _apply_tns(cd, self.cfg)
        out, overlap = _filterbank(
            cd.coeffs,
            cd.ics.window_sequence,
            cd.ics.window_shape,
            self.prev_shape[ch],
            self.overlap[ch],
        )
        self.overlap[ch] = overlap
        self.prev_shape[ch] = cd.ics.window_shape
        self.prev_seq[ch] = cd.ics.window_sequence
        return out

    def decode_frame(self, au: bytes) -> np.ndarray:
        """One raw_data_block → [1024, channels] float64."""
        br = _Bits(au)
        outputs = {}
        ch_index = 0
        while True:
            ele_id = br.read(3)
            if ele_id == 7:  # END
                break
            if ele_id in (0, 3):  # SCE / LFE
                br.read(4)
                cd = self._decode_ics(br, None)
                outputs[ch_index] = self._finish_channel(ch_index, cd)
                ch_index += 1
            elif ele_id == 1:  # CPE
                br.read(4)
                common = br.read(1)
                ms_mask = None
                shared = None
                if common:
                    shared = _parse_ics_info(br, self.cfg)
                    ms_present = br.read(2)
                    if ms_present == 1:
                        ms_mask = [
                            [br.read(1) for _ in range(shared.max_sfb)]
                            for _ in range(shared.num_window_groups)
                        ]
                    elif ms_present == 2:
                        ms_mask = [
                            [1] * shared.max_sfb
                            for _ in range(shared.num_window_groups)
                        ]
                    elif ms_present == 3:
                        raise DecodingError("aac: reserved ms_present")
                left = self._decode_ics(br, shared)
                right = self._decode_ics(br, shared)
                _apply_ms([left, right], ms_mask)
                _apply_pns_and_intensity([left, right], ms_mask, self.lcg)
                outputs[ch_index] = self._finish_channel(ch_index, left)
                outputs[ch_index + 1] = self._finish_channel(
                    ch_index + 1, right
                )
                ch_index += 2
            elif ele_id == 4:  # DSE
                br.read(4)
                align = br.read(1)
                cnt = br.read(8)
                if cnt == 255:
                    cnt += br.read(8)
                if align:
                    br.pos = (br.pos + 7) & ~7
                br.pos += 8 * cnt
            elif ele_id == 5:  # PCE
                _skip_pce(br)
            elif ele_id == 6:  # FIL
                cnt = br.read(4)
                if cnt == 15:
                    cnt += br.read(8) - 1
                br.pos += 8 * cnt
            else:
                raise DecodingError(f"aac: unsupported element {ele_id}")
        n_ch = max(len(outputs), 1)
        frame = np.zeros((1024, n_ch))
        for c in range(len(outputs)):
            frame[:, c] = outputs[c]
        return frame


def _skip_pce(br: _Bits):
    br.read(4)  # instance tag
    br.read(2)  # object type
    br.read(4)  # sample rate index
    nfront = br.read(4)
    nside = br.read(4)
    nback = br.read(4)
    nlfe = br.read(2)
    ndata = br.read(3)
    ncc = br.read(4)
    if br.read(1):
        br.read(4)  # mono mixdown
    if br.read(1):
        br.read(4)  # stereo mixdown
    if br.read(1):
        br.read(3)  # matrix mixdown
    for _ in range(nfront + nside + nback):
        br.read(5)
    for _ in range(nlfe + ndata):
        br.read(4)
    for _ in range(ncc):
        br.read(5)
    br.pos = (br.pos + 7) & ~7
    n = br.read(8)
    br.pos += 8 * n


def decode_aac(
    config: bytes, aus: List[bytes]
) -> Tuple[np.ndarray, AscConfig]:
    """All access units → `[N, channels]` float32 (full scale ±1)."""
    cfg = parse_asc(config)
    dec = AacDecoder(cfg)
    frames = [dec.decode_frame(au) for au in aus if au]
    # flush: one zero-input frame drains the final overlap
    if frames:
        n_ch = frames[0].shape[1]
        frames.append(np.stack([dec.overlap[c] for c in range(n_ch)], 1))
        pcm = np.concatenate(frames, axis=0)
    else:
        pcm = np.zeros((0, max(cfg.channels, 1)))
    # the spec's reference output is 16-bit-integer full scale; the
    # canonical float convention (matching libav) divides by 2^15
    return (pcm / 32768.0).astype(np.float32), cfg


def read_adts(data: bytes) -> Tuple[bytes, List[bytes]]:
    """Split an ADTS stream into (AudioSpecificConfig, raw AUs)."""
    aus = []
    pos = 0
    cfg = None
    n = len(data)
    while pos + 7 <= n:
        if data[pos] != 0xFF or (data[pos + 1] & 0xF6) != 0xF0:
            pos += 1
            continue
        protection_absent = data[pos + 1] & 1
        profile = (data[pos + 2] >> 6) + 1
        rate_index = (data[pos + 2] >> 2) & 0xF
        channels = ((data[pos + 2] & 1) << 2) | (data[pos + 3] >> 6)
        frame_len = (
            ((data[pos + 3] & 0x03) << 11)
            | (data[pos + 4] << 3)
            | (data[pos + 5] >> 5)
        )
        if frame_len < 7 or pos + frame_len > n:
            break
        header = 7 if protection_absent else 9
        aus.append(data[pos + header : pos + frame_len])
        if cfg is None:
            asc0 = (profile << 3) | (rate_index >> 1)
            asc1 = ((rate_index & 1) << 7) | (channels << 3)
            cfg = bytes([asc0, asc1])
        pos += frame_len
    if cfg is None:
        raise DecodingError("aac: no ADTS frames found")
    return cfg, aus
