"""Pure-Python MP3 (MPEG-1/2/2.5 Audio Layer III) decoder for the
FFI-free fallback decode stack.

Completes the reference fallback's format matrix — Symphonia covers
FLAC/MP3/OGG/WAV (bliss-rs src/song/decoder/symphonia.rs, feature
symphonia-mp3) — with a clean-room Layer III implementation built on
numpy. The normative bitstream constants (Huffman tables B.7,
scalefactor band widths B.8, pretab B.6, slen B.5, LSF grouping,
synthesis window C.1) live in `mp3_tables.py`.

Structure: the bit-serial stages (header/side-info/scalefactors/Huffman)
run per granule in Python; everything after requantization is batched
numpy over the whole song — stereo/alias/reorder per granule on
576-vectors, then ONE shot for the 18-point/6-point IMDCT (matmul),
overlap-add (a shifted add across granules), frequency inversion, and
the polyphase synthesis filterbank (a [T, 32] @ [32, 64] matmul plus 16
shifted window taps — the V-FIFO unrolls into pure array shifts).

Gapless alignment: the Xing/Info+LAME tag's encoder delay/padding are
honored exactly like ffmpeg's demuxer (start skip = delay + 529), so
decoded PCM lines up sample-exact with the native libav path.

Error handling mirrors the reference's decode-retry semantics
(symphonia.rs:86 MAX_DECODE_RETRIES = 3): a malformed frame
resynchronizes to the next header, up to 3 failures.
"""

from __future__ import annotations

import math
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import DecodingError
from . import mp3_tables as T

MAX_DECODE_RETRIES = 3  # symphonia.rs:86


class _Corrupt(Exception):
    """A malformed frame — resync and retry (internal)."""


# --------------------------------------------------------------------------
# MSB-first bit reader

class _Bits:
    __slots__ = ("val", "n", "pos")

    def __init__(self, data: bytes):
        self.val = int.from_bytes(data, "big")
        self.n = len(data) * 8
        self.pos = 0

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        pos = self.pos
        if pos + k > self.n:
            raise _Corrupt("bitstream overrun")
        self.pos = pos + k
        return (self.val >> (self.n - pos - k)) & ((1 << k) - 1)

    def peek(self, k: int) -> int:
        pos = self.pos
        shift = self.n - pos - k
        if shift >= 0:
            return (self.val >> shift) & ((1 << k) - 1)
        # past the end: pad with zero bits
        return (self.val << -shift) & ((1 << k) - 1)


# --------------------------------------------------------------------------
# Huffman tables (canonical codes reconstructed from the length lists)

class _Vlc:
    __slots__ = ("prim", "long", "maxlen", "pbits")

    def __init__(self, pairs: List[Tuple[int, int, int]]):
        """pairs: (code, length, symbol), code MSB-first."""
        maxlen = max(l for _, l, _ in pairs)
        pbits = min(maxlen, 10)
        prim: List[Tuple[int, int]] = [(-1, 0)] * (1 << pbits)
        longc: Dict[Tuple[int, int], int] = {}
        for code, l, sym in pairs:
            if l <= pbits:
                base = code << (pbits - l)
                for k in range(1 << (pbits - l)):
                    prim[base + k] = (sym, l)
            else:
                longc[(l, code)] = sym
        self.prim = prim
        self.long = longc
        self.maxlen = maxlen
        self.pbits = pbits

    def decode(self, bits: _Bits) -> int:
        v = bits.peek(self.pbits)
        sym, l = self.prim[v]
        if sym < 0:
            for l in range(self.pbits + 1, self.maxlen + 1):
                s = self.long.get((l, bits.peek(l)), -1)
                if s >= 0:
                    sym = s
                    break
            else:
                raise _Corrupt("invalid huffman codeword")
        bits.pos += l
        if bits.pos > bits.n:
            raise _Corrupt("bitstream overrun")
        return sym


def _canonical_pairs(lens: bytes, syms: bytes) -> List[Tuple[int, int, int]]:
    """Leaves listed left-to-right; assign canonical codes."""
    cur = 0
    out = []
    for l, s in zip(lens, syms):
        code = cur >> (32 - l)
        cur = (cur + (1 << (32 - l))) & 0xFFFFFFFF
        out.append((code, l, s))
    return out


def _build_tables():
    big = [None]  # index 0 = the all-zero table
    off = 0
    for size in T.HUFF_SIZES:
        pairs = _canonical_pairs(
            T.HUFF_LENS[off : off + size], T.HUFF_SYMS[off : off + size]
        )
        big.append(_Vlc(pairs))
        off += size
    quad = []
    for t in range(2):
        pairs = [
            (T.QUAD_CODES[t][i], T.QUAD_BITS[t][i], i) for i in range(16)
        ]
        quad.append(_Vlc(pairs))
    return big, quad


_BIG_VLC, _QUAD_VLC = _build_tables()

# intensity-stereo ratio table (MPEG-1, ISO 2.4.3.4.9.3):
# is_ratio = tan(is_pos * pi / 12)
_IS_TAB = np.array(
    [math.tan(p * math.pi / 12.0) for p in range(7)], dtype=np.float64
)
# MPEG-2 LSF intensity factors: 2^(-(is_pos+1)/2 >> ...) handled inline

# alias-reduction butterflies (ISO Table B.9)
_CI = np.array(
    [-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037]
)
_CS = 1.0 / np.sqrt(1.0 + _CI * _CI)
_CA = _CI / np.sqrt(1.0 + _CI * _CI)


# --------------------------------------------------------------------------
# Frame header

class _Header:
    __slots__ = (
        "lsf", "mpeg25", "rate", "rate_index", "bitrate", "mode",
        "mode_ext", "frame_bytes", "nb_granules", "crc",
    )


def _parse_header(word: int) -> Optional[_Header]:
    if (word >> 21) & 0x7FF != 0x7FF:
        return None
    version = (word >> 19) & 3
    layer = (word >> 17) & 3
    if version == 1 or layer != 1:  # reserved version, or not Layer III
        return None
    bitrate_index = (word >> 12) & 15
    sr_index = (word >> 10) & 3
    if bitrate_index in (0, 15) or sr_index == 3:
        return None  # free-format unsupported
    h = _Header()
    h.lsf = version != 3
    h.mpeg25 = version == 0
    h.crc = ((word >> 16) & 1) == 0
    base = T.SAMPLE_RATES[sr_index]
    h.rate = base >> (2 if h.mpeg25 else (1 if h.lsf else 0))
    # band-table row: 0-2 MPEG1, 3-5 MPEG2, 6-8 MPEG2.5
    h.rate_index = sr_index + (6 if h.mpeg25 else (3 if h.lsf else 0))
    kbps = (T.BITRATES_V2_L3 if h.lsf else T.BITRATES_V1_L3)[bitrate_index]
    h.bitrate = kbps * 1000
    padding = (word >> 9) & 1
    h.mode = (word >> 6) & 3  # 0 stereo, 1 joint, 2 dual, 3 mono
    h.mode_ext = (word >> 4) & 3
    h.nb_granules = 1 if h.lsf else 2
    h.frame_bytes = (72 if h.lsf else 144) * h.bitrate // h.rate + padding
    return h


# --------------------------------------------------------------------------
# Side info / scalefactors

class _Granule:
    __slots__ = (
        "part2_3_length", "big_values", "global_gain", "scalefac_compress",
        "block_type", "switch_point", "table_select", "subblock_gain",
        "region0", "region1", "preflag", "scalefac_scale",
        "count1table_select", "scale_factors",
    )


def _parse_side_info(bits: _Bits, h: _Header, nch: int):
    main_data_begin = bits.read(8 if h.lsf else 9)
    if h.lsf:
        bits.read(nch)  # private bits
    else:
        bits.read(5 if nch == 1 else 3)
    scfsi = [[0] * 4 for _ in range(nch)]
    if not h.lsf:
        for c in range(nch):
            for b in range(4):
                scfsi[c][b] = bits.read(1)
    granules = []
    for _g in range(h.nb_granules):
        row = []
        for _c in range(nch):
            g = _Granule()
            g.part2_3_length = bits.read(12)
            g.big_values = bits.read(9)
            if g.big_values > 288:
                raise _Corrupt("big_values > 288")
            g.global_gain = bits.read(8)
            g.scalefac_compress = bits.read(9 if h.lsf else 4)
            g.subblock_gain = (0, 0, 0)
            g.preflag = 0
            if bits.read(1):  # window switching
                g.block_type = bits.read(2)
                if g.block_type == 0:
                    raise _Corrupt("block_type 0 with window switching")
                g.switch_point = bits.read(1)
                g.table_select = (bits.read(5), bits.read(5), 0)
                g.subblock_gain = (bits.read(3), bits.read(3), bits.read(3))
                # huffman region split (lines): 36 for short, 36/54 for
                # start/stop depending on MPEG1 vs LSF rates — except the
                # 8 kHz MPEG-2.5 band table (rate_index 8), whose wider
                # bands make it 72/108 (ffmpeg mpegaudiodec region_size)
                if g.block_type == 2:
                    g.region0 = 36 if h.rate_index != 8 else 72
                elif h.rate_index <= 2:
                    g.region0 = 36
                else:
                    g.region0 = 54 if h.rate_index != 8 else 108
                g.region1 = 576
            else:
                g.block_type = 0
                g.switch_point = 0
                g.table_select = (bits.read(5), bits.read(5), bits.read(5))
                r0 = bits.read(4)
                r1 = bits.read(3)
                bl = _band_index_long(h.rate_index)
                g.region0 = bl[min(r0 + 1, 22)]
                g.region1 = bl[min(r0 + 1 + r1 + 1, 22)]
            if not h.lsf:
                g.preflag = bits.read(1)
            g.scalefac_scale = bits.read(1)
            g.count1table_select = bits.read(1)
            row.append(g)
        granules.append(row)
    return main_data_begin, scfsi, granules


_BAND_INDEX_LONG: Dict[int, Tuple[int, ...]] = {}


def _band_index_long(rate_index: int) -> Tuple[int, ...]:
    bi = _BAND_INDEX_LONG.get(rate_index)
    if bi is None:
        acc, out = 0, [0]
        for w in T.BAND_LONG[rate_index]:
            acc += w
            out.append(acc)
        bi = tuple(out)
        _BAND_INDEX_LONG[rate_index] = bi
    return bi


def _read_scalefactors_mpeg1(
    bits: _Bits, g: _Granule, scfsi: List[int], prev: Optional[_Granule],
    granule_idx: int,
):
    slen1 = T.SLEN[0][g.scalefac_compress]
    slen2 = T.SLEN[1][g.scalefac_compress]
    if g.block_type == 2:
        sf = []
        if g.switch_point:
            for _ in range(8):
                sf.append(bits.read(slen1))
            for _ in range(9):  # short sfb 3..5, 3 windows
                sf.append(bits.read(slen1))
        else:
            for _ in range(18):  # short sfb 0..5
                sf.append(bits.read(slen1))
        for _ in range(18):  # short sfb 6..11
            sf.append(bits.read(slen2))
        g.scale_factors = sf + [0, 0, 0]
    else:
        groups = ((0, 6, slen1), (6, 11, slen1), (11, 16, slen2), (16, 21, slen2))
        sf = [0] * 21
        for b, (lo, hi, sl) in enumerate(groups):
            if granule_idx == 1 and scfsi[b]:
                sf[lo:hi] = prev.scale_factors[lo:hi]  # type: ignore[union-attr]
            else:
                for i in range(lo, hi):
                    sf[i] = bits.read(sl)
        g.scale_factors = sf + [0]


def _lsf_sf_expand(sf: int, n1: int, n2: int, n3: int) -> List[int]:
    slen = [0, 0, 0, 0]
    if n3:
        slen[3] = sf % n3
        sf //= n3
    if n2:
        slen[2] = sf % n2
        sf //= n2
    if n1:
        slen[1] = sf % n1
        sf //= n1
    slen[0] = sf
    return slen


def _read_scalefactors_lsf(
    bits: _Bits, g: _Granule, intensity_channel: bool
):
    """MPEG-2 LSF scalefactors (ISO 13818-3 2.4.3.2)."""
    tindex = (2 if g.switch_point else 1) if g.block_type == 2 else 0
    sf = g.scalefac_compress
    g.preflag = 0
    if intensity_channel:
        sf >>= 1
        if sf < 180:
            slen = _lsf_sf_expand(sf, 6, 6, 0)
            tindex2 = 3
        elif sf < 244:
            slen = _lsf_sf_expand(sf - 180, 4, 4, 0)
            tindex2 = 4
        else:
            slen = _lsf_sf_expand(sf - 244, 3, 0, 0)
            tindex2 = 5
    else:
        if sf < 400:
            slen = _lsf_sf_expand(sf, 5, 4, 4)
            tindex2 = 0
        elif sf < 500:
            slen = _lsf_sf_expand(sf - 400, 5, 4, 0)
            tindex2 = 1
        else:
            slen = _lsf_sf_expand(sf - 500, 3, 0, 0)
            tindex2 = 2
            g.preflag = 1
    out = []
    for k in range(4):
        n = T.LSF_NSF[tindex2][tindex][k]
        sl = slen[k]
        if sl:
            for _ in range(n):
                out.append(bits.read(sl))
        else:
            out.extend([0] * n)
    out.extend([0, 0, 0])
    g.scale_factors = out


# --------------------------------------------------------------------------
# Huffman spectral decode

def _decode_huffman(bits: _Bits, g: _Granule, bit_end: int) -> np.ndarray:
    x = np.zeros(576, np.float64)
    pos = 0
    regions = (
        (min(g.region0, g.big_values * 2), g.table_select[0]),
        (min(g.region1, g.big_values * 2), g.table_select[1]),
        (g.big_values * 2, g.table_select[2]),
    )
    vals: List[float] = []
    read = bits.read
    for bound, tsel in regions:
        if bound <= pos:
            continue
        vlc_idx, linbits = T.HUFF_MAP[tsel]
        if vlc_idx == 0:
            vals.extend([0.0] * (bound - pos))
            pos = bound
            continue
        vlc = _BIG_VLC[vlc_idx]
        dec = vlc.decode
        while pos < bound:
            sym = dec(bits)
            xv = sym >> 4
            yv = sym & 15
            if xv:
                if xv == 15 and linbits:
                    xv += read(linbits)
                if read(1):
                    xv = -xv
            if yv:
                if yv == 15 and linbits:
                    yv += read(linbits)
                if read(1):
                    yv = -yv
            vals.append(float(xv))
            vals.append(float(yv))
            pos += 2
    # count1 region: quads until the granule's bit budget runs out
    qvlc = _QUAD_VLC[g.count1table_select]
    qdec = qvlc.decode
    while pos <= 572 and bits.pos < bit_end:
        sym = qdec(bits)
        quad = []
        for shift in (3, 2, 1, 0):
            v = (sym >> shift) & 1
            if v and read(1):
                v = -v
            quad.append(float(v))
        if bits.pos > bit_end:
            break  # overshoot: the last quad is discarded (ISO 2.4.3.4.6)
        vals.extend(quad)
        pos += 4
    n = min(len(vals), 576)
    x[:n] = vals[:n]
    return x


# --------------------------------------------------------------------------
# Requantization / stereo / reorder / alias

def _band_widths(g: _Granule, rate_index: int):
    """Per-line scalefactor-band id arrays for this granule's layout."""
    long_w = T.BAND_LONG[rate_index]
    short_w = T.BAND_SHORT[rate_index]
    if g.block_type != 2:
        return ("long", long_w, None)
    if g.switch_point:
        # mixed: long bands up to 36 lines, then short from sfb 3
        acc, nlong = 0, 0
        for w in long_w:
            if acc >= 36:
                break
            acc += w
            nlong += 1
        return ("mixed", long_w[:nlong], short_w[3:])
    return ("short", None, short_w)


def _requantize(x: np.ndarray, g: _Granule, rate_index: int) -> np.ndarray:
    kind, lw, sw = _band_widths(g, rate_index)
    sf = g.scale_factors
    shift = g.scalefac_scale + 1
    gg = g.global_gain - 210
    exps = np.zeros(576, np.int32)
    if kind == "long":
        gains = []
        for b, w in enumerate(lw):
            s = sf[b] + (T.PRETAB[b] if g.preflag else 0)
            gains.append(gg - (s << shift))
        exps[:] = np.repeat(np.asarray(gains, np.int32), lw)[:576]
    else:
        sfi = 0
        parts = []
        if kind == "mixed":
            for b, w in enumerate(lw):
                s = sf[sfi] + (T.PRETAB[b] if g.preflag else 0)
                parts.append(np.full(w, gg - (s << shift), np.int32))
                sfi += 1
        for w in sw:
            for win in range(3):
                s = sf[sfi]
                e = gg - 8 * g.subblock_gain[win] - (s << shift)
                parts.append(np.full(w, e, np.int32))
                sfi += 1
        cat = np.concatenate(parts)[:576]
        exps[: cat.shape[0]] = cat
    out = np.sign(x) * np.abs(x) ** (4.0 / 3.0)
    out *= np.exp2(exps.astype(np.float64) / 4.0)
    return out


def _reorder_map(g: _Granule, rate_index: int) -> Optional[np.ndarray]:
    """Decoded order -> subband-interleaved order for short blocks."""
    if g.block_type != 2:
        return None
    key = (rate_index, g.switch_point)
    m = _REORDER_CACHE.get(key)
    if m is not None:
        return m
    kind, lw, sw = _band_widths(g, rate_index)
    idx = np.arange(576)
    pos = 0
    src = []
    dst = []
    if kind == "mixed":
        n_long = int(sum(lw))
        src.extend(range(n_long))
        dst.extend(range(n_long))
        pos = n_long
    for w in sw:
        if pos + 3 * w > 576:
            break
        for win in range(3):
            for l in range(w):
                src.append(pos + win * w + l)  # decoded: sfb-major
                dst.append(pos + l * 3 + win)  # target: line-major
        pos += 3 * w
    m = idx.copy()
    m[np.asarray(dst)] = np.asarray(src)
    _REORDER_CACHE[key] = m
    return m


_REORDER_CACHE: Dict[Tuple[int, int], np.ndarray] = {}


def _alias_reduce(x: np.ndarray, g: _Granule) -> None:
    """Butterflies on subband boundaries (ISO 2.4.3.4.10.1)."""
    if g.block_type == 2 and not g.switch_point:
        return
    n_sb = 1 if (g.block_type == 2 and g.switch_point) else 31
    for sb in range(1, n_sb + 1):
        lo = sb * 18
        a = x[lo - 1 - np.arange(8)]
        b = x[lo + np.arange(8)]
        x[lo - 1 - np.arange(8)] = a * _CS - b * _CA
        x[lo + np.arange(8)] = b * _CS + a * _CA


# --------------------------------------------------------------------------
# IMDCT (batched later; per-granule spectra collected first)

_IMDCT36 = None
_IMDCT12 = None
_WIN_LONG: Dict[int, np.ndarray] = {}


def _imdct_mats():
    global _IMDCT36, _IMDCT12
    if _IMDCT36 is None:
        n = np.arange(36)[None, :]
        k = np.arange(18)[:, None]
        _IMDCT36 = np.cos(np.pi / 72 * (2 * n + 1 + 18) * (2 * k + 1))
        n = np.arange(12)[None, :]
        k = np.arange(6)[:, None]
        _IMDCT12 = np.cos(np.pi / 24 * (2 * n + 1 + 6) * (2 * k + 1))
    return _IMDCT36, _IMDCT12


def _window_long(block_type: int) -> np.ndarray:
    w = _WIN_LONG.get(block_type)
    if w is not None:
        return w
    n = np.arange(36)
    if block_type == 0:
        w = np.sin(np.pi / 36 * (n + 0.5))
    elif block_type == 1:  # start
        w = np.sin(np.pi / 36 * (n + 0.5))
        w[18:24] = 1.0
        w[24:30] = np.sin(np.pi / 12 * (np.arange(24, 30) + 0.5 - 18))
        w[30:] = 0.0
    elif block_type == 3:  # stop
        w = np.sin(np.pi / 36 * (n + 0.5))
        w[:6] = 0.0
        w[6:12] = np.sin(np.pi / 12 * (np.arange(6, 12) + 0.5 - 6))
        w[12:18] = 1.0
    else:
        raise ValueError(block_type)
    _WIN_LONG[block_type] = w
    return w


_WIN_SHORT = np.sin(np.pi / 12 * (np.arange(12) + 0.5))


def _imdct_granule(x: np.ndarray, g: _Granule) -> np.ndarray:
    """[576] spectra -> [32, 36] windowed IMDCT blocks per subband."""
    m36, m12 = _imdct_mats()
    xs = x.reshape(32, 18)
    out = np.zeros((32, 36), np.float64)
    if g.block_type == 2:
        n_long = 2 if g.switch_point else 0
        if n_long:
            out[:n_long] = (xs[:n_long] @ m36) * _window_long(0)
        short = xs[n_long:]  # [sb, 18] with lines interleaved w0,w1,w2
        sub = short.reshape(-1, 6, 3)  # [sb, k, win]
        y = np.einsum("skw,kn->swn", sub, m12) * _WIN_SHORT  # [sb, 3, 12]
        block = np.zeros((short.shape[0], 36), np.float64)
        for win in range(3):
            block[:, 6 + 6 * win : 18 + 6 * win] += y[:, win]
        out[n_long:] = block
    else:
        out[:] = (xs @ m36) * _window_long(g.block_type)
    return out


# --------------------------------------------------------------------------
# Synthesis filterbank (whole-song batched)

_SYNTH_N = None
_SYNTH_D = None


def _synth_consts():
    global _SYNTH_N, _SYNTH_D
    if _SYNTH_N is None:
        i = np.arange(64)[:, None]
        k = np.arange(32)[None, :]
        _SYNTH_N = np.cos((16 + i) * (2 * k + 1) * np.pi / 64.0)
        d = np.zeros(512, np.float64)
        enw = T.ENWINDOW.astype(np.float64) / 65536.0
        for j in range(257):
            v = enw[j]
            d[j] = v
            if j & 63:
                v = -v
            if j:
                d[512 - j] = v
        _SYNTH_D = d
    return _SYNTH_N, _SYNTH_D


def _synthesize(sb_samples: np.ndarray) -> np.ndarray:
    """[T, 32] subband sample vectors -> [T*32] PCM (one channel)."""
    n_mat, d = _synth_consts()
    t_steps = sb_samples.shape[0]
    v = sb_samples @ n_mat.T  # [T, 64]
    out = np.zeros((t_steps, 32), np.float64)
    for m in range(8):
        a = d[64 * m : 64 * m + 32]  # taps on V[t-2m, 0:32]
        b = d[64 * m + 32 : 64 * m + 64]  # taps on V[t-2m-1, 32:64]
        if 2 * m < t_steps:
            out[2 * m :] += v[: t_steps - 2 * m, :32] * a
        if 2 * m + 1 < t_steps:
            out[2 * m + 1 :] += v[: t_steps - 2 * m - 1, 32:] * b
    return out.reshape(-1)


# --------------------------------------------------------------------------
# Tag parsing (ID3v2 / ID3v1) + Xing/LAME gapless info

def _parse_id3v2(data: bytes) -> Tuple[int, Dict[str, str]]:
    if data[:3] != b"ID3" or len(data) < 10:
        return 0, {}
    size = 0
    for b in data[6:10]:
        size = (size << 7) | (b & 0x7F)
    end = 10 + size
    tags: Dict[str, str] = {}
    ver = data[3]
    pos = 10
    if data[5] & 0x40 and ver >= 4:  # extended header
        ehs = int.from_bytes(data[10:14], "big")
        pos += ehs
    keymap = {
        "TIT2": "TITLE", "TPE1": "ARTIST", "TALB": "ALBUM",
        "TPE2": "ALBUMARTIST", "TCON": "GENRE", "TRCK": "TRACKNUMBER",
        "TPOS": "DISCNUMBER",
        "TT2": "TITLE", "TP1": "ARTIST", "TAL": "ALBUM",
        "TP2": "ALBUMARTIST", "TCO": "GENRE", "TRK": "TRACKNUMBER",
        "TPA": "DISCNUMBER",
    }
    while pos + 10 <= min(end, len(data)):
        if ver >= 3:
            fid = data[pos : pos + 4]
            fsz = int.from_bytes(data[pos + 4 : pos + 8], "big")
            if ver >= 4:  # syncsafe
                fsz = (
                    ((fsz >> 24) & 0x7F) << 21
                    | ((fsz >> 16) & 0x7F) << 14
                    | ((fsz >> 8) & 0x7F) << 7
                    | (fsz & 0x7F)
                )
            body = data[pos + 10 : pos + 10 + fsz]
            pos += 10 + fsz
        else:  # ID3v2.2
            fid = data[pos : pos + 3]
            fsz = int.from_bytes(data[pos + 3 : pos + 6], "big")
            body = data[pos + 6 : pos + 6 + fsz]
            pos += 6 + fsz
        if not fid.strip(b"\x00"):
            break
        key = keymap.get(fid.decode("latin-1", "replace"))
        if key and body:
            enc, raw = body[0], body[1:]
            try:
                if enc == 0:
                    txt = raw.decode("latin-1")
                elif enc == 1:
                    txt = raw.decode("utf-16")
                elif enc == 2:
                    txt = raw.decode("utf-16-be")
                else:
                    txt = raw.decode("utf-8")
            except UnicodeDecodeError:
                continue
            txt = txt.strip("\x00").strip()
            if txt:
                tags.setdefault(key, txt)
    return end, tags


def _parse_id3v1(data: bytes) -> Dict[str, str]:
    if len(data) < 128 or data[-128:-125] != b"TAG":
        return {}
    t = data[-128:]

    def s(lo, hi):
        return t[lo:hi].split(b"\x00")[0].decode("latin-1").strip()

    tags = {}
    if s(3, 33):
        tags["TITLE"] = s(3, 33)
    if s(33, 63):
        tags["ARTIST"] = s(33, 63)
    if s(63, 93):
        tags["ALBUM"] = s(63, 93)
    if t[125] == 0 and t[126]:
        tags["TRACKNUMBER"] = str(t[126])
    return tags


def _parse_xing(body: bytes, h: _Header, nch: int) -> Optional[Tuple[int, int]]:
    """Returns (encoder_delay, encoder_padding) if a LAME tag exists, or
    (-1, -1) for a plain Xing/Info frame (still skipped as audio)."""
    # Xing header offset after side info: MPEG1 is 17/32 bytes, LSF 9/17
    side = (17 if nch == 1 else 32) if not h.lsf else (9 if nch == 1 else 17)
    off = 4 + (2 if h.crc else 0) + side
    tag = body[off : off + 4]
    if tag not in (b"Xing", b"Info"):
        return None
    pos = off + 4
    flags = int.from_bytes(body[pos : pos + 4], "big")
    pos += 4
    for bit in (1, 2, 4):  # frames, bytes, toc
        if flags & bit:
            pos += 4 if bit != 4 else 100
    if flags & 8:
        pos += 4  # quality
    lame = body[pos : pos + 4]
    if lame in (b"LAME", b"Lavc", b"Lavf"):
        gap = body[pos + 21 : pos + 24]
        if len(gap) == 3:
            v = int.from_bytes(gap, "big")
            delay = v >> 12
            padding = v & 0xFFF
            return delay, padding
    return -1, -1


# --------------------------------------------------------------------------
# Main decode

def read_mp3(path) -> Tuple[np.ndarray, int, Dict[str, str], int]:
    """Decode an MP3 file.

    Returns `(pcm [n, channels] float32, sample_rate, tags, n)` — the
    same contract as `flac.read_flac`/`vorbis.read_vorbis`.
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
    try:
        return _read_mp3_inner(data, path)
    except _Corrupt as e:
        raise DecodingError(
            f"while decoding mp3 file '{path}': {e or 'corrupt stream'}."
        ) from None


def _read_mp3_inner(data: bytes, path) -> Tuple[np.ndarray, int, Dict[str, str], int]:
    start, tags = _parse_id3v2(data)
    for k, v in _parse_id3v1(data).items():
        tags.setdefault(k, v)

    pos = start
    n = len(data)
    failures = 0
    first = True
    delay_padding: Optional[Tuple[int, int]] = None
    reservoir = b""
    rate = None
    nch = None
    # collected per-granule state for the batched back end
    gran_blocks: List[np.ndarray] = []  # [ch, 32, 36] windowed IMDCTs
    frames = 0

    while pos + 4 <= n:
        h = _parse_header(int.from_bytes(data[pos : pos + 4], "big"))
        if h is None or (rate is not None and h.rate != rate):
            nxt = data.find(b"\xff", pos + 1)
            if nxt < 0:
                break
            pos = nxt
            failures += 1
            if failures > MAX_DECODE_RETRIES and frames == 0:
                raise _Corrupt("no valid mp3 frames found")
            continue
        frame = data[pos : pos + h.frame_bytes]
        if len(frame) < h.frame_bytes:
            break  # truncated final frame
        this_nch = 1 if h.mode == 3 else 2
        if rate is None:
            rate = h.rate
            nch = this_nch
        elif this_nch != nch:
            pos += h.frame_bytes
            continue
        try:
            consumed = _decode_frame(frame, h, nch, reservoir, gran_blocks)
        except _Corrupt:
            failures += 1
            if failures > MAX_DECODE_RETRIES:
                raise
            pos += h.frame_bytes
            continue
        if first:
            xing = _parse_xing(frame, h, nch)
            if xing is not None:
                delay_padding = xing if xing[0] >= 0 else None
                # a Xing/Info frame carries no audio: drop its granules
                del gran_blocks[len(gran_blocks) - h.nb_granules :]
                first = False
                reservoir = b""
                pos += h.frame_bytes
                continue
            first = False
        reservoir = consumed
        frames += 1
        pos += h.frame_bytes

    if rate is None or not gran_blocks:
        raise _Corrupt("no audio frames")

    # ---- batched back end: overlap-add + frequency inversion + synth
    g_arr = np.stack(gran_blocks)  # [G, ch, 32, 36]
    first_half = g_arr[..., :18]
    second_half = g_arr[..., 18:]
    timeb = first_half.copy()
    timeb[1:] += second_half[:-1]
    # frequency inversion: odd subbands, odd sample index
    timeb[:, :, 1::2, 1::2] *= -1.0
    # [G, ch, 32, 18] -> [ch, G*18, 32]
    sb = timeb.transpose(1, 0, 3, 2).reshape(len(gran_blocks[0]), -1, 32)
    chans = [_synthesize(sb[c]) for c in range(sb.shape[0])]
    pcm = np.stack(chans, axis=1)  # [n, ch]

    if delay_padding is not None:
        delay, padding = delay_padding
        start_skip = delay + 528 + 1
        end_skip = max(padding - (528 + 1), 0)
        pcm = pcm[start_skip : pcm.shape[0] - end_skip]
    return (
        np.ascontiguousarray(pcm, np.float32),
        rate,
        tags,
        pcm.shape[0],
    )


def _decode_frame(
    frame: bytes,
    h: _Header,
    nch: int,
    reservoir: bytes,
    gran_blocks: List[np.ndarray],
) -> bytes:
    """Decode one frame's granules into gran_blocks; returns the updated
    bit reservoir (this frame's main data appended)."""
    header_len = 4 + (2 if h.crc else 0)
    bits = _Bits(frame[header_len:])
    main_data_begin, scfsi, granules = _parse_side_info(bits, h, nch)
    side_bytes = bits.pos // 8
    main_data = frame[header_len + side_bytes :]

    if main_data_begin > len(reservoir):
        # not enough reservoir (e.g. first frame after seek): frame lost,
        # but its main data still feeds the reservoir
        new_res = (reservoir + main_data)[-511:]
        for _ in range(h.nb_granules):
            gran_blocks.append(np.zeros((nch, 32, 36), np.float64))
        return new_res
    buf = (
        reservoir[len(reservoir) - main_data_begin :] + main_data
        if main_data_begin
        else main_data
    )
    mbits = _Bits(buf)

    is_stereo = h.mode == 1 and (h.mode_ext & 1)
    ms_stereo = h.mode == 1 and (h.mode_ext & 2)

    for gi in range(h.nb_granules):
        xs = []
        for c in range(nch):
            g = granules[gi][c]
            bit_start = mbits.pos
            if h.lsf:
                _read_scalefactors_lsf(
                    mbits, g, intensity_channel=is_stereo and c == 1
                )
            else:
                _read_scalefactors_mpeg1(
                    mbits, g, scfsi[c],
                    granules[0][c] if gi == 1 else None, gi,
                )
            x = _decode_huffman(mbits, g, bit_start + g.part2_3_length)
            mbits.pos = bit_start + g.part2_3_length
            if mbits.pos > mbits.n:
                raise _Corrupt("main data overrun")
            xs.append(_requantize(x, g, h.rate_index))
        if nch == 2:
            _apply_stereo(
                xs, granules[gi], h, ms_stereo, is_stereo
            )
        out = np.zeros((nch, 32, 36), np.float64)
        for c in range(nch):
            g = granules[gi][c]
            m = _reorder_map(g, h.rate_index)
            x = xs[c][m] if m is not None else xs[c]
            _alias_reduce(x, g)
            out[c] = _imdct_granule(x, g)
        gran_blocks.append(out)

    return (reservoir + main_data)[-511:]


def _apply_stereo(
    xs: List[np.ndarray],
    gs: List[_Granule],
    h: _Header,
    ms: bool,
    intensity: bool,
) -> None:
    """Joint stereo (ISO 2.4.3.4.9): intensity bands project the left
    (mid) value with the is_pos factors; everything else gets M/S
    (l,r) = ((m+s), (m-s))/sqrt(2) when ms_stereo is set."""
    l, r = xs
    is_mask = (
        _intensity_mask_apply(xs, gs, h) if intensity
        else np.zeros(576, bool)
    )
    if ms:
        rest = ~is_mask
        s = math.sqrt(2.0)
        m_v = (l[rest] + r[rest]) / s
        s_v = (l[rest] - r[rest]) / s
        l[rest] = m_v
        r[rest] = s_v


def _is_factors(
    is_pos: int, lsf: bool, sfc: int
) -> Optional[Tuple[float, float]]:
    """(left, right) intensity factors; None = band not intensity-coded
    (illegal is_pos, ISO 2.4.3.4.9.3)."""
    if lsf:
        # 13818-3: io = 2^(-(sfc&1 + 1)/4); odd is_pos scales left,
        # even scales right, by io^((is_pos+1)//2)
        if is_pos == 0:
            return 1.0, 1.0
        f = 2.0 ** (-((sfc & 1) + 1) * ((is_pos + 1) >> 1) / 4.0)
        return (f, 1.0) if (is_pos & 1) else (1.0, f)
    if is_pos == 6:
        return 1.0, 0.0
    if is_pos >= 7:
        return None
    ratio = _IS_TAB[is_pos]
    return ratio / (1.0 + ratio), 1.0 / (1.0 + ratio)


def _intensity_mask_apply(
    xs: List[np.ndarray], gs: List[_Granule], h: _Header
) -> np.ndarray:
    """Apply intensity stereo to the scalefactor bands lying entirely
    above the right channel's last nonzero line; returns the mask of
    intensity-processed positions."""
    l, r = xs
    g = gs[1]
    kind, lw, sw = _band_widths(g, h.rate_index)
    nz = np.nonzero(r)[0]
    bound = int(nz[-1]) + 1 if nz.size else 0
    sf = g.scale_factors
    mask = np.zeros(576, bool)

    segments = []  # (pos, width, sf_index) in decoded line order
    pos = 0
    sfi = 0
    if kind in ("long", "mixed"):
        for w in lw:
            segments.append((pos, w, sfi))
            pos += w
            sfi += 1
    if kind in ("short", "mixed"):
        for w in (sw or ()):
            for _win in range(3):
                segments.append((pos, w, sfi))
                pos += w
                sfi += 1
    for pos, w, sfi in segments:
        if pos < bound or pos >= 576:
            continue
        f = _is_factors(sf[sfi], h.lsf, g.scalefac_compress)
        if f is None:
            continue
        seg = l[pos : pos + w].copy()
        l[pos : pos + w] = seg * f[0]
        r[pos : pos + w] = seg * f[1]
        mask[pos : pos + w] = True
    return mask
