"""Pure-Python Ogg Vorbis decoder for the FFI-free fallback decode stack.

The reference ships Symphonia as its FFI-free alternative to FFmpeg
(bliss-rs src/song/decoder/symphonia.rs:90-403); OGG Vorbis is one of
the four formats its test/tolerance matrix covers (symphonia.rs:701-750).
This is a clean-room decoder of the Vorbis I bitstream
(https://xiph.org/vorbis/doc/Vorbis_I_spec.html) on top of a minimal Ogg
page layer (RFC 3533), built on numpy:

  * all Huffman codebooks are transmitted in the stream's setup header
    (Vorbis carries its entropy model in-band), decoded here through a
    10-bit primary lookup table with a dict fallback for longer codes;
  * floor1 curves render with closed-form integer line equations
    (vectorized) instead of per-sample Bresenham;
  * the IMDCT runs as one batched matmul per block size over all packets
    at once; windowing/overlap-add are numpy slice ops.

Error handling mirrors the reference's decode-retry semantics
(symphonia.rs:86 MAX_DECODE_RETRIES = 3): a corrupt page (bad CRC) or
malformed packet resynchronizes to the next page, up to 3 failures; an
end-of-packet condition inside an audio packet is not an error (Vorbis I
spec 1.3.2) — the partial data decoded so far is used.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import DecodingError

MAX_DECODE_RETRIES = 3  # symphonia.rs:86

# --------------------------------------------------------------------------
# Vorbis I spec 10.1: floor1_inverse_dB_table — the 256-entry map from
# integer floor amplitude to linear scale (~140 dB of range).
_INVERSE_DB_TABLE = np.array([
    1.0649863e-07, 1.1341951e-07, 1.2079015e-07, 1.2863978e-07,
    1.369995e-07, 1.459025e-07, 1.5538409e-07, 1.6548181e-07,
    1.7623574e-07, 1.8768856e-07, 1.998856e-07, 2.128753e-07,
    2.2670913e-07, 2.4144197e-07, 2.5713223e-07, 2.7384212e-07,
    2.9163792e-07, 3.1059022e-07, 3.307741e-07, 3.5226967e-07,
    3.7516213e-07, 3.995423e-07, 4.255068e-07, 4.5315863e-07,
    4.8260745e-07, 5.1397e-07, 5.4737063e-07, 5.829419e-07, 6.208247e-07,
    6.611694e-07, 7.041359e-07, 7.4989464e-07, 7.98627e-07, 8.505263e-07,
    9.057983e-07, 9.646621e-07, 1.0273513e-06, 1.0941144e-06,
    1.1652161e-06, 1.2409384e-06, 1.3215816e-06, 1.4074654e-06,
    1.4989305e-06, 1.5963394e-06, 1.7000785e-06, 1.8105592e-06,
    1.9282195e-06, 2.053526e-06, 2.1869757e-06, 2.3290977e-06,
    2.4804558e-06, 2.6416496e-06, 2.813319e-06, 2.9961443e-06,
    3.1908505e-06, 3.39821e-06, 3.619045e-06, 3.8542307e-06, 4.1047006e-06,
    4.371447e-06, 4.6555283e-06, 4.958071e-06, 5.280274e-06, 5.623416e-06,
    5.988857e-06, 6.3780467e-06, 6.7925284e-06, 7.2339453e-06,
    7.704048e-06, 8.2047e-06, 8.737888e-06, 9.305725e-06, 9.910464e-06,
    1.0554501e-05, 1.1240392e-05, 1.1970856e-05, 1.2748789e-05,
    1.3577278e-05, 1.4459606e-05, 1.5399271e-05, 1.6400005e-05,
    1.7465769e-05, 1.8600793e-05, 1.9809577e-05, 2.1096914e-05,
    2.2467912e-05, 2.3928002e-05, 2.5482977e-05, 2.7139005e-05,
    2.890265e-05, 3.078091e-05, 3.2781227e-05, 3.4911533e-05, 3.718028e-05,
    3.9596467e-05, 4.2169668e-05, 4.491009e-05, 4.7828602e-05,
    5.0936775e-05, 5.424693e-05, 5.7772202e-05, 6.152657e-05, 6.552491e-05,
    6.9783084e-05, 7.4317984e-05, 7.914758e-05, 8.429104e-05, 8.976875e-05,
    9.560242e-05, 1.0181521e-04, 1.0843174e-04, 1.1547824e-04,
    1.2298267e-04, 1.3097477e-04, 1.3948625e-04, 1.4855085e-04,
    1.5820454e-04, 1.6848555e-04, 1.7943469e-04, 1.9109536e-04,
    2.0351382e-04, 2.167393e-04, 2.3082423e-04, 2.4582449e-04,
    2.6179955e-04, 2.7881275e-04, 2.9693157e-04, 3.1622787e-04,
    3.3677815e-04, 3.5866388e-04, 3.8197188e-04, 4.0679457e-04,
    4.3323037e-04, 4.613841e-04, 4.913675e-04, 5.2329927e-04, 5.573062e-04,
    5.935231e-04, 6.320936e-04, 6.731706e-04, 7.16917e-04, 7.635063e-04,
    8.1312325e-04, 8.6596457e-04, 9.2223985e-04, 9.821722e-04,
    0.0010459992, 0.0011139743, 0.0011863665, 0.0012634633, 0.0013455702,
    0.0014330129, 0.0015261382, 0.0016253153, 0.0017309374, 0.0018434235,
    0.0019632196, 0.0020908006, 0.0022266726, 0.0023713743, 0.0025254795,
    0.0026895993, 0.0028643848, 0.0030505287, 0.003248769, 0.0034598925,
    0.0036847359, 0.0039241905, 0.0041792067, 0.004450795, 0.004740033,
    0.005048067, 0.0053761187, 0.005725489, 0.0060975635, 0.0064938175,
    0.0069158226, 0.0073652514, 0.007843887, 0.008353627, 0.008896492,
    0.009474637, 0.010090352, 0.01074608, 0.011444421, 0.012188144,
    0.012980198, 0.013823725, 0.014722068, 0.015678791, 0.016697686,
    0.017782796, 0.018938422, 0.020169148, 0.021479854, 0.022875736,
    0.02436233, 0.025945531, 0.027631618, 0.029427277, 0.031339627,
    0.03337625, 0.035545226, 0.037855156, 0.0403152, 0.042935107,
    0.045725275, 0.048696756, 0.05186135, 0.05523159, 0.05882085,
    0.062643364, 0.06671428, 0.07104975, 0.075666964, 0.08058423,
    0.08582105, 0.09139818, 0.097337745, 0.1036633, 0.11039993, 0.11757434,
    0.12521498, 0.13335215, 0.14201812, 0.15124726, 0.16107617, 0.1715438,
    0.18269168, 0.19456401, 0.20720787, 0.22067343, 0.23501402, 0.25028655,
    0.26655158, 0.28387362, 0.3023213, 0.32196787, 0.34289113, 0.36517414,
    0.3889052, 0.41417846, 0.44109413, 0.4697589, 0.50028646, 0.53279793,
    0.5674221, 0.6042964, 0.64356697, 0.6853896, 0.72993004, 0.777365,
    0.8278826, 0.88168305, 0.9389798, 1.0,
], dtype=np.float32)

_FLOOR1_RANGES = (256, 128, 86, 64)  # by multiplier-1 (spec 7.2.3)


class _Corrupt(Exception):
    """A malformed page/packet — resync and retry (internal)."""


class _EOP(Exception):
    """End-of-packet while reading — not an error in audio packets
    (Vorbis I spec 1.3.2: partial decoded data is used)."""


def _ilog(x: int) -> int:
    """Vorbis ilog: highest set bit position, ilog(0) = 0 (spec 9.2.1)."""
    return x.bit_length() if x > 0 else 0


def _float32_unpack(x: int) -> float:
    """Vorbis 'packed float' for VQ lookup params (spec 9.2.2)."""
    mant = x & 0x1FFFFF
    exp = (x & 0x7FE00000) >> 21
    if x & 0x80000000:
        mant = -mant
    return float(mant) * 2.0 ** (exp - 788)


class _Bits:
    """LSB-first bit reader over one packet (Vorbis I spec 2.1)."""

    __slots__ = ("val", "n", "pos")

    def __init__(self, data: bytes):
        self.val = int.from_bytes(data, "little")
        self.n = len(data) * 8
        self.pos = 0

    def read(self, k: int) -> int:
        pos = self.pos
        if pos + k > self.n:
            self.pos = self.n
            raise _EOP
        self.pos = pos + k
        return (self.val >> pos) & ((1 << k) - 1)

    def flag(self) -> int:
        return self.read(1)


def _bit_reverse32(x: int) -> int:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x & 0xFFFF) << 16) | (x >> 16)


# --------------------------------------------------------------------------
# Ogg page layer (RFC 3533)

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if (c & 0x80000000) else (c << 1)
            c &= 0xFFFFFFFF
        table.append(c)
    return table


_OGG_CRC = _crc_table()


def _ogg_crc(data: bytes) -> int:
    crc = 0
    t = _OGG_CRC
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ t[(crc >> 24) ^ b]
    return crc


def ogg_packets(data: bytes):
    """Yield `(packet_bytes, granule)` for the first logical stream.

    `granule` is the page's absolute granule position if this packet is
    the last one completed on its page, else None. Corrupt pages (bad
    CRC / truncated) raise _Corrupt after resyncing costs exceed
    MAX_DECODE_RETRIES.
    """
    pos = 0
    serial = None
    pending = b""
    failures = 0
    n = len(data)
    while pos < n:
        sync = data.find(b"OggS", pos)
        if sync < 0:
            break
        if sync != pos:
            failures += 1
            if failures > MAX_DECODE_RETRIES:
                raise _Corrupt("too many corrupt Ogg pages")
        pos = sync
        if pos + 27 > n:
            break
        header = data[pos : pos + 27]
        htype = header[5]
        granule = int.from_bytes(header[6:14], "little", signed=True)
        page_serial = int.from_bytes(header[14:18], "little")
        nsegs = header[26]
        lacing = data[pos + 27 : pos + 27 + nsegs]
        if len(lacing) < nsegs:
            break
        body_start = pos + 27 + nsegs
        body_len = sum(lacing)
        if body_start + body_len > n:
            # truncated final page: tolerate, like the reference's
            # premature-EOF handling (ffmpeg.rs:290-298)
            body_len = n - body_start
        page = data[pos : body_start + body_len]
        crc_stored = int.from_bytes(header[22:26], "little")
        zeroed = page[:22] + b"\x00\x00\x00\x00" + page[26:]
        if _ogg_crc(zeroed) != crc_stored:
            failures += 1
            if failures > MAX_DECODE_RETRIES:
                raise _Corrupt("too many corrupt Ogg pages")
            pos = sync + 4  # resync past this sync word
            continue
        pos = body_start + body_len

        if serial is None:
            if not (htype & 0x02):
                continue  # not a BOS page; keep looking
            serial = page_serial
        elif page_serial != serial:
            continue  # another multiplexed stream

        if not (htype & 0x01):
            pending = b""  # fresh page must not continue: drop remnant
        off = body_start
        completed = []
        for lace in lacing:
            pending += data[off : off + lace]
            off += lace
            if lace < 255:
                completed.append(pending)
                pending = b""
        for i, pkt in enumerate(completed):
            g = granule if (i == len(completed) - 1 and granule >= 0) else None
            yield pkt, g
        if htype & 0x04:
            return  # end of the logical stream


# --------------------------------------------------------------------------
# Codebooks (Vorbis I spec 3)

class _Codebook:
    __slots__ = (
        "dim", "entries", "prim", "long", "maxlen", "vectors", "pbits",
    )

    def __init__(self, bits: _Bits):
        if bits.read(24) != 0x564342:  # 'BCV'
            raise _Corrupt("bad codebook sync")
        self.dim = bits.read(16)
        self.entries = bits.read(24)
        lengths = [0] * self.entries
        if bits.flag():  # ordered
            cur_entry = 0
            cur_len = bits.read(5) + 1
            while cur_entry < self.entries:
                num = bits.read(_ilog(self.entries - cur_entry))
                if cur_entry + num > self.entries:
                    raise _Corrupt("ordered codebook overflow")
                for e in range(cur_entry, cur_entry + num):
                    lengths[e] = cur_len
                cur_entry += num
                cur_len += 1
        else:
            sparse = bits.flag()
            for e in range(self.entries):
                if sparse:
                    if bits.flag():
                        lengths[e] = bits.read(5) + 1
                else:
                    lengths[e] = bits.read(5) + 1

        self._assign_codewords(lengths)
        self._parse_lookup(bits)

    def _assign_codewords(self, lengths: List[int]) -> None:
        """Vorbis codeword assignment: each used entry takes the
        lexicographically-first available leaf of its length (spec 3.2.1).
        Codes are stored in *stream bit order* (first bit read = LSB)."""
        maxlen = max(lengths) if lengths else 0
        self.maxlen = maxlen
        pbits = min(maxlen, 10) if maxlen else 0
        self.pbits = pbits
        prim: List[Tuple[int, int]] = [(-1, 0)] * (1 << pbits)
        longc: Dict[Tuple[int, int], int] = {}
        avail = [0] * 33
        first = True
        for e, l in enumerate(lengths):
            if l == 0:
                continue
            if first:
                code = 0
                for j in range(1, l + 1):
                    avail[j] = 1 << (32 - j)
                first = False
            else:
                z = l
                while z > 0 and not avail[z]:
                    z -= 1
                if z == 0:
                    raise _Corrupt("over-specified codebook")
                code = avail[z]
                avail[z] = 0
                for j in range(z + 1, l + 1):
                    avail[j] = code | (1 << (32 - j))
            # the codeword lives in the top l bits of `code`; a full
            # 32-bit reversal moves it (reversed = stream bit order)
            # into the bottom l bits, with zeros above
            sc = _bit_reverse32(code)
            if l <= pbits:
                step = 1 << l
                for k in range(sc, 1 << pbits, step):
                    prim[k] = (e, l)
            else:
                longc[(l, sc)] = e
        self.prim = prim
        self.long = longc

    def _parse_lookup(self, bits: _Bits) -> None:
        lt = bits.read(4)
        if lt == 0:
            self.vectors = None
            return
        if lt not in (1, 2):
            raise _Corrupt(f"bad lookup type {lt}")
        minimum = _float32_unpack(bits.read(32))
        delta = _float32_unpack(bits.read(32))
        value_bits = bits.read(4) + 1
        sequence_p = bits.flag()
        if lt == 1:
            if self.dim <= 0:
                # (lv+1)**0 == 1 <= entries forever: a dim-0 lookup-1
                # codebook is malformed, not an infinite loop
                raise _Corrupt("lookup type 1 with zero dimensions")
            lv = 0
            while (lv + 1) ** self.dim <= self.entries:
                lv += 1
        else:
            lv = self.entries * self.dim
        mult = np.array(
            [bits.read(value_bits) for _ in range(lv)], dtype=np.float64
        )
        ent = np.arange(self.entries, dtype=np.int64)
        if lt == 1:
            idx = np.empty((self.entries, self.dim), np.int64)
            div = 1
            for j in range(self.dim):
                idx[:, j] = (ent // div) % lv
                div *= lv
        else:
            idx = ent[:, None] * self.dim + np.arange(self.dim)[None, :]
        vals = mult[idx] * delta + minimum
        if sequence_p:
            vals = np.cumsum(vals, axis=1)
        self.vectors = vals.astype(np.float32)

    def scalar(self, bits: _Bits) -> int:
        """Decode one codeword to its entry number."""
        pos = bits.pos
        v = (bits.val >> pos) & ((1 << self.pbits) - 1)
        e, l = self.prim[v]
        if e < 0:
            big = bits.val
            for l in range(self.pbits + 1, self.maxlen + 1):
                key = (l, (big >> pos) & ((1 << l) - 1))
                e = self.long.get(key, -1)
                if e >= 0:
                    break
            else:
                if pos >= bits.n:
                    raise _EOP
                raise _Corrupt("invalid codeword")
        if pos + l > bits.n:
            bits.pos = bits.n
            raise _EOP
        bits.pos = pos + l
        return e


# --------------------------------------------------------------------------
# Floor (Vorbis I spec 7; floor1 only — floor0 is a legacy LSP floor no
# mainstream encoder emits)

class _Floor1:
    __slots__ = (
        "partition_classes", "class_dims", "class_subclasses",
        "class_masterbooks", "subclass_books", "multiplier", "rangebits",
        "xs", "sort_order", "low_nb", "high_nb", "rng",
    )

    def __init__(self, bits: _Bits):
        n_part = bits.read(5)
        self.partition_classes = [bits.read(4) for _ in range(n_part)]
        n_classes = max(self.partition_classes) + 1 if n_part else 0
        self.class_dims = []
        self.class_subclasses = []
        self.class_masterbooks = []
        self.subclass_books = []
        for _ in range(n_classes):
            dim = bits.read(3) + 1
            sub = bits.read(2)
            self.class_dims.append(dim)
            self.class_subclasses.append(sub)
            self.class_masterbooks.append(bits.read(8) if sub else -1)
            self.subclass_books.append(
                [bits.read(8) - 1 for _ in range(1 << sub)]
            )
        self.multiplier = bits.read(2) + 1
        self.rangebits = bits.read(4)
        xs = [0, 1 << self.rangebits]
        for pc in self.partition_classes:
            for _ in range(self.class_dims[pc]):
                xs.append(bits.read(self.rangebits))
        self.xs = xs
        self.rng = _FLOOR1_RANGES[self.multiplier - 1]
        # static per-config: posting-order neighbors + render sort order
        n_posts = len(xs)
        self.sort_order = sorted(range(n_posts), key=lambda i: xs[i])
        low_nb, high_nb = [0, 0], [0, 0]
        for i in range(2, n_posts):
            low, high = 0, 1
            for j in range(i):
                if xs[low] < xs[j] < xs[i]:
                    low = j
                if xs[i] < xs[j] < xs[high]:
                    high = j
            low_nb.append(low)
            high_nb.append(high)
        self.low_nb, self.high_nb = low_nb, high_nb

    def decode(self, bits: _Bits, books: List[_Codebook]) -> Optional[List[int]]:
        """Read one channel's floor posts; None = unvoiced (spec 7.2.3)."""
        if not bits.flag():
            return None
        rng = self.rng
        ybits = _ilog(rng - 1)
        ys = [bits.read(ybits), bits.read(ybits)]
        for pc in self.partition_classes:
            cdim = self.class_dims[pc]
            cbits = self.class_subclasses[pc]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = books[self.class_masterbooks[pc]].scalar(bits)
            for _ in range(cdim):
                book_idx = self.subclass_books[pc][cval & csub]
                cval >>= cbits
                if book_idx >= 0:
                    ys.append(books[book_idx].scalar(bits))
                else:
                    ys.append(0)
        return ys

    def curve(self, ys: List[int], n2: int) -> np.ndarray:
        """Amplitude synthesis + curve render → linear floor [n2]
        (spec 7.2.4)."""
        xs = self.xs
        rng = self.rng
        n_posts = len(xs)
        final = [0] * n_posts
        step2 = [False] * n_posts
        final[0], final[1] = ys[0], ys[1]
        step2[0] = step2[1] = True
        for i in range(2, n_posts):
            low, high = self.low_nb[i], self.high_nb[i]
            pred = _render_point(
                xs[low], final[low], xs[high], final[high], xs[i]
            )
            val = ys[i] if i < len(ys) else 0
            if val:
                highroom = rng - pred
                lowroom = pred
                room = 2 * min(highroom, lowroom)
                if val >= room:
                    if highroom > lowroom:
                        final[i] = val - lowroom + pred
                    else:
                        final[i] = pred - (val - highroom) - 1
                elif val & 1:
                    final[i] = pred - ((val + 1) >> 1)
                else:
                    final[i] = pred + (val >> 1)
                step2[i] = True
                step2[low] = True
                step2[high] = True
            else:
                final[i] = pred
                step2[i] = False

        curve = np.zeros(n2, np.int32)
        mult = self.multiplier
        order = self.sort_order
        lx, ly = 0, min(max(final[order[0]], 0), rng - 1) * mult
        for i in order[1:]:
            if not step2[i]:
                continue
            hx = xs[i]
            hy = min(max(final[i], 0), rng - 1) * mult
            if hx > lx:
                _render_line(lx, ly, hx, hy, curve, n2)
            if hx >= n2:
                lx, ly = hx, hy
                break
            lx, ly = hx, hy
        if lx < n2:
            curve[lx:n2] = min(ly, 255)
        return _INVERSE_DB_TABLE[np.minimum(curve, 255)]


def _render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx if adx else 0
    return y0 - off if dy < 0 else y0 + off


def _render_line(
    x0: int, y0: int, x1: int, y1: int, v: np.ndarray, n2: int
) -> None:
    """Closed-form integer line render over [x0, min(x1, n2))
    (equivalent to the spec's Bresenham accumulation, vectorized)."""
    hi = min(x1, n2)
    if x0 >= hi:
        return
    dy = y1 - y0
    adx = x1 - x0
    i = np.arange(hi - x0, dtype=np.int64)
    if dy >= 0:
        y = y0 + (i * dy) // adx
    else:
        y = y0 - (i * (-dy)) // adx
    v[x0:hi] = np.clip(y, 0, 255)


# --------------------------------------------------------------------------
# Residue (Vorbis I spec 8)

class _Residue:
    __slots__ = (
        "rtype", "begin", "end", "psize", "nclass", "classbook", "books",
    )

    def __init__(self, rtype: int, bits: _Bits, codebooks: List[_Codebook]):
        if rtype not in (0, 1, 2):
            raise _Corrupt(f"bad residue type {rtype}")
        self.rtype = rtype
        self.begin = bits.read(24)
        self.end = bits.read(24)
        self.psize = bits.read(24) + 1
        self.nclass = bits.read(6) + 1
        self.classbook = bits.read(8)
        cascades = []
        for _ in range(self.nclass):
            low = bits.read(3)
            high = bits.read(5) if bits.flag() else 0
            cascades.append((high << 3) | low)
        self.books: List[List[int]] = []
        for c in range(self.nclass):
            row = []
            for p in range(8):
                row.append(bits.read(8) if cascades[c] & (1 << p) else -1)
            self.books.append(row)
        if self.classbook >= len(codebooks):
            raise _Corrupt("residue classbook out of range")

    def decode(
        self,
        bits: _Bits,
        codebooks: List[_Codebook],
        do_not_decode: List[bool],
        n2: int,
    ) -> np.ndarray:
        nch = len(do_not_decode)
        if self.rtype == 2:
            out = np.zeros((1, n2 * nch), np.float32)
            if not all(do_not_decode):
                self._decode_core(bits, codebooks, out, [False], n2 * nch)
            return out.reshape(n2, nch).T.copy()
        out = np.zeros((nch, n2), np.float32)
        self._decode_core(bits, codebooks, out, do_not_decode, n2)
        return out

    def _decode_core(
        self,
        bits: _Bits,
        codebooks: List[_Codebook],
        out: np.ndarray,
        dnd: List[bool],
        n: int,
    ) -> None:
        begin = min(self.begin, n)
        end = min(self.end, n)
        if end <= begin:
            return
        psize = self.psize
        ptr = (end - begin) // psize
        if ptr == 0:
            return
        classbook = codebooks[self.classbook]
        cdim = classbook.dim
        nclass = self.nclass
        chans = [j for j in range(len(dnd)) if not dnd[j]]
        cls = np.zeros((len(dnd), ptr + cdim), np.int32)
        interleaved = self.rtype == 0
        for pass_ in range(8):
            pc = 0
            while pc < ptr:
                if pass_ == 0:
                    for j in chans:
                        temp = classbook.scalar(bits)
                        for i in range(cdim - 1, -1, -1):
                            if pc + i < ptr:
                                cls[j][pc + i] = temp % nclass
                            temp //= nclass
                for _ in range(cdim):
                    if pc >= ptr:
                        break
                    for j in chans:
                        bidx = self.books[cls[j][pc]][pass_]
                        if bidx >= 0:
                            _vq_partition(
                                bits, codebooks[bidx], out[j],
                                begin + pc * psize, psize, interleaved,
                            )
                    pc += 1


def _vq_partition(
    bits: _Bits,
    book: _Codebook,
    v: np.ndarray,
    off: int,
    psize: int,
    interleaved: bool,
) -> None:
    dim = book.dim
    vectors = book.vectors
    if vectors is None:
        raise _Corrupt("residue value book has no VQ lookup")
    reads = psize // dim
    entries = np.empty(reads, np.int64)
    scalar = book.scalar
    for r in range(reads):
        entries[r] = scalar(bits)
    rows = vectors[entries]  # [reads, dim]
    if interleaved:
        v[off : off + reads * dim] += rows.T.ravel()
    else:
        v[off : off + reads * dim] += rows.ravel()


# --------------------------------------------------------------------------
# Mapping / mode (Vorbis I spec 4.2.4)

class _Mapping:
    __slots__ = ("submaps", "coupling", "mux", "submap_floor", "submap_residue")

    def __init__(self, bits: _Bits, channels: int, n_floors: int, n_res: int):
        self.submaps = bits.read(4) + 1 if bits.flag() else 1
        self.coupling: List[Tuple[int, int]] = []
        if bits.flag():
            steps = bits.read(8) + 1
            cb = _ilog(channels - 1)
            for _ in range(steps):
                m = bits.read(cb)
                a = bits.read(cb)
                if m == a or m >= channels or a >= channels:
                    raise _Corrupt("bad coupling step")
                self.coupling.append((m, a))
        if bits.read(2):
            raise _Corrupt("mapping reserved bits set")
        if self.submaps > 1:
            self.mux = [bits.read(4) for _ in range(channels)]
            if max(self.mux) >= self.submaps:
                raise _Corrupt("mux out of range")
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            bits.read(8)  # unused time config
            f = bits.read(8)
            r = bits.read(8)
            if f >= n_floors or r >= n_res:
                raise _Corrupt("submap index out of range")
            self.submap_floor.append(f)
            self.submap_residue.append(r)


# --------------------------------------------------------------------------
# Window + IMDCT

_WINDOW_CACHE: Dict[Tuple[int, int, int, int], np.ndarray] = {}
_IMDCT_CACHE: Dict[int, np.ndarray] = {}


def _vorbis_slope(n: int) -> np.ndarray:
    x = (np.arange(n, dtype=np.float64) + 0.5) / n * (np.pi / 2.0)
    return np.sin(np.pi / 2.0 * np.sin(x) ** 2)


def _window(n: int, bs0: int, prev_flag: int, next_flag: int) -> np.ndarray:
    """Synthesis window for a block of size n (spec 4.3.1): slopes shrink
    to the short size on a boundary with a short block."""
    key = (n, bs0, prev_flag, next_flag)
    w = _WINDOW_CACHE.get(key)
    if w is not None:
        return w
    w = np.zeros(n, np.float64)
    if prev_flag:
        ls, ln = 0, n // 2
    else:
        ls, ln = n // 4 - bs0 // 4, bs0 // 2
    if next_flag:
        rs, rn = n // 2, n // 2
    else:
        rs, rn = 3 * n // 4 - bs0 // 4, bs0 // 2
    w[ls : ls + ln] = _vorbis_slope(ln)
    w[ls + ln : rs] = 1.0
    w[rs : rs + rn] = _vorbis_slope(rn)[::-1]
    w = w.astype(np.float32)
    _WINDOW_CACHE[key] = w
    return w


def _imdct_matrix(n: int) -> np.ndarray:
    """[n/2, n] IMDCT basis: y[t] = sum_k X[k] cos(pi/2n (2t+1+n/2)(2k+1))
    (spec 1.3.2)."""
    m = _IMDCT_CACHE.get(n)
    if m is None:
        t = np.arange(n, dtype=np.float64)[None, :]
        k = np.arange(n // 2, dtype=np.float64)[:, None]
        m = np.cos(np.pi / (2 * n) * (2 * t + 1 + n / 2) * (2 * k + 1))
        m = m.astype(np.float32)
        _IMDCT_CACHE[n] = m
    return m


# --------------------------------------------------------------------------
# Setup / headers

class _Setup:
    __slots__ = (
        "channels", "rate", "bs", "codebooks", "floors", "residues",
        "mappings", "modes", "tags", "vendor",
    )


def _parse_id_header(pkt: bytes) -> Tuple[int, int, Tuple[int, int]]:
    if len(pkt) < 30 or pkt[0] != 1 or pkt[1:7] != b"vorbis":
        raise _Corrupt("bad identification header")
    bits = _Bits(pkt[7:])
    if bits.read(32) != 0:
        raise _Corrupt("unsupported vorbis version")
    channels = bits.read(8)
    rate = bits.read(32)
    bits.read(32)  # bitrate max
    bits.read(32)  # bitrate nominal
    bits.read(32)  # bitrate min
    bs0 = 1 << bits.read(4)
    bs1 = 1 << bits.read(4)
    if channels == 0 or rate == 0 or bs0 > bs1 or not bits.flag():
        raise _Corrupt("bad identification header fields")
    return channels, rate, (bs0, bs1)


def _parse_comments(pkt: bytes) -> Tuple[str, Dict[str, str]]:
    if len(pkt) < 7 or pkt[0] != 3 or pkt[1:7] != b"vorbis":
        raise _Corrupt("bad comment header")
    pos = 7
    vlen = int.from_bytes(pkt[pos : pos + 4], "little")
    pos += 4
    vendor = pkt[pos : pos + vlen].decode("utf-8", "replace")
    pos += vlen
    count = int.from_bytes(pkt[pos : pos + 4], "little")
    pos += 4
    tags: Dict[str, str] = {}
    for _ in range(count):
        if pos + 4 > len(pkt):
            break
        clen = int.from_bytes(pkt[pos : pos + 4], "little")
        pos += 4
        raw = pkt[pos : pos + clen].decode("utf-8", "replace")
        pos += clen
        if "=" in raw:
            k, v = raw.split("=", 1)
            tags[k.upper()] = v
    return vendor, tags


def _parse_setup(pkt: bytes, channels: int) -> Tuple[list, list, list, list, list]:
    if len(pkt) < 7 or pkt[0] != 5 or pkt[1:7] != b"vorbis":
        raise _Corrupt("bad setup header")
    bits = _Bits(pkt[7:])
    codebooks = [_Codebook(bits) for _ in range(bits.read(8) + 1)]
    for _ in range(bits.read(6) + 1):  # time transforms (placeholder)
        if bits.read(16) != 0:
            raise _Corrupt("bad time transform")
    floors = []
    for _ in range(bits.read(6) + 1):
        ftype = bits.read(16)
        if ftype == 1:
            floors.append(_Floor1(bits))
        elif ftype == 0:
            raise _Corrupt("floor0 (legacy LSP floor) is not supported")
        else:
            raise _Corrupt(f"bad floor type {ftype}")
    residues = []
    for _ in range(bits.read(6) + 1):
        rtype = bits.read(16)
        residues.append(_Residue(rtype, bits, codebooks))
    mappings = []
    for _ in range(bits.read(6) + 1):
        if bits.read(16) != 0:
            raise _Corrupt("bad mapping type")
        mappings.append(
            _Mapping(bits, channels, len(floors), len(residues))
        )
    modes = []
    for _ in range(bits.read(6) + 1):
        blockflag = bits.flag()
        if bits.read(16) != 0 or bits.read(16) != 0:
            raise _Corrupt("bad mode window/transform type")
        mapping = bits.read(8)
        if mapping >= len(mappings):
            raise _Corrupt("mode mapping out of range")
        modes.append((blockflag, mapping))
    if not bits.flag():
        raise _Corrupt("setup framing bit unset")
    return codebooks, floors, residues, mappings, modes


# --------------------------------------------------------------------------
# Audio packet decode

def _decode_packet_spectra(
    pkt: bytes, setup: _Setup
) -> Optional[Tuple[int, int, int, List[Optional[np.ndarray]]]]:
    """One audio packet → (n, prev_flag, next_flag, per-channel spectrum
    [n/2] or None-if-silent). Returns None for non-audio packets."""
    bits = _Bits(pkt)
    try:
        if bits.flag():
            return None  # not an audio packet
        mode_idx = bits.read(_ilog(len(setup.modes) - 1))
    except _EOP:
        return None
    try:
        blockflag, mapping_idx = setup.modes[mode_idx]
        mapping = setup.mappings[mapping_idx]
    except IndexError:
        # mode fields are ilog-width, so out-of-range values are
        # representable (and bit flips happen): corrupt packet, not a crash
        raise _Corrupt("packet referenced out-of-range mode")
    n = setup.bs[1] if blockflag else setup.bs[0]
    n2 = n // 2
    prev_flag = next_flag = 1
    ch = setup.channels
    residue_out = np.zeros((ch, n2), np.float32)
    # defined before the try: an _EOP on the window flags must leave the
    # channels silent (spec 1.3.2 partial data), not hit a NameError below
    posts: List[Optional[np.ndarray]] = [None] * ch
    try:
        if blockflag:
            prev_flag = bits.flag()
            next_flag = bits.flag()
        # floor decode per channel
        for c in range(ch):
            floor = setup.floors[mapping.submap_floor[mapping.mux[c]]]
            posts[c] = floor.decode(bits, setup.codebooks)
        no_residue = [posts[c] is None for c in range(ch)]
        # a coupled pair decodes residue if either side is voiced
        # (spec 4.3.4)
        for m, a in mapping.coupling:
            if not (no_residue[m] and no_residue[a]):
                no_residue[m] = no_residue[a] = False
        for submap in range(mapping.submaps):
            sub_ch = [c for c in range(ch) if mapping.mux[c] == submap]
            if not sub_ch:
                continue
            residue = setup.residues[mapping.submap_residue[submap]]
            dnd = [no_residue[c] for c in sub_ch]
            dec = residue.decode(bits, setup.codebooks, dnd, n2)
            for i, c in enumerate(sub_ch):
                residue_out[c] = dec[i]
    except _EOP:
        pass  # partial data is used (spec 1.3.2)
    except IndexError:
        raise _Corrupt("packet referenced out-of-range configuration")

    # inverse coupling (spec 4.3.5), in reverse order
    for m, a in reversed(mapping.coupling):
        mag = residue_out[m]
        ang = residue_out[a]
        new_m = np.where(
            mag > 0,
            np.where(ang > 0, mag, mag + ang),
            np.where(ang > 0, mag, mag - ang),
        )
        new_a = np.where(
            mag > 0,
            np.where(ang > 0, mag - ang, mag),
            np.where(ang > 0, mag + ang, mag),
        )
        residue_out[m] = new_m
        residue_out[a] = new_a

    spectra: List[Optional[np.ndarray]] = [None] * ch
    for c in range(ch):
        if posts[c] is None:
            continue
        floor = setup.floors[mapping.submap_floor[mapping.mux[c]]]
        try:
            curve = floor.curve(posts[c], n2)
        except (ZeroDivisionError, IndexError):
            raise _Corrupt("floor curve synthesis failed")
        spectra[c] = residue_out[c] * curve
    return n, prev_flag, next_flag, spectra


def read_vorbis(
    path,
) -> Tuple[np.ndarray, int, Dict[str, str], int]:
    """Decode an Ogg Vorbis file.

    Returns `(pcm [n, channels] float32, sample_rate, tags, n)` —
    the same contract as `flac.read_flac` (amplitude already in
    [-1, 1], no bit-depth scaling needed).
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
        return _read_vorbis_inner(data, path)
    except (_Corrupt, _EOP) as e:
        raise DecodingError(
            f"while decoding vorbis file '{path}': {e or 'corrupt stream'}."
        ) from None


def _read_vorbis_inner(data: bytes, path) -> Tuple[np.ndarray, int, Dict[str, str], int]:
    packets = ogg_packets(data)
    try:
        id_pkt, _ = next(packets)
        channels, rate, bs = _parse_id_header(id_pkt)
        cmt_pkt, _ = next(packets)
        _, tags = _parse_comments(cmt_pkt)
        setup_pkt, _ = next(packets)
        codebooks, floors, residues, mappings, modes = _parse_setup(
            setup_pkt, channels
        )
    except StopIteration:
        raise _Corrupt("missing vorbis headers") from None

    setup = _Setup()
    setup.channels = channels
    setup.rate = rate
    setup.bs = bs
    setup.codebooks = codebooks
    setup.floors = floors
    setup.residues = residues
    setup.mappings = mappings
    setup.modes = modes
    setup.tags = tags

    # Phase 1 (bit-serial): packets → spectra + window metadata
    blocks: List[Tuple[int, int, int, List[Optional[np.ndarray]]]] = []
    granules: List[Tuple[int, int]] = []  # (block_index_completed, granule)
    failures = 0
    for pkt, granule in packets:
        try:
            dec = _decode_packet_spectra(pkt, setup)
        except _Corrupt:
            failures += 1
            if failures > MAX_DECODE_RETRIES:
                raise
            continue
        if dec is not None:
            blocks.append(dec)
        if granule is not None:
            granules.append((len(blocks), granule))
    if not blocks:
        return np.zeros((0, channels), np.float32), rate, tags, 0

    # Phase 2 (vectorized): batched IMDCT per block size
    times: List[np.ndarray] = [None] * len(blocks)  # type: ignore[list-item]
    for size in set(b[0] for b in blocks):
        idxs = [i for i, b in enumerate(blocks) if b[0] == size]
        spec = np.zeros((len(idxs), channels, size // 2), np.float32)
        for row, i in enumerate(idxs):
            for c, s in enumerate(blocks[i][3]):
                if s is not None:
                    spec[row, c] = s
        y = spec.reshape(-1, size // 2) @ _imdct_matrix(size)
        y = y.reshape(len(idxs), channels, size)
        for row, i in enumerate(idxs):
            times[i] = y[row]

    # Phase 3: window + overlap-add (spec 4.3.8-9: each packet returns
    # prev_n/4 + n/4 samples from the previous window center to the
    # current one; the first packet only primes the lap buffer)
    bs0 = bs[0]
    segs: List[np.ndarray] = []
    seg_starts = [0]
    right: Optional[np.ndarray] = None
    prev_n = 0
    for i, (n, prev_flag, next_flag, _) in enumerate(blocks):
        w = _window(n, bs0, prev_flag, next_flag)
        y = times[i] * w[None, :]
        if right is not None:
            seg_len = prev_n // 4 + n // 4
            out = np.zeros((channels, seg_len), np.float32)
            lap = min(prev_n // 2, seg_len)
            out[:, :lap] += right[:, :lap]
            off = seg_len - n // 2
            if off >= 0:
                out[:, off:] += y[:, : n // 2]
            else:
                out += y[:, -off : -off + seg_len]
            segs.append(out)
            seg_starts.append(seg_starts[-1] + seg_len)
        right = y[:, n // 2 :]
        prev_n = n

    pcm = (
        np.concatenate(segs, axis=1)
        if segs
        else np.zeros((channels, 0), np.float32)
    )
    total = pcm.shape[1]

    # Granule-based sample-accurate trimming: the granule on the page
    # where block k completes equals the absolute end position of
    # segment k (segments are 1:1 with blocks from the second on).
    start_trim = 0
    end = total
    if granules:
        bidx, g = granules[-1]
        produced = seg_starts[min(bidx - 1, len(segs))]
        first_bidx, first_g = granules[0]
        first_produced = seg_starts[min(first_bidx - 1, len(segs))]
        if first_g < first_produced:
            start_trim = first_produced - first_g
        if g + start_trim < produced:
            end = total - (produced - (g + start_trim))
    pcm = pcm[:, start_trim:end]
    return np.ascontiguousarray(pcm.T), rate, tags, pcm.shape[1]
