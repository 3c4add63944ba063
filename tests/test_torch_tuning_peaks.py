"""The fused tuning route's peak list and its one-block-a-song select
(`ops/tuning_kernels.py:tuning_peaks`, `tuning_select`) against the plane
composition of the TPU kernels' contracts they replace (`tuning_planes`,
`bisect16_pair` twice with `level2_plane` between, `threshold_key`,
`histogram_threshold_plane`) and against the JAX package's fused estimator.

On the CPU the wrappers run their plain versions; a numpy copy of the
select kernel's byte-radix steps is held here too. Tests marked `cuda` hold
the kernels against the plain versions on a card and skip without one.
"""

import numpy as np
import pytest
import torch

from bliss_tpu_torch.models import chroma as TC
from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.ops import tuning_kernels as TT

torch.set_num_threads(1)

INT32_MAX = 2**31 - 1
BAND = TC.peak_band(8192)
ROWS = BAND[1]
PER_FRAME = (ROWS + 1) // 2
OUT_KEYS = ("counts", "o1", "o2", "min_c", "tk")


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _spectra(seed, songs=3, frames=60):
    """Peaky frame-major spectra `[songs, frames, 4097]`; the last song is
    silent."""
    rng = np.random.default_rng(seed)
    spec = (rng.random((songs, frames, 4097)) ** 8).astype(np.float32)
    for s in range(songs):
        f = rng.integers(0, frames, 300)
        b = rng.integers(0, 4097, 300)
        spec[s, f, b] += rng.random(300).astype(np.float32) * 20.0
    spec[-1] = 0.0
    return spec


def _masks(seed, songs=3, frames=60):
    rng = np.random.default_rng(seed + 100)
    mask = np.ones((songs, frames), bool)
    mask[0, -7:] = False  # a padded tail
    mask[1] = rng.random(frames) < 0.8  # frames masked anywhere
    return mask


def _pairs(keys, bins, m):
    return sorted(zip(keys[:m].tolist(), bins[:m].tolist()))


@pytest.mark.parametrize("seed", range(4))
def test_peak_list_equals_plane_composition(seed):
    """Each song's list is the plane composition's valid entries, (key,
    bin) as a multiset, and `n` their count; the CPU wrapper is the plain
    version and launches nothing."""
    spec = _t(_spectra(seed))
    mask = _t(_masks(seed))
    _build.reset_launches()
    keys, bins, n = TT.tuning_peaks(spec, mask, *BAND)
    assert _build.LAUNCHES == {}
    assert keys.dtype == torch.int32 and bins.dtype == torch.uint8 and n.dtype == torch.int32
    assert keys.shape == bins.shape == (3, TT.peak_capacity(60, ROWS)) == (3, 60 * PER_FRAME)
    planes = TC.tuning_planes(spec.transpose(1, 2), mask, 8192)
    skey = planes["skey"].reshape(3, -1)
    idx8 = planes["idx8"].reshape(3, -1)
    for s in range(3):
        valid = idx8[s] < 100
        assert int(n[s]) == int(valid.sum())
        want = sorted(zip(skey[s][valid].tolist(), idx8[s][valid].tolist()))
        assert _pairs(keys[s], bins[s], int(n[s])) == want
    assert int(n[0]) > 0 and int(n[2]) == 0  # peaks, and silence


def test_peak_capacity_holds_on_an_alternating_spectrum():
    """Every other band row a peak: 714 a frame, the list exactly full; no
    frame of a random spectrum holds more."""
    frames = 5
    spec = np.full((1, frames, 4097), 0.5, np.float32)
    spec[:, :, 1::2] = 1.0  # odd bins high: band rows 0, 2, ..., 1426
    keys, bins, n = TT.tuning_peaks_plain(_t(spec), torch.ones((1, frames), dtype=torch.bool), *BAND)
    assert int(n[0]) == frames * PER_FRAME == keys.shape[1]
    assert (keys[0] == TC._float_sort_key(torch.tensor(1.0))).all()
    out = TT.tuning_select_plain(keys, bins, n)
    assert int(out["counts"].sum()) == frames * PER_FRAME
    rand = _t(np.random.default_rng(3).random((1, 40, 4097)).astype(np.float32))
    planes = TC.tuning_planes(rand.transpose(1, 2), torch.ones((1, 40), dtype=torch.bool), 8192)
    per_frame = (planes["idx8"] < 100).sum(2)
    assert int(per_frame.max()) <= PER_FRAME


def _key(x):
    return int(np.float32(x).view(np.int32) ^ (0x7FFFFFFF if np.float32(x).view(np.int32) < 0 else 0))


SELECT_CASES = {
    "n0": [[]],
    "n1": [[_key(1.5)]],
    "n2": [[_key(1.0), _key(3.0)]],
    "tied": [[_key(2.0)] * 7],
    # ranks 1 and 2 on either side of a high-16-bit bucket boundary
    "straddle": [[0x40000005, 0x40010003, 0x40000001, 0x40010002]],
    "zero_negative": [
        [_key(-1.0), _key(1.0)],  # median 0.0: tk is -0.0's key
        [_key(0.0), _key(-2.0), _key(3.0), _key(-0.0), _key(-5.0)],
    ],
    # the i16 planes' sentinels: a high half 0xFFFF (NaN keys) and low
    # halves 0xFFFF, which bisect16_pair does not count
    "sentinel_halves": [
        [0x7FFFFFFF, 0x7FFF1234, 0x3F80FFFF, 0x3F80FFFF, 0x3F800001, 0x40000000],
        [0x3F80FFFF, 0x3F80FFFF, 0x3F80FFFF],
    ],
}


def _select_inputs(lists, seed=0, pad=3):
    rng = np.random.default_rng(seed)
    cap = max(len(x) for x in lists) + pad
    keys = np.full((len(lists), cap), INT32_MAX, np.int32)
    bins = np.full((len(lists), cap), 255, np.uint8)
    for s, x in enumerate(lists):
        keys[s, : len(x)] = np.asarray(x, np.int64).astype(np.int32)
        bins[s, : len(x)] = rng.integers(0, 100, len(x))
    n = np.asarray([len(x) for x in lists], np.int32)
    return _t(keys), _t(bins), _t(n)


def _random_lists(seed, songs=4):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(songs):
        mags = (rng.random(int(rng.integers(1, 400))) ** 8 * 20.0).astype(np.float32)
        if s == 1:
            mags[: len(mags) // 3] = mags[0]  # ties
        out.append([_key(m) for m in mags])
    return out


def _composition(keys, bins, n):
    """The TPU route's planes over the list (excluded slots as
    `tuning_planes` marks them) through the plain TPU contracts."""
    listed = torch.arange(keys.shape[1]) < n.unsqueeze(1)
    skey = torch.where(listed, keys, INT32_MAX).unsqueeze(1)
    idx8 = torch.where(listed, bins.to(torch.int32), 101).to(torch.int8).unsqueeze(1)
    posk = (n - 1).to(torch.float32) * 0.5
    ks = torch.stack(
        [torch.clamp(torch.floor(posk).to(torch.int32), min=0),
         torch.clamp(torch.ceil(posk).to(torch.int32), min=0)], 1
    )
    o1 = TT.bisect16_pair_plain((skey >> 16).to(torch.int16), ks)
    plane_lo, rem, min_c = TC.level2_plane(skey, ks, o1)
    o2 = TT.bisect16_pair_plain(plane_lo, rem)
    tk = TC.threshold_key(o1, o2, min_c, torch.float32)
    counts = TT.histogram_threshold_plane_plain(idx8, skey, tk, 100)
    return {"counts": counts, "o1": o1, "o2": o2, "min_c": min_c.to(torch.int32), "tk": tk}


def _pick(hist, k):
    """pick_digits for one rank: the digit whose bucket holds rank k and the
    count below it; 256 and the total when k reaches the total."""
    cum = np.cumsum(hist)
    hit = np.nonzero((cum - hist <= k) & (k < cum))[0]
    if hit.size:
        return int(hit[0]), int(cum[hit[0]] - hist[hit[0]])
    return 256, int(cum[-1])


def _select16(u, level, b_f, ks):
    """select16: two byte levels over the half `level` of the u32 keys."""
    hi = u >> 16
    if level == 0:
        v, on = hi, hi != 0xFFFF
    else:
        v = u & 0xFFFF
        on = (hi == b_f) & (v != 0xFFFF)
    top = np.bincount(v[on] >> 8, minlength=256)
    out = []
    for k in ks:
        d1, below1 = _pick(top, k)
        if d1 == 256:
            out.append((0xFFFF, below1))
            continue
        low = np.bincount(v[on & ((v >> 8) == d1)] & 0xFF, minlength=256)
        d2, below2 = _pick(low, k - below1)
        out.append(((d1 << 8) | d2, below1 + below2))
    return out


def _select_emulated(keys, bins, n, n_bins=100):
    """A numpy copy of tuning_select_kernel's steps, song by song."""
    out = {k: [] for k in OUT_KEYS}
    for s in range(keys.shape[0]):
        m = int(n[s])
        key = keys[s, :m].numpy().astype(np.int64)
        u = (key & 0xFFFFFFFF) ^ 0x80000000
        ks = [(m - 1) // 2 if m > 0 else 0, m // 2]
        (bf, lf), (bc, lc) = _select16(u, 0, 0, ks)
        rem = [max(ks[0] - lf, 0), max(ks[1] - lc, 0)]
        (cf, mf), (cc, mc) = _select16(u, 1, bf, rem)
        in_c = (u >> 16) == bc
        min_c = int(min(0xFFFF, (u[in_c] & 0xFFFF).min())) if in_c.any() else 0xFFFF
        lo_c = cc if bf == bc else min_c

        def flt(k):
            s32 = np.uint32(k ^ 0x80000000).view(np.int32)
            return (s32 ^ np.int32(0x7FFFFFFF) if s32 < 0 else s32).view(np.float32)

        with np.errstate(invalid="ignore"):
            t = np.float32(np.float32(flt((bf << 16) | cf) + flt((bc << 16) | lo_c)) * np.float32(0.5))
        tk = -1 if t == 0.0 else _key(t)
        sel = key >= tk
        out["counts"].append(np.bincount(bins[s, :m].numpy()[sel], minlength=n_bins)[:n_bins])
        out["o1"].append([bf, bc, lf, lc])
        out["o2"].append([cf, cc, mf, mc])
        out["min_c"].append(min_c)
        out["tk"].append(tk)
    return {k: torch.as_tensor(np.asarray(v, np.int64)).to(torch.int32) for k, v in out.items()}


@pytest.mark.parametrize("case", sorted(SELECT_CASES) + ["random"])
def test_select_plain_matches_composition(case):
    """`tuning_select` (plain, on the CPU) and the numpy copy of its kernel
    give o1, o2, min_c, tk and counts equal to the plane composition."""
    lists = _random_lists(7) if case == "random" else SELECT_CASES[case]
    keys, bins, n = _select_inputs(lists)
    want = _composition(keys, bins, n)
    _build.reset_launches()
    got = TT.tuning_select(keys, bins, n)
    assert _build.LAUNCHES == {}
    emulated = _select_emulated(keys, bins, n)
    for k in OUT_KEYS:
        assert got[k].dtype == torch.int32, k
        assert torch.equal(got[k], want[k]), (k, got[k], want[k])
        assert torch.equal(emulated[k], want[k]), (k, emulated[k], want[k])
    if case == "straddle":
        assert int(got["o1"][0, 0]) != int(got["o1"][0, 1])
    if case == "sentinel_halves":
        assert int(got["o2"][1, 0]) == 0xFFFF  # the rank lies past the counted halves
    if case == "zero_negative":
        assert int(got["tk"][0]) == -1


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_fused_estimator_matches_jax(seed):
    """The port's `_estimate_tuning_fused` (peak list + select, plain
    versions) == the JAX fused estimator under interpret mode, per song."""
    import jax.numpy as jnp

    from bliss_tpu.models import chroma as JC

    spec = _spectra(seed, songs=2, frames=173)
    mask = _masks(seed, songs=2, frames=173)
    got = TC._estimate_tuning_fused(_t(spec).transpose(1, 2), _t(mask), 8192)
    for s in range(2):
        want = float(JC._estimate_tuning_fused(
            jnp.asarray(spec[s].T), jnp.asarray(mask[s]), 8192, interpret=True
        ))
        assert float(got[s]) == want
    assert float(got[1]) == 0.0  # silence


def test_select_wrapper_refuses_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        TT.tuning_select(
            torch.empty((1, 8), dtype=torch.int32, **meta),
            torch.empty((1, 8), dtype=torch.uint8, **meta),
            torch.empty(1, dtype=torch.int32, **meta),
        )


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_tuning_peaks_matches_plain(cuda):
    """The list as a multiset and `n`, at full capacity too."""
    alt = np.full((1, 60, 4097), 0.5, np.float32)
    alt[:, :, 1::2] = 1.0
    for spec, mask in ((_spectra(0), _masks(0)), (alt, np.ones((1, 60), bool))):
        spec_c = torch.as_tensor(spec, device=cuda)
        mask_c = torch.as_tensor(mask, device=cuda)
        got = TT.tuning_peaks(spec_c, mask_c, *BAND)
        want = TT.tuning_peaks_plain(spec_c, mask_c, *BAND)
        assert torch.equal(got[2], want[2])
        for s in range(spec.shape[0]):
            m = int(want[2][s])
            assert _pairs(got[0][s].cpu(), got[1][s].cpu(), m) == _pairs(want[0][s].cpu(), want[1][s].cpu(), m)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SELECT_CASES) + ["random"])
def test_cuda_tuning_select_matches_plain(cuda, case):
    lists = _random_lists(7) if case == "random" else SELECT_CASES[case]
    keys, bins, n = (x.to(cuda) for x in _select_inputs(lists))
    got = TT.tuning_select(keys, bins, n)
    want = TT.tuning_select_plain(keys, bins, n)
    for k in OUT_KEYS:
        assert torch.equal(got[k], want[k]), k
