"""The kernels designed again for the card, on the CPU: the key entry of
the byte-radix select (`bisect8_keys`, which forms each level's plane
inside its counting pass) and the three kernels over 512-sample strided
frames on the warp FFT body (`frame_dft_mags`, `timbral_fft`, `specflux`;
their arithmetic is emulated in tests/test_torch_warp_fft.py).

On the CPU the wrappers run their plain PyTorch versions; these are held
against the composition they replace (`radix_plane` + `bisect8_plain`, level
by level and rank by rank), against a sort, and against the Pallas kernels,
run as tests/test_pallas.py runs them (`interpret=True`, or TPU interpret
mode). Tests marked `cuda` hold the CUDA kernels against the plain versions
on a card and skip without one.
"""

import numpy as np
import pytest
import torch

from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.ops import dft_kernels as TD
from bliss_tpu_torch.ops import reductions as TR
from bliss_tpu_torch.ops import tuning_kernels as TT

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _from_bits(bits):
    return np.array(bits, np.uint32).view(np.float32)


def _values(rng, shape):
    v = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, shape)).astype(np.float32)
    v[rng.random(shape) < 0.1] = 0.0
    v[rng.random(shape) < 0.05] = -0.0
    v[rng.random(shape) < 0.2] = 1.5  # ties
    return v


#: f32 values whose sort key has byte 0xFF at level 0, 1, 2, 3 (and -1.0,
#: whose key 0x407FFFFF has it at levels 2 and 3).
TOP_BYTE = _from_bits([0x7F61B1E6, 0x3FFF0000, 0x3F80FF00, 0x3F8000FF, 0xBF800000])


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = (3, 29, 53)
    values = _values(rng, shape)
    mask = rng.random(shape) < 0.4
    if name == "duplicates":
        values = rng.choice(np.float32([0.25, 1.5, 1.5, 7.0]), size=shape)
    elif name == "negative":
        values = -np.abs(values) - np.float32(1e-3)
    elif name == "zeros":
        values = rng.choice(np.float32([0.0, -0.0, 1e-30, -1e-30]), size=shape)
    elif name.startswith("top_byte_"):
        # most valid elements carry the 0xFF byte at this level, so the
        # ranks land on them and the fallback bucket is taken
        level = int(name[-1])
        hit = rng.random(shape) < 0.7
        values[hit] = TOP_BYTE[level]
        values[0, 0, :5] = TOP_BYTE
    elif name == "minus_one":
        values[rng.random(shape) < 0.7] = -1.0
    elif name == "empty":
        mask[:] = False
    elif name == "single":
        mask[:] = False
        mask[0, 3, 4] = mask[1, 0, 0] = mask[2, -1, -1] = True
    elif name == "full":
        mask[:] = True
    return values, mask


CASES = [
    "mixed", "duplicates", "negative", "zeros", "top_byte_0", "top_byte_1",
    "top_byte_2", "top_byte_3", "minus_one", "empty", "single", "full",
]


# ---------------------------------------------------------------------------
# the key entry, level by level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_key_entry_equals_plane_composition(name):
    """Every level's `[bucket, below]` for both ranks == `bisect8_plain` over
    that level's and rank's `radix_plane`, with prefixes and ranks carried
    by hand as the eight-launch loop carried them; the state holds the same
    prefixes, ranks and count; the median == a sort's."""
    values, mask = _case(name)
    v, m = _t(values).reshape(3, -1), _t(mask).reshape(3, -1)
    u, mm, n, rem = TT.radix_keys(v, m, 0.5)
    prefix = [torch.zeros(3, dtype=torch.int64) for _ in range(2)]
    state = torch.full((3, 5), -7, dtype=torch.int64)  # level 0 reads none of it
    median = torch.empty(3)
    for level in range(4):
        out = TT.bisect8_keys(v, m, level, state, 0.5, median)
        assert out.shape == (3, 2, 2) and out.dtype == torch.int32
        for s in range(2):
            want = TT.bisect8_plain(TT.radix_plane(u, mm, level, prefix[s]), rem[s])
            assert torch.equal(out[:, s], want), (name, level, s)
            prefix[s] = (prefix[s] << 8) | want[:, 0].to(torch.int64)
            rem[s] = (rem[s] - want[:, 1]).to(torch.int32)
            assert torch.equal(state[:, s], prefix[s])
            assert torch.equal(state[:, 2 + s], rem[s].to(torch.int64))
        assert torch.equal(state[:, 4], n.to(torch.int64))
    sort = TR.masked_quantile_midpoint(v, m)
    assert torch.equal(median, sort)
    assert torch.equal(TT.masked_quantile_midpoint_radix(_t(values), _t(mask)), sort)
    if name == "empty":
        assert torch.isinf(median).all()


def test_key_entry_planes_match_pallas_interpret():
    """The plane each level of the key entry stands for, through the Pallas
    `_bisect8` in interpret mode: the same `[bucket, below]`."""
    import jax.numpy as jnp

    from bliss_tpu.ops import pallas_select as JS

    values, mask = _case("top_byte_2")
    v, m = _t(values[:1]).reshape(1, -1), _t(mask[:1]).reshape(1, -1)
    u, mm, _, _ = TT.radix_keys(v, m, 0.5)
    state = torch.zeros((1, 5), dtype=torch.int64)
    for level in range(4):
        before = state.clone()
        out = TT.bisect8_keys(v, m, level, state)
        for s in range(2):
            plane = TT.radix_plane(u, mm, level, before[:, s]).numpy()
            k = int(before[0, 2 + s]) if level else int(state[0, 2 + s] + out[0, s, 1])
            padded = JS._pad_to_tile(jnp.asarray(plane), JS._SENT)
            bucket, below = JS._bisect8(padded, jnp.asarray(k, jnp.int32), interpret=True)
            assert out[0, s].tolist() == [int(bucket), int(below)], (level, s)


@pytest.mark.parametrize("q", [0.25, 0.5, 0.9])
def test_radix_select_matches_pallas_interpret_and_sort(q):
    """`masked_quantile_midpoint_radix` through the four-launch loop == the
    JAX radix select (interpret) == the sort-based quantile, exactly."""
    import jax.numpy as jnp

    from bliss_tpu.ops import pallas_select as JS

    rng = np.random.default_rng(int(q * 100))
    shape = (2, 31, 67)
    values = _values(rng, shape)
    mask = rng.random(shape) < 0.3
    got = TT.masked_quantile_midpoint_radix(_t(values), _t(mask), q)
    for i in range(2):
        want = float(
            JS.masked_quantile_midpoint_radix(
                jnp.asarray(values[i]), jnp.asarray(mask[i]), q, interpret=True
            )
        )
        assert float(got[i]) == want
    assert torch.equal(got, TR.masked_quantile_midpoint(_t(values).reshape(2, -1), _t(mask).reshape(2, -1), q))


def test_radix_select_reads_any_cpu_layout_and_checks_shapes():
    """On the CPU a non-contiguous plane is read through a copy; shapes that
    differ are refused; the CPU path launches nothing."""
    rng = np.random.default_rng(5)
    values = _t(_values(rng, (2, 40, 30))).transpose(1, 2)
    mask = _t(rng.random((2, 30, 40)) < 0.5)
    _build.reset_launches()
    got = TT.masked_quantile_midpoint_radix(values, mask)
    assert torch.equal(got, TR.masked_quantile_midpoint(values.reshape(2, -1), mask.reshape(2, -1)))
    assert _build.LAUNCHES == {}
    with pytest.raises(ValueError, match="shape"):
        TT.masked_quantile_midpoint_radix(values, mask[:, :-1])
    with pytest.raises(ValueError):
        TT.bisect8_keys(
            torch.empty((1, 8), device="meta"), torch.empty((1, 8), dtype=torch.bool, device="meta"),
            0, torch.empty((1, 5), dtype=torch.int64, device="meta"),
        )


@pytest.mark.parametrize("route", ["fused", "framed"])
def test_tuning_planes_of_an_stft_spectrum_are_contiguous_frame_major(route):
    """The radix select reads its planes in place on the card and refuses a
    strided one, so the layout the unfused tuning stage hands it is held
    here: for a spectrum made by `stft` (either route), the stencil's
    `[B, F, rows]` tensors, the masks built from them and the storage behind
    `pip_track`'s `[B, rows, F]` views are contiguous, and `estimate_tuning`
    gives the same tuning for a spectrum in any other layout."""
    from bliss_tpu_torch.models import chroma as TC
    from bliss_tpu_torch.ops.spectral import stft

    rng = np.random.default_rng(41)
    t = 2205 * 40
    tone = np.sin(2 * np.pi * 447.0 * np.arange(t) / 22050.0)
    sig = _t((tone + 0.05 * rng.standard_normal((2, t))).astype(np.float32))
    spectrum = stft(sig, 8192, 2205, route=route)
    assert spectrum.shape[1] == 4097 and spectrum.transpose(1, 2).is_contiguous()
    frame_mask = torch.ones(spectrum.shape[0], spectrum.shape[2], dtype=torch.bool)
    frame_mask[1, -7:] = False

    pitches, mags, is_peak = TC._pip_stencil(spectrum.transpose(1, 2), 8192)
    pos = is_peak & frame_mask.unsqueeze(-1) & (pitches > 0.0)
    for plane in (pitches, mags, is_peak, pos):
        assert plane.is_contiguous()
    for view in TC.pip_track(spectrum, frame_mask, 8192):
        assert view.shape[1:] == (pitches.shape[2], pitches.shape[1])
        assert view.transpose(1, 2).is_contiguous()

    want = TC.estimate_tuning(spectrum, frame_mask, 8192)
    assert want.abs().max() > 0.0  # 447 Hz sits off the equal-tempered grid
    assert torch.equal(TC.estimate_tuning(spectrum.contiguous(), frame_mask, 8192), want)


# ---------------------------------------------------------------------------
# frame_dft_mags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hop,offset", [(256, -1000), (128, -37)])
def test_frame_dft_negative_offset_matches_pallas_interpret(hop, offset):
    """`[B, F, 257]` magnitudes (an f32 FFT) vs `pallas_frame_dft_mags` (an
    f32 matrix DFT at full precision) over frames that start inside the
    buffer, as a halo-extended shard's do: 1e-5 of each frame's max
    (tests/test_torch_dft_routes.py holds the positive offsets)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from bliss_tpu.ops import pallas_dft as JD

    rng = np.random.default_rng(hop + abs(offset))
    n_frames = 130
    sig = (rng.normal(size=(2, hop * (n_frames + 6) - offset)) * 0.1).astype(np.float32)
    got = TD.frame_dft_mags(_t(sig), 512, hop, offset, n_frames).numpy()
    assert got.shape == (2, n_frames, 257) and np.isfinite(got).all()
    with pltpu.force_tpu_interpret_mode():
        for b in range(2):
            framed = jnp.asarray(sig[b, -offset:])
            want = np.asarray(JD.pallas_frame_dft_mags(framed, 512, hop, n_frames))
            assert (np.abs(got[b] - want).max(1) / want.max(1)).max() < 1e-5


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_key_entry_matches_plain(cuda, name):
    values, mask = _case(name)
    v = torch.as_tensor(values, device=cuda).reshape(3, -1)
    m = torch.as_tensor(mask, device=cuda).reshape(3, -1)
    sk = torch.zeros((3, 5), dtype=torch.int64, device=cuda)
    sp = sk.clone()
    mk, mp = torch.empty(3, device=cuda), torch.empty(3, device=cuda)
    for level in range(4):
        got = TT.bisect8_keys(v, m, level, sk, 0.5, mk)
        want = TT.bisect8_keys_plain(v, m, level, sp, 0.5, mp)
        assert torch.equal(got, want) and torch.equal(sk, sp), (name, level)
    assert torch.equal(mk, mp)
    assert torch.equal(mk, TR.masked_quantile_midpoint(v, m))


@pytest.mark.cuda
def test_cuda_radix_select_is_four_launches_in_place(cuda):
    rng = np.random.default_rng(31)
    values = torch.as_tensor(_values(rng, (4, 301, 503)), device=cuda)
    mask = torch.as_tensor(rng.random((4, 301, 503)) < 0.05, device=cuda)
    _build.reset_launches()
    got = TR.masked_quantile_midpoint_all(values, mask)
    assert _build.LAUNCHES == {"bisect8_keys": 4}
    assert torch.equal(got, TR.masked_quantile_midpoint(values.reshape(4, -1), mask.reshape(4, -1)))
    with pytest.raises(ValueError, match="contiguous"):
        TT.masked_quantile_midpoint_radix(values.transpose(1, 2), mask.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch,t,hop,offset", [(3, 200000, 128, 384), (3, 200000, 256, 256), (2, 200001, 256, -8349)]
)
def test_cuda_frame_fft_kernel_matches_plain(cuda, batch, t, hop, offset):
    """Odd buffer lengths (unaligned songs), frames past the end, tiles that
    end inside a block's run."""
    rng = np.random.default_rng(32)
    sig = torch.as_tensor((rng.normal(size=(batch, t)) * 0.1).astype(np.float32), device=cuda)
    n_frames = (t + offset) // hop + 3
    got = TD.frame_dft_mags(sig, 512, hop, offset, n_frames)
    want = TD.frame_dft_mags_plain(sig, hop, offset, n_frames)
    assert ((got - want).abs().amax(-1) / want.amax(-1).clamp(min=1e-30)).max() < 1e-5


def _tiles_per_block(n_frames: int, batch: int) -> int:
    """csrc/frame_tiles.cuh:frame_tiles_launch_shape's run of 32-frame tiles
    a block (about four waves of two blocks an SM)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_tiles = -(-n_frames // 32)
    return max(1, -(-(n_tiles * batch) // (sms * 2 * 4)))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,t,offset", [(3, 200_001, 384), (3, 4_000_003, 384), (2, 300_001, -8349)])
def test_cuda_timbral_fft_kernel_matches_plain(cuda, batch, t, offset):
    """#1 on the warp FFT against its plain version at chip_smoke.py's
    limits (total, weighted, energy relative 1e-5, below +-1, geometric mean
    1e-4 a frame): B = 3, odd buffer lengths, frames past the end, runs of
    several tiles a block whose last tile ends inside the run, a negative
    offset (a halo-extended shard); one launch a call."""
    rng = np.random.default_rng(33)
    sig = torch.as_tensor((rng.normal(size=(batch, t)) * 0.1).astype(np.float32), device=cuda)
    n_frames = (t + offset) // 128 + 3
    _build.reset_launches()
    got = TD.timbral_fft(sig, n_frames, offset=offset)
    assert _build.LAUNCHES == {"timbral_fft": 1}
    want = TD.timbral_fft_plain(sig, n_frames, offset=offset)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)) and torch.equal(got[~fin], want[~fin])
    diff = torch.where(fin, (got - want).abs(), 0.0)
    scale = torch.where(fin, want.abs(), 0.0).clamp(min=1e-30)
    for c in (0, 1, 4):
        assert (diff[..., c] / scale[..., c]).max() < 1e-5, c
    assert diff[..., 2].max() <= 1
    assert (diff[..., 3] * np.log(2) / 256).max() < 1e-4
    assert (got[:, -1, 3] == -np.inf).all()  # the last frame lies past the end: silence


@pytest.mark.cuda
@pytest.mark.parametrize("batch,t", [(3, 200_003), (3, 4_000_003)])
def test_cuda_specflux_kernel_matches_plain(cuda, batch, t):
    """#2 on the warp FFT against its plain version, 1e-5 of each song's
    largest onset: the lookback across warps, across tiles (warp 0's carry)
    and across block runs (one extra transform a run), with the first frame
    of every warp, tile and block run held on its own; one launch a call."""
    rng = np.random.default_rng(34)
    sig = torch.as_tensor((rng.normal(size=(batch, t)) * 0.1).astype(np.float32), device=cuda)
    n_frames = t // 256 + 2
    _build.reset_launches()
    got = TD.specflux(sig, n_frames)
    assert _build.LAUNCHES == {"specflux": 1}
    want = TD.specflux_plain(sig, n_frames)
    err = (got - want).abs() / want.abs().amax(1, keepdim=True)
    assert err.max() < 1e-5
    run = 32 * _tiles_per_block(n_frames, batch)
    for step in (4, 32, run):
        assert err[:, ::step].max() < 1e-5, step
    if t > 1_000_000:
        assert run > 32  # block runs of several tiles were held
