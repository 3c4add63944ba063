"""The flat timbral kernel (`ops/dft_kernels.py:timbral_flat`,
`csrc/timbral_flat.cu`): a direct DFT on the tensor cores, each operand split
into three bf16 pieces with six of the nine products kept, and one twiddle
block for a frame's four 128-sample chunks, turned by a quarter turn per chunk.

On the CPU a numpy copy of the kernel's arithmetic (the f32 window product,
the bf16 split, the six products, the per-chunk sums, the quarter turns,
Neumaier in chunk order, the magnitudes and rows), reading the twiddle block
through the kernel's own tile addressing, is held against
`timbral_flat_plain`, an f64 DFT and the Pallas kernel it replaces (TPU
interpret mode, the flat kernel selected): relative 1e-5 on total, weighted
and energy, `below` +-1 (ties on the 95% energy line), and the log2 sum
through the geometric mean it gives, per frame. The copy rounds each stage
sum to nearest where the tensor cores' f32 sum truncates, so it sits closer
to the plain version than the card does; the card is held to
`dft_kernels.timbral_flat_held`'s limits, which the copy with six products
meets and with three (the bf16x3 control) does not. Tests marked `cuda`
hold the kernel on the edge shapes at those limits, as `chip_smoke.py`
does, and skip without a card. JAX is imported only inside the Pallas
comparison, so the `cuda` cases run on a host without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flat_dft.py
"""

import numpy as np
import pytest
import torch

from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.ops import dft_kernels as TD
from bliss_tpu_torch.ops.windows import _hann_np, frame_signal

torch.set_num_threads(1)

HOP, WIN, CHUNKS = 128, 512, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even), returned as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _split3(x: np.ndarray):
    """The kernel's three bf16 pieces of f32 values: hi, mid, lo."""
    hi = _bf16(x)
    r = (x - hi).astype(np.float32)
    mid = _bf16(r)
    return hi, mid, _bf16((r - mid).astype(np.float32))


def _block_from_tiles(tiles: torch.Tensor) -> np.ndarray:
    """`[3, 128, 512]` pieces of the twiddle block, read back through the
    kernel's addressing: stage nt * 4 + kst of 6,144 bytes, piece p at
    2,048 bytes, then no-swizzle K-major core matrices (512 bytes along k,
    128 along n, 16 a column, 2 a k)."""
    flat = tiles.float().reshape(-1).numpy()
    k = np.arange(128)[:, None]
    col = np.arange(512)[None, :]
    nt, cl = col // 32, col % 32
    kst, kl = k // 32, k % 32
    out = np.empty((3, 128, 512), np.float32)
    for p in range(3):
        idx = (nt * 4 + kst) * 3072 + p * 1024 + (kl // 8) * 256 + (cl // 8) * 64 + (cl % 8) * 8 + kl % 8
        out[p] = flat[idx]
    return out


def _slot_bins() -> np.ndarray:
    k = np.arange(256)
    k[255] = 256  # aubio's buggy layout: slot 255 carries the Nyquist bin
    return k


def _turn(re, im, m):
    """(re + i im) * (-i)^m, m per column."""
    swap = (m & 1) == 1
    x = np.where(swap, im, re)
    y = np.where(swap, re, im)
    return np.where(m >= 2, -x, x), np.where((m == 1) | (m == 2), -y, y)


def _comp_add(s, c, p):
    t = (s + p).astype(np.float32)
    c = (c + np.where(np.abs(s) >= np.abs(p), (s - t) + p, (p - t) + s)).astype(np.float32)
    return t, c


#: The kernel's six products a k step, in its order (A piece, B piece), and
#: the three of a bf16x3 control (hh, hm, mh), which the limits must refuse.
PRODUCTS = {
    6: ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)),
    3: ((1, 0), (0, 1), (0, 0)),
}


def _emulated(sig: np.ndarray, n_frames: int, products: int = 6) -> np.ndarray:
    """Rows `[B, n_frames, 5]` by the kernel's arithmetic. The products of
    each 32-deep k-stage of a chunk are summed in f64 and rounded to f32
    once, and a chunk's four stage sums are added in f32 in order. So this
    copy models a stage sum rounded to nearest; the tensor cores' f32 sum
    truncates, which moves the card's rows farther from the plain
    version's than this copy's (the per-frame limits that hold it here
    are not the card's: `timbral_flat_held` is)."""
    x = torch.as_tensor(sig)
    frames = frame_signal(x, WIN, HOP, TD.TIMBRAL_OFFSET, n_frames).numpy()
    a = (frames * _hann_np(WIN).astype(np.float32)).astype(np.float32)
    tw = TD._constants(WIN, "cpu")[1]
    b = _block_from_tiles(TD._flat_twiddle_block(tw)).astype(np.float64)
    m_of = _slot_bins()
    s_re = c_re = s_im = c_im = np.float32(0)
    for c in range(CHUNKS):
        q = np.float32(0)  # [..., 512]: re, im of each slot side by side
        for lo in range(0, HOP, 32):
            ap = [p.astype(np.float64) for p in _split3(a[..., c * HOP + lo : c * HOP + lo + 32])]
            bs = b[:, lo : lo + 32]
            stage = sum(ap[i] @ bs[j] for i, j in PRODUCTS[products])
            q = (q + stage.astype(np.float32)).astype(np.float32)
        re, im = _turn(q[..., 0::2], q[..., 1::2], (c * m_of) & 3)
        s_re, c_re = _comp_add(s_re, c_re, re)
        s_im, c_im = _comp_add(s_im, c_im, im)
    r, i = (s_re + c_re).astype(np.float32), (s_im + c_im).astype(np.float32)
    mags = np.sqrt((r * r + i * i).astype(np.float32))
    return TD.timbral_rows(torch.as_tensor(mags)).numpy()


def _held(got, want, geo_limit=1e-5):
    """The emulation's limits on rows: the largest relative error of total,
    weighted and energy, the largest `below` difference and the largest
    per-frame geometric-mean difference; non-finite entries equal."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and np.array_equal(got[~fin], want[~fin])
    with np.errstate(invalid="ignore"):
        diff = np.where(fin, np.abs(got - want), 0.0)
    scale = np.maximum(np.where(fin, np.abs(want), 0.0), 1e-30)
    rel = max((diff[..., c] / scale[..., c]).max() for c in (0, 1, 4))
    below = diff[..., 2].max()
    geo = (diff[..., 3] * np.log(2) / 256).max()
    assert rel < 1e-5 and below <= 1 and geo < geo_limit, (rel, below, geo)
    return rel, below, geo


def _f64_rows(sig: np.ndarray, n_frames: int) -> np.ndarray:
    """Rows of an f64 DFT of the same f32 windowed frames."""
    return TD.timbral_flat_f64(torch.as_tensor(sig), n_frames).numpy()


def _song(seed: int, seconds: float) -> np.ndarray:
    from chip_smoke import synth_song

    return synth_song(np.random.default_rng(seed), int(22050 * seconds))[None, :]


@pytest.mark.parametrize("case", ["synthetic", "noise", "ragged"])
def test_emulated_kernel_matches_plain(case):
    """The kernel's arithmetic against the plain version (per-chunk f32
    matmuls over the full [512, 256] matrices) on a synthetic song (tones,
    clicks, a quiet noise floor), loud noise in two songs, and a song whose
    length is no multiple of 128 with frames past its end."""
    if case == "synthetic":
        sig, n_frames = _song(0, 4), 700
    elif case == "noise":
        rng = np.random.default_rng(31)
        sig, n_frames = (rng.normal(size=(2, 30000)) * 0.3).astype(np.float32), 240
    else:
        rng = np.random.default_rng(32)
        sig, n_frames = (rng.normal(size=(1, 20000)) * 0.05).astype(np.float32), 163
    want = TD.timbral_flat_plain(torch.as_tensor(sig), n_frames).numpy()
    _held(_emulated(sig, n_frames), want)


def test_emulated_kernel_matches_f64_dft():
    """Against an f64 DFT of the same f32 windowed frames: 1e-5 relative on
    the sums; the log2 sum, which weighs every near-silent bin, through its
    geometric mean at the 1e-4 feature contract, as the plain version's own
    test holds it (tests/test_torch_dft_routes.py)."""
    sig, n_frames = _song(1, 4), 700
    _held(_emulated(sig, n_frames), _f64_rows(sig, n_frames), geo_limit=1e-4)


def test_emulated_kernel_matches_pallas_interpret(monkeypatch):
    """Against the flat matmul-DFT Pallas kernel it replaces, selected as the
    JAX package selects it and run in TPU interpret mode."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from bliss_tpu.ops import pallas_dft as JD

    monkeypatch.setenv("BLISS_TIMBRAL_FFT", "0")
    n_frames = 200
    rng = np.random.default_rng(4)
    sig = (rng.normal(size=HOP * (n_frames + 10)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            JD.pallas_frame_dft_timbral(
                jnp.asarray(np.concatenate([np.zeros(TD.TIMBRAL_OFFSET, np.float32), sig])),
                WIN, HOP, n_frames,
            )
        )
    _held(_emulated(sig[None, :], n_frames)[0], want[:, :5])


def _control_cases():
    rng = np.random.default_rng(31)
    return {
        "synthetic": (_song(0, 4), 700),
        "noise": ((rng.normal(size=(2, 30000)) * 0.3).astype(np.float32), 240),
    }


@pytest.mark.parametrize("case", list(_control_cases()))
@pytest.mark.parametrize("products", [6, 3])
def test_limits_hold_six_products_and_refuse_bf16x3(case, products):
    """`timbral_flat_held`, the card's limits, on the kernel's arithmetic:
    they hold six products and refuse the bf16x3 control (hh, hm, mh: the
    kernel's products without the three smallest), whose dropped
    terms (~2^-16 relative) leave the sums within their 1e-5 and show only
    in the log2 sum's mean distance to an f64 DFT."""
    sig, n_frames = _control_cases()[case]
    x = torch.as_tensor(sig)
    readings, broken = TD.timbral_flat_held(
        _emulated(sig, n_frames, products), TD.timbral_flat_plain(x, n_frames),
        TD.timbral_flat_f64(x, n_frames),
    )
    assert readings["rel"] < TD.FLAT_REL and readings["below"] <= TD.FLAT_BELOW
    if products == 6:
        assert not broken, (broken, readings)
    else:
        assert any("mean geo_mean" in b for b in broken), readings


def test_twiddle_block_is_cached_by_tensor():
    """The route passes its tables' twiddle tensor on every call: the block
    is built once for it, and again only after the tensor is written."""
    tw = TD._constants(WIN, "cpu")[1].clone()
    first = TD._flat_block(tw)
    assert TD._flat_block(tw) is first
    assert torch.equal(first, TD._flat_twiddle_block(tw))
    tw.mul_(1.0)
    assert TD._flat_block(tw) is not first


def test_twiddle_block_is_quarter_turn_symmetric():
    """Rows 128 c + n of the plain version's DFT matrices equal rows n turned
    by (-i)^(ck), bit for bit, except where the phase (n k) mod 512 of row
    128 c + n is a multiple of 128; there the table's cos(pi/2) = 6.1e-17 or
    sin(pi) = 1.2e-16 stands where the turned entry is an exact 0 (or the
    reverse), a difference under 2e-16."""
    cos_m, sin_m = (t.numpy() for t in TD._flat_dft_matrices(TD._constants(WIN, "cpu")[1]))
    k = _slot_bins()
    n = np.arange(HOP)[:, None]
    worst = 0.0
    for c in range(1, CHUNKS):
        re, im = _turn(cos_m[:HOP], sin_m[:HOP], np.broadcast_to((c * k) & 3, (HOP, 256)))
        rows = slice(c * HOP, (c + 1) * HOP)
        differ = (cos_m[rows] != re) | (sin_m[rows] != im)
        crossing = (((c * HOP + n) * k) % 128) == 0
        assert not (differ & ~crossing).any()
        assert differ.any()
        worst = max(worst, np.abs(cos_m[rows] - re).max(), np.abs(sin_m[rows] - im).max())
    assert 0 < worst < 2e-16, worst


def test_twiddle_block_pieces_and_layout():
    """The wrapper's B operand read back through the kernel's addressing is
    the chunk-0 block, cos and -sin of a slot side by side, and its three
    bf16 pieces sum to it exactly."""
    tw = TD._constants(WIN, "cpu")[1]
    tiles = TD._flat_twiddle_block(tw)
    assert tiles.dtype == torch.bfloat16 and tiles.numel() * 2 == 384 * 1024
    pieces = _block_from_tiles(tiles).astype(np.float64)
    cos_m, sin_m = (t.numpy() for t in TD._flat_dft_matrices(tw))
    want = np.stack([cos_m[:HOP], sin_m[:HOP]], axis=-1).reshape(HOP, 512)
    np.testing.assert_array_equal(pieces.sum(0), want.astype(np.float64))
    assert np.array_equal(pieces[0], _bf16(want))


def _edge_signals():
    rng = np.random.default_rng(23)
    noise = (rng.normal(size=(3, 200000)) * 0.1).astype(np.float32)
    quiet = (rng.normal(size=(2, 200000)) * 1e-6).astype(np.float32)
    return {
        # (signal, n_frames): B = 3 at T = 200,000 (not a multiple of 128)
        "b3_1501": (noise, 1501),
        "one_frame": (noise, 1),
        "ragged": (noise[:1], 1000),  # not a multiple of the 128-frame tile
        "past_end": (noise, (200000 + 384) // 128 + 40),  # frames past T
        "silent": (np.zeros((2, 70000), np.float32), 550),
        "near_silent": (quiet, 1563),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_edge_signals()))
def test_cuda_timbral_flat_edges(cuda, case):
    sig, n_frames = _edge_signals()[case]
    x = torch.as_tensor(sig, device=cuda)
    _build.reset_launches()
    got = TD.timbral_flat(x, n_frames)
    assert _build.LAUNCHES == {"timbral_flat": 1}
    want = TD.timbral_flat_plain(x, n_frames)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (sig.shape[0], n_frames, 5)
    readings, broken = TD.timbral_flat_held(got.cpu(), want.cpu(), _f64_rows(sig, n_frames))
    assert not broken, (broken, readings)
    if case == "silent":
        assert torch.isneginf(got[..., 3]).all() and not got[..., [0, 1, 2, 4]].any()


@pytest.mark.cuda
def test_cuda_timbral_flat_never_runs_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel or raises."""
    monkeypatch.setattr(TD, "timbral_flat_plain", None)
    x = torch.zeros((1, 4096), device=cuda)
    assert TD.timbral_flat(x, 8).shape == (1, 8, 5)
    with pytest.raises(TypeError):
        TD.timbral_flat(x.double(), 8)
