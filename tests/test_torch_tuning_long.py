"""The unfused tuning route of the port (long buckets) against the JAX
package: `bisect8`, `histogram_int_plane`, the byte-radix median and the
unfused estimator, exactly, plus the route gate.

On the CPU the wrappers run their plain PyTorch versions; the Pallas
kernels run as tests/test_pallas.py runs them (`interpret=True`, or TPU
interpret mode). Tests marked `cuda` hold the CUDA kernels against the
plain versions on a card and skip without one.
"""

import numpy as np
import pytest
import torch

from bliss_tpu_torch.models import chroma as TC
from bliss_tpu_torch.models.analyzer import bucket_length
from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.ops import reductions as TR
from bliss_tpu_torch.ops import tuning_kernels as TT
from bliss_tpu_torch.ops.windows import n_frames_stft

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# bisect8
# ---------------------------------------------------------------------------


def _byte_plane(rng, shape, density, top_share):
    """int8 plane of key bytes (u8 - 128): a share of valid 0xFF bytes,
    the rest spread, excluded elements at the sentinel 127."""
    u = rng.integers(0, 255, size=shape)
    u[rng.random(shape) < top_share] = 0xFF  # valid bytes equal to the sentinel
    u[rng.random(shape) > density] = 0xFF  # excluded
    return (u - 128).astype(np.int8)


def _j_bisect8(plane, k):
    import jax.numpy as jnp

    from bliss_tpu.ops import pallas_select as JS

    padded = JS._pad_to_tile(jnp.asarray(plane), JS._SENT)
    bucket, below = JS._bisect8(padded, jnp.asarray(k, jnp.int32), interpret=True)
    return [int(bucket), int(below)]


@pytest.mark.parametrize(
    "shape,density,top_share",
    [((37, 150), 0.3, 0.0), ((40, 129), 0.5, 0.2), ((5, 7), 1.0, 0.5), ((20, 40), 0.0, 0.0)],
)
def test_bisect8_matches_pallas_interpret(shape, density, top_share):
    """Exact [bucket, below] on planes with valid 0xFF bytes, sentinels,
    k = 0, k = n - 1 (n = elements below 0xFF), past the end, and an
    all-sentinel plane."""
    rng = np.random.default_rng(sum(shape))
    plane = _byte_plane(rng, shape, density, top_share)
    n = int((plane != 127).sum())
    for k in sorted({0, max(n - 1, 0), n // 2, n, n + 7}):
        want = _j_bisect8(plane, k)
        got = TT.bisect8(_t(plane)[None], torch.tensor([k], dtype=torch.int32))
        assert got[0].tolist() == want, (k, n)


def test_bisect8_sentinel_rule():
    """The k-th element is a valid 0xFF byte: bucket 0xFF, `below` counts
    only the buckets under it; a batch keeps songs apart."""
    a = np.array([3, 5, 255, 255, 255], np.int64) - 128
    b = np.array([0, 0, 254, 7, 255], np.int64) - 128
    plane = _t(np.stack([a, b]).astype(np.int8))
    got = TT.bisect8(plane, torch.tensor([2, 2], dtype=torch.int32))
    assert got.tolist() == [[255, 2], [7, 2]]
    assert got[0].tolist() == _j_bisect8(a.astype(np.int8).reshape(1, -1), 2)
    assert got[1].tolist() == _j_bisect8(b.astype(np.int8).reshape(1, -1), 2)


# ---------------------------------------------------------------------------
# histogram_int_plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_bins", [(0, 100), (1, 100), (2, 128), (3, 7)])
def test_histogram_int_plane_matches_pallas_interpret(seed, n_bins):
    """Exact counts; values below 0 and at or above n_bins (the sentinel)
    are ignored."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from bliss_tpu.ops import pallas_hist as JH

    rng = np.random.default_rng(seed)
    planes = rng.integers(-5, n_bins + 5, size=(3, 41, 97)).astype(np.int32)
    planes[1, rng.random((41, 97)) < 0.9] = n_bins  # mostly sentinel
    planes[2] = n_bins  # nothing selected
    got = TT.histogram_int_plane(_t(planes), n_bins).numpy()
    assert got.shape == (3, n_bins) and got.dtype == np.int32
    with pltpu.force_tpu_interpret_mode():
        for i in range(3):
            want = np.asarray(JH.histogram_int_plane(jnp.asarray(planes[i]), n_bins))
            np.testing.assert_array_equal(got[i], want)
    assert got[2].sum() == 0


# ---------------------------------------------------------------------------
# the byte-radix median
# ---------------------------------------------------------------------------


def _values(rng, shape):
    v = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, shape)).astype(np.float32)
    v[rng.random(shape) < 0.1] = 0.0
    v[rng.random(shape) < 0.05] = -0.0
    v[rng.random(shape) < 0.2] = 1.5  # ties
    return v


@pytest.mark.parametrize("density", [0.02, 0.5, 1.0])
def test_radix_median_matches_pallas_interpret(density):
    """`masked_quantile_midpoint_radix` == the JAX radix select (interpret)
    == the sort-based masked median, exactly; +inf for an empty mask."""
    import jax.numpy as jnp

    from bliss_tpu.ops import pallas_select as JS

    rng = np.random.default_rng(int(density * 100))
    shape = (3, 33, 70)
    values = _values(rng, shape)
    mask = rng.random(shape) < density
    mask[2] = False
    got = TT.masked_quantile_midpoint_radix(_t(values), _t(mask), 0.5).numpy()
    for i in range(3):
        want = float(
            JS.masked_quantile_midpoint_radix(
                jnp.asarray(values[i]), jnp.asarray(mask[i]), 0.5, interpret=True
            )
        )
        assert float(got[i]) == want
    sort = TR.masked_quantile_midpoint(_t(values).reshape(3, -1), _t(mask).reshape(3, -1))
    assert torch.equal(torch.as_tensor(got), sort)
    assert got[2] == np.inf


# ---------------------------------------------------------------------------
# the unfused estimator
# ---------------------------------------------------------------------------


def _peaky_spectra(seed, bins=4097, frames=173):
    rng = np.random.default_rng(seed)
    spec = (rng.random((bins, frames)) ** 8).astype(np.float32)
    spec[rng.integers(0, bins, 400), rng.integers(0, frames, 400)] += (
        rng.random(400).astype(np.float32) * 20.0
    )
    return spec


def _j_unfused(spec, fmask, n_fft=8192, resolution=0.01):
    """The JAX unfused route composed by hand as chroma.py:447-466 runs it
    on a TPU: pip_track -> radix median (interpret) -> selection ->
    histogram_int_plane (interpret)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from bliss_tpu.models import chroma as JC
    from bliss_tpu.ops import pallas_hist as JH
    from bliss_tpu.ops import pallas_select as JS

    pitches, mags, peak = JC.pip_track(jnp.asarray(spec), jnp.asarray(fmask), n_fft)
    pos = peak & (pitches > 0.0)
    threshold = JS.masked_quantile_midpoint_radix(mags, pos, 0.5, interpret=True)
    sel = pos & (mags >= threshold)
    n_bins = int(round(1.0 / resolution))
    octs = JC.hz_to_octs(jnp.maximum(pitches, jnp.finfo(jnp.float32).tiny), 0.0)
    v = jnp.mod(12 * octs, 1.0)
    v = jnp.where(v >= 0.5, v - 1.0, v)
    idx = jnp.clip(((v + 0.5) / resolution).astype(jnp.int32), 0, n_bins - 1)
    with pltpu.force_tpu_interpret_mode():
        counts = JH.histogram_int_plane(jnp.where(sel, idx, n_bins), n_bins)
    tuning = (-50.0 + (100.0 * resolution * jnp.argmax(counts).astype(jnp.float32))) / 100.0
    return float(tuning) if int(counts.sum()) > 0 and bool(peak.any()) else 0.0


def test_unfused_estimator_matches_jax_and_fused():
    """The port's unfused estimate_tuning at f32 == the JAX unfused
    composition, and == the port's fused estimator on the same spectra,
    bit for bit; silence gives 0."""
    fmask = np.ones(173, bool)
    fmask[-9:] = False
    specs = [_peaky_spectra(s) for s in (4, 5)] + [np.zeros((4097, 173), np.float32)]
    spec_t = _t(np.stack(specs))
    fmask_t = _t(np.stack([fmask] * len(specs)))
    unfused = TC.estimate_tuning(spec_t, fmask_t, 8192)
    fused = TC._estimate_tuning_fused(spec_t, fmask_t, 8192)
    assert unfused.dtype == torch.float32
    assert torch.equal(unfused, fused)
    for i, spec in enumerate(specs):
        assert float(unfused[i]) == _j_unfused(spec, fmask)
    assert float(unfused[-1]) == 0.0


def test_pitch_tuning_sentinel_histogram():
    """pitch_tuning through histogram_int_plane == the JAX pitch_tuning
    (its CPU scatter-add), per song; an empty selection gives 0."""
    import jax.numpy as jnp

    from bliss_tpu.models import chroma as JC

    rng = np.random.default_rng(9)
    freqs = rng.uniform(-50.0, 4000.0, size=(2, 60, 30)).astype(np.float32)
    mask = rng.random((2, 60, 30)) < 0.3
    mask[1] = False
    got = TC.pitch_tuning(_t(freqs), _t(mask))
    for i in range(2):
        want = float(JC.pitch_tuning(jnp.asarray(freqs[i]), jnp.asarray(mask[i])))
        assert float(got[i]) == want
    assert float(got[1]) == 0.0


# ---------------------------------------------------------------------------
# the route gate
# ---------------------------------------------------------------------------


def test_route_gate_matches_reference_budget():
    """Every bucket of a 3- to 60-minute song: the port's plane bytes and
    route equal the JAX package's `_fused_plane_bytes` <= 12 MiB gate;
    the fused route ends at the 8,388,608-sample bucket."""
    from bliss_tpu.models import chroma as JC
    from bliss_tpu.models.analyzer import bucket_length as j_bucket_length

    buckets = sorted({bucket_length(s * 22050) for s in range(180, 3601)})
    assert buckets == sorted({j_bucket_length(s * 22050) for s in range(180, 3601)})
    fused = []
    for padded in buckets:
        frames = int(n_frames_stft(padded, 2205))
        want = JC._fused_plane_bytes((4097, frames), 8192)
        assert TC._fused_plane_bytes(frames, 8192) == want
        route = TC.uses_fused_tuning(frames, torch.float32)
        assert route == (want <= 12 << 20)
        assert not TC.uses_fused_tuning(frames, torch.float64)
        if route:
            fused.append(padded)
    assert max(fused) == 8_388_608
    assert min(set(buckets) - set(fused)) == 10_485_760


def test_wrappers_on_cpu_launch_nothing():
    _build.reset_launches()
    TT.bisect8(torch.zeros((1, 10), dtype=torch.int8), torch.zeros(1, dtype=torch.int32))
    TT.histogram_int_plane(torch.zeros((1, 10), dtype=torch.int32), 100)
    assert _build.LAUNCHES == {}
    with pytest.raises(ValueError):
        TT.histogram_int_plane(torch.empty((1, 8), dtype=torch.int32, device="meta"), 100)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_long_route_kernels_exact(cuda):
    rng = np.random.default_rng(21)
    plane = torch.as_tensor(_byte_plane(rng, (4, 900, 1400), 0.05, 0.01), device=cuda)
    n = (plane != 127).flatten(1).sum(1).to(torch.int32)
    for k in (torch.zeros_like(n), n // 2, torch.clamp(n - 1, min=0), n + 3):
        k = k.contiguous()
        assert torch.equal(TT.bisect8(plane, k), TT.bisect8_plain(plane, k))
    idx = torch.as_tensor(rng.integers(-3, 104, (4, 900, 1400)).astype(np.int32), device=cuda)
    assert torch.equal(TT.histogram_int_plane(idx, 100), TT.histogram_int_plane_plain(idx, 100))
    values = torch.as_tensor(_values(rng, (4, 300, 500)), device=cuda)
    mask = torch.as_tensor(rng.random((4, 300, 500)) < 0.1, device=cuda)
    want = TR.masked_quantile_midpoint(values.reshape(4, -1), mask.reshape(4, -1))
    assert torch.equal(TR.masked_quantile_midpoint_all(values, mask), want)
