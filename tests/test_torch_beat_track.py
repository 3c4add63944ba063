"""The beat tracker's hypothesis machine (`ops/tempo_kernels.py`) against the
JAX package's `lax.scan` over `_bt_do`, and the tempo feature of the port's
`tempo_from_series` (block inputs, state machine, firing and median)
against `bliss_tpu`'s, on the CPU, over thresholded series made with numpy
from fixed seeds.

The block inputs' autocorrelation (`ops/tempo_kernels.autocorr`) equals the
JAX package's `_autocorr` bit for bit, and so does every block input but
the two Gaussian weight vectors, whose `exp` is XLA's on one side and
PyTorch's on the other (within an ulp). The state machine is held on the
block inputs of the JAX package's own `_precompute_blocks`, so both sides
walk the same inputs: the beat period after each block exact, the firing
flags exact, the beats within 1e-5 (the JAX package sums the beat phase as
a selection-matrix product, in XLA's order; the port adds the 21 lags left
to right). The tempo feature is held exact. The tests marked `cuda` hold
the two kernels against their plain versions bit for bit on the card and
skip without one; this module imports JAX only inside its JAX
comparisons, so they run there with `python3 -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_beat_track.py`.
"""

import functools

import numpy as np
import pytest
import torch

from bliss_tpu_torch.models import tempo as TT
from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.ops import tempo_kernels as TK
from bliss_tpu_torch.ops.windows import frame_signal

torch.set_num_threads(1)

H = 2600  # hops: 20 blocks of 128
STEP = TK.STEP


def _t(a):
    return torch.as_tensor(np.array(a))


def _clicks(rng, periods, h=H):
    """Onsets `[len(periods), h]`: noise and a click every `period` hops; a
    pair (p, q) switches from p to q halfway."""
    onset = (rng.random((len(periods), h)) * 0.1).astype(np.float32)
    for s, p in enumerate(periods):
        p, q = (p, p) if np.isscalar(p) else p
        onset[s, : h // 2 : p] += 3.0
        onset[s, h // 2 :: q] += 3.0
    return onset


def _case(name):
    """(onset [B, h], silent [B, h], h_valid [B]) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "steady":
        onset = _clicks(rng, [43, 37])
    elif name == "tempo_change":  # drives flagstep, counter and flagconst
        onset = _clicks(rng, [(43, 31), (31, 52)])
    elif name == "doubling":  # a period below 25 hops: bp *= 2
        onset = _clicks(rng, [22, 12])
    elif name == "no_onsets":  # constant onsets, the series cut at 0 (_series)
        onset = np.ones((2, H), np.float32)
        onset[1] += (rng.random(H) * 1e-3).astype(np.float32)
    elif name == "silent":  # silent stretches, one song silent throughout
        onset = _clicks(rng, [43, 40, 29])
        silent = np.zeros((3, H), bool)
        for s, (lo, hi) in enumerate([(700, 1300), (0, H), (1900, H)]):
            onset[s, lo:hi] = 0.0
            silent[s, lo:hi] = True
        return onset, silent, np.full(3, H)
    elif name == "h_valid_mid_block":
        onset = _clicks(rng, [43, 35])
        return onset, np.zeros((2, H), bool), np.array([H - 57, 1077])
    elif name == "one_and_zero_blocks":
        onset = _clicks(rng, [43, 31, 43], h=300)
        return onset, np.zeros((3, 300), bool), np.array([300, 200, 100])
    elif name == "ragged":
        onset = _clicks(rng, [43, 27, (40, 34), 51])
        silent = np.zeros((4, H), bool)
        silent[2, 500:800] = True
        return onset, silent, np.array([H, 1999, 2345, 640])
    return onset, np.zeros(onset.shape, bool), np.full(onset.shape[0], onset.shape[1])


CASES = [
    "steady", "tempo_change", "doubling", "no_onsets", "silent",
    "h_valid_mid_block", "one_and_zero_blocks", "ragged",
]


def _series(name):
    onset, silent, h_valid = _case(name)
    thresh = TT.thresholded_series(_t(onset)).numpy()
    if name == "no_onsets":  # no positive value: the onset of the first hops goes too
        thresh = np.minimum(thresh, 0.0)
    return thresh, silent, h_valid.astype(np.int64)


# ---------------------------------------------------------------------------
# the JAX side: its block inputs and its scan over _bt_do
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_scan():
    """`jit` of the JAX package's block loop over one song's block inputs
    and its count of valid blocks: each block's bp, beats, fired (frozen and
    False past the valid blocks, as `tempo_from_series` masks them), counter
    and flagstep."""
    import jax
    import jax.numpy as jnp

    from bliss_tpu.models import tempo as JT

    consts = JT._bt_constants(22050)

    def run(blocks, n_valid):
        def body(state, xs_k):
            xs, k = xs_k
            valid = k < n_valid
            new, vals, fires = JT._bt_do(state, xs, consts)
            out = jax.tree.map(lambda n, o: jnp.where(valid, n, o), new, state)
            return out, (out.bp, jnp.where(valid, vals, 0.0), fires & valid,
                         out.counter, out.flagstep)

        n_blocks = blocks.dfrev.shape[0]
        _, ys = jax.lax.scan(
            body, JT.initial_beat_state(consts), (blocks, jnp.arange(n_blocks))
        )
        return ys

    return jax.jit(run)


def _jax_blocks(thresh, h_valid):
    """The JAX package's `_precompute_blocks` of each song, and each song's
    count of valid blocks."""
    import jax.numpy as jnp

    from bliss_tpu.models import tempo as JT

    consts = JT._bt_constants(22050)
    h = thresh.shape[1]
    n_blocks = (h - STEP) // STEP + 1
    songs = []
    for s in range(thresh.shape[0]):
        masked = jnp.where(jnp.arange(h) < int(h_valid[s]), jnp.asarray(thresh[s]), 0.0)
        songs.append(JT._precompute_blocks(masked, n_blocks, consts))
    n_valid = np.clip(h_valid // STEP, 0, n_blocks).astype(np.int32)
    return songs, n_valid


def _stack(songs):
    """The songs' JAX block inputs as the port's `[B, NB, ...]` tensors."""
    return {
        name: _t(np.stack([np.asarray(getattr(b, name)) for b in songs]))
        for name in TK.BLOCK_WIDTHS
    }


def _block_rows(name):
    """Every block row `[rows, 512]` of a case's series, as
    `_precompute_blocks` frames it (hops past `h_valid` masked)."""
    thresh, _, h_valid = _series(name)
    h = thresh.shape[1]
    masked = torch.where(torch.arange(h) < _t(h_valid).unsqueeze(-1), _t(thresh), 0.0)
    n_blocks = (h - STEP) // STEP + 1
    frames = frame_signal(masked, TK.WINLEN, STEP, offset=TK.WINLEN - STEP + 1, n_frames=n_blocks)
    return frames.reshape(-1, TK.WINLEN)


def _gaussian_rows(seed, rectified):
    rows = np.random.default_rng(seed).standard_normal((64, TK.WINLEN)).astype(np.float32)
    return _t(np.maximum(rows, 0.0) if rectified else rows)


# ---------------------------------------------------------------------------
# the block inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", ["cases", "gaussian", "rectified"])
def test_autocorr_matches_jax(rows):
    """The port's f32 autocorrelation against `jax.vmap` of the JAX
    package's `_autocorr` (XLA's matmul on the CPU), bit for bit: every
    block row of the 8 cases (346 rows), 64 Gaussian rows, 64 rectified
    Gaussian rows."""
    import jax
    import jax.numpy as jnp

    from bliss_tpu.models import tempo as JT

    if rows == "cases":
        df = torch.cat([_block_rows(name) for name in CASES])
        assert df.shape[0] == 346
    else:
        df = _gaussian_rows(11, rows == "rectified")
    got = TK.autocorr(df)
    want = np.asarray(jax.vmap(JT._autocorr)(jnp.asarray(df.numpy())))
    assert got.dtype == torch.float32 and got.shape == df.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_autocorr_plain_rounds_each_step_once():
    """The plain version's emulated FMA rounds once: where a product rounded
    on its own loses the answer, and where the f64 sum rounded to f32 is a
    double rounding; f64 rows sum in the same order without it."""
    f32 = np.float32
    one = f32(1.0 + 2.0 ** -23)
    a = _t([f32(1.0 + 2.0 ** -12)])
    got = TK._fma_f32(a, a, _t([f32(-1.0)])).item()
    assert got == 2.0 ** -11 + 2.0 ** -24  # a * a - 1 exactly; rounded apart: 2^-11
    # (1 + 2^-23) 2^-12 * -(1 - 2^-23) 2^-12 + (1 + 2^-23) = 1 + 2^-24 + 2^-70:
    # above the f32 tie, but its f64 sum is the tie, which rounds to 1
    x, y = _t([f32((1.0 + 2.0 ** -23) * 2.0 ** -12)]), _t([f32(-(1.0 - 2.0 ** -23) * 2.0 ** -12)])
    assert (x.double() * y.double() + float(one)).float().item() == 1.0
    assert TK._fma_f32(x, y, _t([one])).item() == float(one)
    df = _gaussian_rows(3, False)[:2].double()
    lags = [0, 1, 200, 511]
    want = [[sum(df[r, j - i].item() * df[r, j].item() for j in range(i, 512)) / (512 - i)
             for i in lags] for r in range(2)]
    got = TK.autocorr(df)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got[:, lags].numpy(), want, rtol=1e-12, atol=1e-15)


def test_division_by_rounded_reciprocal_rounds_once():
    """csrc/beat_track.cu:div_rn_by, the context weights' branch-free
    division, in numpy f32 and the plain version's exact FMA: y = RN(1/b),
    q = RN(a y), then twice q = RN(q + RN(a - b q) y), against numpy's f32
    quotient (rounded once) on 10^6 pairs in the range the kernel checks
    (`fast_quotient_range`): the weights' own numerators and denominators,
    and significands drawn anywhere in it."""
    rng = np.random.default_rng(5)
    n = 500_000
    d2 = np.concatenate([rng.uniform(-400, 400, n // 2),
                         rng.integers(-300, 300, n // 2) + rng.uniform(0, 1, n // 2)]).astype(np.float32)
    a = np.concatenate([(np.float32(-0.5) * d2) * d2,
                        -(2.0 ** rng.uniform(-90, 90, n)).astype(np.float32)])
    b = np.concatenate([rng.uniform(20, 140, n).astype(np.float32) * np.float32(0.125),
                        (2.0 ** rng.uniform(-20, 20, n)).astype(np.float32)])
    y = np.float32(1.0) / b
    q = _t(a * y)
    at, bt, yt = _t(a), _t(b), _t(y)
    for _ in range(2):
        q = TK._fma_f32(TK._fma_f32(-bt, q, at), yt, q)
    np.testing.assert_array_equal(q.numpy().view(np.int32), (a / b).view(np.int32))


@pytest.mark.parametrize("name", CASES)
def test_precompute_blocks_matches_jax(name):
    """Every block input of the port's `_precompute_blocks` against the JAX
    package's `BlockInputs`, song by song: equal bit for bit, but the
    Gaussian weights `gwv_if3`/`gwv_if4`, `exp` of an equal argument, whose
    `exp` is XLA's CPU approximation on one side and PyTorch's on the other:
    those are held within one ulp, and where XLA's gives 0 for a result
    below f32's smallest normal, PyTorch's subnormal stands beside it."""
    thresh, _, h_valid = _series(name)
    songs, n_valid = _jax_blocks(thresh, h_valid)
    want = _stack(songs)
    consts = TT._bt_constants("cpu")
    got, got_valid = TT.beat_track_inputs(_t(thresh), _t(h_valid), consts)
    np.testing.assert_array_equal(got_valid.numpy(), n_valid)
    for field in TK.BLOCK_WIDTHS:
        g, w = got[field], want[field]
        assert g.dtype == w.dtype and g.shape == w.shape, field
        if field.startswith("gwv_"):
            ulps = (g.view(torch.int32).long() - w.view(torch.int32).long()).abs()
            flushed = (w == 0.0) & (g < torch.finfo(torch.float32).tiny)
            assert bool(((ulps <= 1) | flushed).all()) and bool((g >= 0).all()), field
        else:
            np.testing.assert_array_equal(_bits(g).numpy(), _bits(w).numpy(), err_msg=field)


# ---------------------------------------------------------------------------
# the state machine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_beat_track_plain_matches_jax_scan(name):
    """Per block and song, on the same block inputs: bp and fired exact,
    beats within 1e-5."""
    thresh, _, h_valid = _series(name)
    songs, n_valid = _jax_blocks(thresh, h_valid)
    blocks = _stack(songs)
    bp, beats, fired = TK.beat_track_plain(blocks, _t(n_valid))
    assert bp.dtype == torch.float32 and beats.dtype == torch.float32
    assert fired.dtype == torch.bool and beats.shape == fired.shape == bp.shape + (8,)
    run = _jax_scan()
    flagconst = []
    for s, b in enumerate(songs):
        bp_j, beats_j, fired_j, counter, flagstep = (
            np.asarray(v) for v in run(b, int(n_valid[s]))
        )
        np.testing.assert_array_equal(bp[s].numpy(), bp_j, err_msg=f"song {s}: bp")
        np.testing.assert_array_equal(fired[s].numpy(), fired_j, err_msg=f"song {s}: fired")
        np.testing.assert_allclose(beats[s].numpy(), beats_j, rtol=0, atol=1e-5,
                                   err_msg=f"song {s}: beats")
        # flagconst: counter 1 -> 0 with flagstep 1 (src/aubio.rs:1150-1165)
        prev = np.concatenate([[0], counter[:-1]])
        flagconst.append(int(((prev == 1) & (flagstep == 1) & (counter == 0)).sum()))
    # each case drives what it names
    nv = torch.as_tensor(n_valid, dtype=torch.int64)
    valid = torch.arange(bp.shape[1]).unsqueeze(0) < nv.unsqueeze(1)
    if name == "tempo_change":
        assert min(flagconst) >= 2, flagconst  # a second hypothesis adopted
    if name == "doubling":
        rp = torch.minimum(blocks["rp_if3"], blocks["rp_if4"])
        assert bool(((rp < 25.0) & valid).any())
        assert bool((bp[valid & (bp != 0.0)] >= 25.0).all())
    if name in ("steady", "ragged", "silent"):
        assert bool(fired.any()) and min(flagconst[:2]) >= 1
    if name == "one_and_zero_blocks":
        assert n_valid.tolist() == [2, 1, 0]
        assert not bool(fired[2].any()) and float(bp[2].abs().sum()) == 0.0


@pytest.mark.parametrize("name", CASES + ["no_block"])
def test_tempo_from_series_matches_jax(name):
    """The tempo feature against the JAX package's `tempo_from_series`, per
    song. From the JAX package's block inputs, the port's state machine and
    its batched firing and median (`_tempo_from_beats`) give it exactly, and
    so does the port's whole `tempo_from_series`."""
    import jax.numpy as jnp

    from bliss_tpu.models import tempo as JT

    if name == "no_block":  # fewer hops than one block: -1 for every song
        thresh, silent, h_valid = _series("one_and_zero_blocks")
        thresh, silent, h_valid = thresh[:, :100], silent[:, :100], np.minimum(h_valid, 100)
    else:
        thresh, silent, h_valid = _series(name)
    # op by op, as the JAX package's tests call it (under `jit` XLA fuses the
    # BPM and its normalization, and rounds otherwise)
    want = np.array([
        float(JT.tempo_from_series(jnp.asarray(thresh[s]), jnp.asarray(silent[s]), int(h_valid[s])))
        for s in range(thresh.shape[0])
    ], np.float32)
    consts = TT._bt_constants("cpu")
    got = TT.tempo_from_series(_t(thresh), _t(silent), _t(h_valid), consts).numpy()
    if name == "no_block":
        np.testing.assert_array_equal(got, want)
        assert (got == -1.0).all()
        return
    songs, n_valid = _jax_blocks(thresh, h_valid)
    jax_blocks = _stack(songs)
    from_jax_blocks = TT._tempo_from_beats(
        *TK.beat_track_plain(jax_blocks, _t(n_valid)), _t(silent), _t(h_valid), STEP
    ).numpy()
    np.testing.assert_array_equal(from_jax_blocks, want)
    np.testing.assert_array_equal(got, want)
    if name == "no_onsets":  # the premise: no positive value in the series
        assert (thresh <= 0.0).all()
    if name == "one_and_zero_blocks":
        assert got[-1] == -1.0
    if name == "silent":
        assert got[1] == -1.0  # silent throughout: no beat fires


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ["zeros", "one nonzero", "inf and NaN", "subnormal", "overflow", "gaussian", "blocks"]
)
def test_cuda_autocorr_matches_plain(cuda, case):
    """The autocorrelation kernel against its plain version on the card,
    bit for bit (a NaN beside a NaN): chip_smoke.py's edge rows, and the
    block rows of every case in their `[B, NB, 512]` layout; one launch;
    what the kernel does not take raises."""
    from chip_smoke import autocorr_edge_rows, same_floats

    if case == "blocks":
        rows = torch.cat([_block_rows(name) for name in CASES]).to(cuda).reshape(2, 173, 512)
    else:
        rows = autocorr_edge_rows(cuda)[case]
    _build.reset_launches()
    got = TK.autocorr(rows)
    assert _build.LAUNCHES == {"autocorr": 1}
    want = TK.autocorr_plain(rows)
    torch.cuda.synchronize()
    assert same_floats(got, want)
    if case == "inf and NaN":
        assert bool(torch.isnan(got).any()) and bool(torch.isfinite(got).any())
    with pytest.raises(ValueError):
        TK.autocorr(rows[..., :256])
    with pytest.raises(TypeError):
        TK.autocorr(rows.double())
    with pytest.raises(ValueError):
        TK.autocorr(rows.transpose(0, -1))


def _random_blocks(regime, dev, batch=4, n_blocks=64):
    """Block inputs drawn directly, off any series, to reach the state
    machine's rare paths: "random" (plausible ranges), "wide" (magnitudes
    from 1e-30 to 1e30, either sign, periods down to 0: extreme peaks and
    context weights out of the fast division's range) and "special" (NaN
    and inf among them)."""
    rng = np.random.default_rng(sum(map(ord, regime)))

    def draw(*shape):
        if regime == "wide":
            return rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-30, 30, shape)
        return np.abs(rng.standard_normal(shape))

    blocks = {
        "dfrev": draw(batch, n_blocks, TK.WINLEN), "comb_u3": draw(batch, n_blocks, TK.LAGLEN),
        "comb_u4": draw(batch, n_blocks, TK.LAGLEN),
        "gwv_if3": rng.uniform(0, 1, (batch, n_blocks, TK.LAGLEN)),
        "gwv_if4": rng.uniform(0, 1, (batch, n_blocks, TK.LAGLEN)),
        "rp_if3": rng.uniform(0 if regime == "wide" else 20, 140, (batch, n_blocks)),
        "rp_if4": rng.uniform(0 if regime == "wide" else 20, 140, (batch, n_blocks)),
    }
    if regime == "special":
        for name in ("dfrev", "comb_u3", "comb_u4", "gwv_if3", "rp_if4"):
            v = blocks[name].reshape(-1)
            at = rng.choice(v.size, max(1, v.size // 50), replace=False)
            v[at] = rng.choice([np.nan, np.inf, -np.inf], at.size)
    out = {k: torch.as_tensor(v.astype(np.float32), device=dev) for k, v in blocks.items()}
    for name in ("ts_if3", "ts_if4"):
        out[name] = torch.as_tensor(rng.choice([3, 4], (batch, n_blocks)).astype(np.int32), device=dev)
    n_valid = torch.tensor([n_blocks, n_blocks - 7, n_blocks // 2, 1], dtype=torch.int32, device=dev)
    return out, n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["random", "wide", "special"])
def test_cuda_beat_track_matches_plain_on_drawn_blocks(cuda, regime):
    """The kernel against the plain loop, bit for bit, on block inputs drawn
    off any series (`_random_blocks`)."""
    blocks, n_valid = _random_blocks(regime, cuda)
    got = TK.beat_track(blocks, n_valid)
    want = TK.beat_track_plain(blocks, n_valid)
    torch.cuda.synchronize()
    for label, g, w in zip(("bp", "beats", "fired"), got, want):
        same = _bits(g) == _bits(w)
        if g.dtype == torch.float32:
            same |= torch.isnan(g) & torch.isnan(w)
        assert bool(same.all()), label


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_beat_track_matches_plain(cuda, name):
    """The kernel against the plain loop on the card, on the port's own
    block inputs: bp, beats and fired bit for bit, one launch, and the same
    tempo feature."""
    thresh, silent, h_valid = _series(name)
    consts = TT._bt_constants(cuda)
    blocks, n_valid = TT.beat_track_inputs(_t(thresh).to(cuda), _t(h_valid).to(cuda), consts)
    _build.reset_launches()
    got = TK.beat_track(blocks, n_valid)
    assert _build.LAUNCHES == {"beat_track": 1}
    want = TK.beat_track_plain(blocks, n_valid)
    torch.cuda.synchronize()
    for label, g, w in zip(("bp", "beats", "fired"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, label
        assert torch.equal(_bits(g), _bits(w)), label
    silent_c, h_c = _t(silent).to(cuda), _t(h_valid).to(cuda)
    tempo = [TT._tempo_from_beats(*out, silent_c, h_c, STEP) for out in (got, want)]
    assert torch.equal(tempo[0], tempo[1])
    with pytest.raises(ValueError):
        TK.beat_track(blocks, n_valid[:-1])
    with pytest.raises(TypeError):
        TK.beat_track(blocks, n_valid.to(torch.int64))
