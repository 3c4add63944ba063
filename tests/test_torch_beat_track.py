"""The beat tracker's hypothesis machine (`ops/tempo_kernels.py`) against the
JAX package's `lax.scan` over `_bt_do`, and the tempo feature of the port's
`tempo_from_series` (block inputs, state machine, firing and median)
against `bliss_tpu`'s, on the CPU, over thresholded series made with numpy
from fixed seeds.

The state machine is held on the block inputs of the JAX package's own
`_precompute_blocks`, so both sides walk the same inputs: the beat period
after each block exact, the firing flags exact, the beats within 1e-5
(the JAX package sums the beat phase as a selection-matrix product, in
XLA's order; the port adds the 21 lags left to right). The tempo feature
is held exact. The test marked `cuda` holds the kernel against the plain
loop bit for bit on the card and skips without one; this module imports
JAX only inside its JAX comparisons, so it runs there with
`python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_beat_track.py`.
"""

import functools

import numpy as np
import pytest
import torch

from bliss_tpu_torch.models import tempo as TT
from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.ops import tempo_kernels as TK

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
    its batched firing and median (`_tempo_from_beats`) give it exactly.
    The port's whole `tempo_from_series` gives it exactly too, but on the
    constant onsets of "no_onsets": there every lag of the autocorrelation
    is alike, the port's sums each lag in another order than the JAX
    package's (both within 1e-8 of f64), and the comb's peak moves by ulps,
    so that case is held within 1e-5, a tenth of the per-feature contract
    (ROADMAP.md, Queue 3)."""
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
    if name == "no_onsets":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
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
