"""The pre-framed CT transform, the direct framed DFT and the flat timbral
rows (`ct_frames_mags`, `frame_dft_mags`, `timbral_flat`) and the analyzer
routes that run them.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the Pallas kernels they replace, run as tests/test_pallas.py runs
them on the CPU (`interpret=True`, or TPU interpret mode with the flat
timbral kernel selected). Each non-default route of the analyzer is held
against the JAX package's CPU analyzer, which computes the same functions
through its plain reference. Tests marked `cuda` hold the hand-written
CUDA kernels against the plain versions on a card and skip without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bliss_tpu_torch.models import analyzer as TA
from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.ops import dft_kernels as TD
from bliss_tpu_torch.ops import spectral as TS
from bliss_tpu_torch.routes import CHOICES, DEFAULT, Routes

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

NON_DEFAULT = [
    Routes(timbral="flat"),
    Routes(timbral="mags", tempo="mags"),
    Routes(chroma_stft="framed"),
]


def _t(a):
    return torch.as_tensor(np.array(a))


def _ids(r):
    return "-".join(f"{k}={v}" for k, v in dataclasses.asdict(r).items() if v != getattr(DEFAULT, k))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------


def test_ct_frames_plain_matches_pallas_interpret():
    """|rDFT| of pre-framed rows vs `pallas_stft_mags_ct`: 1e-5 of each
    frame's max; bins-major `[W/2+1, N]`, N not a multiple of the TPU's
    frame block."""
    import jax.numpy as jnp

    from bliss_tpu.ops import pallas_dft as JD

    rng = np.random.default_rng(3)
    w, f = 8192, 37
    frames = (rng.normal(size=(f, w)) * 0.1).astype(np.float32)
    got = TD.ct_frames_mags(_t(frames)).numpy()
    want = np.asarray(JD.pallas_stft_mags_ct(jnp.asarray(frames), n_frames=f, interpret=True))
    assert got.shape == want.shape == (w // 2 + 1, f)
    assert (np.abs(got - want).max(0) / want.max(0)).max() < 1e-5


@pytest.mark.parametrize("hop,offset", [(128, 384), (256, 256)])
def test_frame_dft_plain_matches_pallas_interpret(hop, offset):
    """`[B, F, 257]` magnitudes vs `pallas_frame_dft_mags` (f32 products at
    full precision) on the offset-padded signal: 1e-5 of each frame's max."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from bliss_tpu.ops import pallas_dft as JD

    rng = np.random.default_rng(hop)
    n_frames = 300
    sig = (rng.normal(size=(2, hop * (n_frames + 6))) * 0.1).astype(np.float32)
    got = TD.frame_dft_mags(_t(sig), 512, hop, offset, n_frames).numpy()
    assert got.shape == (2, n_frames, 257)
    with pltpu.force_tpu_interpret_mode():
        for b in range(2):
            padded = np.concatenate([np.zeros(offset, np.float32), sig[b]])
            want = np.asarray(JD.pallas_frame_dft_mags(jnp.asarray(padded), 512, hop, n_frames))
            assert (np.abs(got[b] - want).max(1) / want.max(1)).max() < 1e-5


def test_frame_dft_negative_offset_and_edges():
    """A negative offset starts the frames inside the buffer (a shard's halo);
    frames past the end read zeros."""
    rng = np.random.default_rng(9)
    sig = _t((rng.normal(size=(1, 9000)) * 0.1).astype(np.float32))
    got = TD.frame_dft_mags(sig, 512, 256, -1000, 40)
    want = TD.frame_dft_mags(sig[:, 1000:], 512, 256, 0, 40)
    assert torch.equal(got, want)
    assert not got[0, 32:].any() and got[0, 31].any()  # frame 32 starts at 9192 > 9000


def test_timbral_flat_plain_matches_pallas_interpret(monkeypatch):
    """Rows (total, weighted, below, log2 sum, energy) vs the flat matmul-DFT
    Pallas kernel, selected as the JAX package selects it: 1e-5 relative,
    `below` +-1 (ties on the 95% energy line), the log2 sum through the
    geometric mean it gives."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from bliss_tpu.ops import pallas_dft as JD

    monkeypatch.setenv("BLISS_TIMBRAL_FFT", "0")
    hop, n_frames, offset = 128, 200, 384
    rng = np.random.default_rng(4)
    sig = (rng.normal(size=hop * (n_frames + 10)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            JD.pallas_frame_dft_timbral(
                jnp.asarray(np.concatenate([np.zeros(offset, np.float32), sig])),
                512, hop, n_frames,
            )
        )
    got = TD.timbral_flat(_t(sig).reshape(1, -1), n_frames)[0].numpy()
    assert got.shape == want.shape == (n_frames, 5)
    for c in (0, 1, 4):
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=1e-5)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1)
    np.testing.assert_allclose(np.exp2(got[:, 3] / 256), np.exp2(want[:, 3] / 256), rtol=1e-5)


def test_timbral_flat_rows_match_f64_dft():
    """The flat rows of a synthetic song sit at f32 rounding distance of an
    f64 DFT's rows: 1e-5 relative; the log2 sum weighs every near-silent
    bin, so it is held through its geometric mean at 1e-4, the feature
    contract, as the FFT route's is."""
    from bliss_tpu_torch.ops.windows import _hann_np, frame_signal
    from chip_smoke import synth_song

    x = synth_song(np.random.default_rng(0), 22050 * 10)
    n_frames = 1500
    sig = _t(x).reshape(1, -1)
    frames = frame_signal(sig, 512, 128, 384, n_frames)[0].numpy().astype(np.float64)
    exact = np.abs(np.fft.rfft(frames * _hann_np(512).astype(np.float32), axis=-1))
    exact = np.concatenate([exact[:, :255], exact[:, 256:]], axis=1)
    flat = TD.timbral_flat(sig, n_frames)[0].numpy().astype(np.float64)
    np.testing.assert_allclose(flat[:, 0], exact.sum(1), rtol=1e-5)
    np.testing.assert_allclose(flat[:, 1], (exact * np.arange(256)).sum(1), rtol=1e-5)
    np.testing.assert_allclose(flat[:, 4], (exact**2).sum(1), rtol=1e-5)
    np.testing.assert_allclose(
        np.exp2(flat[:, 3] / 256), np.exp2(np.log2(exact).sum(1) / 256), rtol=1e-4
    )


@pytest.mark.parametrize("name", ["ct_frames_mags", "frame_dft_mags", "timbral_flat"])
def test_wrapper_on_cpu_is_the_plain_version(name):
    """On a CPU tensor a wrapper returns its plain version's result and
    launches nothing; another device is refused."""
    rng = np.random.default_rng(7)
    sig = _t((rng.normal(size=(2, 20480)) * 0.1).astype(np.float32))
    _build.reset_launches()
    if name == "ct_frames_mags":
        frames = sig.reshape(20, 2048)
        got, want = TD.ct_frames_mags(frames), TD.ct_frames_mags_plain(frames)
        meta = lambda: TD.ct_frames_mags(torch.empty((4, 2048), device="meta"))  # noqa: E731
    elif name == "frame_dft_mags":
        got = TD.frame_dft_mags(sig, 512, 256, 256, 70)
        want = TD.frame_dft_mags_plain(sig, 256, 256, 70)
        assert torch.equal(want, TS.framed_pvoc_mags(sig, 512, 256, 256, 70))
        meta = lambda: TD.frame_dft_mags(torch.empty((1, 4096), device="meta"), 512, 256, 256, 8)  # noqa: E731
    else:
        got, want = TD.timbral_flat(sig, 100), TD.timbral_flat_plain(sig, 100)
        meta = lambda: TD.timbral_flat(torch.empty((1, 4096), device="meta"), 10)  # noqa: E731
    assert torch.equal(got, want)
    assert _build.LAUNCHES == {}
    with pytest.raises(ValueError):
        meta()


def test_wrappers_reject_what_the_kernels_do_not_take():
    sig = torch.zeros((1, 4096))
    with pytest.raises(ValueError, match="512"):
        TD.frame_dft_mags(sig, 1024, 256, 0, 4)
    with pytest.raises(ValueError, match="hop"):
        TD.frame_dft_mags(sig, 512, 130, 0, 4)
    with pytest.raises(ValueError, match="hop"):
        TD.frame_dft_mags(sig, 512, 512, 0, 4)
    with pytest.raises(ValueError, match="power of two"):
        TD.ct_frames_mags(torch.zeros((3, 1000)))
    with pytest.raises(ValueError, match=r"\[N, W\]"):
        TD.ct_frames_mags(torch.zeros((2, 3, 1024)))


def test_framed_pvoc_mags_stays_plain():
    """The building block of the kernels' plain versions reaches no kernel
    wrapper: its module imports none at load time, and it never counts a
    launch."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(TS.framed_pvoc_mags))
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert "dft_kernels" not in names and "frame_dft_mags" not in names
    assert not hasattr(TS, "frame_dft_mags")


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


def test_routes_validate():
    assert DEFAULT == Routes("fft", "fused", "fused")
    for kind, values in CHOICES.items():
        for v in values:
            assert getattr(Routes(**{kind: v}), kind) == v
        with pytest.raises(ValueError, match=kind):
            Routes(**{kind: "other"})
    with pytest.raises(dataclasses.FrozenInstanceError):
        DEFAULT.timbral = "flat"
    x = np.zeros(20000, np.float32)
    with pytest.raises(TypeError, match="Routes"):
        TA.analyze_samples(x, x.shape[0], device="cpu", routes="flat")
    sig = torch.zeros((1, 20000))
    with pytest.raises(ValueError, match="chroma_stft"):
        TS.stft(sig, 8192, 2205, route="other")


@pytest.mark.parametrize("routes", NON_DEFAULT, ids=_ids)
def test_route_matches_jax_cpu_analyzer(decoded_s16_mono, routes):
    """Each non-default route on the CPU vs the JAX package's CPU analyzer
    (its plain reference of the same functions), V2 at 1e-5 and tempo equal
    to the golden's; and vs the port's own default route."""
    from bliss_tpu.models import analyzer as JA

    x = decoded_s16_mono
    want = JA.build_analyzer(2)(x)
    got = TA.build_analyzer(2, device="cpu", routes=routes)(x)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(got[0] - 0.3846389) < 1e-5
    own = TA.build_analyzer(2, device="cpu")(x)
    np.testing.assert_allclose(got, own, atol=1e-5)
    if routes.timbral == "fft":
        np.testing.assert_array_equal(got[:10], own[:10])


@pytest.mark.parametrize("routes", NON_DEFAULT, ids=_ids)
def test_route_reaches_every_entry_point(routes):
    """`analyze_samples`, `analyze_batch` and `build_analyzer` pass `routes`
    down: each calls the route's wrappers and not the default's."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=40000) * 0.1).astype(np.float32)
    called = []

    def spy(name, fn):
        def wrapped(*a, **k):
            called.append(name)
            return fn(*a, **k)

        return wrapped

    from bliss_tpu_torch.models import tempo as TP
    from bliss_tpu_torch.models import timbral as TB

    with pytest.MonkeyPatch.context() as mp:
        for mod, names in (
            (TB, ("timbral_fft", "timbral_flat", "frame_dft_mags")),
            (TP, ("specflux", "frame_dft_mags")),
            (TD, ("ct_stft_mags", "ct_frames_mags")),
        ):
            for n in names:
                mp.setattr(mod, n, spy(f"{mod.__name__.split('.')[-1]}.{n}", getattr(mod, n)))
        outs = [
            TA.analyze_samples(x, x.shape[0], 2, device="cpu", routes=routes).numpy(),
            TA.analyze_batch(x[None], [x.shape[0]], 2, device="cpu", routes=routes)[0],
            TA.build_analyzer(2, device="cpu", routes=routes)(x),
        ]
    expect = {
        "timbral": {"fft": "timbral.timbral_fft", "flat": "timbral.timbral_flat",
                    "mags": "timbral.frame_dft_mags"}[routes.timbral],
        "tempo": {"fused": "tempo.specflux", "mags": "tempo.frame_dft_mags"}[routes.tempo],
        "chroma": {"fused": "dft_kernels.ct_stft_mags",
                   "framed": "dft_kernels.ct_frames_mags"}[routes.chroma_stft],
    }
    assert sorted(called) == sorted(list(expect.values()) * 3)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
    np.testing.assert_allclose(outs[0][:10], outs[2][:10], atol=1e-6)


def test_framed_stft_equals_fused_on_cpu():
    rng = np.random.default_rng(6)
    sig = _t((rng.normal(size=(2, 40000)) * 0.1).astype(np.float32))
    lengths = [40000, 31000]
    sig[1, 31000:] = 0.0
    a = TS.stft(sig, 8192, 2205, lengths)
    b = TS.stft(sig, 8192, 2205, lengths, route="framed")
    assert a.shape == b.shape == (2, 4097, 19)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card: hand-written kernels vs their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_ct_frames_kernel_matches_plain(cuda):
    rng = np.random.default_rng(21)
    for n, w in ((700, 8192), (70000, 8192)):  # the second passes 65,535 rows
        frames = torch.as_tensor((rng.normal(size=(n, w)) * 0.1).astype(np.float32), device=cuda)
        got, want = TD.ct_frames_mags(frames), TD.ct_frames_mags_plain(frames)
        assert got.shape == (w // 2 + 1, n)
        assert ((got - want).abs().amax(0) / want.amax(0)).max() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("hop,offset", [(128, 384), (256, 256), (256, -8349)])
def test_cuda_frame_dft_kernel_matches_plain(cuda, hop, offset):
    rng = np.random.default_rng(22)
    sig = torch.as_tensor((rng.normal(size=(3, 200000)) * 0.1).astype(np.float32), device=cuda)
    n_frames = (200000 + offset) // hop + 3  # the last frames run past the end
    got = TD.frame_dft_mags(sig, 512, hop, offset, n_frames)
    want = TD.frame_dft_mags_plain(sig, hop, offset, n_frames)
    assert ((got - want).abs().amax(-1) / want.amax(-1).clamp(min=1e-30)).max() < 1e-5


@pytest.mark.cuda
def test_cuda_timbral_flat_kernel_matches_plain(cuda):
    rng = np.random.default_rng(23)
    sig = torch.as_tensor((rng.normal(size=(3, 200000)) * 0.1).astype(np.float32), device=cuda)
    got, want = TD.timbral_flat(sig, 1501), TD.timbral_flat_plain(sig, 1501)
    # the sums against the plain version, the log2 sum against an f64 DFT of
    # the same f32 windowed frames, at the limits chip_smoke.py holds it to
    readings, broken = TD.timbral_flat_held(got, want, TD.timbral_flat_f64(sig, 1501))
    assert not broken, (broken, readings)


@pytest.mark.cuda
@pytest.mark.parametrize("routes", NON_DEFAULT, ids=_ids)
def test_cuda_routes_launch_their_kernels(cuda, routes):
    rng = np.random.default_rng(24)
    x = (rng.normal(size=100000) * 0.1).astype(np.float32)
    _build.reset_launches()
    TA.analyze_samples(x, x.shape[0], device="cuda", routes=routes)
    want = {"flat": {"timbral_flat": 1}, "mags": {"frame_dft_mags": 2}}.get(routes.timbral, {})
    if routes.chroma_stft == "framed":
        want = {"ct_frames": 1}
    for k, v in want.items():
        assert _build.LAUNCHES.get(k, 0) == v
