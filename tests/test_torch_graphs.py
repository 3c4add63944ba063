"""The batch driver's CUDA graphs (`models/analyzer.py:analyze_replayed`)
and what they rest on.

On the CPU: the reflect pad of the chroma STFT, which reads no length on
the host, against the row loop it replaced, bit for bit at f32 and f64 and
on `meta` tensors; a capture's launch counts added at each replay; the
reader of `graph_replay_share.scan`; the CPU driver, which captures
nothing.

On a card (`cuda`): the driver's replays against the eager analysis bit
for bit over three bucket shapes, a part-full last bucket and a B = 2 long
bucket, with the `analyze` span's `graph` argument; the launch counts of a
replay; a warm analysis that never waits on the card; the replayed kernels
in `device_trace`'s trace; threads that share the graphs, on streams of
their own or the default one."""

import importlib.util
import json
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bliss_tpu_torch.io import batch as TB
from bliss_tpu_torch.io.decoder import Decoder, PreAnalyzedSong
from bliss_tpu_torch.models import analyzer as TA
from bliss_tpu_torch.models.analyzer import MIN_SAMPLES
from bliss_tpu_torch.ops import _build
from bliss_tpu_torch.ops.windows import frame_signal_reflect, reflect_pad_signal
from bliss_tpu_torch.routes import Routes
from bliss_tpu_torch.utils.profiling import RECORDER, Span, device_trace

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _row_loop(signal, lengths, window_length):
    """The reflect pad as it was written before: a slice write a row, each
    length read on the host. The reference."""
    pad = window_length // 2
    b, t = signal.shape
    padded = signal.new_zeros((b, t + 2 * pad + window_length))
    padded[:, :pad] = signal[:, 1 : pad + 1].flip(-1)
    padded[:, pad : pad + t] = signal
    for i, n in enumerate(torch.as_tensor(lengths).reshape(-1).tolist()):
        start = max(n - 1 - pad, 0)
        padded[i, pad + n : 2 * pad + n] = signal[i, start : start + pad].flip(-1)
    return padded


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("window", [2048, 8192])
def test_reflect_pad_signal_equals_the_row_loop(dtype, seed, window):
    """Random batches whose lengths sit at `MIN_SAMPLES`, at T and in
    between, zero past each length: the gather and scatter write every
    sample of the row loop, bit for bit, from a tensor or a list."""
    rng = np.random.default_rng([seed, window])
    b = int(rng.integers(1, 7))
    t = int(rng.integers(MIN_SAMPLES, 5 * MIN_SAMPLES))
    lengths = rng.integers(MIN_SAMPLES, t + 1, size=b)
    lengths[0] = t
    lengths[-1] = MIN_SAMPLES if b > 1 else t
    x = torch.as_tensor(rng.standard_normal((b, t))).to(dtype)
    x = torch.where(torch.arange(t) < torch.as_tensor(lengths).unsqueeze(-1), x, 0.0)
    want = _row_loop(x, lengths, window)
    for given in (torch.as_tensor(lengths), lengths.tolist()):
        got = reflect_pad_signal(x, given, window)
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int8), want.view(torch.int8))


def test_reflect_pad_signal_reads_no_length_on_the_host():
    """On `meta` tensors, which hold no values, the pad and the framing on
    it complete: no length is read on the host."""
    x = torch.empty(3, 40000, device="meta")
    lengths = torch.empty(3, dtype=torch.int64, device="meta")
    assert reflect_pad_signal(x, lengths, 8192).shape == (3, 40000 + 2 * 4096 + 8192)
    frames = frame_signal_reflect(x, lengths, 8192, 2205, 19)
    assert frames.shape == (3, 19, 8192) and frames.device.type == "meta"


def test_a_replay_adds_what_its_capture_counted(monkeypatch):
    """`counting_capture` yields a dict of its own to each block, nested
    ones too; `add_launches` adds such a dict, once a replay, to the counts
    by kernel and by (kernel, device). (That a capture's launches land in
    its dict alone is a `cuda` case below: the CPU launches no kernel.)"""
    monkeypatch.setattr(_build, "LAUNCHES", {"specflux": 1})
    monkeypatch.setattr(_build, "LAUNCHES_ON", {("specflux", "cuda:0"): 1})
    with _build.counting_capture() as outer:
        with _build.counting_capture() as inner:
            assert inner == {} and inner is not outer
        assert _build._capture.counts is outer
    assert _build._capture.counts is None
    captured = {("ct_stft", "cuda:0"): 2, ("specflux", "cuda:0"): 1, ("ct_stft", "cuda:1"): 1}
    _build.add_launches(captured)
    _build.add_launches(captured)
    assert _build.LAUNCHES == {"specflux": 3, "ct_stft": 6}
    assert _build.LAUNCHES_ON == {("specflux", "cuda:0"): 3, ("ct_stft", "cuda:0"): 4,
                                  ("ct_stft", "cuda:1"): 2}


def test_analyze_replayed_refuses_the_cpu():
    x = torch.zeros(2, 16384)
    with pytest.raises(ValueError, match="card"):
        TA.analyze_replayed(x, torch.full((2,), 16384), torch.empty(2, 23))


def _graph_share_reader():
    path = ROOT / "perfbench" / "metrics" / "graph_replay_share.scan.py"
    spec = importlib.util.spec_from_file_location("graph_replay_share_scan", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class _View:
    """What the reader takes of a traced window: its bounds on the
    profiler's clock and the program's spans."""

    def __init__(self, spans):
        self.t0_ns, self.t1_ns = 1000, 2000
        self.program_spans = spans


def _span(name, lo, hi, thread=7, graph=None):
    return Span(name, lo, hi, thread, -1, -1, None if graph is None else {"graph": graph})


@pytest.mark.parametrize(
    "spans,share",
    [
        # the driver's thread: three analyses in the window, one replayed
        ([_span("batch.dispatch", 1100, 1200), _span("analyze", 1150, 1190, graph="capture"),
          _span("batch.dispatch", 1300, 1400), _span("analyze", 1350, 1390, graph="replay"),
          _span("batch.dispatch", 1500, 1600), _span("analyze", 1550, 1590, graph="capture"),
          # outside the window, and another thread's
          _span("analyze", 100, 900, graph="capture"),
          _span("analyze", 1500, 1600, thread=8, graph="capture")], 100 / 3),
        ([_span("batch.dispatch", 900, 1100), _span("analyze", 950, 1050, graph="replay"),
          _span("batch.dispatch", 1900, 2100), _span("analyze", 1950, 2050, graph="replay")], 100.0),
        # a program whose spans say nothing of a graph, or that has none
        ([_span("batch.dispatch", 1100, 1200), _span("analyze", 1150, 1190)], None),
        ([], None),
    ],
    ids=["a-third", "clipped", "no-graph-argument", "no-spans"],
)
def test_graph_replay_share_reads_the_drivers_analyze_spans(spans, share):
    got = _graph_share_reader()(_View(spans))
    assert got == (None if share is None else pytest.approx(share))


class NoiseDecoder(Decoder):
    """Songs of seeded noise, as long as their path's stem says."""

    @classmethod
    def decode(cls, path):
        n = int(pathlib.PurePath(path).stem)
        x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 0.1
        return PreAnalyzedSong(path=pathlib.Path(path), duration=n / 22050, sample_array=x)


def test_the_cpu_driver_captures_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a graph on the CPU")

    monkeypatch.setattr(TB, "analyze_replayed", refuse)
    paths = [f"/songs/{n}.pcm" for n in (9000, 12000, 20000)]
    out = list(TB.analyze_paths_batched(NoiseDecoder, paths, batch_size=2, device="cpu"))
    assert len(out) == 3 and all(hasattr(r, "analysis") for _, r in out)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    """cuda:0 with no graph captured before or after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    TA._CARD_GRAPHS.clear()
    yield torch.device("cuda", 0)
    TA._CARD_GRAPHS.clear()
    torch.cuda.synchronize()


#: Songs of the driver's mix (samples): three B = 8 buckets, two full
#: batches each and a part-full third in the first; with `LONG_SONG` at
#: 2^23, five 7-minute songs in B = 2 buckets of 10,485,760 samples,
#: whose frames take the unfused tuning route.
MIX = (
    [9_000 + 421 * i for i in range(17)]
    + [1_100_000 + 9_001 * i for i in range(16)]
    + [2_200_000 + 17_003 * i for i in range(16)]
    + [9_261_000 + 1_001 * i for i in range(5)]
)


@pytest.mark.cuda
def test_the_drivers_graphs_equal_the_eager_analysis(card, monkeypatch):
    """Each batch of the mix, replayed or captured, gives the eager
    `analyze_tensor`'s features bit for bit; each shape is captured on its
    first batch and replayed after, and the `analyze` span says which."""
    monkeypatch.setattr(TB, "LONG_SONG", 1 << 23)
    calls = []
    real = TB.analyze_replayed

    def spy(x, lengths, out, version, dtype):
        how = real(x, lengths, out, version, dtype)
        torch.cuda.synchronize()
        want = TA.analyze_tensor(x, lengths, version, dtype).cpu()
        part_full = bool((lengths == MIN_SAMPLES).any())
        calls.append((tuple(x.shape), how, part_full,
                      torch.equal(out.view(torch.int32), want.view(torch.int32))))
        return how

    monkeypatch.setattr(TB, "analyze_replayed", spy)
    RECORDER.take()
    paths = [f"/songs/{n}.pcm" for n in MIX]
    with profile(activities=[ProfilerActivity.CPU]):
        out = list(TB.analyze_paths_batched(NoiseDecoder, paths, device=card))
    spans = [s for s in RECORDER.take() if s.name == "analyze"]
    assert len(out) == len(MIX) and all(hasattr(r, "analysis") for _, r in out)
    assert all(same for *_, same in calls), calls
    shapes = sorted({shape for shape, *_ in calls})
    assert len([s for s in shapes if s[0] == 8]) == 3 and (2, 10_485_760) in shapes
    for shape in shapes:
        hows = [how for s, how, *_ in calls if s == shape]
        assert hows[0] == "capture" and set(hows[1:]) == {"replay"}, (shape, hows)
    assert any(part and how == "replay" for s, how, part, _ in calls if s[0] == 8)
    assert any(part and how == "replay" for s, how, part, _ in calls if s[0] == 2)
    assert [s.args["graph"] for s in spans] == [how for _, how, *_ in calls]


def _batch(device, b, t, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, t, generator=g, device=device) * 0.1
    lengths = torch.linspace(t, t * 3 // 4, b, device=device).to(torch.int64)
    return x, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(8, 1_310_720), (2, 10_485_760)])
def test_a_replay_counts_the_launches_of_the_eager_analysis(card, b, t):
    x, lengths = _batch(card, b, t)
    out = torch.empty((b, 23), pin_memory=True)
    counts = []
    for run in ("eager", "capture", "replay", "replay"):
        _build.reset_launches()
        if run == "eager":
            want = TA.analyze_tensor(x, lengths).cpu()
        else:
            assert TA.analyze_replayed(x, lengths, out) == run
            torch.cuda.synchronize()
            assert torch.equal(out.view(torch.int32), want.view(torch.int32)), run
        counts.append((dict(_build.LAUNCHES), dict(_build.LAUNCHES_ON)))
    assert counts[0][0] and all(c == counts[0] for c in counts), counts


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,t,routes",
    [(8, 1_310_720, Routes()), (2, 10_485_760, Routes()), (8, 1_310_720, Routes(chroma_stft="framed"))],
    ids=["driver-shape", "long-unfused-tuning", "framed-chroma"],
)
def test_a_warm_analysis_never_waits_on_the_card(card, b, t, routes):
    """With the card's sync debug mode at "error", one warm
    `analyze_tensor` (lengths on the card) runs without a call that waits
    on the card, and on the default routes (the driver's, which it
    captures) so does a replay of its graph."""
    x, lengths = _batch(card, b, t)
    out = torch.empty((b, 23), pin_memory=True)
    replayed = routes == Routes()
    TA.analyze_tensor(x, lengths, routes=routes)
    if replayed:
        TA.analyze_replayed(x, lengths, out)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TA.analyze_tensor(x, lengths, routes=routes)
        if replayed:
            assert TA.analyze_replayed(x, lengths, out) == "replay"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("captured", ["inside", "outside"])
def test_replayed_kernels_reach_the_trace(card, tmp_path, captured):
    """A graph captured while a profiler runs, or before it, leaves the
    kernels of each replay in `device_trace`'s trace: one timbral
    transform an analysis that ran, none for the capture."""
    x, lengths = _batch(card, 8, 1_310_720)
    out = torch.empty((8, 23), pin_memory=True)
    if captured == "outside":
        TA.analyze_replayed(x, lengths, out)
    with device_trace(tmp_path):
        hows = [TA.analyze_replayed(x, lengths, out) for _ in range(4)]
    trace = json.loads((tmp_path / "trace.json").read_text())
    kernels = [e for e in trace["traceEvents"]
               if e.get("cat") == "kernel" and "timbral_fft_kernel" in e.get("name", "")]
    assert hows == (["capture"] if captured == "inside" else ["replay"]) + ["replay"] * 3
    assert len(kernels) == 4, [e["name"] for e in kernels]


@pytest.mark.cuda
def test_threads_sharing_the_graphs_get_their_own_features(card):
    """Twelve threads (more than the card host's cores), each with batches
    of its own over two shapes, half of them on streams of their own and
    half on the default one, analyze through the shared graphs at once,
    the shapes' captures among them, with the interpreter switching
    threads every microsecond: each gets its own batch's eager features,
    bit for bit (a write of the static input or a replay that another
    thread interleaved, or that ran beside it on another stream, would
    hand it another's)."""
    shapes = [(8, 16_384), (8, 24_576)]
    batches = [_batch(card, *shapes[k % 2], seed=k) for k in range(24)]
    want = [TA.analyze_tensor(x, lengths).cpu() for x, lengths in batches]
    got: dict = {}

    def work(i):
        stream = torch.cuda.Stream(card) if i % 2 else torch.cuda.default_stream(card)
        with torch.cuda.stream(stream):
            for k in range(i, len(batches), 12):
                out = torch.empty((8, 23), pin_memory=True)
                TA.analyze_replayed(*batches[k], out)
                stream.synchronize()
                got[k] = out.clone()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == list(range(len(batches)))
    for k, w in enumerate(want):
        assert torch.equal(got[k].view(torch.int32), w.view(torch.int32)), k
