"""The analysis entry points: samples -> bliss feature vector (counterpart
of bliss_tpu/models/analyzer.py).

Every descriptor reads one on-device `[B, T]` buffer of zero-padded songs
with per-song valid lengths. On CUDA the path is f32 and runs the
hand-written kernels; on the CPU (only when the caller passes
`device="cpu"`) each kernel's plain version runs instead, with the chroma
stage at f64 by default for golden parity. Every entry point takes
`routes` (`bliss_tpu_torch.routes.Routes`): which kernel carries each
descriptor's transform; the default is the card's analysis path.

The batch driver, which sees each bucket shape again and again, analyzes
a batch on a card through `analyze_replayed`: one CUDA graph a shape,
captured after the shape's first batch and replayed for every later one.
The other entry points take their callers' one-off shapes and run
eagerly.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..errors import AnalysisError
from ..ops import _build
from ..routes import DEFAULT as DEFAULT_ROUTES
from ..routes import Routes
from ..tables import Tables, default_tables
from ..utils.profiling import RECORDER
from . import chroma as chroma_model
from . import loudness as loudness_model
from . import tempo as tempo_model
from . import timbral as timbral_model

#: Minimum analyzable length = the largest descriptor window
#: (src/song/mod.rs:417-429).
MIN_SAMPLES = chroma_model.WINDOW_SIZE  # 8192


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA request without a card raises rather
    than falling back to the CPU. A card comes back indexed (`cuda:N`, the
    current one for a bare "cuda"), so "cuda" and "cuda:0" share every
    per-device cache."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but torch.cuda.is_available() is false; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        index = torch.cuda.current_device() if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"no card {device}: {torch.cuda.device_count()} visible")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def resolve_devices(devices=None, device=None) -> list:
    """The device list of a multi-device entry point: `devices` (entries
    may repeat), else `[device]`, else every visible card, raising without
    one. One list holds cards or the CPU, not both."""
    if devices is not None and device is not None:
        raise ValueError("pass devices or device, not both")
    if devices is None:
        if device is not None:
            devices = [device]
        elif not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested (every visible card) but torch.cuda.is_available() "
                "is false; pass devices=['cpu'] to run the plain PyTorch path"
            )
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("an empty device list")
    if len({d.type for d in out}) > 1:
        raise ValueError(f"a device list mixes the CPU and cards: {out}")
    return out


def _resolve_dtype(device: torch.device, dtype):
    """f32 on the card; on the CPU f64 unless the caller picks f32."""
    if dtype is None:
        return torch.float32 if device.type == "cuda" else torch.float64
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError("the CUDA path is f32")
    return dtype


def analyze_tensor(
    signal: torch.Tensor,
    lengths: torch.Tensor,
    version: int = 2,
    dtype=torch.float32,
    tables: Tables | None = None,
    routes: Routes = DEFAULT_ROUTES,
) -> torch.Tensor:
    """`[B, T]` samples + `[B]` valid lengths -> `[B, 23|20]` f32 features
    on the signal's device, ordered [tempo, zcr, centroid x2, rolloff x2,
    flatness x2, loudness x2, chroma...] (src/song/mod.rs:493-506)."""
    if not isinstance(routes, Routes):
        raise TypeError(f"routes: expected a Routes, got {type(routes).__name__}")
    dev = signal.device
    lengths = lengths.to(device=dev, dtype=torch.int64)
    # samples past each song's end read as zero, whatever the buffer held
    signal = torch.where(
        torch.arange(signal.shape[-1], device=dev) < lengths.unsqueeze(-1),
        signal.to(torch.float32),
        0.0,
    )
    return _analyze_masked(signal, lengths, version, dtype, tables, routes)


def _analyze_masked(signal, lengths, version, dtype, tables, routes) -> torch.Tensor:
    """`analyze_tensor` after its first step: `signal` f32 and zero past
    each of the int64 `lengths`."""
    tab = (tables or default_tables()).on(signal.device)
    # each stage's span is the host's enqueue of its work, not the card's
    sp = RECORDER.begin("analyze.tempo")
    tempo = tempo_model.tempo_feature(signal, lengths, tab, route=routes.tempo)
    sp.end()
    sp = RECORDER.begin("analyze.zcr")
    zcr = timbral_model.zcr_feature(signal, lengths)
    sp.end()
    sp = RECORDER.begin("analyze.timbral")
    spectral = timbral_model.spectral_features(signal, lengths, tab, routes.timbral)
    sp.end()
    sp = RECORDER.begin("analyze.loudness")
    loud = loudness_model.loudness_features(signal, lengths)
    sp.end()
    sp = RECORDER.begin("analyze.chroma")
    chroma = chroma_model.chroma_features(
        signal, lengths, version, dtype, tab, routes.chroma_stft
    )
    sp.end()
    return torch.cat(
        [tempo.unsqueeze(-1), zcr.unsqueeze(-1), spectral, loud, chroma.to(torch.float32)],
        dim=-1,
    ).to(torch.float32)


class _Captured(NamedTuple):
    """One batch shape's analysis captured in a CUDA graph: the graph, its
    static inputs (the masked samples, a view of the card's input buffer,
    and the lengths), the features it writes and the launches one replay
    makes."""

    graph: torch.cuda.CUDAGraph
    signal: torch.Tensor
    lengths: torch.Tensor
    features: torch.Tensor
    launches: dict


class _CardGraphs:
    """The captured analyses of one card, by (B, T, version, dtype), on
    the default routes. They share one graph memory pool, and each views
    its static input from the start of the card's input buffer: every
    write of an input, replay and copy of features runs in order on the
    card's own `stream`, under `lock`, after the work its caller's stream
    has queued and before what that stream queues next, whatever stream
    each caller is on. A shape larger than the buffer takes a new one, of twice
    the old size or the shape's, whichever is larger; the graphs captured
    over the old buffer keep it, so the buffers held come to less than
    twice the last, and no graph is captured twice."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.buffer = torch.empty(0, dtype=torch.float32, device=device)
        # what the masked write compares and writes, outside the graphs
        self.positions = torch.arange(0, device=device)
        self.zero = torch.zeros((), device=device)
        self.graphs: dict = {}

    def _capture(self, key) -> _Captured:
        b, t, version, dtype = key
        signal = self.buffer[: b * t].view(b, t)
        lengths = torch.full((b,), t, dtype=torch.int64, device=self.device)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's work on the card during the capture
        # (an upload, a synchronizing copy) is not this graph's and may go on
        with _build.counting_capture() as launches, torch.cuda.graph(
            graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"
        ):
            features = _analyze_masked(signal, lengths, version, dtype, None, DEFAULT_ROUTES)
        return _Captured(graph, signal, lengths, features, launches)

    def add(self, key) -> None:
        """Capture `key`'s analysis."""
        need = key[0] * key[1]
        if need > self.buffer.numel():
            size = max(need, 2 * self.buffer.numel())
            self.buffer = torch.empty(size, dtype=torch.float32, device=self.device)
        if key[1] > self.positions.numel():
            self.positions = torch.arange(key[1], device=self.device)
        self.graphs[key] = self._capture(key)


_CARD_GRAPHS: dict = {}
_CARD_GRAPHS_LOCK = threading.Lock()


def analyze_replayed(
    signal: torch.Tensor,
    lengths: torch.Tensor,
    out: torch.Tensor,
    version: int = 2,
    dtype=torch.float32,
) -> str:
    """`analyze_tensor` of a `[B, T]` batch on a card, with the default
    tables and routes, its features copied into `out` (e.g. pinned host
    memory, an asynchronous copy, done before the caller's current stream
    goes on). The first batch of a shape runs eagerly, then its analysis
    is captured in a CUDA graph ("capture"); every later batch of that
    shape is masked into the graph's static input and replays it
    ("replay"), which returns the eager analysis's features bit for bit.
    The graphs live for the process. Returns "capture" or "replay"."""
    dev = signal.device
    if dev.type != "cuda":
        raise ValueError(f"a CUDA graph needs a card, not {dev}")
    with _CARD_GRAPHS_LOCK:
        card = _CARD_GRAPHS.get(dev)
        if card is None:
            card = _CARD_GRAPHS[dev] = _CardGraphs(dev)
    key = (*signal.shape, version, dtype)
    with card.lock, torch.cuda.device(dev):
        caller = torch.cuda.current_stream(dev)
        card.stream.wait_stream(caller)
        with torch.cuda.stream(card.stream):
            g = card.graphs.get(key)
            if g is None:
                out.copy_(analyze_tensor(signal, lengths, version, dtype), non_blocking=True)
                card.add(key)
                how = "capture"
            else:
                t = signal.shape[1]
                torch.where(card.positions[:t] < lengths.unsqueeze(-1),
                            signal.to(torch.float32), card.zero, out=g.signal)
                g.lengths.copy_(lengths)
                g.graph.replay()
                _build.add_launches(g.launches)
                out.copy_(g.features, non_blocking=True)
                how = "replay"
        caller.wait_stream(card.stream)
    return how


def analyze_samples(
    signal,
    length,
    version: int = 2,
    dtype=None,
    device="cuda",
    tables: Tables | None = None,
    routes: Routes = DEFAULT_ROUTES,
) -> torch.Tensor:
    """One song: `[T]` samples (+ valid `length`) -> `[23|20]` f32 features
    on `device`."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(signal, dtype=np.float32), device=dev).reshape(1, -1)
    lengths = torch.as_tensor([int(length)], device=dev)
    return analyze_tensor(x, lengths, version, _resolve_dtype(dev, dtype), tables, routes)[0]


def bucket_length(n: int, min_bucket: int = 1 << 14) -> int:
    """Smallest padded size holding `n`: powers of two with 4 subdivisions
    per octave (padding waste <= ~19%)."""
    if n <= min_bucket:
        return min_bucket
    p = 1 << (max(n - 1, 1)).bit_length()
    for num in (5, 6, 7):  # p/2 * {1.25, 1.5, 1.75}
        cand = (p >> 3) * num
        if cand >= n:
            return cand
    return p


def build_analyzer(
    version: int = 2,
    dtype=None,
    device="cuda",
    tables: Tables | None = None,
    routes: Routes = DEFAULT_ROUTES,
):
    """Host-facing analyzer: `analyze(np_samples) -> np.ndarray[features]`,
    padding each song to its `bucket_length`."""
    dev = resolve_device(device)
    dtype = _resolve_dtype(dev, dtype)

    def analyze(samples) -> np.ndarray:
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        n = samples.shape[-1]
        if n < MIN_SAMPLES:
            raise AnalysisError("empty or too short song.")
        buf = np.zeros(bucket_length(n), dtype=np.float32)
        buf[:n] = samples
        x = torch.as_tensor(buf, device=dev).reshape(1, -1)
        lengths = torch.as_tensor([n], device=dev)
        return analyze_tensor(x, lengths, version, dtype, tables, routes)[0].cpu().numpy()

    return analyze


def analyze_batch(
    batch,
    lengths,
    version: int = 2,
    dtype=None,
    device="cuda",
    tables: Tables | None = None,
    routes: Routes = DEFAULT_ROUTES,
) -> np.ndarray:
    """Analyze a `[B, T]` zero-padded batch of songs with valid `lengths`
    in one pass of the device path -> `[B, 23|20]`."""
    dev = resolve_device(device)
    dtype = _resolve_dtype(dev, dtype)
    lengths = np.asarray(lengths, dtype=np.int64).reshape(-1)
    if lengths.size and lengths.min() < MIN_SAMPLES:
        raise AnalysisError("empty or too short song.")
    x = torch.as_tensor(np.asarray(batch, dtype=np.float32), device=dev)
    out = analyze_tensor(
        x, torch.as_tensor(lengths, device=dev), version, dtype, tables, routes
    )
    return out.cpu().numpy()
