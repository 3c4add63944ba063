"""The analysis entry points: samples -> bliss feature vector (counterpart
of bliss_tpu/models/analyzer.py).

Every descriptor reads one on-device `[B, T]` buffer of zero-padded songs
with per-song valid lengths. On CUDA the path is f32 and runs the
hand-written kernels; on the CPU (only when the caller passes
`device="cpu"`) each kernel's plain version runs instead, with the chroma
stage at f64 by default for golden parity. Every entry point takes
`routes` (`bliss_tpu_torch.routes.Routes`): which kernel carries each
descriptor's transform; the default is the card's analysis path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import AnalysisError
from ..routes import DEFAULT as DEFAULT_ROUTES
from ..routes import Routes
from ..tables import Tables, default_tables
from . import chroma as chroma_model
from . import loudness as loudness_model
from . import tempo as tempo_model
from . import timbral as timbral_model

#: Minimum analyzable length = the largest descriptor window
#: (src/song/mod.rs:417-429).
MIN_SAMPLES = chroma_model.WINDOW_SIZE  # 8192


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA request without a card raises rather
    than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


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
    t = signal.shape[-1]
    lengths = lengths.to(device=dev, dtype=torch.int64)
    # samples past each song's end read as zero, whatever the buffer held
    signal = torch.where(
        torch.arange(t, device=dev) < lengths.unsqueeze(-1),
        signal.to(torch.float32),
        0.0,
    )
    tab = (tables or default_tables()).on(dev)
    tempo = tempo_model.tempo_feature(signal, lengths, tab, route=routes.tempo)
    zcr = timbral_model.zcr_feature(signal, lengths)
    spectral = timbral_model.spectral_features(signal, lengths, tab, routes.timbral)
    loud = loudness_model.loudness_features(signal, lengths)
    chroma = chroma_model.chroma_features(
        signal, lengths, version, dtype, tab, routes.chroma_stft
    )
    return torch.cat(
        [tempo.unsqueeze(-1), zcr.unsqueeze(-1), spectral, loud, chroma.to(torch.float32)],
        dim=-1,
    ).to(torch.float32)


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
