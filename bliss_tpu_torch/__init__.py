"""PyTorch/CUDA port of bliss_tpu's analysis path.

Audio files (`io/`: the FFI-free decoders and the batch driver
`io.batch.analyze_paths_batched`) or decoded 22.05 kHz mono PCM go in,
the bliss feature vector (23 features for Version2, 20 for Version1)
comes out, on an NVIDIA GPU through hand-written CUDA kernels (`csrc/`),
or on the CPU through each kernel's plain PyTorch version when the caller
asks for `device="cpu"`.

Analyzed songs go into a SQLite `Library` (`library.py`), whose
playlist queries run on one cached feature matrix on the same device
(`playlist.py`).

The package imports torch and numpy only; it keeps its own copies of the
host-side constants it needs.
"""

import torch

# Full f32 products on the card. TF32 keeps ~10 mantissa bits; reduced
# precision f32 products were the cause of a 3.9e-4 chroma drift in the
# JAX package's history, so both switches are pinned off for the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .errors import AnalysisError, BlissError, DecodingError, ProviderError  # noqa: E402
from .features import (  # noqa: E402
    CHANNELS,
    NUMBER_FEATURES,
    SAMPLE_RATE,
    VERSION2_WEIGHTS,
    AnalysisIndex,
    AnalysisIndexV1,
    FeaturesVersion,
)
from .song import Analysis, AnalysisOptions, CueInfo, Song  # noqa: E402

__version__ = "0.13.0"  # the bliss-rs feature level, as bliss_tpu's


def __getattr__(name):
    """`Library`, `BaseConfig` and `LibrarySong`, imported on first use."""
    if name in ("Library", "BaseConfig", "LibrarySong"):
        from . import library

        return getattr(library, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Analysis",
    "AnalysisError",
    "AnalysisIndex",
    "AnalysisIndexV1",
    "AnalysisOptions",
    "BlissError",
    "CHANNELS",
    "CueInfo",
    "DecodingError",
    "FeaturesVersion",
    "NUMBER_FEATURES",
    "ProviderError",
    "SAMPLE_RATE",
    "Song",
    "VERSION2_WEIGHTS",
]
