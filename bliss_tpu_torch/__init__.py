"""PyTorch/CUDA port of bliss_tpu's analysis path.

Audio files (`io/`: the FFI-free decoders and the batch driver
`io.batch.analyze_paths_batched`) or decoded 22.05 kHz mono PCM go in,
the bliss feature vector (23 features for Version2, 20 for Version1)
comes out, on an NVIDIA GPU through hand-written CUDA kernels (`csrc/`),
or on the CPU through each kernel's plain PyTorch version when the caller
asks for `device="cpu"`.

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
    NUMBER_FEATURES,
    SAMPLE_RATE,
    FeaturesVersion,
)
from .song import Analysis, AnalysisOptions, CueInfo, Song  # noqa: E402

__all__ = [
    "Analysis",
    "AnalysisError",
    "AnalysisOptions",
    "BlissError",
    "CueInfo",
    "DecodingError",
    "FeaturesVersion",
    "NUMBER_FEATURES",
    "ProviderError",
    "SAMPLE_RATE",
    "Song",
]
