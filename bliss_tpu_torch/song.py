"""Analysis and Song, minimal (counterpart of bliss_tpu/song.py): a
versioned feature vector and the entry point that computes it from
decoded samples. Decoding files is not part of this package yet."""

from __future__ import annotations

import numpy as np

from .errors import ProviderError
from .features import FeaturesVersion


class Analysis:
    """A versioned f32 feature vector (src/song/mod.rs:224-371)."""

    def __init__(self, analysis, features_version=None):
        if features_version is None:
            features_version = FeaturesVersion.latest()
        features_version = FeaturesVersion.from_int(int(features_version))
        vec = np.asarray(analysis, dtype=np.float32).ravel()
        if vec.shape[0] != features_version.feature_count:
            raise ProviderError(
                f"Feature count {vec.shape[0]} does not match the expected "
                f"version feature count {features_version.feature_count}"
            )
        self._vec = vec
        self.features_version = features_version

    def as_vec(self) -> list:
        return [float(x) for x in self._vec]

    def as_arr1(self) -> np.ndarray:
        return self._vec.copy()

    def __getitem__(self, index) -> float:
        return float(self._vec[int(index)])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Analysis)
            and self.features_version == other.features_version
            and np.array_equal(self._vec, other._vec)
        )

    def __repr__(self) -> str:
        return f"Analysis(version={int(self.features_version)}, {self.as_vec()})"


class Song:
    """Entry point from decoded f32/mono/22050 Hz samples to an Analysis."""

    @staticmethod
    def analyze(
        sample_array,
        features_version=FeaturesVersion.VERSION2,
        device="cuda",
    ) -> Analysis:
        """Analyze one song's samples (src/song/mod.rs:402-508) on `device`
        (the card unless the caller asks for the CPU)."""
        from .models.analyzer import build_analyzer

        version = FeaturesVersion.from_int(int(features_version))
        features = build_analyzer(int(version), device=device)(sample_array)
        return Analysis(features, version)
