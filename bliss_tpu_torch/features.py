"""Feature versioning, weights and indices (bliss-rs src/lib.rs:142-234,
src/song/mod.rs:102-222)."""

from __future__ import annotations

import enum

import numpy as np

from .errors import ProviderError

SAMPLE_RATE = 22050
CHANNELS = 1

#: Per-feature weights for the Version2 default (Mahalanobis) metric
#: (src/lib.rs:209-234).
VERSION2_WEIGHTS = np.array([0.25] + [1.0] * 9 + [3.0 / 13.0] * 13, dtype=np.float32)


class FeaturesVersion(enum.IntEnum):
    """Version of the analysis features."""

    VERSION1 = 1
    VERSION2 = 2
    LATEST = 2

    @classmethod
    def latest(cls) -> "FeaturesVersion":
        return cls.VERSION2

    @property
    def feature_count(self) -> int:
        return 23 if self is FeaturesVersion.VERSION2 else 20

    def feature_weights(self) -> np.ndarray:
        """Diagonal weight matrix for the version's default distance metric."""
        if self is FeaturesVersion.VERSION2:
            return np.diag(VERSION2_WEIGHTS).astype(np.float32)
        return np.eye(self.feature_count, dtype=np.float32)

    def distance_metric(self):
        """Distance metric yielding the best results for this version."""
        from .playlist import mahalanobis_distance_builder

        return mahalanobis_distance_builder(self.feature_weights())

    @classmethod
    def from_int(cls, value: int) -> "FeaturesVersion":
        try:
            return cls(value)
        except ValueError:
            raise ProviderError(
                f"This features' version ({value}) does not exist"
            ) from None


#: Latest version's feature count (reference src/song/mod.rs:222).
NUMBER_FEATURES = FeaturesVersion.latest().feature_count


class AnalysisIndex(enum.IntEnum):
    """Indexes the fields of a Version2 analysis (src/song/mod.rs:102-156)."""

    TEMPO = 0
    ZCR = 1
    MEAN_SPECTRAL_CENTROID = 2
    STD_DEVIATION_SPECTRAL_CENTROID = 3
    MEAN_SPECTRAL_ROLLOFF = 4
    STD_DEVIATION_SPECTRAL_ROLLOFF = 5
    MEAN_SPECTRAL_FLATNESS = 6
    STD_DEVIATION_SPECTRAL_FLATNESS = 7
    MEAN_LOUDNESS = 8
    STD_DEVIATION_LOUDNESS = 9
    CHROMA1 = 10
    CHROMA2 = 11
    CHROMA3 = 12
    CHROMA4 = 13
    CHROMA5 = 14
    CHROMA6 = 15
    CHROMA7 = 16
    CHROMA8 = 17
    CHROMA9 = 18
    CHROMA10 = 19
    CHROMA11 = 20
    CHROMA12 = 21
    CHROMA13 = 22


AnalysisIndex.FEATURES_VERSION = FeaturesVersion.VERSION2  # type: ignore


class AnalysisIndexV1(enum.IntEnum):
    """Indexes the fields of a Version1 analysis (src/song/mod.rs:163-220)."""

    TEMPO = 0
    ZCR = 1
    MEAN_SPECTRAL_CENTROID = 2
    STD_DEVIATION_SPECTRAL_CENTROID = 3
    MEAN_SPECTRAL_ROLLOFF = 4
    STD_DEVIATION_SPECTRAL_ROLLOFF = 5
    MEAN_SPECTRAL_FLATNESS = 6
    STD_DEVIATION_SPECTRAL_FLATNESS = 7
    MEAN_LOUDNESS = 8
    STD_DEVIATION_LOUDNESS = 9
    CHROMA1 = 10
    CHROMA2 = 11
    CHROMA3 = 12
    CHROMA4 = 13
    CHROMA5 = 14
    CHROMA6 = 15
    CHROMA7 = 16
    CHROMA8 = 17
    CHROMA9 = 18
    CHROMA10 = 19


AnalysisIndexV1.FEATURES_VERSION = FeaturesVersion.VERSION1  # type: ignore
