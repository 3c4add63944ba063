"""Analysis, AnalysisOptions and Song (counterpart of bliss_tpu/song.py):
a versioned feature vector, the song record that carries it with its
metadata, and the entry points that compute it from decoded samples on
`device` (the card unless the caller asks for the CPU). Distances and
playlists are not part of this package yet."""

from __future__ import annotations

import os
import pathlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .errors import ProviderError
from .features import FeaturesVersion


@dataclass
class CueInfo:
    """Where a CUE-extracted song comes from (src/cue.rs:32-44)."""

    cue_path: pathlib.Path
    audio_file_path: pathlib.Path


@dataclass
class AnalysisOptions:
    """Options for the analysis of songs (src/song/mod.rs:252-269)."""

    features_version: FeaturesVersion = None  # type: ignore[assignment]
    number_cores: int = 0

    def __post_init__(self):
        if self.features_version is None:
            self.features_version = FeaturesVersion.latest()
        if isinstance(self.features_version, int) and not isinstance(
            self.features_version, FeaturesVersion
        ):
            self.features_version = FeaturesVersion.from_int(
                self.features_version
            )
        if self.number_cores <= 0:
            self.number_cores = os.cpu_count() or 1


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


@dataclass
class Song:
    """An analyzed song with its metadata (src/song/mod.rs:41-76)."""

    path: pathlib.Path = field(default_factory=lambda: pathlib.Path(""))
    artist: Optional[str] = None
    title: Optional[str] = None
    album: Optional[str] = None
    album_artist: Optional[str] = None
    track_number: Optional[int] = None
    disc_number: Optional[int] = None
    genre: Optional[str] = None
    analysis: Optional[Analysis] = None
    duration: float = 0.0  # seconds
    features_version: FeaturesVersion = None  # type: ignore[assignment]
    cue_info: Optional[CueInfo] = None

    def __post_init__(self):
        if self.features_version is None:
            self.features_version = FeaturesVersion.latest()
        self.path = pathlib.Path(self.path)

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

    @staticmethod
    def analyze_with_options(
        sample_array, analysis_options: AnalysisOptions, device="cuda"
    ) -> Analysis:
        """Like `analyze`, with the options' features version
        (src/song/mod.rs:412-508)."""
        return Song.analyze(sample_array, analysis_options.features_version, device)
