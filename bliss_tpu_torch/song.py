"""Analysis, AnalysisOptions and Song (counterpart of bliss_tpu/song.py):
a versioned feature vector, the song record that carries it with its
metadata, and the entry points that compute it from decoded samples on
`device` (the card unless the caller asks for the CPU). The distance
between two analyses is a scalar on the host, as in the JAX package;
batched distances and playlists are in `playlist.py`."""

from __future__ import annotations

import os
import pathlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .errors import ProviderError
from .features import AnalysisIndex, AnalysisIndexV1, FeaturesVersion


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

    @classmethod
    def _unchecked(cls, vec: np.ndarray, features_version) -> "Analysis":
        """Wrap a validated f32 row without conversion: the library's bulk
        loader builds one per song of the cached matrix."""
        self = cls.__new__(cls)
        self._vec = vec
        self.features_version = features_version
        return self

    def as_vec(self) -> list:
        return [float(x) for x in self._vec]

    def as_arr1(self) -> np.ndarray:
        return self._vec.copy()

    def __getitem__(self, index) -> float:
        if isinstance(index, (AnalysisIndex, AnalysisIndexV1)):
            if self.features_version != type(index).FEATURES_VERSION:
                raise IndexError("Tried to index features with incompatible indexes")
            return float(self._vec[int(index)])
        return float(self._vec[index])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Analysis)
            and self.features_version == other.features_version
            and np.array_equal(self._vec, other._vec)
        )

    def __repr__(self) -> str:
        """The reference's `fmt::Debug` (src/song/mod.rs:294-324): named
        fields, then the raw vector in a `/* [...] */` trailer, each float
        in Rust's shortest round-trip f32 notation."""
        raw = ", ".join(_f32_debug(x) for x in self._vec)
        if len(self._vec) != self.features_version.feature_count:
            return f"Analysis (Version ?) /* [{raw}] */"
        names = (
            AnalysisIndex
            if self.features_version == FeaturesVersion.VERSION2
            else AnalysisIndexV1
        )
        fields = ", ".join(
            f"{_camel(name.name)}: {_f32_debug(self._vec[name.value])}" for name in names
        )
        return f"Analysis (Version {int(self.features_version)}) {{ {fields} }} /* [{raw}] */"

    def distance(self, other: "Analysis") -> float:
        """Distance by the version's default metric (src/song/mod.rs:364-370);
        raises on mismatched versions."""
        if self.features_version != other.features_version:
            raise ProviderError("Mismatched features version between two songs or analysis")
        metric = self.features_version.distance_metric()
        return float(metric(self.as_arr1(), other.as_arr1()))


def _f32_debug(x) -> str:
    """Rust `{:?}` of an f32: the shortest decimal that round-trips, always
    with a fractional part (1 -> "1.0")."""
    return np.format_float_positional(np.float32(x), unique=True, trim="0")


def _camel(name: str) -> str:
    """TEMPO -> Tempo, MEAN_SPECTRAL_CENTROID -> MeanSpectralCentroid."""
    return "".join(part.capitalize() for part in name.split("_"))


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

    def distance(self, other: "Song") -> float:
        """Distance of the two songs' analyses (src/song/mod.rs:193-201)."""
        if self.analysis is None or other.analysis is None:
            raise ProviderError(
                "tried to compute the distance of a song that has not been analyzed"
            )
        return self.analysis.distance(other.analysis)
