"""Feature versioning (bliss-rs src/lib.rs:142-234)."""

from __future__ import annotations

import enum

from .errors import ProviderError

SAMPLE_RATE = 22050
CHANNELS = 1


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
