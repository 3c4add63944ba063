"""Error taxonomy, mirroring the reference bliss-rs error type
(bliss-rs src/lib.rs:236-252)."""

from __future__ import annotations


class BlissError(Exception):
    """Umbrella type for bliss error types."""


class DecodingError(BlissError):
    """An error happened while decoding an (audio) file."""

    def __str__(self) -> str:
        return f"error happened while decoding file - {self.args[0]}"


class AnalysisError(BlissError):
    """An error happened during the analysis of the song's samples."""

    def __str__(self) -> str:
        return f"error happened while analyzing file - {self.args[0]}"


class ProviderError(BlissError):
    """An error happened with the music library provider."""

    def __str__(self) -> str:
        return f"error happened with the music library provider - {self.args[0]}"
