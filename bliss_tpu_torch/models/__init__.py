"""Descriptor models of the analysis: timbral, loudness, tempo, chroma."""

from .analyzer import analyze_samples, build_analyzer

__all__ = ["analyze_samples", "build_analyzer"]
