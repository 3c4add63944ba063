"""Descriptor models of the analysis: timbral, loudness, tempo, chroma."""
