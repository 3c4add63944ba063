"""Splitting work over devices and processes (counterpart of
bliss_tpu/parallel/): `mesh` (a list of devices: row groups of a batch, a
row-sharded library matrix), `longsong` (one very long song in time shards
over a device list) and `distributed` (processes joined by a gloo group)."""

from .mesh import (
    make_mesh,
    sharded_analyze_batch,
    sharded_closest_distances,
    sharded_top_k,
)

__all__ = [
    "make_mesh",
    "sharded_analyze_batch",
    "sharded_closest_distances",
    "sharded_top_k",
]
