"""Work spread over a list of devices (counterpart of
bliss_tpu/parallel/mesh.py).

A "mesh" here is a list of `torch.device`s; entries may repeat (two
entries of one card run two groups on it, one after the other). The JAX
package's 1-D `Mesh(("songs",))` and its `P("songs")` row sharding become
contiguous row groups, one a list entry, each on its own device:

  * batch analysis: the `[B, T]` batch splits into contiguous row groups,
    each analyzed by `analyze_tensor` on its device; songs are independent,
    so nothing crosses devices but the `[B, F]` features, in row order;
  * library distance queries: the `[N, F]` matrix is row-sharded (`N`
    padded to a multiple of the device count, `place_rows`), the seeds go
    to every device; each device computes the distances of its rows and a
    local top-k, and the host merges the candidates.

Every group is launched before any result is read back, so the cards of a
list overlap.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import AnalysisError
from ..models.analyzer import (
    MIN_SAMPLES,
    _resolve_dtype,
    analyze_tensor,
    resolve_devices,
)
from ..playlist import _batched_cosine, _batched_mahalanobis


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """The device list: `devices` (e.g. `[torch.device("cpu")] * 8`), or
    every visible card, raising without one; the first `n_devices`."""
    mesh = resolve_devices(devices)
    return mesh if n_devices is None else mesh[:n_devices]


def sharded_analyze_batch(
    mesh, batch: np.ndarray, lengths: np.ndarray, version: int = 2, dtype=None
) -> np.ndarray:
    """Analyze a `[B, T]` batch over the devices of `mesh`: contiguous row
    groups, one a device, each through `analyze_tensor` on its device;
    returns `[B, 23|20]` in row order. Any `B`: the groups' sizes differ by
    at most one, and a device with no row runs nothing."""
    mesh = list(mesh)
    dtype = _resolve_dtype(mesh[0], dtype)
    batch = np.asarray(batch, np.float32).reshape(len(batch), -1)
    lengths = np.asarray(lengths, np.int64).reshape(-1)
    if lengths.size and lengths.min() < MIN_SAMPLES:
        raise AnalysisError("empty or too short song.")
    n_feat = 23 if version == 2 else 20
    b, n = batch.shape[0], len(mesh)
    outs = []
    for i, dev in enumerate(mesh):
        lo, hi = b * i // n, b * (i + 1) // n
        if hi > lo:
            x = torch.as_tensor(batch[lo:hi], device=dev)
            n_x = torch.as_tensor(lengths[lo:hi], device=dev)
            outs.append(analyze_tensor(x, n_x, version, dtype))
    # every group is on its device before the first read-back
    return np.concatenate([o.cpu().numpy() for o in outs] or [np.zeros((0, n_feat), np.float32)])


def place_rows(mesh, matrix) -> list:
    """`matrix [N, F]` row-sharded over `mesh`: `N` zero-padded to a
    multiple of the device count (at least one row a device), one
    contiguous block of rows a device, in row order."""
    mesh = list(mesh)
    x = torch.as_tensor(matrix, dtype=torch.float32).cpu()
    shard_n = -(-max(x.shape[0], 1) // len(mesh))
    pad = shard_n * len(mesh) - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    return [x[i * shard_n : (i + 1) * shard_n].to(dev) for i, dev in enumerate(mesh)]


def block_distances(kind: str, blocks, seeds, m=None) -> list:
    """Each row block's summed distances to `seeds [K, F]` on the block's own
    device ("mahalanobis" with `m [F, F]`, euclidean being `m = I`, or
    "cosine"): the package's batched forms, ordered sums and square roots
    rounded once, so a row's distance does not depend on its block."""
    seeds = torch.as_tensor(seeds, dtype=torch.float32)
    m = None if m is None else torch.as_tensor(m, dtype=torch.float32)
    out = []
    for blk in blocks:
        s = seeds.to(blk.device)
        if kind == "cosine":
            out.append(_batched_cosine(blk, s))
        else:
            out.append(_batched_mahalanobis(blk, s, m.to(blk.device)))
    return out


def gather(pieces, device) -> torch.Tensor:
    """Per-device pieces concatenated in order on `device`."""
    return torch.cat([p.to(device) for p in pieces])


def _weights(weights, f: int) -> np.ndarray:
    return np.eye(f, dtype=np.float32) if weights is None else np.asarray(weights, np.float32)


def sharded_closest_distances(mesh, library, seeds, weights=None) -> np.ndarray:
    """`[N]` summed Mahalanobis distances (euclidean with `weights=None`) of
    every row of `library [N, F]` to `seeds [K, F]`, the rows sharded over
    `mesh`, TF32 off (the package pins it)."""
    library = np.asarray(library, np.float32)
    blocks = place_rows(mesh, library)
    d = block_distances("mahalanobis", blocks, seeds, _weights(weights, library.shape[-1]))
    return gather(d, "cpu").numpy()[: library.shape[0]]


def sharded_top_k(mesh, library, seeds, k: int, weights=None, n_real: int | None = None):
    """Top-k closest library rows to a seed set: a local top-k on each
    device's row block, then a host merge of the candidates.

    Every degenerate shape of the JAX package's contract: `N` not a
    multiple of the device count (rows are padded and never selected), `k`
    larger than a block (each block gives min(k, block rows) candidates, so
    a top-k cluster on one device comes back whole), `k > N` (clamped), and
    `n_real` for a pre-padded matrix (rows past it are padding). A matrix
    already placed (`place_rows`' list of equal blocks, one a device of
    `mesh`) is used as it is. Returns `(indices, distances)`, both
    `[min(k, N)]`, ascending, ties broken by the lower row index in each
    block (a stable sort) and in the merge."""
    mesh = list(mesh)
    placed = isinstance(library, (list, tuple))
    if placed:
        blocks = list(library)
        if len(blocks) != len(mesh) or any(b.device != d for b, d in zip(blocks, mesh)):
            raise ValueError("a placed library holds one block a device of the mesh")
        if len({b.shape[0] for b in blocks}) != 1:
            raise ValueError("a placed library's blocks are of one size")
        rows, f = sum(b.shape[0] for b in blocks), blocks[0].shape[-1]
    else:
        library = np.asarray(library, np.float32)
        rows, f = library.shape
    n = rows if n_real is None else int(n_real)
    k = min(int(k), n)
    if k <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    if n_real is not None and rows % len(mesh):
        raise ValueError(
            f"pre-padded library ({rows} rows) must be a multiple of the device "
            f"count {len(mesh)} when n_real is given"
        )
    if not placed:
        blocks = place_rows(mesh, library)
    shard_n = blocks[0].shape[0]
    k_local = min(k, shard_n)
    cands = []
    for i, d in enumerate(block_distances("mahalanobis", blocks, seeds, _weights(weights, f))):
        row = i * shard_n + torch.arange(shard_n, device=d.device)
        d = torch.where(row < n, d, torch.inf)  # padded rows lose
        # torch.topk orders equal values in no set way; a stable sort
        # puts the lower row first, as lax.top_k does
        dist, order = torch.sort(d, stable=True)
        cands.append((row[order[:k_local]], dist[:k_local]))
    idx = np.concatenate([i.cpu().numpy() for i, _ in cands])
    dist = np.concatenate([d.cpu().numpy() for _, d in cands])
    # the merge sorts by (distance, row), as a stable host argsort would
    order = np.lexsort((idx, dist))[:k]
    return idx[order], dist[order]
