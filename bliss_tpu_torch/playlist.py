"""Playlist engine: distance metrics and playlist builders (counterpart of
bliss_tpu/playlist.py; bliss-rs src/playlist.rs).

Metrics work on the whole `[N, F]` library matrix at once, as torch ops on
an explicit device (the card unless the caller asks for the CPU):

  * euclidean, cosine and Mahalanobis distances to a seed set are one
    batched product each, at full f32 precision (the package pins TF32 off),
    with every sum over the features in one fixed order, so the card and
    the CPU give the same playlists;
  * `closest_to_songs` is one distance pass and a stable sort;
  * `song_to_song` is a greedy nearest-neighbour walk kept on the device:
    on the card, blocks of its steps are captured once in a CUDA graph and
    replayed, so no step reads back to the host; the eager step loop is
    the plain version, run on the CPU;
  * the extended isolation forest is built and scored on the host (numpy).

Scalar two-vector metrics keep the reference's semantics on the host. A
set metric is a *builder* (trained on seed vectors) producing a metric,
mirroring the DistanceMetricBuilder/DistanceMetric trait pair
(src/playlist.rs:24-59).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .errors import ProviderError
from .models.analyzer import resolve_device

Vector = np.ndarray

#: Steps of the greedy walk captured in one CUDA graph.
CHAIN_BLOCK = 256


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def euclidean_distance(a: Vector, b: Vector) -> float:
    """Euclidean distance (src/playlist.rs:65-71)."""
    d = np.asarray(a, np.float32) - np.asarray(b, np.float32)
    return float(np.sqrt(np.dot(d, d)))


def cosine_distance(a: Vector, b: Vector) -> float:
    """Cosine distance (src/playlist.rs:76-79)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    sim = float(np.dot(a, b)) / float(np.sqrt(np.dot(a, a)) * np.sqrt(np.dot(b, b)))
    return 1.0 - sim


def mahalanobis_distance(a: Vector, b: Vector, m: np.ndarray) -> float:
    """Weighted distance `sqrt((a-b)ᵀ M (a-b))` (src/playlist.rs:140-142)."""
    d = np.asarray(a, np.float32) - np.asarray(b, np.float32)
    return float(np.sqrt(d @ np.asarray(m, np.float32) @ d))


def mahalanobis_distance_builder(m: np.ndarray):
    """Return a two-vector metric closing over `m` (src/playlist.rs:129-131)."""
    m = np.asarray(m, np.float32)

    def metric(a: Vector, b: Vector) -> float:
        return mahalanobis_distance(a, b, m)

    metric.weight_matrix = m  # read by the batched forms
    return metric


def variance_based_weight_matrix(seeds: Sequence[Vector]) -> np.ndarray:
    """Inverse-variance diagonal weights from seed vectors
    (src/playlist.rs:173-221)."""
    if len(seeds) < 2:
        raise ProviderError("seeds must contain more than one element")
    n = len(np.asarray(seeds[0]).ravel())
    if n == 0:
        raise ProviderError("seed feature vectors must not be empty")
    arr = []
    for s in seeds:
        v = np.asarray(s, np.float32).ravel()
        if v.shape[0] != n:
            raise ProviderError("all seed feature vectors must have the same length")
        arr.append(v)
    mat = np.stack(arr)
    variance = mat.var(axis=0)  # population variance
    weights = 1.0 / (variance + 1e-6)
    weights *= n / weights.sum()
    return np.diag(weights).astype(np.float32)


def _gemm_form(func, n_features: int):
    """("mahalanobis", M) for the weighted metrics and for euclidean (M = I),
    ("cosine", None) for cosine, None for a metric with no batched form."""
    m = getattr(func, "weight_matrix", None)
    if m is not None:
        return "mahalanobis", np.asarray(m, np.float32)
    if func is euclidean_distance:
        return "mahalanobis", np.eye(n_features, dtype=np.float32)
    if func is cosine_distance:
        return "cosine", None
    return None


# ---------------------------------------------------------------------------
# Metric builder protocol
# ---------------------------------------------------------------------------


class DistanceMetricBuilder:
    """Builds a trained metric measuring distance *to a set of vectors*."""

    def build(self, vectors: Sequence[Vector]) -> "DistanceMetric":
        raise NotImplementedError


class DistanceMetric:
    def distance(self, vector: Vector) -> float:
        raise NotImplementedError

    def distances(self, matrix: np.ndarray) -> np.ndarray:
        """Distances of the rows of an `[N, F]` matrix; this default scores
        row by row with `distance`, on the host."""
        return np.array([self.distance(v) for v in matrix], np.float32)


class FunctionDistanceMetric(DistanceMetric):
    """Sum of a plain two-vector metric over the seed set
    (src/playlist.rs:36-59). `distances` computes the metrics that have a
    batched form on the device of a tensor it is given, and on `device` for
    a numpy array (returning numpy)."""

    def __init__(self, func: Callable, vectors: Sequence[Vector], device="cuda"):
        self.func = func
        self.vectors = [np.asarray(v, np.float32) for v in vectors]
        self.device = device

    def distance(self, vector: Vector) -> float:
        return float(sum(self.func(v, vector) for v in self.vectors))

    def distances(self, matrix):
        form = _gemm_form(self.func, matrix.shape[-1])
        if form is None:
            return super().distances(matrix)
        is_tensor = isinstance(matrix, torch.Tensor)
        dev = matrix.device if is_tensor else resolve_device(self.device)
        x = torch.as_tensor(matrix, dtype=torch.float32, device=dev)
        seeds = torch.as_tensor(np.stack(self.vectors), device=dev)
        kind, m = form
        if kind == "cosine":
            out = _batched_cosine(x, seeds)
        else:
            out = _batched_mahalanobis(x, seeds, torch.as_tensor(m, device=dev))
        return out if is_tensor else out.cpu().numpy()


def _as_builder(metric, device="cuda") -> DistanceMetricBuilder:
    """Plain callables auto-implement the builder (src/playlist.rs:41-51);
    their batched distances run on `device`."""
    if isinstance(metric, DistanceMetricBuilder):
        return metric

    class _FnBuilder(DistanceMetricBuilder):
        def build(self, vectors):
            return FunctionDistanceMetric(metric, vectors, device)

    return _FnBuilder()


def _ordered_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension, left to right. A reduction kernel sums
    in another order on the card than on the CPU; in one fixed order the
    two round a row's sum alike, so with `_sqrt` both give the same
    distances, orders and dedup verdicts bit for bit (with a diagonal
    weight matrix, whose product is exact on both)."""
    acc = t[..., 0]
    for f in range(1, t.shape[-1]):
        acc = acc + t[..., f]
    return acc


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """The f32 square root rounded once, on every device: PyTorch's
    vectorized f32 `sqrt` on the CPU is off by an ulp for some inputs;
    through f64 it rounds as the card's does."""
    return torch.sqrt(t.double()).float()


def _batched_mahalanobis(x: torch.Tensor, seeds: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Σ_seeds sqrt((x-s)ᵀM(x-s)) for every row of `x` `[N, F]`: one
    `[N, K, F] @ [F, F]` product and ordered sums (the JAX package's
    `einsum("nkf,fg,nkg->nk")`)."""
    d = x[:, None, :] - seeds[None, :, :]
    q = _ordered_sum(torch.matmul(d, m) * d)
    return _ordered_sum(_sqrt(torch.clamp_min(q, 0.0)))


def _batched_cosine(x: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    xn = _sqrt(_ordered_sum(x * x))
    sn = _sqrt(_ordered_sum(seeds * seeds))
    sim = _ordered_sum(x[:, None, :] * seeds[None, :, :]) / (xn[:, None] * sn[None, :])
    return _ordered_sum(1.0 - sim)


def _order_dedup(kind: str, mat, dists, m, mask, meta_ids, threshold: float):
    """The device half of `Library.playlist_from`'s dedup: from the seed
    distances `dists [N]` (`_batched_mahalanobis` / `_batched_cosine` of
    each row block) -> masked stable argsort -> row gather -> consecutive-
    pair distances -> dedup verdicts, as one function of torch ops on
    `mat`'s device. Returns `order` (int64 `[N]`) and one verdict per
    consecutive pair (bool `[N-1]`), both on the device.

    `kind` is "mahalanobis" (euclidean rides it with an identity `m`) or
    "cosine". A verdict is src/playlist.rs:367-402's: pair distance below
    `threshold`, or equal non-null (title, artist), which `meta_ids` holds
    as integers (equal ids == equal pairs; -1 == any None)."""
    masked = torch.where(mask, dists, torch.inf)
    order = torch.argsort(masked, stable=True)
    g = mat.index_select(0, order)
    a, b = g[:-1], g[1:]
    if kind == "cosine":
        na = _sqrt(_ordered_sum(a * a))
        nb = _sqrt(_ordered_sum(b * b))
        pair = 1.0 - _ordered_sum(a * b) / (na * nb)
    else:
        dd = a - b
        pair = _sqrt(torch.clamp_min(_ordered_sum(torch.matmul(dd, m) * dd), 0.0))
    mid = meta_ids.index_select(0, order)
    same = (pair < threshold) | ((mid[:-1] == mid[1:]) & (mid[:-1] >= 0))
    return order, same


def _dedup_walk_runs(n: int, base_same: np.ndarray, scalar_same) -> np.ndarray:
    """The dedup walk of `dedup_playlist_custom_distance`, on INDICES:
    returns the kept positions in [0, n) given precomputed consecutive
    verdicts `base_same` ([n-1] bool) and a `scalar_same(i, j)` resolver
    for the non-consecutive rechecks that follow a drop (where `current`
    stays put). Same verdict order as the list walk; the caller
    materializes the songs."""
    if n <= 0:
        return np.arange(0)
    flagged = np.flatnonzero(base_same)
    if not len(flagged):
        return np.arange(n)
    runs = []
    cur = 0
    fi = 0
    while cur < n - 1:
        while fi < len(flagged) and flagged[fi] < cur:
            fi += 1
        stop = int(flagged[fi]) if fi < len(flagged) else n - 1
        if stop > cur:
            runs.append(np.arange(cur, stop))
        cur = stop
        if cur >= n - 1:
            break
        nxt = cur + 2
        while nxt < n and scalar_same(cur, nxt):
            nxt += 1
        if nxt >= n:
            break
        runs.append(np.arange(cur, cur + 1))
        cur = nxt
    runs.append(np.arange(cur, cur + 1))
    return np.concatenate(runs)


# ---------------------------------------------------------------------------
# Extended isolation forest (set metric), on the host
# ---------------------------------------------------------------------------


class ForestOptions(DistanceMetricBuilder):
    """Extended-isolation-forest metric builder (src/playlist.rs:230-251):
    `n_trees` hyperplane-split trees over a bootstrap-free subsample; the
    *distance* is the anomaly score `2^(-avg_path/c(n))`, smaller meaning
    "more like the seed set"."""

    def __init__(
        self,
        n_trees: int = 1000,
        sample_size: int = 200,
        max_tree_depth: Optional[int] = None,
        extension_level: int = 10,
        seed: int = 0,
    ):
        self.n_trees = n_trees
        self.sample_size = sample_size
        self.max_tree_depth = max_tree_depth
        self.extension_level = extension_level
        self.seed = seed

    def build(self, vectors: Sequence[Vector]) -> "IsolationForest":
        sample_size = min(self.sample_size, len(vectors))
        return IsolationForest(
            np.stack([np.asarray(v, np.float64) for v in vectors]),
            n_trees=self.n_trees,
            sample_size=sample_size,
            max_tree_depth=self.max_tree_depth,
            extension_level=self.extension_level,
            seed=self.seed,
        )


def _harmonic(n: float) -> float:
    return np.log(n) + np.euler_gamma


def _c_factor(n: int) -> float:
    """Average unsuccessful BST search path length."""
    if n <= 1:
        return 0.0
    return 2.0 * _harmonic(n - 1.0) - (2.0 * (n - 1.0) / n)


class IsolationForest(DistanceMetric):
    """Extended isolation forest on the host: trees built from a seeded
    numpy generator (sample_size <= 200), scoring vectorized over a whole
    `[N, F]` numpy matrix."""

    def __init__(
        self,
        data: np.ndarray,
        n_trees: int,
        sample_size: int,
        max_tree_depth: Optional[int],
        extension_level: int,
        seed: int,
    ):
        n, dim = data.shape
        if extension_level >= dim:
            extension_level = dim - 1
        self.dim = dim
        depth_limit = max_tree_depth or int(np.ceil(np.log2(max(sample_size, 2))))
        rng = np.random.default_rng(seed)
        self.c_n = _c_factor(sample_size)
        self.trees = []
        for _ in range(n_trees):
            idx = rng.choice(n, size=min(sample_size, n), replace=False)
            self.trees.append(self._build_tree(data[idx], rng, 0, depth_limit, extension_level))

    def _build_tree(self, x, rng, depth, limit, ext):
        n = x.shape[0]
        if depth >= limit or n <= 1:
            size = 0.0 if n <= 1 else _c_factor(n)
            return ("leaf", depth + size)
        normal = rng.normal(size=self.dim)
        zero_idx = rng.choice(self.dim, size=self.dim - ext - 1, replace=False)
        normal[zero_idx] = 0.0
        mins, maxs = x.min(axis=0), x.max(axis=0)
        point = rng.uniform(mins, maxs)
        side = (x - point) @ normal
        left, right = x[side < 0], x[side >= 0]
        if len(left) == 0 or len(right) == 0:
            return ("leaf", depth + _c_factor(n))
        return (
            "node",
            normal,
            point,
            self._build_tree(left, rng, depth + 1, limit, ext),
            self._build_tree(right, rng, depth + 1, limit, ext),
        )

    def _path_lengths(self, tree, x: np.ndarray, out: np.ndarray, mask):
        if tree[0] == "leaf":
            out[mask] += tree[1]
            return
        _, normal, point, left, right = tree
        side = (x[mask] - point) @ normal
        idx = np.flatnonzero(mask)
        lmask = np.zeros_like(mask)
        rmask = np.zeros_like(mask)
        lmask[idx[side < 0]] = True
        rmask[idx[side >= 0]] = True
        if lmask.any():
            self._path_lengths(left, x, out, lmask)
        if rmask.any():
            self._path_lengths(right, x, out, rmask)

    def distances(self, matrix: np.ndarray) -> np.ndarray:
        x = np.asarray(matrix, np.float64)
        total = np.zeros(x.shape[0])
        full = np.ones(x.shape[0], bool)
        for tree in self.trees:
            self._path_lengths(tree, x, total, full)
        avg = total / len(self.trees)
        if self.c_n <= 0:
            return np.full(x.shape[0], 0.5, np.float32)
        return (2.0 ** (-avg / self.c_n)).astype(np.float32)

    def distance(self, vector: Vector) -> float:
        return float(self.distances(np.asarray(vector)[None, :])[0])


# ---------------------------------------------------------------------------
# Playlist builders
# ---------------------------------------------------------------------------


def _song_matrix(songs) -> np.ndarray:
    return np.stack([np.asarray(s.analysis.as_arr1(), np.float32) for s in songs])


def closest_to_songs(initial_songs, candidate_songs, metric_builder, device="cuda"):
    """Sort `candidate_songs` by distance to `initial_songs`
    (src/playlist.rs:256-270), the distances on `device`. Returns a new
    sorted list."""
    dev = resolve_device(device)
    candidates = list(candidate_songs)
    if not candidates:
        return []
    builder = _as_builder(metric_builder, dev)
    metric = builder.build([s.analysis.as_arr1() for s in initial_songs])
    dists = metric.distances(_song_matrix(candidates))
    order = np.argsort(dists, kind="stable")
    return [candidates[i] for i in order]


def song_to_song(initial_songs, candidate_songs, metric_builder, device="cuda"):
    """Greedy nearest-neighbour chain (src/playlist.rs:272-326).

    With a function metric that has a batched form, the walk after the
    first pick runs on `device` (`_device_greedy_chain`); a builder metric
    re-trains on each step, as the reference does."""
    dev = resolve_device(device)
    pool = list(candidate_songs)
    if not pool:
        return []
    builder = _as_builder(metric_builder, dev)
    out = []
    mat = _song_matrix(pool)
    alive = np.ones(len(pool), bool)

    # first pick: distance to all the initial songs
    metric = builder.build([s.analysis.as_arr1() for s in initial_songs])
    d = metric.distances(mat)
    idx = int(np.argmin(d))
    alive[idx] = False
    out.append(pool[idx])

    is_pure_fn = not isinstance(metric_builder, DistanceMetricBuilder)
    if is_pure_fn and len(pool) > 1:
        order = _device_greedy_chain(mat, idx, metric_builder, alive, dev)
        if order is not None:
            out.extend(pool[i] for i in order)
            return out
        # a function metric with no batched form: its pairwise matrix
        pair = _pairwise_matrix(mat, metric_builder, dev)
        cur = idx
        for _ in range(len(pool) - 1):
            row = np.where(alive, pair[cur], np.inf)
            cur = int(np.argmin(row))
            alive[cur] = False
            out.append(pool[cur])
    else:
        while alive.any():
            metric = builder.build([out[-1].analysis.as_arr1()])
            d = np.where(alive, metric.distances(mat), np.inf)
            nxt = int(np.argmin(d))
            alive[nxt] = False
            out.append(pool[nxt])
    return out


def _chain_rows(x: torch.Tensor, metric):
    """`dist_row(cur)`: the distances of every row of `x` to row `cur` (a
    `[1]` int64 tensor) by `metric`, a metric with a batched form, in the
    JAX package's expanded form `q + vᵀMv − 2·(xM)·v` with `xM` and `q`
    formed once."""
    kind, m = _gemm_form(metric, x.shape[1])
    if kind == "cosine":
        norms = torch.sqrt((x * x).sum(1))

        def dist_row(cur):
            v = x.index_select(0, cur)[0]
            sim = torch.mv(x, v) / (norms * torch.sqrt(torch.dot(v, v)))
            return 1.0 - sim

        return dist_row
    mm = torch.as_tensor(m, device=x.device)
    xm = torch.matmul(x, mm)
    q = (xm * x).sum(1)  # x_i^T M x_i

    def dist_row(cur):
        v = x.index_select(0, cur)[0]
        quad = q + torch.dot(torch.matmul(v, mm), v) - 2.0 * torch.mv(xm, v)
        return torch.sqrt(torch.clamp_min(quad, 0.0))

    return dist_row


def _chain_steps(dist_row, alive: torch.Tensor, cur: torch.Tensor, out: torch.Tensor) -> None:
    """`len(out)` steps of the walk from row `cur` (`[1]` int64): each step
    picks the nearest live row (the first on ties), marks it dead and
    writes it to `out`. Past the last live row a step picks row 0 and
    changes nothing."""
    for j in range(out.shape[0]):
        d = torch.where(alive, dist_row(cur), torch.inf)
        nxt = out[j : j + 1]
        torch.argmin(d, dim=0, keepdim=True, out=nxt)
        alive.index_fill_(0, nxt, False)
        cur = nxt


def _greedy_chain_plain(x: torch.Tensor, start: int, metric, alive: torch.Tensor, steps: int):
    """The walk as an eager step loop on `x`'s device (the plain version):
    `steps` indices, an int64 tensor on that device. `alive` is consumed."""
    dist_row = _chain_rows(x, metric)
    out = torch.empty(steps, dtype=torch.int64, device=x.device)
    cur = torch.full((1,), start, dtype=torch.int64, device=x.device)
    _chain_steps(dist_row, alive, cur, out)
    return out


def _greedy_chain_graph(x: torch.Tensor, start: int, metric, alive: torch.Tensor, steps: int,
                        block: int = CHAIN_BLOCK):
    """The same walk on the card: `block` steps captured once in a CUDA
    graph, replayed `ceil(steps / block)` times; the indices stay on the
    device. `alive` is consumed."""
    dist_row = _chain_rows(x, metric)
    block = max(1, min(block, steps))
    n_blocks = -(-steps // block)
    out = torch.empty(n_blocks * block, dtype=torch.int64, device=x.device)
    cur = torch.full((1,), start, dtype=torch.int64, device=x.device)
    blk = torch.empty(block, dtype=torch.int64, device=x.device)
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):  # warm-up on copies: the state stays as it is
        _chain_steps(dist_row, alive.clone(), cur.clone(), torch.empty_like(blk[:2]))
    torch.cuda.current_stream(x.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _chain_steps(dist_row, alive, cur, blk)
        cur.copy_(blk[-1:])
    for k in range(n_blocks):
        graph.replay()
        out[k * block : (k + 1) * block].copy_(blk)
    return out[:steps]


def _device_greedy_chain(mat, start_idx: int, metric, alive0, device="cuda"):
    """The greedy nearest-neighbour walk from row `start_idx` over the rows
    `alive0` marks, on `device` (a tensor `mat` stays where it is): one
    distance row and a masked argmin a step, O(N) memory, and only the
    index sequence leaves the device. On the card the steps replay as a
    CUDA graph (`_greedy_chain_graph`); on the CPU they run eagerly.
    Returns a list, or None for metrics with no batched form."""
    if _gemm_form(metric, mat.shape[1]) is None:
        return None
    dev = mat.device if isinstance(mat, torch.Tensor) else resolve_device(device)
    x = torch.as_tensor(mat, dtype=torch.float32, device=dev)
    alive = torch.as_tensor(alive0, dtype=torch.bool, device=dev).clone()
    steps = int(alive.sum())
    if steps == 0:
        return []
    chain = _greedy_chain_graph if dev.type == "cuda" else _greedy_chain_plain
    return chain(x, int(start_idx), metric, alive, steps).tolist()


def _pairwise_matrix(mat: np.ndarray, metric, device="cuda") -> np.ndarray:
    """[N, N] pairwise distances, one product on `device` for the metrics
    with a batched form, two-vector calls on the host otherwise."""
    form = _gemm_form(metric, mat.shape[-1])
    if form is None:
        n = mat.shape[0]
        out = np.zeros((n, n), np.float32)
        for i in range(n):
            for j in range(n):
                out[i, j] = metric(mat[i], mat[j])
        return out
    dev = resolve_device(device)
    x = torch.as_tensor(mat, dtype=torch.float32, device=dev)
    kind, m = form
    if kind == "cosine":
        n = torch.sqrt((x * x).sum(1))
        out = 1.0 - torch.matmul(x, x.T) / (n[:, None] * n[None, :])
    else:
        # (a-b)ᵀM(a-b) = aᵀMa + bᵀMb - 2aᵀMb: norms and one product
        xm = torch.matmul(x, torch.as_tensor(m, device=dev))
        q = (xm * x).sum(1)
        cross = torch.matmul(xm, x.T)
        out = torch.sqrt(torch.clamp_min(q[:, None] + q[None, :] - 2.0 * cross, 0.0))
    return out.cpu().numpy()


def dedup_playlist(playlist, distance_threshold: Optional[float] = None):
    """Drop consecutive near-duplicates using euclidean distance
    (src/playlist.rs:343-348)."""
    return dedup_playlist_custom_distance(playlist, distance_threshold, euclidean_distance)


def _rowwise_distances(a: np.ndarray, b: np.ndarray, metric):
    """dist(a[i], b[i]) on the host for the metrics with a batched form, or
    None."""
    m = getattr(metric, "weight_matrix", None)
    if metric is euclidean_distance:
        d = a - b
        return np.sqrt(np.sum(d * d, axis=1))
    if m is not None:
        d = a - b
        return np.sqrt(np.maximum(np.sum((d @ m) * d, axis=1), 0.0))
    if metric is cosine_distance:
        na = np.sqrt(np.sum(a * a, axis=1))
        nb = np.sqrt(np.sum(b * b, axis=1))
        return 1.0 - np.sum(a * b, axis=1) / (na * nb)
    return None


def dedup_playlist_custom_distance(
    playlist, distance_threshold: Optional[float], metric_builder,
    matrix: Optional[np.ndarray] = None, metadata=None,
):
    """Drop consecutive songs closer than `distance_threshold` (default
    0.05) or sharing a non-empty title+artist (src/playlist.rs:367-402).
    Returns a list. Runs on the host.

    For the function metrics with a batched form (and playlists over 64
    songs) every consecutive-pair distance is computed in one vectorized
    pass; scalar rechecks happen only after a drop, where `current` stays
    put and the precomputed pair no longer applies.

    `matrix` / `metadata` are inputs for callers that already hold a
    columnar view of the playlist (the `Library` passes its cached feature
    matrix): `matrix` is the playlist's `[N, F]` vectors with row i =
    playlist[i], `metadata` its `(titles, artists)` pair of length-N object
    arrays. Both are optional, consulted only on the vectorized path, and
    checked against the playlist's length."""
    threshold = 0.05 if distance_threshold is None else distance_threshold
    builder = _as_builder(metric_builder)
    playlist = list(playlist)
    if not playlist:
        return []
    if matrix is not None and len(matrix) != len(playlist):
        raise ProviderError(
            f"dedup matrix has {len(matrix)} rows for a {len(playlist)}-song playlist"
        )
    if metadata is not None and (
        len(metadata) != 2
        or len(metadata[0]) != len(playlist)
        or len(metadata[1]) != len(playlist)
    ):
        raise ProviderError(
            "dedup metadata must be (titles, artists) arrays matching the playlist length"
        )

    consecutive = None
    if not isinstance(metric_builder, DistanceMetricBuilder) and len(playlist) > 64:
        mat = matrix if matrix is not None else _song_matrix(playlist)
        consecutive = _rowwise_distances(mat[:-1], mat[1:], metric_builder)

    def pair_distance(i_cur, i_nxt):
        if consecutive is not None and i_nxt == i_cur + 1:
            return float(consecutive[i_cur])
        metric = builder.build([playlist[i_cur].analysis.as_arr1()])
        return metric.distance(playlist[i_nxt].analysis.as_arr1())

    def scalar_same(i_cur, i_nxt):
        return pair_distance(i_cur, i_nxt) < threshold or _same_meta(
            playlist[i_cur], playlist[i_nxt]
        )

    n = len(playlist)
    if consecutive is None:
        out = []
        cur = 0
        for nxt in range(1, n):
            if not scalar_same(cur, nxt):
                out.append(playlist[cur])
                cur = nxt
        out.append(playlist[cur])
        return out

    if metadata is not None:
        titles_a = np.asarray(metadata[0], object)
        artists_a = np.asarray(metadata[1], object)
    else:
        titles_a = np.empty(n, object)
        artists_a = np.empty(n, object)
        for i, s in enumerate(playlist):
            titles_a[i] = s.title
            artists_a[i] = s.artist
    not_none = (
        (titles_a[:-1] != None)  # noqa: E711 — elementwise on object
        & (titles_a[1:] != None)  # noqa: E711
        & (artists_a[:-1] != None)  # noqa: E711
        & (artists_a[1:] != None)  # noqa: E711
    )
    meta = not_none & (titles_a[:-1] == titles_a[1:]) & (artists_a[:-1] == artists_a[1:])
    base_same = (np.asarray(consecutive) < threshold) | meta
    if not base_same.any():
        return playlist
    return [playlist[i] for i in _dedup_walk_runs(n, base_same, scalar_same)]


def _same_meta(a, b) -> bool:
    """Equal, non-null title and artist (src/playlist.rs:377-383)."""
    return (
        a.title is not None
        and b.title is not None
        and a.artist is not None
        and b.artist is not None
        and a.title == b.title
        and a.artist == b.artist
    )


def closest_album_to_group(group, pool):
    """Album-level playlist: rank albums by the euclidean distance of their
    mean vector to the group's mean vector (src/playlist.rs:424-485). Runs
    on the host."""
    group = list(group)
    pool = [s for s in pool if all(s != g for g in group)]
    if not group:
        raise ProviderError("Mean of empty slice")

    albums = {}
    for song in pool:
        if song.album is not None:
            albums.setdefault(song.album, []).append(song)

    group_mean = _song_matrix(group).mean(axis=0)
    ranked = sorted(
        albums.items(),
        key=lambda kv: euclidean_distance(group_mean, _song_matrix(kv[1]).mean(axis=0)),
    )
    playlist = list(group)

    def opt_key(v):
        # Rust Option ordering: None < Some(x) (src/playlist.rs:475-481)
        return (0, 0) if v is None else (1, v)

    for album, songs in ranked:
        songs = sorted(songs, key=lambda s: (opt_key(s.disc_number), opt_key(s.track_number)))
        playlist.extend(songs)
    return playlist
