"""Work spread over the processes of a cluster (counterpart of
bliss_tpu/parallel/distributed.py).

Every exchange of the JAX package's multi-host layer is host-level
(`multihost_utils.process_allgather`, `sync_global_devices`): a few
integers a round, the top-k candidates, barriers. No device array crosses
processes. So the port sends these exchanges through a `torch.distributed`
**gloo** group on CPU tensors, on the card too: gloo needs no card, and
two processes can share one card, which NCCL refuses. Each process
analyzes its own rows on its own device list (a "mesh",
`parallel.mesh.make_mesh`), as on one host.

`initialize` joins the group at a `tcp://` address given as an argument
(never `env://`); `timeout_seconds` bounds how long a collective waits for
a peer, the JAX package's heartbeat timeout. A peer that dies closes its
sockets, and the survivors' next collective raises.

`update_library_distributed` is the integrated driver (the reference's
src/library.rs:1000-1093 + 1187-1293): one deterministic set-difference
work list on every process, a round-robin slice each, synchronized
analysis rounds, and every process storing its own rows, each song in its
own transaction, into one shared SQLite database, once its analysis
rounds are done.
"""

from __future__ import annotations

import datetime
import pathlib

import numpy as np
import torch
import torch.distributed as dist

from .mesh import sharded_analyze_batch, sharded_top_k


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    timeout_seconds: float | None = None,
) -> None:
    """Join (or form) the cluster's gloo group at `coordinator_address`
    ("host:port" or "tcp://host:port"; process 0 listens there).
    `timeout_seconds` bounds every wait on a peer (torch's default, 30
    minutes, when None)."""
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    if not address.startswith("tcp://"):
        raise ValueError(f"coordinator address {coordinator_address!r}: tcp://host:port expected")
    kwargs = {}
    if timeout_seconds is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_seconds)
    dist.init_process_group(
        "gloo", init_method=address, world_size=num_processes, rank=process_id, **kwargs
    )


def shutdown() -> None:
    """Leave the group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_allgather(x) -> np.ndarray:
    """`[P, *x.shape]`: every process's `x` (one shape on every process), in
    process order."""
    t = torch.as_tensor(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def barrier() -> None:
    """Every process waits for all the others (`sync_global_devices`)."""
    dist.barrier()


def analyze_batch_distributed(
    mesh, local_batch: np.ndarray, local_lengths: np.ndarray, version: int = 2
) -> np.ndarray:
    """Analyze this process's `[B_local, T_local]` songs on its devices
    `mesh`; returns `[B_local, n_features]`.

    Collective: every process calls it together, with RAGGED row counts
    (zero included) and pad lengths. One all-gather of `(B_local, T_local)`
    agrees the envelope; each process pads its rows to the global `T` and
    analyzes its own rows only."""
    from ..models.analyzer import MIN_SAMPLES

    local_batch = np.asarray(local_batch, np.float32)
    if local_batch.ndim != 2:
        local_batch = local_batch.reshape(local_batch.shape[0], -1)
    b_local = local_batch.shape[0]
    t_local = local_batch.shape[1] if b_local else 0
    info = process_allgather(np.array([b_local, t_local], np.int64))
    t_glob = max(int(info[:, 1].max()), MIN_SAMPLES)
    n_feat = 23 if version == 2 else 20
    if b_local == 0:
        return np.zeros((0, n_feat), np.float32)
    batch = np.zeros((b_local, t_glob), np.float32)
    batch[:, :t_local] = local_batch
    return sharded_analyze_batch(mesh, batch, local_lengths, version)


def top_k_distributed(
    mesh,
    local_rows: np.ndarray,
    row_offset: int,
    n_total: int,
    seeds: np.ndarray,
    k: int,
    weights: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Global top-k over a library whose rows live per process.

    Each process passes its `[N_local, F]` rows (`row_offset` = global index
    of its first row) and computes their top-k on its devices
    (`sharded_top_k`); its k candidates, padded to k with (`n_total`, inf),
    cross the group in one all-gather, and every process merges them the
    same way. Returns identical `(indices, distances)` on every process,
    ascending, ties broken by global row index."""
    k = min(int(k), int(n_total))
    if k <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    local_rows = np.asarray(local_rows, np.float32)
    ids = np.full(k, n_total, np.int64)
    dists = np.full(k, np.inf, np.float32)
    if local_rows.shape[0]:
        idx, d = sharded_top_k(mesh, local_rows, seeds, k, weights)
        ids[: len(idx)] = idx + row_offset
        dists[: len(d)] = d
    all_ids = process_allgather(ids).reshape(-1)
    all_d = process_allgather(dists).reshape(-1)
    order = np.lexsort((all_ids, all_d))[:k]
    return all_ids[order], all_d[order]


def analyze_paths_distributed(
    decoder_cls,
    local_paths,
    mesh,
    analysis_options=None,
    round_size: int = 8,
):
    """Analyze this process's slice of a song list on its devices `mesh`.

    Collective: every process calls with ITS paths (ragged counts fine,
    CUE sheets fan out). Decode runs in the process; analysis runs in
    synchronized rounds of at most `round_size` songs a process (a process
    that has run out sends empty rounds, so the collectives stay matched).
    Returns `[(path, Song | BlissError)]` for the local slice."""
    from ..errors import AnalysisError, BlissError, DecodingError
    from ..io.batch import _decode_cue, _Decoded, _make_song
    from ..models.analyzer import MIN_SAMPLES, bucket_length
    from ..song import AnalysisOptions

    opts = analysis_options or AnalysisOptions()
    version = int(opts.features_version)
    results: list = []
    ok: list = []
    for path in map(pathlib.Path, local_paths):
        try:
            if path.suffix.lower() == ".cue":
                entries = _decode_cue(decoder_cls, path, 0)
            else:
                entries = [_Decoded(0, path, raw=decoder_cls.decode(path))]
        except BlissError as e:
            entries = [_Decoded(0, path, error=e)]
        except Exception as e:  # pragma: no cover - defensive
            entries = [_Decoded(0, path, error=DecodingError(str(e)))]
        for d in entries:
            if d.error is not None:
                results.append((d.path, d.error))
                continue
            d.n = int(d.raw.sample_array.shape[0])
            if d.n < MIN_SAMPLES:
                results.append((d.path, AnalysisError("empty or too short song.")))
                continue
            ok.append(d)

    counts = process_allgather(np.array([len(ok)], np.int64))
    n_rounds = -(-int(counts.max()) // round_size)
    for r in range(n_rounds):
        chunk = ok[r * round_size : (r + 1) * round_size]
        t = max((bucket_length(d.n) for d in chunk), default=MIN_SAMPLES)
        batch = np.zeros((len(chunk), t), np.float32)
        lengths = np.zeros((len(chunk),), np.int64)
        for i, d in enumerate(chunk):
            batch[i, : d.n] = d.raw.sample_array
            d.raw.sample_array = None  # bound host RAM a round
            lengths[i] = d.n
        feats = analyze_batch_distributed(mesh, batch, lengths, version)
        for d, f in zip(chunk, feats):
            results.append((d.path, _make_song(d.raw, f, opts)))
    return results


def update_library_distributed(
    library,
    paths,
    mesh,
    process_id: int,
    num_processes: int,
    analysis_options=None,
    round_size: int = 8,
):
    """`Library.update_library` split across the processes of the group,
    all committing to ONE shared SQLite database.

    Every process opens the same `Library` (shared config/DB path),
    computes the SAME set-difference work list, takes the `process_id`-th
    round-robin slice, analyzes it on its devices
    (`analyze_paths_distributed`), and stores its own rows once its rounds
    are done, each song in its own transaction, so the processes' commits
    interleave safely under SQLite's file lock; process 0 purges the other
    versions' rows behind a barrier first. Returns (n_success, n_failure)
    of this process."""
    from .. import library as library_mod
    from ..song import Song

    opts = analysis_options or library.config.analysis_options
    with library._lock:
        existing = {
            pathlib.Path(r[0])
            for r in library.sqlite_conn.execute(
                "select path from song where analyzed = true and version = ? order by id",
                (int(opts.features_version),),
            )
        }
    todo = sorted({pathlib.Path(p) for p in paths} - existing, key=str)
    if todo and process_id == 0:
        # one process purges the other versions' rows (idempotent, but
        # spares the write contention); all wait before analysis begins
        with library._lock:
            library.sqlite_conn.execute(
                "delete from song where version != ?", (int(opts.features_version),)
            )
            library.sqlite_conn.commit()
        library._invalidate_matrix_cache()
    barrier()

    results = analyze_paths_distributed(
        library.decoder_cls, todo[process_id::num_processes], mesh, opts, round_size=round_size
    )
    success = failure = 0
    for path, result in results:
        if isinstance(result, Song):
            library.store_song(library_mod.LibrarySong(result, None))
            success += 1
        else:
            library.store_failed_song(path, result, opts.features_version)
            failure += 1
    barrier()
    if process_id == 0:
        library.config.analysis_options = opts
        library.config.write()
    return success, failure
