"""The port's multi-process layer (`bliss_tpu_torch/parallel/distributed.py`)
on CPU clusters of 2 and 4 processes joined by a gloo group on
tcp://127.0.0.1: the six scenarios of tests/test_distributed.py.

Each process of a cluster is this file run as a script (the
`if __name__ == "__main__":` block below):

    python tests/test_torch_distributed.py <process_id> <port> <scenario> [workdir] --nprocs N

with two CPU entries as its device list. The workers import no JAX; they
hold their results against the port's one-process routes and write their
features under the work folder, and the tests here hold those against
`bliss_tpu`'s `analyze_batch` at the tolerance of
tests/test_torch_analyzer.py::test_side_by_side_with_jax (1e-5). Every
worker has its own timeout.

Scenarios: smoke (equal shapes, then a global top-k), ragged (5 vs 3 rows
at different pad lengths, then 2 vs 0), library (one shared store; ragged
with 4 processes), library_die + library_resume (a worker dies after its
first round; nothing is stored; a fresh cluster resumes), die (a worker
exits after joining; the other fails cleanly, without hanging).
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
LIB_PATHS = [
    DATA / "s16_mono_22_5kHz.flac",
    DATA / "piano.flac",
    DATA / "s32_stereo_44_1_kHz.mp3",
    DATA / "s32_stereo_44_1_kHz.flac",
]
WORKER_DEVICES = ["cpu", "cpu"]


def _smoke_data():
    rng = np.random.default_rng(0)
    t = 16384
    batch = (rng.normal(size=(8, t)) * 0.1).astype(np.float32)
    lengths = np.array([t, t - 100, t - 2048, t, t, t - 1, t, t - 5000], np.int64)
    library = np.random.default_rng(1).normal(size=(100, 23)).astype(np.float32)
    return batch, lengths, library


def _ragged_data():
    """Per process: round 1 (5 rows at 16384, 3 rows at 20480), round 2
    (2 rows, none)."""
    rng = np.random.default_rng(42)
    t0, t1 = 16384, 20480
    sigs = [(rng.normal(size=(5, t0)) * 0.1).astype(np.float32),
            (rng.normal(size=(3, t1)) * 0.1).astype(np.float32)]
    lens = [np.array([t0, t0 - 7, t0 - 2048, 9000, t0], np.int64),
            np.array([t1, 8400, t1 - 1], np.int64)]
    second = [((rng.normal(size=(2, t0)) * 0.1).astype(np.float32),
               np.array([t0, t0 - 3], np.int64)),
              (np.zeros((0, t0), np.float32), np.zeros((0,), np.int64))]
    return sigs, lens, second


# ---------------------------------------------------------------------------
# the parent: start a cluster, hold what it wrote
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cluster(scenario: str, workdir, timeout=180, n_procs=2):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(pid), str(port), scenario, str(workdir),
             "--nprocs", str(n_procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(n_procs)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return procs, outs


def _assert_ok(procs, outs):
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"DISTRIBUTED_SMOKE_OK pid={pid}" in out, out[-4000:]


def _jax_analyze_batch(batch, lengths):
    import pytest

    pytest.importorskip("jax")
    from bliss_tpu.models.analyzer import analyze_batch

    return np.asarray(analyze_batch(batch, lengths))


def test_two_process_cluster(tmp_path):
    procs, outs = _run_cluster("smoke", tmp_path)
    _assert_ok(procs, outs)
    batch, lengths, _ = _smoke_data()
    got = np.concatenate([np.load(tmp_path / f"smoke_{pid}.npy") for pid in range(2)])
    np.testing.assert_allclose(got, _jax_analyze_batch(batch, lengths), atol=1e-5)


def test_two_process_ragged_hosts(tmp_path):
    """Unequal row counts (5 vs 3, 2 vs 0) and pad lengths, absorbed inside
    analyze_batch_distributed."""
    procs, outs = _run_cluster("ragged", tmp_path)
    _assert_ok(procs, outs)
    sigs, lens, second = _ragged_data()
    rows = [sigs[0], sigs[1], second[0][0]]
    t = max(r.shape[1] for r in rows)
    batch = np.concatenate([np.pad(r, ((0, 0), (0, t - r.shape[1]))) for r in rows])
    want = _jax_analyze_batch(batch, np.concatenate([lens[0], lens[1], second[0][1]]))
    got = np.concatenate([np.load(tmp_path / f"ragged_{pid}.npy") for pid in range(2)]
                         + [np.load(tmp_path / "ragged_second_0.npy")])
    assert np.load(tmp_path / "ragged_second_1.npy").shape == (0, 23)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _stored(workdir) -> dict:
    import sqlite3

    with sqlite3.connect(pathlib.Path(workdir) / "songs.db") as conn:
        rows = conn.execute(
            "select song.path, feature.feature from feature join song on song.id = feature.song_id"
            " order by song.id, feature.feature_index"
        ).fetchall()
    out: dict = {}
    for path, f in rows:
        out.setdefault(path, []).append(f)
    return {p: np.asarray(v, np.float32) for p, v in out.items()}


def _hold_library_against_jax(workdir):
    import pytest

    pytest.importorskip("jax")
    from bliss_tpu.io.fallback import FallbackDecoder as JaxFallback
    from bliss_tpu.models.analyzer import build_analyzer

    analyze = build_analyzer(2)
    stored = _stored(workdir)
    assert sorted(stored) == sorted(str(p) for p in LIB_PATHS)
    for p in LIB_PATHS[:2]:
        want = analyze(np.asarray(JaxFallback.decode(p).sample_array))
        np.testing.assert_allclose(stored[str(p)], want, atol=1e-5)


def test_two_process_shared_library_update(tmp_path):
    """update_library_distributed: both processes analyze their slice and
    commit to one SQLite store; both see the merged library, the failed
    ledger and the resume no-op."""
    procs, outs = _run_cluster("library", tmp_path)
    _assert_ok(procs, outs)
    for out in outs:
        assert "stored pid=" in out
    _hold_library_against_jax(tmp_path)


def test_four_process_ragged_library_update(tmp_path):
    """Four processes, a ragged round-robin split (2/1/1/1 entries; the
    resume pass gives every process an empty slice), one shared store."""
    procs, outs = _run_cluster("library", tmp_path, n_procs=4)
    _assert_ok(procs, outs)
    for out in outs:
        assert "stored pid=" in out
    assert len(_stored(tmp_path)) == 4


def test_mid_update_worker_kill_then_resume(tmp_path):
    """Worker 1 dies after its first analysis round: the survivor errors
    cleanly with NOTHING stored; a fresh cluster resumes through the
    set-difference work list and every song lands once."""
    procs, outs = _run_cluster("library_die", tmp_path)
    assert procs[1].returncode == 17, outs[1][-2000:]
    assert "DISTRIBUTED_WORKER_DYING pid=1" in outs[1]
    assert "DOWNED_WORKER_DETECTED pid=0" in outs[0] or procs[0].returncode != 0, outs[0][-4000:]
    assert _stored(tmp_path) == {}, "the crashed run stored rows"

    procs, outs = _run_cluster("library_resume", tmp_path)
    _assert_ok(procs, outs)
    for out in outs:
        assert "resumed" in out and "rows=4" in out
    assert len(_stored(tmp_path)) == 4


def test_two_process_downed_worker(tmp_path):
    """Worker 1 exits after joining; worker 0 fails cleanly within the
    group's timeout, never hangs."""
    procs, outs = _run_cluster("die", tmp_path, timeout=120)
    assert procs[1].returncode == 17, outs[1][-2000:]
    assert "DISTRIBUTED_WORKER_DYING pid=1" in outs[1]
    assert "DOWNED_WORKER_DETECTED pid=0" in outs[0] or procs[0].returncode != 0, outs[0][-4000:]


# ---------------------------------------------------------------------------
# the worker: one process of a cluster
# ---------------------------------------------------------------------------


def scenario_smoke(pid, mesh, workdir, nprocs):
    from bliss_tpu_torch.models.analyzer import analyze_batch
    from bliss_tpu_torch.parallel import distributed as D

    batch, lengths, library = _smoke_data()
    lo, hi = pid * 4, (pid + 1) * 4
    feats = D.analyze_batch_distributed(mesh, batch[lo:hi], lengths[lo:hi])
    assert feats.shape == (4, 23), feats.shape
    np.testing.assert_array_equal(feats, analyze_batch(batch[lo:hi], lengths[lo:hi], device="cpu"))
    np.save(pathlib.Path(workdir) / f"smoke_{pid}.npy", feats)

    # global top-k over per-process rows (60/40), against the host's
    seeds = library[:2] + 0.01
    split = [0, 60, 100]
    idx, dist = D.top_k_distributed(
        mesh, library[split[pid] : split[pid + 1]], split[pid], 100, seeds, k=7
    )
    lib64 = library.astype(np.float64)
    d = sum(np.linalg.norm(lib64 - s.astype(np.float64), axis=1) for s in seeds)
    np.testing.assert_array_equal(idx, np.argsort(d, kind="stable")[:7])
    assert (dist[:-1] <= dist[1:]).all()


def scenario_ragged(pid, mesh, workdir, nprocs):
    from bliss_tpu_torch.models.analyzer import analyze_batch
    from bliss_tpu_torch.parallel import distributed as D

    sigs, lens, second = _ragged_data()
    feats = D.analyze_batch_distributed(mesh, sigs[pid], lens[pid])
    assert feats.shape == ((5, 23) if pid == 0 else (3, 23)), feats.shape
    # the local analyzer at this process's own pad length
    np.testing.assert_allclose(feats, analyze_batch(sigs[pid], lens[pid], device="cpu"), atol=1e-6)
    np.save(pathlib.Path(workdir) / f"ragged_{pid}.npy", feats)
    sig, length = second[pid]
    feats = D.analyze_batch_distributed(mesh, sig, length)
    assert feats.shape == ((2, 23) if pid == 0 else (0, 23)), feats.shape
    np.save(pathlib.Path(workdir) / f"ragged_second_{pid}.npy", feats)


def _open_shared_library(pid, workdir):
    from bliss_tpu_torch.io.fallback import FallbackDecoder
    from bliss_tpu_torch.library import BaseConfig, Library
    from bliss_tpu_torch.parallel import distributed as D

    config = BaseConfig(config_path=pathlib.Path(workdir) / "config.json")
    if pid == 0 and not config.config_path.exists():
        lib = Library.new(config, FallbackDecoder, devices=WORKER_DEVICES)
        D.barrier()
    else:
        D.barrier()
        lib = Library(config, FallbackDecoder, create=False, devices=WORKER_DEVICES)
    return lib


def scenario_library(pid, mesh, workdir, nprocs):
    """Every process updates ONE shared store; with 4 processes the
    round-robin split of the 5-entry work list is ragged."""
    from bliss_tpu_torch.io.batch import analyze_paths_batched
    from bliss_tpu_torch.io.fallback import FallbackDecoder
    from bliss_tpu_torch.parallel import distributed as D

    lib = _open_shared_library(pid, workdir)
    paths = LIB_PATHS + [DATA / "nonexistent.flac"]  # -> the failed ledger
    success, failure = D.update_library_distributed(lib, paths, mesh, pid, nprocs)
    print(f"stored pid={pid} success={success} failure={failure}", flush=True)

    songs = lib.songs_from_library()
    assert len(songs) == 4, [str(s.bliss_song.path) for s in songs]
    failed = lib.get_failed_songs()
    assert len(failed) == 1 and "nonexistent" in str(failed[0].song_path), failed
    # the shared store's vectors == a one-process batch driver's
    local = dict(analyze_paths_batched(FallbackDecoder, LIB_PATHS, device="cpu"))
    by_path = {str(s.bliss_song.path): s for s in songs}
    for p in LIB_PATHS:
        np.testing.assert_allclose(
            by_path[str(p)].bliss_song.analysis.as_arr1(), local[p].analysis.as_arr1(), atol=1e-6
        )
    # resume: nothing new to analyze (every process gets an empty slice)
    assert D.update_library_distributed(lib, LIB_PATHS, mesh, pid, nprocs) == (0, 0)


def scenario_library_die(pid, mesh, workdir, nprocs):
    """Worker 1 dies after its FIRST analysis round; the survivor errors
    cleanly and stores nothing (rows are stored after all rounds)."""
    from bliss_tpu_torch.parallel import distributed as D

    lib = _open_shared_library(pid, workdir)
    if pid == 1:
        real = D.analyze_batch_distributed
        rounds = []

        def dying(*a, **kw):
            if rounds:
                print("DISTRIBUTED_WORKER_DYING pid=1", flush=True)
                os._exit(17)
            rounds.append(1)
            return real(*a, **kw)

        D.analyze_batch_distributed = dying
    try:
        D.update_library_distributed(lib, LIB_PATHS, mesh, pid, nprocs, round_size=1)
    except RuntimeError as exc:  # gloo's error for a lost peer
        assert len(lib.songs_from_library()) == 0, "partial commit!"
        print(f"DOWNED_WORKER_DETECTED pid={pid} {type(exc).__name__}", flush=True)
        os._exit(0)
    raise AssertionError("update succeeded with a dead peer?")


def scenario_library_resume(pid, mesh, workdir, nprocs):
    from bliss_tpu_torch.parallel import distributed as D

    lib = _open_shared_library(pid, workdir)
    D.update_library_distributed(lib, LIB_PATHS, mesh, pid, nprocs)
    paths = sorted(str(s.bliss_song.path) for s in lib.songs_from_library())
    assert len(paths) == len(set(paths)) == 4, paths
    with lib._lock:
        n_rows = lib.sqlite_conn.execute("select count(*) from song").fetchone()[0]
    assert n_rows == 4, n_rows
    print(f"resumed pid={pid} rows={n_rows}", flush=True)


def scenario_die(pid, mesh, workdir, nprocs):
    """Worker 1 exits after joining; worker 0's next collective fails."""
    from bliss_tpu_torch.parallel import distributed as D

    if pid == 1:
        print("DISTRIBUTED_WORKER_DYING pid=1", flush=True)
        os._exit(17)
    sig = np.zeros((4, 16384), np.float32)
    try:
        D.analyze_batch_distributed(mesh, sig, np.full((4,), 16384))
    except RuntimeError as exc:
        print(f"DOWNED_WORKER_DETECTED pid={pid} {type(exc).__name__}", flush=True)
        os._exit(0)
    raise AssertionError("collective succeeded with a dead peer?")


def main(argv) -> None:
    import torch

    from bliss_tpu_torch.parallel import distributed as D
    from bliss_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    nprocs = 2
    if "--nprocs" in argv:
        i = argv.index("--nprocs")
        nprocs = int(argv[i + 1])
        del argv[i : i + 2]
    pid, port, scenario, workdir = int(argv[0]), argv[1], argv[2], argv[3]
    dying = scenario in ("die", "library_die")
    D.initialize(f"127.0.0.1:{port}", nprocs, pid, timeout_seconds=20 if dying else 120)
    scenarios = {
        "smoke": scenario_smoke, "ragged": scenario_ragged, "library": scenario_library,
        "library_die": scenario_library_die, "library_resume": scenario_library_resume,
        "die": scenario_die,
    }
    scenarios[scenario](pid, make_mesh(devices=WORKER_DEVICES), workdir, nprocs)
    assert "jax" not in sys.modules and "bliss_tpu" not in sys.modules
    D.barrier()
    D.shutdown()
    print(f"DISTRIBUTED_SMOKE_OK pid={pid}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent))
    main(sys.argv[1:])
