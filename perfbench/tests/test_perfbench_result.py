"""A run's last line, the check that decides `correct` with the timed path
broken underneath, a run without a card, and the import guard."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, run_small

PERFBENCH = ROOT / "perfbench"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["scan-fma_full-v2", "query-fma_large-v2"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(cell, trace):
    r = run_small(cell, 2**32 + 7, trace=trace)
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["checked"]
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    if not trace:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
        assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    else:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(r["device"])
    assert all(set(c) == {"value", "limit"} for c in r["checked"].values())
    json.dumps(r)


# ---- faults planted in the timed path: each must come out not correct ----

def _scan_fault(monkeypatch, kind):
    import bliss_tpu_torch.io.batch as driver

    real = driver.analyze_tensor
    first = {}

    def broken(x, lengths, *args, **kwargs):
        out = real(x, lengths, *args, **kwargs)
        if kind == "altered":  # one feature of one song, where it is produced
            out = out.clone()
            out[0, 12] += 1e-3
        elif kind == "half":  # half of the batch left out, the mean over the rest
            half = max(out.shape[0] // 2, 1)
            out = out.clone()
            out[half:] = out[:half].mean(0)
        elif kind == "stale":  # the first batch's answer handed out again
            first.setdefault(out.shape, out)
            out = first[out.shape]
        return out

    monkeypatch.setattr(driver, "analyze_tensor", broken)


def _query_fault(monkeypatch, kind):
    from bliss_tpu_torch.library import Library

    real = Library.playlist_from
    last = {}

    def broken(self, paths):
        out = real(self, paths)
        if kind == "altered":  # two songs of the playlist swapped
            out[10], out[500] = out[500], out[10]
        elif kind == "half":  # the farther half of the playlist left out
            out = out[: len(out) // 2]
        elif kind == "stale":  # the previous playlist handed out again
            out, last["out"] = last.get("out", out), out
        return out

    monkeypatch.setattr(Library, "playlist_from", broken)


@pytest.mark.parametrize("kind", ["altered", "half", "stale"])
@pytest.mark.parametrize("cell", ["scan-fma_full-v2", "query-fma_large-v2"])
def test_a_broken_path_is_not_correct(monkeypatch, cell, kind):
    (_scan_fault if cell.startswith("scan") else _query_fault)(monkeypatch, kind)
    r = run_small(cell, 2**31 + 99)
    assert r["correct"] is False, r["checked"]


def test_a_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "scan-fma_full-v2",
         "--seed", "5", "--seconds", "10", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no card" in out.stderr


def test_a_directory_without_the_program_fails(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(PERFBENCH), str(tmp_path / "perfbench")], check=True)
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "scan-fma_full-v2",
         "--seed", "5", "--seconds", "10", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and "{" not in out.stdout


# ---- the import guard ----

def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in PERFBENCH.rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "bliss_tpu"}
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (PERFBENCH / "reference").glob("*.py"):
        names = _imports(path)
        assert names <= {"__future__", "math", "numpy", "torch"}, f"{path}: {names}"
        assert "bliss_tpu_torch" not in names and "bliss_tpu" not in names


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    from perfbench import run

    run_small("query-fma_large-v2", 11)
    assert run.forbidden_loaded() == []  # bliss_tpu_torch is loaded and passes
    monkeypatch.setitem(sys.modules, "bliss_tpu.features", object())
    assert run.forbidden_loaded() == ["bliss_tpu"]
