"""Shared helpers of the benchmark's tests: small cells on the CPU.

    python3 -m pytest perfbench/tests -q            # here, on the CPU
    python3 -m pytest perfbench/tests -q -m cuda    # the controls, on a card
"""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: The cells cut to a size the CPU runs in seconds: a few short songs and
#: a 3,000-song store, every song of the window checked.
SMALL = {
    "scan-fma_full-v2": {
        "config": {"pcm_pool": {"tracks": 2, "track_seconds": 40, "detune_cents": 25},
                   "track_seconds": {"dist": "lognormal", "mean": 20, "sigma": 0.5,
                                     "min": 10, "max": 35}},
        "traffic": {"period": 8, "sample_songs": 1000},
    },
    "query-fma_large-v2": {
        "config": {"library_songs": 3000},
        "traffic": {"sample_queries": 3},
    },
}


#: Windows long enough for the driver's first results on a busy CPU: it
#: yields only once three more batches are in flight.
SECONDS = {"scan-fma_full-v2": 10.0, "query-fma_large-v2": 3.0}


def bench():
    """`BENCHMARK.json` with the query cell that it does not hold (its
    entries in `query_cell.json`: the harness drives it, but its host-bound
    latency spreads too widely between processes for a bound)."""
    from perfbench.run import benchmark

    out = benchmark()
    held = json.loads((pathlib.Path(__file__).parent / "query_cell.json").read_text())
    for key, entries in held.items():
        out[key] = out[key] + entries
    return out


def run_small(cell: str, seed: int, trace: bool = False):
    """A run of `cell` on the CPU at `SMALL` sizes: the result object."""
    from perfbench.run import run_cell

    return run_cell(cell, seed, SECONDS[cell], trace, device="cpu", overrides=SMALL[cell],
                    bench=bench())


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never while
    a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
