"""The batch driver's default long-song route and the scaling bench, on the
CPU.

- `io.batch._longsong_route`: the JAX driver's default (a song above 20
  minutes leaves the buckets when more than one device is visible, one
  shard a device), and explicit arguments winning.
- The route through `analyze_paths_batched` with `LONGSONG_SAMPLES` cut to
  30 s: over `[cpu] * 2` a 70-s WAV goes through the sharded analyzer in 2
  shards, over `[cpu]` it stays bucketed; its vector against the JAX
  driver's on the same WAV over 2 of the conftest's 8 XLA CPU devices
  (`BLISS_ANALYZE_DEVICES=2`) at the long-song tolerance, `ATOL` (f32
  reduction order across shards), tempo within 1e-6 of the JAX driver's
  and equal to the port's bucketed tempo.
- `benches/scaling_bench.py` at its CPU sizes: its JSON keys, every list
  bit for bit against one entry, and the two-process gloo rounds (three
  entries on the same rows, bit for bit).

JAX is imported only inside the JAX comparison."""

import json
import wave

import numpy as np
import pytest
import torch

from bliss_tpu_torch import Song
from bliss_tpu_torch.benches import scaling_bench
from bliss_tpu_torch.io import batch as TB
from bliss_tpu_torch.io.fallback import FallbackDecoder
from bliss_tpu_torch.parallel import longsong as TL

# one intra-op thread: the suite runs several test workers side by side
torch.set_num_threads(1)

ATOL = 2e-5
#: The JAX driver's bound, 30 s, in both drivers' tests.
SHORT_BOUND = 30 * 22050


def _write_wav(path, seconds: float, seed: int):
    n = int(seconds * 22050)
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / 22050.0
    sig = (rng.normal(size=n) * 0.08).astype(np.float32) + 0.3 * np.sin(2 * np.pi * 220.0 * t)
    sig *= (0.4 + 0.6 * (np.sin(2 * np.pi * 2.0 * t) > 0)).astype(np.float32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(np.clip(sig * 32767, -32768, 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def long_wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("long") / "long.wav"
    _write_wav(path, 70.0, 13)
    return path


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "samples,shards,entries,want",
    [
        (None, None, 1, (None, 1)),  # one entry: off, as JAX on one chip
        (None, None, 2, (26_460_000, 2)),  # the JAX default, one shard an entry
        (None, None, 8, (26_460_000, 8)),
        (30 * 22050, None, 1, (30 * 22050, 1)),  # an explicit bound wins
        (None, 8, 2, (26_460_000, 8)),  # an explicit shard count wins
        (30 * 22050, 4, 1, (30 * 22050, 4)),
        (10**9, None, 4, (10**9, 4)),
    ],
)
def test_longsong_route(samples, shards, entries, want):
    assert TB.LONGSONG_SAMPLES == 20 * 60 * 22050 == 26_460_000
    assert TB._longsong_route(samples, shards, entries) == want


def _routed(wav, devices):
    """The driver's song for `wav` over `devices` with the default route
    arguments, and the keyword arguments of each sharded call."""
    calls = []
    real = TL.sharded_analyze_samples

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, "LONGSONG_SAMPLES", SHORT_BOUND)
        mp.setattr(TL, "sharded_analyze_samples", spy)
        song = dict(TB.analyze_paths_batched(FallbackDecoder, [wav], devices=devices))[wav]
    assert isinstance(song, Song), song
    return song, calls


def test_default_route_over_two_entries_matches_jax_driver(long_wav, monkeypatch):
    """Over two entries and no `longsong_samples`, the 70-s song above the
    30-s bound is sharded 2 ways, as the JAX driver shards it over a mesh
    of 2 devices; over one entry it stays bucketed. The routed vector is
    the JAX driver's at `ATOL`."""
    routed, calls = _routed(long_wav, ["cpu"] * 2)
    assert len(calls) == 1 and calls[0]["shards"] == 2
    assert [str(d) for d in calls[0]["devices"]] == ["cpu", "cpu"]
    bucketed, calls = _routed(long_wav, ["cpu"])
    assert calls == []

    pytest.importorskip("jax")
    from bliss_tpu.io import batch as JB
    from bliss_tpu.io.fallback import FallbackDecoder as JaxFallbackDecoder

    monkeypatch.setenv("BLISS_LONGSONG_SAMPLES", str(SHORT_BOUND))
    monkeypatch.setenv("BLISS_ANALYZE_DEVICES", "2")
    assert JB._device_count() == 2 and JB._longsong_threshold() == SHORT_BOUND
    jax_song = dict(JB.analyze_paths_batched(JaxFallbackDecoder, [long_wav]))[long_wav]
    want = np.asarray(jax_song.analysis.as_arr1())
    got = routed.analysis.as_arr1()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # tempo is discrete: the same beats, up to the two packages' rounding of
    # the BPM normalization (tests/test_torch_longsong.py's rule); equal to
    # the port's bucketed tempo
    assert abs(got[0] - want[0]) < 1e-6
    assert got[0] == bucketed.analysis.as_arr1()[0]
    np.testing.assert_allclose(bucketed.analysis.as_arr1(), got, atol=ATOL)
    assert routed.duration == bucketed.duration == jax_song.duration


# ---------------------------------------------------------------------------
# the scaling bench
# ---------------------------------------------------------------------------


def test_scaling_lists_hold_bit_for_bit():
    rows = scaling_bench.run_lists("cpu", (1, 2, 4), scaling_bench.SMALL_SIZES, repeat=1,
                                   log=lambda *a, **k: None)
    assert [r["entries"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["bit_for_bit"] and r["finite"] and r["distinct_cards"] == 0
        assert r["features"].shape == (r["entries"], 23)
        assert set(r["per_entry_overhead"]) == set(scaling_bench.PATHS)
        assert all(r[f"{p}_s"] > 0 for p in scaling_bench.PATHS)
    assert rows[0]["held"] == {} and rows[0]["weak_scaling_efficiency_analyze"] == 1.0
    for r in rows[1:]:
        assert r["held"] == {"features": True, "top_k": True, "chroma": True, "longsong": True}


def test_scaling_bench_json_line(monkeypatch, capsys):
    """`main` at the CPU sizes over 1, 2 and 4 entries, one warm call a path
    (each gloo worker on one intra-op thread): one JSON line last, every
    key, bit for bit."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(scaling_bench, "REPEAT", 1)
    rc = scaling_bench.main(["--device", "cpu", "--small", "--entries", "4"])
    lines = capsys.readouterr().out.splitlines()
    out = json.loads(lines[-1])
    assert rc == 0
    assert set(out) == {"metric", "value", "unit", "lists", "gloo", "bit_for_bit", "finite",
                        "sizes", "device", "card"}
    assert out["metric"] == "weak_scaling_efficiency_analyze" and out["card"] is None
    assert out["bit_for_bit"] and out["finite"] and out["sizes"] == scaling_bench.SMALL_SIZES
    assert [r["entries"] for r in out["lists"]] == [1, 2, 4]
    assert out["value"] == out["lists"][-1]["weak_scaling_efficiency_analyze"] > 0
    for r in out["lists"]:
        for key in ("analyze_s", "top_k_s", "chroma_s", "longsong_s", "distinct_cards",
                    "weak_scaling_efficiency_analyze", "per_entry_overhead", "held"):
            assert key in r, key
    gloo = out["gloo"]
    assert gloo["processes"] == 2 and gloo["rounds"] == scaling_bench.ROUNDS
    assert gloo["bit_for_bit"]
    for key in ("distributed_ms", "sharded_ms", "local_ms", "overhead_ms", "exchange_ms"):
        assert len(gloo[key]) == 2, key
    assert all(ms > 0 for key in ("distributed_ms", "sharded_ms", "local_ms", "exchange_ms")
               for ms in gloo[key])
    for d, l, o in zip(gloo["distributed_ms"], gloo["local_ms"], gloo["overhead_ms"]):
        assert o == pytest.approx(d - l)
