"""The readers of the program's own spans (`perfbench/program_spans.py`
and its six metrics) on synthetic windows: the clip to the window, the
driver's thread alone, the idle time put down to the innermost span; the
program without its recorder; a small traced scan on the CPU; and the
entries of `BENCHMARK.json` that name them."""

import json
import sys
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT, run_small

from bliss_tpu_torch.utils.profiling import Span
from perfbench import program_spans
from perfbench.run import benchmark, load_reader
from perfbench.trace import View

NEW = ["fill_ms_per_song", "launch_ms_per_song", "decode_wait_ms_per_song",
       "card_wait_ms_per_song", "idle_in_fill_share.scan", "idle_unattributed_share.scan"]

#: The per-layer entries accepted before the program's spans were read.
ACCEPTED = [
    {"name": "device_idle_share.scan", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "scan_songs_per_s", "workloads": ["scan-fma_full-v2"]},
    {"name": "roofline_share.scan", "unit": "%", "better": "higher", "source": "device_trace",
     "layer": "kernels (csrc/)", "moves": "scan_songs_per_s", "workloads": ["scan-fma_full-v2"]},
    {"name": "device_ms_per_song", "unit": "ms/song", "better": "lower", "source": "device_trace",
     "layer": "descriptors (models/, ops/)", "moves": "scan_songs_per_s",
     "workloads": ["scan-fma_full-v2"]},
    {"name": "h2d_ms_per_song", "unit": "ms/song", "better": "lower", "source": "device_trace",
     "layer": "batch driver (io/batch.py)", "moves": "scan_songs_per_s",
     "workloads": ["scan-fma_full-v2"]},
]

DRIVER, DECODER = 11, 22
MS = 1_000_000


def span(name, lo_ms, hi_ms, thread=DRIVER):
    return Span(name, lo_ms * MS, hi_ms * MS, thread, -1, -1, None)


def window(spans, ops=(), songs=4):
    """A 100-ms window at 1,000 ms with `ops` (ms pairs) on the card."""
    view = View(1000 * MS, 1100 * MS, [("kernel", a * MS, b * MS) for a, b in ops], [],
                {"songs": songs})
    view.program_spans = spans
    return view


def read(name, view):
    return load_reader(name)(view)


#: Two batches on the driver's thread, one half outside the window; a
#: decode thread's span that is no driver's.
SPANS = [
    span("batch.decode_wait", 990, 1004),  # 4 ms inside
    span("batch.dispatch", 1004, 1040),
    span("batch.slot_wait", 1005, 1007),
    span("batch.fill", 1007, 1027),
    span("batch.upload", 1027, 1028),
    span("analyze", 1028, 1038),
    span("analyze.tempo", 1029, 1031),
    span("batch.drain", 1040, 1050),
    span("batch.card_wait", 1041, 1047),
    span("batch.songs", 1047, 1049),
    span("batch.dispatch", 1090, 1120),
    span("batch.fill", 1092, 1112),  # 8 ms inside
    span("batch.fill", 1000, 1100, thread=DECODER),
]


def test_host_time_a_song_on_the_driver_thread_in_the_window():
    view = window(SPANS)
    assert read("fill_ms_per_song", view) == pytest.approx((20 + 8) / 4)
    assert read("launch_ms_per_song", view) == pytest.approx(10 / 4)
    assert read("decode_wait_ms_per_song", view) == pytest.approx(4 / 4)
    assert read("card_wait_ms_per_song", view) == pytest.approx((2 + 6) / 4)


def test_idle_time_by_the_innermost_span():
    # the card runs 1028-1040 and 1045-1060: idle 0-28, 40-45, 60-100 ms into the window
    view = window(SPANS, ops=[(1028, 1035), (1033, 1040), (1045, 1060)])
    by = program_spans.idle_by_span(view)
    assert sum(by.values()) == (28 + 5 + 40) * MS
    assert by["batch.fill"] == (20 + 8) * MS and by["batch.decode_wait"] == 4 * MS
    assert by["batch.slot_wait"] == 2 * MS and by["batch.dispatch"] == (1 + 2) * MS
    assert by["batch.upload"] == 1 * MS and by["batch.drain"] == 1 * MS  # 1040-1041
    assert by["batch.card_wait"] == 4 * MS  # 1041-1045, where the card was idle
    assert "analyze" not in by and "analyze.tempo" not in by  # the card ran then
    assert by[None] == (40 - 8 - 2) * MS  # 1060-1090
    assert read("idle_in_fill_share.scan", view) == pytest.approx(100 * 28 / 73)
    assert read("idle_unattributed_share.scan", view) == pytest.approx(100 * 30 / 73)


def test_innermost_pieces_cover_the_window():
    pieces = program_spans.innermost([("a", 10, 50), ("b", 20, 30), ("c", 30, 40), ("d", 60, 70)],
                                     0, 100)
    assert pieces == [(0, 10, None), (10, 20, "a"), (20, 30, "b"), (30, 40, "c"), (40, 50, "a"),
                      (50, 60, None), (60, 70, "d"), (70, 100, None)]


def test_the_driver_is_the_thread_that_dispatched():
    swapped = [s._replace(thread=DECODER if s.thread == DRIVER else DRIVER) for s in SPANS]
    assert read("fill_ms_per_song", window(swapped)) == pytest.approx((20 + 8) / 4)
    # the decode thread's fill over the whole window is never counted
    only_other = [s for s in SPANS if s.thread == DECODER]
    assert read("fill_ms_per_song", window(only_other)) is None


@pytest.mark.parametrize("name", NEW)
def test_no_spans_read_none(name, monkeypatch):
    assert read(name, window([], ops=[(1000, 1010)])) is None
    outside = [span("batch.dispatch", 800, 900), span("batch.fill", 810, 890)]
    assert read(name, window(outside, ops=[(1000, 1010)])) is None
    # a program from before the recorder: its profiling module has no RECORDER
    monkeypatch.setitem(sys.modules, "bliss_tpu_torch.utils.profiling",
                        types.ModuleType("bliss_tpu_torch.utils.profiling"))
    view = View(0, 10, [("kernel", 0, 5)], [], {"songs": 3})
    assert read(name, view) is None and view.program_spans == []


def test_idle_shares_need_device_operations():
    assert read("idle_in_fill_share.scan", window(SPANS)) is None
    assert read("fill_ms_per_song", window(SPANS, songs=0)) is None


def test_a_traced_scan_on_the_cpu_reads_its_spans():
    """Under a CPU profiler the driver records its spans through the window
    and the host-time readers find them (the CPU has no device operations,
    so the idle shares stay out)."""
    with profile(activities=[ProfilerActivity.CPU]):
        r = run_small("scan-fma_full-v2", 2**33 + 5, trace=True)
    assert r["correct"] is True
    got = {k: v["value"] for k, v in r["metrics"].items()}
    for name in NEW[:4]:
        assert got[name] >= 0, name
    assert got["fill_ms_per_song"] > 0 and got["launch_ms_per_song"] > 0
    assert not {"idle_in_fill_share.scan", "idle_unattributed_share.scan"} & set(got)
    assert r["metrics"]["fill_ms_per_song"]["unit"] == "ms/song"


def test_the_benchmark_entries():
    bench = benchmark()
    assert bench["per_layer"][: len(ACCEPTED)] == ACCEPTED
    new = bench["per_layer"][len(ACCEPTED):]
    assert [m["name"] for m in new] == NEW
    layers = {m["layer"] for m in ACCEPTED} | {"entry (models/analyzer.py)", "decode (host)"}
    for m in new:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["source"] == "program_span" and m["moves"] == "scan_songs_per_s"
        assert m["workloads"] == ["scan-fma_full-v2"] and m["better"] == "lower"
        assert m["unit"] == ("%" if m["name"].endswith(".scan") else "ms/song")
        assert m["layer"] in layers
    json.dumps(bench)
