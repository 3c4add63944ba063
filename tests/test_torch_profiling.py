"""The port's span recorder (bliss_tpu_torch/utils/profiling.py) on the
CPU: it records only while a torch profiler runs, on the profiler's clock;
the batch driver's and the analyzer's spans nest by batch; its buffer is
bounded; `device_trace` writes the spans into its Chrome trace; an off
span site is cheap and allocates nothing."""

import itertools
import json
import pathlib
import threading
import timeit
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bliss_tpu_torch.io import batch
from bliss_tpu_torch.io.batch import analyze_paths_batched
from bliss_tpu_torch.io.decoder import Decoder, PreAnalyzedSong
from bliss_tpu_torch.utils import profiling
from bliss_tpu_torch.utils.profiling import RECORDER, Recorder, device_trace

torch.set_num_threads(1)

STAGES = ["analyze.tempo", "analyze.zcr", "analyze.timbral", "analyze.loudness", "analyze.chroma"]

#: Samples of each song (path `/songs/<n>.pcm`): with a batch of 4, two
#: buckets of 16,384 (one full, one flushed part-full) and one of 24,576.
LENGTHS = [9000, 12000, 20000, 9500, 16000, 10000, 15000]


class NoiseDecoder(Decoder):
    """Songs of seeded noise, as long as their path's stem says."""

    @classmethod
    def decode(cls, path):
        n = int(pathlib.PurePath(path).stem)
        x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 0.1
        return PreAnalyzedSong(path=pathlib.Path(path), duration=n / 22050, sample_array=x)


def scan() -> list:
    paths = [f"/songs/{n}.pcm" for n in LENGTHS]
    out = list(analyze_paths_batched(NoiseDecoder, paths, batch_size=4, device="cpu"))
    assert len(out) == len(LENGTHS) and all(hasattr(r, "analysis") for _, r in out)
    return out


@pytest.fixture
def recorder():
    """The program's recorder, emptied before and after the test."""
    RECORDER.take()
    yield RECORDER
    RECORDER.take()


def test_no_profiler_records_nothing(recorder):
    scan()
    assert recorder.take() == []


def test_driver_and_analyzer_spans_nest_by_batch(recorder):
    with profile(activities=[ProfilerActivity.CPU]):
        scan()
    spans = recorder.take()
    assert {s.thread for s in spans} == {threading.get_native_id()}  # the driver's thread
    children = {i: [] for i in range(len(spans))}
    for s in spans:
        if s.parent >= 0:
            children[s.parent].append(s)

    def names(i):
        return [c.name for c in children[i]]

    dispatch = [i for i, s in enumerate(spans) if s.name == "batch.dispatch"]
    drain = [i for i, s in enumerate(spans) if s.name == "batch.drain"]
    batches = [spans[i].batch for i in dispatch]
    assert batches == list(range(3))  # a full bucket, then the two part-full ones
    assert sorted(spans[i].batch for i in drain) == batches
    for i in dispatch:
        # one group a batch on one entry; on the CPU no pinned ring
        assert names(i) == ["batch.fill", "batch.upload", "analyze"]
        assert spans[i].parent == -1
        assert all(c.batch == spans[i].batch for c in children[i])
    for i, s in enumerate(spans):
        if s.name == "analyze":
            assert names(i) == STAGES
            assert all(c.batch == s.batch and c.start_ns >= s.start_ns and c.end_ns <= s.end_ns
                       for c in children[i])
    for i in drain:
        assert names(i) == ["batch.songs"] and spans[i].parent == -1
    fills = [s for s in spans if s.name == "batch.fill"]
    assert sum(s.args["rows"] for s in fills) == len(LENGTHS)
    assert sum(s.args["samples"] for s in fills) == sum(LENGTHS)
    assert all(s.args["threads"] == 1 for s in fills)  # short songs: one thread
    waits = [s for s in spans if s.name == "batch.decode_wait"]
    assert waits and all(s.parent == -1 and s.batch == -1 for s in waits)


def test_a_split_fill_records_its_threads_on_the_drivers_thread(recorder, monkeypatch):
    """A batch past the split threshold is copied by several threads, and
    its `batch.fill` span, like every other, is the driver's and says how
    many threads shared the copy."""
    monkeypatch.setattr(batch, "FILL_SPLIT_BYTES", 16 << 10)
    monkeypatch.setattr(batch, "_usable_cores", lambda: 8)
    with profile(activities=[ProfilerActivity.CPU]):
        scan()
    spans = recorder.take()
    assert {s.thread for s in spans} == {threading.get_native_id()}
    fills = [s for s in spans if s.name == "batch.fill"]
    assert len(fills) == 3 and sum(s.args["rows"] for s in fills) == len(LENGTHS)
    for s in fills:
        assert s.args["threads"] == max(1, min(8, 4 * s.args["samples"] // (16 << 10)))
    assert max(s.args["threads"] for s in fills) > 1


def test_a_span_encloses_the_profilers_event_of_its_op(recorder):
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = recorder.begin("product")
        a @ a
        sp.end()
    (span,) = recorder.take()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert span.start_ns <= mm[0].start_ns() <= mm[0].start_ns() + mm[0].duration_ns() <= span.end_ns


def test_the_buffer_drops_past_its_capacity_and_counts():
    rec = Recorder(capacity=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            rec.begin(f"s{i}").end()
        other = threading.Thread(target=lambda: rec.begin("other").end())
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    assert [s.name for s in rec.take()] == ["s0", "s1", "s2"] and rec.dropped == 3
    assert rec.take() == []
    with profile(activities=[ProfilerActivity.CPU]):
        outer = rec.begin("outer", batch=7)
        rec.begin("inner").end()
        outer.end()
        other = threading.Thread(target=lambda: rec.begin("other").end())
        other.start()
        other.join(timeout=10)
    spans = {s.name: s for s in rec.take()}
    assert spans["inner"].parent == 0 and spans["inner"].batch == 7  # nested, batch inherited
    assert spans["other"].parent == -1 and spans["other"].thread != spans["outer"].thread


def test_device_trace_writes_the_programs_spans(tmp_path, recorder):
    with device_trace(tmp_path) as prof:
        sp = recorder.begin("transform", batch=3)
        torch.fft.rfft(torch.ones(4096))
        sp.end(rows=1)
    assert prof.key_averages()
    trace = json.loads((tmp_path / "trace.json").read_text())
    (span,) = [e for e in trace["traceEvents"] if e.get("cat") == "program"]
    assert span["name"] == "transform" and span["args"] == {"rows": 1, "batch": 3}
    assert span["ph"] == "X" and span["tid"] == threading.get_native_id()
    rfft = [e for e in trace["traceEvents"] if e.get("name") == "aten::fft_rfft"]
    assert rfft, "the profiler's own event"
    # on the trace's own timebase, the span holds its op
    assert span["ts"] <= rfft[0]["ts"] and rfft[0]["ts"] + rfft[0]["dur"] <= span["ts"] + span["dur"]
    assert recorder.take() == []  # taken by the trace


def test_an_off_span_site_is_cheap_and_allocates_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    rec = Recorder()

    def sites(n):
        for _ in itertools.repeat(None, n):
            sp = rec.begin("batch.fill", 3)
            sp.end()

    sites(1000)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        sites(10_000)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak - before < 512  # nothing kept: a span object a site would hold ~1 MB
    assert rec.take() == [] and rec.dropped == 0
    n = 20_000
    seconds = min(timeit.repeat(lambda: sites(n), number=1, repeat=9)) / n
    assert seconds < 0.3e-6, f"{seconds * 1e9:.0f} ns a site"
    assert rec.begin("x") is profiling._OFF  # the one shared no-op span
