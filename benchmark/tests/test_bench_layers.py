"""The readers of the program's layer spans and counters on a synthetic
trace and a stub of the program's ``TOTALS``: per frame,
the share of idle time no span covers, and the counters' ratios; a
program without a span or the counters reads nothing."""
from __future__ import annotations

import types

import pytest

from benchmark.harness import spec
from benchmark.harness.cell import MetricContext
from benchmark.harness.trace import Trace

K1 = "void mobi_gop_executor_kernel<true>(MobiArgs)"

# window 0-1000 us; the device busy 100-200, 600-720, so idle 0-100,
# 200-600 and 720-1000 (780 us)
TRACE = Trace(
    window=(0.0, 1000.0),
    spans={"mobiclip.setup": [(0.0, 50.0), (720.0, 760.0), (-90.0, -40.0)],
           "mobiclip.demux": [(50.0, 100.0)],
           "mobiclip.scan": [(200.0, 400.0), (-40.0, -10.0)],
           "mobiclip.pack": [(400.0, 420.0)],
           "mobiclip.dispatch": [(420.0, 440.0), (590.0, 610.0)],
           "mobiclip.device_decode": [(610.0, 700.0)],
           "mobiclip.audio": [(760.0, 800.0)],
           "mobiclip.emit": [(800.0, 860.0)]},
    device=[(K1, 100.0, 200.0), (K1, 600.0, 700.0),
            ("Memcpy DtoH (Device -> Pinned)", 700.0, 720.0)])
CTX = MetricContext(TRACE, {"frames": 10, "k1_bytes": 0, "k5_bytes": 0})
BARE = MetricContext(Trace((0.0, 1000.0), {}, [(K1, 100.0, 200.0)]),
                     {"frames": 10, "k1_bytes": 0, "k5_bytes": 0})
NEW = ("scan_us_per_frame.file", "dispatch_us_per_frame",
       "dispatch_us_per_frame.file", "device_wait_us_per_frame",
       "device_wait_us_per_frame.file", "idle_unspanned",
       "idle_unspanned.file", "scan_pool_busy", "scan_native_share",
       "scan_native_share.file", "k1_ns_per_op_chunk",
       "k1_ns_per_op_chunk.file")
COUNTERS = {"scan_pool_busy", "scan_native_share", "scan_native_share.file",
            "k1_ns_per_op_chunk", "k1_ns_per_op_chunk.file"}


@pytest.fixture
def totals(monkeypatch):
    """The program's TOTALS replaced by a stub: 100 frames, 50 op
    chunks, scans busy 3 s of 4 slot-seconds, 1.5 s of it native."""
    from mobiclipdecoder_tpu_torch.runtime import metrics
    stub = types.SimpleNamespace(
        frames=100, op_chunks=50, scan_busy_seconds=3.0,
        scan_native_seconds=1.5, scan_slot_seconds=4.0)
    monkeypatch.setattr(metrics, "TOTALS", stub)
    return stub


def read(name, ctx=CTX):
    return spec.reader(name).read(ctx)


def test_span_readers_per_frame():
    assert read("scan_us_per_frame.file") == 20.0
    assert read("dispatch_us_per_frame") == 4.0
    assert read("device_wait_us_per_frame") == 9.0
    for name in ("dispatch_us_per_frame", "device_wait_us_per_frame"):
        assert read(name + ".file") == read(name)


def test_idle_unspanned_counts_what_no_span_covers():
    """The gap 0-100 is covered whole, 200-600 by 250 us (a dispatch span
    runs into the busy stretch after it), 720-1000 by half: 290 of 780
    idle us are unspanned."""
    assert read("idle_unspanned") == pytest.approx(100.0 * 290 / 780)
    assert read("idle_unspanned.file") == read("idle_unspanned")
    # no span at all: every idle microsecond is unspanned
    assert read("idle_unspanned", BARE) == pytest.approx(100.0)
    # overlapping spans count once
    two = Trace((0.0, 100.0), {"mobiclip.a": [(0.0, 30.0), (10.0, 20.0)],
                               "mobiclip.b": [(20.0, 40.0)]},
                [(K1, 50.0, 100.0)])
    assert read("idle_unspanned", MetricContext(two, CTX.work)) \
        == pytest.approx(20.0)


def test_counter_readers(totals):
    assert read("scan_pool_busy") == pytest.approx(75.0)
    assert read("scan_native_share") == pytest.approx(50.0)
    assert read("scan_native_share.file") == read("scan_native_share")
    # K1 200 us over 10 frames x 0.5 op chunks a frame: 40,000 ns a chunk
    assert read("k1_ns_per_op_chunk") == pytest.approx(40000.0)
    assert read("k1_ns_per_op_chunk.file") == read("k1_ns_per_op_chunk")
    totals.frames = totals.scan_slot_seconds = totals.scan_busy_seconds = 0
    for name in COUNTERS:
        assert read(name) is None, name


def test_a_program_without_the_spans_or_counters_reads_nothing(
        monkeypatch):
    """The parent program: no layer spans, no TOTALS."""
    from mobiclipdecoder_tpu_torch.runtime import metrics
    monkeypatch.delattr(metrics, "TOTALS")
    for name in NEW:
        if name.startswith("idle_unspanned"):
            continue
        assert read(name, BARE) is None, name


def test_the_new_metrics_are_in_the_benchmark():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == ("program_counter" if name in COUNTERS
                               else "program_span")
        cells = (["mods_file", "moflex_file"] if name.endswith(".file")
                 else ["moflex_corpus_b8"])
        assert m["workloads"] == cells
