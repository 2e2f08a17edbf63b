"""The percentile, the device's busy union, its idle gaps and the
breakdown, on synthetic profiler events."""
from __future__ import annotations

import types

import pytest
import torch

from benchmark.harness import stats, trace
from benchmark.harness.cell import MetricContext, Reservoir

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, dev, a, b, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=dev, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=a, end=b))


EVENTS = [
    ev(trace.WINDOW, CPU, 100.0, 200.0),
    ev("mobiclip.scan", CPU, 100.0, 130.0),
    ev("mobiclip.pack", CPU, 130.0, 140.0),
    ev("mobiclip.scan", CPU, 160.0, 190.0),
    ev("aten::copy_", CPU, 131.0, 132.0),
    ev("mobiclip.scan", CUDA, 100.0, 130.0, annotation=True),
    ev("void mobi_gop_executor_kernel<true>(MobiArgs)", CUDA, 140.0, 160.0),
    ev("mobi_prologue_sblob_kernel", CUDA, 138.0, 141.0),
    ev("Memcpy HtoD (Pageable -> Device)", CUDA, 135.0, 138.0),
    ev("Memcpy DtoH (Device -> Pinned)", CUDA, 195.0, 205.0),
    ev("mobi_gop_executor_kernel<true>", CUDA, 40.0, 60.0),   # before
]


def test_percentile_interpolates_like_numpy():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.summary(xs) == {"median": 3.0, "p95": pytest.approx(4.8),
                                 "n": 5}
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_union_and_gaps():
    ivs = [(0, 10), (5, 15), (20, 30), (40, 50)]
    assert trace.union(ivs, 0, 100) == 35
    assert trace.union(ivs, 8, 25) == 12
    assert trace.gaps(ivs, 0, 60) == [(15, 20), (30, 40), (50, 60)]
    assert trace.gaps([], 0, 5) == [(0, 5)]


def test_reduce_and_read():
    tr = trace.reduce(EVENTS)
    assert tr.window == (100.0, 200.0)
    assert set(tr.spans) == {"mobiclip.scan", "mobiclip.pack"}
    assert len(tr.device) == 5          # the annotation copy is not work
    assert tr.span_us("mobiclip.scan") == 60.0
    assert tr.device_us(lambda n: "mobi_gop_executor" in n) == 20.0
    assert tr.device_us(lambda n: n.startswith("Memcpy")) == 3.0 + 5.0
    assert tr.busy_us() == (160 - 135) + (200 - 195)
    assert tr.gaps() == [(100.0, 135.0), (160.0, 195.0)]


def test_breakdown_labels_gaps_by_the_open_span():
    b = trace.breakdown(trace.reduce(EVENTS))
    assert b["device_ops"][0] == ["mobi_gop_executor_kernel<true>", 20e-6]
    assert [n for n, _s in b["device_ops"]] == [
        "mobi_gop_executor_kernel<true>", "Memcpy DtoH ",
        "mobi_prologue_sblob_kernel", "Memcpy HtoD "]
    assert b["idle_gaps"] == [["mobiclip.scan", 35e-6],
                              ["mobiclip.scan", 35e-6]]
    assert trace.label((140.0, 160.0), {}) == "none"
    # a span that covers a sliver of a gap does not name it
    assert trace.label((0.0, 10.0), {"mobiclip.pack": [(1.0, 2.0)]}) \
        == "none"
    assert trace.label((0.0, 10.0), {"mobiclip.pack": [(1.0, 7.0)]}) \
        == "mobiclip.pack"


def test_metric_readers_on_the_synthetic_trace():
    from benchmark.harness import spec
    cell = spec.load_cell("moflex_corpus_b8")
    ctx = MetricContext(trace.reduce(EVENTS),
                        {"frames": 10, "k1_bytes": 3.35e12 * 2e-6,
                         "k5_bytes": 0})
    got = {m["name"]: cell.reader(m["name"]).read(ctx)
           for m in cell.per_layer}
    assert got["scan_us_per_frame"] == 6.0
    assert got["pack_us_per_frame"] == 1.0
    assert got["k1_us_per_frame"] == 2.0
    assert got["k1_roofline"] == pytest.approx(10.0)
    assert got["k5_roofline"] is None         # no bytes: nothing to read
    assert got["copy_us_per_frame"] == 0.8
    assert got["device_idle"] == pytest.approx(70.0)
    # the file cells' readers read as the corpus cell's
    filed = spec.load_cell("mods_file")
    for m in filed.per_layer:
        base = m["name"].removesuffix(".file")
        assert filed.reader(m["name"]).read(ctx) == got[base]


def test_reservoir_keeps_a_uniform_sample_drawn_from_the_seed():
    def run(seed):
        r = Reservoir(seed, 4)
        for i in range(100):
            if r.take(i):
                pass
            if i >= 1:          # answers arrive one item late
                r.keep(i - 1, i - 1)
        r.keep(99, 99)
        return [i for i, _a in r.items()]
    a = run(3)
    assert a == run(3) and len(a) == 4 and a != list(range(4))
    assert run(3) != run(4)
