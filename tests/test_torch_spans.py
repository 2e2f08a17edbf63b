"""The port's spans and counters (runtime/metrics.py) on the transcoder's
and the batch decoder's paths, at 64x48 on the CPU (the plain executor).

Under torch.profiler a MODS and a Moflex file record a span of every host
layer, none inside another and each with frames equal to the oracle's; a
MOC5 file's frame walk is one demux span;
with the profiler off no ``record_function`` is entered; and the counters
of ``DecodeMetrics`` (and the process's ``TOTALS``) equal the sums over
the native scans' results, an executor launch for each scanned GOP."""
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).parent))

from test_mods_e2e import _build_fixture  # noqa: E402
from test_moflex import _build_moflex  # noqa: E402

from mobiclipdecoder_tpu_torch.containers.moc5 import Moc5Muxer  # noqa: E402
from mobiclipdecoder_tpu_torch.models.oracle_video import (  # noqa: E402
    MobiclipVersion)
from mobiclipdecoder_tpu_torch.ops import executor  # noqa: E402
from mobiclipdecoder_tpu_torch.ops.vmem_engine import (  # noqa: E402
    VmemBatchDecoder, VmemVideoDecoder)
from mobiclipdecoder_tpu_torch.runtime import metrics  # noqa: E402
from mobiclipdecoder_tpu_torch.runtime import transcode as pt  # noqa: E402
from mobiclipdecoder_tpu_torch.testing.synth import (  # noqa: E402
    StreamSynthesizer)
from mobiclipdecoder_tpu_torch.utils import native  # noqa: E402

W, H = 64, 48
DS = MobiclipVersion.MODS_DS
LAYERS = ("setup", "demux", "scan", "pack", "dispatch", "device_decode",
          "audio", "emit")
FILES = {"mods": (pt.decode_mods, lambda: _build_fixture(nframes=20)),
         "moflex": (pt.decode_moflex, lambda: _build_moflex(nframes=20))}


def _same(a, b):
    assert len(a) == len(b)
    for k, (fa, fb) in enumerate(zip(a, b)):
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(fa, p), getattr(fb, p),
                                          err_msg=f"frame {k} {p}")
        assert (fa.pcm is None) == (fb.pcm is None), k
        if fa.pcm is not None:
            np.testing.assert_array_equal(fa.pcm, fb.pcm)


def _gops(seeds, ngops, nframes):
    synths = [StreamSynthesizer(W, H, DS, seed=s) for s in seeds]
    return [[[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
             for f in range(nframes)] for _ in range(ngops)]


@pytest.mark.parametrize("kind", sorted(FILES))
def test_a_file_records_every_layer_and_none_nests(kind):
    """More than one chunk (20 frames, CHUNK_FRAMES 16) with audio: every
    layer's span appears, and the spans follow one another on the
    profiler's clock, none inside another."""
    decode, build = FILES[kind]
    blob = build()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = list(decode(blob, engine="cpu"))
    _same(got, list(decode(blob, engine="oracle")))
    assert len(got) == 20 and any(f.pcm is not None for f in got)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.name.startswith("mobiclip."))
    assert {n.removeprefix("mobiclip.") for _a, _b, n in spans} \
        == set(LAYERS)
    assert sum(n == "mobiclip.setup" for _a, _b, n in spans) == 1
    for (_a0, b0, n0), (a1, _b1, n1) in zip(spans, spans[1:]):
        assert a1 >= b0, (n0, n1)


def test_decode_moc5_walks_the_file_in_one_demux_span():
    """A MOC5 file of 20 frames (two chunks, no audio): the whole frame
    walk is one ``mobiclip.demux`` span, first of all, and no span lies
    inside another."""
    synth = StreamSynthesizer(W, H, MobiclipVersion.MOFLEX_3DS, seed=33)
    mux = Moc5Muxer(W, H)
    for i in range(20):
        mux.add_frame(synth.iframe(0x18) if i == 0 else synth.pframe())
    blob = mux.to_bytes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = list(pt.decode_moc5(blob, engine="cpu"))
    _same(got, list(pt.decode_moc5(blob, engine="oracle")))
    assert len(got) == 20
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.name.startswith("mobiclip."))
    names = [n for _a, _b, n in spans]
    assert names.count("mobiclip.demux") == 1
    assert names[0] == "mobiclip.demux"
    assert {n.removeprefix("mobiclip.") for n in names} \
        == set(LAYERS) - {"audio"}
    for (_a0, b0, n0), (a1, _b1, n1) in zip(spans, spans[1:]):
        assert a1 >= b0, (n0, n1)


def test_no_record_function_with_the_profiler_off(monkeypatch):
    """Every decode path with the profiler off: the helper never enters
    record_function.  With a profile taken it does."""
    entered = []

    def counting(name):
        entered.append(name)
        return metrics._NULL
    monkeypatch.setattr(metrics, "record_function", counting)

    def decode_all():
        for decode, build in FILES.values():
            list(decode(build(), engine="cpu"))
        gops = _gops((1, 2), 2, 2)
        dec = VmemBatchDecoder(W, H, DS, batch=2, device="cpu")
        list(dec.decode_gops(iter(gops)))
        dec.decode_gop(gops[0])
        dec.decode_frames(gops[1][0])
    decode_all()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        decode_all()
    assert {"mobiclip." + n for n in LAYERS} <= set(entered)


@pytest.fixture
def scans(monkeypatch):
    """The results of every native whole-GOP scan, in any thread, and
    the number of executor launches."""
    got = types.SimpleNamespace(results=[], launches=0)
    scan = native.NativePlanner.scan_gop_packed
    run_gop = executor.run_gop

    def recording(self, packets):
        r = scan(self, packets)
        got.results.append(r)
        return r

    def counting(*args, **kwargs):
        got.launches += 1
        return run_gop(*args, **kwargs)
    monkeypatch.setattr(native.NativePlanner, "scan_gop_packed", recording)
    monkeypatch.setattr(executor, "run_gop", counting)
    return got


def _check_counters(m, before, scans, launches, frames):
    res = scans.results
    assert scans.launches == launches and m.frames == frames
    assert m.op_chunks == sum(r["nct"] for r in res) > 0
    assert 0 < m.scan_native_seconds <= m.scan_busy_seconds \
        <= m.scan_slot_seconds
    assert m.scan_busy_seconds == pytest.approx(
        sum(r["seconds"] for r in res))
    assert m.bytes_in > 0
    # every add reached the process's totals too
    now = dataclasses.asdict(metrics.TOTALS)
    for k, v in dataclasses.asdict(m).items():
        assert now[k] - getattr(before, k) == pytest.approx(v), k


def test_decode_gops_counters_equal_the_scans(scans):
    before = dataclasses.replace(metrics.TOTALS)
    gops = _gops((3, 4), 3, 3)
    dec = VmemBatchDecoder(W, H, DS, batch=2, device="cpu", native=True)
    assert len(list(dec.decode_gops(iter(gops)))) == 3
    assert len(scans.results) == 2 * 3
    _check_counters(dec.metrics, before, scans, launches=3, frames=18)


def test_decode_stream_chunk_counters_equal_the_scans(scans):
    before = dataclasses.replace(metrics.TOTALS)
    pkts = [fr[0] for fr in _gops((5,), 1, 5)[0]]
    dec = VmemVideoDecoder(W, H, DS, device="cpu", native=True)
    yuv, offs, err = dec.decode_stream_chunk(pkts)
    assert err is None and yuv.shape[0] == len(offs) == 5
    assert len(scans.results) == 1
    _check_counters(dec.metrics, before, scans, launches=1, frames=5)
