"""The port's stage spans (runtime/metrics.py ``span``, a
torch.profiler.record_function while the profiler records, at the sites of
mobiclipdecoder_tpu_torch/ops/vmem_engine.py) against the JAX engine's
jax.profiler.TraceAnnotation spans: the JAX engine's names, in order, are
a subsequence of the port's on the same streams, with frames exactly
equal, at 64x48 on the CPU (the JAX engine in interpret mode, the port
with its plain executor).  The port adds ``mobiclip.dispatch`` (upload and
launches) and records ``mobiclip.scan`` and ``mobiclip.device_decode`` on
every path, the transcoder's chunk path and ``decode_gops`` included."""
import jax
import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from mobiclipdecoder_tpu.models.oracle_video import MobiclipVersion
from mobiclipdecoder_tpu.ops import vmem_engine as jengine
from mobiclipdecoder_tpu.testing.synth import StreamSynthesizer

from mobiclipdecoder_tpu_torch.ops import vmem_engine as tengine
from mobiclipdecoder_tpu_torch.runtime import metrics

W, H = 64, 48
DS = MobiclipVersion.MODS_DS
NAMES = ("mobiclip.scan", "mobiclip.pack", "mobiclip.dispatch",
         "mobiclip.device_decode")
JAX_NAMES = ("mobiclip.scan", "mobiclip.pack", "mobiclip.device_decode")


def _gops(seeds, ngops, nframes):
    synths = [StreamSynthesizer(W, H, DS, seed=s) for s in seeds]
    return [[[s.iframe(0x18) if f == 0 else s.pframe() for s in synths]
             for f in range(nframes)] for _ in range(ngops)]


@pytest.fixture
def spans(monkeypatch):
    """Records the span names each engine enters: {"jax": [...],
    "torch": [...]}."""
    got = {"jax": [], "torch": []}

    def recorder(key):
        class Span:
            def __init__(self, name):
                self.name = name

            def __enter__(self):
                got[key].append(self.name)
                return self

            def __exit__(self, *exc):
                return False
        return Span

    monkeypatch.setattr(jax.profiler, "TraceAnnotation", recorder("jax"))
    # the port's spans open only while a profile records: say it does
    monkeypatch.setattr(metrics, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(metrics, "record_function", recorder("torch"))
    return got


def _is_subsequence(short, long):
    it = iter(long)
    return all(name in it for name in short)


@pytest.mark.parametrize("native", [True, False])
def test_decode_gop_and_decode_gops_record_the_jax_spans(spans, native):
    """decode_gop(fused=True) of one GOP, then decode_gops over two more:
    the native path records scan (whole-GOP scan) and pack (blob
    assembly), the plan path scan (per-frame plans) and pack (chunk
    packing); decode_gop adds device_decode around its download, as the
    JAX engine does; the port adds dispatch, and in decode_gops a dispatch
    for each download's enqueue and a device_decode for each wait."""
    gops = _gops((1, 2), 3, 3)
    jd = jengine.VmemBatchDecoder(W, H, DS, batch=2, interpret=True,
                                  native=native)
    td = tengine.VmemBatchDecoder(W, H, DS, batch=2, device="cpu",
                                  native=native)
    np.testing.assert_array_equal(td.decode_gop(gops[0], fused=True),
                                  jd.decode_gop(gops[0], fused=True))
    assert spans["jax"] == list(JAX_NAMES)
    assert spans["torch"] == list(NAMES)
    assert _is_subsequence(spans["jax"], spans["torch"])
    spans["jax"].clear()
    spans["torch"].clear()
    for a, b in zip(td.decode_gops(iter(gops[1:])),
                    jd.decode_gops(iter(gops[1:])), strict=True):
        np.testing.assert_array_equal(a, b)
    assert spans["jax"] == ["mobiclip.scan", "mobiclip.pack"] * 2
    assert spans["torch"] == [
        "mobiclip.scan", "mobiclip.pack", "mobiclip.dispatch",
        "mobiclip.dispatch"] * 2 + ["mobiclip.device_decode"] * 2
    assert _is_subsequence(spans["jax"], spans["torch"])


@pytest.mark.parametrize("native", [True, False])
def test_decode_stream_chunk_records_the_jax_spans(spans, native):
    """The transcoder's path: the JAX engine records pack alone (its scan
    of the chunk lies outside the stage spans, and it records no
    device_decode); the port records the chunk's scan, pack, dispatch and
    the wait for its download."""
    pkts = [fr[0] for fr in _gops((3,), 1, 3)[0]]
    jv = jengine.VmemVideoDecoder(W, H, DS, interpret=True, native=native)
    tv = tengine.VmemVideoDecoder(W, H, DS, device="cpu", native=native)
    jy, joffs, jerr = jv.decode_stream_chunk(pkts)
    ty, toffs, terr = tv.decode_stream_chunk(pkts)
    assert (toffs, terr) == (joffs, jerr) and terr is None
    np.testing.assert_array_equal(ty, jy)
    assert spans["jax"] == ["mobiclip.pack"]
    assert spans["torch"] == list(NAMES)
    assert _is_subsequence(spans["jax"], spans["torch"])


def test_decode_frames_records_the_jax_spans_in_order(spans):
    """The port's decode_frames is the JAX engine's ring-in-HBM branch (a
    fused F=1 launch), so it records that branch's scan and pack, the
    port's dispatch, then device_decode around its download as the JAX
    per-round branch does: the JAX sequence is a subsequence of the
    port's."""
    frames = _gops((4, 5), 1, 2)[0]
    jd = jengine.VmemBatchDecoder(W, H, DS, batch=2, interpret=True)
    td = tengine.VmemBatchDecoder(W, H, DS, batch=2, device="cpu")
    for fp in frames:
        np.testing.assert_array_equal(td.decode_frames(fp),
                                      jd.decode_frames(fp))
    assert spans["jax"] == ["mobiclip.scan", "mobiclip.device_decode"] * 2
    assert spans["torch"] == list(NAMES) * 2
    assert _is_subsequence(spans["jax"], spans["torch"])


def test_spans_reach_the_torch_profiler():
    """Under torch.profiler (CPU activity only), one decode_gop's four
    spans appear as events, in stage order."""
    frames = _gops((6, 7), 1, 1)[0]
    td = tengine.VmemBatchDecoder(W, H, DS, batch=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        td.decode_gop(frames)
    ours = sorted((e.time_range.start, e.name) for e in prof.events()
                  if e.name in NAMES)
    assert [name for _t, name in ours] == list(NAMES)
