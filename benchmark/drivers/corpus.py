"""A corpus job: B streams decoded in lockstep, GOP after GOP.

The program's ``VmemBatchDecoder.decode_gops`` takes each GOP from an
iterator that the window feeds while its clock runs (a closed loop: the
job waits for its own results), and yields each GOP's (F, B, HH, S) frames
as host numpy.  The streams' GOPs are cycled.

Traffic keys: ``streams`` (B), ``gops_per_stream``, ``gop_frames`` (F: one
I-frame, then P-frames), ``crop`` (false: full-stride frames), ``sample``
(answers kept for the check).
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from benchmark.gen.traffic import corpus_stream, version_of
from benchmark.harness import work as frozen
from benchmark.harness.cell import Check, Reservoir, Window, differing
from benchmark.reference.decode import decode_video

COUNTING = "benchmark.harness.work:CountingOracle"


def prepare(ctx):
    cfg, tr = ctx.config, ctx.traffic
    if tr["crop"]:
        raise ValueError("the corpus driver compares full-stride frames")
    B, G, F = tr["streams"], tr["gops_per_stream"], tr["gop_frames"]
    streams = ctx.pool.starmap(corpus_stream, [
        (cfg, ctx.seed, b, G, F, cfg["iframe_qp"]) for b in range(B)])
    gops = [[[streams[b][g][f] for b in range(B)] for f in range(F)]
            for g in range(G)]
    from mobiclipdecoder_tpu_torch.ops.vmem_engine import VmemBatchDecoder
    dec = VmemBatchDecoder(cfg["width"], cfg["height"],
                           int(version_of(cfg)), batch=B, native=True,
                           device=ctx.device, crop=False)
    for _ in range(2):
        for _out in dec.decode_gops(iter(gops)):
            pass
    return {"gops": gops, "streams": streams, "dec": dec}


def window(ctx, state, seconds: float) -> Window:
    gops, dec = state["gops"], state["dec"]
    res = Reservoir(ctx.seed, ctx.traffic["sample"])
    win = Window()
    sent: list[float] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def feed():
        while time.perf_counter() < deadline:
            i = len(sent)
            res.take(i)
            sent.append(time.perf_counter())
            win.indices.append(i % len(gops))
            yield gops[i % len(gops)]
    t_end = t0
    try:
        for i, out in enumerate(dec.decode_gops(feed())):
            t_end = time.perf_counter()
            win.latency_s.append(t_end - sent[i])
            win.finished_s.append(t_end - t0)
            win.delivered += 1
            win.frames += out.shape[0] * out.shape[1]
            res.keep(i, out)
    except Exception:
        traceback.print_exc(file=sys.stderr)
    win.attempted = len(sent)
    win.failed = win.attempted - win.delivered
    win.done = win.indices[:win.delivered]
    win.elapsed_s = t_end - t0
    win.samples = res.items()
    return win


def release(state) -> None:
    state.pop("dec", None)


def reference(ctx, state):
    cfg, tr = ctx.config, ctx.traffic
    G, F = tr["gops_per_stream"], tr["gop_frames"]
    done = ctx.pool.starmap(decode_video, [
        (cfg["width"], cfg["height"], cfg["version"],
         [p for gop in s for p in gop], COUNTING) for s in state["streams"]])
    frames = [np.stack([fr[g * F:(g + 1) * F] for fr, _c in done], axis=1)
              for g in range(G)]
    return {"frames": frames, "counts": [c for _fr, c in done]}


def checks(ctx, state, win: Window, ref) -> list[Check]:
    bad = sum(differing(out, ref["frames"][win.indices[i]])
              for i, out in win.samples)
    return [Check("pixels_differing", bad, 0),
            Check("gops_missing", win.attempted - win.delivered, 0)]


def work(ctx, state, win: Window, ref) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    F = tr["gop_frames"]
    per_gop = []
    for g in range(tr["gops_per_stream"]):
        counts = [c[g * F:(g + 1) * F] for c in ref["counts"]]
        first = [g * F] * len(counts)
        per_gop.append((
            frozen.k1_bytes(counts, first, cfg["height"], cfg["stride"])[
                "bytes"], frozen.k5_bytes(counts)["bytes"]))
    return {"frames": win.frames,
            "k1_bytes": sum(per_gop[g][0] for g in win.done),
            "k5_bytes": sum(per_gop[g][1] for g in win.done)}


def content(ctx, state, ref) -> dict:
    cfg = ctx.config
    packets = [p for s in state["streams"] for g in s for p in g]
    counts = [c for cs in ref["counts"] for c in cs]
    return frozen.content(packets, counts, cfg["width"], cfg["height"],
                          cfg["fps"])


def end_to_end(win: Window) -> dict:
    return {"frames_per_s": win.frames / win.elapsed_s}


def timings(win: Window) -> dict:
    return {"gop_latency_ms": [t * 1e3 for t in win.latency_s]}
