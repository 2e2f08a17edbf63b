"""A file converter: one container after another, each decoded whole by
the program's transcoder with a decoder of its own, as the CLI's
``decode`` builds it (without its writer).

Each file is timed from its bytes in memory to its first ``DecodedFrame``
(the decoder is built inside that time); the window cycles the files.

Traffic keys: ``files``, ``frames_per_file`` (a whole number of the
configuration's keyframe intervals), ``sample`` (files kept for the
check).  The frozen byte counts are taken over the transcoder's launches,
``transcode.CHUNK_FRAMES`` frames of a file each.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from benchmark.gen.traffic import file_gop, mux_file
from benchmark.harness import work as frozen
from benchmark.harness.cell import Check, Reservoir, Window, differing
from benchmark.reference.decode import decode_video, file_pcm

COUNTING = "benchmark.harness.work:CountingOracle"
ENTRY = {"mods": "decode_mods", "moflex": "decode_moflex"}


def _gops_per_file(cfg: dict, tr: dict) -> int:
    k = cfg["keyframe_interval"]
    if tr["frames_per_file"] % k:
        raise ValueError("frames_per_file must be whole keyframe intervals")
    return tr["frames_per_file"] // k


def prepare(ctx):
    cfg, tr = ctx.config, ctx.traffic
    G, K = _gops_per_file(cfg, tr), cfg["keyframe_interval"]
    flat = ctx.pool.starmap(file_gop, [
        (cfg, ctx.seed, n, g, K, cfg["iframe_qp"])
        for n in range(tr["files"]) for g in range(G)])
    gops = [flat[n * G:(n + 1) * G] for n in range(tr["files"])]
    files = [mux_file(cfg, g) for g in gops]
    from mobiclipdecoder_tpu_torch.runtime import transcode
    state = {"gops": gops, "files": files,
             "decode": getattr(transcode, ENTRY[cfg["container"]]),
             "launch_frames": transcode.CHUNK_FRAMES}
    engine = "cuda" if ctx.device == "cuda" else "cpu"
    state["engine"] = engine
    for data in files:
        for _fr in state["decode"](data, engine=engine):
            pass
    return state


def window(ctx, state, seconds: float) -> Window:
    files, decode, engine = state["files"], state["decode"], state["engine"]
    res = Reservoir(ctx.seed, ctx.traffic["sample"])
    win = Window()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_end = t0
    while time.perf_counter() < deadline:
        i = win.attempted
        keep = res.take(i)
        win.attempted += 1
        win.indices.append(i % len(files))
        got = []
        try:
            ts = time.perf_counter()
            it = decode(files[i % len(files)], engine=engine)
            first = next(it)
            win.latency_s.append(time.perf_counter() - ts)
            n = 1
            if keep:
                got.append(first)
            for fr in it:
                n += 1
                if keep:
                    got.append(fr)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            win.failed += 1
            continue
        t_end = time.perf_counter()
        win.delivered += 1
        win.done.append(i % len(files))
        win.finished_s.append(t_end - t0)
        win.frames += n
        res.keep(i, got)
    win.elapsed_s = t_end - t0
    win.samples = res.items()
    return win


def release(state) -> None:
    state.pop("decode", None)


def reference(ctx, state):
    cfg = ctx.config
    G = len(state["gops"][0])
    jobs = [(cfg["width"], cfg["height"], cfg["version"], g["video"],
             COUNTING) for f in state["gops"] for g in f]
    video = ctx.pool.starmap_async(decode_video, jobs)
    pcm = ctx.pool.starmap(file_pcm, [
        (cfg["container"], cfg["audio"]["channels"],
         [g["audio"] for g in f]) for f in state["gops"]])
    video = video.get()
    out = []
    for n, samples in enumerate(pcm):
        part = video[n * G:(n + 1) * G]
        out.append({"frames": np.concatenate([fr for fr, _c in part]),
                    "counts": [c for _fr, cs in part for c in cs],
                    "pcm": samples})
    return out


def checks(ctx, state, win: Window, ref) -> list[Check]:
    W, H, S = (ctx.config[k] for k in ("width", "height", "stride"))
    pix = pcm = 0
    for i, frames in win.samples:
        want = ref[win.indices[i]]
        for k, wf in enumerate(want["frames"]):
            fr = frames[k] if k < len(frames) else None
            wy, wuv = wf[:H, :W], wf[H:]
            wu, wv = wuv[:, :W // 2], wuv[:, S // 2:S // 2 + W // 2]
            for got, exp in ((None if fr is None else fr.y, wy),
                             (None if fr is None else fr.u, wu),
                             (None if fr is None else fr.v, wv)):
                pix += differing(got, exp)
            pcm += differing(None if fr is None else fr.pcm, want["pcm"][k])
        pix += sum(f.y.size + f.u.size + f.v.size
                   for f in frames[len(want["frames"]):])
    return [Check("pixels_differing", pix, 0),
            Check("pcm_samples_differing", pcm, 0),
            Check("files_failed", win.failed, 0)]


def work(ctx, state, win: Window, ref) -> dict:
    cfg = ctx.config
    per_file = []
    for r in ref:
        k1 = k5 = 0
        for a, b in frozen.launches(len(r["counts"]),
                                    state["launch_frames"]):
            c = [r["counts"][a:b]]
            k1 += frozen.k1_bytes(c, [a], cfg["height"], cfg["stride"])[
                "bytes"]
            k5 += frozen.k5_bytes(c)["bytes"]
        per_file.append((k1, k5))
    return {"frames": win.frames,
            "k1_bytes": sum(per_file[n][0] for n in win.done),
            "k5_bytes": sum(per_file[n][1] for n in win.done)}


def content(ctx, state, ref) -> dict:
    cfg = ctx.config
    packets = [p for f in state["gops"] for g in f for p in g["video"]]
    counts = [c for r in ref for c in r["counts"]]
    return frozen.content(packets, counts, cfg["width"], cfg["height"],
                          cfg["fps"])


def end_to_end(win: Window) -> dict:
    from benchmark.harness.stats import percentile
    return {"frames_per_s": win.frames / win.elapsed_s,
            "first_frame_p95_ms": percentile(win.latency_s, 95) * 1e3}


def timings(win: Window) -> dict:
    return {"first_frame_ms": [t * 1e3 for t in win.latency_s]}
