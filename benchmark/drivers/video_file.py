"""A file converter for containers that carry only video: one file after
another, each decoded whole by the program's transcoder with a decoder of
its own, as the CLI's ``decode`` builds it (without its writer).

The window, its timing of each file's first frame, the end-to-end metrics,
the frozen work counts and the content line are ``drivers/file.py``'s, so
both drivers measure a first frame the same way; the inputs, the
reference and the check are this driver's own: no PCM.

Traffic keys: ``files``, ``frames_per_file`` (a whole number of the
configuration's keyframe intervals), ``sample`` (files kept for the
check).  Each run prints ``[k1]``: the window's executor launches by the
form of K1's working plane (``ops/executor.py``'s counters, card only).
"""
from __future__ import annotations

import contextlib
import types

import numpy as np

from benchmark.controls.control import CONTROL, ControlTranscoder
from benchmark.drivers.file import (COUNTING, content, end_to_end,  # noqa
                                    release, timings, window as file_window,
                                    work)
from benchmark.gen.moc5 import file_gop, mux_file
from benchmark.harness.cell import Check, Window, differing
from benchmark.reference.decode import decode_video

ENTRY = {"moc5": "decode_moc5"}


def _k1_forms() -> tuple[int, int]:
    from mobiclipdecoder_tpu_torch.ops import executor
    return executor.global_plane_launches, executor.smem_plane_launches


def prepare(ctx):
    cfg, tr = ctx.config, ctx.traffic
    K = cfg["keyframe_interval"]
    if tr["frames_per_file"] % K:
        raise ValueError("frames_per_file must be whole keyframe intervals")
    G = tr["frames_per_file"] // K
    flat = ctx.pool.starmap(file_gop, [
        (cfg, ctx.seed, n, g, K, cfg["iframe_qp"])
        for n in range(tr["files"]) for g in range(G)])
    gops = [flat[n * G:(n + 1) * G] for n in range(tr["files"])]
    files = [mux_file(cfg, g) for g in gops]
    from mobiclipdecoder_tpu_torch.runtime import transcode
    engine = "cuda" if ctx.device == "cuda" else "cpu"
    state = {"gops": gops, "files": files, "engine": engine,
             "decode": getattr(transcode, ENTRY[cfg["container"]]),
             "launch_frames": transcode.CHUNK_FRAMES}
    for data in files:
        for _fr in state["decode"](data, engine=engine):
            pass
    return state


def window(ctx, state, seconds: float) -> Window:
    before = _k1_forms()
    win = file_window(ctx, state, seconds)
    global_plane, smem_plane = (b - a for a, b in zip(before, _k1_forms()))
    print(f"[k1] global_plane_launches={global_plane} "
          f"smem_plane_launches={smem_plane}", flush=True)
    return win


def reference(ctx, state):
    cfg = ctx.config
    G = len(state["gops"][0])
    video = ctx.pool.starmap(decode_video, [
        (cfg["width"], cfg["height"], cfg["version"], g["video"], COUNTING)
        for f in state["gops"] for g in f])
    out = []
    for n in range(len(state["gops"])):
        part = video[n * G:(n + 1) * G]
        out.append({"frames": np.concatenate([fr for fr, _c in part]),
                    "counts": [c for _fr, cs in part for c in cs]})
    return out


def checks(ctx, state, win: Window, ref) -> list[Check]:
    W, H, S = (ctx.config[k] for k in ("width", "height", "stride"))
    pix = 0
    for i, frames in win.samples:
        want = ref[win.indices[i]]["frames"]
        for k, wf in enumerate(want):
            fr = frames[k] if k < len(frames) else None
            wy, wuv = wf[:H, :W], wf[H:]
            wu, wv = wuv[:, :W // 2], wuv[:, S // 2:S // 2 + W // 2]
            for got, exp in ((None if fr is None else fr.y, wy),
                             (None if fr is None else fr.u, wu),
                             (None if fr is None else fr.v, wv)):
                pix += differing(got, exp)
        pix += sum(f.y.size + f.u.size + f.v.size for f in frames[len(want):])
    return [Check("pixels_differing", pix, 0),
            Check("files_failed", win.failed, 0)]


class VideoControl(ControlTranscoder):
    """``ControlTranscoder`` for files with no audio: each file's frames
    decoded by the control, with no PCM."""

    def _decode_all(self) -> None:
        cfg = self.cfg
        W, H = cfg["width"], cfg["height"]
        files = list(self.files.items())
        video = iter(self.pool.starmap(decode_video, [
            (W, H, cfg["version"], g["video"], CONTROL)
            for _d, gops in files for g in gops]))
        for data, gops in files:
            frames = np.concatenate([next(video)[0] for _g in gops])
            S = frames.shape[2]
            self.kept[data] = [types.SimpleNamespace(
                y=fr[:H, :W], u=fr[H:, :W // 2],
                v=fr[H:, S // 2:S // 2 + W // 2], pcm=None)
                for fr in frames]


@contextlib.contextmanager
def in_control(cell, pool):
    """The control (``controls/control.py``'s ``CONTROL``, the residual
    held to int8, through ``decode_video``) in the transcoder entry's
    place for the duration of the block; ``run_cell`` inside it has to
    come out not ``correct``."""
    from mobiclipdecoder_tpu_torch.runtime import transcode
    ctl = VideoControl(cell.config, pool)
    entry = ENTRY[cell.config["container"]]
    undo = [(cell.driver, "mux_file", cell.driver.mux_file),
            (transcode, entry, getattr(transcode, entry))]
    cell.driver.mux_file = ctl.muxed(cell.driver.mux_file)
    setattr(transcode, entry, ctl.decode)
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
