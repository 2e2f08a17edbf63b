"""A file converter for Moflex files with FastAudio sound: one file after
another, each decoded whole by the program's transcoder with a decoder of
its own, as the CLI's ``decode`` builds it (without its writer).

The window, its timing of each file's first frame, the end-to-end
metrics, the check, the video's frozen work counts and the content line
are ``drivers/file.py``'s, so both drivers measure a first frame the same
way; the inputs (``gen/fastaudio.py``: each frame's chunk before its
video, so a file's first frame waits for its sound), the reference's PCM
(``reference/audio_fastaudio.py``) and the count ``k8_bytes`` are this
driver's own.

``k8_bytes`` is what the FastAudio codec's synthesis has to move, whatever
implements it: 40 bytes read a packet, 2 bytes written a sample, and each
channel's state (8 history words and the de-emphasis word) read and
written once a transcoder launch, launches reckoned as in
``drivers/file.py``.

Traffic keys: ``files``, ``frames_per_file`` (a whole number of the
configuration's keyframe intervals), ``sample`` (files kept for the
check).
"""
from __future__ import annotations

import numpy as np

from benchmark.drivers.file import (COUNTING, checks, content,  # noqa
                                    end_to_end, release, timings, window,
                                    work as file_work)
from benchmark.gen.fastaudio import (PACKET_BYTES, PACKET_SAMPLES, file_gop,
                                     mux_file, rounds)
from benchmark.harness import work as frozen
from benchmark.reference.audio_fastaudio import file_pcm
from benchmark.reference.decode import decode_video

#: a channel's lattice state: 8 history words and the de-emphasis word
STATE_BYTES = 9 * 4


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
             "decode": transcode.decode_moflex,
             "launch_frames": transcode.CHUNK_FRAMES}
    for data in files:
        for _fr in state["decode"](data, engine=engine):
            pass
    return state


def reference(ctx, state):
    cfg = ctx.config
    G = len(state["gops"][0])
    video = ctx.pool.starmap_async(decode_video, [
        (cfg["width"], cfg["height"], cfg["version"], g["video"], COUNTING)
        for f in state["gops"] for g in f])
    pcm = ctx.pool.starmap(file_pcm, [
        (cfg["audio"]["channels"], [g["audio"] for g in f])
        for f in state["gops"]])
    video = video.get()
    out = []
    for n, samples in enumerate(pcm):
        part = video[n * G:(n + 1) * G]
        out.append({"frames": np.concatenate([fr for fr, _c in part]),
                    "counts": [c for _fr, cs in part for c in cs],
                    "pcm": samples})
    return out


def k8_bytes(cfg: dict, frames: int, launch_frames: int) -> int:
    """``k8_bytes`` of one file of ``frames`` frames."""
    a = cfg["audio"]
    packets = a["channels"] * sum(rounds(f, a["frequency"], cfg["fps"])
                                  for f in range(frames))
    launches = len(frozen.launches(frames, launch_frames))
    return (packets * (PACKET_BYTES + 2 * PACKET_SAMPLES)
            + launches * a["channels"] * 2 * STATE_BYTES)


def work(ctx, state, win, ref) -> dict:
    per_file = [k8_bytes(ctx.config, len(r["counts"]), state["launch_frames"])
                for r in ref]
    return {**file_work(ctx, state, win, ref),
            "k8_bytes": sum(per_file[n] for n in win.done)}
