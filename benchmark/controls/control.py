"""The control of the benchmark's check: the reference in the program's
place, with one guarantee that the configurations state broken.

The configurations promise Y, U and V samples equal to the spec decoder's.
``NarrowResidual`` is the frozen oracle with its spatial residual held to
8 bits (each sample clamped to [-128, 127] before it is added): the step
that would tempt a later change, since the residual rows between the
prologue and the executor are the largest traffic of a GOP, and a row of
int8 moves a quarter of the bytes of int32.  The benchmark's check must
find it wrong, and this script shows that it does.

    python3 benchmark/controls/control.py --workload moflex_corpus_b8 \
        --seeds 1,2,3 --seconds 2

puts the control where the cell's driver builds the program (the corpus
driver's ``VmemBatchDecoder``, the file driver's transcoder entry) and
makes a whole run of the cell for each seed, at the cell's own size: the
inputs, the warm-up, a short window, and the check against the reference.
It prints per seed ``correct`` and the numbers compared beside their
limits; ``correct`` has to come out false.  The control runs on the host's
cores, in a process pool of its own; each answer is decoded once and kept,
so the window's cycle of the same inputs gives the same answers again.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import sys
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.reference.decode import decode_video, file_pcm  # noqa: E402
from benchmark.reference.oracle_video import OracleDecoder  # noqa: E402

CONTROL = "benchmark.controls.control:NarrowResidual"


class NarrowResidual(OracleDecoder):
    """The oracle with each spatial residual sample clamped to int8."""

    def _add_clamp(self, plane, off, res):
        super()._add_clamp(plane, off, np.clip(res, -128, 127))


class ControlBatchDecoder:
    """``VmemBatchDecoder``'s place: ``decode_gops`` yields each GOP's
    (F, B, HH, S) frames, decoded by the control.  A GOP's answer depends
    on the GOPs before it, so the first time a GOP follows a given GOP,
    every stream is decoded from its start through the GOPs taken so far;
    later the kept answer is given again."""

    def __init__(self, width, height, version, batch, pool, **_kw):
        from benchmark.reference.oracle_video import MobiclipVersion
        self.args = (width, height, MobiclipVersion(int(version)).name)
        self.batch, self.pool = batch, pool
        self.taken: list = []
        self.kept: dict = {}

    def decode_gops(self, gops):
        for gop in gops:
            key = (id(self.taken[-1]) if self.taken else None, id(gop))
            self.taken.append(gop)
            if key not in self.kept:
                self.kept[key] = self._decode(len(gop))
            yield self.kept[key]

    def _decode(self, frames: int) -> np.ndarray:
        streams = [[p for g in self.taken for p in (f[b] for f in g)]
                   for b in range(self.batch)]
        done = self.pool.starmap(decode_video, [
            self.args + (s, CONTROL) for s in streams])
        return np.stack([fr[-frames:] for fr, _x in done], axis=1)


class ControlTranscoder:
    """The transcoder entry's place: ``decode(data, engine)`` yields each
    frame of the file whose container bytes are ``data``, with ``y``,
    ``u``, ``v`` (cropped) and ``pcm``, the video decoded by the control
    and the audio by the reference.  The files are known by the bytes the
    driver muxed; all of them are decoded the first time one is asked
    for."""

    def __init__(self, cfg: dict, pool):
        self.cfg, self.pool = cfg, pool
        self.files: dict[bytes, list[dict]] = {}
        self.kept: dict[bytes, list] = {}

    def muxed(self, mux):
        def f(cfg, gops):
            data = mux(cfg, gops)
            self.files[data] = gops
            return data
        return f

    def decode(self, data: bytes, engine=None):
        if data not in self.kept:
            self._decode_all()
        yield from self.kept[data]

    def _decode_all(self) -> None:
        cfg = self.cfg
        W, H = cfg["width"], cfg["height"]
        files = list(self.files.items())
        jobs = [(W, H, cfg["version"], g["video"], CONTROL)
                for _d, gops in files for g in gops]
        video = iter(self.pool.starmap(decode_video, jobs))
        for data, gops in files:
            frames = np.concatenate([next(video)[0] for _g in gops])
            pcm = file_pcm(cfg["container"], cfg["audio"]["channels"],
                           [g["audio"] for g in gops])
            S = frames.shape[2]
            self.kept[data] = [types.SimpleNamespace(
                y=fr[:H, :W], u=fr[H:, :W // 2],
                v=fr[H:, S // 2:S // 2 + W // 2], pcm=pcm[k])
                for k, fr in enumerate(frames)]


@contextlib.contextmanager
def in_place(cell, pool):
    """The control where ``cell``'s driver builds the program, for the
    duration of the block."""
    kind = cell.traffic["driver"]
    undo = []

    def put(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    if kind == "corpus":
        from mobiclipdecoder_tpu_torch.ops import vmem_engine
        put(vmem_engine, "VmemBatchDecoder",
            lambda *a, **k: ControlBatchDecoder(*a, pool=pool, **k))
    elif kind == "file":
        from mobiclipdecoder_tpu_torch.runtime import transcode
        ctl = ControlTranscoder(cell.config, pool)
        put(cell.driver, "mux_file", ctl.muxed(cell.driver.mux_file))
        put(transcode, cell.driver.ENTRY[cell.config["container"]],
            ctl.decode)
    else:
        raise ValueError(f"no control for the {kind!r} driver")
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def control_run(cell, seed: int, seconds: float, device: str,
                workers: int | None = None) -> dict:
    """A whole run of ``cell`` with the control in the program's place:
    the result object, whose ``correct`` has to be false."""
    from benchmark.run import run_cell
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers or os.cpu_count()) as pool, in_place(cell, pool):
        return run_cell(cell, seed, seconds, False, device,
                        workers=workers, log=lambda m: None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import spec
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        cell = spec.load_cell(args.workload)
        r = control_run(cell, int(s), args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
