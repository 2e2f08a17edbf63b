"""The control of the FastAudio cell's PCM check: the frozen reference in
the program's place, with the lattice's products taken in 32 bits.

The configuration promises every frame's PCM equal to the host FastAudio
decoder's, whose lattice takes each coefficient-times-state product
(coef * hist, coef * r5, and the de-emphasis' r9 * 0x6E14) whole before
its shift: 48 bits and more.  ``NarrowProduct`` wraps each product to 32
bits first, the nearest precision below, and the step that would tempt a
later change to the lattice (an int32 multiply in place of an int64 one).
The video is the exact reference's, so only ``pcm_samples_differing``
can find it wrong, and this script shows that it does.

    python3 benchmark/controls/fastaudio.py --seeds 1,2,3 --seconds 2

puts the control where the ``fastaudio_file`` driver builds the program
(its transcoder entry) and makes a whole run of ``moflex_fastaudio_file``
for each seed, at the cell's own size: the inputs, the warm-up, a short
window, and the check against the reference.  It prints per seed
``correct`` and the numbers compared beside their limits; ``correct``
has to come out false.
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

from benchmark.reference import audio_fastaudio  # noqa: E402
from benchmark.reference.audio_fastaudio import _s32  # noqa: E402
from benchmark.reference.decode import decode_video  # noqa: E402

CELL = "moflex_fastaudio_file"


def _mulshift15(a: int, b: int) -> int:
    return (_s32(a * b) + 0x4000) >> 15


class NarrowProduct(audio_fastaudio.FastAudioDecoder):
    """The reference decoder with each lattice product wrapped to int32."""

    def decode(self) -> np.ndarray:
        out, coef = self.excitation()
        inr = self.internal
        hist = [_s32(int(inr[107 - j])) for j in range(8)]
        r9 = _s32(int(inr[109]))
        result = np.empty(256, dtype=np.int16)
        for i in range(256):
            r5 = int(out[i])
            nh = []
            for j in range(8):
                r5 = _s32(r5 - _mulshift15(coef[j], hist[j]))
                nh.append(_s32(hist[j] + _mulshift15(coef[j], r5)))
            hist = nh[1:] + [r5]
            r9 = _s32(r5 + _mulshift15(r9, 0x6E14))
            result[i] = max(-32768, min(32767, r9 * 2))
        for j in range(8):
            inr[107 - j] = hist[j] & 0xFFFFFFFF
        inr[109] = r9 & 0xFFFFFFFF
        return result


def narrow_pcm(channels: int, gops: list) -> list:
    """``audio_fastaudio.file_pcm`` with ``NarrowProduct`` decoding."""
    exact = audio_fastaudio.FastAudioDecoder
    audio_fastaudio.FastAudioDecoder = NarrowProduct
    try:
        return audio_fastaudio.file_pcm(channels, gops)
    finally:
        audio_fastaudio.FastAudioDecoder = exact


class ControlTranscoder:
    """``decode_moflex``'s place: each frame of the file whose bytes are
    ``data``, with ``y``, ``u``, ``v`` (cropped) from the exact reference
    and ``pcm`` from ``NarrowProduct``.  The files are known by the bytes
    the driver muxed; all of them are decoded the first time one is asked
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
        video = iter(self.pool.starmap(decode_video, [
            (W, H, cfg["version"], g["video"]) for _d, gops in files
            for g in gops]))
        pcm = iter(self.pool.starmap(narrow_pcm, [
            (cfg["audio"]["channels"], [g["audio"] for g in gops])
            for _d, gops in files]))
        for data, gops in files:
            frames = np.concatenate([next(video)[0] for _g in gops])
            samples = next(pcm)
            S = frames.shape[2]
            self.kept[data] = [types.SimpleNamespace(
                y=fr[:H, :W], u=fr[H:, :W // 2],
                v=fr[H:, S // 2:S // 2 + W // 2], pcm=samples[k])
                for k, fr in enumerate(frames)]


@contextlib.contextmanager
def in_place(cell, pool):
    """The control where the cell's driver builds the program, for the
    duration of the block."""
    from mobiclipdecoder_tpu_torch.runtime import transcode
    ctl = ControlTranscoder(cell.config, pool)
    undo = [(cell.driver, "mux_file", cell.driver.mux_file),
            (transcode, "decode_moflex", transcode.decode_moflex)]
    cell.driver.mux_file = ctl.muxed(cell.driver.mux_file)
    transcode.decode_moflex = ctl.decode
    try:
        yield
    finally:
        for obj, name, value in undo:
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
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import spec
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        r = control_run(spec.load_cell(CELL), int(s), args.seconds, device)
        print(json.dumps({"workload": CELL, "seed": int(s),
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
