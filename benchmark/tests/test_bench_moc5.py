"""The MOC5 cell on the CPU at 528x32 (stride 1024, the Wii's stride):
the frozen generator's files read back through the program's demuxer, a
whole run is ``correct``, and one altered sample or the control in the
program's place makes it not ``correct``."""
from __future__ import annotations

import json
import multiprocessing

import numpy as np
import pytest

from benchmark.gen import moc5
from benchmark.harness import spec
from benchmark.run import run_cell

SEED = 2 ** 32 + 29
CELL = "moc5_file"


def tiny_moc5_cell() -> spec.Cell:
    """``moc5_file`` cut to 2 files of 2 GOPs of 12 frames at 528x32: the
    transcoder's launches of 16 frames straddle a GOP, so the second one
    reads what the first left in the ring."""
    cell = spec.load_cell(CELL)
    cfg = json.loads(json.dumps(cell.config))
    cfg.update(width=528, height=32, keyframe_interval=12)
    assert cfg["stride"] == 1024
    tr = dict(cell.traffic, files=2, frames_per_file=24, sample=2)
    return spec.Cell(CELL, cell.workload, cfg, tr, cell.driver,
                     cell.end_to_end, cell.per_layer, 1)


def _run(cell, seed=SEED, seconds=2.0):
    return run_cell(cell, seed, seconds, False, "cpu", workers=2,
                    log=lambda m: None)


def test_generated_file_reads_back_through_the_program_demuxer():
    from mobiclipdecoder_tpu_torch.containers.moc5 import Moc5Demuxer
    cfg = tiny_moc5_cell().config
    gops = [moc5.file_gop(cfg, SEED, 0, g, 5, cfg["iframe_qp"])
            for g in range(2)]
    dm = Moc5Demuxer(moc5.mux_file(cfg, gops))
    h = dm.header
    assert (h.width, h.height, h.fps) == (528, 32, 30.0)
    want = [p for g in gops for p in g["video"]]
    got = list(dm.frames())
    assert len(got) == len(want) == 10
    for k, (a, b) in enumerate(zip(got, want)):
        # the packet, then its zero pad and the next block's 8 header
        # bytes the player leaves behind the payload
        assert a[:len(b)] == b and a[len(b):len(b) + moc5.TAIL] == bytes(
            moc5.TAIL), k


def test_tiny_cell_is_correct():
    r = _run(tiny_moc5_cell())
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == {"pixels_differing", "files_failed"}
    assert set(r["metrics"]) == {"first_frame_p95_ms", "setup_s"}


def test_one_altered_sample_is_not_correct(monkeypatch):
    from mobiclipdecoder_tpu_torch.ops import vmem_engine
    orig = vmem_engine._decode_gop_resid

    def altered(ring, ops, resid, F, H, S):
        r, yuv = orig(ring, ops, resid, F, H, S)
        yuv = yuv.clone()
        yuv[-1, -1, 9, 13] += 1
        return r, yuv
    monkeypatch.setattr(vmem_engine, "_decode_gop_resid", altered)
    r = _run(tiny_moc5_cell())
    assert not r["correct"]
    assert r["checks"]["pixels_differing"]["value"] > 0


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_control_in_the_program_place_is_not_correct(seed):
    """The control (the reference with its residual held to 8 bits) in
    ``decode_moc5``'s place through a whole ``run_cell``."""
    cell = tiny_moc5_cell()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(2) as pool, cell.driver.in_control(cell, pool):
        r = _run(cell, seed, 1.0)
    assert not r["correct"]
    assert r["checks"]["pixels_differing"]["value"] > 0
    assert np.all([c["limit"] == 0 for c in r["checks"].values()])
