"""The frozen byte counts of K1 and K5 against chip_smoke.py's
``gop_work`` and ``prologue_work``, term by term, on one small GOP of each
configuration.

The counts share every term that is the content's: the reference frames
read, the intra tables, the frames and ring slots written, the nonzero
coefficients.  They differ where the packing adds to the work: the
program's op rows (blocks merged into fewer rows, plus one header row
per chunk) and its coefficient rows (64 int32 each, four 4x4 blocks to a
row) against one record per block and n*n samples per coded n x n block;
the ring's margins against the frame's own samples; padding rows and
slots in the blob."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.gen.traffic import corpus_stream, version_of
from benchmark.harness import work
from benchmark.reference.decode import decode_video
from benchmark.tests.tiny import tiny_config

B, F = 2, 4


def _case(config: str):
    import chip_smoke
    from mobiclipdecoder_tpu_torch.ops.packing import (
        _assemble_gop_parts, _geom, _part_dense_arrays)
    cfg = tiny_config(config)
    cfg.update(width={"mods_ds_256x192": 256}.get(config, 400),
               height={"mods_ds_256x192": 192}.get(config, 240),
               stride={"mods_ds_256x192": 256}.get(config, 512))
    streams = [corpus_stream(cfg, 11, b, 2, F, cfg["iframe_qp"])
               for b in range(B)]
    g = 1                     # the second GOP reads the first's frames
    gop = [[streams[b][g][f] for b in range(B)] for f in range(F)]
    counts = [decode_video(cfg["width"], cfg["height"], cfg["version"],
                           [p for q in s for p in q],
                           "benchmark.harness.work:CountingOracle")[1]
              [g * F:(g + 1) * F] for s in streams]
    parts = chip_smoke.scanned_parts(version_of(cfg), gop,
                                     (cfg["width"], cfg["height"]))
    ops, _coefs, sizes = _part_dense_arrays(parts)
    blob, nct, nnzb = _assemble_gop_parts(parts)
    _hh, G8, SP = _geom(cfg["height"], cfg["stride"])
    return (cfg, counts, ops, sizes, blob, nct, nnzb, G8 * 8 * SP,
            chip_smoke)


def counts_streams(cfg):
    return [corpus_stream(cfg, 11, b, 2, F, cfg["iframe_qp"])
            for b in range(B)]


def _coef_rows(cfg, streams, g=1) -> int:
    """The program's coefficient rows for GOP g: the planner's rows per
    frame (an empty frame's one dummy row is not referenced)."""
    from mobiclipdecoder_tpu_torch.models.plan import PlanningDecoder
    n = 0
    for s in streams:
        p = PlanningDecoder(cfg["width"], cfg["height"], version_of(cfg))
        for k, pkt in enumerate(q for gop in s for q in gop):
            p.data, p.offset = pkt, 0
            p.decode_frame()
            u = p.unified_plan()
            if k >= g * F and u["sizes"].any():
                n += len(u["sizes"])
    return n


@pytest.mark.parametrize("config", ["mods_ds_256x192", "moflex_3ds_400x240"])
def test_k1_terms_match_gop_work(config):
    cfg, counts, ops, sizes, _b, _n, _z, ring_plane, cs = _case(config)
    H, S = cfg["height"], cfg["stride"]
    k1 = work.k1_bytes(counts, [F] * B, H, S)
    gw = cs.gop_work(ops, F, H, S)
    # the packing's terms, read from its arrays
    fid = ops[:, :, 0, 1]
    live = (fid >= 0) & (fid < F)
    op_rows = int(np.where(live, ops[:, :, 0, 0], 0).sum())
    coef_rows = _coef_rows(cfg, counts_streams(cfg))
    shared = (k1["planes_in"] * ring_plane + k1["terms"]["tables"]
              + (F * B + min(F, 6) * B) * ring_plane)
    assert gw["bytes"] == (op_rows + int(live.sum())) * 16 \
        + coef_rows * 256 + shared
    assert k1["planes_in"] > 0
    # the content's terms against the packing's: merged rows, wider rows
    blocks = k1["terms"]["records"] // work.RECORD_OUT
    assert op_rows <= blocks
    assert k1["terms"]["residuals"] <= coef_rows * 256
    assert k1["terms"]["frames"] == F * B * (H + H // 2) * S


@pytest.mark.parametrize("config", ["mods_ds_256x192", "moflex_3ds_400x240"])
def test_k5_terms_match_prologue_work(config):
    import torch
    cfg, counts, _o, _s, blob, nct, nnzb, _p, cs = _case(config)
    pw = cs.prologue_work(torch.from_numpy(blob), B, nct, nnzb)
    k5 = work.k5_bytes(counts)
    assert pw["nnz"] == k5["terms"]["nonzeros"] // work.NONZERO
    coded = sum(c["coded"] for s in counts for c in s)
    assert pw["rows"] >= coded
    # padding rows and slots are the blob's, not the work's
    assert pw["nnzb"] * B >= pw["nnz"]
    assert k5["bytes"] < pw["sblob"]["bytes"]
