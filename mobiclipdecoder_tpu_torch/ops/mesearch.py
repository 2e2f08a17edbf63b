"""Full-search SAD volume for the encoder's motion search.

Port of ``mobiclipdecoder_tpu/ops/mesearch.py``.  The reference analyzer
runs a log/diamond descent per block per reference frame on the CPU
(Analyzer.cs:608-679); here the loop is inverted: the device computes the
SAD of EVERY 8x8 tile of the frame against EVERY full-pel offset in a
+-``range_`` window of EVERY reference frame, a (cands, refs, H/8, W/8)
volume.  Any 8-aligned leaf of the partition lattice then gets its
full-search SAD surface as a sum of tile entries, and the host's
rate-distortion pass reduces to an argmin plus a 3x3 half-pel refinement.

The volume is exact integer SAD; out-of-frame candidates read the
zero-padded reference and must be masked by the caller's legality window
(encoder._mv_range does).  On CUDA tensors ``_sad8_volume`` is one launch
of K7 (``ops/mesearch_kernels.py``, csrc/sad.cu); on CPU tensors it is the
plain torch ``_sad8_volume_plain``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import check_device
from . import mesearch_kernels


def _sad8_volume(cur: torch.Tensor, refs: torch.Tensor,
                 range_: int = 16) -> torch.Tensor:
    """cur: (H, W) int32; refs: (R, H, W) int32, on one device.  Returns
    ((2*range_+1)**2, R, H//8, W//8) int32: entry [k, r, by, bx] is the SAD
    of cur's 8x8 tile (by, bx) against ref r shifted by full-pel
    (dy, dx) = (k // (2*range_+1) - range_, k % (2*range_+1) - range_).

    On CUDA tensors one launch of K7, which takes contiguous tensors or
    raises; on CPU tensors the plain version; any other device raises."""
    if cur.device.type == "cpu":
        return _sad8_volume_plain(cur, refs, range_)
    if cur.device.type != "cuda":
        raise ValueError(f"no SAD volume for device {cur.device}")
    return mesearch_kernels.sad_volume(cur, refs, range_)


def _sad8_volume_plain(cur: torch.Tensor, refs: torch.Tensor,
                       range_: int = 16) -> torch.Tensor:
    """``_sad8_volume`` in plain torch, on whatever device its inputs lie
    on: one chunk per vertical offset: the 2*range_+1 horizontal offsets of a
    row are unfolded views of the padded references, differenced and
    tile-summed together."""
    H, W = cur.shape
    R = refs.shape[0]
    side = 2 * range_ + 1
    pad = torch.nn.functional.pad(refs, (range_, range_, range_, range_))
    cols = pad.unfold(2, W, 1)                     # (R, H + 2r, side, W)
    rows = []
    for dy in range(side):
        win = cols[:, dy:dy + H]                   # (R, H, side, W)
        d = (cur[None, :, None, :] - win).abs()
        s8 = d.reshape(R, H // 8, 8, side, W // 8, 8).sum(
            dim=(2, 5), dtype=torch.int32)         # (R, H/8, side, W/8)
        rows.append(s8.permute(2, 0, 1, 3))
    return torch.cat(rows, dim=0)


class SadVolume:
    """Per-frame full-search helper: the volume on ``device``, the
    reductions on the host."""

    def __init__(self, cur: np.ndarray, refs: list[np.ndarray],
                 range_: int = 16, *, device):
        """cur: (H, W) uint8 target; refs: list of (H, W) uint8 planes
        (reference 1..R in MC order).  A CUDA device that is not there
        raises."""
        dev = check_device(device)
        self.range_ = range_
        self.side = 2 * range_ + 1
        self.R = len(refs)
        if self.R == 0:
            self.vol = None
            return
        c = torch.from_numpy(np.ascontiguousarray(cur, np.int32)).to(dev)
        r = torch.from_numpy(np.stack(refs).astype(np.int32)).to(dev)
        self.vol = _sad8_volume(c, r, range_).cpu().numpy()
        k = np.arange(self.side * self.side)
        self.cand_dy = k // self.side - range_
        self.cand_dx = k % self.side - range_

    def leaf_best(self, bx: int, by: int, w: int, h: int,
                  lo_x: int, hi_x: int, lo_y: int, hi_y: int,
                  nrefs: int):
        """Best full-pel (SAD, ref, mv_halfpel) per reference for the
        8-aligned leaf at (bx, by) size (w, h), restricted to the half-pel
        legality box [lo_x, hi_x] x [lo_y, hi_y].  Returns a list of
        (sad, ref, (mvx, mvy)) sorted best-first, one entry per ref."""
        sums = self.vol[:, :nrefs,
                        by // 8:(by + h) // 8,
                        bx // 8:(bx + w) // 8].sum(axis=(2, 3))
        mvx = 2 * self.cand_dx
        mvy = 2 * self.cand_dy
        ok = ((mvx >= lo_x) & (mvx <= hi_x)
              & (mvy >= lo_y) & (mvy <= hi_y))
        masked = np.where(ok[:, None], sums, 1 << 30)
        best_k = np.argmin(masked, axis=0)            # (nrefs,)
        out = []
        for r in range(nrefs):
            k = int(best_k[r])
            out.append((int(masked[k, r]), r + 1,
                        (int(mvx[k]), int(mvy[k]))))
        out.sort()
        return out
