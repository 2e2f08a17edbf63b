"""Multi-stream batched decoding on the wavefront engine.

Port of ``mobiclipdecoder_tpu/parallel/batch.py``.  Per-stream FramePlans
are stacked into (B, ...) arrays padded to shared shapes, and the whole
batch is reconstructed by one ``decode_frame_core`` call per frame round
(on the card one launch of K6); ``decode_gop`` uploads a GOP's plans once
and runs it as a loop over frames on a (B, 6, HH, S) int32 ring that stays
on the device.  ``devices=[...]``, the counterpart of the
JAX package's ``mesh=``, splits the stream batch into equal shards, one
per device: each device keeps its shard's ring and runs
``decode_frame_core`` on its shard's rows of every frame round.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.oracle_video import MobiclipVersion
from ..models.pipeline import decode_frame_core, prepare_plan
from ..models.plan import PlanningDecoder
from ..utils.device import check_device


def stack_plans(prepared: list[dict]) -> dict:
    """Pad a list of prepare_plan() outputs to common shapes (zeros after
    each array's end) and stack."""
    out = {}
    for key in ("mc", "resid", "resid_coef", "iops", "icoef", "seqmap",
                "n_levels"):
        arrs = [np.asarray(p[key]) for p in prepared]
        tgt = tuple(max(a.shape[d] for a in arrs)
                    for d in range(arrs[0].ndim))
        out[key] = np.zeros((len(arrs),) + tgt, np.result_type(*arrs))
        for i, a in enumerate(arrs):
            out[key][(i,) + tuple(slice(0, n) for n in a.shape)] = a
    return out


def upload_rounds(rounds: list[dict], device) -> list[dict]:
    """Host arrays of several frame rounds (stack_plans() outputs,
    ``n_levels`` included) -> per round a dict of int32 tensors on
    ``device``, each a view of one upload of all of them."""
    parts, layout, off = [], [], 0
    for arrays in rounds:
        lay = {}
        for k, v in arrays.items():
            a = np.ascontiguousarray(v, np.int32)
            lay[k] = (off, a.shape)
            parts.append(a.ravel())
            off += a.size
        layout.append(lay)
    blob = torch.from_numpy(np.concatenate(parts)).to(device)
    return [{k: blob[o:o + int(np.prod(sh))].view(sh)
             for k, (o, sh) in lay.items()} for lay in layout]


class BatchVideoDecoder:
    """Decodes B independent streams in lockstep, one ``decode_frame_core``
    call per frame round, on ``device``, or with the streams split into
    equal contiguous shards over ``devices`` (one call per shard and
    round).  One of the two is required; a CUDA device that is not there
    raises."""

    def __init__(self, width: int, height: int, version: MobiclipVersion,
                 batch: int, *, device=None, devices=None,
                 native: bool | None = None):
        if (device is None) == (devices is None):
            raise TypeError("give exactly one of device and devices")
        self.devices = [check_device(d) for d in (
            [device] if devices is None else devices)]
        if not self.devices or batch % len(self.devices):
            raise ValueError(f"{batch} streams do not split over "
                             f"{len(self.devices)} devices")
        self.device = self.devices[0]
        self.B = batch
        self.planners = [PlanningDecoder(width, height, version)
                         for _ in range(batch)]
        self.natives = None
        if native is not False:
            try:
                from ..utils.native import NativePlanner
                self.natives = [NativePlanner(width, height, int(version))
                                for _ in range(batch)]
            except (OSError, AttributeError, RuntimeError):
                if native is True:
                    raise
        self.width, self.height = width, height
        self.stride = self.planners[0].stride
        HH = height + height // 2
        per = batch // len(self.devices)
        self.rings = [torch.zeros((per, 6, HH, self.stride),
                                  dtype=torch.int32, device=d)
                      for d in self.devices]

    @property
    def ring(self) -> torch.Tensor:
        """The (B, 6, HH, S) int32 ring: on the device, or with several
        devices joined on the CPU."""
        if len(self.rings) == 1:
            return self.rings[0]
        return torch.cat([r.cpu() for r in self.rings])

    def scan_packets(self, packets: list[bytes]) -> dict:
        """One frame per stream -> stacked prepare_plan() host arrays."""
        if len(packets) != self.B:
            raise ValueError(f"{len(packets)} packets for {self.B} streams")
        prepared = []
        if self.natives is not None:
            for nat, pkt in zip(self.natives, packets):
                prepared.append(prepare_plan(nat.scan(pkt)))
        else:
            for planner, pkt in zip(self.planners, packets):
                planner.data = pkt
                planner.offset = 0
                planner.decode_frame()
                prepared.append(prepare_plan(planner.plan()))
        return stack_plans(prepared)

    def _shards(self, arrays: dict) -> list[dict]:
        """Stacked host arrays -> each shard's rows."""
        per = self.B // len(self.devices)
        return [{k: v[i * per:(i + 1) * per] for k, v in arrays.items()}
                for i in range(len(self.devices))]

    def _round(self, uploads: list[dict]) -> list[torch.Tensor]:
        """Roll each shard's ring, decode one frame round from the shard's
        uploaded plan tensors into slot 0; returns each shard's (B/n, HH,
        S) int32 frames on its device."""
        bufs = []
        for i, t in enumerate(uploads):
            ring = torch.roll(self.rings[i], 1, dims=1)
            buf = decode_frame_core(ring, t["mc"], t["resid"],
                                    t["resid_coef"], t["iops"], t["icoef"],
                                    t["seqmap"], t["n_levels"], self.height,
                                    self.stride)
            ring[:, 0] = buf
            self.rings[i] = ring
            bufs.append(buf)
        return bufs

    def _upload(self, rounds: list[dict]) -> list[list[dict]]:
        """Frame rounds of stacked host arrays -> per round, each shard's
        plan tensors: one upload per shard.  Every upload comes before any
        decode: a copy from pageable memory waits for its stream, which
        would hold a repeated device's next shard."""
        shards = [self._shards(r) for r in rounds]
        per_shard = [upload_rounds([s[i] for s in shards], d)
                     for i, d in enumerate(self.devices)]
        return [list(shards) for shards in zip(*per_shard)]

    def decode_frames(self, packets: list[bytes]) -> np.ndarray:
        """One frame per stream; returns (B, HH, S) uint8 planes."""
        bufs = self._round(self._upload([self.scan_packets(packets)])[0])
        return np.concatenate([b.to(torch.uint8).cpu().numpy()
                               for b in bufs])

    def decode_gop(self, frames: list[list[bytes]]) -> np.ndarray:
        """frames[f][b] = packet of frame f of stream b.  Every frame is
        scanned and uploaded first (one upload per shard), and the frames
        stay on the device until the GOP is done; returns (F, B, HH, S)
        uint8."""
        uploads = self._upload([self.scan_packets(fp) for fp in frames])
        steps = [[b.to(torch.uint8) for b in self._round(u)]
                 for u in uploads]
        return np.concatenate([torch.stack(shard).cpu().numpy()
                               for shard in zip(*steps)], axis=1)
