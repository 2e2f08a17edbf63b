"""Multi-stream batched decoding on the wavefront engine.

Port of ``mobiclipdecoder_tpu/parallel/batch.py``.  Per-stream FramePlans
are stacked into (B, ...) arrays padded to shared shapes per frame round
(each round keeps its own shapes); ``decode_gop`` uploads a GOP's rounds
once and decodes them in one ``models/pipeline.py`` ``decode_gop`` call
(on the card one launch of K6, the JAX package's ``decode_gop_jit``) on a
(B, 6, HH, S) int32 ring that stays on the device; ``decode_frames`` is
the same with one round.  The ring keeps physical slots, its logical slot
0 at ``head`` (``ring`` gives the logical order).  ``devices=[...]``, the
counterpart of the JAX package's ``mesh=``, splits the stream batch into
equal shards, one per device: each device keeps its shard's ring and
decodes its shard's rows of every frame round, one call per shard.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.oracle_video import MobiclipVersion
from ..models.pipeline import decode_gop, prepare_plan
from ..models.plan import PlanningDecoder
from ..ops.wavefront_kernels import GopPlans, upload_gop
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
    ``device``, each a view of one upload of all of them
    (``upload_gop``'s rounds)."""
    return upload_gop(rounds, device).rounds


class BatchVideoDecoder:
    """Decodes B independent streams in lockstep, one ``decode_gop`` call
    per GOP (or frame round) on ``device``, or with the streams split into
    equal contiguous shards over ``devices`` (one call per shard).  One of
    the two is required; a CUDA device that is not there raises."""

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
        # physical slots; logical slot 0 (the last frame) is slot head
        self.rings = [torch.zeros((per, 6, HH, self.stride),
                                  dtype=torch.int32, device=d)
                      for d in self.devices]
        self.head = 0

    @property
    def ring(self) -> torch.Tensor:
        """The (B, 6, HH, S) int32 ring in logical order (slot r the frame r
        back): on the device, or with several devices joined on the CPU."""
        rings = [torch.roll(r, -self.head, dims=1) for r in self.rings]
        if len(rings) == 1:
            return rings[0]
        return torch.cat([r.cpu() for r in rings])

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

    def _upload(self, rounds: list[dict]) -> list[GopPlans]:
        """Frame rounds of stacked host arrays -> each shard's GopPlans: one
        upload per shard.  Every upload comes before any decode: a copy
        from pageable memory waits for its stream, which would hold a
        repeated device's next shard."""
        shards = [self._shards(r) for r in rounds]
        return [upload_gop([s[i] for s in shards], d)
                for i, d in enumerate(self.devices)]

    def _decode(self, rounds: list[dict]) -> np.ndarray:
        """Every shard's rounds in one ``decode_gop`` call each, then one
        copy to the host each; (F, B, HH, S) uint8."""
        outs = [decode_gop(ring, self.head, plans, self.height, self.stride)
                for ring, plans in zip(self.rings, self._upload(rounds))]
        self.head = (self.head + 5 * len(rounds)) % 6
        return np.concatenate([o.cpu().numpy() for o in outs], axis=1)

    def decode_frames(self, packets: list[bytes]) -> np.ndarray:
        """One frame per stream; returns (B, HH, S) uint8 planes."""
        return self._decode([self.scan_packets(packets)])[0]

    def decode_gop(self, frames: list[list[bytes]]) -> np.ndarray:
        """frames[f][b] = packet of frame f of stream b.  Every frame is
        scanned and uploaded first (one upload per shard), then each shard
        decodes the GOP in one call; returns (F, B, HH, S) uint8."""
        return self._decode([self.scan_packets(fp) for fp in frames])
