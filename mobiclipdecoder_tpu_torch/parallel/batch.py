"""Multi-stream batched decoding on the wavefront engine.

Port of ``mobiclipdecoder_tpu/parallel/batch.py``.  Per-stream FramePlans
are stacked into (B, ...) arrays padded to shared shapes, and the whole
batch is reconstructed by one ``decode_frame_core`` call per frame round;
``decode_gop`` runs a GOP as a loop over frames on a (B, 6, HH, S) int32
ring that stays on the device.  The JAX package's mesh argument is not
ported: the port runs one process per GPU (parallel/distributed.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.oracle_video import MobiclipVersion
from ..models.pipeline import decode_frame_core, prepare_plan, upload_plan
from ..models.plan import PlanningDecoder
from ..utils.device import check_device


def _pad_to(a: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    if a.ndim == 0 or a.shape == tuple(shape):
        return a
    pads = [(0, t - s) for s, t in zip(a.shape, shape)]
    return np.pad(a, pads)


def stack_plans(prepared: list[dict]) -> dict:
    """Pad a list of prepare_plan() outputs to common shapes and stack."""
    out = {}
    for key in ("mc", "resid", "resid_coef", "iops", "icoef", "seqmap",
                "n_levels"):
        arrs = [np.asarray(p[key]) for p in prepared]
        tgt = tuple(max(a.shape[d] for a in arrs)
                    for d in range(arrs[0].ndim))
        out[key] = np.stack([_pad_to(a, tgt) for a in arrs])
    return out


class BatchVideoDecoder:
    """Decodes B independent streams in lockstep, one ``decode_frame_core``
    call per frame round, on ``device`` (required; a CUDA device that is
    not there raises)."""

    def __init__(self, width: int, height: int, version: MobiclipVersion,
                 batch: int, *, device, native: bool | None = None):
        self.device = check_device(device)
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
        self.ring = torch.zeros((batch, 6, HH, self.stride),
                                dtype=torch.int32, device=self.device)

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

    def _step(self, arrays: dict) -> torch.Tensor:
        """Roll the ring, decode one frame round into slot 0; returns the
        (B, HH, S) int32 frames on the device."""
        t = upload_plan(arrays, self.device)
        ring = torch.roll(self.ring, 1, dims=1)
        buf = decode_frame_core(ring, t["mc"], t["resid"], t["resid_coef"],
                                t["iops"], t["icoef"], t["seqmap"],
                                arrays["n_levels"], self.height, self.stride)
        ring[:, 0] = buf
        self.ring = ring
        return buf

    def decode_frames(self, packets: list[bytes]) -> np.ndarray:
        """One frame per stream; returns (B, HH, S) uint8 planes."""
        buf = self._step(self.scan_packets(packets))
        return buf.to(torch.uint8).cpu().numpy()

    def decode_gop(self, frames: list[list[bytes]]) -> np.ndarray:
        """frames[f][b] = packet of frame f of stream b.  The frames stay
        on the device until the GOP is done; returns (F, B, HH, S) uint8."""
        per_frame = [self.scan_packets(fp) for fp in frames]
        bufs = [self._step(arrays).to(torch.uint8) for arrays in per_frame]
        return torch.stack(bufs).cpu().numpy()
