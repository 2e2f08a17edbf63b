"""Structured decode metrics (SURVEY.md §5 observability).

The reference's only observability is a percent counter in the CLI
(MobiConverter/Program.cs:168-175).  Batch jobs here get per-stage counters —
frames, macroblock ops, coded blocks, bytes, wall-clock per stage — and a
final JSON report aligned with BASELINE.json's metrics.
"""
from __future__ import annotations

import dataclasses
import json
import time


@dataclasses.dataclass
class DecodeMetrics:
    frames: int = 0
    keyframes: int = 0
    bytes_in: int = 0
    mc_blocks: int = 0
    resid_blocks: int = 0
    intra_blocks: int = 0
    intra_levels: int = 0
    pcm_samples: int = 0
    scan_seconds: float = 0.0
    device_seconds: float = 0.0
    wall_seconds: float = 0.0

    def add_plan(self, plan) -> None:
        self.mc_blocks += int(plan.mc.shape[0])
        self.resid_blocks += int(plan.resid.shape[0])
        self.intra_blocks += int(plan.intra.shape[0])
        self.intra_levels += int(plan.n_levels)

    @property
    def fps(self) -> float:
        return self.frames / self.wall_seconds if self.wall_seconds else 0.0

    def report(self) -> dict:
        d = dataclasses.asdict(self)
        d["fps"] = round(self.fps, 2)
        if self.frames:
            d["mc_blocks_per_frame"] = round(self.mc_blocks / self.frames, 1)
            d["intra_blocks_per_frame"] = round(
                self.intra_blocks / self.frames, 1)
        return d

    def json(self) -> str:
        return json.dumps(self.report())


class StageTimer:
    """`with metrics.time(m, "scan_seconds"):` wall-clock accumulator."""

    def __init__(self, metrics: DecodeMetrics, field: str):
        self.m = metrics
        self.field = field

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        setattr(self.m, self.field,
                getattr(self.m, self.field) + time.perf_counter() - self.t0)
        return False
