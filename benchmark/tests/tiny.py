"""Cells at a size the CPU tests can hold: the benchmark's own
configurations and traffic mixes, cut to 64x48 and a few frames, run on
the CPU, where the program takes its plain versions."""
from __future__ import annotations

import copy
import json

from benchmark.harness import spec


def tiny_config(name: str) -> dict:
    cfg = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(width=64, height=48, stride=256, keyframe_interval=4)
    return cfg


def tiny_cell(traffic: str, config: str) -> spec.Cell:
    bench = spec.load_benchmark()
    tr = json.loads((spec.HERE / "traffic" / f"{traffic}.json").read_text())
    if tr["driver"] == "corpus":
        tr.update(streams=2, gops_per_stream=2, gop_frames=4, sample=4)
    else:
        tr.update(files=2, frames_per_file=8, sample=2)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or traffic in m["workloads"]]
    layer = [m for m in bench["per_layer"]
             if traffic in m.get("workloads", [traffic])]
    return spec.Cell(traffic, {"name": traffic, "chips": 1},
                     tiny_config(config), tr,
                     spec._module("drivers", tr["driver"], spec.HERE),
                     e2e, layer, 1)
