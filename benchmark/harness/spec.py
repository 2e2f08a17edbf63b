"""Finding a cell's parts by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each part
lives in a file of its own under this folder, found by that name:

* a configuration: the file its ``configs`` entry names;
* a traffic mix: ``traffic/<traffic>.json``, whose ``driver`` key names
  ``drivers/<driver>.py``;
* a per-layer metric: ``metrics/<name>.py``, a reader with
  ``read(ctx) -> float | None``.

So a later cell, configuration, traffic mix, driver or metric is added as
new files and entries, without an edit to a file that is here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]     # benchmark/
REPO = HERE.parent


def _module(kind: str, name: str, root: Path):
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    key = "benchmark_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """Everything a run of one cell needs, found by name."""
    name: str
    workload: dict
    config: dict
    traffic: dict
    driver: object
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int
    root: Path = HERE       # the benchmark folder the parts are found in

    def reader(self, metric: str):
        """The per-layer metric ``metric``'s reader module."""
        return reader(metric, self.root)


def reader(metric: str, root: Path = HERE):
    """The reader module ``metrics/<metric>.py`` under ``root``."""
    return _module("metrics", metric, root)


def load_benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench: dict | None = None, repo: Path = REPO,
              root: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (``repo``'s BENCHMARK.json when
    None), with its configuration, traffic mix, driver and metrics."""
    bench = load_benchmark(repo) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; the cells are "
                       f"{sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((repo / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    driver = _module("drivers", traffic["driver"], root)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, w, config, traffic, driver, e2e, layer,
                int(w["chips"]), root)
