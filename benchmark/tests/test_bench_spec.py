"""Finding a cell's parts by name, and BENCHMARK.json against the
contract's shape."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert hasattr(cell.driver, "window") and hasattr(cell.driver, "checks")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert hasattr(cell.reader(m["name"]), "read")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for entry in (BENCH["configs"] + BENCH["workloads"]
                  + BENCH["end_to_end"] + BENCH["per_layer"]):
        assert NAME.match(entry["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    # each cell that lists a per-layer metric reports the end-to-end
    # metric it moves
    for name in CELLS:
        cell = spec.load_cell(name)
        reported = {m["name"] for m in cell.end_to_end}
        assert {m["moves"] for m in cell.per_layer} <= reported
    for c in BENCH["configs"]:
        assert (spec.REPO / c["file"]).is_file()
        assert json.loads((spec.REPO / c["file"]).read_text())[
            "source"] == c["source"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_a_cell_made_only_of_new_files(tmp_path):
    """A later cell brings a configuration, a traffic mix, a driver and a
    metric as new files, and the harness finds each by its name."""
    root = tmp_path / "benchmark"
    for d in ("configs", "traffic", "drivers", "metrics"):
        (root / d).mkdir(parents=True)
    shutil.copy(spec.HERE / "configs" / "mods_ds_256x192.json",
                root / "configs" / "moc5_wii.json")
    (root / "traffic" / "wii_corpus.json").write_text(
        json.dumps({"driver": "later", "streams": 2}))
    (root / "drivers" / "later.py").write_text(
        "def window(ctx, state, seconds):\n    return None\n"
        "def checks(ctx, state, win, ref):\n    return []\n")
    (root / "metrics" / "dispatch_ms.later.py").write_text(
        "def read(ctx):\n    return None\n")
    bench = json.loads(json.dumps(BENCH))
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("wii_corpus")
    bench["configs"].append({"name": "moc5_wii", "source": "x",
                             "file": "benchmark/configs/moc5_wii.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "wii_corpus", "config": "moc5_wii",
                               "traffic": "wii_corpus", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "dispatch_ms.later", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "host scan", "moves": "frames_per_s",
                               "workloads": ["wii_corpus"]})
    cell = spec.load_cell("wii_corpus", bench, repo=tmp_path, root=root)
    assert cell.traffic["streams"] == 2
    assert cell.driver.window(None, None, 1) is None
    assert [m["name"] for m in cell.per_layer] == ["dispatch_ms.later"]
    assert cell.reader("dispatch_ms.later").read(None) is None
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s",
                                                    "setup_s"]
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell", bench, repo=tmp_path, root=root)
