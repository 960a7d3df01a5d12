"""The benchmark's files: BENCHMARK.json against its contract, every file
it names, and a cell added as a file found with no edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from gsbench import harness as H
from gsbench.run import load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = H.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gsbench/run.py"]
    assert BENCH["paths"] == ["gsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert layers == {"step", "render", "backward", "optimizer", "kernels",
                      "device", "view"}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist_and_parse(cell):
    entry = H.cell_entry(BENCH, cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    w = H.load_json(H.HERE / "workloads" / f"{cell}.json")
    assert (w["config"], w["traffic"]) == (entry["config"], entry["traffic"])
    cfg = H.load_json(H.HERE / "configs" / f"{entry['config']}.json")
    assert cfg["name"] == entry["config"] and cfg["chips"] == 1
    assert (H.HERE / "traffic" / f"{w['traffic']}.py").exists()
    e2e = {m["name"] for m in H.end_to_end_metrics(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = H.per_layer_metrics(BENCH, cell)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert hasattr(H.load_module(H.HERE / "metrics" /
                                     f"{m['name']}.py"), "read")


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_files(config):
    cfg = H.load_json(H.REPO / config["file"])
    assert config["file"].startswith("gsbench/configs/")
    assert cfg["name"] == config["name"]
    assert (cfg["source"], cfg["reduced"]) == (config["source"],
                                               config["reduced"])
    # every cut says why in the file's "assumed"
    assert all(k in cfg["assumed"] for k in config["reduced"])
    assert cfg["num_gaussians"] == 52363
    assert (cfg["width"], cfg["height"]) == (5068, 3324)
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_a_cell_added_as_a_file_is_found(tmp_path):
    """A new workload file and its BENCHMARK.json entry are all a new cell
    needs."""
    for sub in ("workloads", "configs"):
        shutil.copytree(H.HERE / sub, tmp_path / sub)
    new = H.load_json(tmp_path / "workloads" / "treehill_ref.render.json")
    new["params"]["cameras"] = 8
    (tmp_path / "workloads" / "treehill_ref.orbit8.json").write_text(
        json.dumps(new))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="treehill_ref.orbit8",
                                   config="treehill_ref", traffic="render",
                                   chips=1, why="eight cameras"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "treehill_3dgs.render" in m.get("workloads", ()):
            m["workloads"].append("treehill_ref.orbit8")
    cell, chips = load_cell(bench, "treehill_ref.orbit8", 1, 1.0, False,
                            "cpu", root=tmp_path)
    assert chips == 1 and cell.params["cameras"] == 8
    assert cell.traffic == "render"
    assert "render_p95_ms" in {m["name"] for m in
                               H.end_to_end_metrics(bench, cell.name)}
    with pytest.raises(SystemExit):
        load_cell(bench, "treehill_ref.orbit9", 1, 1.0, False, "cpu",
                  root=tmp_path)
