"""The benchmark's files: BENCHMARK.json against its contract, every file
it names, the scene recipes, and a cell, or a configuration of its own
size with its own recipe, added as files and found with no edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from gsbench import harness as H
from gsbench import scene
from gsbench.run import load_cell
from gsbench.tests.tiny import run_tiny, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = H.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# the layers of PERF.md's list; a later metric may name a new one
LAYERS = {"step", "render", "backward", "optimizer", "kernels", "device",
          "view"}
# the configurations already measured keep their size and recipe; a
# configuration of another size comes as a file of its own
PINNED = {
    "treehill_3dgs": dict(num_gaussians=52363, width=5068, height=3324,
                          init="knn3"),
    "treehill_ref": dict(num_gaussians=52363, width=5068, height=3324,
                         init="constant", scale=0.001),
}


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
    assert layers >= LAYERS
    assert all(NAME.match(layer) for layer in layers - LAYERS)
    assert len(json.dumps(BENCH)) < 64 * 1024


def check_cell(bench: dict, cell: str, root=H.HERE) -> None:
    """A cell's entry and the files it is found by under ``root``."""
    entry = H.cell_entry(bench, cell)
    assert entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    w = H.load_json(root / "workloads" / f"{cell}.json")
    assert (w["config"], w["traffic"]) == (entry["config"], entry["traffic"])
    cfg = H.load_json(root / "configs" / f"{entry['config']}.json")
    assert cfg["name"] == entry["config"] and cfg["chips"] == entry["chips"]
    assert (H.HERE / "traffic" / f"{w['traffic']}.py").exists()
    e2e = {m["name"] for m in H.end_to_end_metrics(bench, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = H.per_layer_metrics(bench, cell)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert hasattr(H.load_module(H.HERE / "metrics" /
                                     f"{m['name']}.py"), "read")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist_and_parse(cell):
    check_cell(BENCH, cell)


def test_few_cells_take_four_chips():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(CELLS) // 4)


def check_config(bench: dict, config: dict, root=H.HERE) -> None:
    """A configuration's entry and its file under ``root``."""
    assert config["file"] == f"gsbench/configs/{config['name']}.json"
    cfg = H.load_json(root / "configs" / f"{config['name']}.json")
    assert cfg["name"] == config["name"]
    assert (cfg["source"], cfg["reduced"]) == (config["source"],
                                               config["reduced"])
    # every cut says why in the file's "assumed"
    assert all(k in cfg["assumed"] for k in config["reduced"])
    for key in ("num_gaussians", "width", "height"):
        assert type(cfg[key]) is int and cfg[key] > 0, key
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    scene.recipe(cfg["init"])                  # raises for an unknown one
    assert any(w["config"] == config["name"] for w in bench["workloads"])


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_files(config):
    check_config(BENCH, config)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_measured_configurations_keep_their_size(name):
    cfg = H.load_json(H.HERE / "configs" / f"{name}.json")
    assert {k: cfg[k] for k in PINNED[name]} == PINNED[name]


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


# sums over the points (the first 300 slots) and over the pool of 1,200 of
# each leaf that the built-in recipes made before recipes could be files:
# treehill config cut to 300 points, seed 5, sh_rest_std 0.1, on the CPU.
# The tolerance covers last-bit differences of vectorised log between CPUs.
BUILT_IN_SUMS = {
    "treehill_3dgs": dict(
        means=(-54.98908861342352, -54.98908861342352),
        log_scales=(260.11404360010056, -18390.825468652707),
        quats=(300.0, 1200.0),
        opacity_logits=(659.1673851013184, -17340.83261489868),
        sh=(60.32343764274174, 60.32343764274174)),
    "treehill_ref": dict(
        means=(-54.98908861342352, -54.98908861342352),
        log_scales=(-6216.9798374176025, -24867.91934967041),
        quats=(300.0, 1200.0),
        opacity_logits=(2763.072109222412, -15236.927890777588),
        sh=(60.32343764274174, 60.32343764274174)),
}


def _scene(cfg: dict, capacity: int, seed: int = 5):
    gen = scene.generator(seed, "cpu")
    xyz, rgb = scene.point_cloud(cfg, gen, "cpu")
    return xyz, scene.initial_params(cfg, xyz, rgb, capacity, gen, 0.1)


@pytest.mark.parametrize("name", sorted(BUILT_IN_SUMS))
def test_the_built_in_recipes_are_unchanged(name):
    cfg = dict(H.load_json(H.HERE / "configs" / f"{name}.json"),
               num_gaussians=300)
    _, (params, active) = _scene(cfg, 1200)
    assert int(active.sum()) == 300 and bool(active[:300].all())
    assert set(params) == set(BUILT_IN_SUMS[name])
    for k, v in params.items():
        got = (float(v[:300].double().sum()), float(v.double().sum()))
        assert got == pytest.approx(BUILT_IN_SUMS[name][k], rel=1e-7,
                                    abs=0), k


@pytest.mark.parametrize("init", ["knn4", "../reference/train"])
def test_an_unknown_recipe_raises_and_names_the_recipes(init):
    cfg = dict(H.load_json(H.HERE / "configs" / "treehill_3dgs.json"),
               num_gaussians=300, init=init)
    with pytest.raises(ValueError, match="knn3.*constant"):
        _scene(cfg, 300)


# a recipe as a configuration of a trained scene's shape would bring it:
# points uniform in the extent's cube, anisotropic scales about
# ``scale``, random unit quaternions, opacities spread over 0.05-0.95
RECIPE = '''"""Trained-like gaussians made from the seed."""

import math

import torch

from gsbench import scene


def point_cloud(cfg, gen, device):
    n, extent = cfg["num_gaussians"], float(cfg["extent"])
    xyz = (torch.rand((n, 3), generator=gen, device=device) * 2.0
           - 1.0) * extent
    rgb = torch.randint(0, 256, (n, 3), generator=gen, device=device)
    return xyz, rgb.to(torch.float32)


def initial_params(cfg, xyz, rgb, capacity, gen, sh_rest_std):
    params, active = scene.pool(cfg, xyz, rgb, capacity, gen, sh_rest_std)
    n, dev = xyz.shape[0], xyz.device
    params["log_scales"][:n] = math.log(cfg["scale"]) + 0.5 * torch.randn(
        (n, 3), generator=gen, device=dev)
    q = torch.randn((n, 4), generator=gen, device=dev)
    params["quats"][:n] = q / torch.linalg.vector_norm(q, dim=1,
                                                       keepdim=True)
    op = 0.05 + 0.9 * torch.rand(n, generator=gen, device=dev)
    params["opacity_logits"][:n] = torch.log(op / (1.0 - op))
    return params, active
'''


def _add_configuration(tmp_path, monkeypatch, recipe=RECIPE):
    """A configuration of another size and resolution with its own recipe,
    a train and a render cell of it, as files under ``tmp_path`` and
    entries in a copy of BENCHMARK.json."""
    for sub in ("workloads", "configs"):
        shutil.copytree(H.HERE / sub, tmp_path / sub)
    (tmp_path / "scenes").mkdir()
    (tmp_path / "scenes" / "trained_like.py").write_text(recipe)
    monkeypatch.setattr(scene, "SCENES", tmp_path / "scenes")
    cfg = H.load_json(H.HERE / "configs" / "treehill_3dgs.json")
    cfg.update(name="trained", num_gaussians=3_100_000, width=1267,
               height=831, init="trained_like", scale=0.05, reduced=[])
    (tmp_path / "configs" / "trained.json").write_text(json.dumps(cfg))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="trained", source=cfg["source"],
                                 file="gsbench/configs/trained.json",
                                 reduced=[], why="a trained scene's shape"))
    for kind in ("train", "render"):
        w = H.load_json(H.HERE / "workloads" / f"treehill_3dgs.{kind}.json")
        w["config"] = "trained"
        if kind == "train":
            # from this recipe's readings at the CPU's size, seeds 5-7:
            # the program's largest 2.5e-7, 4.2e-6, 6.4e-7; the TF32
            # control's least 1.4e-4, 1.3e-3, 4.1e-4
            w["limits"].update(loss_gap=1e-5, grad_gap=1e-4,
                               change_gap=3e-5)
        (tmp_path / "workloads" / f"trained.{kind}.json").write_text(
            json.dumps(w))
        bench["workloads"].append(dict(name=f"trained.{kind}",
                                       config="trained", traffic=kind,
                                       chips=1, why=f"{kind} at 1267x831"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if f"treehill_3dgs.{kind}" in m.get("workloads", ()):
                m["workloads"].append(f"trained.{kind}")
    return bench, cfg


@pytest.mark.parametrize("kind", ["train", "render"])
def test_a_configuration_of_its_own_size_and_recipe_added_as_files(
        tmp_path, monkeypatch, kind):
    """A configuration file, its recipe file, workload files and
    BENCHMARK.json entries are all it needs: its cells pass the checks
    of the benchmark's own, are found, run correct at the CPU's size, and
    the TF32 control of each comes out not correct."""
    bench, cfg = _add_configuration(tmp_path, monkeypatch)
    name = f"trained.{kind}"
    check_config(bench, bench["configs"][-1], root=tmp_path)
    check_cell(bench, name, root=tmp_path)
    cell, chips = load_cell(bench, name, 1, 1.0, False, "cpu",
                            root=tmp_path)
    assert chips == 1 and cell.config["init"] == "trained_like"
    # the recipe's own cloud, scales per axis and rotations
    small = dict(cfg, num_gaussians=300)
    xyz, (params, _) = _scene(small, 300)
    own, _ = scene.recipe("trained_like").point_cloud(
        small, scene.generator(5, "cpu"), "cpu")
    assert torch.equal(xyz, own)
    assert bool((params["log_scales"][:, 0] != params["log_scales"][:, 1])
                .all())
    assert torch.allclose(torch.linalg.vector_norm(params["quats"], dim=1),
                          torch.ones(300))
    assert float(params["quats"][:, 1:].abs().min()) > 0.0
    out = run_tiny(tiny_cell(name, root=tmp_path))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    control = run_tiny(tiny_cell(name, root=tmp_path), control=True)
    assert not control.correct, control.checks


def test_a_recipe_with_other_leaves_raises(tmp_path, monkeypatch):
    """A recipe's pool is checked before the program's kernels read it
    by its strides: here round scales, one per gaussian."""
    flat = RECIPE + '''

def initial_params(cfg, xyz, rgb, capacity, gen, sh_rest_std):
    params, active = scene.pool(cfg, xyz, rgb, capacity, gen, sh_rest_std)
    params["log_scales"] = params["log_scales"][:, :1].contiguous()
    return params, active
'''
    _, cfg = _add_configuration(tmp_path, monkeypatch, flat)
    with pytest.raises(ValueError, match="log_scales"):
        _scene(dict(cfg, num_gaussians=300), 300)
