"""The reference against the port's CPU path at a tiny size, the control
that the check has to fail, and runs with the timed path broken
underneath, each of which has to come out not correct."""

from __future__ import annotations

import pytest
import torch

from gsbench import harness as H
from gsbench.tests.tiny import run_tiny, tiny_cell

TRAIN = ["treehill_3dgs.train", "treehill_ref.train"]
RENDER = ["treehill_3dgs.render", "treehill_ref.render"]


@pytest.mark.parametrize("name", TRAIN + RENDER)
def test_port_matches_the_reference(name):
    out = run_tiny(tiny_cell(name))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("name", TRAIN + RENDER)
def test_the_tf32_control_is_not_correct(name):
    out = run_tiny(tiny_cell(name), control=True)
    assert not out.correct, out.checks


def test_a_traced_run_checks_too():
    out = run_tiny(tiny_cell("treehill_ref.train", trace=True))
    assert out.correct and out.readings.units == 4
    assert set(out.readings.stage_ms) >= {"render", "backward", "optimizer"}


@pytest.fixture
def trainer_module():
    from intro_to_gaussian_splatting_tpu_torch.train import trainer
    return trainer


def test_a_step_that_leaves_the_state_unchanged(monkeypatch, trainer_module):
    monkeypatch.setattr(trainer_module.Optimizer, "step",
                        lambda self, model, grads, state: state)
    out = run_tiny(tiny_cell("treehill_ref.train"))
    # no Adam state: the first gradient reads 0 against the reference's
    assert not out.correct and out.checks["grad_gap"][0] == 1.0


def test_half_of_the_image_left_out_of_the_loss(monkeypatch, trainer_module):
    whole = trainer_module.fused_photometric_loss

    def top_half(tiles, target, ntx, nty, ts, h, w, wt):
        return whole(tiles, target[:, :h // 2].contiguous(), ntx, nty, ts,
                     h // 2, w, wt)

    monkeypatch.setattr(trainer_module, "fused_photometric_loss", top_half)
    out = run_tiny(tiny_cell("treehill_3dgs.train"))
    assert not out.correct, out.checks


@pytest.fixture
def render_module():
    from intro_to_gaussian_splatting_tpu_torch.ops import render
    return render


@pytest.mark.parametrize("fault", ["one_tile", "bottom_half"])
def test_an_altered_view(monkeypatch, render_module, fault):
    clean = render_module.render_tiled

    def altered(*args, **kwargs):
        img = clean(*args, **kwargs).clone()
        if fault == "one_tile":
            img[256:272, 384:400] += 0.5
        else:
            img[img.shape[0] // 2:] = 0.0
        return img

    monkeypatch.setattr(render_module, "render_tiled", altered)
    out = run_tiny(tiny_cell("treehill_ref.render"))
    assert not out.correct, out.checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"]
                                  for w in H.benchmark()["workloads"]])
def test_card_matches_the_reference_and_the_control_fails(card, name):
    """Each cell of the benchmark, cut to the CPU tests' size, on the
    card."""
    assert run_tiny(tiny_cell(name, device=card)).correct
    assert not run_tiny(tiny_cell(name, device=card), control=True).correct


@pytest.mark.parametrize("gap, marked", [(1e-6, True), (1e-2, False)])
def test_near_depth_ties_mark_their_tile(gap, marked):
    """Two overlapping gaussians in one tile, red in front of blue: a
    near tie of their depths marks the tile, a clear gap does not."""
    from gsbench.reference import raster
    from gsbench.reference.binning import Pairs
    from gsbench.reference.render import order_unsure_tiles

    rast = H.load_json(H.HERE / "configs" / "treehill_3dgs.json")[
        "rasterizer"]
    depth = torch.tensor([5.0, 5.0 + gap])
    pairs = Pairs(gauss=torch.tensor([0, 1]), tile=torch.tensor([0, 0]),
                  tile_starts=torch.tensor([0]), tile_counts=torch.tensor([2]),
                  ntx=1, nty=1)
    rec = torch.tensor([[8.0, 8.0], [8.0, 8.0], [0.02, 0.02], [0.0, 0.0],
                        [0.02, 0.02], [0.9, 0.9], [1.0, 0.0], [0.0, 0.0],
                        [0.0, 1.0]])
    tiles, _ = raster.composite(rec, pairs.tile_starts, pairs.tile_counts,
                                rast)
    grid = order_unsure_tiles(dict(depth=depth), pairs, rec, tiles, rast)
    assert grid.shape == (1, 1) and bool(grid[0, 0]) == marked
