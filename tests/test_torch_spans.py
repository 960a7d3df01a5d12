"""The port's spans (utils/profiling.py ``span`` / ``spans``) on the CPU:
nothing is recorded outside a profiler session; inside one a training
step records ``step`` > {``render`` > {``project``, ``bin``,
``rasterize``}, ``backward``, ``optimizer``} and a view ``view`` >
{``project``, ``bin``, ``rasterize``}, each child inside its parent and
sharing its unit; recording changes no bit of the training."""

import dataclasses

import pytest
import torch

from intro_to_gaussian_splatting_tpu_torch.config import (
    RasterizerConfig,
    TrainConfig,
)
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import PARAM_NAMES
from intro_to_gaussian_splatting_tpu_torch.ops import render
from intro_to_gaussian_splatting_tpu_torch.train import trainer as T
from intro_to_gaussian_splatting_tpu_torch.utils import profiling as U
from tests.scenes import small_scene
from tests.test_torch_common import port_camera, port_model

RCFG = RasterizerConfig(chunk_size=128, pairs_per_gaussian=32, group_tiles=2,
                        groups_per_step=1)
TCFG = TrainConfig(iterations=2, densify_start=10 ** 9,
                   opacity_reset_interval=0)
RENDER = {"project": {}, "bin": {}, "rasterize": {}}
TREES = {
    "train": {"step": {"render": RENDER, "backward": {}, "optimizer": {}}},
    "view": {"view": RENDER},
}


def _scene():
    _, cam, model = small_scene(n=40, width=32, height=32, seed=21,
                                scale_lo=0.08, scale_hi=0.3)
    return port_camera(cam), port_model(model)


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _train(profiled: bool):
    """(trainer, spans it recorded) after two steps on one camera."""
    cam, model = _scene()
    with torch.no_grad():
        target = render.render(model, cam, RCFG).numpy()
    _, model = _scene()
    with torch.no_grad():
        model.means.add_(0.05)
    trainer = T.Trainer(model=model, cameras=[cam], targets=[target],
                        scene_extent=1.0, rcfg=RCFG, tcfg=TCFG, log_every=1)
    last = max((s.id for s in U.spans()), default=-1)
    if profiled:
        with _profiled():
            trainer.run(2)
    else:
        trainer.run(2)
    return trainer, [s for s in U.spans() if s.id > last]


@pytest.fixture(scope="module")
def trained():
    return _train(profiled=True)


def test_no_span_outside_a_profiler_session():
    before = U.spans()
    assert U.span("step") is U._NO_SPAN and U.span("x") is U.span("y")
    with U.span("step"), U.span("render"):
        torch.ones(4).sum()
    assert U.spans() == before


def _check_tree(records, tree: dict, parent=None, unit=None):
    """The records under ``parent`` are ``tree``'s keys in that order, each
    inside its parent and of its unit, and so on down."""
    kids = sorted((s for s in records if s.parent == parent),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == list(tree)
    for s in kids:
        if parent is not None:
            outer = next(p for p in records if p.id == parent)
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
            assert s.unit == unit
        assert s.device_ms is None and s.marks == ()
        _check_tree(records, tree[s.name], s.id,
                    s.id if s.name in U.UNIT_SPANS else unit)


@pytest.mark.parametrize("kind", sorted(TREES))
def test_spans_nest_by_stage(kind, trained):
    if kind == "train":
        records = trained[1]
        steps = [s for s in records if s.name == "step"]
        assert len(steps) == 2 and len(records) == 2 * 7
        for step in steps:
            _check_tree([s for s in records if s.unit == step.id],
                        TREES[kind])
        return
    cam, model = _scene()
    last = max((s.id for s in U.spans()), default=-1)
    with _profiled(), torch.no_grad():
        render.render(model, cam, RCFG)
    records = [s for s in U.spans() if s.id > last]
    assert len(records) == 4
    _check_tree(records, TREES[kind])


def test_spans_change_no_bit_of_training(trained):
    traced, _ = trained
    plain, records = _train(profiled=False)
    assert records == []
    assert [m["loss"] for m in traced.history] == [
        m["loss"] for m in plain.history]
    for name in PARAM_NAMES:
        assert torch.equal(getattr(traced.model, name),
                           getattr(plain.model, name)), name
    for name in PARAM_NAMES:
        a, b = traced.opt_state[name], plain.opt_state[name]
        assert torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu), name
    assert dataclasses.asdict(traced.rcfg) == dataclasses.asdict(plain.rcfg)
