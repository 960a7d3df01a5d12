"""Port vs JAX package: checkpoints and PLY interop on the CPU.

The port's ``export_ply`` of a converted JAX model (SH degree 1, some dead
pool slots) is byte for byte the JAX package's; ``import_ply`` of a JAX
file equals the JAX ``import_ply`` exactly. The port's checkpoints (its
own format: the JAX package's are orbax's) round-trip every parameter,
``active``, the step and each Adam group's ``count``, ``mu``, ``nu`` and
``schedule_count`` exactly, also for a JAX optimizer state carried in
through ``convert``; interrupted saves are skipped and retention keeps the
newest. A ``Trainer`` run of 4 steps equals, bit for bit, 2 steps, a save,
a fresh ``Trainer`` resumed from it and 2 more.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.config import TrainConfig
from intro_to_gaussian_splatting_tpu.train import checkpoint as jck
from intro_to_gaussian_splatting_tpu.train import trainer as jt
from intro_to_gaussian_splatting_tpu_torch import convert
from intro_to_gaussian_splatting_tpu_torch.config import (
    TrainConfig as PortTrainConfig,
)
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import PARAM_NAMES
from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import render_tiled
from intro_to_gaussian_splatting_tpu_torch.train import checkpoint as C
from intro_to_gaussian_splatting_tpu_torch.train import trainer as T
from tests.scenes import small_scene
from tests.test_torch_common import (
    FAST_COMPILE,
    np_,
    port_camera,
    port_config,
    port_model,
)
from tests.test_torch_train import RCFG

ADAM = ("count", "mu", "nu", "schedule_count")


def _jax_model(n=24, seed=4):
    """A small JAX model in the 3DGS colour space, SH degree 1, with the
    last four pool slots dead."""
    _, _, model = small_scene(n=n, seed=seed)
    rng = np.random.default_rng(seed)
    return model.replace(
        sh=jnp.asarray(rng.normal(size=(n, 4, 3)), jnp.float32),
        active=jnp.asarray(np.arange(n) < n - 4), color_space="sh")


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        for f in ADAM:
            x, y = getattr(a[name], f), getattr(b[name], f)
            assert (x is None) == (y is None), (name, f)
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), (name, f)


def _assert_models_equal(a, b):
    for name in PARAM_NAMES + ("active",):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.color_space == b.color_space


def test_export_ply_bytes_match_jax_and_import_ply(tmp_path):
    model = _jax_model()
    jpath, ppath = str(tmp_path / "j.ply"), str(tmp_path / "p.ply")
    jck.export_ply(jpath, model)
    C.export_ply(ppath, port_model(model))
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()
    want = jck.import_ply(jpath)
    got = C.import_ply(jpath, device="cpu")
    assert got.capacity == 20 and bool(got.active.all())
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    rgb = C.import_ply(ppath, color_space="rgb", device="cpu")
    assert rgb.color_space == "rgb" and rgb.sh.shape == (20, 4, 3)


def _stepped_state(model, steps=2):
    tx = T.make_optimizer(PortTrainConfig(iterations=10), 2.0)
    state = tx.init({n: getattr(model, n) for n in PARAM_NAMES})
    rng = np.random.default_rng(0)
    for _ in range(steps):
        grads = {n: torch.from_numpy(rng.normal(size=getattr(
            model, n).shape).astype(np.float32)) for n in PARAM_NAMES}
        _, state = tx.update(grads, state)
    return state


def test_checkpoint_round_trip(tmp_path):
    model = port_model(_jax_model())
    state = _stepped_state(model)
    assert int(state["means"].schedule_count) == 2
    C.save_checkpoint(str(tmp_path), model, state, 7)
    C.save_checkpoint(str(tmp_path), model, state, 7)    # replaces step_7
    assert C.list_checkpoint_steps(str(tmp_path)) == [7]
    template = port_model(_jax_model(seed=9))
    template_state = _stepped_state(template, steps=0)
    got, got_state, step = C.load_checkpoint(str(tmp_path), template,
                                             template_state)
    assert step == 7
    _assert_models_equal(got, model)
    _assert_state_equal(got_state, state)
    small = port_model(_jax_model(n=10))
    with pytest.raises(ValueError, match="shape"):
        C.load_checkpoint(str(tmp_path), small, _stepped_state(small, 0))


def test_jax_optimizer_state_through_a_port_checkpoint(tmp_path):
    """A JAX run's optax state, one update in, carried into the port by
    ``convert`` and through a port checkpoint, equals the JAX leaves."""
    model = _jax_model()
    params = model.params()
    tx = jt.make_optimizer(TrainConfig(iterations=10), 2.0)
    state = tx.init(params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.25), params)
    _, state = jax.jit(tx.update).lower(grads, state).compile(FAST_COMPILE)(
        grads, state)
    state = jax.tree.map(np.asarray, state)
    pstate = convert.optimizer_state_from_numpy(state, device="cpu")
    C.save_checkpoint(str(tmp_path), port_model(model), pstate, 1)
    pm = port_model(model)
    _, back, _ = C.load_checkpoint(str(tmp_path), pm, pstate)
    _assert_state_equal(back, pstate)
    for name in PARAM_NAMES:
        chain = state.inner_states[name].inner_state
        assert int(back[name].count) == int(chain[0].count) == 1
        np.testing.assert_array_equal(np_(back[name].mu), chain[0].mu[name])
        np.testing.assert_array_equal(np_(back[name].nu), chain[0].nu[name])
    assert int(back["means"].schedule_count) == int(
        state.inner_states["means"].inner_state[1].count)


def test_interrupted_saves_are_skipped_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    for name in ("step_10", "step_20", "step_30.tmp-123", "step_5.old-9",
                 "step_x", "other"):
        os.makedirs(os.path.join(d, name))
    assert C.list_checkpoint_steps(d) == [10, 20]
    C.prune_checkpoints(d, keep=0)          # keep <= 0 deletes none
    assert C.list_checkpoint_steps(d) == [10, 20]
    C.prune_checkpoints(d, keep=1)
    assert C.list_checkpoint_steps(d) == [20]
    assert os.path.isdir(os.path.join(d, "step_30.tmp-123"))
    assert C.list_checkpoint_steps(str(tmp_path / "none")) == []
    with pytest.raises(FileNotFoundError):
        C.load_checkpoint(str(tmp_path / "none"), None, None)


def test_trainer_resume_is_bit_equal_to_a_straight_run(tmp_path):
    _, cam, jmodel = small_scene(n=40, width=32, height=32, seed=21,
                                 scale_lo=0.08, scale_hi=0.3)
    cam = port_camera(cam)
    with torch.no_grad():
        target = render_tiled(port_model(jmodel), cam,
                              port_config(RCFG)).numpy()[::-1].copy()
    tcfg = PortTrainConfig(iterations=4, checkpoint_every=2)

    def trainer(d):
        return T.Trainer(model=port_model(jmodel), cameras=[cam],
                         targets=[target], scene_extent=2.0,
                         rcfg=port_config(RCFG), tcfg=tcfg, log_every=2,
                         checkpoint_dir=str(tmp_path / d))

    straight = trainer("a")
    straight.run(4)
    first = trainer("b")
    first.run(2)
    resumed = trainer("b")
    assert resumed.resume() == 2
    resumed.run(2)
    assert straight.step == resumed.step == 4
    _assert_models_equal(resumed.model, straight.model)
    _assert_state_equal(resumed.opt_state, straight.opt_state)
    assert not torch.equal(resumed.model.means, port_model(jmodel).means)
    assert C.list_checkpoint_steps(str(tmp_path / "b")) == [2, 4]
