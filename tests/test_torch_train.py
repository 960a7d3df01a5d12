"""Port vs JAX package: the training slice on the CPU.

``make_optimizer`` against optax (rtol 1e-6 over three steps); densify,
prune, opacity reset and ``zero_slots`` against the JAX package's, fed the
JAX package's split noise; one default ``train_step`` against the JAX
``train_step`` (loss rel 1e-5, PSNR abs 1e-4, every gradient within a
relative L2 difference of 1e-4, the updated parameters and the densify
state); a JAX training state carried into the port through ``convert``
and stepped on in both; one split-loss ``train_step`` (``fused_loss=False``:
tile L1, untile, fused SSIM) and ``train_step_batched`` over two cameras,
with either loss, against the JAX package's at the same tolerances. Then
the ``Trainer``'s behaviour, mirroring the JAX package's
tests/test_training.py: the loss falls, the pair pool grows on overflow,
the target cache stays bounded, camera groups wrap around a ragged camera
count, a Trainer over a 1x1 mesh takes a step. Each JAX step is compiled
once (``jax_fast``) and the parameter-free references run in one compiled
program.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from intro_to_gaussian_splatting_tpu.config import (
    RasterizerConfig,
    TrainConfig,
)
from intro_to_gaussian_splatting_tpu.models.camera import (
    stack_cameras as jax_stack_cameras,
)
from intro_to_gaussian_splatting_tpu.models.gaussians import (
    GaussianModel as JaxModel,
)
from intro_to_gaussian_splatting_tpu.ops.binning import tile_grid
from intro_to_gaussian_splatting_tpu.ops.fused_loss_pallas import (
    pad_target_chw,
)
from intro_to_gaussian_splatting_tpu.ops.rasterize_pallas import (
    image_to_tiles as jax_image_to_tiles,
    tile_pixel_mask as jax_tile_pixel_mask,
)
from intro_to_gaussian_splatting_tpu.train import densify as JD
from intro_to_gaussian_splatting_tpu.train import trainer as jt
from intro_to_gaussian_splatting_tpu_torch import convert
from intro_to_gaussian_splatting_tpu_torch.config import (
    TrainConfig as PortTrainConfig,
)
from intro_to_gaussian_splatting_tpu_torch.models import stack_cameras
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import PARAM_NAMES
from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import (
    image_to_tiles,
    render_tiled as port_render_tiled,
    tile_pixel_mask,
)
from intro_to_gaussian_splatting_tpu_torch.train import densify as D
from intro_to_gaussian_splatting_tpu_torch.train import trainer as T
from tests.scenes import small_scene
from tests.test_torch_common import (
    FAST_COMPILE,
    jax_fast,
    np_,
    port_camera,
    port_config,
    port_model,
)
from tests.test_torch_rasterize import rel_l2

# one tile group per grid step: the JAX kernels unroll their body over the
# groups of a step, so this keeps their interpret-mode programs small
RCFG = RasterizerConfig(chunk_size=128, pairs_per_gaussian=32, group_tiles=2,
                        groups_per_step=1)


def port_train_config(cfg: TrainConfig) -> PortTrainConfig:
    return PortTrainConfig(**dataclasses.asdict(cfg))


def _params(model):
    return {name: getattr(model, name) for name in PARAM_NAMES}


def test_train_config_matches():
    assert dataclasses.asdict(port_train_config(TrainConfig())) == \
        dataclasses.asdict(TrainConfig())
    assert [f.name for f in dataclasses.fields(PortTrainConfig)] == \
        [f.name for f in dataclasses.fields(TrainConfig)]


def test_make_optimizer_matches_optax():
    """Three Adam steps of random gradients, every group's learning rate:
    the decaying means rate, the SH DC/rest split inside one tensor."""
    rng = np.random.default_rng(0)
    n, k = 12, 4
    shapes = dict(means=(n, 3), log_scales=(n, 3), quats=(n, 4),
                  opacity_logits=(n,), sh=(n, k, 3))
    params = {name: rng.normal(size=s).astype(np.float32)
              for name, s in shapes.items()}
    cfg = TrainConfig(iterations=4)
    tx = jt.make_optimizer(cfg, scene_extent=2.5)
    state = tx.init(jax.tree.map(jnp.asarray, params))
    update = jax.jit(tx.update).lower(params, state).compile(FAST_COMPILE)
    ptx = T.make_optimizer(port_train_config(cfg), 2.5)
    pstate = ptx.init({k_: torch.from_numpy(v) for k_, v in params.items()})
    for _ in range(3):
        grads = {name: rng.normal(size=s).astype(np.float32)
                 for name, s in shapes.items()}
        want, state = update(grads, state)
        got, pstate = ptx.update(
            {k_: torch.from_numpy(v) for k_, v in grads.items()}, pstate)
        for name in PARAM_NAMES:
            np.testing.assert_allclose(np_(got[name]),
                                       np.asarray(want[name]), rtol=1e-6,
                                       err_msg=name)
    want_state = convert.optimizer_state_from_numpy(
        jax.tree.map(np.asarray, state), device="cpu")
    for name in PARAM_NAMES:
        assert int(pstate[name].count) == int(want_state[name].count) == 3
        np.testing.assert_allclose(np_(pstate[name].nu),
                                   np_(want_state[name].nu), rtol=1e-6)
    assert int(pstate["means"].schedule_count) == 3
    assert pstate["sh"].schedule_count is None


def _pool_model():
    """30 gaussians in a pool of 64, as the JAX package's densify test."""
    raw, cam, model = small_scene(n=30, width=32, height=32, seed=3)
    cap = 64

    def pad(x, fill=0.0):
        return jnp.concatenate(
            [x, jnp.full((cap - x.shape[0],) + x.shape[1:], fill, x.dtype)])

    return JaxModel(
        means=pad(model.means), log_scales=pad(model.log_scales, -10.0),
        quats=pad(model.quats).at[30:, 0].set(1.0),
        opacity_logits=pad(model.opacity_logits, -20.0),
        sh=pad(model.sh), active=pad(model.active, False),
        color_space="rgb")


def _assert_models_equal(pm, jm, rtol=1e-6, atol=1e-7):
    for name in PARAM_NAMES:
        np.testing.assert_allclose(np_(getattr(pm, name)),
                                   np.asarray(getattr(jm, name)), rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_array_equal(np_(pm.active), np.asarray(jm.active))


def test_densify_prune_reset_match():
    model = _pool_model()
    cap = model.capacity
    rng = np.random.default_rng(5)
    # mixed candidates: some below the threshold, ties, splits and clones
    grad = np.where(rng.uniform(size=cap) < 0.7,
                    rng.uniform(0, 2e-3, size=cap), 1e-3).astype(np.float32)
    count = rng.integers(0, 4, size=cap).astype(np.int32)
    state = JD.DensifyState(grad_accum=jnp.asarray(grad),
                            count=jnp.asarray(count))
    tcfg = TrainConfig(densify_grad_threshold=2e-4,
                       densify_scale_threshold=0.05)
    key = jax.random.PRNGKey(3)
    max_new = 40     # more than the free slots: some stay unused
    tx = jt.make_optimizer(tcfg, 1.0)

    def reference():
        want, want_dst = JD.densify(model, state, key, tcfg, 1.0, max_new)
        pruned = JD.prune(want, tcfg, 0.5)
        opt = jax.tree.map(lambda x: x + 1.0 if x.ndim else x,
                           tx.init(want.params()))
        return (want, want_dst, jax.random.normal(key, (max_new, 3)),
                pruned, JD.reset_opacity(pruned), opt,
                JD.zero_slots(opt, want_dst, cap))

    want, want_dst, noise, pruned, reset, opt, want_opt = jax.tree.map(
        np.asarray, jax_fast(reference))
    pm = port_model(model)
    pstate = convert.densify_state_from_numpy(
        dataclasses.asdict(jax.tree.map(np.asarray, state)), device="cpu")
    dst = D.densify(pm, pstate, torch.from_numpy(noise),
                    port_train_config(tcfg), 1.0, max_new)
    np.testing.assert_array_equal(np_(dst), np.asarray(want_dst))
    assert (np_(dst) < cap).sum() > 0 and (np_(dst) == cap).sum() > 0
    _assert_models_equal(pm, want)

    D.prune(pm, port_train_config(tcfg), 0.5)
    np.testing.assert_array_equal(np_(pm.active), np.asarray(pruned.active))
    D.reset_opacity(pm)
    _assert_models_equal(pm, reset)

    # zero_slots on optimizer moments and on a non-pool leaf
    popt = convert.optimizer_state_from_numpy(opt, device="cpu")
    D.zero_slots(T.Optimizer.moments(popt) + [popt["means"].count],
                 dst, cap)
    got = convert.optimizer_state_from_numpy(want_opt, device="cpu")
    for name in PARAM_NAMES:
        for moment in ("mu", "nu", "count"):
            np.testing.assert_array_equal(
                np_(getattr(popt[name], moment)),
                np_(getattr(got[name], moment)))


def _train_scene():
    """A camera, a perturbed model and its target: the true model's render
    (the port's, on the CPU)."""
    raw, cam, true_model = small_scene(n=60, width=48, height=32, seed=11,
                                       scale_lo=0.08, scale_hi=0.3)
    with torch.no_grad():
        target = port_render_tiled(port_model(true_model), port_camera(cam),
                                   port_config(RCFG)).numpy()
    model = true_model.replace(
        opacity_logits=true_model.opacity_logits - 1.0)
    return cam, model, target


def _jax_step(step, tcfg, tx, *args):
    """The JAX package's ``train_step`` or ``train_step_batched`` on
    ``args`` (model, optimizer state, densify state, camera(s), targets),
    compiled once for their shapes."""
    return step.lower(*args, rcfg=RCFG, tcfg=tcfg, tx=tx,
                      active_sh_degree=0).compile(FAST_COMPILE)


def _jax_grads(opt_state):
    """The gradients of the first Adam step, read back from its first
    moments (mu = (1 - b1) g)."""
    state = convert.optimizer_state_from_numpy(
        jax.tree.map(np.asarray, opt_state), device="cpu")
    return {name: np_(state[name].mu) / (1 - T.ADAM_B1)
            for name in PARAM_NAMES}


def _assert_step_matches(pm, pmet, pds, grads, jm, jmet, jd, jo):
    """Port and JAX package after one step from the same state: loss rel
    1e-5, PSNR abs 1e-4, gradients within relative L2 1e-4, the updated
    parameters (Adam's first step is about lr * sign(g)) and the densify
    state."""
    assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    assert float(pmet["psnr"]) == pytest.approx(float(jmet["psnr"]),
                                                abs=1e-4)
    assert not bool(pmet["overflowed"]) and not bool(jmet["overflowed"])
    for name, want_g in _jax_grads(jo).items():
        assert np.linalg.norm(want_g) > 0, name
        assert rel_l2(np_(grads[name]), want_g) <= 1e-4, name
    _assert_models_equal(pm, jm, rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(np_(pds.count), np.asarray(jd.count))
    assert rel_l2(np_(pds.grad_accum), np.asarray(jd.grad_accum)) <= 1e-4


def test_train_step_matches_jax_and_continues_from_its_state():
    """One default step in both packages; the gradients are read back from
    the JAX package's first Adam moments (mu = (1 - b1) g). Then the JAX
    state after that step is carried into the port and both take one more
    step."""
    cam, model, target = _train_scene()
    tcfg = TrainConfig()
    h, w = cam.height, cam.width
    ntx, nty = tile_grid(w, h, RCFG.tile_size)
    tpad = pad_target_chw(jnp.asarray(target), ntx, nty, RCFG.tile_size, h,
                          w)
    tx = jt.make_optimizer(tcfg, 1.0)
    opt = tx.init(model.params())
    ds = JD.DensifyState.zero(model.capacity)
    step = _jax_step(jt.train_step, tcfg, tx, model, opt, ds, cam, None,
                     None, tpad)
    jm, jo, jd, jmet = step(model, opt, ds, cam, None, None, tpad)

    pcfg, ptcfg = port_config(RCFG), port_train_config(tcfg)
    pm, pc = port_model(model), port_camera(cam)
    chw = torch.from_numpy(target.transpose(2, 0, 1).copy())
    ptx = T.make_optimizer(ptcfg, 1.0)
    popt = ptx.init(_params(pm))
    pds = D.DensifyState.zero(pm.capacity)
    loss, mse, _, _, grads = T.camera_loss_and_grads(
        pm, pc, None, None, chw, pcfg, ptcfg)
    pm, popt, pds, pmet = T.train_step(pm, popt, pds, pc, None, None, chw,
                                       pcfg, ptcfg, ptx, 0)
    assert float(pmet["loss"]) == float(loss)
    assert int(pmet["num_active"]) == 60
    _assert_step_matches(pm, pmet, pds, grads, jm, jmet, jd, jo)

    # carry the JAX state across and take one more step in both
    jm2, jo2, jd2, jmet2 = step(jm, jo, jd, cam, None, None, tpad)
    m = jax.tree.map(np.asarray, jm)
    cm = convert.model_from_numpy(m.params(), m.active, m.color_space,
                                  device="cpu")
    cds = convert.densify_state_from_numpy(
        dataclasses.asdict(jax.tree.map(np.asarray, jd)), device="cpu")
    jax_state = convert.optimizer_state_from_numpy(
        jax.tree.map(np.asarray, jo), device="cpu")
    cm, copt, cds, cmet = T.train_step(cm, jax_state, cds, pc, None, None,
                                       chw, pcfg, ptcfg, ptx, 0)
    assert float(cmet["loss"]) == pytest.approx(float(jmet2["loss"]),
                                                rel=1e-5)
    _assert_models_equal(cm, jm2, rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(np_(cds.count), np.asarray(jd2.count))
    want2 = convert.optimizer_state_from_numpy(
        jax.tree.map(np.asarray, jo2), device="cpu")
    for name in PARAM_NAMES:
        assert int(copt[name].count) == int(want2[name].count) == 2
        assert rel_l2(np_(copt[name].mu), np_(want2[name].mu)) <= 1e-4


def _split_targets(target):
    """One (H, W, 3) target in the split path's layouts, in both packages:
    (JAX (tiles, mask, image), port (tiles, mask, image))."""
    h, w, _ = target.shape
    jt_ = (jax_image_to_tiles(jnp.asarray(target), RCFG),
           jax_tile_pixel_mask(h, w, RCFG),
           jnp.asarray(target.transpose(2, 0, 1)))
    pcfg = port_config(RCFG)
    pt = (image_to_tiles(torch.from_numpy(target), pcfg),
          tile_pixel_mask(h, w, pcfg),
          torch.from_numpy(target.transpose(2, 0, 1).copy()))
    return jt_, pt


def test_split_loss_train_step_matches_jax():
    """``TrainConfig(fused_loss=False)``: the tile L1, the untile relayout
    and 1 - SSIM through the fused SSIM (B4a and B4b's plain versions
    here), PSNR from the tile MSE."""
    cam, model, target = _train_scene()
    tcfg = TrainConfig(fused_loss=False)
    (jtt, jtm, jti), (ptt, ptm, pti) = _split_targets(target)
    tx = jt.make_optimizer(tcfg, 1.0)
    opt = tx.init(model.params())
    ds = JD.DensifyState.zero(model.capacity)
    args = (model, opt, ds, cam, jtt, jtm, jti)
    jm, jo, jd, jmet = _jax_step(jt.train_step, tcfg, tx, *args)(*args)

    pcfg, ptcfg = port_config(RCFG), port_train_config(tcfg)
    pm, pc = port_model(model), port_camera(cam)
    ptx = T.make_optimizer(ptcfg, 1.0)
    loss, mse, _, _, grads = T.camera_loss_and_grads(pm, pc, ptt, ptm, pti,
                                                     pcfg, ptcfg)
    assert mse is None
    pm, _, pds, pmet = T.train_step(
        pm, ptx.init(_params(pm)), D.DensifyState.zero(pm.capacity), pc,
        ptt, ptm, pti, pcfg, ptcfg, ptx, 0)
    assert float(pmet["loss"]) == float(loss)
    _assert_step_matches(pm, pmet, pds, grads, jm, jmet, jd, jo)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_train_step_batched_matches_jax(fused):
    """One Adam step on the mean gradient of two cameras, rendered in
    order; the densify statistics accumulate per camera."""
    cam, model, target = _train_scene()
    cam2 = small_scene(n=60, width=48, height=32, seed=8)[1]
    with torch.no_grad():
        target2 = 0.5 * port_render_tiled(
            port_model(model), port_camera(cam2), port_config(RCFG)).numpy()
    tcfg = TrainConfig(fused_loss=fused)
    tx = jt.make_optimizer(tcfg, 1.0)
    opt = tx.init(model.params())
    ds = JD.DensifyState.zero(model.capacity)
    h, w = cam.height, cam.width
    ntx, nty = tile_grid(w, h, RCFG.tile_size)
    if fused:
        jtargets = (None, None, jnp.stack([pad_target_chw(
            jnp.asarray(t), ntx, nty, RCFG.tile_size, h, w)
            for t in (target, target2)]))
        ptargets = (None, None, torch.stack([torch.from_numpy(
            t.transpose(2, 0, 1).copy()) for t in (target, target2)]))
    else:
        both = [_split_targets(t) for t in (target, target2)]
        jtargets = tuple(jnp.stack([b[0][k] for b in both])
                         for k in range(3))
        ptargets = tuple(torch.stack([b[1][k] for b in both])
                         for k in range(3))
    args = (model, opt, ds, jax_stack_cameras([cam, cam2])) + jtargets
    jm, jo, jd, jmet = _jax_step(jt.train_step_batched, tcfg, tx,
                                 *args)(*args)

    pcfg, ptcfg = port_config(RCFG), port_train_config(tcfg)
    pm = port_model(model)
    pcams = stack_cameras([port_camera(cam), port_camera(cam2)])
    ptx = T.make_optimizer(ptcfg, 1.0)
    grads = [T.camera_loss_and_grads(
        pm, port_camera(c), *(None if t is None else t[i] for t in ptargets),
        pcfg, ptcfg)[4] for i, c in enumerate((cam, cam2))]
    mean = {name: (grads[0][name] + grads[1][name]) / 2
            for name in PARAM_NAMES}
    pm, _, pds, pmet = T.train_step_batched(
        pm, ptx.init(_params(pm)), D.DensifyState.zero(pm.capacity), pcams,
        *ptargets, pcfg, ptcfg, ptx, 0)
    assert int(pmet["num_active"]) == 60
    assert int(pds.count.max()) == 2      # seen by both cameras
    _assert_step_matches(pm, pmet, pds, mean, jm, jmet, jd, jo)


def _port_scene(n, seed, scale_lo=0.08, scale_hi=0.3):
    raw, cam, model = small_scene(n=n, width=32, height=32, seed=seed,
                                  scale_lo=scale_lo, scale_hi=scale_hi)
    return port_camera(cam), port_model(model)


def test_trainer_lowers_loss_and_writes_jsonl(tmp_path):
    """The default objective (fused L1 + SSIM) on a perturbed model, with
    densify, prune and the opacity reset running inside the loop."""
    cam, true_model = _port_scene(40, 21)
    with torch.no_grad():
        target = port_render_tiled(true_model, cam, port_config(RCFG)).numpy()
    _, noisy = _port_scene(40, 21)
    with torch.no_grad():
        noisy.sh.add_(0.3 * torch.from_numpy(
            np.random.default_rng(0).normal(size=noisy.sh.shape)).float())
        noisy.opacity_logits.sub_(1.0)
    tcfg = PortTrainConfig(iterations=5, densify_start=10 ** 9,
                           opacity_reset_interval=0)
    jsonl = tmp_path / "metrics.jsonl"
    trainer = T.Trainer(model=noisy, cameras=[cam], targets=[target],
                        scene_extent=2.0, rcfg=port_config(RCFG), tcfg=tcfg,
                        log_every=1, jsonl_path=str(jsonl))
    hist = trainer.run(5)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.9, hist
    assert hist[-1]["psnr"] > hist[0]["psnr"] + 0.5, hist
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert all("loss" in r and "psnr" in r and r["overflow_steps"] == 0
               for r in rows)

    # densify (in a pool with free slots), prune and reset in the loop
    cam2, model2 = _port_scene(20, 3, scale_lo=0.02, scale_hi=0.25)
    pool = convert.model_from_numpy(
        {name: np.concatenate([np_(getattr(model2, name)), np.zeros(
            (12,) + tuple(getattr(model2, name).shape[1:]), np.float32)])
         for name in PARAM_NAMES},
        np.arange(32) < 20, "rgb", device="cpu")
    tcfg2 = PortTrainConfig(iterations=4, densify_start=2,
                            densify_interval=2, densify_grad_threshold=0.0,
                            opacity_reset_interval=3)
    trainer2 = T.Trainer(model=pool, cameras=[cam2], targets=[target],
                         scene_extent=2.0, rcfg=port_config(RCFG),
                         tcfg=tcfg2, log_every=2)
    hist2 = trainer2.run(4)
    assert hist2[-1]["num_active"] > 20
    assert np.isfinite(hist2[-1]["loss"])
    # reset to <= 0.01 at step 3, then one Adam step of lr 0.05 in logits
    assert float(torch.sigmoid(pool.opacity_logits.detach()).max()) <= 0.011


def test_trainer_grows_pair_pool_on_overflow():
    """A pair pool too small for the scene overflows, the Trainer doubles
    it, and a later step runs clean (JAX test_training.py:78-101; the tile
    L1 objective, ssim_weight=0, as there)."""
    cam, model = _port_scene(60, 21, scale_lo=0.15, scale_hi=0.5)
    with torch.no_grad():
        target = port_render_tiled(model, cam, port_config(RCFG)).numpy()
    tiny = dataclasses.replace(port_config(RCFG), pairs_per_gaussian=1)
    tcfg = PortTrainConfig(iterations=8, densify_start=10 ** 9,
                           opacity_reset_interval=0, ssim_weight=0.0)
    events = []
    trainer = T.Trainer(model=model, cameras=[cam], targets=[target],
                        scene_extent=1.0, rcfg=tiny, tcfg=tcfg, log_every=1,
                        on_log=events.append)
    trainer.run(8)
    assert [m for m in events if m.get("overflowed")]
    assert [m for m in events if m.get("event") == "pair_pool_grown"]
    assert trainer.rcfg.pairs_per_gaussian > 1
    assert not events[-1].get("overflowed"), events[-1]


def test_trainer_target_cache_is_bounded():
    """Training over many cameras keeps the LRU target cache within its
    byte budget (JAX test_training.py:419-441)."""
    cam, model = _port_scene(15, 13)
    with torch.no_grad():
        target = port_render_tiled(model, cam, port_config(RCFG)).numpy()
    n_cams = 6
    tcfg = PortTrainConfig(iterations=n_cams, densify_start=10 ** 9,
                           opacity_reset_interval=0)
    trainer = T.Trainer(model=model, cameras=[cam] * n_cams,
                        targets=[target.copy() for _ in range(n_cams)],
                        scene_extent=1.0, rcfg=port_config(RCFG), tcfg=tcfg,
                        log_every=10)
    trainer._target_for(0)
    one_entry = trainer._tiled[0][1]
    assert one_entry == 3 * 32 * 32 * 4
    trainer.target_cache_bytes = 2 * one_entry + 1
    trainer.run(n_cams)
    assert len(trainer._tiled) <= 2
    assert trainer._tiled_bytes <= trainer.target_cache_bytes
    assert np.isfinite(trainer.history[-1]["loss"])


def test_trainer_camera_batch_ragged_groups():
    """camera_batch not dividing the camera count: the last group wraps
    around, so the groups are fixed and their stacked targets are cached
    (JAX test_training.py:279-300; the tile L1 objective, as there)."""
    cams = [_port_scene(20, s)[0] for s in (2, 3, 4)]
    _, model = _port_scene(20, 2)
    with torch.no_grad():
        target = port_render_tiled(model, cams[0], port_config(RCFG)).numpy()
    tcfg = PortTrainConfig(iterations=4, densify_start=10 ** 9,
                           opacity_reset_interval=0, ssim_weight=0.0,
                           camera_batch=2)
    trainer = T.Trainer(model=model, cameras=cams,
                        targets=[target.copy() for _ in cams],
                        scene_extent=1.0, rcfg=port_config(RCFG), tcfg=tcfg,
                        log_every=2)
    hist = trainer.run(4)      # 2 groups: (0, 1) and (2, 0)
    assert np.isfinite(hist[-1]["loss"])
    keys = [k for k in trainer._tiled if isinstance(k, tuple)
            and k and k[0] == "batch"]
    assert sorted(keys) == [("batch", 0, 1), ("batch", 2, 0)], keys
    cams_, tiles, masks, imgs = trainer._tiled[("batch", 2, 0)][0]
    assert cams_.world2view.shape == (2, 4, 4) and imgs is None
    assert tiles.shape[0] == masks.shape[0] == 2


@pytest.mark.parametrize("change,match", [
    (dict(camera_batch=2), "batched-steps slice"),
    (dict(fused_loss=False), "split-loss slice"),
    (dict(mesh=object()), "parallel/"),
])
def test_later_slices_raise(change, match):
    """Each change that raised until its slice landed (``match`` names the
    slice) now builds a Trainer that takes a step: the batched steps, the
    split loss and, since the parallel/ slice, a mesh (here 1x1, one gloo
    rank in this process)."""
    cam, model = _port_scene(10, 2)
    change = dict(change)
    mesh = change.pop("mesh", None)
    kwargs = dict(model=model, cameras=[cam], targets=[np.zeros((32, 32, 3))],
                  scene_extent=1.0, rcfg=port_config(RCFG),
                  tcfg=PortTrainConfig(**change))
    if mesh is None:
        hist = T.Trainer(**kwargs).run(1)
    else:
        import torch.distributed as dist

        from intro_to_gaussian_splatting_tpu_torch.parallel.multihost import (
            global_mesh, init_multihost,
        )
        from tests.torch_mesh_ranks import _free_port
        init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
        try:
            trainer = T.Trainer(**kwargs, mesh=global_mesh(device="cpu"))
            hist = trainer.run(1)
            assert trainer.model.capacity == 10
        finally:
            dist.destroy_process_group()
    assert hist[-1]["step"] == 1 and np.isfinite(hist[-1]["loss"]), match
    assert T.scene_extent_of(np.array([[0.0, 0, 0], [2.0, 0, 0]])) == 1.0
