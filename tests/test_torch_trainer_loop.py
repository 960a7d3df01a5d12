"""Port vs JAX package: the training loop, ``Trainer.run``, on the CPU.

Twelve steps over three 32x32 cameras from one start model in both
packages: the camera order drawn from ``tcfg.seed``, the SH degree raised
every 4 steps (0, 1, 2), prune passes from step 6 every 3 steps (the
gradient threshold keeps clone and split out, so no random noise is
drawn), an opacity reset at step 10, and a metrics row at every step.
A row reports the model its step trained, before that step's prune pass.
Every row's step and active count are equal, its loss within 1e-5
relative and its PSNR within 1e-4 dB; at the end every parameter is
within a relative L2 difference of 1e-4. The loop's single steps are held
against JAX's in test_torch_train.py; this file is apart from it so that
the two heavy files run on different workers.
"""

import jax
import jax.numpy as jnp
import numpy as np

from intro_to_gaussian_splatting_tpu.config import TrainConfig
from intro_to_gaussian_splatting_tpu.models.sh import rgb_to_sh
from intro_to_gaussian_splatting_tpu.ops.rasterize_pallas import render_tiled
from intro_to_gaussian_splatting_tpu.train import trainer as jt
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import PARAM_NAMES
from intro_to_gaussian_splatting_tpu_torch.train import trainer as T
from tests.scenes import small_scene
from tests.test_torch_common import (
    FAST_COMPILE,
    np_,
    port_camera,
    port_config,
    port_model,
)
from tests.test_torch_rasterize import rel_l2
from tests.test_torch_train import RCFG, port_train_config

STEPS = 12
TCFG = TrainConfig(iterations=STEPS, densify_start=6, densify_interval=3,
                   densify_grad_threshold=1e9, prune_opacity_threshold=0.35,
                   opacity_reset_interval=10, sh_degree_interval=4, seed=3)


def _sh_model(n, seed):
    """small_scene's model in the SH colour space of degree 2: its colours
    as the DC band, seeded small higher bands."""
    raw, _, model = small_scene(n=n, width=32, height=32, seed=seed)
    rng = np.random.default_rng(seed)
    sh = np.concatenate([rgb_to_sh(raw["colors"])[:, None, :],
                         0.1 * rng.normal(size=(n, 8, 3))], axis=1)
    return model.replace(sh=jnp.asarray(sh, jnp.float32), color_space="sh")


def test_trainer_run_matches_jax():
    cams = [small_scene(n=40, width=32, height=32, seed=s)[1]
            for s in (21, 22, 23)]
    true_model = small_scene(n=40, width=32, height=32, seed=21)[2]
    # one compiled program renders the three targets
    render = jax.jit(render_tiled, static_argnames=("config", "interpret")) \
        .lower(true_model, cams[0], config=RCFG, interpret=True) \
        .compile(FAST_COMPILE)
    targets = [np.asarray(render(true_model, cam)) for cam in cams]
    start = _sh_model(40, 5)
    assert start.sh_degree == 2

    jax_trainer = jt.Trainer(model=start, cameras=cams, targets=targets,
                             scene_extent=2.0, rcfg=RCFG, tcfg=TCFG,
                             log_every=1)
    want = jax_trainer.run(STEPS)
    port_trainer = T.Trainer(model=port_model(start),
                             cameras=[port_camera(c) for c in cams],
                             targets=targets, scene_extent=2.0,
                             rcfg=port_config(RCFG),
                             tcfg=port_train_config(TCFG), log_every=1)
    got = port_trainer.run(STEPS)

    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        list(range(1, STEPS + 1))
    assert [int(r["num_active"]) for r in got] == \
        [int(r["num_active"]) for r in want]
    # the prune passes remove gaussians; nothing is cloned or split
    assert int(want[0]["num_active"]) == 40 > int(want[-1]["num_active"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5,
                                   err_msg=f"step {w['step']}")
        np.testing.assert_allclose(g["psnr"], w["psnr"], atol=1e-4,
                                   err_msg=f"step {w['step']}")
    assert port_trainer.active_sh_degree == jax_trainer.active_sh_degree == 2
    jm = jax_trainer.model
    np.testing.assert_array_equal(np_(port_trainer.model.active),
                                  np.asarray(jm.active))
    for name in PARAM_NAMES:
        err = rel_l2(np_(getattr(port_trainer.model, name)),
                     np.asarray(getattr(jm, name)))
        assert err < 1e-4, (name, err)
    # the reset at step 10 capped every opacity at 0.01 (two Adam steps of
    # learning rate 0.05 in logits since), under the prune threshold: the
    # pass after step 12, the last row's model, left nothing active
    opacity = 1.0 / (1.0 + np.exp(-np.asarray(jm.opacity_logits)))
    assert opacity.max() <= 0.012
    assert not np.asarray(jm.active).any()
