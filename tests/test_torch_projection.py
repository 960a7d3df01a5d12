"""Port vs JAX package: project_gaussians and pack_records.

Floats within rtol 1e-5 / atol 1e-6 (float32, same operation order);
``valid`` and ``radius`` exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.config import (
    CompatConfig,
    RasterizerConfig,
)
from intro_to_gaussian_splatting_tpu.ops import projection as jp
from intro_to_gaussian_splatting_tpu_torch.ops import projection as tp
from tests.scenes import small_scene
from tests.test_torch_common import np_, port_camera, port_config, port_model

FIELDS = ("mean2d", "depth", "conic", "color", "opacity")


def _scene(color):
    raw, cam, model = small_scene(n=120, width=40, height=32, seed=9,
                                  scale_hi=0.4)
    # culled slots: eight behind the camera, four inactive
    means = np.array(model.means)
    means[:8] = 1.5 * np.asarray(cam.cam_center)
    active = np.ones(120, bool)
    active[8:12] = False
    model = model.replace(means=jnp.asarray(means), active=jnp.asarray(active))
    if color == "sh3":
        rng = np.random.default_rng(9)
        sh = rng.normal(0.0, 0.3, size=(120, 16, 3)).astype(np.float32)
        model = model.replace(sh=jnp.asarray(sh), color_space="sh")
    return cam, model


@pytest.mark.parametrize("color,compat,offset", [
    ("rgb", CompatConfig(), False),
    ("sh3", CompatConfig(), True),
    ("rgb", CompatConfig.REFERENCE_CPU, False),     # double sigmoid
])
def test_project_gaussians_matches(color, compat, offset):
    cam, model = _scene(color)
    cfg = RasterizerConfig(compat=compat, cov2d_dilation=0.3)
    off = (np.random.default_rng(1).normal(size=(120, 2)).astype(np.float32)
           if offset else None)
    want = jp.project_gaussians(
        model, cam, cfg, mean2d_offset=None if off is None else jnp.asarray(off))
    got = tp.project_gaussians(
        port_model(model), port_camera(cam), port_config(cfg),
        mean2d_offset=None if off is None else torch.from_numpy(off))
    for name in FIELDS:
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(np_(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(np_(got.radius), np.asarray(want.radius))
    assert np.asarray(want.valid).any() and not np.asarray(want.valid).all()

    np.testing.assert_allclose(np_(tp.pack_records(got)),
                               np.asarray(jp.pack_records(want)),
                               rtol=1e-5, atol=1e-6)


def test_active_sh_degree_and_record_rows():
    cam, model = _scene("sh3")
    cfg = RasterizerConfig()
    want = jp.project_gaussians(model, cam, cfg, active_sh_degree=1)
    got = tp.project_gaussians(port_model(model), port_camera(cam),
                               port_config(cfg), active_sh_degree=1)
    np.testing.assert_allclose(np_(got.color), np.asarray(want.color),
                               rtol=1e-5, atol=1e-6)
    for name in ("REC_MEAN_X", "REC_MEAN_Y", "REC_CONIC_A", "REC_CONIC_B",
                 "REC_CONIC_C", "REC_OPACITY", "REC_MIN_X", "REC_MAX_X",
                 "REC_MIN_Y", "REC_MAX_Y", "REC_TILE", "REC_COLOR_R",
                 "REC_COLOR_G", "REC_COLOR_B", "REC_DEPTH", "REC_ONE",
                 "PAYLOAD_START", "NUM_PAYLOAD", "NUM_REC_ROWS"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.ndc2pix(torch.tensor(0.25), 101) == float(
        jp.ndc2pix(jnp.float32(0.25), 101))
