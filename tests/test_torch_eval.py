"""Port vs JAX package: held-out evaluation on the CPU.

On one shared 64x48 scene of two cameras, the rows of the port's
``evaluate`` (``render_tiled``, clip, ``psnr`` and the plain ``ssim``)
against the JAX package's ``evaluate`` (its Pallas rasterizer in interpret
mode): PSNR within 1e-3 dB, SSIM within 1e-5, names, sizes and the
``overflowed`` flag equal, also on a pair pool too small for the scene;
``render_views`` against the port's own renders.
"""

import dataclasses

import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.train.evaluate import (
    evaluate as jax_evaluate,
)
from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import render_tiled
from intro_to_gaussian_splatting_tpu_torch.train.evaluate import (
    evaluate,
    render_views,
)
from tests.scenes import small_scene
from tests.test_torch_common import port_camera, port_config, port_model
from tests.test_torch_train import RCFG


@pytest.fixture(scope="module")
def scene():
    """Two cameras on one 64x48 scene; the targets are noisy renders."""
    _, cam0, model = small_scene(n=60, width=64, height=48, seed=5,
                                 scale_lo=0.08, scale_hi=0.3)
    _, cam1, _ = small_scene(n=60, width=64, height=48, seed=6)
    cams = [cam0, cam1]
    pm = port_model(model)
    rng = np.random.default_rng(0)
    targets = []
    for cam in cams:
        with torch.no_grad():
            img = render_tiled(pm, port_camera(cam), port_config(RCFG))
        targets.append(np.clip(img.numpy() + rng.normal(
            0.0, 0.05, img.shape), 0.0, 1.0).astype(np.float32))
    return model, cams, targets


@pytest.mark.parametrize("pool", ["enough", "too_small"])
def test_evaluate_matches_jax(scene, pool):
    model, cams, targets = scene
    rcfg = RCFG if pool == "enough" else dataclasses.replace(
        RCFG, pairs_per_gaussian=1)
    names = ["a.png", "b.png"]
    want = jax_evaluate(model, cams, targets, rcfg, names=names)
    got = evaluate(port_model(model), [port_camera(c) for c in cams],
                   targets, port_config(rcfg), names=names)
    assert [r["name"] for r in got] == ["a.png", "b.png", "mean"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        assert abs(g["psnr"] - w["psnr"]) <= 1e-3, (g, w)
        assert abs(g["ssim"] - w["ssim"]) <= 1e-5, (g, w)
        for key in ("overflowed", "height", "width"):
            assert g.get(key) == w.get(key), (key, g, w)
    assert all(r["overflowed"] == (pool == "too_small") for r in got[:2])
    assert 5.0 < got[-1]["psnr"] < 60.0


def test_render_views(scene):
    model, cams, _ = scene
    pm, cfg = port_model(model), port_config(RCFG)
    views = render_views(pm, [port_camera(c) for c in cams], cfg)
    for view, cam in zip(views, cams):
        assert view.shape == (48, 64, 3) and view.dtype == np.float32
        with torch.no_grad():
            want = render_tiled(pm, port_camera(cam), cfg).clamp(0, 1)
        np.testing.assert_array_equal(view, want.numpy())
    assert evaluate(pm, [], [], cfg) == []
