"""Port vs JAX package: camera, spherical harmonics, covariances, KNN scale
and point-cloud init. Same numpy inputs into both; atol 1e-6 (float32)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.io.synthetic import ring_cameras
from intro_to_gaussian_splatting_tpu.models import camera as jcam
from intro_to_gaussian_splatting_tpu.models import gaussians as jg
from intro_to_gaussian_splatting_tpu.models import sh as jsh
from intro_to_gaussian_splatting_tpu_torch.io.colmap import (
    ColmapCamera,
    ColmapImage,
)
from intro_to_gaussian_splatting_tpu_torch.models import camera as tcam
from intro_to_gaussian_splatting_tpu_torch.models import gaussians as tg
from intro_to_gaussian_splatting_tpu_torch.models import sh as tsh
from tests.test_torch_common import np_

ATOL = 1e-6


@pytest.mark.parametrize("seed,width,height", [(0, 64, 48), (5, 5068, 3324)])
def test_camera_fields_match(seed, width, height):
    qvec, tvec = ring_cameras(3, width, height, seed=seed)[seed % 3]
    focal = 0.78 * width
    want = jcam.make_camera(focal, 0.9 * focal, width, height, qvec, tvec)
    got = tcam.make_camera(focal, 0.9 * focal, width, height, qvec, tvec,
                           device="cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("width", "height"):
            assert a == b
        else:
            assert b.dtype == torch.float32
            np.testing.assert_allclose(np_(b), np.asarray(a), rtol=0,
                                       atol=ATOL, err_msg=f.name)
    np.testing.assert_array_equal(tcam.quat_to_rotmat(qvec),
                                  jcam.quat_to_rotmat(qvec))


def test_world2view_recentered_and_colmap_camera():
    rng = np.random.default_rng(0)
    q = rng.normal(size=4)
    R = tcam.quat_to_rotmat(q)
    t = rng.normal(size=3)
    np.testing.assert_array_equal(
        tcam.world2view_recentered(R, t, (0.5, -1.0, 2.0), 1.7),
        jcam.world2view_recentered(R, t, (0.5, -1.0, 2.0), 1.7))
    c = ColmapCamera(1, "PINHOLE", 200, 100, np.array([180.0, 170.0, 100, 50]))
    im = ColmapImage(1, q / np.linalg.norm(q), t, 1, "a.png",
                     np.zeros((0, 2)), np.zeros(0, np.int64))
    want = jcam.camera_from_colmap(c, im, downscale=2)
    got = tcam.camera_from_colmap(c, im, downscale=2, device="cpu")
    assert (got.width, got.height) == (want.width, want.height)
    np.testing.assert_allclose(np_(got.full_proj), np.asarray(want.full_proj),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(0.0, 0.5, size=(50, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
        np.float32)
    want = np.asarray(jsh.eval_sh(jnp.asarray(sh), jnp.asarray(dirs), degree))
    got = np_(tsh.eval_sh(torch.from_numpy(sh), torch.from_numpy(dirs),
                          degree))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    rgb = rng.uniform(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(tsh.rgb_to_sh(torch.from_numpy(rgb))),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(np_(tsh.sh_to_rgb(torch.from_numpy(rgb))),
                               np.asarray(jsh.sh_to_rgb(jnp.asarray(rgb))),
                               rtol=0, atol=ATOL)
    assert tsh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree)


def test_covariances_match():
    rng = np.random.default_rng(3)
    log_scales = np.log(rng.uniform(0.02, 0.3, size=(64, 3))).astype(
        np.float32)
    quats = rng.normal(size=(64, 4)).astype(np.float32)
    jl, jq = jnp.asarray(log_scales), jnp.asarray(quats)
    tl, tq = torch.from_numpy(log_scales), torch.from_numpy(quats)
    np.testing.assert_allclose(np_(tg.quats_to_rotmats(tq)),
                               np.asarray(jg.quats_to_rotmats(jq)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(np_(tg.covariance_3d(tl, tq)),
                               np.asarray(jg.covariance_3d(jl, jq)),
                               rtol=0, atol=ATOL)
    for a, b in zip(tg.covariance_3d_channels(tl, tq),
                    jg.covariance_3d_channels(jl, jq)):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=0, atol=ATOL)


def test_knn_mean_scale_matches():
    rng = np.random.default_rng(4)
    pts = rng.normal(0.0, 1.0, size=(300, 3)).astype(np.float32)
    want = np.asarray(jg.knn_mean_scale(jnp.asarray(pts), chunk=128))
    got = np_(tg.knn_mean_scale(torch.from_numpy(pts), chunk=128))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kwargs", [
    dict(),                                              # reference init
    dict(scale_init=None, opacity=0.9),                  # KNN init
    dict(sh_degree=3, color_space="sh", capacity=260),   # SH colours, pool
])
def test_init_from_points_matches(kwargs):
    rng = np.random.default_rng(5)
    pts = rng.normal(0.0, 1.5, size=(200, 3))
    rgb = rng.integers(0, 256, size=(200, 3), dtype=np.uint8)
    want = jg.init_from_points(pts, rgb, **kwargs)
    got = tg.init_from_points(pts, rgb, device="cpu", **kwargs)
    assert got.color_space == want.color_space
    assert got.sh_degree == want.sh_degree
    for name in ("means", "log_scales", "quats", "opacity_logits", "sh",
                 "active"):
        np.testing.assert_allclose(np_(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
