"""Port vs JAX package: the point-projection sanity path on the CPU.

``project_points`` against the JAX package's (pixel coordinates within
1e-4 px, depths rel 1e-6, the validity mask equal), ``render_points_image``
equal to the JAX package's image (nearest point per pixel, squares of
radius 1), and ``keypoint_reprojection_report`` equal to the JAX package's
on a synthetic COLMAP scene with noisy keypoints (float64 numpy in both:
rel 1e-12), at full resolution and downscaled.
"""

import numpy as np
import pytest

from intro_to_gaussian_splatting_tpu.io.colmap import read_model as jax_read
from intro_to_gaussian_splatting_tpu.ops import points as jp
from intro_to_gaussian_splatting_tpu_torch.io.colmap import read_model
from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
    make_colmap_scene,
)
from intro_to_gaussian_splatting_tpu_torch.ops import points as pp
from tests.scenes import small_scene
from tests.test_torch_common import np_, port_camera


def test_project_points_and_image_match_jax():
    raw, cam, model = small_scene(n=150, width=48, height=40, seed=11)
    pts = np.concatenate([raw["points"], [[0.0, 0.0, 40.0]]])   # behind
    xy, depth, valid = jp.project_points(pts.astype(np.float32), cam)
    pxy, pdepth, pvalid = pp.project_points(pts, port_camera(cam))
    np.testing.assert_array_equal(np_(pvalid), np.asarray(valid))
    assert 0 < int(np.asarray(valid).sum()) < len(pts)
    np.testing.assert_allclose(np_(pxy), np.asarray(xy), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np_(pdepth), np.asarray(depth), rtol=1e-6,
                               atol=1e-6)

    colors = raw["colors"].astype(np.float32)
    for radius in (0, 1):
        want = np.asarray(jp.render_points_image(
            raw["points"].astype(np.float32), colors, cam,
            splat_radius=radius))
        got = np_(pp.render_points_image(raw["points"], colors,
                                         port_camera(cam),
                                         splat_radius=radius))
        assert got.shape == (40, 48, 3)
        np.testing.assert_array_equal(got, want)
        assert (np.abs(got - 1.0).sum(-1) > 1e-6).sum() > 20


@pytest.mark.parametrize("downscale", [1, 2])
def test_keypoint_report_matches_jax(tmp_path, downscale):
    sparse = make_colmap_scene(str(tmp_path), num_points=200, num_cameras=2,
                               width=64, height=48, seed=4,
                               keypoint_noise_px=0.5)
    cams, ims, points = read_model(sparse)
    jcams, jims, jpoints = jax_read(sparse)
    points = points.filter_by_track_length(2)
    jpoints = jpoints.filter_by_track_length(2)
    for iid in sorted(ims):
        got = pp.keypoint_reprojection_report(points, cams[1], ims[iid],
                                              downscale)
        want = jp.keypoint_reprojection_report(jpoints, jcams[1], jims[iid],
                                               downscale)
        assert got.keys() == want.keys()
        assert got["n_matched"] == want["n_matched"] > 0
        for k in ("mean_px", "median_px", "p90_px", "max_px"):
            assert got[k] == pytest.approx(want[k], rel=1e-12)
        assert 0.1 / downscale < got["mean_px"] < 2.0 / downscale
