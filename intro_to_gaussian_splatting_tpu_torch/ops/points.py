"""Point-projection sanity path.

The port's counterpart of the JAX package's ``ops/points.py``: project the
raw COLMAP 3D points into a camera (frustum cull, homogeneous point times
the full projection, divide by w, ndc2Pix) and compare with COLMAP's stored
2D keypoints, or scatter the cloud into an image for a look.

  * ``project_points``: slot-aligned pixel coordinates, depths and a
    validity mask (no compaction);
  * ``render_points_image``: the nearest point wins each pixel, as a
    depth scatter-min, then only the winners write their colour;
  * ``keypoint_reprojection_report``: the reprojection error in pixels,
    host-side numpy.

The 4x4 transforms are written out as products and sums in float32, so no
TF32 matrix unit touches them whatever the process's matmul settings.
"""

from __future__ import annotations

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.models.camera import Camera
from intro_to_gaussian_splatting_tpu_torch.ops.projection import ndc2pix


def _transform32(homog: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, 4) @ (4, 4) in plain float32 arithmetic (never TF32)."""
    return (homog[:, 0:1] * m[0] + homog[:, 1:2] * m[1]
            + homog[:, 2:3] * m[2] + homog[:, 3:4] * m[3])


def project_points(points, camera: Camera, min_z: float = 0.2):
    """World-space points (N, 3) -> (xy (N, 2) pixel coordinates, depth
    (N,) camera-space z, valid (N,) bool: in front of ``min_z`` and inside
    the image). Culled slots keep their position with ``valid`` False."""
    dev = camera.world2view.device
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    homog = torch.cat([pts, torch.ones((pts.shape[0], 1), dtype=pts.dtype,
                                       device=dev)], dim=1)
    depth = _transform32(homog, camera.world2view.float())[:, 2]
    in_front = depth >= min_z
    p_clip = _transform32(homog, camera.full_proj.float())
    w = p_clip[:, 3:4]
    w_safe = torch.where(torch.abs(w) < 1e-8, torch.full_like(w, 1e-8), w)
    p_ndc = p_clip[:, :3] / w_safe
    x = ndc2pix(p_ndc[:, 0], camera.width)
    y = ndc2pix(p_ndc[:, 1], camera.height)
    on_screen = (x >= 0) & (x < camera.width) & (y >= 0) & (y < camera.height)
    return torch.stack([x, y], dim=1), depth, in_front & on_screen


@torch.no_grad()
def render_points_image(points, colors, camera: Camera,
                        background: float = 1.0,
                        splat_radius: int = 1) -> torch.Tensor:
    """Scatter the projected cloud into an (H, W, 3) image: the nearest
    point wins each pixel, drawn as a (2r+1) x (2r+1) square so that a
    sparse cloud stays visible at full resolution."""
    h, w = camera.height, camera.width
    xy, depth, valid = project_points(points, camera)
    dev = xy.device
    xi = torch.round(xy[:, 0]).to(torch.int64)
    yi = torch.round(xy[:, 1]).to(torch.int64)
    r = splat_radius
    offsets = [(dx, dy) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    dropped = h * w        # one slot past the image takes culled points

    def pixel_index(dx, dy):
        xs = torch.clamp(xi + dx, 0, w - 1)
        ys = torch.clamp(yi + dy, 0, h - 1)
        return torch.where(valid, ys * w + xs, dropped)

    # pass 1: per-pixel nearest depth (a scatter-min is order-free)
    z = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    flat_z = torch.full((h * w + 1,), float("inf"), dtype=torch.float32,
                        device=dev)
    for dx, dy in offsets:
        flat_z.scatter_reduce_(0, pixel_index(dx, dy), z, reduce="amin")
    # pass 2: only the depth winners write their colour (losers go to the
    # dropped slot, so none overwrites a winner)
    cols = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    flat_rgb = torch.full((h * w + 1, 3), float(background),
                          dtype=torch.float32, device=dev)
    for dx, dy in offsets:
        idx = pixel_index(dx, dy)
        won = valid & (flat_z[idx] >= z)
        flat_rgb[torch.where(won, idx, dropped)] = cols
    return flat_rgb[:dropped].reshape(h, w, 3)


def keypoint_reprojection_report(points, camera_rec, image_rec,
                                 downscale: int = 1) -> dict:
    """Projected 3D points against COLMAP's stored 2D keypoints: for every
    keypoint of ``image_rec`` linked to a point of ``points``, the
    reprojection error in (downscaled) pixels. Host-side numpy only.
    Returns {n_keypoints, n_matched, mean_px, median_px, p90_px, max_px}.

    The camera model assumes a centred principal point; a reconstruction
    with an off-centre cx/cy shows a constant offset of that many pixels.
    """
    from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
        project_points_numpy,
    )

    # project at full resolution, then rescale: ndc2Pix scales by
    # (dim - 1) / 2, so projecting at W/d would carry a (d-1)/d px offset
    xy, valid = project_points_numpy(
        np.asarray(points.xyz, np.float64), image_rec.qvec, image_rec.tvec,
        fx=camera_rec.fx, fy=camera_rec.fy,
        width=camera_rec.width, height=camera_rec.height)
    xy = xy / downscale
    id_to_row = {int(pid): i for i, pid in enumerate(points.ids)}
    errs = []
    pids = np.asarray(image_rec.point3D_ids)
    for k, pid in enumerate(pids):
        row = id_to_row.get(int(pid))
        if row is None or not valid[row]:
            continue
        stored = np.asarray(image_rec.xys[k], np.float64) / downscale
        errs.append(np.linalg.norm(xy[row] - stored))
    errs = np.asarray(errs)
    return dict(
        n_keypoints=int(len(pids)),
        n_matched=int(len(errs)),
        mean_px=float(errs.mean()) if len(errs) else None,
        median_px=float(np.median(errs)) if len(errs) else None,
        p90_px=float(np.percentile(errs, 90)) if len(errs) else None,
        max_px=float(errs.max()) if len(errs) else None,
    )
