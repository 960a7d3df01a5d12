"""Synthetic scenes made offline from a seed: a clustered point cloud and a
ring of inward-looking cameras, at any scale up to the reference benchmark
scene's (``treehill_like_scene``: 52,363 points, 5068 x 3324), and a whole
COLMAP scene on disk (``make_colmap_scene``: sparse model, true keypoints
and, optionally, ground-truth images), the offline stand-in for the
network-fetched datasets."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from intro_to_gaussian_splatting_tpu_torch.io import colmap as C
from intro_to_gaussian_splatting_tpu_torch.models.camera import (
    Z_FAR,
    Z_NEAR,
    focal2fov,
    perspective_matrix,
    quat_to_rotmat,
)


def random_point_cloud(
    n: int, seed: int = 0, extent: float = 4.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Clustered point cloud (positions, u8 colors) roughly like a COLMAP
    sparse reconstruction (dense near the object, sparse background)."""
    rng = np.random.default_rng(seed)
    n_core = int(n * 0.8)
    core = rng.normal(0.0, extent * 0.25, size=(n_core, 3))
    bg = rng.uniform(-extent, extent, size=(n - n_core, 3))
    xyz = np.concatenate([core, bg], axis=0)
    rgb = rng.integers(0, 256, size=(n, 3), dtype=np.uint8)
    return xyz.astype(np.float64), rgb


def ring_cameras(
    num_cameras: int,
    width: int,
    height: int,
    focal: float | None = None,
    radius: float = 6.0,
    z: float = 1.5,
    seed: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Poses on a ring looking at the origin. Returns [(qvec wxyz, tvec)],
    tvec being the COLMAP world->camera translation: x_cam = R x_world + t.
    """
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(num_cameras):
        theta = 2 * np.pi * i / num_cameras + rng.uniform(-0.05, 0.05)
        eye = np.array([radius * np.cos(theta), radius * np.sin(theta), z])
        # camera convention: +z forward, +x right, +y down (COLMAP)
        forward = -eye / np.linalg.norm(eye)
        world_up = np.array([0.0, 0.0, -1.0])
        right = np.cross(forward, world_up)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        R = np.stack([right, down, forward], axis=0)  # world->camera rows
        t = -R @ eye
        poses.append((rotmat_to_quat(R), t))
    return poses


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> wxyz quaternion (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def project_points_numpy(
    xyz: np.ndarray, qvec: np.ndarray, tvec: np.ndarray,
    fx: float, width: int, height: int, min_z: float = 0.2,
    fy: float | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-NumPy pinhole projection: world points -> (xy pixels, valid).

    The reference's keypoint-overlay math (cull -> homog @ full_proj -> /w
    -> ndc2Pix) in float64, in the row-vector convention of
    ``models.camera.make_camera``, so a synthetic scene's stored keypoints
    agree with what ``ops.points.project_points`` computes. Scene making
    never touches a device."""
    fy = fx if fy is None else fy
    R = quat_to_rotmat(qvec)
    w2v = np.zeros((4, 4))
    w2v[:3, :3] = R
    w2v[:3, 3] = np.asarray(tvec, dtype=np.float64)
    w2v[3, 3] = 1.0
    w2v = w2v.T
    proj = perspective_matrix(Z_NEAR, Z_FAR, focal2fov(fx, width),
                              focal2fov(fy, height)).T
    full_proj = w2v @ proj
    homog = np.concatenate([xyz, np.ones((len(xyz), 1))], axis=1)
    depth = (homog @ w2v)[:, 2]
    clip = homog @ full_proj
    w = np.where(np.abs(clip[:, 3:4]) < 1e-12, 1e-12, clip[:, 3:4])
    ndc = clip[:, :3] / w
    x = (ndc[:, 0] + 1.0) * (width - 1) / 2.0   # ndc2Pix
    y = (ndc[:, 1] + 1.0) * (height - 1) / 2.0
    valid = ((depth >= min_z) & (x >= 0) & (x < width)
             & (y >= 0) & (y < height))
    return np.stack([x, y], axis=1), valid


def make_colmap_scene(
    out_dir: str,
    num_points: int = 500,
    num_cameras: int = 4,
    width: int = 128,
    height: int = 96,
    seed: int = 0,
    write_images: bool = False,
    keypoint_noise_px: float = 0.0,
    device=None,
) -> str:
    """Write a synthetic COLMAP sparse model to ``out_dir/sparse/0`` and
    return that path; the same bytes as the JAX package's
    ``make_colmap_scene`` for the same arguments.

    The stored 2D keypoints are the true projections of the 3D points into
    each camera (optionally perturbed by ``keypoint_noise_px`` of gaussian
    noise), so projected points land on the stored keypoints. With
    ``write_images=True`` a ground-truth PNG per camera, rendered by the
    dense oracle ``ops.compositing.render_dense`` over the cloud with soft
    splats on ``device`` (the card unless the caller asks for the CPU), goes
    under ``out_dir/images/`` by the name ``images.bin`` lists; writing it
    needs PIL."""
    sparse = os.path.join(out_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    rng = np.random.default_rng(seed)

    xyz, rgb = random_point_cloud(num_points, seed)
    focal = 0.9 * max(width, height)
    cameras: Dict[int, C.ColmapCamera] = {
        1: C.ColmapCamera(
            id=1, model="PINHOLE", width=width, height=height,
            params=np.array([focal, focal, width / 2.0, height / 2.0]),
        )
    }
    poses = ring_cameras(num_cameras, width, height, seed=seed)
    images: Dict[int, C.ColmapImage] = {}
    # each image observes a random subset of its visible points (for track
    # structure); keypoints are their true projections
    track_image_ids = [[] for _ in range(num_points)]
    track_p2d = [[] for _ in range(num_points)]
    for i, (qvec, tvec) in enumerate(poses, start=1):
        all_xy, valid = project_points_numpy(
            xyz, qvec, tvec, focal, width, height)
        visible = np.flatnonzero(valid)
        n_obs = max(1, min(len(visible), num_points // 2))
        obs = np.sort(rng.choice(visible, size=n_obs, replace=False))
        xys = all_xy[obs]
        if keypoint_noise_px > 0:
            xys = xys + rng.normal(0.0, keypoint_noise_px, xys.shape)
        pids = np.arange(1, num_points + 1)[obs]
        images[i] = C.ColmapImage(
            id=i, qvec=qvec, tvec=tvec, camera_id=1,
            name=f"im_{i:04d}.png", xys=xys, point3D_ids=pids,
        )
        for k, p in enumerate(obs):
            track_image_ids[p].append(i)
            track_p2d[p].append(k)

    lengths = np.array([len(t) for t in track_image_ids], dtype=np.int64)
    points = C.ColmapPoints(
        ids=np.arange(1, num_points + 1, dtype=np.int64),
        xyz=xyz,
        rgb=rgb,
        error=rng.uniform(0.1, 2.0, size=num_points),
        track_lengths=lengths,
        track_image_ids=np.array(
            [i for t in track_image_ids for i in t], dtype=np.int64),
        track_point2D_idxs=np.array(
            [i for t in track_p2d for i in t], dtype=np.int64),
    )
    C.write_cameras_binary(cameras, os.path.join(sparse, "cameras.bin"))
    C.write_images_binary(images, os.path.join(sparse, "images.bin"))
    C.write_points3D_binary(points, os.path.join(sparse, "points3D.bin"))

    if write_images:
        import torch
        from PIL import Image

        from intro_to_gaussian_splatting_tpu_torch.models import (
            camera_from_colmap, init_from_points,
        )
        from intro_to_gaussian_splatting_tpu_torch.ops.compositing import (
            render_dense,
        )

        img_dir = os.path.join(out_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        model = init_from_points(xyz, rgb, scale_init=0.05, opacity=0.9,
                                 device=device)
        for i in sorted(images):
            cam = camera_from_colmap(cameras[1], images[i],
                                     device=model.device)
            with torch.no_grad():
                img = render_dense(model, cam).cpu().numpy()
            arr = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(img_dir, images[i].name))
    return sparse


def treehill_like_scene(
    num_points: int = 52363, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[np.ndarray, np.ndarray]]]:
    """Point cloud + poses at the scale of the reference benchmark scene
    (52,363 gaussians seen at 5068 x 3324)."""
    xyz, rgb = random_point_cloud(num_points, seed, extent=10.0)
    poses = ring_cameras(8, 5068, 3324, radius=14.0, z=3.0, seed=seed)
    return xyz, rgb, poses
