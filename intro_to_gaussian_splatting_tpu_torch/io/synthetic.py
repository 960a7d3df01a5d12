"""Synthetic scenes made offline from a seed: a clustered point cloud and a
ring of inward-looking cameras, at any scale up to the reference benchmark
scene's (``treehill_like_scene``: 52,363 points, 5068 x 3324)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


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


def treehill_like_scene(
    num_points: int = 52363, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[np.ndarray, np.ndarray]]]:
    """Point cloud + poses at the scale of the reference benchmark scene
    (52,363 gaussians seen at 5068 x 3324)."""
    xyz, rgb = random_point_cloud(num_points, seed, extent=10.0)
    poses = ring_cameras(8, 5068, 3324, radius=14.0, z=3.0, seed=seed)
    return xyz, rgb, poses
