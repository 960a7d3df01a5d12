"""Pinhole camera matrices from a world-to-camera pose, in the row-vector
convention (points transform as ``p_homog @ M``), OpenGL-style perspective
with znear 0.001 and zfar 100 and the principal point centred."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Z_NEAR = 0.001
Z_FAR = 100.0


@dataclasses.dataclass(frozen=True)
class RefCamera:
    world2view: torch.Tensor   # (4, 4) row-vector world -> camera
    full_proj: torch.Tensor    # (4, 4) row-vector world -> clip
    fx: float
    fy: float
    tan_fovx: float
    tan_fovy: float
    cam_center: torch.Tensor   # (3,)
    width: int
    height: int


def make_ref_camera(R: np.ndarray, t: np.ndarray, focal: float, width: int,
                    height: int, device) -> RefCamera:
    """``R`` (3, 3) and ``t`` (3,): x_cam = R x_world + t."""
    w2v = np.eye(4)
    w2v[:3, :3] = R
    w2v[:3, 3] = t
    w2v = w2v.T
    tan_x = width / (2.0 * focal)
    tan_y = height / (2.0 * focal)
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / tan_x
    proj[1, 1] = 1.0 / tan_y
    proj[3, 2] = 1.0
    proj[2, 2] = Z_FAR / (Z_FAR - Z_NEAR)
    proj[2, 3] = -(Z_FAR * Z_NEAR) / (Z_FAR - Z_NEAR)
    full = w2v @ proj.T
    center = -np.asarray(R, dtype=np.float64).T @ np.asarray(t, np.float64)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=device, dtype=torch.float32)

    return RefCamera(world2view=f32(w2v), full_proj=f32(full),
                     fx=float(np.float32(focal)), fy=float(np.float32(focal)),
                     tan_fovx=float(np.float32(tan_x)),
                     tan_fovy=float(np.float32(tan_y)),
                     cam_center=f32(center), width=int(width),
                     height=int(height))
