"""Pinhole camera as a dataclass of tensors.

Conventions are those of the JAX package (and of the reference it follows):
  * row-vector convention: points transform as ``p_homog @ M``; matrices are
    stored pre-transposed;
  * ``world2view`` = [R | t] homogeneous, transposed;
  * ``projection`` = OpenGL-style perspective from fov, znear=0.001,
    zfar=100, principal point centred;
  * ``full_proj = world2view @ projection``;
  * quaternions are wxyz.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.device import resolve_device

Z_NEAR = 0.001
Z_FAR = 100.0


@dataclasses.dataclass(frozen=True)
class Camera:
    """One camera; every tensor lives on the same device."""

    world2view: torch.Tensor   # (4, 4) row-vector world->camera
    full_proj: torch.Tensor    # (4, 4) row-vector world->clip
    fx: torch.Tensor           # () focal length, pixels
    fy: torch.Tensor
    tan_fovx: torch.Tensor     # () tan(fovX / 2)
    tan_fovy: torch.Tensor
    cam_center: torch.Tensor   # (3,) camera position in world coords
    width: int
    height: int


CAMERA_TENSORS = ("world2view", "full_proj", "fx", "fy", "tan_fovx",
                  "tan_fovy", "cam_center")


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion (4,) -> rotation matrix (3, 3); normalizes first."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def perspective_matrix(znear: float, zfar: float, fovx: float,
                       fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection (column-vector form)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def make_camera(
    fx: float, fy: float, width: int, height: int,
    qvec: np.ndarray, tvec: np.ndarray,
    znear: float = Z_NEAR, zfar: float = Z_FAR,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> Camera:
    """Build a Camera from a COLMAP-style pose (qvec wxyz, tvec world->cam).

    The matrices are composed in float64 on the host, then stored as
    ``dtype`` on ``device`` (the card unless the caller asks for the CPU).
    """
    device = resolve_device(device)
    R = quat_to_rotmat(qvec)
    w2v = np.zeros((4, 4))
    w2v[:3, :3] = R
    w2v[:3, 3] = np.asarray(tvec, dtype=np.float64)
    w2v[3, 3] = 1.0
    w2v = w2v.T
    fovx = focal2fov(fx, width)
    fovy = focal2fov(fy, height)
    proj = perspective_matrix(znear, zfar, fovx, fovy).T
    full_proj = w2v @ proj
    cam_center = np.linalg.inv(w2v)[3, :3]

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
            device=device, dtype=dtype)

    return Camera(
        world2view=t(w2v), full_proj=t(full_proj), fx=t(fx), fy=t(fy),
        tan_fovx=t(math.tan(fovx / 2)), tan_fovy=t(math.tan(fovy / 2)),
        cam_center=t(cam_center), width=int(width), height=int(height),
    )


def world2view_recentered(
    R: np.ndarray, t: np.ndarray,
    translate: np.ndarray = (0.0, 0.0, 0.0), scale: float = 1.0,
) -> np.ndarray:
    """World->view with a recentered/rescaled camera position: recompose
    [R^T | t], invert to cam2world, shift+scale the centre, invert back.
    Returns the plain (column-vector) 4x4."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(R, dtype=np.float64).T
    Rt[:3, 3] = np.asarray(t, dtype=np.float64)
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    c2w[:3, 3] = (c2w[:3, 3] + np.asarray(translate, np.float64)) * scale
    return np.linalg.inv(c2w)


def stack_cameras(cams) -> Camera:
    """Stack same-resolution cameras into one batched Camera (a leading
    camera dimension on every tensor)."""
    w, h = cams[0].width, cams[0].height
    if not all(c.width == w and c.height == h for c in cams):
        raise ValueError("stack_cameras requires equal resolutions; group "
                         "by size first")
    return Camera(**{name: torch.stack([getattr(c, name) for c in cams])
                     for name in CAMERA_TENSORS}, width=w, height=h)


def index_camera(cams: Camera, i: int) -> Camera:
    """Camera ``i`` of a stacked Camera."""
    return Camera(**{name: getattr(cams, name)[i]
                     for name in CAMERA_TENSORS},
                  width=cams.width, height=cams.height)


def camera_from_colmap(camera, image, downscale: int = 1,
                       device: str | torch.device | None = None) -> Camera:
    """Build from io.colmap records (ColmapCamera, ColmapImage)."""
    return make_camera(
        fx=camera.fx / downscale, fy=camera.fy / downscale,
        width=camera.width // downscale, height=camera.height // downscale,
        qvec=image.qvec, tvec=image.tvec, device=device,
    )
