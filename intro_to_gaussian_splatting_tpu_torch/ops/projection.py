"""Geometry pass: 3D gaussians -> screen-space splat records.

Steps, batched over gaussians and written elementwise in the same order as
the JAX package so both round alike:
  1. frustum cull: camera-space z >= min_z
  2. Sigma_3d = (R S)(R S)^T as six channels
  3. NDC projection + ndc2pix
  4. EWA 2D covariance (J W Sigma W^T J^T)[:2, :2]
  5. closed-form 2x2 inverse ("conic") with a determinant clamp
  6. 3-sigma screen radius via eigenvalues
  7. colour: raw RGB or SH evaluation
Culled gaussians keep their slots with ``valid=False`` and radius 0.
"""

from __future__ import annotations

import dataclasses

import torch

from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig
from intro_to_gaussian_splatting_tpu_torch.models.camera import Camera
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    GaussianModel,
    covariance_3d_channels,
)
from intro_to_gaussian_splatting_tpu_torch.models.sh import eval_sh

# Feature rows of the packed, feature-major (NUM_REC_ROWS, N) record matrix.
# The payload rows [r, g, b, depth, 1] are contiguous at the end.
REC_MEAN_X = 0
REC_MEAN_Y = 1
REC_CONIC_A = 2   # inverse-covariance [0, 0]
REC_CONIC_B = 3   # inverse-covariance [0, 1]
REC_CONIC_C = 4   # inverse-covariance [1, 1]
REC_OPACITY = 5
REC_MIN_X = 6
REC_MAX_X = 7
REC_MIN_Y = 8
REC_MAX_Y = 9
REC_TILE = 10     # pair's tile id (binning fills it; f32-exact below 2^24)
REC_COLOR_R = 11
REC_COLOR_G = 12
REC_COLOR_B = 13
REC_DEPTH = 14
REC_ONE = 15
PAYLOAD_START = 11
NUM_PAYLOAD = 5
NUM_REC_ROWS = 16
# Rows that carry a gradient back from the rasterizer; its backward (B2)
# writes exact zeros in the bbox, tile-id and constant-one rows.
GRAD_ROWS = (REC_MEAN_X, REC_MEAN_Y, REC_CONIC_A, REC_CONIC_B, REC_CONIC_C,
             REC_OPACITY, REC_COLOR_R, REC_COLOR_G, REC_COLOR_B, REC_DEPTH)


@dataclasses.dataclass(frozen=True)
class ProjectedGaussians:
    """Per-gaussian screen-space quantities, slot-aligned with the model."""

    mean2d: torch.Tensor   # (N, 2) pixel coords
    depth: torch.Tensor    # (N,) camera-space z
    conic: torch.Tensor    # (N, 3) [a, b, c] of the 2x2 inverse covariance
    radius: torch.Tensor   # (N,) screen-space radius, pixels (0 when invalid)
    color: torch.Tensor    # (N, 3)
    opacity: torch.Tensor  # (N,)
    valid: torch.Tensor    # (N,) bool


def ndc2pix(v: torch.Tensor, dim: int) -> torch.Tensor:
    return (v + 1.0) * (dim - 1) * 0.5


def project_gaussians(
    model: GaussianModel,
    camera: Camera,
    config: RasterizerConfig = RasterizerConfig(),
    active_sh_degree: int | None = None,
    mean2d_offset: torch.Tensor | None = None,
) -> ProjectedGaussians:
    f32 = torch.float32
    means = model.means.to(f32)
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    w2v = camera.world2view.to(f32)

    def affine(m, col):                                     # row-vector p @ M
        return mx * m[0, col] + my * m[1, col] + mz * m[2, col] + m[3, col]

    xv = affine(w2v, 0)
    yv = affine(w2v, 1)
    depth = affine(w2v, 2)
    in_frustum = depth >= config.frustum_min_z

    fp = camera.full_proj.to(f32)
    w = affine(fp, 3)
    w_safe = torch.where(torch.abs(w) < 1e-8, 1e-8, w)
    mean2d = torch.stack(
        [ndc2pix(affine(fp, 0) / w_safe, camera.width),
         ndc2pix(affine(fp, 1) / w_safe, camera.height)], dim=1)
    if mean2d_offset is not None:
        # zero-valued probe: its gradient is the screen-space positional
        # gradient that densification reads
        mean2d = mean2d + mean2d_offset

    sxx, sxy, sxz, syy, syz, szz = covariance_3d_channels(
        model.log_scales.to(f32), model.quats.to(f32))
    z = depth
    z_safe = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    limx = config.ewa_clamp * camera.tan_fovx
    limy = config.ewa_clamp * camera.tan_fovy
    x = torch.clamp(xv / z_safe, -limx, limx) * z
    y = torch.clamp(yv / z_safe, -limy, limy) * z
    fx, fy = camera.fx, camera.fy
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    # M = J @ W, J = [[fx/z, 0, -fx*x/z^2], [0, fy/z, -fy*y/z^2]],
    # W = w2v[:3, :3].T
    j00, j02 = fx * inv_z, -fx * x * inv_z2
    j11, j12 = fy * inv_z, -fy * y * inv_z2
    m = [[j00 * w2v[k, 0] + j02 * w2v[k, 2] for k in range(3)],
         [j11 * w2v[k, 1] + j12 * w2v[k, 2] for k in range(3)]]

    def quad(u, v):                                         # u . Sigma3d . v
        return (u[0] * v[0] * sxx + u[1] * v[1] * syy + u[2] * v[2] * szz
                + (u[0] * v[1] + u[1] * v[0]) * sxy
                + (u[0] * v[2] + u[2] * v[0]) * sxz
                + (u[1] * v[2] + u[2] * v[1]) * syz)

    a = quad(m[0], m[0]) + config.cov2d_dilation
    b = quad(m[0], m[1])
    c = quad(m[1], m[1]) + config.cov2d_dilation

    det = a * c - b * b
    det_clamped = torch.clamp(det, min=config.det_clamp)
    conic = torch.stack([c, -b, a], dim=1) / det_clamped[:, None]

    mid = 0.5 * (a + c)
    disc = torch.clamp(mid * mid - det, min=config.eig_floor)
    lam_max = mid + torch.sqrt(disc)
    radius = torch.ceil(
        config.radius_sigmas * torch.sqrt(torch.clamp(lam_max, min=0.0)))

    if model.color_space == "rgb":
        color = model.sh[:, 0, :].to(f32)
    else:
        deg = model.sh_degree if active_sh_degree is None else active_sh_degree
        dirs = means - camera.cam_center.to(f32)
        norm = torch.sqrt(torch.sum(dirs * dirs, dim=1, keepdim=True))
        dirs = dirs / torch.clamp(norm, min=1e-8)
        color = eval_sh(model.sh.to(f32), dirs, deg)

    opacity = torch.sigmoid(model.opacity_logits.to(f32))
    if config.compat.double_sigmoid:
        opacity = torch.sigmoid(opacity)

    valid = in_frustum & model.active & (radius > 0)
    radius = torch.where(valid, radius, 0.0)

    return ProjectedGaussians(
        mean2d=mean2d, depth=depth, conic=conic, radius=radius,
        color=color, opacity=opacity, valid=valid,
    )


def pack_records(proj: ProjectedGaussians) -> torch.Tensor:
    """The (NUM_REC_ROWS, N) feature-major record matrix the rasterizer
    reads. The bbox rows are integer-valued tests and carry no gradient."""
    radius = proj.radius.detach()
    mean2d_ng = proj.mean2d.detach()
    zeros = torch.zeros_like(proj.depth)
    rows = [
        proj.mean2d[:, 0],
        proj.mean2d[:, 1],
        proj.conic[:, 0],
        proj.conic[:, 1],
        proj.conic[:, 2],
        proj.opacity,
        torch.floor(mean2d_ng[:, 0] - radius),
        torch.ceil(mean2d_ng[:, 0] + radius),
        torch.floor(mean2d_ng[:, 1] - radius),
        torch.ceil(mean2d_ng[:, 1] + radius),
        zeros,                       # tile-id row, filled by binning
        proj.color[:, 0],
        proj.color[:, 1],
        proj.color[:, 2],
        proj.depth,
        torch.ones_like(proj.depth),
    ]
    return torch.stack(rows, dim=0)
