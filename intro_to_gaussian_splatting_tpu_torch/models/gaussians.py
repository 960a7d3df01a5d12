"""Gaussian primitive set as an ``nn.Module``.

Parameters (activations are applied in the projection pass):
  * ``means``          (N, 3)    world-space centres
  * ``log_scales``     (N, 3)    per-axis scale, stored in log space
  * ``quats``          (N, 4)    wxyz rotation, normalized on use
  * ``opacity_logits`` (N,)      sigmoid -> opacity
  * ``sh``             (N, K, 3) SH colour coefficients, K = (degree+1)^2
The buffer ``active`` (N,) bool marks live pool slots, and ``color_space``
is "rgb" (``sh[:, 0]`` holds linear RGB, the reference's behaviour) or "sh"
(the view-dependent 3DGS colour model).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
from intro_to_gaussian_splatting_tpu_torch.models.sh import rgb_to_sh

PARAM_NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")


class GaussianModel(nn.Module):
    def __init__(self, means: torch.Tensor, log_scales: torch.Tensor,
                 quats: torch.Tensor, opacity_logits: torch.Tensor,
                 sh: torch.Tensor, active: torch.Tensor,
                 color_space: str = "sh"):
        super().__init__()
        assert color_space in ("rgb", "sh")
        self.means = nn.Parameter(means)
        self.log_scales = nn.Parameter(log_scales)
        self.quats = nn.Parameter(quats)
        self.opacity_logits = nn.Parameter(opacity_logits)
        self.sh = nn.Parameter(sh)
        self.register_buffer("active", active)
        self.color_space = color_space

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1

    @property
    def device(self) -> torch.device:
        return self.means.device


def quats_to_rotmats(quats: torch.Tensor) -> torch.Tensor:
    """Batched wxyz quaternion -> (N, 3, 3) rotation; normalizes first."""
    q = quats / _norm(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, kept: sqrt of the plain sum of
    squares, as the JAX package computes it."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def covariance_3d(log_scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma = (R S)(R S)^T, (N, 3, 3)."""
    R = quats_to_rotmats(quats)
    S = torch.exp(log_scales)
    RS = R * S[..., None, :]
    return RS @ RS.transpose(-1, -2)


def covariance_3d_channels(log_scales: torch.Tensor, quats: torch.Tensor):
    """Sigma = (R S)(R S)^T as six (N,) channels (xx, xy, xz, yy, yz, zz),
    written out elementwise in the same order as the JAX package."""
    q = quats / _norm(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s2 = torch.exp(2.0 * log_scales)
    e0, e1, e2 = s2[..., 0], s2[..., 1], s2[..., 2]
    sxx = r00 * r00 * e0 + r01 * r01 * e1 + r02 * r02 * e2
    sxy = r00 * r10 * e0 + r01 * r11 * e1 + r02 * r12 * e2
    sxz = r00 * r20 * e0 + r01 * r21 * e1 + r02 * r22 * e2
    syy = r10 * r10 * e0 + r11 * r11 * e1 + r12 * r12 * e2
    syz = r10 * r20 * e0 + r11 * r21 * e1 + r12 * r22 * e2
    szz = r20 * r20 * e0 + r21 * r21 * e1 + r22 * r22 * e2
    return sxx, sxy, sxz, syy, syz, szz


def knn_mean_scale(points: torch.Tensor, k: int = 3,
                   chunk: int = 1024) -> torch.Tensor:
    """Mean distance to the k nearest neighbours, per point, on the points'
    device. Query chunks keep memory at O(N * chunk); distances use the
    |a|^2 + |b|^2 - 2ab form, as the JAX package does."""
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        q = points[lo:hi]
        d2 = sq[lo:hi, None] + sq[None, :] - 2.0 * (q @ points.T)
        rows = torch.arange(hi - lo, device=points.device)
        d2[rows, rows + lo] = float("inf")       # not its own neighbour
        near = torch.topk(d2, k, dim=1, largest=False).values
        out[lo:hi] = torch.mean(torch.sqrt(torch.clamp(near, min=0.0)), dim=1)
    return torch.clamp(out, min=1e-5)


def init_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    sh_degree: int = 0,
    color_space: str = "rgb",
    capacity: Optional[int] = None,
    opacity: float = 0.9999,
    scale_init: Optional[float] = 1e-3,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> GaussianModel:
    """Build a GaussianModel from a COLMAP point cloud.

    Defaults reproduce the reference init: colors/256, constant scale 1e-3,
    identity quats, opacity logit of 0.9999. ``scale_init=None`` takes the
    3-NN mean-distance scale, computed on ``device``.
    """
    device = resolve_device(device)
    n = points.shape[0]
    cap = capacity or n
    assert cap >= n
    k = (sh_degree + 1) ** 2

    means = np.zeros((cap, 3), dtype=np.float32)
    means[:n] = points
    sh = np.zeros((cap, k, 3), dtype=np.float32)
    base_rgb = np.asarray(colors, dtype=np.float32) / 256.0
    sh[:n, 0] = base_rgb if color_space == "rgb" else rgb_to_sh(base_rgb)

    log_scales = np.full((cap, 3), np.log(1e-3), dtype=np.float32)
    if scale_init is not None:
        log_scales[:n] = np.log(scale_init)
    else:
        pts = torch.as_tensor(np.asarray(points, dtype=np.float32),
                              device=device)
        d = knn_mean_scale(pts).cpu().numpy()
        log_scales[:n] = np.log(np.maximum(d, 1e-7))[:, None]

    quats = np.zeros((cap, 4), dtype=np.float32)
    quats[:, 0] = 1.0
    opacity_logits = np.full(
        (cap,), float(np.log(opacity / (1 - opacity))), dtype=np.float32)
    opacity_logits[n:] = -20.0
    active = np.zeros((cap,), dtype=bool)
    active[:n] = True

    def t(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    return GaussianModel(
        means=t(means), log_scales=t(log_scales), quats=t(quats),
        opacity_logits=t(opacity_logits), sh=t(sh),
        active=torch.as_tensor(active, device=device),
        color_space=color_space,
    )
