"""A scene of the shape a 3DGS run has halfway through its 30,000 steps,
made from the seed: anisotropic, rotated gaussians of varied opacity, with
view-dependent colour, on the built-in point cloud.

The cloud is the built-in one (80% normal about the origin with a
standard deviation of a quarter of the extent, 20% uniform in the
extent's cube). 3DGS starts each gaussian at the spacing of its cloud (the
root of its mean squared distance to its 3 nearest neighbours); that
search takes all N² pairs, so each scale here starts from the cloud's own
density at the point instead, in closed form: the spacing of ``rho``
points per unit volume is ``rho ** (-1/3)``. Per axis,

    log_scale = log(C * rho(x) ** (-1/3)) + normal(0, 0.5),

rotations are random unit quaternions (uniform over rotations), opacities
uniform in 0.05-0.95 and the SH coefficients above degree 0 normal(0,
0.1) whatever the traffic asks for, since a trained scene has them.
``C`` sets the pairs a view makes (``configs/treehill_3dgs_30k.json``,
``assumed``).
"""

from __future__ import annotations

import math

import torch

from gsbench import scene

# the spacing's multiple that gives 15-40M pairs a view at 1267x831
C = 0.5
LOG_SCALE_STD = 0.5
OPACITY_RANGE = (0.05, 0.95)
SH_REST_STD = 0.1


def density(xyz: torch.Tensor, n: int, extent: float) -> torch.Tensor:
    """Points per unit volume of the built-in cloud of ``n`` points at
    ``xyz``: its normal part and, inside the cube, its uniform part."""
    sigma = 0.25 * extent
    n_core = int(n * 0.8)
    r2 = torch.sum(xyz.double() ** 2, dim=1)
    normal = n_core * torch.exp(-0.5 * r2 / sigma ** 2) / (
        (2.0 * math.pi) ** 1.5 * sigma ** 3)
    inside = (xyz.abs() <= extent).all(dim=1)
    uniform = (n - n_core) / (2.0 * extent) ** 3 * inside
    return normal + uniform


def initial_params(cfg, xyz, rgb, capacity, gen, sh_rest_std):
    params, active = scene.pool(cfg, xyz, rgb, capacity, gen, SH_REST_STD)
    n, dev = xyz.shape[0], xyz.device
    rho = density(xyz, n, float(cfg["extent"]))
    base = (math.log(C) - torch.log(rho) / 3.0).float()
    params["log_scales"][:n] = base[:, None] + LOG_SCALE_STD * torch.randn(
        (n, 3), generator=gen, device=dev)
    q = torch.randn((n, 4), generator=gen, device=dev)
    params["quats"][:n] = q / torch.linalg.vector_norm(q, dim=1,
                                                       keepdim=True)
    lo, hi = OPACITY_RANGE
    op = lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)
    params["opacity_logits"][:n] = torch.log(op / (1.0 - op))
    return params, active
