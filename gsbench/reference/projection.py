"""3D gaussians -> screen-space splats, in plain PyTorch (autograd-able).

The 3DGS projection (Kerbl et al. 2023, section 4 and its EWA splatting):
camera-space position by the view matrix, pixel position by the full
projection, 2D covariance J W Sigma W^T J^T with the camera-space x, y
clamped to 1.3 times the half field of view, its inverse (the conic) with
the determinant clamped from below, a radius of 3 sigmas of the larger
eigenvalue rounded up, view-dependent colour from spherical harmonics
(offset by 0.5, clamped at 0) and the opacity's sigmoid. A gaussian is
valid when it lies past the near plane, is active and has a radius.

``precision="tf32"`` rounds every matrix product's inputs to TF32.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 explicit mantissa bits, to
    nearest. The gradient passes through the rounding unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


def rotations(quats: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions (N, 4) -> (N, 3, 3) rotations, normalised first."""
    q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def sh_colour(sh: torch.Tensor, dirs: torch.Tensor, degree: int):
    """Real SH (the 3DGS basis, degrees 0-3) of ``sh`` (N, K, 3) along
    unit ``dirs`` (N, 3): (N, 3), + 0.5 and clamped at 0."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                  SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                  SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4 * zz - xx - yy),
                  SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    b = torch.cat(basis, dim=1)                              # (N, k)
    rgb = torch.sum(b[:, :, None] * sh[:, :b.shape[1], :], dim=1)
    return torch.clamp(rgb + 0.5, min=0.0)


def project(params: dict, active: torch.Tensor, cam, rast: dict,
            sh_degree: int, precision: str = "float32") -> dict:
    """Screen-space splats of every slot: mean2d (N, 2) pixels, depth,
    conic (N, 3) = [a, b, c] of the inverse 2D covariance, radius
    (pixels; ``radius_raw`` before rounding up), colour (N, 3), opacity
    and valid."""
    means = params["means"]
    n = means.shape[0]
    hom = torch.cat([means, torch.ones((n, 1), dtype=means.dtype,
                                       device=means.device)], dim=1)
    view = matmul(hom, cam.world2view, precision)
    clip = matmul(hom, cam.full_proj, precision)
    xv, yv, depth = view[:, 0], view[:, 1], view[:, 2]
    w = clip[:, 3]
    w = torch.where(torch.abs(w) < 1e-8, 1e-8, w)
    mean2d = torch.stack([(clip[:, 0] / w + 1.0) * (cam.width - 1) * 0.5,
                          (clip[:, 1] / w + 1.0) * (cam.height - 1) * 0.5],
                         dim=1)

    rot = rotations(params["quats"])
    rs = rot * torch.exp(params["log_scales"])[:, None, :]
    sigma = matmul(rs, rs.transpose(1, 2), precision)        # (N, 3, 3)

    z = torch.where(torch.abs(depth) < 1e-8, 1e-8, depth)
    limx = rast["ewa_clamp"] * cam.tan_fovx
    limy = rast["ewa_clamp"] * cam.tan_fovy
    tx = torch.clamp(xv / z, -limx, limx) * depth
    ty = torch.clamp(yv / z, -limy, limy) * depth
    zero = torch.zeros_like(z)
    jac = torch.stack([
        torch.stack([cam.fx / z, zero, -cam.fx * tx / (z * z)], -1),
        torch.stack([zero, cam.fy / z, -cam.fy * ty / (z * z)], -1),
    ], dim=1)                                               # (N, 2, 3)
    # W: the camera-space rotation, world2view[:3, :3] transposed back
    rot_w = cam.world2view[:3, :3].T.expand(n, 3, 3)
    m = matmul(jac, rot_w, precision)                        # (N, 2, 3)
    cov = matmul(matmul(m, sigma, precision), m.transpose(1, 2), precision)
    a = cov[:, 0, 0] + rast["cov2d_dilation"]
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + rast["cov2d_dilation"]
    det = a * c - b * b
    conic = (torch.stack([c, -b, a], dim=1)
             / torch.clamp(det, min=rast["det_clamp"])[:, None])
    mid = 0.5 * (a + c)
    disc = torch.clamp(mid * mid - det, min=rast["eig_floor"])
    lam = mid + torch.sqrt(disc)
    radius_raw = rast["radius_sigmas"] * torch.sqrt(torch.clamp(lam, min=0.0))
    radius = torch.ceil(radius_raw)

    dirs = means - cam.cam_center
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(
        dirs, dim=1, keepdim=True), min=1e-8)
    colour = sh_colour(params["sh"], dirs, sh_degree)
    opacity = torch.sigmoid(params["opacity_logits"])
    valid = (depth >= rast["frustum_min_z"]) & active & (radius > 0)
    return dict(mean2d=mean2d, depth=depth, conic=conic,
                radius=torch.where(valid, radius, 0.0).detach(),
                radius_raw=radius_raw.detach(), mid=mid.detach(),
                disc=disc.detach(),
                colour=colour, opacity=opacity, valid=valid.detach())
