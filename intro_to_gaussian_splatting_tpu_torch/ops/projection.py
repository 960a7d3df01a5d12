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

``project_gaussians`` runs the plain version, ``project_gaussians_reference``,
for tensors on the CPU. For tensors on the card it is an
``autograd.Function`` whose forward launches kernel J1 and whose backward
launches kernel J2 (csrc/projection.cu): one launch each way in place of
the plain version's few hundred small ones. It raises on what the kernels
do not take. The offset of ``mean2d_offset`` is added after J1, so its
gradient reaches the probe as on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig
from intro_to_gaussian_splatting_tpu_torch.models.camera import (
    CAMERA_TENSORS,
    Camera,
)
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianModel,
    covariance_3d_channels,
)
from intro_to_gaussian_splatting_tpu_torch.models.sh import eval_sh
from intro_to_gaussian_splatting_tpu_torch.ops.cuda_build import (
    CudaKernel,
    KernelSource,
)

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


def project_gaussians_reference(
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


# kernels J1 and J2; -fmad=false: J1 rounds step by step as the plain
# version's chain of library kernels does
PROJECTION_SOURCE = KernelSource("projection", ("-fmad=false",))
# both entries' camera pointers, rasterizer scalars, image size, colour and
# sigmoid flag
_SHARED_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_float] * 6 + [
    ctypes.c_int] * 4
PROJECT_FWD = CudaKernel(PROJECTION_SOURCE, "project_fwd", [
    *[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int, *_SHARED_ARGS,
    *[ctypes.c_void_p] * 7, ctypes.c_int, ctypes.c_void_p,
])
PROJECT_BWD = CudaKernel(PROJECTION_SOURCE, "project_bwd", [
    *[ctypes.c_void_p] * 5, ctypes.c_int, ctypes.c_int, *_SHARED_ARGS,
    *[ctypes.c_void_p] * 10, ctypes.c_int, ctypes.c_void_p,
])
RGB_DEGREE = -1   # the kernels' colour argument for raw RGB


def _inputs(model: GaussianModel, camera: Camera) -> dict:
    return {**{n: getattr(model, n) for n in PARAM_NAMES},
            "active": model.active,
            **{f"camera.{n}": getattr(camera, n) for n in CAMERA_TENSORS}}


def _check_devices(model, camera, mean2d_offset) -> None:
    dev = model.means.device
    inputs = _inputs(model, camera)
    if mean2d_offset is not None:
        inputs["mean2d_offset"] = mean2d_offset
    mixed = {n: str(t.device) for n, t in inputs.items() if t.device != dev}
    if mixed:
        raise ValueError(f"project_gaussians takes every input on the means' "
                         f"device ({dev}); on others: {mixed}")


def _kernel_degree(model: GaussianModel, active_sh_degree) -> int:
    """The kernels' colour argument: raw RGB, or the SH degree that
    ``eval_sh`` evaluates (0 to 3)."""
    if model.color_space == "rgb":
        return RGB_DEGREE
    deg = model.sh_degree if active_sh_degree is None else active_sh_degree
    deg = min(max(int(deg), 0), 3)
    if (deg + 1) ** 2 > model.sh.shape[1]:
        raise ValueError(f"SH degree {deg} needs {(deg + 1) ** 2} "
                         f"coefficients, the model has {model.sh.shape[1]}")
    return deg


def check_card_inputs(model: GaussianModel, camera: Camera,
                      mean2d_offset: torch.Tensor | None = None) -> None:
    """Raise ValueError on what J1 and J2 do not take: any input on another
    device than the means, a parameter or camera tensor of another dtype
    than float32, a camera tensor that requires grad, shapes other than
    the model's and the camera's, or tensors that are not on a card."""
    _check_devices(model, camera, mean2d_offset)
    inputs = _inputs(model, camera)
    wrong = {n: str(t.dtype) for n, t in inputs.items()
             if t.dtype != (torch.bool if n == "active" else torch.float32)}
    if wrong:
        raise ValueError(f"J1/J2 take float32 parameters and camera tensors "
                         f"and a bool active mask, got {wrong}")
    grad = [n for n, t in inputs.items()
            if n.startswith("camera.") and t.requires_grad]
    if grad:
        raise ValueError(f"J1/J2 give no gradient to the camera, and {grad} "
                         f"requires one")
    n = model.means.shape[0]
    shapes = dict(means=(n, 3), log_scales=(n, 3), quats=(n, 4),
                  opacity_logits=(n,), active=(n,))
    shapes["camera.world2view"] = shapes["camera.full_proj"] = (4, 4)
    sizes = {f"camera.{k}": 1 for k in ("fx", "fy", "tan_fovx", "tan_fovy")}
    sizes["camera.cam_center"] = 3
    bad = [k for k, s in shapes.items() if tuple(inputs[k].shape) != s]
    bad += [k for k, s in sizes.items() if inputs[k].numel() != s]
    if model.sh.dim() != 3 or model.sh.shape[0] != n or model.sh.shape[2] != 3:
        bad.append("sh")
    if bad:
        raise ValueError(f"J1/J2 take a model of (N, ...) parameters and a "
                         f"single camera; wrong shapes: {bad}")
    if model.means.device.type != "cuda":
        raise ValueError(f"J1/J2 take tensors on a card, got "
                         f"{model.means.device}")


def _launch_args(params, camera, config, degree):
    """J1's and J2's leading arguments (the parameters, the camera, the
    rasterizer's scalars, the image size, the colour and the sigmoid) and
    the camera tensors they point into, which the caller holds until it
    has launched."""
    means, _, _, _, sh = params
    cam = [getattr(camera, n).contiguous() for n in CAMERA_TENSORS]
    return ([t.data_ptr() for t in params], means.shape[0], sh.shape[1],
            [t.data_ptr() for t in cam] + [
                config.frustum_min_z, config.ewa_clamp, config.det_clamp,
                config.eig_floor, config.radius_sigmas,
                config.cov2d_dilation, camera.width, camera.height, degree,
                int(config.compat.double_sigmoid)], cam)


def _project_fwd_cuda(params, active, camera, config, degree):
    """J1: the (mean2d, depth, conic, radius, color, opacity, valid) of
    ``project_gaussians_reference``."""
    ptrs, n, k, scalars, cam = _launch_args(params, camera, config, degree)
    dev = params[0].device
    out = [torch.empty(shape, dtype=torch.float32, device=dev)
           for shape in ((n, 2), (n,), (n, 3), (n,), (n, 3), (n,))]
    out.append(torch.empty((n,), dtype=torch.bool, device=dev))
    PROJECT_FWD.launch(*ptrs, active.data_ptr(), n, k, *scalars,
                       *[t.data_ptr() for t in out], dev.index or 0,
                       torch.cuda.current_stream(dev).cuda_stream)
    return tuple(out)


def _project_bwd_cuda(params, camera, config, degree, cotangents):
    """J2: the gradients of the five parameters from the cotangents of
    mean2d, depth, conic, color and opacity (None reads as zeros)."""
    ptrs, n, k, scalars, cam = _launch_args(params, camera, config, degree)
    dev = params[0].device
    cot = [None if g is None else g.contiguous() for g in cotangents]
    grads = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for t in params]
    PROJECT_BWD.launch(*ptrs, n, k, *scalars,
                       *[0 if g is None else g.data_ptr() for g in cot],
                       *[t.data_ptr() for t in grads], dev.index or 0,
                       torch.cuda.current_stream(dev).cuda_stream)
    return grads


class _ProjectGaussians(torch.autograd.Function):
    """The five parameters -> J1's seven outputs; the backward is J2, from
    the saved parameters alone."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, opacity_logits, sh, active,
                camera, config, degree):
        params = (means, log_scales, quats, opacity_logits, sh)
        out = _project_fwd_cuda(params, active, camera, config, degree)
        ctx.save_for_backward(*params)
        ctx.camera, ctx.config, ctx.degree = camera, config, degree
        ctx.mark_non_differentiable(out[3], out[6])   # radius, valid
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_mean2d, g_depth, g_conic, _radius, g_color,
                 g_opacity, _valid):
        grads = _project_bwd_cuda(ctx.saved_tensors, ctx.camera, ctx.config,
                                  ctx.degree, (g_mean2d, g_depth, g_conic,
                                               g_color, g_opacity))
        return (*grads, None, None, None, None)


def project_gaussians(
    model: GaussianModel,
    camera: Camera,
    config: RasterizerConfig = RasterizerConfig(),
    active_sh_degree: int | None = None,
    mean2d_offset: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """``project_gaussians_reference``'s function: the plain version for a
    model on the CPU, kernels J1 and J2 for one on the card (one launch
    forward and, under autograd, one backward; nothing saved under
    ``torch.no_grad()``)."""
    if model.means.device.type != "cuda":
        _check_devices(model, camera, mean2d_offset)
        return project_gaussians_reference(model, camera, config,
                                           active_sh_degree, mean2d_offset)
    check_card_inputs(model, camera, mean2d_offset)
    degree = _kernel_degree(model, active_sh_degree)
    params = [getattr(model, n).contiguous() for n in PARAM_NAMES]
    active = model.active.contiguous()
    # under torch.no_grad(), or with no parameter that requires grad,
    # apply builds no node and saves nothing
    out = _ProjectGaussians.apply(*params, active, camera, config, degree)
    mean2d, depth, conic, radius, color, opacity, valid = out
    if mean2d_offset is not None:
        # zero-valued probe: its gradient is the screen-space positional
        # gradient that densification reads
        mean2d = mean2d + mean2d_offset
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
