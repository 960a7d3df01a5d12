"""Dense oracle renderer: every pixel against every gaussian, no binning.

O(pixels * N), in plain torch on any device. It is the port's in-package
reference and its ``"dense"`` backend. Compositing runs over depth-ordered
chunks of gaussians in log space, as in the JAX package:

    alpha[p, i]   = clamp(opacity_i * exp(-0.5 d^T Sigma^-1 d), 0, alpha_clamp)
    s             = max(log1p(-alpha), -30)
    T[p, i]       = T_carry[p] * exp(exclusive prefix sum of s)
    include[p, i] = T[p, i] * (1 - alpha[p, i]) >= t_threshold
    accum        += (T * alpha * include) @ payload^T

``include`` is the reference's early exit: with alpha <= alpha_clamp < 1, T
is monotone, so the first gaussian that would push T under the threshold
ends the pixel for good. ``exact_break=True`` is the reference Python
renderer's break instead: tested on the unclamped alpha, and permanent
even where the unclamped alpha breaks monotonicity.
"""

from __future__ import annotations

from typing import Optional

import torch

from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig
from intro_to_gaussian_splatting_tpu_torch.models.camera import Camera
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import GaussianModel
from intro_to_gaussian_splatting_tpu_torch.ops import projection as P
from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
    pack_records,
    project_gaussians,
)

# Floor on log1p(-alpha): e^-30 ~ 1e-13 is far below every T threshold.
_LOG_FLOOR = -30.0


def prefix_sum_incl(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis by log-step shift-adds
    (the JAX package's summation order)."""
    g = x.shape[-1]
    k = 1
    while k < g:
        shifted = torch.nn.functional.pad(x[..., :-k], (k, 0))
        x = x + shifted
        k *= 2
    return x


def _row(rec: torch.Tensor, i: int) -> torch.Tensor:
    return rec[i:i + 1, :]


def gaussian_alpha(px, py, rec):
    """Raw (unclamped) alpha, (P, G), of records ``rec`` (16, G) at pixels
    ``px``, ``py`` (P, 1)."""
    dx = px - _row(rec, P.REC_MEAN_X)
    dy = py - _row(rec, P.REC_MEAN_Y)
    power = (_row(rec, P.REC_CONIC_A) * dx * dx
             + 2.0 * _row(rec, P.REC_CONIC_B) * dx * dy
             + _row(rec, P.REC_CONIC_C) * dy * dy)
    return _row(rec, P.REC_OPACITY) * torch.exp(-0.5 * power)


def effective_alpha(alpha_raw, px, py, rec, gmask, config: RasterizerConfig):
    """Clamp and mask the raw alpha; ``gmask`` is a (1, G) or (P, G) bool."""
    a = torch.clamp(alpha_raw, 0.0, config.alpha_clamp)
    if config.alpha_min > 0.0:
        a = torch.where(alpha_raw >= config.alpha_min, a, 0.0)
    if config.compat.pixel_bbox_test:
        inb = ((px >= _row(rec, P.REC_MIN_X)) & (px <= _row(rec, P.REC_MAX_X))
               & (py >= _row(rec, P.REC_MIN_Y))
               & (py <= _row(rec, P.REC_MAX_Y)))
        a = torch.where(inb, a, 0.0)
    return a * gmask.to(a.dtype)


def tile_overlap_mask(px, py, rec, config: RasterizerConfig):
    """(P, G): does the gaussian's bbox overlap the pixel's tile? Emulates
    the binning of the tiled backends."""
    ts = config.tile_size
    tx0 = torch.div(px, ts, rounding_mode="floor") * ts
    ty0 = torch.div(py, ts, rounding_mode="floor") * ts
    hi = float(ts) if config.compat.inclusive_tile_overlap else float(ts - 1)
    x_ov = ((_row(rec, P.REC_MIN_X) <= tx0 + hi)
            & (_row(rec, P.REC_MAX_X) >= tx0))
    y_ov = ((_row(rec, P.REC_MIN_Y) <= ty0 + hi)
            & (_row(rec, P.REC_MAX_Y) >= ty0))
    return x_ov & y_ov


def sorted_records(proj: P.ProjectedGaussians):
    """(records, order): the (16, N) record matrix depth-sorted front to
    back, invalid slots last, and the sort's permutation (ref: a global
    ascending argsort on camera z, gaussian_scene.py:117-129)."""
    key = torch.where(proj.valid, proj.depth, float("inf"))
    order = torch.argsort(key, stable=True)
    return pack_records(proj)[:, order], order


def render_dense(
    model: GaussianModel,
    camera: Camera,
    config: RasterizerConfig = RasterizerConfig(),
    tile_culling: bool = True,
    exact_break: bool = False,
    chunk: int = 256,
    active_sh_degree: Optional[int] = None,
    return_aux: bool = False,
):
    """Render (height, width, 3) by compositing all gaussians per pixel,
    ``chunk`` gaussians at a time (memory is O(pixels * chunk)). With
    ``tile_culling`` each pixel sees only the gaussians whose bbox overlaps
    its tile (the binning of the tiled backends); without, every valid
    gaussian. ``exact_break`` takes the reference Python renderer's
    permanent break on the unclamped alpha (module docstring).

    With ``return_aux=True`` also returns alpha, depth and the EXACT final
    transmittance prod(1 - alpha_i) over all gaussians.
    """
    proj = project_gaussians(model, camera, config, active_sh_degree)
    rec, order = sorted_records(proj)
    gvalid = proj.valid[order]
    h, w = camera.height, camera.width
    dev = rec.device
    ys = torch.arange(h, device=dev)[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, device=dev)[None, :].expand(h, w).reshape(-1)
    px = xs.to(torch.float32)[:, None]
    py = ys.to(torch.float32)[:, None]

    T = torch.ones((h * w, 1), device=dev)
    alive = torch.ones((h * w, 1), device=dev)
    accum = torch.zeros((h * w, P.NUM_PAYLOAD), device=dev)
    for lo in range(0, rec.shape[1], chunk):
        rec_c = rec[:, lo:lo + chunk]
        gmask = gvalid[None, lo:lo + chunk]
        if tile_culling:
            gmask = gmask & tile_overlap_mask(px, py, rec_c, config)
        alpha_raw = gaussian_alpha(px, py, rec_c)
        a = effective_alpha(alpha_raw, px, py, rec_c, gmask, config)
        s = torch.clamp(torch.log1p(-a), min=_LOG_FLOOR)
        s_incl = prefix_sum_incl(s)
        t = T * torch.exp(s_incl - s)
        if exact_break:
            masked_raw = torch.where(a > 0.0, alpha_raw, 0.0)
            bad = (t * (1.0 - masked_raw) < config.t_threshold).to(
                torch.float32)
            done = (prefix_sum_incl(bad) > 0.0).to(torch.float32)
            include = alive * (1.0 - done)
            alive = alive * (1.0 - done[:, -1:])
        else:
            include = (t * (1.0 - a) >= config.t_threshold).to(torch.float32)
        wgt = t * a * include
        accum = accum + wgt @ rec_c[P.PAYLOAD_START:, :].T
        T = T * torch.exp(s_incl[:, -1:])

    image = accum[:, :3].reshape(h, w, 3)
    if config.compat.skip_last_tile:
        image = image * skip_last_tile_mask(h, w, config.tile_size,
                                            dev)[..., None]
    if return_aux:
        return image, dict(
            depth=accum[:, 3].reshape(h, w),
            alpha=accum[:, 4].reshape(h, w),
            transmittance=T[:, 0].reshape(h, w),
        )
    return image


def skip_last_tile_mask(h: int, w: int, ts: int,
                        device: torch.device) -> torch.Tensor:
    """(H, W) f32 mask blanking what the reference's CPU path never renders:
    x in [0, width - tile_size) and y likewise, rounded up to whole tiles."""
    lim_x = ((w - ts - 1) // ts + 1) * ts if w > ts else 0
    lim_y = ((h - ts - 1) // ts + 1) * ts if h > ts else 0
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return ((xs < lim_x) & (ys < lim_y)).to(torch.float32)
