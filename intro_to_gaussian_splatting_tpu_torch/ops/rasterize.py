"""Tiled rasterizer: project -> bin -> rasterize (B1) -> untile (B5).

``rasterize_pairs`` is an ``autograd.Function``. For tensors on the card
its forward launches kernel B1 (csrc/rasterize_fwd.cu) and its backward
kernel B2 (csrc/rasterize_bwd.cu); for tensors on the CPU they run the plain
versions, ``rasterize_pairs_reference`` and
``rasterize_pairs_backward_reference``.

Tile output is (NG, 5, GT, ts*ts) with channels [r, g, b, depth, alpha], in
the JAX package's layout; tile slots past the last real tile are zeros.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig
from intro_to_gaussian_splatting_tpu_torch.models.camera import Camera
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import GaussianModel
from intro_to_gaussian_splatting_tpu_torch.ops import projection as P
from intro_to_gaussian_splatting_tpu_torch.ops.binning import (
    bin_gaussians,
    num_groups_for,
    tile_grid,
)
from intro_to_gaussian_splatting_tpu_torch.ops.compositing import (
    skip_last_tile_mask,
)
from intro_to_gaussian_splatting_tpu_torch.ops.cuda_build import (
    CudaKernel,
    KernelSource,
)
from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
    project_gaussians,
)
from intro_to_gaussian_splatting_tpu_torch.ops.relayout import (
    untile_chw,
    untile_chw_fast,
)

OUT_CHANNELS = 5

# -fmad=false: the kernel rounds step by step as the plain version does
RASTERIZE_SOURCE = KernelSource("rasterize_fwd", ("-fmad=false",))
RASTERIZE_FWD = CudaKernel(RASTERIZE_SOURCE, "rasterize_fwd", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p,
])
RASTERIZE_BWD_SOURCE = KernelSource("rasterize_bwd", ("-fmad=false",))
RASTERIZE_BWD = CudaKernel(RASTERIZE_BWD_SOURCE, "rasterize_bwd", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
])


def _check_pairs(records, tile_starts, tile_counts, num_groups, config):
    if records.dim() != 2 or records.shape[0] != P.NUM_REC_ROWS:
        raise ValueError(f"records must be ({P.NUM_REC_ROWS}, MP), got "
                         f"{tuple(records.shape)}")
    nt = tile_starts.shape[0]
    if tile_counts.shape != (nt,) or nt > num_groups * config.group_tiles:
        raise ValueError("tile ranges do not fit the group layout")
    if config.tile_size ** 2 > 1024:
        raise ValueError("tile_size^2 must fit one CUDA block (<= 1024)")


def _alpha_terms(rec, px, py, config):
    """Per-(pair, pixel) alpha of ``rec`` (16, na) rows against the tile's
    local pixel coordinates: (dx, dy, weight, alpha_raw, a), each (na, pix),
    with the kernels' arithmetic in their order."""
    def col(row):
        return rec[row][:, None]

    dx = px - col(P.REC_MEAN_X)
    dy = py - col(P.REC_MEAN_Y)
    q = (col(P.REC_CONIC_A) * dx * dx
         + 2.0 * col(P.REC_CONIC_B) * dx * dy
         + col(P.REC_CONIC_C) * dy * dy)
    weight = torch.exp(-0.5 * q)
    alpha_raw = col(P.REC_OPACITY) * weight
    a = torch.clamp(alpha_raw, 0.0, config.alpha_clamp)
    if config.alpha_min > 0.0:
        a = torch.where(alpha_raw >= config.alpha_min, a, 0.0)
    if config.compat.pixel_bbox_test:
        inb = ((px >= col(P.REC_MIN_X)) & (px <= col(P.REC_MAX_X))
               & (py >= col(P.REC_MIN_Y)) & (py <= col(P.REC_MAX_Y)))
        a = torch.where(inb, a, 0.0)
    return dx, dy, weight, alpha_raw, a


def _depth_rank_schedule(tile_starts, tile_counts):
    """Tiles sorted by pair count, largest first, so that the tiles with a
    pair of depth rank k are a prefix: (order, starts in that order,
    max_count, active[k] = number of tiles with more than k pairs)."""
    counts_host = tile_counts.cpu().numpy().astype(np.int64)
    order_host = np.argsort(-counts_host, kind="stable")
    sorted_counts = counts_host[order_host]
    order = torch.as_tensor(order_host, device=tile_starts.device)
    starts = tile_starts.to(torch.int64)[order]
    max_count = int(sorted_counts[0]) if len(sorted_counts) else 0
    active = np.searchsorted(-sorted_counts, -np.arange(max_count),
                             side="left")
    return order, starts, max_count, active


def _tile_rows(tiles, order):
    """(NG, C, GT, pix) -> (C, NT, pix), tiles in ``order``."""
    ng, c, gt, pix = tiles.shape
    return tiles.permute(1, 0, 2, 3).reshape(c, ng * gt, pix)[:, order]


def rasterize_pairs_reference(records, tile_starts, tile_counts,
                              num_groups: int, config: RasterizerConfig,
                              count_evaluations: bool = False):
    """Plain PyTorch version of kernel B1.

    Steps over the within-tile depth rank k = 0 .. max_count - 1; each step
    takes pair k of every tile that has one (tiles sorted by count, so the
    active set is a prefix) and updates all their pixels at once, with the
    kernel's arithmetic in the kernel's order. With ``count_evaluations``
    also returns the number of (pair, pixel) evaluations the inputs need up
    to each pixel's exit, the work the kernel must do.
    """
    _check_pairs(records, tile_starts, tile_counts, num_groups, config)
    ts = config.tile_size
    pix = ts * ts
    gt = config.group_tiles
    dev = records.device
    nt = tile_starts.shape[0]
    lane = torch.arange(pix, device=dev)
    px = (lane % ts).to(torch.float32)[None, :]
    py = (lane // ts).to(torch.float32)[None, :]
    order, starts, max_count, active = _depth_rank_schedule(tile_starts,
                                                            tile_counts)

    T = torch.ones((nt, pix), device=dev)
    alive = torch.ones((nt, pix), dtype=torch.bool, device=dev)
    acc = torch.zeros((OUT_CHANNELS, nt, pix), device=dev)
    evaluations = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(max_count):
        na = int(active[k])
        rec = records[:, starts[:na] + k]                  # (16, na)
        _, _, _, _, a = _alpha_terms(rec, px, py, config)
        t_prev = T[:na]
        live = alive[:na]
        if count_evaluations:
            evaluations += live.sum()
        t_incl = t_prev * (1.0 - a)
        keep = live & (t_incl >= config.t_threshold)
        w = t_prev * a
        for c in range(OUT_CHANNELS):
            contrib = rec[P.PAYLOAD_START + c][:, None] * w
            acc[c, :na] = acc[c, :na] + torch.where(keep, contrib, 0.0)
        T[:na] = torch.where(keep, t_incl, t_prev)
        alive[:na] = keep

    out = torch.zeros((OUT_CHANNELS, num_groups * gt, pix), device=dev)
    out[:, order] = acc
    out = out.reshape(OUT_CHANNELS, num_groups, gt, pix).permute(1, 0, 2, 3)
    out = out.contiguous()
    if count_evaluations:
        return out, int(evaluations)
    return out


def rasterize_pairs_backward_reference(records, tile_starts, tile_counts,
                                       out, g_tile, num_groups: int,
                                       config: RasterizerConfig):
    """Plain PyTorch version of kernel B2: the gradient of
    ``rasterize_pairs`` with respect to the (16, MP) records, from the
    forward output ``out`` and its cotangent ``g_tile``, both
    (NG, 5, GT, ts*ts).

    Steps over the depth rank k as ``rasterize_pairs_reference`` does, with
    B2's per-pixel arithmetic in B2's order; each pair's terms are summed
    over its tile's pixels. Rows 6-10 and 15, pairs after their pixels'
    exits and the slots past the last tile are exactly 0.
    """
    _check_pairs(records, tile_starts, tile_counts, num_groups, config)
    ts = config.tile_size
    pix = ts * ts
    dev = records.device
    nt = tile_starts.shape[0]
    lane = torch.arange(pix, device=dev)
    px = (lane % ts).to(torch.float32)[None, :]
    py = (lane // ts).to(torch.float32)[None, :]
    order, starts, max_count, active = _depth_rank_schedule(tile_starts,
                                                            tile_counts)
    gch = _tile_rows(g_tile, order)                       # (5, NT, pix)
    u_all = torch.zeros((nt, pix), device=dev)
    for c, oc in enumerate(_tile_rows(out, order)):
        u_all = u_all + gch[c] * oc

    T = torch.ones((nt, pix), device=dev)
    alive = torch.ones((nt, pix), dtype=torch.bool, device=dev)
    prefix = torch.zeros((nt, pix), device=dev)
    drec = torch.zeros_like(records)
    for k in range(max_count):
        na = int(active[k])
        cols = starts[:na] + k
        rec = records[:, cols]                             # (16, na)

        def col(row):
            return rec[row][:, None]

        dx, dy, weight, alpha_raw, a = _alpha_terms(rec, px, py, config)
        t_prev = T[:na]
        g = gch[:, :na]
        one_minus = 1.0 - a
        t_incl = t_prev * one_minus
        keep = alive[:na] & (t_incl >= config.t_threshold)
        w = t_prev * a
        gc = torch.zeros_like(w)
        for c in range(OUT_CHANNELS):
            gc = gc + col(P.PAYLOAD_START + c) * g[c]
        prefix[:na] = prefix[:na] + torch.where(keep, gc * w, 0.0)
        suffix = u_all[:na] - prefix[:na]
        da = gc * t_prev - suffix / one_minus
        passthrough = ((a > 0.0) & (alpha_raw < config.alpha_clamp)).to(
            torch.float32)
        dalpha = da * passthrough
        op = col(P.REC_OPACITY)
        ca, cb, cc = (col(P.REC_CONIC_A), col(P.REC_CONIC_B),
                      col(P.REC_CONIC_C))
        dq = dalpha * op * weight * (-0.5)
        terms = (
            dq * (-(2.0 * ca * dx + 2.0 * cb * dy)),
            dq * (-(2.0 * cc * dy + 2.0 * cb * dx)),
            dq * dx * dx,
            dq * 2.0 * dx * dy,
            dq * dy * dy,
            dalpha * weight,
        ) + tuple(w * g[c] for c in range(4))
        for row, term in zip(P.GRAD_ROWS, terms):
            drec[row, cols] = torch.where(keep, term, 0.0).sum(dim=1)
        T[:na] = torch.where(keep, t_incl, t_prev)
        alive[:na] = keep
    return drec


def _check_cuda_inputs(records, tile_starts, tile_counts):
    dev = records.device
    for name, t, dtype in (("records", records, torch.float32),
                           ("tile_starts", tile_starts, torch.int32),
                           ("tile_counts", tile_counts, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{dev}")
    if tile_starts.numel():
        # the kernels read records[:, start:start + count] unchecked
        lo, hi = torch.stack([
            torch.minimum(tile_starts, tile_counts).min().long(),
            (tile_starts.long() + tile_counts).max()]).tolist()
        if lo < 0 or hi > records.shape[1]:
            raise ValueError("tile ranges fall outside the record stream")


def _rasterize_bwd_cuda(records, tile_starts, tile_counts, out, g_tile,
                        num_groups, config):
    _check_pairs(records, tile_starts, tile_counts, num_groups, config)
    _check_cuda_inputs(records, tile_starts, tile_counts)
    ts = config.tile_size
    shape = (num_groups, OUT_CHANNELS, config.group_tiles, ts * ts)
    for name, t in (("out", out), ("g_tile", g_tile)):
        if (t.shape != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != records.device):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {records.device}")
    drec = torch.empty_like(records)
    dev = records.device
    RASTERIZE_BWD.launch(
        records.data_ptr(), records.shape[1], tile_starts.data_ptr(),
        tile_counts.data_ptr(), tile_starts.shape[0], config.group_tiles, ts,
        config.alpha_clamp, config.alpha_min, config.t_threshold,
        int(config.compat.pixel_bbox_test), out.data_ptr(), g_tile.data_ptr(),
        drec.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    return drec


def _rasterize_fwd_cuda(records, tile_starts, tile_counts, num_groups,
                        config):
    _check_pairs(records, tile_starts, tile_counts, num_groups, config)
    _check_cuda_inputs(records, tile_starts, tile_counts)
    dev = records.device
    ts = config.tile_size
    gt = config.group_tiles
    out = torch.empty((num_groups, OUT_CHANNELS, gt, ts * ts),
                      dtype=torch.float32, device=dev)
    RASTERIZE_FWD.launch(
        records.data_ptr(), records.shape[1], tile_starts.data_ptr(),
        tile_counts.data_ptr(), tile_starts.shape[0], num_groups * gt, gt, ts,
        config.alpha_clamp, config.alpha_min, config.t_threshold,
        int(config.compat.pixel_bbox_test), out.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


class _RasterizePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, records, tile_starts, tile_counts, num_groups, config):
        if records.is_cuda:
            out = _rasterize_fwd_cuda(records, tile_starts, tile_counts,
                                      num_groups, config)
        else:
            out = rasterize_pairs_reference(records, tile_starts,
                                            tile_counts, num_groups, config)
        ctx.save_for_backward(records, tile_starts, tile_counts, out)
        ctx.num_groups = num_groups
        ctx.config = config
        return out

    @staticmethod
    def backward(ctx, g_tile):
        records, tile_starts, tile_counts, out = ctx.saved_tensors
        args = (records, tile_starts, tile_counts, out, g_tile.contiguous(),
                ctx.num_groups, ctx.config)
        if records.is_cuda:
            drec = _rasterize_bwd_cuda(*args)
        else:
            drec = rasterize_pairs_backward_reference(*args)
        return drec, None, None, None, None


def rasterize_pairs(records: torch.Tensor, tile_starts: torch.Tensor,
                    tile_counts: torch.Tensor, num_groups: int,
                    config: RasterizerConfig) -> torch.Tensor:
    """records (16, MP) -> (num_groups, 5, GT, ts*ts).

    ``tile_starts`` / ``tile_counts`` (NT,) int32 are each tile's range of
    the (tile, depth)-sorted stream, as ``bin_gaussians`` returns them.
    """
    return _RasterizePairs.apply(records, tile_starts, tile_counts,
                                 num_groups, config)


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def untile(tile_out: torch.Tensor, ntx: int, nty: int, ts: int, height: int,
           width: int) -> torch.Tensor:
    """(NG, C, GT, ts*ts) channel-major tile groups -> (H, W, C)."""
    ng, c, gt, pix = tile_out.shape
    flat = tile_out.permute(0, 2, 1, 3).reshape(ng * gt, c, pix)
    img = flat[:ntx * nty].reshape(nty, ntx, c, ts, ts)
    img = img.permute(0, 3, 1, 4, 2).reshape(nty * ts, ntx * ts, c)
    return img[:height, :width]


def image_to_tiles(img: torch.Tensor, config: RasterizerConfig) -> torch.Tensor:
    """(H, W, C) -> (NG, C, GT, ts*ts), the rasterizer's layout; the inverse
    of ``untile`` up to zero padding."""
    h, w, c = img.shape
    ts = config.tile_size
    gt = config.group_tiles
    ntx, nty = tile_grid(w, h, ts)
    ng = num_groups_for(ntx * nty, config)
    pad = torch.nn.functional.pad(img, (0, 0, 0, ntx * ts - w, 0, nty * ts - h))
    tiles = pad.reshape(nty, ts, ntx, ts, c).permute(0, 2, 4, 1, 3)
    tiles = tiles.reshape(nty * ntx, c, ts * ts)
    tiles = torch.nn.functional.pad(tiles, (0, 0, 0, 0, 0, ng * gt - nty * ntx))
    return tiles.reshape(ng, gt, c, ts * ts).permute(0, 2, 1, 3).contiguous()


def tile_pixel_mask(height: int, width: int, config: RasterizerConfig,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """(NG, 1, GT, ts*ts) 0/1 mask of pixels inside the true image bounds."""
    ones = torch.ones((height, width, 1), device=device)
    return image_to_tiles(ones, config)


# ---------------------------------------------------------------------------
# High-level tiled renderer
# ---------------------------------------------------------------------------

def render_tiles(
    model: GaussianModel,
    camera: Camera,
    config: RasterizerConfig = RasterizerConfig(),
    active_sh_degree: Optional[int] = None,
    return_aux: bool = False,
    mean2d_offset: Optional[torch.Tensor] = None,
):
    """Render in the rasterizer's tile layout, (NG, 5, GT, ts*ts)."""
    h, w = camera.height, camera.width
    ntx, nty = tile_grid(w, h, config.tile_size)
    num_groups = num_groups_for(ntx * nty, config)
    proj = project_gaussians(model, camera, config, active_sh_degree,
                             mean2d_offset)
    bins = bin_gaussians(proj, w, h, config)
    tiles = rasterize_pairs(bins.pair_records, bins.tile_starts,
                            bins.tile_counts, num_groups, config)
    if return_aux:
        return tiles, dict(overflowed=bins.overflowed,
                           num_pairs=bins.num_pairs,
                           visible=proj.valid.detach())
    return tiles


def render_tiled(
    model: GaussianModel,
    camera: Camera,
    config: RasterizerConfig = RasterizerConfig(),
    active_sh_degree: Optional[int] = None,
    return_aux: bool = False,
    mean2d_offset: Optional[torch.Tensor] = None,
):
    """Full pipeline: project -> bin -> rasterize -> (H, W, 3).

    The colour channels go through ``untile_chw_fast`` (kernel B5-untile on
    the card) and one permute to (H, W, 3), as the JAX package's hot path
    does; ``return_aux`` untiles depth and alpha with the plain ``untile``.
    """
    h, w = camera.height, camera.width
    ts = config.tile_size
    ntx, nty = tile_grid(w, h, ts)
    num_groups = num_groups_for(ntx * nty, config)

    proj = project_gaussians(model, camera, config, active_sh_degree,
                             mean2d_offset)
    bins = bin_gaussians(proj, w, h, config)
    tile_out = rasterize_pairs(bins.pair_records, bins.tile_starts,
                               bins.tile_counts, num_groups, config)
    image = untile_chw_fast(tile_out, ntx, nty, ts, h, w).permute(1, 2, 0)
    if config.compat.skip_last_tile:
        image = image * skip_last_tile_mask(h, w, ts, image.device)[..., None]
    if return_aux:
        depth_alpha = untile(tile_out[:, 3:5], ntx, nty, ts, h, w)
        alpha = depth_alpha[..., 1]
        return image, dict(
            depth=depth_alpha[..., 0],
            alpha=alpha,
            # the accumulated-weight complement 1 - alpha, NOT the exact
            # exit transmittance: it differs from prod(1 - alpha_i) by at
            # most the excluded tail, t_threshold / (1 - alpha_clamp)
            transmittance=(1.0 - alpha).detach(),
            overflowed=bins.overflowed,
            num_pairs=bins.num_pairs,
            visible=proj.valid.detach(),
        )
    return image


__all__ = [
    "OUT_CHANNELS", "rasterize_pairs", "rasterize_pairs_reference",
    "rasterize_pairs_backward_reference",
    "render_tiles", "render_tiled", "untile", "untile_chw", "image_to_tiles",
    "tile_pixel_mask",
]
