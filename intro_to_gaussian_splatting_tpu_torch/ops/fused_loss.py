"""Fused tile-space photometric loss: L1 + SSIM value and pixel gradient.

``fused_photometric_loss`` is an ``autograd.Function``. Its forward
computes the 3DGS objective (1-w)*L1 + w*(1-SSIM) of the rasterizer's tile
output against a (3, H, W) target, the mean squared error (a metrics tap
for PSNR) and the gradient of the loss with respect to the tiles, in the
tiles' own layout; its backward returns that gradient scaled by the loss
cotangent and drops the MSE's, as the JAX package's custom VJP does
(fused_loss_pallas.py:253-294). For tiles on the card the forward is
kernel B3 (csrc/fused_loss.cu); for tiles on the CPU it is the plain
version, ``fused_photometric_loss_reference``: the split path the JAX
package holds its kernel against (tile L1, untile, plain SSIM under
autograd, tile MSE).

Layouts: the prediction is the rasterizer's (NG, C, GT, 16*16) group
layout, read in place (its first 3 channels; C may be 3 or the full 5);
the target is a plain channel-major (3, H, W) image. The JAX package's
flattened, row-padded layouts were TPU DMA constraints. The gradient has
the prediction's shape and is exactly 0 outside the image, in the phantom
tiles of the group padding and in channels >= 3.
"""

from __future__ import annotations

import ctypes

import torch

from intro_to_gaussian_splatting_tpu_torch.ops.cuda_build import (
    CudaKernel,
    KernelSource,
)
from intro_to_gaussian_splatting_tpu_torch.ops.relayout import (
    tile_chw,
    untile_chw,
)
from intro_to_gaussian_splatting_tpu_torch.train import loss as L

TILE_SIZE = 16

FUSED_LOSS_SOURCE = KernelSource("fused_loss", ("-fmad=false",))


class _Taps(ctypes.Structure):
    """The 11 window taps, passed to the kernel by value."""
    _fields_ = [("k", ctypes.c_float * L.WINDOW)]


FUSED_LOSS = CudaKernel(FUSED_LOSS_SOURCE, "fused_loss", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    _Taps, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
])
# the kernel's output regions: 2 x 4 tiles per block, 3 partial sums each
_REGION_TILES = (2, 4)


def _check(tiles, target, ntx, nty, ts, h, w):
    if ts != TILE_SIZE:
        raise ValueError("the fused loss takes 16-pixel tiles only")
    if h <= L.WINDOW - 1 or w <= L.WINDOW - 1:
        raise ValueError("image smaller than the SSIM window")
    ng, c, gt, pix = tiles.shape
    if c < 3 or pix != ts * ts or ng * gt < ntx * nty:
        raise ValueError(f"tile layout {tuple(tiles.shape)} does not hold a "
                         f"{ntx}x{nty} grid of RGB tiles")
    if ntx * ts < w or nty * ts < h:
        raise ValueError("image larger than the tile grid")
    if tuple(target.shape) != (3, h, w):
        raise ValueError(f"target must be (3, {h}, {w}), got "
                         f"{tuple(target.shape)}")


def fused_photometric_loss_reference(tiles, target, ntx, nty, ts, h, w,
                                     ssim_weight):
    """Plain version of kernel B3: (loss, mse, gradient w.r.t. tiles)."""
    _check(tiles, target, ntx, nty, ts, h, w)
    ng, c, gt, _ = tiles.shape
    target_tiles = tile_chw(target, ng, 3, gt, ntx, nty, ts)
    mask = tile_chw(torch.ones((1, h, w), device=tiles.device), ng, 1, gt,
                    ntx, nty, ts)
    with torch.enable_grad():
        x = tiles.detach().requires_grad_(True)
        loss = L.tile_l1(x, target_tiles, mask)
        if ssim_weight > 0.0:
            img = untile_chw(x[:, :3], ntx, nty, ts, h, w)
            loss = ((1.0 - ssim_weight) * loss
                    + ssim_weight * (1.0 - L.ssim_chw(img, target)))
        grad, = torch.autograd.grad(loss, x)
    mse = L.tile_mse(tiles.detach(), target_tiles, mask)
    return loss.detach(), mse, grad


def _fused_loss_cuda(tiles, target, ntx, nty, ts, h, w, ssim_weight):
    _check(tiles, target, ntx, nty, ts, h, w)
    dev = tiles.device
    if (tiles.dtype != torch.float32 or target.dtype != torch.float32
            or target.device != dev or not target.is_contiguous()):
        raise ValueError("fused loss takes float32 tiles and a contiguous "
                         "float32 target on the same card")
    if tiles.stride(3) != 1 or tiles.stride(2) != ts * ts:
        raise ValueError("each tile's pixels must be contiguous")
    ng, c, gt, pix = tiles.shape
    taps = _Taps((ctypes.c_float * L.WINDOW)(*L.ssim_kernel1d().tolist()))
    hw, ww = h - L.WINDOW + 1, w - L.WINDOW + 1
    n_pix, n_win = 3.0 * h * w, 3.0 * hw * ww
    rows, cols = _REGION_TILES
    n_part = 3 * 3 * (-(-nty // rows)) * (-(-ntx // cols))
    partial = torch.empty((n_part,), dtype=torch.float32, device=dev)
    grad = torch.empty((ng, c, gt, pix), dtype=torch.float32, device=dev)
    sums = torch.empty((3,), dtype=torch.float32, device=dev)
    FUSED_LOSS.launch(
        tiles.data_ptr(), tiles.stride(0), tiles.stride(1), gt, ntx, nty,
        target.data_ptr(), h, w, taps, L.C1, L.C2,
        (1.0 - ssim_weight) / n_pix, -ssim_weight / n_win,
        partial.data_ptr(), grad.data_ptr(), c, ng, sums.data_ptr(),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    loss = ((1.0 - ssim_weight) * (sums[0] / n_pix)
            + ssim_weight * (1.0 - sums[1] / n_win))
    return loss, sums[2] / n_pix, grad


class _FusedPhotometricLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tiles, target, ntx, nty, ts, h, w, ssim_weight):
        fn = (_fused_loss_cuda if tiles.is_cuda
              else fused_photometric_loss_reference)
        loss, mse, grad = fn(tiles, target, ntx, nty, ts, h, w, ssim_weight)
        ctx.save_for_backward(grad)
        ctx.mark_non_differentiable(mse)
        return loss, mse

    @staticmethod
    def backward(ctx, g_loss, g_mse):
        grad, = ctx.saved_tensors      # the mse cotangent is dropped
        return grad * g_loss, None, None, None, None, None, None, None


def fused_photometric_loss(tiles: torch.Tensor, target: torch.Tensor,
                           ntx: int, nty: int, ts: int, h: int, w: int,
                           ssim_weight: float):
    """(loss, mse) of tiles (NG, C>=3, GT, 256) against target (3, H, W);
    differentiable in ``tiles`` through ``loss`` only."""
    return _FusedPhotometricLoss.apply(tiles, target, ntx, nty, ts, h, w,
                                       ssim_weight)
