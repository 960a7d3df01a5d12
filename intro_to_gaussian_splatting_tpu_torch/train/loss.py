"""Training losses and image metrics, in plain PyTorch.

The 3DGS objective (1-w)*L1 + w*(1-SSIM) and PSNR, as the JAX package's
train/loss.py computes them: SSIM over 11x11 gaussian windows (sigma 1.5,
c1 = 0.01^2, c2 = 0.03^2), VALID windows only, as a separable depthwise
blur. The training step's loss is the fused kernel B3
(ops/fused_loss.py); these are its plain oracle and the metrics.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WINDOW = 11
SIGMA = 1.5
C1 = 0.01 ** 2
C2 = 0.03 ** 2


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return psnr_from_mse(torch.mean((pred - target) ** 2))


@functools.lru_cache(maxsize=None)
def ssim_kernel1d(window: int = WINDOW, sigma: float = SIGMA) -> np.ndarray:
    """The normalized 1-D gaussian taps, float32 (cached as numpy)."""
    ax = np.arange(window) - (window - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return g.astype(np.float32)


def _blur_chw(x: torch.Tensor, window: int, sigma: float) -> torch.Tensor:
    """Separable depthwise gaussian blur of (C, H, W), VALID: rows first,
    then columns, as the JAX package convolves."""
    c = x.shape[0]
    k = torch.from_numpy(ssim_kernel1d(window, sigma)).to(x.device)
    kh = k[None, None, :, None].expand(c, 1, window, 1)
    kw = k[None, None, None, :].expand(c, 1, 1, window)
    y = x[None]
    for kern in (kh, kw):
        y = torch.nn.functional.conv2d(y, kern, groups=c)
    return y[0]


def ssim_chw(pred: torch.Tensor, target: torch.Tensor,
             window: int = WINDOW, sigma: float = SIGMA,
             c1: float = C1, c2: float = C2,
             reduce: bool = True) -> torch.Tensor:
    """Mean SSIM over channel-major (C, H, W) images in [0, 1];
    ``reduce=False`` returns the (C, H-window+1, W-window+1) map."""
    mu_x = _blur_chw(pred, window, sigma)
    mu_y = _blur_chw(target, window, sigma)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = _blur_chw(pred * pred, window, sigma) - mu_x2
    sigma_y = _blur_chw(target * target, window, sigma) - mu_y2
    sigma_xy = _blur_chw(pred * target, window, sigma) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2)
    smap = num / den
    return torch.mean(smap) if reduce else smap


def ssim(pred: torch.Tensor, target: torch.Tensor,
         window: int = WINDOW, sigma: float = SIGMA,
         c1: float = C1, c2: float = C2) -> torch.Tensor:
    """Mean SSIM over (H, W, 3) images in [0, 1]."""
    return ssim_chw(pred.permute(2, 0, 1), target.permute(2, 0, 1), window,
                    sigma, c1, c2)


def rgb_loss(pred: torch.Tensor, target: torch.Tensor,
             ssim_weight: float = 0.2) -> torch.Tensor:
    """(1-w) * L1 + w * (1 - SSIM) of (H, W, 3) images."""
    if ssim_weight == 0.0:
        return l1(pred, target)
    return ((1.0 - ssim_weight) * l1(pred, target)
            + ssim_weight * (1.0 - ssim(pred, target)))


def tile_l1(pred_tiles: torch.Tensor, target_tiles: torch.Tensor,
            mask_tiles: torch.Tensor) -> torch.Tensor:
    """Mean L1 in the rasterizer's tile layout (NG, >=3, GT, pix); target
    and mask from ``image_to_tiles`` / ``tile_pixel_mask``."""
    diff = torch.abs(pred_tiles[:, :3] - target_tiles[:, :3]) * mask_tiles
    return torch.sum(diff) / (3.0 * torch.sum(mask_tiles))


def tile_mse(pred_tiles: torch.Tensor, target_tiles: torch.Tensor,
             mask_tiles: torch.Tensor) -> torch.Tensor:
    """Mean squared error in the tile layout (padding masked out)."""
    d2 = ((pred_tiles[:, :3] - target_tiles[:, :3]) ** 2) * mask_tiles
    return torch.sum(d2) / (3.0 * torch.sum(mask_tiles))


def tile_psnr(pred_tiles: torch.Tensor, target_tiles: torch.Tensor,
              mask_tiles: torch.Tensor) -> torch.Tensor:
    """PSNR in the tile layout; equals ``psnr`` on the untiled images."""
    return psnr_from_mse(tile_mse(pred_tiles, target_tiles, mask_tiles))
