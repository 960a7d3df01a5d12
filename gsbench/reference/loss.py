"""The 3DGS photometric loss, (1 - w) * L1 + w * (1 - SSIM), in plain
PyTorch: SSIM over the valid 11x11 gaussian windows (sigma 1.5) of each
channel, c1 = 0.01^2, c2 = 0.03^2 (Wang et al. 2004, as 3DGS uses it).
``precision="tf32"`` rounds the inputs of every convolution to TF32."""

from __future__ import annotations

import numpy as np
import torch

from gsbench.reference.projection import to_tf32

WINDOW = 11
SIGMA = 1.5
C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _taps(device) -> torch.Tensor:
    ax = np.arange(WINDOW) - (WINDOW - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2 * SIGMA ** 2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device)


def _blur(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Separable valid gaussian blur of (C, H, W): down, then along."""
    c = x.shape[0]
    k = _taps(x.device)
    y = x[None]
    for kern in (k[None, None, :, None], k[None, None, None, :]):
        kern = kern.expand(c, 1, *kern.shape[2:])
        if precision == "tf32":
            y, kern = to_tf32(y), to_tf32(kern)
        y = torch.nn.functional.conv2d(y, kern, groups=c)
    return y[0]


def ssim(pred: torch.Tensor, target: torch.Tensor,
         precision: str = "float32") -> torch.Tensor:
    """Mean SSIM of (C, H, W) images."""
    mu_x, mu_y = _blur(pred, precision), _blur(target, precision)
    sxx = _blur(pred * pred, precision) - mu_x * mu_x
    syy = _blur(target * target, precision) - mu_y * mu_y
    sxy = _blur(pred * target, precision) - mu_x * mu_y
    num = (2 * mu_x * mu_y + C1) * (2 * sxy + C2)
    den = (mu_x * mu_x + mu_y * mu_y + C1) * (sxx + syy + C2)
    return torch.mean(num / den)


def photometric(pred: torch.Tensor, target: torch.Tensor, ssim_weight: float,
                precision: str = "float32") -> torch.Tensor:
    l1 = torch.mean(torch.abs(pred - target))
    return ((1.0 - ssim_weight) * l1
            + ssim_weight * (1.0 - ssim(pred, target, precision)))
