"""Held-out view evaluation: PSNR and SSIM per camera.

The port's counterpart of the JAX package's ``train/evaluate.py``, the
novel-view protocol that scores a 3DGS scene: each view is rendered with
``render_tiled`` (kernels B1 and B5-untile on the card), clipped to [0, 1]
and scored with ``train/loss.py``'s ``psnr`` and plain ``ssim``, as the JAX
package scores it (its SSIM there is not a Pallas kernel either).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig
from intro_to_gaussian_splatting_tpu_torch.models.camera import Camera
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    GaussianModel,
)
from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import render_tiled
from intro_to_gaussian_splatting_tpu_torch.train.loss import psnr, ssim


@torch.no_grad()
def evaluate(
    model: GaussianModel,
    cameras: Sequence[Camera],
    targets: Sequence[np.ndarray],
    rcfg: RasterizerConfig = RasterizerConfig(),
    active_sh_degree: Optional[int] = None,
    names: Optional[Sequence[str]] = None,
) -> List[Dict]:
    """Render every camera and score it against its (H, W, 3) ground truth.

    Returns one dict per view, {name, psnr, ssim, overflowed, height,
    width}, then a summary row {name: "mean", psnr, ssim} averaging the
    views. ``overflowed`` says the pair pool dropped gaussians for that view
    (``rcfg.pairs_per_gaussian`` too small, as for a densified model under
    the default pool): its metrics under-count far gaussians. Each view's
    three numbers come back to the host in one transfer."""
    rows: List[Dict] = []
    for i, (cam, target) in enumerate(zip(cameras, targets)):
        t = torch.as_tensor(np.asarray(target, dtype=np.float32),
                            device=model.device)
        img, aux = render_tiled(model, cam, rcfg,
                                active_sh_degree=active_sh_degree,
                                return_aux=True)
        img = torch.clamp(img, 0.0, 1.0)
        p, s, ovf = torch.stack([psnr(img, t), ssim(img, t),
                                 aux["overflowed"].float()]).tolist()
        rows.append(dict(name=names[i] if names else f"view_{i}", psnr=p,
                         ssim=s, overflowed=ovf > 0, height=cam.height,
                         width=cam.width))
    if rows:
        rows.append(dict(name="mean",
                         psnr=float(np.mean([r["psnr"] for r in rows])),
                         ssim=float(np.mean([r["ssim"] for r in rows]))))
    return rows


@torch.no_grad()
def render_views(
    model: GaussianModel,
    cameras: Sequence[Camera],
    rcfg: RasterizerConfig = RasterizerConfig(),
    active_sh_degree: Optional[int] = None,
) -> List[np.ndarray]:
    """Render every camera; returns float32 (H, W, 3) images in [0, 1]."""
    return [torch.clamp(render_tiled(model, cam, rcfg,
                                     active_sh_degree=active_sh_degree),
                        0.0, 1.0).cpu().numpy()
            for cam in cameras]
