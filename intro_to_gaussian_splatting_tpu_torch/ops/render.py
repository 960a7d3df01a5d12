"""High-level render entry point with backend dispatch.

Backends:
  * "tiled": project -> bin -> rasterize (kernel B1 on the card) -> untile
    (kernel B5-untile on the card); the production path;
  * "dense": all-pairs compositing in plain torch (the oracle, O(pixels*N));
  * "auto":  the tiled path. A kernel that does not build raises; there is
    no fallback to the dense path.
"""

from __future__ import annotations

from typing import Optional

import torch

from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig
from intro_to_gaussian_splatting_tpu_torch.models.camera import Camera
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import GaussianModel
from intro_to_gaussian_splatting_tpu_torch.ops.compositing import render_dense
from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import render_tiled

BACKENDS = ("auto", "tiled", "dense")


def render(
    model: GaussianModel,
    camera: Camera,
    config: RasterizerConfig = RasterizerConfig(),
    backend: str = "auto",
    active_sh_degree: Optional[int] = None,
) -> torch.Tensor:
    """Render (height, width, 3) on the model's device."""
    if backend in ("auto", "tiled"):
        return render_tiled(model, camera, config,
                            active_sh_degree=active_sh_degree)
    if backend == "dense":
        return render_dense(model, camera, config,
                            active_sh_degree=active_sh_degree)
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")
