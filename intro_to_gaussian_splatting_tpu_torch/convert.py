"""Carry a model or a camera across from numpy arrays.

The JAX package's pytrees become numpy with ``jax.tree.map(np.asarray, x)``;
these functions take such numpy leaves (never JAX arrays or JAX types) and
build the port's counterparts, so weights and poses move between the two
packages without either importing the other.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
from intro_to_gaussian_splatting_tpu_torch.models.camera import Camera
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import GaussianModel

PARAM_NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")
CAMERA_TENSORS = ("world2view", "full_proj", "fx", "fy", "tan_fovx",
                  "tan_fovy", "cam_center")


def model_from_numpy(params: Mapping[str, np.ndarray], active: np.ndarray,
                     color_space: str = "sh",
                     device: str | torch.device | None = None) -> GaussianModel:
    """``params`` holds the five parameter arrays by name (float32 is kept
    bit for bit); ``active`` is the (N,) bool pool mask."""
    device = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return GaussianModel(
        **{name: t(params[name]) for name in PARAM_NAMES},
        active=torch.from_numpy(np.array(active, dtype=bool)).to(device),
        color_space=color_space,
    )


def camera_from_numpy(fields: Mapping[str, Any],
                      device: str | torch.device | None = None) -> Camera:
    """``fields`` holds the camera's seven arrays by name plus the ints
    ``width`` and ``height`` (``dataclasses.asdict`` of a numpy-leaved
    camera of either package)."""
    device = resolve_device(device)
    tensors = {name: torch.from_numpy(
        np.array(fields[name], dtype=np.float32)).to(device)
        for name in CAMERA_TENSORS}
    return Camera(**tensors, width=int(fields["width"]),
                  height=int(fields["height"]))
