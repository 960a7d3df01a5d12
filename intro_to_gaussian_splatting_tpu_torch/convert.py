"""Carry a model, a camera or a training state across from numpy arrays.

The JAX package's pytrees become numpy with ``jax.tree.map(np.asarray, x)``;
these functions take such numpy leaves (never JAX arrays or JAX types) and
build the port's counterparts, so weights, poses and a training run's
state move between the two packages without either importing the other.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
from intro_to_gaussian_splatting_tpu_torch.models.camera import (
    CAMERA_TENSORS,
    Camera,
)
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianModel,
)
from intro_to_gaussian_splatting_tpu_torch.train.densify import DensifyState
from intro_to_gaussian_splatting_tpu_torch.train.trainer import (
    AdamGroup,
    OptState,
)


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


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def densify_state_from_numpy(fields: Mapping[str, Any],
                             device: str | torch.device | None = None
                             ) -> DensifyState:
    """``fields`` holds ``grad_accum`` (N,) and ``count`` (N,)
    (``dataclasses.asdict`` of a numpy-leaved DensifyState)."""
    device = resolve_device(device)
    return DensifyState(
        grad_accum=_tensor(fields["grad_accum"], np.float32, device),
        count=_tensor(fields["count"], np.int32, device))


def optimizer_state_from_numpy(opt_state: Any,
                               device: str | torch.device | None = None
                               ) -> OptState:
    """The port's Adam state from the JAX package's optimizer state with
    numpy leaves: optax's ``multi_transform`` state, one masked inner state
    per parameter group, each a chain whose first member is Adam's
    (``count``, ``mu``, ``nu``) and, for the means, whose second is the
    learning-rate schedule's ``count``. Read by attribute and key names
    only, so nothing of optax or JAX is imported."""
    device = resolve_device(device)
    state = {}
    for name in PARAM_NAMES:
        chain = opt_state.inner_states[name].inner_state
        adam = chain[0]
        schedule = chain[1] if name == "means" else None
        state[name] = AdamGroup(
            count=_tensor(adam.count, np.int32, device),
            mu=_tensor(adam.mu[name], np.float32, device),
            nu=_tensor(adam.nu[name], np.float32, device),
            schedule_count=(None if schedule is None
                            else _tensor(schedule.count, np.int32, device)))
    return state
