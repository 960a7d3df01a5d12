"""Checkpoint / resume and PLY interop.

The port's counterpart of the JAX package's ``train/checkpoint.py``:

  * ``save_checkpoint`` / ``load_checkpoint`` keep the full training state
    (every parameter, ``active``, the step and each Adam group's ``count``,
    ``mu``, ``nu`` and ``schedule_count``) as one ``torch.save`` of a plain
    dict of tensors, ints and strings under ``<dir>/step_<N>/state.pt``,
    loadable with ``weights_only=True``. A save writes
    ``step_<N>.tmp-<ns>`` and renames it, so an interrupted save leaves a
    sibling that ``list_checkpoint_steps`` skips. The JAX package keeps
    orbax checkpoints; neither package reads the other's.
  * ``export_ply`` / ``import_ply`` write and read the standard 3DGS PLY
    layout (``f_dc_*``, ``f_rest_*``, ``opacity``, ``scale_*``, ``rot_*``),
    byte for byte the JAX package's: the format the two packages share.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from typing import Optional, Tuple

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianModel,
)
from intro_to_gaussian_splatting_tpu_torch.train.trainer import (
    AdamGroup,
    OptState,
)

STATE_FILE = "state.pt"
ADAM_FIELDS = ("count", "mu", "nu", "schedule_count")


def _payload(model: GaussianModel, opt_state: OptState, step: int) -> dict:
    return dict(
        model={name: getattr(model, name).detach() for name in PARAM_NAMES},
        active=model.active, color_space=model.color_space, step=int(step),
        opt_state={name: {f: getattr(group, f) for f in ADAM_FIELDS}
                   for name, group in opt_state.items()})


def save_checkpoint(path: str, model: GaussianModel, opt_state: OptState,
                    step: int) -> None:
    """Write the state to ``<path>/step_<step>``, replacing a checkpoint of
    the same step."""
    path = os.path.abspath(path)
    final = os.path.join(path, f"step_{step}")
    tmp = f"{final}.tmp-{time.time_ns()}"
    os.makedirs(tmp)
    torch.save(_payload(model, opt_state, step), os.path.join(tmp, STATE_FILE))
    old = None
    if os.path.isdir(final):
        old = f"{final}.old-{time.time_ns()}"
        os.replace(final, old)
    os.replace(tmp, final)
    if old:
        shutil.rmtree(old, ignore_errors=True)


def list_checkpoint_steps(path: str):
    """Step numbers with a saved checkpoint under ``path``, ascending. Only
    exact ``step_<N>`` directories count: an interrupted save leaves
    ``step_<N>.tmp-<ns>`` siblings behind, which resume must skip."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return []
    steps = []
    for d in os.listdir(path):
        m = re.fullmatch(r"step_(\d+)", d)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def prune_checkpoints(path: str, keep: int) -> None:
    """Delete all but the newest ``keep`` step_* checkpoints (``keep`` <= 0
    deletes none)."""
    steps = list_checkpoint_steps(path)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(os.path.abspath(path), f"step_{s}"),
                      ignore_errors=True)


def load_checkpoint(path: str, model_template: GaussianModel,
                    opt_state_template: OptState,
                    step: Optional[int] = None
                    ) -> Tuple[GaussianModel, OptState, int]:
    """(model, opt_state, step) from the newest (or the given) checkpoint
    under ``path``, on the template model's device. The templates fix the
    shapes: a checkpoint of another capacity or optimizer raises."""
    path = os.path.abspath(path)
    if step is None:
        steps = list_checkpoint_steps(path)
        if not steps:
            raise FileNotFoundError(f"no step_<N> checkpoints under {path}")
        step = max(steps)
    state = torch.load(os.path.join(path, f"step_{step}", STATE_FILE),
                       map_location=model_template.device, weights_only=True)
    for name in PARAM_NAMES:
        got = tuple(state["model"][name].shape)
        want = tuple(getattr(model_template, name).shape)
        if got != want:
            raise ValueError(f"checkpoint {name} has shape {got}, the model "
                             f"{want}")
    if sorted(state["opt_state"]) != sorted(opt_state_template):
        raise ValueError("the checkpoint's optimizer groups differ from the "
                         "template's")
    model = GaussianModel(**state["model"], active=state["active"],
                          color_space=state["color_space"])
    opt_state = {name: AdamGroup(**state["opt_state"][name])
                 for name in opt_state_template}
    return model, opt_state, int(state["step"])


def export_ply(path: str, model: GaussianModel) -> None:
    """Write the active gaussians in the standard 3DGS PLY layout."""
    from intro_to_gaussian_splatting_tpu_torch.io.ply import write_ply

    def np_(t):
        return t.detach().cpu().numpy()

    active = np_(model.active)
    means = np_(model.means)[active]
    sh = np_(model.sh)[active]                   # (n, K, 3)
    n, k, _ = sh.shape
    extra = {
        "f_dc": sh[:, 0, :],
        "opacity": np_(model.opacity_logits)[active],
        "scale": np_(model.log_scales)[active],
        "rot": np_(model.quats)[active],
    }
    if k > 1:
        # 3DGS layout: f_rest is (K-1, 3) transposed to channel-major
        extra["f_rest"] = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)
    write_ply(path, means, extra=extra)


def import_ply(path: str, color_space: str = "sh",
               device: str | torch.device | None = None) -> GaussianModel:
    """Read a 3DGS-layout PLY back into a GaussianModel on ``device`` (the
    card unless the caller asks for the CPU)."""
    from intro_to_gaussian_splatting_tpu_torch.io.ply import read_ply

    device = resolve_device(device)
    data = read_ply(path)
    n = len(data["x"])
    means = np.stack([data["x"], data["y"], data["z"]], axis=1)
    sh0 = np.stack([data[f"f_dc_{i}"] for i in range(3)], axis=1)
    rest_keys = sorted((k for k in data if k.startswith("f_rest_")),
                       key=lambda s: int(s.split("_")[-1]))
    if rest_keys:
        rest = np.stack([data[k] for k in rest_keys], axis=1)
        rest = rest.reshape(n, 3, rest.shape[1] // 3).transpose(0, 2, 1)
        sh = np.concatenate([sh0[:, None, :], rest], axis=1)
    else:
        sh = sh0[:, None, :]

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    return GaussianModel(
        means=t(means),
        log_scales=t(np.stack([data[f"scale_{i}"] for i in range(3)], 1)),
        quats=t(np.stack([data[f"rot_{i}"] for i in range(4)], 1)),
        opacity_logits=t(data["opacity"]), sh=t(sh),
        active=torch.ones(n, dtype=torch.bool, device=device),
        color_space=color_space)
