"""Adaptive density control: clone / split / prune on a fixed-capacity pool.

The JAX package's train/densify.py in PyTorch. The gaussian tensors never
change shape: dead slots carry ``active=False``, and densification copies
the top-gradient candidates into free slots. The model's parameters are
updated in place (JAX returns new arrays; here the pool is rewritten where
it lies). JAX's ``mode="drop"`` writes for destinations equal to the
capacity become masked writes.

Densification reads screen-space positional gradients (the 3DGS
criterion), taken with respect to a zero-valued ``mean2d_offset`` probe in
the projection pass. The split offsets' standard-normal noise is drawn by
``split_noise`` from an explicit ``torch.Generator``, apart from the
arithmetic, so that a test can feed ``densify`` the JAX package's noise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from intro_to_gaussian_splatting_tpu_torch.config import TrainConfig
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianModel,
    quats_to_rotmats,
)


@dataclasses.dataclass
class DensifyState:
    grad_accum: torch.Tensor   # (N,) f32 accumulated |dL/d mean2d|
    count: torch.Tensor        # (N,) int32 number of times visible

    @staticmethod
    def zero(capacity: int, device: torch.device | str = "cpu"
             ) -> "DensifyState":
        return DensifyState(
            grad_accum=torch.zeros((capacity,), dtype=torch.float32,
                                   device=device),
            count=torch.zeros((capacity,), dtype=torch.int32, device=device))


def accumulate(state: DensifyState, screen_grads: torch.Tensor,
               visible: torch.Tensor) -> DensifyState:
    """screen_grads: (N, 2) dL/d mean2d of this step; visible: (N,) bool."""
    norm = torch.sqrt(torch.sum(screen_grads * screen_grads, dim=-1))
    return DensifyState(
        grad_accum=state.grad_accum + torch.where(visible, norm, 0.0),
        count=state.count + visible.to(torch.int32))


def split_noise(max_new: int, generator: torch.Generator,
                device: torch.device | str) -> torch.Tensor:
    """(max_new, 3) standard-normal samples for the split offsets."""
    return torch.randn((max_new, 3), generator=generator, device=device)


@torch.no_grad()
def densify(model: GaussianModel, state: DensifyState, noise: torch.Tensor,
            config: TrainConfig, scene_extent: float,
            max_new: int) -> torch.Tensor:
    """One clone/split pass, in place. ``noise`` is (max_new, 3) standard
    normal (``split_noise``). Returns the destination slots written,
    (max_new,) int64, equal to the capacity where no slot was used, so that
    the caller can zero the optimizer moments there (``zero_slots``)."""
    cap = model.capacity
    active = model.active
    grad_avg = state.grad_accum / torch.clamp(state.count, min=1)
    cand = active & (grad_avg > config.densify_grad_threshold)
    max_scale = torch.exp(torch.max(model.log_scales, dim=-1).values)
    split = cand & (max_scale > config.densify_scale_threshold
                    * scene_extent)

    # top-gradient candidates; free slots = inactive, lowest index first
    score = torch.where(cand, grad_avg, -math.inf)
    src = torch.argsort(-score, stable=True)[:max_new]
    src_ok = score[src] > -math.inf
    free = torch.argsort(active.to(torch.int8), stable=True)[:max_new]
    free_ok = ~active[free]
    valid = src_ok & free_ok
    dst = torch.where(valid, free, cap)

    # new gaussian = copy of its source; a split source's copy is offset by
    # a sample of the source gaussian, and both copies shrink by 1.6
    shrink = torch.log(torch.tensor(1.6, dtype=torch.float32,
                                    device=active.device))
    off = noise * torch.exp(model.log_scales[src])
    world_off = torch.einsum("nij,nj->ni", quats_to_rotmats(model.quats[src]),
                             off)
    is_split_src = split[src][:, None]
    new = dict(
        means=model.means[src] + torch.where(is_split_src, world_off, 0.0),
        log_scales=model.log_scales[src] - torch.where(is_split_src, shrink,
                                                       0.0),
        quats=model.quats[src],
        opacity_logits=model.opacity_logits[src],
        sh=model.sh[src],
    )
    at = dst[valid]
    for name in PARAM_NAMES:
        getattr(model, name)[at] = new[name][valid]
    model.active[at] = True
    # the split sources shrink in place as well
    model.log_scales.sub_(torch.where(split[:, None], shrink, 0.0))
    return dst


@torch.no_grad()
def prune(model: GaussianModel, config: TrainConfig,
          scene_extent: float) -> None:
    """Deactivate low-opacity or overly large gaussians, in place."""
    opacity = torch.sigmoid(model.opacity_logits)
    too_faint = opacity < config.prune_opacity_threshold
    too_big = (torch.exp(torch.max(model.log_scales, dim=-1).values)
               > 0.5 * scene_extent)
    model.active &= ~too_faint & ~too_big


@torch.no_grad()
def reset_opacity(model: GaussianModel, ceiling: float = 0.01) -> None:
    """Clamp opacity to <= ceiling (3DGS periodic opacity reset), in
    place."""
    logit = torch.log(torch.tensor(ceiling / (1.0 - ceiling),
                                   dtype=torch.float32,
                                   device=model.opacity_logits.device))
    torch.minimum(model.opacity_logits, logit, out=model.opacity_logits)


@torch.no_grad()
def zero_slots(tensors, slots: torch.Tensor, capacity: int) -> None:
    """Zero, in place, the rows ``slots`` (< capacity) of every tensor whose
    leading dimension is the capacity; other tensors are left as they
    are."""
    rows = slots[slots < capacity]
    for t in tensors:
        if t.dim() >= 1 and t.shape[0] == capacity:
            t[rows] = 0

