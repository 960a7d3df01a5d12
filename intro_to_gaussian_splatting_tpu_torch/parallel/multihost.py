"""Multi-process training: joining the world, the global mesh, and each
rank's share of values that every rank holds whole.

One rank is one device. ``init_multihost`` joins the ranks through a TCP
store at the coordinator's address (the JAX package uses
``jax.distributed``'s coordinator), NCCL for the card and gloo for the CPU:

    gstpu-torch train --multihost --coordinator host0:1234 \\
        --num-processes 2 --process-id $RANK ...

A lost peer fails the run after ``timeout_s`` instead of hanging it;
restarting every rank and resuming from the newest checkpoint is the
recovery path (a mesh checkpoint is one file, written by rank 0 from the
gathered state, that also resumes on one card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianModel,
)
from intro_to_gaussian_splatting_tpu_torch.parallel.mesh import (
    GAUSS_AXIS,
    Mesh,
    make_mesh,
)
from intro_to_gaussian_splatting_tpu_torch.parallel.sharded import (
    shard_model,
    shard_rows,
    strip_layout,
)


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: str | torch.device | None = None,
                   timeout_s: float = 600.0) -> torch.device:
    """Join (or form) the world of ranks and return this rank's device:
    the card (``cuda:process_id % device_count``, NCCL) unless ``device``
    asks for the CPU (gloo). ``coordinator`` is ``host:port`` of rank 0;
    left out, the address, world size and rank come from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    torchrun sets them). Does nothing but resolve the device if the world
    is already initialised."""
    device = resolve_device(device)
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def global_mesh(n_gauss_shards: Optional[int] = None,
                n_tile_shards: Optional[int] = None,
                device: str | torch.device | None = None) -> Mesh:
    """The gauss x tiles mesh over every rank of every process."""
    return make_mesh(n_gauss_shards, n_tile_shards, device)


def process_local_rows(height: int, tile_size: int,
                       mesh: Mesh) -> Tuple[int, int]:
    """(row0, rows) of the padded image strip this rank owns: it loads
    and uploads only those rows of a target."""
    strip_rows, _ = strip_layout(height, tile_size, mesh.size)
    return mesh.rank * strip_rows, strip_rows


def globalize_target(local_rows, padded_h: int, mesh: Mesh) -> torch.Tensor:
    """This rank's (rows, W, 3) strip of a (padded_h, W, 3) target, on its
    device; no rank holds the full image."""
    local = torch.as_tensor(local_rows, dtype=torch.float32)
    if local.shape[0] * mesh.size != padded_h:
        raise ValueError(f"{local.shape[0]} rows per rank over {mesh.size} "
                         f"ranks do not make {padded_h} rows")
    return local.to(mesh.device)


def put_global(x, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """This rank's share of a value every rank holds whole, on its device:
    its gauss shard of the leading dimension with ``axis=GAUSS_AXIS``, the
    whole value with ``axis=None``."""
    x = torch.as_tensor(x)
    if axis == GAUSS_AXIS:
        x = shard_rows(x, mesh)
    elif axis is not None:
        raise ValueError(f"put_global shards along {GAUSS_AXIS!r} only")
    return x.to(mesh.device)


def put_global_tree(tree, mesh: Mesh, axis: Optional[str] = None):
    """``put_global`` over a GaussianModel or over the tensor fields of a
    dataclass (a Camera, a DensifyState); 0-d tensors stay whole."""
    if isinstance(tree, GaussianModel):
        return shard_model(tree, mesh) if axis == GAUSS_AXIS else \
            tree.to(mesh.device)
    fields = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    return dataclasses.replace(tree, **{
        name: put_global(v, mesh, axis if v.dim() else None)
        for name, v in fields.items() if isinstance(v, torch.Tensor)})


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every gauss shard of a capacity-leading tensor, concatenated (no
    gradient)."""
    if mesh.n_gauss == 1:
        return x.detach().clone()
    # bool travels as uint8, which every backend reduces and gathers
    y = x.detach().to(torch.uint8 if x.dtype == torch.bool else x.dtype)
    parts = [torch.empty_like(y) for _ in range(mesh.n_gauss)]
    dist.all_gather(parts, y.contiguous(), group=mesh.gauss_group)
    return torch.cat(parts).to(x.dtype)


def gather_model(model_shard: GaussianModel, mesh: Mesh) -> GaussianModel:
    """The whole model on every rank, from each rank's shard (for export,
    checkpoints and densification). Every rank must call it."""
    return GaussianModel(
        **{n: gather_rows(getattr(model_shard, n), mesh)
           for n in PARAM_NAMES},
        active=gather_rows(model_shard.active, mesh),
        color_space=model_shard.color_space)


def is_coordinator() -> bool:
    """True on rank 0, and in a process that has joined no world (JAX's
    ``jax.process_index() == 0``, which is 0 in a single process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Cross-rank sync point (checkpoint write ordering)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
