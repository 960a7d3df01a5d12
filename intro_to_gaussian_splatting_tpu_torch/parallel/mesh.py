"""A device mesh of torch.distributed ranks.

The JAX package's parallel/mesh.py builds a ``jax.sharding.Mesh`` over the
devices that one process drives. Here one rank is one device, and a mesh
is a ``g x t`` grid of ranks: rank ``g_idx * t + t_idx``, as the JAX
package's ``devices.reshape(g, t)`` orders them.

  * "gauss": the gaussians are sharded over it. The ranks that share a tile
    index form a gauss group; the ring of parallel/sharded.py runs in it.
  * "tiles": the ranks that share a gauss index form a tile group. They
    hold the same shard (``PS(GAUSS_AXIS)`` replicates it over the tile
    axis), so their gradients are summed in that group.

Rank ``g_idx * t + t_idx`` owns image strip ``g_idx * t + t_idx``
(``_strip_index``, JAX sharded.py:102): the strip index is the rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from intro_to_gaussian_splatting_tpu_torch.device import resolve_device

GAUSS_AXIS = "gauss"
TILE_AXIS = "tiles"


def mesh_dims(n: int, n_gauss_shards: Optional[int] = None,
              n_tile_shards: Optional[int] = None) -> Tuple[int, int]:
    """(g, t) of a mesh of ``n`` ranks, the JAX package's rule: with
    neither given, the tile axis takes the largest power of two <= sqrt(n)
    (more parallel work there) and the gauss axis the rest."""
    if n_gauss_shards is None and n_tile_shards is None:
        n_tile_shards = _largest_pow2_leq(math.isqrt(n))
    if n_gauss_shards is None:
        n_gauss_shards = n // n_tile_shards
    elif n_tile_shards is None:
        n_tile_shards = n // n_gauss_shards
    if n_gauss_shards * n_tile_shards != n:
        raise ValueError(f"{n_gauss_shards}x{n_tile_shards} != {n} ranks")
    return n_gauss_shards, n_tile_shards


def _largest_pow2_leq(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``g x t`` mesh, its device and its two
    process groups."""

    n_gauss: int
    n_tiles: int
    g_idx: int
    t_idx: int
    device: torch.device
    gauss_group: object      # ranks (0..g-1, t_idx)
    tile_group: object       # ranks (g_idx, 0..t-1)

    @property
    def shape(self) -> dict:
        return {GAUSS_AXIS: self.n_gauss, TILE_AXIS: self.n_tiles}

    @property
    def size(self) -> int:
        return self.n_gauss * self.n_tiles

    @property
    def rank(self) -> int:
        """This rank's global rank, which is also its strip index."""
        return self.g_idx * self.n_tiles + self.t_idx

    @property
    def gauss_ranks(self) -> List[int]:
        """Global ranks of the gauss group, in gauss-index order."""
        return [g * self.n_tiles + self.t_idx for g in range(self.n_gauss)]

    @property
    def tile_ranks(self) -> List[int]:
        """Global ranks of the tile group, in tile-index order."""
        return [self.g_idx * self.n_tiles + t for t in range(self.n_tiles)]


def make_mesh(n_gauss_shards: Optional[int] = None,
              n_tile_shards: Optional[int] = None,
              device: str | torch.device | None = None) -> Mesh:
    """The mesh over every rank of the initialised default process group.

    Every rank must call it, with the same arguments. ``device`` defaults
    to the card (``cuda:rank % device_count``; the group's backend must be
    NCCL); a CPU device needs a gloo group.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(parallel.multihost.init_multihost)")
    n, rank = dist.get_world_size(), dist.get_rank()
    g, t = mesh_dims(n, n_gauss_shards, n_tile_shards)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    backend = dist.get_backend()
    if (device.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"a {device.type} mesh cannot run on a {backend} "
                         f"process group (NCCL for the card, gloo for the "
                         f"CPU)")
    # every rank creates every group, in the same order, or new_group hangs
    gauss_groups = [dist.new_group([gi * t + ti for gi in range(g)])
                    for ti in range(t)]
    tile_groups = [dist.new_group([gi * t + ti for ti in range(t)])
                   for gi in range(g)]
    g_idx, t_idx = divmod(rank, t)
    return Mesh(n_gauss=g, n_tiles=t, g_idx=g_idx, t_idx=t_idx,
                device=device, gauss_group=gauss_groups[t_idx],
                tile_group=tile_groups[g_idx])


def mesh_shape(mesh: Mesh) -> Tuple[int, int]:
    return mesh.n_gauss, mesh.n_tiles
