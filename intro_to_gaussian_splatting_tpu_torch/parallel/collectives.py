"""The mesh's collectives inside the differentiated graph.

In JAX, ``shard_map`` differentiates ``ppermute`` and ``all_gather`` for
free: the transpose of a shift is the opposite shift, that of a tiled
all-gather a reduce-scatter. torch.distributed calls are not
differentiable, so each one that sits in the graph is an
``autograd.Function`` here whose backward is that transpose:

  * ``ring_shift``: every rank of the gauss group sends to the next and
    receives from the previous one (``ppermute`` with ``(i, i + 1)``);
  * ``next_strip_halo``: the first rows of the next strip, a shift along
    the tile axis and, for the column that wrapped, one along the gauss
    axis (JAX sharded.py:444-459). Its backward returns the halo's
    cotangent to the strip that owns those rows; without it the SSIM
    gradient at strip boundaries would be lost;
  * ``all_gather_rows``: the tiled all-gather of the ``ring=False`` path;
    its backward sums the cotangents over the gauss group and keeps this
    shard's rows.

On a group of one rank every shift is the identity (torch refuses a send
to oneself; the card only ever runs 1x1).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from intro_to_gaussian_splatting_tpu_torch.parallel.mesh import Mesh


def shift(x: torch.Tensor, ranks: List[int], pos: int, group,
          step: int) -> torch.Tensor:
    """Send ``x`` to ``ranks[(pos + step) % n]`` and return what
    ``ranks[(pos - step) % n]`` sent, every rank of ``ranks`` at once.
    ``ranks`` are global ranks (``P2POp``'s peers are global in torch 2.x)
    and ``pos`` is this rank's index in them."""
    n = len(ranks)
    if step % n == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(pos + step) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(pos - step) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, pos, group, step):
        ctx.args = (ranks, pos, group, -step)
        return shift(x, ranks, pos, group, step)

    @staticmethod
    def backward(ctx, g):
        return shift(g, *ctx.args), None, None, None, None


def _shift(x, ranks, pos, group, step):
    if len(ranks) == 1:
        return x
    return _Shift.apply(x, ranks, pos, group, step)


def ring_shift(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One hop of the gauss-axis ring: after it, gauss rank i holds what
    rank i - 1 held. The backward carries cotangents the other way."""
    return _shift(x, mesh.gauss_ranks, mesh.g_idx, mesh.gauss_group, 1)


def next_strip_halo(x: torch.Tensor, rows: int, mesh: Mesh) -> torch.Tensor:
    """The first ``rows`` rows of the next strip (index s + 1), delivered
    to strip s. The last strip receives the first strip's rows; callers
    mask them (their windows lie past the true image height)."""
    a = _shift(x[:rows], mesh.tile_ranks, mesh.t_idx, mesh.tile_group, -1)
    if mesh.t_idx == mesh.n_tiles - 1:
        # strip (g, T-1) needs rows of (g+1, 0): the last column's ranks
        # received them from (g, 0) above and pass them down the gauss axis
        a = _shift(a, mesh.gauss_ranks, mesh.g_idx, mesh.gauss_group, -1)
    return a


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = [torch.empty_like(x) for _ in range(mesh.n_gauss)]
        dist.all_gather(parts, x.contiguous(), group=mesh.gauss_group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.gauss_group)
        n = g.shape[0] // mesh.n_gauss
        return g[mesh.g_idx * n:(mesh.g_idx + 1) * n], None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every gauss shard's rows of ``x`` stacked in gauss order (the
    tiled ``all_gather`` along the first dimension)."""
    if mesh.n_gauss == 1:
        return x
    return _AllGatherRows.apply(x, mesh)
