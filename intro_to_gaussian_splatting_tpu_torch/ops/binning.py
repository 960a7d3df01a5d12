"""Tile binning: gaussians -> per-tile contiguous, depth-ordered pair ranges.

  1. stable depth argsort of the gaussians, front to back, invalid last;
  2. per gaussian, its clamped tile span [tx0, tx1] x [ty0, ty1];
  3. exclusive prefix sum of pair counts -> each gaussian's slot offset;
     overflow drops WHOLE gaussians far-to-near, so per-tile ranges stay
     exact;
  4. every pair slot finds its gaussian's depth rank by binary search over
     the offsets and decodes its tile id;
  5. one stable sort by tile id groups the pairs per tile and keeps depth
     order within each tile;
  6. per-tile [start, count) and per-group starts by binary search of the
     sorted keys;
  7. gather the records into pair order, feature-major (16, MP), with
     means and bboxes in the owning tile's local pixel frame.

Steps 1-3 (per gaussian) run in the span ``order`` and steps 4-7 (per
pair slot) in the span ``pairs``, both inside the caller's ``bin``.

The gather's gradient sums each gaussian's pair gradients. PyTorch's own
indexing backward would scatter-add them with atomics on the card, in an
order that changes from run to run. In emission order each gaussian's
pairs are one contiguous block, and ``_GatherPairs``' backward sums each
block in a fixed order: on the card kernel G1 (csrc/segment_sums.cu) moves
the emitted pairs' gradients to emission order as 64-byte records and
sums each gaussian's contiguous run; on the CPU the plain version,
``gather_pairs_backward_reference``, does what the JAX package's
``_gather_pairs_fm`` VJP does: it puts the pair gradients back in emission
order and takes each block's sum as a difference of a two-level running
sum. Either way the gradient is the same bit for bit from run to run.

The pair pool is ``round_up(pairs_per_gaussian * N, chunk_size)`` slots plus
one trailing chunk of sentinel-keyed slots, as in the JAX package. Above 4M
slots the JAX package also rounds the pool up to whole gather slabs, a TPU
memory workaround this port does not copy, so there its ``MP`` may exceed
the port's by sentinel slots only; every emitted pair, range and count is
the same.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig
from intro_to_gaussian_splatting_tpu_torch.ops import projection as P
from intro_to_gaussian_splatting_tpu_torch.ops.cuda_build import (
    CudaKernel,
    KernelSource,
)
from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
    ProjectedGaussians,
    pack_records,
)
from intro_to_gaussian_splatting_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TileBins:
    pair_records: torch.Tensor  # (NUM_REC_ROWS, MP) f32, feature-major,
    #                             tile-grouped, means/bboxes TILE-LOCAL,
    #                             REC_TILE row = owning tile id
    pair_rank: torch.Tensor     # (MP,) int32 depth rank per pair
    pair_valid: torch.Tensor    # (MP,) bool
    tile_starts: torch.Tensor   # (NT,) int32 first pair of each tile
    tile_counts: torch.Tensor   # (NT,) int32
    group_starts: torch.Tensor  # (NG + 1,) int32 first pair of each group
    num_pairs: torch.Tensor     # () int32 total emitted pairs (pre-drop)
    overflowed: torch.Tensor    # () bool: num_pairs > max_pairs


# kernel G1, the gather's backward on the card (it only adds, so
# -fmad=false, which every kernel of the port takes, changes nothing)
SEGMENT_SUMS_SOURCE = KernelSource("segment_sums", ("-fmad=false",))
SEGMENT_SUMS = CudaKernel(SEGMENT_SUMS_SOURCE, "segment_sums", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
])
GRAD_ROWS_MASK = sum(1 << r for r in P.GRAD_ROWS)
MAX_SLOTS = 2 ** 31 - 32   # G1 indexes pair slots in 32 bits


def tile_grid(width: int, height: int, tile_size: int) -> Tuple[int, int]:
    return (-(-width // tile_size), -(-height // tile_size))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def num_groups_for(num_tiles: int, config: RasterizerConfig) -> int:
    """Tile-group count, padded to a whole number of ``groups_per_step``
    (the JAX package's layout; padded groups are empty and render zeros)."""
    ng = -(-num_tiles // config.group_tiles)
    gps = config.groups_per_step
    return -(-ng // gps) * gps



_CUM_BLOCK = 512


def _segment_sums(g_em: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Sums of the column blocks [lo[i], hi[i]) of ``g_em`` (F, MP): (F, N).

    A two-level running sum, as the JAX package's gather VJP takes it:
    inclusive sums inside blocks of 512 columns plus an exclusive sum of
    the block totals, so a segment inside one block sees only that block's
    rounding. Both scans run along the rows of 2-D tensors, which PyTorch
    scans one row per thread block in a fixed order (its 1-D float scan on
    the card is not run-to-run deterministic). The block sums are taken in
    float64: the card's scan groups a row's terms by the row's length, so
    in float32 a segment's rounding would depend on how many blocks the
    whole stream has (the pool's size), and the same pairs would sum
    differently in two pools.
    """
    f, mp = g_em.shape
    b = _CUM_BLOCK
    nb = -(-mp // b)
    gp = torch.nn.functional.pad(g_em, (0, (nb + 1) * b - mp))
    fine = torch.cumsum(gp.reshape(f * (nb + 1), b), dim=1).reshape(
        f, (nb + 1) * b)
    totals = fine[:, b - 1::b].double()                      # (F, NB+1)
    coarse = torch.cumsum(totals, dim=1) - totals            # exclusive

    def excl_at(idx):
        # the exclusive in-block prefix at column idx: 0 on a block
        # boundary, else the inclusive prefix at idx - 1
        v = fine[:, torch.clamp(idx - 1, min=0)]
        return torch.where((idx % b == 0)[None, :], 0.0, v)

    return ((coarse[:, hi // b] - coarse[:, lo // b])
            + (excl_at(hi) - excl_at(lo))).to(g_em.dtype)


class _GatherPairs(torch.autograd.Function):
    """records_rank (16, N) -> (16, MP) in sorted pair order, localized to
    each pair's tile; the backward sums pair gradients per gaussian."""

    @staticmethod
    def forward(ctx, records_rank, sorted_rank, perm, sorted_keys, valid,
                lo, hi, ntx, ts, total_emit):
        out = records_rank[:, sorted_rank]
        zero = torch.zeros((), dtype=sorted_keys.dtype,
                           device=sorted_keys.device)
        for rows, origin in (
                ((P.REC_MEAN_X, P.REC_MIN_X, P.REC_MAX_X), sorted_keys % ntx),
                ((P.REC_MEAN_Y, P.REC_MIN_Y, P.REC_MAX_Y),
                 sorted_keys // ntx)):
            shift = (torch.where(valid, origin, zero) * ts).to(torch.float32)
            for row in rows:
                out[row] -= shift
        out[P.REC_TILE] = sorted_keys.to(torch.float32)
        ctx.save_for_backward(perm, lo, hi)
        ctx.n = records_rank.shape[1]
        ctx.total_emit = total_emit
        return out

    @staticmethod
    def backward(ctx, g):
        perm, lo, hi = ctx.saved_tensors
        d = gather_pairs_backward(g.contiguous(), perm, lo, hi, ctx.n,
                                  ctx.total_emit)
        return d, None, None, None, None, None, None, None, None, None


def gather_pairs_backward_reference(g: torch.Tensor, perm: torch.Tensor,
                                    lo: torch.Tensor, hi: torch.Tensor,
                                    n: int) -> torch.Tensor:
    """The gather's gradient (16, N) from the records' (16, MP) gradient
    ``g`` in sorted-pair order: per gaussian the sums of its emission block
    [lo, hi) in the gradient rows, zeros in the others. The plain version
    of kernel G1, run on the CPU; on the card it is the library chain that
    G1 replaced."""
    # only these rows carry pair gradients back to the gaussians
    rows = torch.as_tensor(P.GRAD_ROWS, device=g.device)
    g_rows = g[rows]                                     # (10, MP)
    # back to emission order: sorted slot i came from emission slot
    # perm[i]; distinct targets, so the scatter is exact
    g_em = torch.empty_like(g_rows)
    g_em[:, perm] = g_rows
    del g_rows
    d = torch.zeros((P.NUM_REC_ROWS, n), dtype=g.dtype, device=g.device)
    d[rows] = _segment_sums(g_em, lo, hi)
    return d


def _gather_pairs_backward_cuda(g, perm, lo, hi, n, total_emit):
    dev = g.device
    mp = g.shape[1] if g.dim() == 2 else -1
    if (g.shape != (P.NUM_REC_ROWS, mp) or g.dtype != torch.float32
            or not g.is_contiguous()):
        raise ValueError(f"G1 takes a contiguous float32 ({P.NUM_REC_ROWS}, "
                         f"MP) gradient, got {g.dtype} {tuple(g.shape)}")
    for name, t, size in (("perm", perm, mp), ("lo", lo, n), ("hi", hi, n)):
        if (t.shape != (size,) or t.dtype != torch.int64
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous int64 ({size},) "
                             f"tensor on {dev}")
    if not 0 <= total_emit <= mp <= MAX_SLOTS:
        raise ValueError(f"G1 takes 0 <= total_emit <= MP <= {MAX_SLOTS}, "
                         f"got total_emit {total_emit}, MP {mp}")
    # each emitted pair's gradient as one 64-byte record, in emission order
    scratch = torch.empty((total_emit, 16), dtype=torch.float32, device=dev)
    d = torch.empty((P.NUM_REC_ROWS, n), dtype=torch.float32, device=dev)
    SEGMENT_SUMS.launch(
        g.data_ptr(), mp, perm.data_ptr(), lo.data_ptr(), hi.data_ptr(), n,
        total_emit, GRAD_ROWS_MASK, scratch.data_ptr(), d.data_ptr(),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    return d


def gather_pairs_backward(g: torch.Tensor, perm: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor, n: int,
                          total_emit: int) -> torch.Tensor:
    """``gather_pairs_backward_reference``'s function through kernel G1 for
    a gradient on the card, the plain version for one on the CPU.
    ``total_emit`` is the emitted prefix of the sorted pairs, which holds
    every block: perm[:total_emit] is a permutation of [0, total_emit)."""
    if g.is_cuda:
        return _gather_pairs_backward_cuda(g, perm, lo, hi, n, total_emit)
    return gather_pairs_backward_reference(g, perm, lo, hi, n)


def bin_gaussians(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    config: RasterizerConfig = RasterizerConfig(),
    max_pairs: Optional[int] = None,
) -> TileBins:
    ts = config.tile_size
    ntx, nty = tile_grid(width, height, ts)
    num_tiles = ntx * nty
    n = proj.depth.shape[0]
    dev = proj.depth.device
    i64 = torch.int64
    if max_pairs is None:
        max_pairs = config.pairs_per_gaussian * n
    max_pairs = round_up(max_pairs, config.chunk_size)
    mp_alloc = max_pairs + config.chunk_size   # + one sentinel chunk

    with span("order"):
        # 1. depth sort, invalid last
        depth_key = torch.where(proj.valid, proj.depth.detach(), float("inf"))
        order = torch.argsort(depth_key, stable=True)
        mean2d = proj.mean2d.detach()[order]
        radius = proj.radius.detach()[order]
        valid = proj.valid[order]

        min_x = torch.floor(mean2d[:, 0] - radius)
        max_x = torch.ceil(mean2d[:, 0] + radius)
        min_y = torch.floor(mean2d[:, 1] - radius)
        max_y = torch.ceil(mean2d[:, 1] + radius)

        # 2. tile spans; the reference's inclusive overlap test admits a bbox
        # touching the first pixel of the next tile
        if config.compat.inclusive_tile_overlap:
            tx0 = torch.ceil(min_x / ts).to(torch.int32) - 1
            ty0 = torch.ceil(min_y / ts).to(torch.int32) - 1
        else:
            tx0 = torch.floor(min_x / ts).to(torch.int32)
            ty0 = torch.floor(min_y / ts).to(torch.int32)
        tx1 = torch.floor(max_x / ts).to(torch.int32)
        ty1 = torch.floor(max_y / ts).to(torch.int32)
        # intersect with the grid; only the outward bound is clamped per side,
        # so a bbox fully off-screen gets span 0
        tx0 = torch.clamp(tx0, min=0).to(i64)
        ty0 = torch.clamp(ty0, min=0).to(i64)
        tx1 = torch.clamp(tx1, max=ntx - 1).to(i64)
        ty1 = torch.clamp(ty1, max=nty - 1).to(i64)
        span_x = torch.clamp(tx1 - tx0 + 1, 0, config.max_span)
        span_y = torch.clamp(ty1 - ty0 + 1, 0, config.max_span)
        counts = torch.where(valid, span_x * span_y, 0)

        # 3. slot offsets; the gaussians that fit entirely form a prefix of the
        # depth order, so the dropped set is a far-to-near suffix
        ends = torch.cumsum(counts, 0)                          # offsets[1:]
        starts = ends - counts                                  # offsets[:-1]
        total = ends[-1]
        full = ends <= max_pairs
        total_emit = int(torch.max(torch.where(full, ends, 0)))

    with span("pairs"):
        # 4. ragged expand: slot p belongs to depth rank #{i : ends[i] <= p}
        p = torch.arange(mp_alloc, dtype=i64, device=dev)
        rank = torch.clamp(torch.searchsorted(ends, p, right=True), 0, n - 1)
        k = p - starts[rank]
        sx_span = torch.clamp(span_x[rank], min=1)
        tile_id = (ty0[rank] + k // sx_span) * ntx + (tx0[rank] + k % sx_span)
        del k, sx_span
        gt = config.group_tiles
        num_groups = num_groups_for(num_tiles, config)
        # non-emitted slots take a sentinel key past every real tile and group
        sentinel = num_groups * gt
        tile_key = torch.where(p < total_emit, tile_id, sentinel)
        del tile_id, p

        # 5. stable sort by tile keeps depth order within each tile
        sorted_keys, perm = torch.sort(tile_key, stable=True)
        del tile_key
        sorted_rank = rank[perm]
        del rank
        pair_valid = sorted_keys < num_tiles

        # 6. per-tile and per-group ranges of the sorted stream
        tile_bounds = torch.searchsorted(
            sorted_keys, torch.arange(num_tiles + 1, dtype=i64, device=dev))
        tile_starts = tile_bounds[:-1]
        tile_counts = tile_bounds[1:] - tile_starts
        group_starts = torch.searchsorted(
            sorted_keys,
            torch.arange(num_groups + 1, dtype=i64, device=dev) * gt)

        # 7. gather records into pair order (differentiable), feature-major,
        # with means/bboxes in the owning tile's local frame
        records_rank = pack_records(proj)[:, order]             # (16, N)
        total_t = torch.as_tensor(total_emit, device=dev)
        lo = torch.minimum(starts, total_t)
        hi = torch.minimum(ends, total_t)
        pair_records = _GatherPairs.apply(records_rank, sorted_rank, perm,
                                          sorted_keys, pair_valid, lo, hi, ntx,
                                          ts, total_emit)
        del perm

    return TileBins(
        pair_records=pair_records,
        pair_rank=sorted_rank.to(torch.int32),
        pair_valid=pair_valid,
        tile_starts=tile_starts.to(torch.int32),
        tile_counts=tile_counts.to(torch.int32),
        group_starts=group_starts.to(torch.int32),
        num_pairs=total.to(torch.int32),
        overflowed=total > max_pairs,
    )
