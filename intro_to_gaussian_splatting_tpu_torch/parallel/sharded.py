"""Rendering and training over a device mesh (the JAX package's
parallel/sharded.py).

Decomposition, as in the JAX package:

  * the gaussians are sharded over the "gauss" axis; each rank projects
    its shard and packs its records;
  * the image's tile rows are split into one strip per rank, strip
    ``g_idx * t + t_idx``; each rank rasterizes its strip with the same
    kernels as one card (B1 forward, B2 backward, through
    ``rasterize_pairs``);
  * records reach the strip owners one of two ways:
      - ``ring=True`` (default): a ring over the gauss group
        (``collectives.ring_shift``). Each rank holds one projected shard
        in flight, takes the (tile, record) pairs of that shard that fall
        in its strip, and passes the shard on; after ``g`` hops every
        shard has visited every strip of the group. One stable
        (tile, depth, emission index) sort restores the exact compositing
        order, so arrival order never matters;
      - ``ring=False``: an all-gather of the projections along the gauss
        axis and the single-card binning (the ring's oracle).
  * the loss is the single-card objective: per-strip numerators over
    global denominators, SSIM windows crossing strip boundaries through
    ``next_strip_halo``.

Where the JAX package differentiates a ``shard_map``, this module calls
``torch.autograd.grad`` on each rank and sums over the tile group:

  * the loss is replicated (an all-reduce of every strip's numerator and
    denominator). Each rank differentiates only its own numerator over
    the global denominator, which carries no gradient: calling backward
    on the all-reduced value through a differentiable all-reduce would
    give every gradient ``world_size`` times over;
  * the ring's and the halo's backwards carry each strip's cotangents to
    the rank that holds the gaussians or the rows they came from;
  * a shard is replicated over the tile axis, so its gradients (and the
    densify probe's) are summed over the tile group, the transpose of the
    replicated input in JAX. The all-reduce gives every replica the same
    bits, so their Adam updates stay equal.

The pair stream is the port's rasterizer interface: records with means
and bounding boxes in the owning tile's frame and per-tile
``tile_starts`` / ``tile_counts`` (JAX hands its kernel ``group_starts``).
Every gather in the graph has a deterministic backward: the slab gather
sums each gaussian's pair gradients as ``_GatherPairs`` does (not an
atomic scatter-add), and the sort's is a scatter to distinct slots.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from intro_to_gaussian_splatting_tpu_torch.config import (
    RasterizerConfig,
    TrainConfig,
)
from intro_to_gaussian_splatting_tpu_torch.models.camera import (
    CAMERA_TENSORS,
    Camera,
)
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianModel,
)
from intro_to_gaussian_splatting_tpu_torch.ops import projection as P
from intro_to_gaussian_splatting_tpu_torch.ops.binning import (
    _segment_sums,
    bin_gaussians,
    num_groups_for,
    round_up,
    tile_grid,
)
from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
    ProjectedGaussians,
    pack_records,
    project_gaussians,
)
from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import (
    rasterize_pairs,
    untile,
)
from intro_to_gaussian_splatting_tpu_torch.parallel.collectives import (
    all_gather_rows,
    next_strip_halo,
    ring_shift,
)
from intro_to_gaussian_splatting_tpu_torch.parallel.mesh import Mesh
from intro_to_gaussian_splatting_tpu_torch.train import densify as D
from intro_to_gaussian_splatting_tpu_torch.train.loss import WINDOW, ssim_chw

_RING_DEPTH_BUCKETS = 1024


def strip_layout(height: int, tile_size: int,
                 n_strips: int) -> Tuple[int, int]:
    """Rows are padded so that each rank owns an equal strip of whole
    tiles. Returns (strip_rows, padded_height)."""
    nty = -(-height // tile_size)
    nty_pad = -(-nty // n_strips) * n_strips
    strip_rows = (nty_pad // n_strips) * tile_size
    return strip_rows, strip_rows * n_strips


def pad_rows(image: torch.Tensor, padded_height: int) -> torch.Tensor:
    """Zero rows appended to reach ``padded_height``."""
    pad = [0, 0] * (image.dim() - 1) + [0, padded_height - image.shape[0]]
    return torch.nn.functional.pad(image, pad)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's gauss shard of a capacity-leading tensor."""
    n = x.shape[0] // mesh.n_gauss
    return x[mesh.g_idx * n:(mesh.g_idx + 1) * n]


def shard_model(model: GaussianModel, mesh: Mesh) -> GaussianModel:
    """This rank's gauss shard of a model every rank holds whole, on the
    mesh's device (the capacity must divide by the gauss axis)."""
    if model.capacity % mesh.n_gauss:
        raise ValueError(f"capacity {model.capacity} not divisible by the "
                         f"gauss axis {mesh.n_gauss}")

    def part(x):
        return shard_rows(x.detach(), mesh).to(mesh.device).clone()

    return GaussianModel(**{n: part(getattr(model, n)) for n in PARAM_NAMES},
                         active=part(model.active),
                         color_space=model.color_space)


def camera_on(camera: Camera, device: torch.device) -> Camera:
    return dataclasses.replace(camera, **{
        n: getattr(camera, n).to(device) for n in CAMERA_TENSORS})


def ring_max_pairs(capacity: int, n_strips: int,
                   rcfg: RasterizerConfig) -> int:
    """Default per-strip pair budget of the ring: the single-card budget
    (pairs_per_gaussian * N) split across strips, with 2x slack for
    uneven tile occupancy, rounded to whole chunks."""
    per = 2 * rcfg.pairs_per_gaussian * capacity // max(n_strips, 1)
    return round_up(max(per, rcfg.chunk_size), rcfg.chunk_size)


def ring_hop_pairs(max_pairs_local: int, g_size: int,
                   rcfg: RasterizerConfig) -> int:
    """Default cap on the pairs one shard may add to a strip in one hop:
    about 4x the balanced share of the strip's budget (the full budget on
    small gauss axes). A shard skewed beyond it loses that hop's farthest
    gaussians and raises ``overflowed``, even when the strip's total fits;
    the Trainer then doubles the pool, and the cap with it (JAX
    sharded.py:120-140)."""
    h = min(max_pairs_local,
            max(4 * max_pairs_local // max(g_size, 1), 2 * rcfg.chunk_size))
    return round_up(h, rcfg.chunk_size)


def _tile_spans(bb: torch.Tensor, ts: int, inclusive: bool):
    """Tile-index bounds of bbox record rows, the rule of bin_gaussians
    step 2, un-clamped, in global tile coordinates (int64)."""
    min_x, max_x = bb[P.REC_MIN_X], bb[P.REC_MAX_X]
    min_y, max_y = bb[P.REC_MIN_Y], bb[P.REC_MAX_Y]
    if inclusive:
        tx0 = torch.ceil(min_x / ts).to(torch.int32) - 1
        ty0 = torch.ceil(min_y / ts).to(torch.int32) - 1
    else:
        tx0 = torch.floor(min_x / ts).to(torch.int32)
        ty0 = torch.floor(min_y / ts).to(torch.int32)
    tx1 = torch.floor(max_x / ts).to(torch.int32)
    ty1 = torch.floor(max_y / ts).to(torch.int32)
    return (t.to(torch.int64) for t in (tx0, tx1, ty0, ty1))


class _GatherSlab(torch.autograd.Function):
    """One hop's emitted pairs, ``rec[:, src]``, in emission order. The
    pairs of shard column i are the contiguous block [lo[i], hi[i]), so
    the backward is ``_segment_sums`` of the gradient rows."""

    @staticmethod
    def forward(ctx, rec, src, lo, hi):
        ctx.save_for_backward(lo, hi)
        ctx.n = rec.shape[1]
        return rec[:, src]

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.saved_tensors
        rows = list(P.GRAD_ROWS)
        d = torch.zeros((P.NUM_REC_ROWS, ctx.n), dtype=g.dtype,
                        device=g.device)
        d[rows] = _segment_sums(g[rows], lo, hi)
        return d, None, None, None


class _SortPairs(torch.autograd.Function):
    """The emitted pairs in (tile, depth, emission) order, means and
    bboxes moved into the owning tile's frame (x: the tile column; y: the
    strip's first image row plus the tile row, as JAX sharded.py:309-323)
    and the tile id in its row. The backward scatters to distinct slots."""

    @staticmethod
    def forward(ctx, buf, perm, sorted_key, ntx, ts, row0):
        ctx.save_for_backward(perm)
        out = buf[:, perm]
        sx = ((sorted_key % ntx) * ts).to(torch.float32)
        sy = (row0 + (sorted_key // ntx) * ts).to(torch.float32)
        for rows, shift in (((P.REC_MEAN_X, P.REC_MIN_X, P.REC_MAX_X), sx),
                            ((P.REC_MEAN_Y, P.REC_MIN_Y, P.REC_MAX_Y), sy)):
            for row in rows:
                out[row] -= shift
        out[P.REC_TILE] = sorted_key.to(torch.float32)
        return out

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        d = torch.empty_like(g)
        d[:, perm] = g
        d[P.REC_TILE] = 0.0
        return d, None, None, None, None, None


@dataclasses.dataclass(frozen=True)
class StripPairs:
    """The pair stream of one strip, in the rasterizer's interface."""

    records: torch.Tensor      # (16, E) f32, tile-grouped, tile-local
    tile_starts: torch.Tensor  # (NT,) int32
    tile_counts: torch.Tensor  # (NT,) int32
    overflowed: torch.Tensor   # () bool
    demand: torch.Tensor       # () pairs this strip wanted
    emitted: torch.Tensor      # () pairs it admitted
    bytes_moved: float         # records this rank sent to strip owners


def _ring_bin_strip(proj: ProjectedGaussians, width: int, strip_rows: int,
                    rcfg: RasterizerConfig, mesh: Mesh,
                    max_pairs_local: int) -> StripPairs:
    """The ring: this rank's strip pairs from every shard of its gauss
    group (JAX ``_ring_bin_strip``, sharded.py:160-341).

    Overflow policy, as the single-card pool's up to one depth bucket:
    pass 1 sums per-strip depth-bucket histograms of the demand over the
    gauss group, and this strip admits the nearest buckets whose total
    fits ``max_pairs_local`` (at least one). Pass 2 is the ring: ``g`` hops
    of emission, each capped at ``ring_hop_pairs``, with a shift between
    hops; a hop emits its shard's pairs in depth order (JAX: in slot
    order), so a capped hop drops far to near. Only emitted pairs are
    stored, so the buffers are as long as the strip's pairs.
    """
    ts = rcfg.tile_size
    ntx, nty_local = tile_grid(width, strip_rows, ts)
    num_tiles = ntx * nty_local
    mp = max_pairs_local
    g_size = mesh.n_gauss
    n_strips = mesh.size
    hop = ring_hop_pairs(mp, g_size, rcfg)
    strip = mesh.rank
    row0 = strip * strip_rows
    ty_lo = strip * nty_local
    inclusive = rcfg.compat.inclusive_tile_overlap
    i64 = torch.int64

    rec0 = pack_records(proj)                      # (16, Ns), global pixels
    valid0 = proj.valid
    dev = rec0.device
    ns = rec0.shape[1]

    # ---- pass 1 (no ring): the global far-tail admission ----------------
    nb = _RING_DEPTH_BUCKETS
    depth0 = rec0[P.REC_DEPTH].detach()
    lims = torch.stack([
        -torch.min(torch.where(valid0, depth0, float("inf"))),
        torch.max(torch.where(valid0, depth0, -float("inf")))])
    if g_size > 1:
        dist.all_reduce(lims, op=dist.ReduceOp.MAX, group=mesh.gauss_group)
    dmin, dmax = -lims[0], lims[1]
    dscale = nb / torch.clamp(dmax - dmin, min=1e-12)

    def bucket_of(d):
        return torch.clamp(((d - dmin) * dscale).to(torch.int32), 0,
                           nb - 1).to(i64)

    bb0 = rec0.detach()
    tx0, tx1, ty0, ty1 = _tile_spans(bb0, ts, inclusive)
    span_x0 = torch.clamp(torch.clamp(tx1, max=ntx - 1)
                          - torch.clamp(tx0, min=0) + 1, 0, rcfg.max_span)
    top = (torch.arange(n_strips, device=dev) * nty_local)[:, None]
    rows = torch.clamp(torch.minimum(ty1[None], top + nty_local - 1)
                       - torch.maximum(ty0[None], top) + 1, 0, rcfg.max_span)
    demand0 = torch.where(valid0[None], span_x0[None] * rows, 0)   # (S, Ns)
    hist = torch.zeros((n_strips, nb), dtype=i64, device=dev).scatter_add_(
        1, bucket_of(depth0)[None].expand(n_strips, -1), demand0)
    if g_size > 1:
        dist.all_reduce(hist, group=mesh.gauss_group)
    # the nearest buckets whose total fits the budget; at least one, so a
    # single overfull bucket degrades to the hop cap below
    bstar = torch.clamp((torch.cumsum(hist[strip], 0) <= mp).sum(), min=1)

    # ---- pass 2: the ring ----------------------------------------------
    # the shard travels with its valid flags as a 17th row
    x = torch.cat([rec0, valid0.to(rec0.dtype)[None]])
    slabs, keys = [], []
    base, total, hop_ovf = 0, 0, False
    for h in range(g_size):
        if h:
            x = ring_shift(x, mesh)          # now shard g_idx - h
        rec, valid = x[:P.NUM_REC_ROWS], x[P.NUM_REC_ROWS] > 0.5
        bb = rec.detach()
        tx0, tx1, ty0, ty1 = _tile_spans(bb, ts, inclusive)
        tx0 = torch.clamp(tx0, min=0)
        ty0 = torch.clamp(ty0, min=ty_lo) - ty_lo         # strip-local rows
        tx1 = torch.clamp(tx1, max=ntx - 1)
        ty1 = torch.clamp(ty1, max=ty_lo + nty_local - 1) - ty_lo
        span_x = torch.clamp(tx1 - tx0 + 1, 0, rcfg.max_span)
        span_y = torch.clamp(ty1 - ty0 + 1, 0, rcfg.max_span)
        demand = torch.where(valid, span_x * span_y, 0)
        counts = torch.where(bucket_of(bb[P.REC_DEPTH]) < bstar, demand, 0)
        # emission in the shard's depth order, invalid last (binning step
        # 1): on one rank the pair stream, and the rounding of every
        # gaussian's gradient sum, are the single card's; a capped hop
        # keeps its nearest gaussians
        order = torch.argsort(torch.where(valid, bb[P.REC_DEPTH],
                                          float("inf")), stable=True)
        ends = torch.cumsum(counts[order], 0)
        starts = ends - counts[order]
        # whole gaussians, against the hop cap and the budget left
        cap = min(hop, mp - base)
        emit_t = torch.max(torch.where(ends <= cap, ends, 0))
        emit, wanted, d = torch.stack(
            [emit_t, ends[-1], demand.sum()]).tolist()
        hop_ovf = hop_ovf or emit < wanted
        total += d
        # the ragged expand (binning step 4) over the emitted pairs only
        p = torch.arange(emit, dtype=i64, device=dev)
        rank = torch.clamp(torch.searchsorted(ends, p, right=True),
                           max=ns - 1)
        k = p - starts[rank]
        src = order[rank]
        sx = torch.clamp(span_x[src], min=1)
        keys.append((ty0[src] + k // sx) * ntx + (tx0[src] + k % sx))
        del p, k, sx, rank
        # each shard column's block of the slab, by column
        emit_c = torch.as_tensor(emit, device=dev)
        lo, hi = torch.empty_like(starts), torch.empty_like(ends)
        lo[order] = torch.minimum(starts, emit_c)
        hi[order] = torch.minimum(ends, emit_c)
        slabs.append(_GatherSlab.apply(rec, src, lo, hi))
        base += emit
    buf = torch.cat(slabs, dim=1) if g_size > 1 else slabs[0]
    key = torch.cat(keys) if g_size > 1 else keys[0]
    del slabs, keys

    # two stable sorts: (tile, depth, emission index)
    by_depth = torch.argsort(buf[P.REC_DEPTH].detach(), stable=True)
    perm = by_depth[torch.argsort(key[by_depth], stable=True)]
    del by_depth
    sorted_key = key[perm]
    records = _SortPairs.apply(buf, perm, sorted_key, ntx, ts, row0)
    bounds = torch.searchsorted(
        sorted_key, torch.arange(num_tiles + 1, dtype=i64, device=dev))
    return StripPairs(
        records=records,
        tile_starts=bounds[:-1].to(torch.int32),
        tile_counts=(bounds[1:] - bounds[:-1]).to(torch.int32),
        overflowed=torch.as_tensor(total > mp or hop_ovf, device=dev),
        demand=torch.as_tensor(total, device=dev),
        emitted=torch.as_tensor(base, device=dev),
        # the shard and its valid row, once to the next rank per hop
        bytes_moved=float(4 * (P.NUM_REC_ROWS + 1) * ns * (g_size - 1)))


# ProjectedGaussians fields the all-gather path moves, and their widths
_PROJ_FIELDS = (("mean2d", 2), ("depth", 1), ("conic", 3), ("radius", 1),
                ("color", 3), ("opacity", 1), ("valid", 1))


def _gathered_strip_pairs(proj: ProjectedGaussians, width: int,
                          strip_rows: int, rcfg: RasterizerConfig,
                          mesh: Mesh) -> StripPairs:
    """``ring=False``: all-gather the projections along the gauss axis,
    move them into this strip's pixel rows and bin them as one card does
    (JAX sharded.py:370-393)."""
    cols = []
    for name, _ in _PROJ_FIELDS:
        t = getattr(proj, name)
        if name in ("radius", "valid"):
            t = t.detach().to(torch.float32)
        cols.append(t.reshape(t.shape[0], -1))
    full = all_gather_rows(torch.cat(cols, dim=1), mesh)
    parts, i = {}, 0
    for name, w in _PROJ_FIELDS:
        parts[name] = full[:, i:i + w] if w > 1 else full[:, i]
        i += w
    parts["valid"] = parts["valid"] > 0.5
    row0 = float(mesh.rank * strip_rows)
    parts["mean2d"] = parts["mean2d"] - torch.tensor(
        [0.0, row0], device=full.device)
    bins = bin_gaussians(ProjectedGaussians(**parts), width, strip_rows, rcfg)
    mp_alloc = bins.pair_records.shape[1]
    return StripPairs(
        records=bins.pair_records, tile_starts=bins.tile_starts,
        tile_counts=bins.tile_counts, overflowed=bins.overflowed,
        demand=bins.num_pairs,
        emitted=torch.clamp(bins.num_pairs, max=mp_alloc),
        # every shard's projections reach every other rank of the group
        bytes_moved=float(4 * full.shape[1] * proj.depth.shape[0]
                          * (mesh.n_gauss - 1)))


def _render_strip(model_shard: GaussianModel, camera: Camera,
                  rcfg: RasterizerConfig, strip_rows: int, mesh: Mesh,
                  active_sh_degree: Optional[int] = None, ring: bool = True,
                  max_pairs_local: Optional[int] = None,
                  mean2d_offset: Optional[torch.Tensor] = None):
    """Project this rank's shard, route the records to the strip owners
    and rasterize this rank's strip (B1; B2 in the backward). Returns
    ((strip_rows, W, 5) channels, the strip's pairs, the shard's
    visibility). ``max_pairs_local`` overrides the ring's per-strip pair
    budget (``ring_max_pairs``); over budget, whole gaussians drop far to
    near by global depth, as on one card."""
    w = camera.width
    ts = rcfg.tile_size
    ntx, nty_local = tile_grid(w, strip_rows, ts)
    num_groups = num_groups_for(ntx * nty_local, rcfg)
    proj = project_gaussians(model_shard, camera, rcfg, active_sh_degree,
                             mean2d_offset)
    if ring:
        if max_pairs_local is None:
            max_pairs_local = ring_max_pairs(
                model_shard.capacity * mesh.n_gauss, mesh.size, rcfg)
        pairs = _ring_bin_strip(proj, w, strip_rows, rcfg, mesh,
                                max_pairs_local)
    else:
        pairs = _gathered_strip_pairs(proj, w, strip_rows, rcfg, mesh)
    tile_out = rasterize_pairs(pairs.records, pairs.tile_starts,
                               pairs.tile_counts, num_groups, rcfg)
    strip = untile(tile_out, ntx, nty_local, ts, strip_rows, w)
    return strip, pairs, proj.valid.detach()


def sharded_render(model_shard: GaussianModel, camera: Camera, mesh: Mesh,
                   rcfg: RasterizerConfig = RasterizerConfig(),
                   active_sh_degree: Optional[int] = None,
                   ring: bool = True) -> torch.Tensor:
    """The (H, W, 3) image on every rank: each renders its strip, and the
    strips are all-gathered in strip order."""
    strip_rows, _ = strip_layout(camera.height, rcfg.tile_size, mesh.size)
    with torch.no_grad():
        strip, _, _ = _render_strip(model_shard, camera, rcfg, strip_rows,
                                    mesh, active_sh_degree, ring)
        strip = strip[..., :3].contiguous()
        if mesh.size == 1:
            return strip[:camera.height]
        strips = [torch.empty_like(strip) for _ in range(mesh.size)]
        dist.all_gather(strips, strip)
    return torch.cat(strips)[:camera.height]


def sharded_loss_and_grads(model_shard: GaussianModel, camera: Camera,
                           target_strip: torch.Tensor, mesh: Mesh,
                           rcfg: RasterizerConfig, ssim_weight: float,
                           active_sh_degree: Optional[int] = None,
                           ring: bool = True):
    """The single-card objective (1-w)·L1 + w·(1-SSIM) of the whole image
    and this shard's gradients: (loss, grads, aux).

    ``target_strip`` is this rank's (strip_rows, W, 3) rows of the target,
    zero past the image (``process_local_rows``). ``loss`` is the same on
    every rank; ``grads`` holds one tensor per parameter and ``"probe"``,
    the shard's (N/g, 2) screen-space gradient, each summed over the
    tile group. Per-strip sums are combined as global (numerator,
    denominator) pairs, so padding rows and partial SSIM window rows carry
    their true weight (JAX sharded.py:462-546). The SSIM is the plain
    ``ssim_chw`` map (B3 and B4 are not on this path); only the windows
    that start in this strip count.
    """
    height, width = camera.height, camera.width
    strip_rows, _ = strip_layout(height, rcfg.tile_size, mesh.size)
    win = WINDOW
    if strip_rows < win - 1:
        raise ValueError(f"strips of {strip_rows} rows are thinner than "
                         f"the SSIM halo ({win - 1} rows)")
    dev = mesh.device
    probe = torch.zeros((model_shard.capacity, 2), dtype=torch.float32,
                        device=dev, requires_grad=True)
    strip, pairs, visible = _render_strip(
        model_shard, camera, rcfg, strip_rows, mesh, active_sh_degree, ring,
        mean2d_offset=probe)
    row0 = mesh.rank * strip_rows
    row = torch.arange(strip_rows, device=dev) + row0
    mask = (row < height).to(torch.float32)[:, None, None]
    pred = strip[..., :3] * mask
    target = target_strip * mask
    l1_num = torch.sum(torch.abs(pred - target))
    # every strip's sums, all-reduced in one call; the numerators are
    # values here, only this strip's own are differentiated below
    local = dict(l1_num=l1_num.detach(),
                 l1_den=torch.sum(mask) * width * 3.0,
                 sq_num=torch.sum((pred - target) ** 2).detach())
    if ssim_weight > 0.0:
        ext_p = torch.cat([pred, next_strip_halo(pred, win - 1, mesh)])
        ext_t = torch.cat([target, next_strip_halo(target, win - 1, mesh)])
        smap = ssim_chw(ext_p.permute(2, 0, 1), ext_t.permute(2, 0, 1),
                        window=win, reduce=False)   # (3, strip_rows, W-10)
        # each of the image's height - win + 1 window rows is counted by
        # the strip it starts in
        wrow = (row < height - win + 1).to(torch.float32)[None, :, None]
        s_num = torch.sum(smap * wrow)
        local.update(s_num=s_num.detach(),
                     s_den=torch.sum(wrow) * smap.shape[0] * smap.shape[2])
    local.update(overflowed=pairs.overflowed, active=model_shard.active.sum(),
                 demand=pairs.demand, emitted=pairs.emitted)
    sums = torch.stack([v.to(torch.float64) for v in local.values()])
    if mesh.size > 1:
        dist.all_reduce(sums)
    total = dict(zip(local, sums))
    l1_den = float(total["l1_den"])
    loss = total["l1_num"] / l1_den
    # this strip's numerators over the global denominators: the sum over
    # ranks of these objectives is the loss, so its gradient is not
    # multiplied by the world size
    objective = l1_num * ((1.0 - ssim_weight) / l1_den)
    if ssim_weight > 0.0:
        s_den = float(total["s_den"])
        loss = ((1.0 - ssim_weight) * loss
                + ssim_weight * (1.0 - total["s_num"] / s_den))
        objective = objective - s_num * (ssim_weight / s_den)
    inputs = [getattr(model_shard, n) for n in PARAM_NAMES] + [probe]
    grads = torch.autograd.grad(objective, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    if mesh.n_tiles > 1:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.tile_group)
        grads = [f.view_as(g) for f, g in zip(
            torch.split(flat, [g.numel() for g in grads]), grads)]
    bytes_moved = torch.tensor([pairs.bytes_moved], dtype=torch.float64,
                               device=dev)
    if mesh.size > 1:
        dist.all_reduce(bytes_moved, op=dist.ReduceOp.MAX)
    aux = dict(
        overflowed=total["overflowed"] > 0.0,
        visible=visible,
        psnr=-10.0 * torch.log10(torch.clamp(total["sq_num"] / l1_den,
                                             min=1e-12)),
        num_active=total["active"] / mesh.n_tiles,
        # global ring accounting: pair demand and admission summed over
        # strips; the bytes a rank sends to route records (the most of any
        # rank; a training step moves about twice this, the backward
        # carrying cotangents back)
        ring_demand=total["demand"],
        ring_emitted=total["emitted"],
        ring_bytes_per_device=bytes_moved[0],
    )
    return (loss.to(torch.float32), dict(zip(PARAM_NAMES + ("probe",), grads)),
            aux)


def sharded_train_step(model: GaussianModel, opt_state, dstate: D.DensifyState,
                       camera: Camera, target_strip: torch.Tensor, mesh: Mesh,
                       rcfg: RasterizerConfig, tcfg: TrainConfig, tx,
                       active_sh_degree: int = 0, ring: bool = True):
    """One optimization step of this rank's shard, the full 3DGS recipe
    (the probe gradients feed ``dstate``, as ``train_step``'s do). The
    model's parameters are updated in place. Returns
    (model, opt_state, dstate, metrics); the metrics are replicated."""
    loss, grads, aux = sharded_loss_and_grads(
        model, camera, target_strip, mesh, rcfg, tcfg.ssim_weight,
        active_sh_degree, ring)
    probe = grads.pop("probe")
    opt_state = tx.step(model, grads, opt_state)
    dstate = D.accumulate(dstate, probe, aux["visible"])
    metrics = dict(loss=loss, psnr=aux["psnr"],
                   num_active=aux["num_active"],
                   overflowed=aux["overflowed"],
                   ring_demand=aux["ring_demand"],
                   ring_emitted=aux["ring_emitted"],
                   ring_bytes_per_device=aux["ring_bytes_per_device"])
    return model, opt_state, dstate, metrics
