"""One view, and one training step's loss and gradients, in plain PyTorch.

A view's comparison leaves out two kinds of tiles whose pixels a last-bit
difference between two float32 implementations can change as a whole:
the tiles whose pairs change (``binning.unsure_tiles``), and the tiles
whose image changes when two pairs of one tile whose depths lie within
``DEPTH_EPS`` of each other trade places (``order_unsure_tiles``): a
depth is a sum of terms of the scene's size (10-20 units), the two sides
round it differently by a few of its float32 steps (about 1e-6 each),
and a near tie can sort either way.
"""

from __future__ import annotations

import contextlib

import torch

from gsbench.reference import raster
from gsbench.reference.binning import bin_pairs, unsure_tiles
from gsbench.reference.loss import photometric
from gsbench.reference.projection import project

# scene units: about ten float32 roundings of a depth
DEPTH_EPS = 1e-5
# a tile counts as changed where a pixel moves by more than this
CHANGE_EPS = 1e-5


@contextlib.contextmanager
def float32_only():
    """TF32 off for matrix products and convolutions (by default cuDNN
    may use it), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def pair_records(proj: dict, pairs, ts: int) -> torch.Tensor:
    """(9, P) records of the pairs, means in each pair's tile frame."""
    g = pairs.gauss
    mean2d = proj["mean2d"].detach()
    ox = ((pairs.tile % pairs.ntx) * ts).to(torch.float32)
    oy = ((pairs.tile // pairs.ntx) * ts).to(torch.float32)
    rows = [mean2d[g, 0] - ox, mean2d[g, 1] - oy]
    rows += [proj["conic"].detach()[g, i] for i in range(3)]
    rows += [proj["opacity"].detach()[g]]
    rows += [proj["colour"].detach()[g, i] for i in range(3)]
    return torch.stack(rows)


def order_unsure_tiles(proj: dict, pairs, rec: torch.Tensor,
                       tiles: torch.Tensor, rast: dict) -> torch.Tensor:
    """(nty, ntx) bool: the tiles whose composite ``tiles`` (3, NT, ts*ts)
    changes when each pair of neighbours in a tile's depth order whose
    depths lie within ``DEPTH_EPS`` of each other trade places."""
    grid = torch.zeros(pairs.ntx * pairs.nty, dtype=torch.bool,
                       device=rec.device)
    d = proj["depth"].detach()[pairs.gauss]
    close = (pairs.tile[1:] == pairs.tile[:-1]) & (
        (d[1:] - d[:-1]).abs() <= DEPTH_EPS)
    i = torch.nonzero(close).flatten()
    if i.numel() == 0:
        return grid.reshape(pairs.nty, pairs.ntx)
    # swap disjoint neighbours: in a run of near ties, every other one
    i = i[torch.cat([i.new_ones(1, dtype=torch.bool), i[1:] != i[:-1] + 1])]
    perm = torch.arange(rec.shape[1], device=rec.device)
    perm[i], perm[i + 1] = i + 1, i
    # composite the tiles that hold a swap, alone
    t = torch.unique(pairs.tile[i])
    counts, starts = pairs.tile_counts[t], pairs.tile_starts[t]
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(int(counts.sum()), device=rec.device)
    idx = torch.repeat_interleave(starts - first, counts) + k
    swapped, _ = raster.composite(rec[:, perm[idx]], first, counts, rast)
    moved = (swapped - tiles[:, t]).abs().amax(dim=(0, 2)) > CHANGE_EPS
    grid[t[moved]] = True
    return grid.reshape(pairs.nty, pairs.ntx)


def render_view(params: dict, active: torch.Tensor, cam, rast: dict,
                sh_degree: int, precision: str = "float32"):
    """(H, W, 3) image of one view, the work counts of its compositing
    (``evaluations``, ``pairs_read``, ``pairs``, ``nonempty_tiles``) and
    the (H, W) mask of the pixels outside ``unsure_tiles``."""
    ts = rast["tile_size"]
    with torch.no_grad(), float32_only():
        proj = project(params, active, cam, rast, sh_degree, precision)
        pairs = bin_pairs(proj, cam.width, cam.height, rast)
        rec = pair_records(proj, pairs, ts)
        tiles, counts = raster.composite(rec, pairs.tile_starts,
                                         pairs.tile_counts, rast)
        img = raster.tiles_to_image(tiles, pairs.ntx, pairs.nty, ts,
                                    cam.height, cam.width)
        window = unsure_tiles(proj, cam, rast)
        order = order_unsure_tiles(proj, pairs, rec, tiles, rast)
        unsure = window | order
        sure = ~unsure.repeat_interleave(ts, 0).repeat_interleave(ts, 1)[
            :cam.height, :cam.width]
    counts.update(unsure_window_tiles=int(window.sum()),
                  unsure_order_tiles=int(order.sum()),
                  pairs=int(pairs.gauss.shape[0]),
                  nonempty_tiles=int((pairs.tile_counts > 0).sum()),
                  visible=int(proj["valid"].sum()))
    return img.permute(1, 2, 0), counts, sure


def loss_and_grads(params: dict, active: torch.Tensor, cam, target_chw,
                   rast: dict, ssim_weight: float, sh_degree: int,
                   precision: str = "float32"):
    """(loss, grads, screen_grads, visible) of one camera: ``grads`` per
    parameter, ``screen_grads`` (N, 2) the gradient with respect to the
    pixel position of each gaussian."""
    ts = rast["tile_size"]
    with float32_only():
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        proj = project(leaves, active, cam, rast, sh_degree, precision)
        pairs = bin_pairs(proj, cam.width, cam.height, rast)
        rec = pair_records(proj, pairs, ts)
        tiles, _ = raster.composite(rec, pairs.tile_starts,
                                    pairs.tile_counts, rast)
        img = raster.tiles_to_image(tiles, pairs.ntx, pairs.nty, ts,
                                    cam.height, cam.width)
        x = img.detach().requires_grad_(True)
        loss = photometric(x, target_chw, ssim_weight, precision)
        g_img, = torch.autograd.grad(loss, x)
        g_tiles = raster.image_to_tiles(g_img, pairs.ntx, pairs.nty, ts)
        drec = raster.composite_backward(rec, pairs.tile_starts,
                                         pairs.tile_counts, tiles, g_tiles,
                                         rast)
        # each gaussian's sum over its pairs, in float64
        n = params["means"].shape[0]
        per_g = torch.zeros((raster.NUM_ROWS, n), dtype=torch.float64,
                            device=drec.device)
        per_g.index_add_(1, pairs.gauss, drec.double())
        per_g = per_g.float()
        outs = [proj["mean2d"], proj["conic"], proj["opacity"],
                proj["colour"]]
        grads_out = [per_g[[raster.MX, raster.MY]].T,
                     per_g[[raster.CA, raster.CB, raster.CC]].T,
                     per_g[raster.OP],
                     per_g[[raster.R, raster.G, raster.B]].T]
        grads = torch.autograd.grad(outs, [leaves[k] for k in params],
                                    grads_out, allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(params, grads)}
    return (float(loss.detach()), grads, grads_out[0].contiguous(),
            proj["valid"].clone())
