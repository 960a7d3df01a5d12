"""Splats -> (tile, depth)-sorted pairs, in plain PyTorch.

A valid gaussian covers the tiles its pixel box [floor(x - r), ceil(x + r)]
x [floor(y - r), ceil(y + r)] overlaps, at most ``max_span`` tiles along
each axis from the first, clipped to the grid. Pairs are ordered by tile,
and within a tile front to back by depth (ties by slot). Nothing is
dropped: the configurations size the program's pair pool to hold every
pair, and a program that drops some renders another image.

Which tiles a gaussian covers is a discontinuous function of its position
and radius: a rounding of the last bit that carries ``floor`` or ``ceil``
over an integer moves an edge of the box by a pixel, and where the box
crosses a tile border, or the span is cut to ``max_span``, the gaussian
enters or leaves a whole row or column of tiles. Two float32
implementations of the same projection differ in those bits. So
``unsure_tiles`` marks the tiles whose pairs would change under a
perturbation of each gaussian's camera-space position by ``WORLD_EPS``
(about ten float32 roundings of the scene's coordinates), carried to the
pixel position (plus ``PIXEL_EPS``), and of its unrounded radius by
``RELATIVE_EPS`` plus the rounding of its eigenvalue; an image
comparison leaves those tiles out. The radius is 3 sigmas of the larger
eigenvalue, ``mid + sqrt(disc)`` with ``disc = mid**2 - det``: for a
nearly round footprint ``disc`` cancels, and a few float32 roundings of
``mid**2`` and ``det`` (``DISC_ROUNDINGS`` of 2**-24 ``mid**2``) move the
root by up to sqrt(8 * 2**-24) ~ 7e-4 of the eigenvalue. The two sides'
radii of such a gaussian were seen a whole pixel apart at 513.
"""

from __future__ import annotations

import dataclasses

import torch

WORLD_EPS = 1e-5        # scene units
PIXEL_EPS = 1e-4        # pixels
RELATIVE_EPS = 1e-5
# roundings of mid**2 - det, in units of 2**-24 mid**2
DISC_ROUNDINGS = 8.0
F32_UNIT = 2.0 ** -24


@dataclasses.dataclass(frozen=True)
class Pairs:
    gauss: torch.Tensor        # (P,) int64 slot of each pair
    tile: torch.Tensor         # (P,) int64 tile id (row-major)
    tile_starts: torch.Tensor  # (NT,) int64
    tile_counts: torch.Tensor  # (NT,) int64
    ntx: int
    nty: int


def tile_grid(width: int, height: int, ts: int):
    return -(-width // ts), -(-height // ts)


def _window(m, r, ts, n, max_span):
    """First and last tile (inclusive) along one axis; last < first where
    the gaussian covers none."""
    t0 = torch.clamp(torch.floor(torch.floor(m - r) / ts), min=0)
    t1 = torch.clamp(torch.floor(torch.ceil(m + r) / ts), max=n - 1)
    span = torch.clamp(t1 - t0 + 1, 0, max_span)
    return t0.long(), (t0 + span - 1).long()


@torch.no_grad()
def bin_pairs(proj: dict, width: int, height: int, rast: dict) -> Pairs:
    ts = rast["tile_size"]
    ntx, nty = tile_grid(width, height, ts)
    dev = proj["depth"].device
    valid = proj["valid"]
    key = torch.where(valid, proj["depth"].detach(), float("inf"))
    order = torch.argsort(key, stable=True)
    order = order[valid[order]]
    m = proj["mean2d"].detach()[order]
    r = proj["radius"][order]
    tx0, tx1 = _window(m[:, 0], r, ts, ntx, rast["max_span"])
    ty0, ty1 = _window(m[:, 1], r, ts, nty, rast["max_span"])
    span_x = torch.clamp(tx1 - tx0 + 1, min=0)
    counts = span_x * torch.clamp(ty1 - ty0 + 1, min=0)
    idx = torch.repeat_interleave(torch.arange(order.shape[0], device=dev),
                                  counts)
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(idx.shape[0], device=dev) - first[idx]
    sx = span_x[idx]
    tile = (ty0[idx] + k // sx) * ntx + tx0[idx] + k % sx
    tile_sorted, perm = torch.sort(tile, stable=True)
    counts_t = torch.bincount(tile_sorted, minlength=ntx * nty)
    starts = torch.cumsum(counts_t, 0) - counts_t
    return Pairs(gauss=order[idx[perm]], tile=tile_sorted,
                 tile_starts=starts, tile_counts=counts_t, ntx=ntx, nty=nty)


@torch.no_grad()
def unsure_tiles(proj: dict, cam, rast: dict) -> torch.Tensor:
    """(nty, ntx) bool: the tiles whose pairs change under the module's
    perturbation of some valid gaussian."""
    ts, span = rast["tile_size"], rast["max_span"]
    ntx, nty = tile_grid(cam.width, cam.height, ts)
    valid = proj["valid"]
    m = proj["mean2d"].detach()[valid]
    depth = proj["depth"].detach()[valid].abs()[:, None]
    raw = proj["radius_raw"][valid]
    mid, disc = proj["mid"][valid], proj["disc"][valid]
    # the root's error: ~sqrt(d_disc) where disc cancels, d_disc /
    # (2 sqrt(disc)) where it does not
    d_disc = DISC_ROUNDINGS * F32_UNIT * mid * mid
    d_lam = d_disc / (torch.sqrt(disc) + torch.sqrt(d_disc)) + (
        4 * F32_UNIT * mid)
    rel = RELATIVE_EPS + d_lam / (2 * (mid + torch.sqrt(disc)))
    focal = torch.tensor([cam.fx, cam.fy], device=m.device)
    centre = torch.tensor([(cam.width - 1) * 0.5, (cam.height - 1) * 0.5],
                          device=m.device)
    # d(pixel) = f (dx + |x / z| dz) / z for a camera-space error dx, dz
    eps = PIXEL_EPS + WORLD_EPS * focal * (
        1 + (m - centre).abs() / focal) / depth
    radii = (torch.ceil(raw * (1 - rel)), torch.ceil(raw * (1 + rel)))
    windows = []                        # per axis: union and intersection
    for axis, n in ((0, ntx), (1, nty)):
        los, his = [], []
        for sign in (-1.0, 1.0):
            for r in radii:
                lo, hi = _window(m[:, axis] + sign * eps[:, axis], r, ts, n,
                                 span)
                los.append(lo)
                his.append(hi)
        lo, hi = torch.stack(los), torch.stack(his)
        windows.append((lo.min(0).values, hi.max(0).values,
                        lo.max(0).values, hi.min(0).values))
    (ux0, ux1, ix0, ix1), (uy0, uy1, iy0, iy1) = windows
    moved = ((ux0 != ix0) | (ux1 != ix1) | (uy0 != iy0) | (uy1 != iy1)) & (
        ux1 >= ux0) & (uy1 >= uy0)
    grid = torch.zeros((nty, ntx), dtype=torch.bool, device=m.device)
    for g in torch.nonzero(moved).flatten().tolist():
        vals = [int(v[g]) for v in (ux0, ux1, ix0, ix1, uy0, uy1, iy0, iy1)]
        a0, a1, b0, b1, c0, c1, d0, d1 = vals
        # the union's box less the intersection's: four strips
        grid[c0:c1 + 1, a0:b0] = True
        grid[c0:c1 + 1, max(b1 + 1, a0):a1 + 1] = True
        grid[c0:d0, a0:a1 + 1] = True
        grid[max(d1 + 1, c0):c1 + 1, a0:a1 + 1] = True
    return grid
