"""Front-to-back compositing of (tile, depth)-sorted pairs and its gradient.

A frozen copy of the port's plain versions of its kernels B1 and B2
(``rasterize_pairs_reference`` and ``rasterize_pairs_backward_reference``
in ``ops/rasterize.py`` of the port, as of the benchmark's first version),
on this module's own layout: per pixel,

    alpha = min(opacity * exp(-0.5 d^T conic d), alpha_clamp)
    a pair counts while T * (1 - alpha) >= t_threshold; the first that
    does not ends the pixel; T *= 1 - alpha for every pair that counts
    colour += T * alpha * rgb

They step over the depth rank k within a tile, every tile at once (tiles
sorted by pair count, so the tiles that have a pair k are a prefix), and
stop once no pixel of any tile is left. ``composite`` also counts the work
the inputs need: the (pair, pixel) evaluations up to each pixel's exit and
the pairs up to each tile's last exit.
"""

from __future__ import annotations

import numpy as np
import torch

# rows of the per-pair record matrix: mean (tile-local pixels), conic,
# opacity, colour
MX, MY, CA, CB, CC, OP, R, G, B = range(9)
NUM_ROWS = 9
# stop the depth-rank loop once every pixel has exited, checked this often
_CHECK_EVERY = 16


def _schedule(tile_starts, tile_counts):
    counts = tile_counts.cpu().numpy().astype(np.int64)
    order_host = np.argsort(-counts, kind="stable")
    sorted_counts = counts[order_host]
    order = torch.as_tensor(order_host, device=tile_starts.device)
    starts = tile_starts[order]
    max_count = int(sorted_counts[0]) if len(sorted_counts) else 0
    active = np.searchsorted(-sorted_counts, -np.arange(max_count),
                             side="left")
    return order, starts, max_count, active


def _pixels(ts, dev):
    lane = torch.arange(ts * ts, device=dev)
    return ((lane % ts).to(torch.float32)[None, :],
            (lane // ts).to(torch.float32)[None, :])


def _alpha(rec, px, py, rast):
    def col(row):
        return rec[row][:, None]

    dx = px - col(MX)
    dy = py - col(MY)
    q = col(CA) * dx * dx + 2.0 * col(CB) * dx * dy + col(CC) * dy * dy
    weight = torch.exp(-0.5 * q)
    alpha_raw = col(OP) * weight
    a = torch.clamp(alpha_raw, 0.0, rast["alpha_clamp"])
    return dx, dy, weight, alpha_raw, a


@torch.no_grad()
def composite(rec, tile_starts, tile_counts, rast):
    """rec (9, P) -> (rgb (3, NT, ts*ts), counts): counts holds
    ``evaluations`` and ``pairs_read`` (ints)."""
    ts = rast["tile_size"]
    thr = rast["t_threshold"]
    dev = rec.device
    nt = tile_starts.shape[0]
    px, py = _pixels(ts, dev)
    order, starts, max_count, active = _schedule(tile_starts, tile_counts)
    T = torch.ones((nt, ts * ts), device=dev)
    alive = torch.ones((nt, ts * ts), dtype=torch.bool, device=dev)
    acc = torch.zeros((3, nt, ts * ts), device=dev)
    evaluations = torch.zeros((), dtype=torch.int64, device=dev)
    pairs_read = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(max_count):
        na = int(active[k])
        if k % _CHECK_EVERY == 0 and not bool(alive[:na].any()):
            break
        r = rec[:, starts[:na] + k]
        _, _, _, _, a = _alpha(r, px, py, rast)
        t_prev = T[:na]
        live = alive[:na]
        evaluations += live.sum()
        pairs_read += live.any(dim=1).sum()
        t_incl = t_prev * (1.0 - a)
        keep = live & (t_incl >= thr)
        w = t_prev * a
        for c in range(3):
            acc[c, :na] += torch.where(keep, r[R + c][:, None] * w, 0.0)
        T[:na] = torch.where(keep, t_incl, t_prev)
        alive[:na] = keep
    out = torch.zeros_like(acc)
    out[:, order] = acc
    return out, dict(evaluations=int(evaluations),
                     pairs_read=int(pairs_read))


@torch.no_grad()
def composite_backward(rec, tile_starts, tile_counts, out, g_out, rast):
    """The gradient (9, P) of sum(g_out * composite(rec)) with respect to
    rec; ``out`` and ``g_out`` are (3, NT, ts*ts)."""
    ts = rast["tile_size"]
    thr = rast["t_threshold"]
    clamp = rast["alpha_clamp"]
    dev = rec.device
    nt = tile_starts.shape[0]
    px, py = _pixels(ts, dev)
    order, starts, max_count, active = _schedule(tile_starts, tile_counts)
    g = g_out[:, order]
    u_all = torch.sum(g * out[:, order], dim=0)
    T = torch.ones((nt, ts * ts), device=dev)
    alive = torch.ones((nt, ts * ts), dtype=torch.bool, device=dev)
    prefix = torch.zeros((nt, ts * ts), device=dev)
    drec = torch.zeros_like(rec)
    for k in range(max_count):
        na = int(active[k])
        if k % _CHECK_EVERY == 0 and not bool(alive[:na].any()):
            break
        cols = starts[:na] + k
        r = rec[:, cols]
        dx, dy, weight, alpha_raw, a = _alpha(r, px, py, rast)
        t_prev = T[:na]
        gk = g[:, :na]
        one_minus = 1.0 - a
        t_incl = t_prev * one_minus
        keep = alive[:na] & (t_incl >= thr)
        w = t_prev * a
        gc = (r[R][:, None] * gk[0] + r[G][:, None] * gk[1]
              + r[B][:, None] * gk[2])
        prefix[:na] += torch.where(keep, gc * w, 0.0)
        suffix = u_all[:na] - prefix[:na]
        da = gc * t_prev - suffix / one_minus
        dalpha = da * ((a > 0.0) & (alpha_raw < clamp)).to(torch.float32)
        ca, cb, cc = r[CA][:, None], r[CB][:, None], r[CC][:, None]
        dq = dalpha * r[OP][:, None] * weight * (-0.5)
        terms = (dq * (-(2.0 * ca * dx + 2.0 * cb * dy)),
                 dq * (-(2.0 * cc * dy + 2.0 * cb * dx)),
                 dq * dx * dx, dq * 2.0 * dx * dy, dq * dy * dy,
                 dalpha * weight, w * gk[0], w * gk[1], w * gk[2])
        for row, term in enumerate(terms):
            drec[row, cols] = torch.where(keep, term, 0.0).sum(dim=1)
        T[:na] = torch.where(keep, t_incl, t_prev)
        alive[:na] = keep
    return drec


def tiles_to_image(tiles, ntx, nty, ts, height, width):
    """(C, NT, ts*ts) row-major tiles -> (C, H, W)."""
    c = tiles.shape[0]
    img = tiles.reshape(c, nty, ntx, ts, ts).permute(0, 1, 3, 2, 4)
    return img.reshape(c, nty * ts, ntx * ts)[:, :height, :width]


def image_to_tiles(img, ntx, nty, ts):
    """(C, H, W) -> (C, NT, ts*ts), zero past the image."""
    c, h, w = img.shape
    pad = torch.nn.functional.pad(img, (0, ntx * ts - w, 0, nty * ts - h))
    return pad.reshape(c, nty, ts, ntx, ts).permute(0, 1, 3, 2, 4).reshape(
        c, nty * ntx, ts * ts)
