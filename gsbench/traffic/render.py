"""Traffic ``render``: a viewer orbiting the scene. The window calls the
port's ``ops.render.render`` closed loop, one view in flight: each view is
timed from the call to the ``synchronize()`` after it, and the next is
sent when it is done. The views go round ``cameras`` ring cameras in an
order drawn from the seed, at ``active_sh_degree``, with the model's
capacity equal to its gaussians. ``warm_views`` views warm the path up in
set-up.

``render_p95_ms`` is the 95th percentile of every view's latency in the
window and ``render_views_per_s`` the views completed over the window.
``sample_views`` of the window's views, drawn from the seed by reservoir
sampling, keep their images; after the window the program is freed and
the plain reference renders the same cameras from the same inputs. With
``--trace 1`` the window is ``trace_views`` views run untraced and
host-timed, then the same views under the profiler, and the reference
counts the work of each.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from gsbench import scene, sides, tracing
from gsbench.harness import Outcome, Readings, sync
from gsbench.reference.render import render_view


def _inputs(cell):
    cfg, p, dev = cell.config, cell.params, cell.device
    gen = scene.generator(cell.seed, dev)
    xyz, rgb = scene.point_cloud(cfg, gen, dev)
    params, active = scene.initial_params(
        cfg, xyz, rgb, cfg["num_gaussians"], gen, p["sh_rest_std"])
    poses = scene.ring_poses(cfg, p["cameras"], cell.seed)
    order = np.random.default_rng(cell.seed).permutation(p["cameras"])
    return params, active, poses, order


def _program(cell, params, active, poses):
    from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig

    model, cams = sides.program_scene(cell, params, active, poses)
    return model, cams, RasterizerConfig(**cell.rasterizer())


def _view(cell, model, cam, rcfg):
    from intro_to_gaussian_splatting_tpu_torch.ops import render

    with torch.no_grad():
        return render.render(model, cam, rcfg,
                             active_sh_degree=cell.params["active_sh_degree"])


class Reservoir:
    """A uniform sample of ``k`` of a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, \
            np.random.default_rng(seed), 0, []

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _window(cell, model, cams, rcfg, order):
    kept = Reservoir(cell.params["sample_views"], cell.seed)
    latencies = []
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    end = t0
    while end < deadline:
        cam_idx = int(order[len(latencies) % len(order)])
        start = time.perf_counter()
        img = _view(cell, model, cams[cam_idx], rcfg)
        sync(cell.device)
        end = time.perf_counter()
        latencies.append(end - start)
        kept.offer((cam_idx, img))
    return latencies, end - t0, kept.items


def _traced(cell, model, cams, rcfg, order, params, active, ref_cams):
    from intro_to_gaussian_splatting_tpu_torch.ops import rasterize as R

    n = cell.params["trace_views"]
    idx = [int(order[i % len(order)]) for i in range(n)]

    def views():
        kept = Reservoir(cell.params["sample_views"], cell.seed)
        for i in idx:
            kept.offer((i, _view(cell, model, cams[i], rcfg)))
            sync(cell.device)
        return kept.items

    sync(cell.device)
    t0 = time.perf_counter()
    views()
    untraced_s = time.perf_counter() - t0
    trace, kept = tracing.traced_window(
        views, lambda: sync(cell.device),
        {"rasterize_fwd": lambda: R.RASTERIZE_FWD.launches})
    cell.log(f"{n} views: {untraced_s:.4f} s untraced, trace window "
             f"{trace.window_s:.4f} s")
    counts = sides.work_counts(cell, params, active,
                               [ref_cams[i] for i in idx],
                               cell.params["active_sh_degree"])
    return Readings(trace=trace, units=n, untraced_s=untraced_s,
                    counts=counts), kept


def rel_l2(got: torch.Tensor, want: torch.Tensor, sure: torch.Tensor):
    """Relative L2 distance over the pixels of ``sure``."""
    if got.shape != want.shape:
        return float("inf")
    diff = torch.where(sure[..., None], got.double() - want.double(), 0.0)
    ref = torch.where(sure[..., None], want.double(), 0.0)
    return float(torch.linalg.vector_norm(diff)
                 / torch.linalg.vector_norm(ref))


def compare(kept, want: dict, limits: dict) -> dict:
    """The worst sampled view's relative L2 distance from the
    reference's image of its camera, outside the reference's unsure
    tiles."""
    worst = max(rel_l2(img, *want[cam_idx]) for cam_idx, img in kept)
    return dict(image_rel_l2=(worst, limits["image_rel_l2"]))


def _reference(cell, params, active, ref_cams, cam_ids,
               precision: str = "float32") -> dict:
    """{camera: (image, sure pixels)} of the reference."""
    rast = cell.rasterizer()
    degree = cell.params["active_sh_degree"]
    out = {}
    for i in sorted(set(cam_ids)):
        img, counts, sure = render_view(params, active, ref_cams[i], rast,
                                        degree, precision)
        cell.log(f"view {i}: {1 - float(sure.float().mean()):.3e} of the "
                 f"pixels in unsure tiles ({counts['unsure_window_tiles']} "
                 f"by their pairs, {counts['unsure_order_tiles']} by depth "
                 f"ties)")
        out[i] = (img, sure)
    return out


def run(cell) -> Outcome:
    params, active, poses, order = _inputs(cell)
    model, cams, rcfg = _program(cell, params, active, poses)
    for i in range(cell.params["warm_views"]):
        _view(cell, model, cams[int(order[i % len(order)])], rcfg)
    sync(cell.device)
    ref_cams = sides.reference_cameras(cell, poses)
    setup_s = time.perf_counter() - cell.t_start
    cell.log(f"set-up {setup_s:.2f} s")
    readings, e2e = None, {}
    if cell.trace:
        readings, kept = _traced(cell, model, cams, rcfg, order, params,
                                 active, ref_cams)
        attempted = readings.units
    else:
        latencies, seconds, kept = _window(cell, model, cams, rcfg, order)
        e2e["render_p95_ms"] = float(np.percentile(latencies, 95)) * 1e3
        e2e["render_views_per_s"] = len(latencies) / seconds
        attempted = len(latencies)
    e2e["setup_s"] = setup_s
    sync(cell.device)
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    del model, cams
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    cell.log(f"window closed at {t_ref - cell.t_start:.2f} s")
    want = _reference(cell, params, active, ref_cams, [c for c, _ in kept])
    cell.log(f"reference {time.perf_counter() - t_ref:.2f} s")
    return Outcome(end_to_end=e2e, attempted=attempted, failed=0,
                   checks=compare(kept, want, cell.limits),
                   memory_peak=peak, readings=readings)


def control(cell) -> Outcome:
    """The reference in TF32 in the program's place, on the cameras of
    ``sample_views`` views drawn as the window draws them."""
    params, active, poses, order = _inputs(cell)
    ref_cams = sides.reference_cameras(cell, poses)
    kept = Reservoir(cell.params["sample_views"], cell.seed)
    for i in range(4 * len(order)):
        kept.offer(int(order[i % len(order)]))
    ids = kept.items
    got = _reference(cell, params, active, ref_cams, ids, precision="tf32")
    want = _reference(cell, params, active, ref_cams, ids)
    return Outcome(end_to_end={}, attempted=0, failed=0,
                   checks=compare([(i, got[i][0]) for i in ids], want,
                                  cell.limits))
