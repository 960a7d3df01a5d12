#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port's render path.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

It imports only the port (``intro_to_gaussian_splatting_tpu_torch``), never
JAX, and prints one JSON line per phase:

  device    card name and power limit, torch and CUDA versions, the build
            of both kernels (one nvcc per source, started together) and
            ptxas's register / shared-memory / spill report;
  small     a small seeded scene rendered on the card against the port's
            dense oracle on the card and the CPU path;
  ref_init  the treehill-scale scene (52,363 gaussians at 5068x3324, built
            as bench.py builds it) at the reference init, through
            ``ops.render.render(backend="auto")`` with both launch counts
            set to 0 just before and read just after;
  knn_init  the same scene at the KNN scale init with the dense pool
            (pairs_per_gaussian=585, group_tiles=16, groups_per_step=16);
  kernels   per scene, each kernel against its plain version on the
            scene's real inputs, its time from CUDA events, its bound, the
            plain version's time and the library call's; the whole
            ``render_tiled`` on a host clock around synchronisation, its
            stages one by one, and one call under torch.profiler (time in
            kernels, idle share, longest kernels).

Then the nvidia-smi line, the kernels summary line (main-path = ref-init
numbers) and, last, the contract line. Any failed check exits non-zero
before the last line; with no card, or outside a checkout, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "intro_to_gaussian_splatting_tpu_torch"

# Published peaks of one H100 SXM (NVIDIA data sheet), at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Operations kernel B1 does per (pair, pixel) evaluation: dx, dy (2), the
# conic quadratic (9), the -0.5 scale (1), expf (1), opacity (1), clamp (2),
# 1 - a (1), T * (1 - a) (1), the threshold test (1), T * a (1) and five
# multiply-adds into the accumulators (10).
B1_OPS_PER_EVALUATION = 30
# Pair counts the JAX package gives on the same inputs (its bench.py).
JAX_PAIRS = {"ref_init": 81513, "knn_init": 29146684}

B1_REPLACES = "intro_to_gaussian_splatting_tpu/ops/rasterize_pallas.py:220"
B5_REPLACES = "intro_to_gaussian_splatting_tpu/ops/relayout_pallas.py:59"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    """(ms, binding resource): the larger of bytes over the HBM rate and
    operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage_times(torch, model, cam, cfg, ntx, nty, ng, project_gaussians,
                bin_gaussians, R, L, reps: int = 3) -> dict:
    """Host-clock ms of each stage of render_tiled, synchronised after each
    (mean of ``reps`` runs): where the time of one render goes."""
    names = ("project", "bin", "B1 rasterize", "B5 untile + permute")
    sums = dict.fromkeys(names, 0.0)
    with torch.no_grad():
        for _ in range(reps):
            marks = [time.perf_counter()]
            proj = project_gaussians(model, cam, cfg)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            bins = bin_gaussians(proj, cam.width, cam.height, cfg)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            tiles = R.rasterize_pairs(bins.pair_records, bins.tile_starts,
                                      bins.tile_counts, ng, cfg)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            L.untile_chw_fast(tiles, ntx, nty, cfg.tile_size, cam.height,
                              cam.width).permute(1, 2, 0).contiguous()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            for name, a, b in zip(names, marks, marks[1:]):
                sums[name] += (b - a) * 1e3 / reps
    return sums


def device_profile(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, the ms the
    card spent in kernels, the idle share, and the five longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    return dict(wall_ms=wall_ms, kernel_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                kernel_launches=sum(e.count for e in kernels),
                top_kernels=[[e.key[:80], e.self_device_time_total / 1e3,
                              e.count] for e in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (REPO / PACKAGE / "__init__.py").is_file():
        print(f"chip_smoke: {PACKAGE}/ not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig
    from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
        random_point_cloud, ring_cameras,
    )
    from intro_to_gaussian_splatting_tpu_torch.models import (
        GaussianModel, init_from_points, make_camera,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops import cuda_build
    from intro_to_gaussian_splatting_tpu_torch.ops import rasterize as R
    from intro_to_gaussian_splatting_tpu_torch.ops import relayout as L
    from intro_to_gaussian_splatting_tpu_torch.ops.binning import (
        bin_gaussians, num_groups_for, tile_grid,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops.compositing import (
        render_dense,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
        project_gaussians,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops.render import render

    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    cuda_build.build([R.RASTERIZE_SOURCE, L.UNTILE_SOURCE])
    build_s = time.perf_counter() - t0
    emit("device", card=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         build_s=build_s,
         ptxas={"rasterize_fwd": cuda_build.ptxas_report(R.RASTERIZE_SOURCE),
                "untile_chw": cuda_build.ptxas_report(L.UNTILE_SOURCE)})

    # -- small seeded scene: card against the dense oracle and the CPU path
    rng = np.random.default_rng(3)
    n, w, h = 400, 48, 32
    qvec, tvec = ring_cameras(1, w, h, radius=5.0, z=1.0, seed=3)[0]
    arrays = dict(
        means=rng.normal(0.0, 1.2, size=(n, 3)),
        colors=rng.uniform(0.0, 1.0, size=(n, 3)),
        log_scales=np.log(rng.uniform(0.02, 0.25, size=(n, 3))),
        quats=rng.normal(size=(n, 4)),
        opacity_logits=rng.uniform(-2.0, 6.0, size=(n,)))
    small_cfg = RasterizerConfig(pairs_per_gaussian=32, group_tiles=2)
    small = {}
    for dev in ("cuda", "cpu"):
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)
        model = GaussianModel(
            means=f32(arrays["means"]), log_scales=f32(arrays["log_scales"]),
            quats=f32(arrays["quats"]),
            opacity_logits=f32(arrays["opacity_logits"]),
            sh=f32(arrays["colors"])[:, None, :],
            active=torch.ones(n, dtype=torch.bool, device=dev),
            color_space="rgb")
        cam = make_camera(0.9 * max(w, h), 0.9 * max(w, h), w, h, qvec, tvec,
                          device=dev)
        with torch.no_grad():
            small[dev] = render(model, cam, small_cfg, backend="auto").cpu()
            if dev == "cuda":
                dense = render_dense(model, cam, small_cfg).cpu()
    err_dense = float((small["cuda"] - dense).abs().max())
    err_cpu = float((small["cuda"] - small["cpu"]).abs().max())
    emit("small", gaussians=n, width=w, height=h,
         max_abs_vs_dense_oracle=err_dense, max_abs_vs_cpu_path=err_cpu,
         tolerance="rtol 1e-4, atol 1e-5")
    check(torch.allclose(small["cuda"], dense, rtol=1e-4, atol=1e-5),
          "small scene: card render disagrees with the dense oracle")
    check(torch.allclose(small["cuda"], small["cpu"], rtol=1e-4, atol=1e-5),
          "small scene: card render disagrees with the CPU path")

    # -- treehill-scale scene, exactly as bench.py builds it
    width, height = 5068, 3324
    xyz, rgb = random_point_cloud(52363, seed=0, extent=10.0)
    qvec, tvec = ring_cameras(1, width, height, radius=14.0, z=3.0,
                              seed=0)[0]
    focal = 0.78 * width
    cam = make_camera(focal, focal, width, height, qvec, tvec, device="cuda")
    ts = 16
    ntx, nty = tile_grid(width, height, ts)
    mpix = width * height / 1e6
    scenes = {
        "ref_init": (init_from_points(xyz, rgb, device="cuda"),
                     RasterizerConfig()),
        "knn_init": (init_from_points(xyz, rgb, scale_init=None, opacity=0.9,
                                      device="cuda"),
                     RasterizerConfig(pairs_per_gaussian=585, group_tiles=16,
                                      groups_per_step=16)),
    }

    summary = {}
    for scene, (model, cfg) in scenes.items():
        ng = num_groups_for(ntx * nty, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        R.RASTERIZE_FWD.launches = 0
        L.UNTILE_CHW.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            image = render(model, cam, cfg, backend="auto")
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = {"B1": R.RASTERIZE_FWD.launches,
                    "B5-untile": L.UNTILE_CHW.launches}
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            proj = project_gaussians(model, cam, cfg)
            bins = bin_gaussians(proj, width, height, cfg)
        num_pairs = int(bins.num_pairs)
        overflowed = bool(bins.overflowed)
        finite = bool(torch.isfinite(image).all())
        emit(scene, gaussians=model.capacity, width=width, height=height,
             config=dict(pairs_per_gaussian=cfg.pairs_per_gaussian,
                         group_tiles=cfg.group_tiles,
                         groups_per_step=cfg.groups_per_step),
             launches=launches, num_pairs=num_pairs,
             num_pairs_jax_package=JAX_PAIRS[scene],
             pool_slots=bins.pair_records.shape[1], overflowed=overflowed,
             image_shape=list(image.shape), finite=finite,
             image_mean=float(image.mean()), first_render_ms=first_ms,
             max_memory_allocated=peak, card=card)
        check(all(v >= 1 for v in launches.values()),
              f"{scene}: a kernel of the path was not launched: {launches}")
        check(tuple(image.shape) == (height, width, 3) and finite,
              f"{scene}: image is not a finite (H, W, 3) tensor")
        check(not overflowed, f"{scene}: the pair pool overflowed")
        check(abs(num_pairs - JAX_PAIRS[scene]) <= 0.01 * JAX_PAIRS[scene],
              f"{scene}: {num_pairs} pairs, the JAX package counts "
              f"{JAX_PAIRS[scene]}")

        # -- each kernel against its plain version on this scene's inputs
        args = (bins.pair_records, bins.tile_starts, bins.tile_counts, ng,
                cfg)
        with torch.no_grad():
            tiles = R.rasterize_pairs(*args)
            plain, evaluations = R.rasterize_pairs_reference(
                *args, count_evaluations=True)
        torch.cuda.synchronize()
        b1_err = (tiles - plain).abs().amax(dim=(0, 2, 3)).tolist()
        b1_ok = torch.allclose(tiles, plain, rtol=1e-4, atol=1e-5)
        chw = L.untile_chw_fast(tiles, ntx, nty, ts, height, width)
        chw_plain = L.untile_chw(tiles[:, :3], ntx, nty, ts, height, width)
        b5_err = float((chw - chw_plain).abs().max())
        b5_ok = torch.equal(chw, chw_plain)

        # -- times
        b1_ms = cuda_ms(torch, lambda: R.rasterize_pairs(*args), iters=10)
        b1_plain_ms = cuda_ms(
            torch, lambda: R.rasterize_pairs_reference(*args), iters=1,
            warmup=0)
        b1_bytes = (64 * num_pairs + 8 * ntx * nty
                    + R.OUT_CHANNELS * tiles[0, 0].numel() * ng * 4)
        b1_bound, b1_by = bound(b1_bytes, B1_OPS_PER_EVALUATION * evaluations)
        b5_ms = cuda_ms(torch, lambda: L.untile_chw_fast(
            tiles, ntx, nty, ts, height, width), iters=20)
        b5_plain_ms = cuda_ms(torch, lambda: L.untile_chw(
            tiles[:, :3], ntx, nty, ts, height, width), iters=10)
        # the library yardstick: the tile -> image-row transposition as one
        # permute + contiguous of the channel-major flattened tiles
        flat = tiles[:, :3].permute(1, 0, 2, 3).reshape(
            3, -1, ts * ts)[:, :ntx * nty].reshape(3, nty, ntx, ts, ts)
        b5_lib_ms = cuda_ms(
            torch, lambda: flat.permute(0, 1, 3, 2, 4).contiguous(), iters=20)
        b5_bound, b5_by = bound(2 * 3 * width * height * 4, 0)

        def whole():
            with torch.no_grad():
                return R.render_tiled(model, cam, cfg)

        whole()
        torch.cuda.synchronize()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            whole()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        render_ms = sum(reps) / len(reps)
        stages = stage_times(torch, model, cam, cfg, ntx, nty, ng,
                             project_gaussians, bin_gaussians, R, L)
        device = device_profile(torch, whole)

        rows = [
            dict(name="B1 rasterize_fwd", route="cuda",
                 source=f"{PACKAGE}/csrc/rasterize_fwd.cu",
                 replaces=B1_REPLACES, launches=launches["B1"],
                 max_abs_err=max(b1_err), ms=b1_ms, plain_ms=b1_plain_ms,
                 bound_ms=b1_bound, bound_by=b1_by, library_ms=None),
            dict(name="B5-untile untile_chw", route="cuda",
                 source=f"{PACKAGE}/csrc/untile_chw.cu",
                 replaces=B5_REPLACES, launches=launches["B5-untile"],
                 max_abs_err=b5_err, ms=b5_ms, plain_ms=b5_plain_ms,
                 bound_ms=b5_bound, bound_by=b5_by, library_ms=b5_lib_ms),
        ]
        emit(f"{scene}_kernels", kernels=rows,
             b1_max_abs_err_per_channel=b1_err, b1_within_tolerance=b1_ok,
             b1_tolerance="rtol 1e-4, atol 1e-5", b1_evaluations=evaluations,
             b1_bytes=b1_bytes, b5_exactly_equal=b5_ok,
             render_tiled_ms=reps, render_tiled_mean_ms=render_ms,
             render_tiled_mpix_per_s=mpix / (render_ms / 1e3),
             stages_host_ms=stages, device_profile=device, card=card)
        check(b1_ok, f"{scene}: B1 disagrees with its plain version "
                     f"(max abs per channel {b1_err})")
        check(b5_ok, f"{scene}: B5-untile differs from its plain version")
        summary[scene] = rows
        del tiles, plain, chw, chw_plain, flat, bins, proj, image
        torch.cuda.empty_cache()

    print(card, flush=True)
    print(json.dumps({"kernels": summary["ref_init"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
