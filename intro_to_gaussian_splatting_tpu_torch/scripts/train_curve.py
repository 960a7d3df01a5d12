"""Training curve on the card: optimize a synthetic scene for a few hundred
steps and record the (step, loss, PSNR, num_active) curve as JSONL.

The counterpart of the JAX package's ``scripts/train_curve.py``, on the
same problem: the ground-truth targets are rendered on the device from a
denser, opaque "true" model (``render_tiled``: kernels B1 and B5-untile on
the card) and stay there, and the ``Trainer`` optimizes a sparse subsample
of it, so densify and prune change the model, the pair pool grows when it
overflows and PSNR climbs. Run on a machine with an NVIDIA card:

    python -m intro_to_gaussian_splatting_tpu_torch.scripts.train_curve \\
        [--steps 600] [--mpix 1.3] [--out gstpu_out/train_curve.jsonl]

or on the host at a tiny size with ``--cpu`` (for example ``--mpix 0.003
--true-n 400 --init-n 100 --cameras 2 --steps 24``). Without ``--cpu`` it
raises where there is no card.

``--out`` is truncated when the run starts; the ``Trainer`` appends one
JSON object per log boundary (every 25 steps), and a summary line follows
with the JAX script's keys (``device`` in place of its ``backend``) and
what this script measures besides: each densify + prune pass's host ms
between two synchronisations with the active count before and after, each
pool growth with its step, whether the target renders overflowed their
pool, peak device memory and, on the card, its name and power limit. The
summary also goes to stdout; the exit code is 1 when PSNR did not climb by
more than 1 dB.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import torch

from intro_to_gaussian_splatting_tpu_torch.config import (
    RasterizerConfig,
    TrainConfig,
)
from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
    random_point_cloud,
    ring_cameras,
)
from intro_to_gaussian_splatting_tpu_torch.models.camera import make_camera
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    GaussianModel,
    init_from_points,
)
from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import render_tiled
from intro_to_gaussian_splatting_tpu_torch.train.trainer import (
    Trainer,
    scene_extent_of,
)

DEFAULT_OUT = os.path.join("gstpu_out", "train_curve.jsonl")
LOG_EVERY = 25

_T0 = time.perf_counter()


def log(*a) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *a, file=sys.stderr,
          flush=True)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Train a synthetic scene and record its curve.")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSONL of the curve, truncated at the start")
    ap.add_argument("--mpix", type=float, default=1.3)
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--true-n", type=int, default=60_000)
    ap.add_argument("--init-n", type=int, default=12_000)
    ap.add_argument("--camera-batch", type=int, default=1,
                    help="cameras per optimizer step")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host instead of the card")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Problem:
    """The scene, targets, configurations and initial model of one run."""

    args: argparse.Namespace
    device: torch.device
    width: int
    height: int
    true_model: GaussianModel
    cameras: list
    targets: list                 # (H, W, 3) tensors on the device
    targets_overflowed: bool
    scene_extent: float
    rcfg: RasterizerConfig
    tcfg: TrainConfig
    model: GaussianModel
    log_every: int = LOG_EVERY


def make_problem(args: argparse.Namespace,
                 device: str | torch.device | None = None) -> Problem:
    """The JAX script's problem on ``device`` (the card unless asked for
    the CPU): its image size rounded to 16, its true model, ring cameras,
    configurations and KNN-initialized subsample; the targets rendered on
    the device."""
    device = resolve_device(device)
    width = int(round((args.mpix * 1e6 * 3 / 2) ** 0.5 / 16) * 16)
    height = int(round(width * 2 / 3 / 16) * 16)
    rcfg = RasterizerConfig(pairs_per_gaussian=8)
    # a dense, opaque "true" scene the optimizer must reproduce
    xyz_t, rgb_t = random_point_cloud(args.true_n, seed=3, extent=8.0)
    true_model = init_from_points(xyz_t, rgb_t, scale_init=0.06, opacity=0.9,
                                  sh_degree=0, color_space="sh",
                                  device=device)
    cams = [make_camera(0.85 * width, 0.85 * width, width, height, qvec,
                        tvec, device=device)
            for qvec, tvec in ring_cameras(args.cameras, width, height,
                                           radius=12.0, z=2.5, seed=1)]
    targets, overflowed = [], False
    with torch.no_grad():
        for cam in cams:
            image, aux = render_tiled(true_model, cam, rcfg, return_aux=True)
            targets.append(image)
            overflowed |= bool(aux["overflowed"])

    # optimize from a sparse subsample: densify must grow it back
    tcfg = TrainConfig(
        iterations=args.steps, ssim_weight=0.2,
        densify_start=100, densify_stop=args.steps - 100,
        densify_interval=100, opacity_reset_interval=0,
        capacity_multiplier=6.0, sh_degree=0,
        camera_batch=args.camera_batch,
    )
    model = init_from_points(
        xyz_t[:args.init_n], rgb_t[:args.init_n], sh_degree=0,
        color_space="sh",
        capacity=int(args.init_n * tcfg.capacity_multiplier),
        opacity=0.1, scale_init=None, device=device)
    return Problem(args=args, device=device, width=width, height=height,
                   true_model=true_model, cameras=cams,
                   targets=targets, targets_overflowed=overflowed,
                   scene_extent=scene_extent_of(xyz_t), rcfg=rcfg,
                   tcfg=tcfg, model=model)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip()


def run_problem(problem: Problem) -> dict:
    """Train ``problem.model`` for ``args.steps`` steps, writing the curve
    to ``args.out``; returns the summary (also appended there)."""
    args, device = problem.args, problem.device
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    open(args.out, "w").close()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    rows, growth, passes = [], [], []

    def on_log(m):
        if m.get("event") == "pair_pool_grown":
            growth.append(dict(step=m["step"],
                               pairs_per_gaussian=m["pairs_per_gaussian"]))
        elif "psnr" in m:
            rows.append(dict(m))
        log(" ".join(f"{k}={v}" for k, v in m.items()))

    trainer = Trainer(model=problem.model, cameras=problem.cameras,
                      targets=problem.targets,
                      scene_extent=problem.scene_extent, rcfg=problem.rcfg,
                      tcfg=problem.tcfg, log_every=problem.log_every,
                      on_log=on_log,
                      jsonl_path=args.out)

    # time each densify + prune pass inside the loop, synchronised
    densify_and_prune = trainer._densify_and_prune

    def timed(model, dstate):
        _sync(device)
        before = int(model.active.sum())
        t0 = time.perf_counter()
        slots = densify_and_prune(model, dstate)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        passes.append(dict(step=trainer.step, host_ms=ms,
                           active_before=before,
                           active_after=int(model.active.sum()),
                           slots_written=int((slots < model.capacity).sum())))
        return slots

    trainer._densify_and_prune = timed
    t0 = time.perf_counter()
    trainer.run(args.steps)
    _sync(device)
    wall = time.perf_counter() - t0

    psnrs = [r["psnr"] for r in rows]
    summary = dict(
        event="summary", device=str(device), steps=args.steps,
        width=problem.width, height=problem.height,
        wall_s=wall, steps_per_s=args.steps / wall,
        first_psnr=psnrs[0], best_psnr=max(psnrs), final_psnr=psnrs[-1],
        final_active=int(rows[-1]["num_active"]),
        pairs_per_gaussian=trainer.rcfg.pairs_per_gaussian,
        camera_batch=args.camera_batch,
        targets_overflowed=problem.targets_overflowed,
        pool_growth=growth, densify_passes=passes,
        curve=[[int(r["step"]), r["loss"], r["psnr"], int(r["num_active"])]
               for r in rows],
    )
    if device.type == "cuda":
        summary.update(max_memory_allocated=torch.cuda.max_memory_allocated(
            device), card=card_line(device))
    with open(args.out, "a") as f:
        f.write(json.dumps(summary) + "\n")
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    problem = make_problem(args, "cpu" if args.cpu else None)
    log(f"device: {problem.device}; scene {problem.width}x{problem.height} "
        f"({problem.width * problem.height / 1e6:.2f} Mpix), "
        f"true={args.true_n} gaussians, init={args.init_n}; targets "
        f"rendered on the device (overflowed: {problem.targets_overflowed})")
    summary = run_problem(problem)
    print(json.dumps(summary))
    if summary["final_psnr"] > summary["first_psnr"] + 1.0:
        return 0
    log("WARNING: PSNR did not climb by >1 dB")
    return 1


if __name__ == "__main__":
    sys.exit(main())
