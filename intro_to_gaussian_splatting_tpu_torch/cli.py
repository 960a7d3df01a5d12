"""Command-line interface of the port, ``gstpu-torch``, over COLMAP scene
directories: ``render``, ``points``, ``bench``, ``info``, ``train``,
``eval`` and ``fetch``, with the JAX package's flags.

Every command runs on the CUDA card; ``--cpu`` runs the same path on the
host, with the kernels' plain PyTorch versions. Each command that computes
prints the device it ran on (``info`` only reads the model files).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.ops.render import BACKENDS

COMPAT_CHOICES = ["default", "reference-cpu", "reference-cuda"]


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="COLMAP scene dir (containing sparse/0) or "
                   "sparse model dir")
    p.add_argument("--image-index", type=int, default=0,
                   help="camera index to render")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--min-track", type=int, default=2,
                   help="min track length filter (reference uses 2)")


def _read_scene(path: str):
    from intro_to_gaussian_splatting_tpu_torch.io import (
        read_model, resolve_sparse,
    )
    try:
        sparse = resolve_sparse(path)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    return sparse, read_model(sparse)


def _device(args) -> torch.device:
    from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
    return resolve_device("cpu" if args.cpu else None)


def _load(args):
    """(model, camera, points, (camera record, image record)) of the scene's
    ``--image-index`` view, the reference init, on the command's device."""
    from intro_to_gaussian_splatting_tpu_torch.models import (
        camera_from_colmap, init_from_points,
    )
    device = _device(args)
    _, (cameras, images, points) = _read_scene(args.scene)
    points = points.filter_by_track_length(args.min_track)
    model = init_from_points(points.xyz, points.rgb, device=device)
    keys = sorted(images.keys())
    image = images[keys[args.image_index % len(keys)]]
    cam = camera_from_colmap(cameras[image.camera_id], image, args.downscale,
                             device=device)
    return model, cam, points, (cameras[image.camera_id], image)


def write_ppm(path: str, img: np.ndarray) -> None:
    arr = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
        f.write(arr.tobytes())


def _rcfg_for(args):
    from intro_to_gaussian_splatting_tpu_torch.config import (
        CompatConfig, RasterizerConfig,
    )
    compat = {
        "default": CompatConfig(),
        "reference-cpu": CompatConfig.REFERENCE_CPU,
        "reference-cuda": CompatConfig.REFERENCE_CUDA,
    }[args.compat]
    return RasterizerConfig(tile_size=args.tile_size, compat=compat)


def cmd_render(args) -> int:
    from intro_to_gaussian_splatting_tpu_torch.ops.render import render

    model, cam, points, _ = _load(args)
    config = _rcfg_for(args)
    t0 = time.perf_counter()
    with torch.no_grad():
        img = render(model, cam, config, backend=args.backend).cpu().numpy()
    dt = time.perf_counter() - t0
    mpix = cam.width * cam.height / 1e6
    print(f"rendered {cam.width}x{cam.height} ({len(points)} gaussians) "
          f"in {dt:.3f}s [{mpix / dt:.2f} Mpix/s, backend={args.backend}, "
          f"device={model.device}]")
    write_ppm(args.output, img)
    print(f"wrote {args.output}")
    return 0


def cmd_points(args) -> int:
    """Point-projection sanity render, and with ``--compare-keypoints`` the
    reprojection error against COLMAP's stored keypoints."""
    from intro_to_gaussian_splatting_tpu_torch.ops.points import (
        keypoint_reprojection_report, render_points_image,
    )

    _, cam, points, (cam_rec, image_rec) = _load(args)
    t0 = time.perf_counter()
    img = render_points_image(
        np.asarray(points.xyz, np.float32),
        np.asarray(points.rgb, np.float32) / 255.0, cam,
        splat_radius=args.radius).cpu().numpy()
    print(f"projected {len(points)} points in {time.perf_counter() - t0:.3f}s "
          f"[device={cam.world2view.device}]")
    write_ppm(args.output, img)
    print(f"wrote {args.output}")
    if args.compare_keypoints:
        r = keypoint_reprojection_report(points, cam_rec, image_rec,
                                         args.downscale)
        if r["n_matched"] == 0:
            print("keypoint overlay: no stored keypoints matched the "
                  "loaded points (nothing to compare)")
        else:
            print(f"keypoint overlay vs COLMAP ({r['n_matched']}/"
                  f"{r['n_keypoints']} keypoints matched): "
                  f"mean {r['mean_px']:.2f}px, median {r['median_px']:.2f}px,"
                  f" p90 {r['p90_px']:.2f}px, max {r['max_px']:.2f}px")
    return 0


def cmd_bench(args) -> int:
    from intro_to_gaussian_splatting_tpu_torch.ops.render import render
    from intro_to_gaussian_splatting_tpu_torch.utils.profiling import (
        benchmark,
    )

    model, cam, points, _ = _load(args)
    config = _rcfg_for(args)
    with torch.no_grad():
        res = benchmark(render, model, cam, config, backend=args.backend,
                        iters=args.iters)
    print(f"{cam.width}x{cam.height}, {len(points)} gaussians, "
          f"backend={args.backend}, device={model.device}: "
          f"{res.mean_s * 1e3:.2f} ms/frame "
          f"({res.mpix_per_s(cam.width, cam.height):.1f} Mpix/s), "
          f"first call {res.first_s:.1f}s")
    return 0


def cmd_info(args) -> int:
    sparse, (cameras, images, points) = _read_scene(args.scene)
    print(f"model dir: {sparse}")
    print(f"cameras: {len(cameras)}")
    for cid, c in sorted(cameras.items()):
        print(f"  [{cid}] {c.model} {c.width}x{c.height} fx={c.fx:.1f} "
              f"fy={c.fy:.1f}")
    print(f"images: {len(images)}")
    print(f"points3D: {len(points)} "
          f"(track>=2: {int((points.track_lengths >= 2).sum())})")
    return 0


def cmd_train(args) -> int:
    from intro_to_gaussian_splatting_tpu_torch.train.trainer import train_cli
    return train_cli(args)


def cmd_eval(args) -> int:
    """PSNR/SSIM of a trained model on the scene's (held-out) views."""
    from intro_to_gaussian_splatting_tpu_torch.config import RasterizerConfig
    from intro_to_gaussian_splatting_tpu_torch.io.dataset import load_scene
    from intro_to_gaussian_splatting_tpu_torch.train.checkpoint import (
        import_ply,
    )
    from intro_to_gaussian_splatting_tpu_torch.train.evaluate import (
        evaluate, render_views,
    )

    device = _device(args)
    model = import_ply(args.ply, device=device)
    scene = load_scene(args.scene, downscale=args.downscale,
                       min_track=args.min_track, device=device)
    if args.holdout > 0:
        _, scene = scene.split_holdout(args.holdout)
    if not scene.cameras:
        raise SystemExit("no cameras with ground-truth images to evaluate")
    # a densified model can hold far more pairs than the default pool; an
    # overflowing pool deflates PSNR/SSIM, so each such view is called out
    rcfg = RasterizerConfig(tile_size=args.tile_size,
                            pairs_per_gaussian=args.pairs_per_gaussian)
    print(f"evaluating {len(scene.cameras)} views on device={device}")
    rows = evaluate(model, scene.cameras, scene.targets, rcfg,
                    names=scene.names)
    n_overflowed = 0
    for r in rows:
        flag = ""
        if r.get("overflowed"):
            n_overflowed += 1
            flag = "  [PAIR POOL OVERFLOW: metrics unreliable]"
        print(f"{r['name']:>24s}  psnr {r['psnr']:6.2f}  "
              f"ssim {r['ssim']:.4f}{flag}")
    if n_overflowed:
        print(f"WARNING: {n_overflowed} view(s) overflowed the pair pool; "
              f"re-run with a larger --pairs-per-gaussian "
              f"(currently {rcfg.pairs_per_gaussian})")
    if args.save_renders:
        os.makedirs(args.save_renders, exist_ok=True)
        for name, img in zip(scene.names,
                             render_views(model, scene.cameras, rcfg)):
            write_ppm(os.path.join(args.save_renders,
                                   os.path.splitext(name)[0] + ".ppm"), img)
        print(f"wrote {len(scene.cameras)} renders to {args.save_renders}")
    return 0


def cmd_fetch(args) -> int:
    """Download and extract a Mip-NeRF-360 dataset."""
    from intro_to_gaussian_splatting_tpu_torch.io.fetch import fetch_dataset
    try:
        out = fetch_dataset(args.dataset, args.out_dir,
                            keep_zip=args.keep_zip)
    except RuntimeError as e:
        raise SystemExit(str(e))
    print(f"extracted {args.dataset} into {out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gstpu-torch",
        description="gaussian splatting on an NVIDIA card (PyTorch/CUDA)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host CPU instead of the CUDA card")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render one view of a COLMAP scene")
    _add_scene_args(p)
    p.add_argument("--output", "-o", default="render.ppm")
    p.add_argument("--tile-size", type=int, default=16)
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    p.add_argument("--compat", choices=COMPAT_CHOICES, default="default",
                   help="reproduce the reference implementation's quirks")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("points", help="point-projection sanity render")
    _add_scene_args(p)
    p.add_argument("--output", "-o", default="points.ppm")
    p.add_argument("--radius", type=int, default=1,
                   help="point splat radius, px")
    p.add_argument("--compare-keypoints", action="store_true",
                   help="report the reprojection error of the projected 3D "
                        "points against COLMAP's stored 2D keypoints")
    p.set_defaults(fn=cmd_points)

    p = sub.add_parser("bench", help="time the renderer on a scene view")
    _add_scene_args(p)
    p.add_argument("--tile-size", type=int, default=16)
    p.add_argument("--compat", choices=COMPAT_CHOICES, default="default")
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    p.add_argument("--iters", type=int, default=10)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="print scene statistics")
    _add_scene_args(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("train", help="optimize gaussians against scene images")
    _add_scene_args(p)
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--out-dir", default="./gstpu_out")
    p.add_argument("--holdout", type=int, default=0, metavar="N",
                   help="hold out every Nth view for eval (0 = train on all)")
    p.add_argument("--ssim-weight", type=float, default=None,
                   help="override TrainConfig.ssim_weight")
    p.add_argument("--camera-batch", type=int, default=1, metavar="B",
                   help="average gradients over B same-size cameras per "
                        "optimizer step (train_step_batched)")
    p.add_argument("--eval-at-end", action="store_true",
                   help="print PSNR/SSIM on the holdout (or train) views "
                        "after training")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="save the full training state every N steps "
                        "(0 = save at the end only)")
    p.add_argument("--resume", nargs="?", const="auto", default=None,
                   metavar="CKPT_DIR",
                   help="resume from a checkpoint dir (bare --resume uses "
                        "<out-dir>/ckpt); --iterations is the TOTAL budget")
    mh = p.add_argument_group("multi-host: one process per device")
    mh.add_argument("--multihost", action="store_true",
                    help="train this process's rank of a gauss x tiles "
                         "mesh over every process (NCCL; gloo with --cpu)")
    mh.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="rank 0's address (default: MASTER_ADDR and "
                         "MASTER_PORT from the environment)")
    mh.add_argument("--num-processes", type=int, default=None,
                    help="world size (default: WORLD_SIZE)")
    mh.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (default: RANK)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="PSNR/SSIM of a trained model")
    _add_scene_args(p)
    p.add_argument("--ply", required=True,
                   help="trained model (train writes point_cloud.ply)")
    p.add_argument("--tile-size", type=int, default=16)
    p.add_argument("--pairs-per-gaussian", type=int, default=8,
                   help="pair-pool capacity per gaussian; overflowing "
                        "views are flagged (densified models need more)")
    p.add_argument("--holdout", type=int, default=0, metavar="N",
                   help="evaluate only every Nth view (holdout protocol)")
    p.add_argument("--save-renders", default=None, metavar="DIR",
                   help="also write each rendered view as PPM")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("fetch", help="download a Mip-NeRF-360 dataset "
                       "(treehill is in 360_extra)")
    p.add_argument("dataset", nargs="?", default="360_extra",
                   choices=["360_extra", "360"])
    p.add_argument("--out-dir", default="./data")
    p.add_argument("--keep-zip", action="store_true")
    p.set_defaults(fn=cmd_fetch)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
