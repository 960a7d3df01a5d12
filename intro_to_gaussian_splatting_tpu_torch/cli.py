"""Command-line interface of the port: ``gstpu-torch render`` and
``gstpu-torch info`` over COLMAP scene directories.

Rendering runs on the CUDA card; ``--cpu`` runs the same path on the host,
with the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.ops.render import BACKENDS


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
    from intro_to_gaussian_splatting_tpu_torch.models import (
        camera_from_colmap, init_from_points,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops.render import render

    device = "cpu" if args.cpu else "cuda"
    _, (cameras, images, points) = _read_scene(args.scene)
    points = points.filter_by_track_length(args.min_track)
    model = init_from_points(points.xyz, points.rgb, device=device)
    keys = sorted(images.keys())
    image = images[keys[args.image_index % len(keys)]]
    cam = camera_from_colmap(cameras[image.camera_id], image, args.downscale,
                             device=device)
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
    p.add_argument("--compat",
                   choices=["default", "reference-cpu", "reference-cuda"],
                   default="default",
                   help="reproduce the reference implementation's quirks")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("info", help="print scene statistics")
    _add_scene_args(p)
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
