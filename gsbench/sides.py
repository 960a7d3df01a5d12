"""What both traffic kinds hand each side: the program's model and cameras
built from the run's inputs, the reference's cameras from the same poses,
and the reference's count of the work of a set of views."""

from __future__ import annotations

import statistics

from gsbench import scene
from gsbench.reference.camera import make_ref_camera
from gsbench.reference.render import render_view
from gsbench.reference.train import NAMES


def focal(cfg: dict) -> float:
    return cfg["focal_per_width"] * cfg["width"]


def program_scene(cell, params: dict, active, poses):
    """(the port's GaussianModel, its Cameras) of the run's inputs; the
    model holds copies, which the program may update in place."""
    from intro_to_gaussian_splatting_tpu_torch.models.camera import (
        make_camera,
    )
    from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
        GaussianModel,
    )

    cfg = cell.config
    model = GaussianModel(**{k: params[k].clone() for k in NAMES},
                          active=active.clone(), color_space="sh")
    cams = [make_camera(focal(cfg), focal(cfg), cfg["width"], cfg["height"],
                        scene.quaternion(R), t, device=cell.device)
            for R, t in poses]
    return model, cams


def reference_cameras(cell, poses):
    cfg = cell.config
    return [make_ref_camera(R, t, focal(cfg), cfg["width"], cfg["height"],
                            cell.device) for R, t in poses]


def work_counts(cell, params: dict, active, ref_cams,
                sh_degree: int) -> dict:
    """The reference's count of the work of one view, mean over
    ``ref_cams``, with the sizes the counts need."""
    rast = cell.rasterizer()
    each = [render_view(params, active, cam, rast, sh_degree)[1]
            for cam in ref_cams]
    counts = {k: statistics.fmean(c[k] for c in each) for k in each[0]}
    cfg, ts = cell.config, rast["tile_size"]
    counts.update(width=cfg["width"], height=cfg["height"],
                  tiles=-(-cfg["width"] // ts) * -(-cfg["height"] // ts),
                  tile_size=ts, slots=int(active.sum()),
                  sh_degree=sh_degree,
                  sh_coeffs=(cfg["sh_degree"] + 1) ** 2)
    return counts
