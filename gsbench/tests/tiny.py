"""A cell of the benchmark cut to a size the CPU runs in seconds.

Train cells: 300 gaussians, 64x48 pixels, a closer ring (extent 2, radius
5), pairs_per_gaussian 64. Render cells: 2,000 gaussians at 800x528 in
the configuration's own geometry and pool, so that the pixel positions
carry the precision the control takes away. The window is a second long.
The cell's files are found under ``root``, the benchmark's directory by
default.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from gsbench import harness as H


def tiny_cell(name: str, seed: int = 5, trace: bool = False,
              device: str = "cpu", root: Path = H.HERE) -> H.Cell:
    w = H.load_json(root / "workloads" / f"{name}.json")
    cfg = H.load_json(root / "configs" / f"{w['config']}.json")
    p = copy.deepcopy(w["params"])
    if w["traffic"] == "train":
        cfg.update(num_gaussians=300, width=64, height=48, extent=2.0,
                   camera_radius=5.0, camera_z=1.0)
        p.update(setup_steps=4, log_every=2, trace_steps=4, stage_reps=1)
        p["rasterizer"]["pairs_per_gaussian"] = 64
    else:
        cfg.update(num_gaussians=2000, width=800, height=528)
        p.update(cameras=4, trace_views=3, warm_views=1)
    return H.Cell(name=name, config=cfg, traffic=w["traffic"], params=p,
                  limits=w["limits"], seed=seed, seconds=1.0, trace=trace,
                  device=torch.device(device), t_start=time.perf_counter())


def run_tiny(cell: H.Cell, control: bool = False) -> H.Outcome:
    traffic = H.load_module(H.HERE / "traffic" / f"{cell.traffic}.py")
    return traffic.control(cell) if control else traffic.run(cell)
