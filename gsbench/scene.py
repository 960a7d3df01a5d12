"""The inputs of a run, made from its seed on the run's device: the point
cloud, the initial gaussian parameters, the camera poses and the training
targets. Both sides, the program and the reference, get the same.

A configuration's ``init`` names its scene recipe: ``"knn3"`` or
``"constant"``, the two built here, or a file ``scenes/<init>.py`` that
defines ``initial_params(cfg, xyz, rgb, capacity, gen, sh_rest_std)`` and
may define ``point_cloud(cfg, gen, device)``; both sides are fed from it,
so it imports nothing of the program.

The point cloud follows the recipe of ``random_point_cloud`` in the
repository's synthetic scenes (80% normal about the origin with a standard
deviation of a quarter of the extent, 20% uniform in the extent's cube,
colours uniform in 0-255), drawn with a ``torch.Generator`` in a few large
calls. Cameras sit on a ring looking at the origin, each jittered by up to
0.05 rad. Targets are smooth images: a ramp and a low-frequency wave per
channel, each with coefficients drawn from the seed.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from gsbench.harness import load_module

SH_C0 = 0.28209479177387814
SCENES = Path(__file__).resolve().parent / "scenes"
BUILT_IN = ("knn3", "constant")


def recipe(init: str):
    """The module of the recipe file ``scenes/<init>.py``, or None for a
    built-in recipe; any other ``init`` raises, naming the recipes."""
    if init in BUILT_IN:
        return None
    path = SCENES / f"{init}.py"
    if path.parent != SCENES or not path.is_file():
        files = sorted(p.stem for p in SCENES.glob("*.py"))
        raise ValueError(f"unknown init {init!r}: the recipes are "
                         f"{list(BUILT_IN) + files}")
    return load_module(path)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def point_cloud(cfg: dict, gen: torch.Generator, device):
    """(xyz (N, 3) float32, rgb (N, 3) float32 in 0-255): the recipe's
    own, where its file defines ``point_cloud``."""
    module = recipe(cfg["init"])
    if module is not None and hasattr(module, "point_cloud"):
        return module.point_cloud(cfg, gen, device)
    n, extent = cfg["num_gaussians"], float(cfg["extent"])
    n_core = int(n * 0.8)
    core = torch.randn((n_core, 3), generator=gen, device=device) * (
        extent * 0.25)
    bg = (torch.rand((n - n_core, 3), generator=gen, device=device) * 2.0
          - 1.0) * extent
    rgb = torch.randint(0, 256, (n, 3), generator=gen, device=device)
    return torch.cat([core, bg]), rgb.to(torch.float32)


def knn_mean_distance(xyz: torch.Tensor, k: int = 3,
                      chunk: int = 512) -> torch.Tensor:
    """Mean distance of each point to its k nearest other points, from
    exact coordinate differences, ``chunk`` queries at a time."""
    n = xyz.shape[0]
    out = torch.empty(n, device=xyz.device)
    for lo in range(0, n, chunk):
        q = xyz[lo:lo + chunk]
        d2 = torch.sum((q[:, None, :] - xyz[None, :, :]) ** 2, dim=-1)
        rows = torch.arange(q.shape[0], device=xyz.device)
        d2[rows, rows + lo] = float("inf")
        near = torch.topk(d2, k, dim=1, largest=False).values
        out[lo:lo + chunk] = torch.sqrt(near).mean(dim=1)
    return out


def initial_params(cfg: dict, xyz: torch.Tensor, rgb: torch.Tensor,
                   capacity: int, gen: torch.Generator,
                   sh_rest_std: float = 0.0):
    """(params, active) of a pool of ``capacity`` slots, the first N the
    points, by the configuration's recipe (``"init"``): ``"knn3"`` scales
    each point by its mean 3-NN distance, ``"constant"`` by ``scale``, both
    round and unrotated on ``pool``; a recipe file's ``initial_params``
    returns the same five leaves."""
    module = recipe(cfg["init"])
    if module is not None:
        params, active = module.initial_params(cfg, xyz, rgb, capacity, gen,
                                               sh_rest_std)
        _check_pool(cfg, params, active, capacity, xyz.device.type)
        return params, active
    params, active = pool(cfg, xyz, rgb, capacity, gen, sh_rest_std)
    n = xyz.shape[0]
    if cfg["init"] == "knn3":
        d = torch.clamp(knn_mean_distance(xyz), min=1e-7)
        params["log_scales"][:n] = torch.log(d)[:, None]
    else:
        params["log_scales"][:n] = math.log(cfg["scale"])
    return params, active


def pool(cfg: dict, xyz: torch.Tensor, rgb: torch.Tensor, capacity: int,
         gen: torch.Generator, sh_rest_std: float = 0.0):
    """(params, active) of a pool of ``capacity`` slots, the first N the
    points: identity rotations, ``opacity``, the colours as the DC SH
    coefficient and the higher coefficients 0 (or normal with
    ``sh_rest_std``), and every scale 1e-3 for the recipe to set. Free
    slots: position 0, scale 1e-3, opacity logit -20, colour 0."""
    n = xyz.shape[0]
    dev = xyz.device
    k = (cfg["sh_degree"] + 1) ** 2
    means = torch.zeros((capacity, 3), device=dev)
    means[:n] = xyz
    log_scales = torch.full((capacity, 3), math.log(1e-3), device=dev)
    quats = torch.zeros((capacity, 4), device=dev)
    quats[:, 0] = 1.0
    op = cfg["opacity"]
    logits = torch.full((capacity,), -20.0, device=dev)
    logits[:n] = math.log(op / (1.0 - op))
    sh = torch.zeros((capacity, k, 3), device=dev)
    sh[:n, 0] = (rgb / 256.0 - 0.5) / SH_C0
    if sh_rest_std > 0.0 and k > 1:
        sh[:n, 1:] = torch.randn((n, k - 1, 3), generator=gen,
                                 device=dev) * sh_rest_std
    active = torch.zeros(capacity, dtype=torch.bool, device=dev)
    active[:n] = True
    return dict(means=means, log_scales=log_scales, quats=quats,
                opacity_logits=logits, sh=sh), active


def _check_pool(cfg: dict, params: dict, active: torch.Tensor,
                capacity: int, device_type: str) -> None:
    """A recipe's pool has the built-ins' leaves, shapes and types: the
    port's kernels read them by their strides."""
    k = (cfg["sh_degree"] + 1) ** 2
    shapes = dict(means=(capacity, 3), log_scales=(capacity, 3),
                  quats=(capacity, 4), opacity_logits=(capacity,),
                  sh=(capacity, k, 3))
    got = {name: (tuple(t.shape), t.dtype, t.device.type)
           for name, t in params.items()}
    want = {name: (shape, torch.float32, device_type)
            for name, shape in shapes.items()}
    if got != want or (tuple(active.shape), active.dtype) != (
            (capacity,), torch.bool):
        raise ValueError(f"recipe {cfg['init']!r} returned {got}, active "
                         f"{tuple(active.shape)} {active.dtype}; want "
                         f"{want}, active ({capacity},) torch.bool")


def extent_of(xyz: torch.Tensor) -> float:
    """Radius of the cloud's bounding sphere about its mean."""
    return float(torch.linalg.vector_norm(xyz - xyz.mean(dim=0),
                                          dim=1).max())


def ring_poses(cfg: dict, count: int, seed: int):
    """[(R (3, 3), t (3,))] world -> camera (x_cam = R x + t), +z forward,
    +y down, on a ring of ``camera_radius`` at height ``camera_z``."""
    rng = np.random.default_rng(seed)
    radius, z = cfg["camera_radius"], cfg["camera_z"]
    poses = []
    for i in range(count):
        theta = 2 * np.pi * i / count + rng.uniform(-0.05, 0.05)
        eye = np.array([radius * np.cos(theta), radius * np.sin(theta), z])
        forward = -eye / np.linalg.norm(eye)
        right = np.cross(forward, np.array([0.0, 0.0, -1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        R = np.stack([right, down, forward])
        poses.append((R, -R @ eye))
    return poses


def quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation -> wxyz unit quaternion (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def targets(cfg: dict, count: int, gen: torch.Generator, device):
    """``count`` smooth (H, W, 3) float32 images in [0, 1]."""
    h, w = cfg["height"], cfg["width"]
    yy = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    xx = torch.linspace(0.0, 1.0, w, device=device)[None, :]
    coef = torch.rand((count, 3, 6), generator=gen, device=device)
    out = []
    for i in range(count):
        chans = []
        for c in range(3):
            a, b, f1, f2, ph, amp = coef[i, c].tolist()
            wave = torch.sin(2 * math.pi * ((1 + 3 * f1) * xx
                                            + (1 + 3 * f2) * yy) + 6.3 * ph)
            chans.append(torch.clamp(0.2 + 0.3 * a * yy + 0.3 * b * xx
                                     + 0.2 * amp * wave, 0.0, 1.0))
        out.append(torch.stack(chans, dim=-1).contiguous())
    return out
