"""Scene dataset loading: a COLMAP model with its ground-truth images.

The port's copy of the JAX package's ``io/dataset.py``: the train and eval
commands share one loader that pairs every COLMAP image record with its
decoded photo (when it is on disk) and the matching Camera, on the device
the caller names (the card unless it asks for the CPU). Images are decoded
with PIL exactly as the JAX package decodes them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SceneData:
    """One COLMAP scene with decoded ground truth.

    cameras[i] / targets[i] / names[i] line up; targets are float32
    (H, W, 3) numpy arrays in [0, 1] (None for a missing photo when the
    loader was asked not to require them). ``points`` is the
    track-filtered sparse cloud used for gaussian init.
    """

    cameras: List            # list[models.camera.Camera]
    targets: List[Optional[np.ndarray]]
    names: List[str]
    points: "object"          # io.colmap.ColmapPoints

    def split_holdout(self, every: int):
        """(train, holdout) split: every ``every``-th view is held out (the
        Mip-NeRF-360 protocol holds out every 8th). ``every <= 0`` returns
        (self, empty)."""
        tr_idx = [i for i in range(len(self.cameras))
                  if every <= 0 or i % every != 0]
        ho_idx = [i for i in range(len(self.cameras))
                  if every > 0 and i % every == 0]

        def pick(idx):
            return SceneData(
                cameras=[self.cameras[i] for i in idx],
                targets=[self.targets[i] for i in idx],
                names=[self.names[i] for i in idx],
                points=self.points)

        return pick(tr_idx), pick(ho_idx)


def resolve_sparse(path: str) -> str:
    """Find the COLMAP model dir under ``path`` (accepts the scene root,
    ``sparse`` or ``sparse/0`` itself)."""
    for cand in (path, os.path.join(path, "sparse", "0"),
                 os.path.join(path, "sparse"), os.path.join(path, "0")):
        if os.path.exists(os.path.join(cand, "cameras.bin")) or \
           os.path.exists(os.path.join(cand, "cameras.txt")):
            return cand
    raise FileNotFoundError(f"no COLMAP model found under {path}")


def image_root(sparse: str) -> str:
    """The images directory of a scene whose model is at ``sparse``: a
    sibling of ``sparse/`` under the scene root. Numeric components are
    stripped only when they sit under a ``sparse`` directory: a scene whose
    own directory name is numeric (``/data/360`` holding ``cameras.bin``)
    keeps its images at ``<scene>/images``."""
    root = os.path.normpath(sparse)
    probe = root
    while os.path.basename(probe).isdigit():
        probe = os.path.dirname(probe)
    if os.path.basename(probe) == "sparse":
        root = os.path.dirname(probe)
    return os.path.join(root, "images")


def load_scene(scene_dir: str, downscale: int = 1, min_track: int = 2,
               image_dir: Optional[str] = None,
               require_images: bool = True, device=None) -> SceneData:
    """Load a COLMAP scene plus its ground-truth images.

    Images are searched under ``<scene_dir>/images`` (the Mip-NeRF-360
    layout) and decoded with PIL at the camera's (downscaled) resolution.
    Images missing on disk are skipped; with ``require_images=False`` a
    missing photo yields ``targets[i] = None`` (render-only flows). The
    cameras live on ``device``.
    """
    from PIL import Image

    from intro_to_gaussian_splatting_tpu_torch.io.colmap import read_model
    from intro_to_gaussian_splatting_tpu_torch.models.camera import (
        camera_from_colmap,
    )

    sparse = resolve_sparse(scene_dir)
    cameras, images, points = read_model(sparse)
    points = points.filter_by_track_length(min_track)
    image_dir = image_dir or image_root(sparse)

    cams, targets, names = [], [], []
    for iid in sorted(images):
        im = images[iid]
        cam = camera_from_colmap(cameras[im.camera_id], im, downscale,
                                 device=device)
        path = os.path.join(image_dir, im.name)
        if os.path.exists(path):
            pil = Image.open(path).resize((cam.width, cam.height))
            target = np.asarray(pil, dtype=np.float32)[..., :3] / 255.0
        elif require_images:
            continue
        else:
            target = None
        cams.append(cam)
        targets.append(target)
        names.append(im.name)
    return SceneData(cameras=cams, targets=targets, names=names,
                     points=points)
