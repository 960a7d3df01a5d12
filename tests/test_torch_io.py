"""Port vs JAX package: scene IO on the CPU.

PLY files byte for byte the JAX package's (with and without the 3DGS extra
properties) and each package reading the other's; the COLMAP binary
writers byte for byte; ``make_colmap_scene``'s sparse model byte for byte
for the same seed, its ground-truth images within 1/255 (the port renders
them with its dense oracle, the JAX package with its own, both quantised
to 8 bits); ``load_scene`` equal to the JAX package's (cameras to 1e-6,
decoded targets and names exactly) from the scene root, ``sparse`` and
``sparse/0`` and from a numeric scene root; ``split_holdout``. Both
packages decode images with PIL.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from intro_to_gaussian_splatting_tpu.io import colmap as jc
from intro_to_gaussian_splatting_tpu.io import dataset as jd
from intro_to_gaussian_splatting_tpu.io import ply as jply
from intro_to_gaussian_splatting_tpu.io import synthetic as js
from intro_to_gaussian_splatting_tpu_torch.convert import CAMERA_TENSORS
from intro_to_gaussian_splatting_tpu_torch.io import colmap as pc
from intro_to_gaussian_splatting_tpu_torch.io import dataset as pd
from intro_to_gaussian_splatting_tpu_torch.io import ply as pply
from intro_to_gaussian_splatting_tpu_torch.io import synthetic as ps
from tests.test_torch_common import np_

SCENE = dict(num_points=120, num_cameras=3, width=48, height=32, seed=2,
             write_images=True)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same synthetic scene written by each package."""
    root = tmp_path_factory.mktemp("scenes")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    js.make_colmap_scene(jax_dir, **SCENE)
    ps.make_colmap_scene(port_dir, device="cpu", **SCENE)
    return jax_dir, port_dir


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("extra", [False, True])
def test_ply_bytes_match_jax_and_read_across(tmp_path, extra):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(17, 3)).astype(np.float32)
    kwargs = dict(rgb=rng.integers(0, 256, size=(17, 3)).astype(np.uint8))
    if extra:
        kwargs = dict(extra={"f_dc": rng.normal(size=(17, 3)),
                             "opacity": rng.normal(size=17),
                             "f_rest": rng.normal(size=(17, 9))})
    jpath, ppath = str(tmp_path / "j.ply"), str(tmp_path / "p.ply")
    jply.write_ply(jpath, xyz, **kwargs)
    pply.write_ply(ppath, xyz, **kwargs)
    assert _read(jpath) == _read(ppath)
    for mine, theirs in ((pply.read_ply(jpath), jply.read_ply(jpath)),
                         (jply.read_ply(ppath), pply.read_ply(ppath))):
        assert list(mine) == list(theirs)
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])


def test_colmap_writers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    cams = {c: dict(id=c, model="PINHOLE", width=64, height=48,
                    params=rng.uniform(10, 60, size=4)) for c in (1, 2)}
    ims = {i: dict(id=i, qvec=rng.normal(size=4), tvec=rng.normal(size=3),
                   camera_id=1 + i % 2, name=f"im_{i}.png",
                   xys=rng.uniform(0, 64, size=(5, 2)),
                   point3D_ids=rng.integers(-1, 40, size=5))
           for i in (1, 2, 3)}
    pts = dict(ids=np.arange(1, 7), xyz=rng.normal(size=(6, 3)),
               rgb=rng.integers(0, 256, size=(6, 3)),
               error=rng.uniform(size=6),
               track_lengths=np.array([1, 2, 0, 3, 1, 2]),
               track_image_ids=rng.integers(1, 4, size=9),
               track_point2D_idxs=rng.integers(0, 5, size=9))
    for pkg, d in ((jc, "j"), (pc, "p")):
        os.makedirs(tmp_path / d)
        pkg.write_cameras_binary({k: pkg.ColmapCamera(**v)
                                  for k, v in cams.items()},
                                 str(tmp_path / d / "cameras.bin"))
        pkg.write_images_binary({k: pkg.ColmapImage(**v)
                                 for k, v in ims.items()},
                                str(tmp_path / d / "images.bin"))
        pkg.write_points3D_binary(pkg.ColmapPoints(**pts),
                                  str(tmp_path / d / "points3D.bin"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert _read(tmp_path / "j" / name) == _read(tmp_path / "p" / name)


def test_make_colmap_scene_matches_jax(scenes):
    jax_dir, port_dir = scenes
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (_read(os.path.join(jax_dir, "sparse", "0", name))
                == _read(os.path.join(port_dir, "sparse", "0", name)))
    from PIL import Image

    names = sorted(os.listdir(os.path.join(jax_dir, "images")))
    assert names == sorted(os.listdir(os.path.join(port_dir, "images")))
    assert names == ["im_0001.png", "im_0002.png", "im_0003.png"]
    for n in names:
        a, b = (np.asarray(Image.open(os.path.join(d, "images", n)),
                           dtype=np.int32) for d in scenes)
        assert a.shape == (32, 48, 3) and np.abs(a - b).max() <= 1
        assert a.std() > 0


def _assert_scenes_equal(port, jax_scene):
    assert port.names == jax_scene.names
    assert len(port.cameras) == len(jax_scene.cameras)
    for pcam, jcam in zip(port.cameras, jax_scene.cameras):
        assert (pcam.width, pcam.height) == (jcam.width, jcam.height)
        for name in CAMERA_TENSORS:
            np.testing.assert_allclose(np_(getattr(pcam, name)),
                                       np.asarray(getattr(jcam, name)),
                                       rtol=1e-6, atol=1e-6)
    for a, b in zip(port.targets, jax_scene.targets):
        np.testing.assert_array_equal(a, b)
    for f in dataclasses.fields(port.points):
        np.testing.assert_array_equal(getattr(port.points, f.name),
                                      getattr(jax_scene.points, f.name))


def test_load_scene_matches_jax(scenes, tmp_path):
    jax_dir = scenes[0]
    for arg in (jax_dir, jax_dir + "/sparse", jax_dir + "/sparse/0"):
        scene = pd.load_scene(arg, device="cpu")
        assert len(scene.cameras) == 3
        assert scene.targets[0].shape == (32, 48, 3)
        _assert_scenes_equal(scene, jd.load_scene(arg))
    # a numeric scene root holding the model files: images at <root>/images
    root = tmp_path / "360"
    root.mkdir()
    for f in os.listdir(os.path.join(jax_dir, "sparse", "0")):
        shutil.copy(os.path.join(jax_dir, "sparse", "0", f), root / f)
    shutil.copytree(os.path.join(jax_dir, "images"), root / "images")
    (tmp_path / "images").mkdir()                  # a decoy at the parent
    scene = pd.load_scene(str(root), device="cpu")
    assert len(scene.cameras) == 3
    _assert_scenes_equal(scene, jd.load_scene(str(root)))
    # downscaled, and a photo missing on disk
    os.remove(root / "images" / "im_0002.png")
    for kwargs in (dict(downscale=2), dict(require_images=False)):
        _assert_scenes_equal(pd.load_scene(str(root), device="cpu", **kwargs),
                             jd.load_scene(str(root), **kwargs))


def test_split_holdout(scenes):
    scene = pd.load_scene(scenes[1], device="cpu")
    want = jd.load_scene(scenes[1])
    for every in (0, 2, 3, 8):
        for mine, theirs in zip(scene.split_holdout(every),
                                want.split_holdout(every)):
            assert mine.names == theirs.names
            assert mine.points is scene.points
    train, held = scene.split_holdout(2)
    assert held.names == ["im_0001.png", "im_0003.png"]
    assert train.names == ["im_0002.png"]
