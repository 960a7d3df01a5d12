"""Port vs JAX package: the host C++ (``utils/native.py``), ``render_dense``'s
``exact_break`` / ``tile_culling`` and ``multihost.is_coordinator``.

The port's scalar C++ oracle, fed the port's depth-sorted records, against
the JAX package's ``render_dense`` on the same seeded scene in the
configurations of the JAX package's own oracle tests (tests/test_native.py),
at their rtol 1e-4 / atol 1e-5; the port's ``render_dense`` against JAX's
with the reference's exact break and without tile culling; the port's
native COLMAP readers against the Python readers of both packages, values
and dtypes equal; a failed build of the native reader: the port's readers
warn once and return what the JAX package's return, as the JAX package's
fall back; that a corrupt file, and ``*_available()`` on a failing
compiler, still raise; and that the package data ships every source of
the port's csrc/.
"""

import dataclasses
import tomllib
import warnings
from pathlib import Path

import numpy as np
import pytest

from intro_to_gaussian_splatting_tpu.config import (
    CompatConfig as JaxCompat,
    RasterizerConfig as JaxConfig,
)
from intro_to_gaussian_splatting_tpu.io import colmap as jax_colmap
from intro_to_gaussian_splatting_tpu.io import dataset as jax_dataset
from intro_to_gaussian_splatting_tpu.ops.compositing import (
    render_dense as jax_render_dense,
)
from intro_to_gaussian_splatting_tpu.utils import native as jax_native
from intro_to_gaussian_splatting_tpu_torch.io import colmap as port_colmap
from intro_to_gaussian_splatting_tpu_torch.io.dataset import load_scene
from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
    make_colmap_scene,
)
from intro_to_gaussian_splatting_tpu_torch.ops import cuda_build
from intro_to_gaussian_splatting_tpu_torch.ops.compositing import (
    render_dense,
    sorted_records,
)
from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
    project_gaussians,
)
from intro_to_gaussian_splatting_tpu_torch.parallel import multihost
from intro_to_gaussian_splatting_tpu_torch.utils import native
from tests.scenes import small_scene
from tests.test_torch_common import (
    jax_fast,
    np_,
    port_camera,
    port_config,
    port_model,
)

TOL = dict(rtol=1e-4, atol=1e-5)


def _scene(n, seed):
    raw, cam, model = small_scene(n=n, width=48, height=32, seed=seed)
    return cam, model, port_camera(cam), port_model(model)


def _oracle(tmodel, tcam, cfg):
    """The port's oracle image of the port's depth-sorted records."""
    proj = project_gaussians(tmodel, tcam, cfg)
    rec, order = sorted_records(proj)
    return native.oracle_render(np_(rec), np_(proj.valid[order]),
                                tcam.width, tcam.height, cfg)


@pytest.mark.parametrize("cfg", [
    JaxConfig(),
    JaxConfig(compat=JaxCompat.REFERENCE_CUDA, t_threshold=1e-3),
    JaxConfig(alpha_min=1.0 / 255.0),
    # most pixels end early: holds the oracle's permanent break
    JaxConfig(t_threshold=0.1, alpha_clamp=0.5),
], ids=["default", "reference_cuda", "alpha_min", "early_exit"])
def test_oracle_matches_jax_render_dense(cfg):
    cam, model, tcam, tmodel = _scene(120, 31)
    want = np.asarray(jax_fast(jax_render_dense, model, cam, config=cfg))
    got = _oracle(tmodel, tcam, port_config(cfg))
    np.testing.assert_allclose(got, want, **TOL)


def test_oracle_skip_last_tile_matches_exact_break():
    """The reference CPU renderer's margin quirk: the oracle leaves the last
    tile column black and agrees with ``render_dense(exact_break=True)`` of
    both packages."""
    cfg = JaxConfig(compat=JaxCompat.REFERENCE_CPU, t_threshold=1e-6)
    cam, model, tcam, tmodel = _scene(60, 7)
    img = _oracle(tmodel, tcam, port_config(cfg))
    assert np.all(img[:, 32:] == 0.0)
    want = np.asarray(jax_fast(jax_render_dense, model, cam, config=cfg,
                               exact_break=True))
    got = np_(render_dense(tmodel, tcam, port_config(cfg), exact_break=True))
    np.testing.assert_allclose(img, want, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("exact_break,tile_culling", [(True, True),
                                                      (False, False)])
def test_render_dense_options_match_jax(exact_break, tile_culling):
    # many pixels break, and the unclamped alpha of the exact break passes
    # the clamp
    cfg = JaxConfig(t_threshold=0.1, alpha_clamp=0.5)
    cam, model, tcam, tmodel = _scene(120, 31)
    want = np.asarray(jax_fast(jax_render_dense, model, cam, config=cfg,
                               exact_break=exact_break,
                               tile_culling=tile_culling, chunk=64))
    got = np_(render_dense(tmodel, tcam, port_config(cfg),
                           exact_break=exact_break,
                           tile_culling=tile_culling, chunk=64))
    np.testing.assert_allclose(got, want, **TOL)
    default = np_(render_dense(tmodel, tcam, port_config(cfg)))
    assert not np.allclose(got, default, **TOL)


def _fields(x):
    return x if isinstance(x, dict) else dataclasses.asdict(x)


def _assert_same(got, want):
    """Equal values and dtypes, field by field."""
    got, want = _fields(got), _fields(want)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert type(got[k]) is type(want[k]) and got[k] == want[k], k


def test_native_colmap_matches_python_readers(tmp_path, monkeypatch):
    sparse = make_colmap_scene(str(tmp_path), num_points=300, num_cameras=3,
                               device="cpu")
    pts_file, im_file = (f"{sparse}/{f}.bin" for f in ("points3D", "images"))
    pts_native = port_colmap.read_points3D_binary(pts_file)
    im_native = port_colmap.read_images_binary(im_file)
    assert native.colmap_available()
    assert port_colmap.ColmapPoints(
        **native.read_points3d_native(pts_file)).ids.size == 300

    # the Python parsers of both packages
    monkeypatch.setattr(native, "colmap_available", lambda: False)
    monkeypatch.setattr(jax_native, "colmap_available", lambda: False)
    readers = [(port_colmap.read_points3D_binary,
                port_colmap.read_images_binary),
               (jax_colmap.read_points3D_binary,
                jax_colmap.read_images_binary)]
    for read_points, read_images in readers:
        _assert_same(pts_native, read_points(pts_file))
        im_py = read_images(im_file)
        assert list(im_native) == list(im_py)
        for k in im_py:
            _assert_same(im_native[k], im_py[k])


def test_failed_build_falls_back_to_the_python_parser(tmp_path, monkeypatch):
    """A compiler that fails: the readers warn once, run the compiler once,
    write nothing to the build directory and return what the JAX package's
    Python readers return, field for field."""
    scene = tmp_path / "scene"
    sparse = make_colmap_scene(str(scene), num_points=300, num_cameras=3,
                               device="cpu")
    pts_file, im_file = (f"{sparse}/{f}.bin" for f in ("points3D", "images"))
    build = tmp_path / "build"
    monkeypatch.setenv("GSTPU_TORCH_BUILD_DIR", str(build))
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(port_colmap, "_native_build_failed", False)
    monkeypatch.setattr(jax_native, "colmap_available", lambda: False)
    builds = []
    real_build = cuda_build.build

    def counted_build(sources):
        builds.append([src.name for src in sources])
        return real_build(sources)

    monkeypatch.setattr(cuda_build, "build", counted_build)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reads = [(port_colmap.read_points3D_binary(pts_file),
                  port_colmap.read_images_binary(im_file))
                 for _ in range(2)]
        cameras, images, points = port_colmap.read_model(sparse)
        got_scene = load_scene(str(scene), require_images=False,
                               device="cpu")
    assert [str(w.message) for w in caught] == [
        "the native COLMAP reader did not build (build failed: "
        "colmap_reader (false exit 1)); the Python parser reads COLMAP "
        "files instead"]
    assert caught[0].category is RuntimeWarning
    assert builds == [["colmap_reader"]]
    assert not build.exists() or not any(build.iterdir())

    want_cameras, want_images, want_points = jax_colmap.read_model(sparse)
    for pts, ims in reads + [(points, images)]:
        _assert_same(pts, want_points)
        assert list(ims) == list(want_images)
        for k in want_images:
            _assert_same(ims[k], want_images[k])
    assert list(cameras) == list(want_cameras)
    for k in want_cameras:
        _assert_same(cameras[k], want_cameras[k])
    want_scene = jax_dataset.load_scene(str(scene), require_images=False)
    assert got_scene.names == want_scene.names
    assert len(got_scene.cameras) == 3 and got_scene.targets == [None] * 3
    _assert_same(got_scene.points, want_scene.points)


@pytest.mark.parametrize("stem", ["points3D", "images"])
def test_native_colmap_truncated_file_raises(tmp_path, stem):
    sparse = make_colmap_scene(str(tmp_path), num_points=50, num_cameras=2,
                               device="cpu")
    path = f"{sparse}/{stem}.bin"
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) - 5])
    read = {"points3D": port_colmap.read_points3D_binary,
            "images": port_colmap.read_images_binary}[stem]
    with pytest.raises(ValueError, match="corrupt"):
        read(path)


def test_host_libraries_build_from_the_ports_sources(monkeypatch):
    """The port's own copies in csrc/, built into the port's build
    directory: never the JAX package's native/ or utils/_native/."""
    monkeypatch.delenv("GSTPU_TORCH_BUILD_DIR", raising=False)
    port = Path(native.__file__).resolve().parent.parent
    for src in (native.ORACLE_SOURCE, native.COLMAP_SOURCE):
        assert src.path == port / "csrc" / f"{src.name}.cpp"
        assert src.path.is_file()
        assert src.library().parent == port / "_build"
        assert src.flags() == ("-O3", "-march=native", "-fPIC", "-shared",
                               "-std=c++17", "-Wall")


def test_failing_compiler_raises_with_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setenv("GSTPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match=r"oracle \(false exit 1\)"):
        native.oracle_available()
    assert not list((tmp_path / "build").glob("*.so"))
    # no compiler at all: not available, and nothing built
    monkeypatch.setenv("CXX", "no-such-compiler-gstpu")
    assert cuda_build.cxx_path() is None
    assert not native.oracle_available()
    assert not native.colmap_available()


def test_package_data_ships_every_csrc_file():
    """A non-editable install builds the kernels and the host libraries
    from csrc/ at first use: the package data must list all of it."""
    port = Path(native.__file__).resolve().parent.parent
    meta = tomllib.loads((port.parent / "pyproject.toml").read_text())
    patterns = meta["tool"]["setuptools"]["package-data"][port.name]
    shipped = {f for pattern in patterns for f in port.glob(pattern)}
    sources = [f for f in (port / "csrc").rglob("*") if f.is_file()]
    assert {f.suffix for f in sources} == {".cu", ".cpp"}
    assert [f.name for f in sources if f not in shipped] == []


def test_is_coordinator_without_a_process_group():
    assert multihost.is_coordinator()
