"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX (the JAX package's parity tests are in the other
test_torch_*.py files), so that its ``cuda`` tests run on a machine with a
card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Each ``cuda`` test takes the ``cuda_device`` fixture, which skips when there
is no card. The CPU tests check what the wrappers do without one: the plain
versions run and nothing is built.
"""

import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu_torch.config import (
    CompatConfig,
    RasterizerConfig,
)
from intro_to_gaussian_splatting_tpu_torch.io.synthetic import ring_cameras
from intro_to_gaussian_splatting_tpu_torch.models import (
    GaussianModel,
    make_camera,
)
from intro_to_gaussian_splatting_tpu_torch.ops import cuda_build
from intro_to_gaussian_splatting_tpu_torch.ops import rasterize as tr
from intro_to_gaussian_splatting_tpu_torch.ops import relayout as tl
from intro_to_gaussian_splatting_tpu_torch.ops.binning import (
    bin_gaussians,
    num_groups_for,
    tile_grid,
)
from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
    project_gaussians,
)
from intro_to_gaussian_splatting_tpu_torch.ops.render import render

CFG = RasterizerConfig(chunk_size=128, pairs_per_gaussian=32, group_tiles=2)
# kernel and plain version round alike (-fmad=false); the tolerance is the
# one the JAX package's kernel tests use
TOL = dict(rtol=1e-4, atol=1e-5)
CASES = {
    "early_exit": (dict(n=400, width=48, height=32, seed=3, opacity_hi=6.0),
                   CFG),
    "partial_tiles": (dict(n=80, width=40, height=24, seed=5), CFG),
    "reference_cuda_alpha_min": (
        dict(n=80, width=48, height=32, seed=7),
        RasterizerConfig(chunk_size=128, pairs_per_gaussian=32,
                         group_tiles=3, groups_per_step=2, t_threshold=1e-3,
                         alpha_min=1.0 / 255.0,
                         compat=CompatConfig.REFERENCE_CUDA)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernel test")
    return torch.device("cuda")


def _scene(device, n, width, height, seed, opacity_hi=4.0):
    """Random gaussians in front of a ring camera, made with numpy."""
    rng = np.random.default_rng(seed)
    qvec, tvec = ring_cameras(1, width, height, radius=5.0, z=1.0,
                              seed=seed)[0]

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    model = GaussianModel(
        means=f32(rng.normal(0.0, 1.2, size=(n, 3))),
        sh=f32(rng.uniform(0.0, 1.0, size=(n, 3)))[:, None, :],
        log_scales=f32(np.log(rng.uniform(0.02, 0.25, size=(n, 3)))),
        quats=f32(rng.normal(size=(n, 4))),
        opacity_logits=f32(rng.uniform(-2.0, opacity_hi, size=(n,))),
        active=torch.ones(n, dtype=torch.bool, device=device),
        color_space="rgb")
    focal = 0.9 * max(width, height)
    cam = make_camera(focal, focal, width, height, qvec, tvec, device=device)
    return model, cam


def _bins(case, device):
    kw, cfg = CASES[case]
    model, cam = _scene(device, **kw)
    ntx, nty = tile_grid(cam.width, cam.height, cfg.tile_size)
    with torch.no_grad():
        bins = bin_gaussians(project_gaussians(model, cam, cfg), cam.width,
                             cam.height, cfg)
    return cfg, num_groups_for(ntx * nty, cfg), bins


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU the wrappers run the plain versions and never build or
    launch a kernel."""
    def no_build(*args):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(cuda_build, "build", no_build)
    before = (tr.RASTERIZE_FWD.launches, tl.UNTILE_CHW.launches)
    cfg, ng, bins = _bins("early_exit", "cpu")
    args = (bins.pair_records, bins.tile_starts, bins.tile_counts, ng, cfg)
    tiles = tr.rasterize_pairs(*args)
    torch.testing.assert_close(tiles, tr.rasterize_pairs_reference(*args),
                               rtol=0, atol=0)
    ntx, nty = tile_grid(48, 32, 16)
    assert torch.equal(tl.untile_chw_fast(tiles, ntx, nty, 16, 32, 48),
                       tl.untile_chw(tiles[:, :3], ntx, nty, 16, 32, 48))
    assert (tr.RASTERIZE_FWD.launches, tl.UNTILE_CHW.launches) == before


def test_kernel_build_flags():
    for src in (tr.RASTERIZE_SOURCE, tl.UNTILE_SOURCE):
        assert src.path.is_file()
        flags = cuda_build.NVCC_FLAGS + src.extra_flags
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "--use_fast_math" not in flags
        assert "__expf(" not in src.path.read_text()
        assert src.library().name.startswith(f"lib{src.name}-")
    assert "-fmad=false" in tr.RASTERIZE_SOURCE.extra_flags


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_b1_kernel_matches_plain_on_card(case, cuda_device):
    cfg, ng, bins = _bins(case, cuda_device)
    args = (bins.pair_records, bins.tile_starts, bins.tile_counts, ng, cfg)
    before = tr.RASTERIZE_FWD.launches
    got = tr.rasterize_pairs(*args)
    torch.cuda.synchronize()
    assert tr.RASTERIZE_FWD.launches == before + 1
    torch.testing.assert_close(got, tr.rasterize_pairs_reference(*args),
                               **TOL)
    assert got.abs().sum() > 0


@pytest.mark.cuda
def test_b1_kernel_checks_its_inputs(cuda_device):
    cfg, ng, bins = _bins("partial_tiles", cuda_device)
    with pytest.raises(ValueError, match="tile_starts"):
        tr.rasterize_pairs(bins.pair_records, bins.tile_starts.long(),
                           bins.tile_counts, ng, cfg)
    with pytest.raises(ValueError, match="records"):
        tr.rasterize_pairs(bins.pair_records[:8], bins.tile_starts,
                           bins.tile_counts, ng, cfg)
    too_long = bins.tile_counts.clone()
    too_long[-1] = bins.pair_records.shape[1]
    with pytest.raises(ValueError, match="outside the record stream"):
        tr.rasterize_pairs(bins.pair_records, bins.tile_starts, too_long, ng,
                           cfg)


@pytest.mark.cuda
def test_b5_kernel_matches_plain_on_card(cuda_device):
    w, h, ts, gt = 84, 52, 16, 4
    ntx, nty = tile_grid(w, h, ts)
    ng = num_groups_for(ntx * nty, RasterizerConfig(group_tiles=gt))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tiles = torch.randn((ng, 5, gt, ts * ts), generator=gen,
                        device=cuda_device)
    before = tl.UNTILE_CHW.launches
    got = tl.untile_chw_fast(tiles, ntx, nty, ts, h, w)
    torch.cuda.synchronize()
    assert tl.UNTILE_CHW.launches == before + 1
    assert torch.equal(got, tl.untile_chw(tiles[:, :3], ntx, nty, ts, h, w))
    with pytest.raises(ValueError, match="contiguous"):
        tl.untile_chw_fast(tiles.transpose(0, 1), ntx, nty, ts, h, w)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda_device):
    kw, cfg = CASES["early_exit"]
    renders = {}
    for device in ("cpu", cuda_device):
        model, cam = _scene(device, **kw)
        with torch.no_grad():
            renders[str(device)] = render(model, cam, cfg).cpu()
    torch.testing.assert_close(renders["cuda"], renders["cpu"], **TOL)
