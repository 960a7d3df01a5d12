"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX (the JAX package's parity tests are in the other
test_torch_*.py files), so that its ``cuda`` tests run on a machine with a
card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Each ``cuda`` test takes the ``cuda_device`` fixture, which skips when there
is no card. The CPU tests check what the wrappers do without one: the plain
versions run and nothing is built.

Tolerances: B1 rtol 1e-4 / atol 1e-5 (kernel and plain version round alike,
-fmad=false); B2, B3 and B4b gradients a relative L2 difference <= 1e-4
(the kernels sum pixels in a tree, the plain versions with torch.sum or
through conv2d), B3's value and MSE and B4a's value rel 1e-5; B4c against
B4a and B4b, value rel 1e-6 and gradient relative L2 1e-5; the relayouts
and P1 exactly equal; P2 relative L2 1e-6 (its three payload sums taken
in another order); G1 relative L2 1e-5 against its plain version (direct
sums against differences of running sums), and no further than it from
the float64 sums; J1 equal to its plain version but for the fields and
ulps that ``test_projection_kernels_match_plain_on_card`` names, J2 within
relative L2 1e-5 of autograd through the plain version (the same chain
rule, its terms added in another order). Every kernel's output is the same
bit for bit from one launch to the next.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu_torch.config import (
    CompatConfig,
    RasterizerConfig,
    TrainConfig,
)
from intro_to_gaussian_splatting_tpu_torch.io.synthetic import ring_cameras
from intro_to_gaussian_splatting_tpu_torch.models import (
    GaussianModel,
    make_camera,
)
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    covariance_3d_channels,
)
from intro_to_gaussian_splatting_tpu_torch.ops import binning as tb
from intro_to_gaussian_splatting_tpu_torch.ops import cuda_build
from intro_to_gaussian_splatting_tpu_torch.ops import fused_loss as tf
from intro_to_gaussian_splatting_tpu_torch.ops import probe as tp
from intro_to_gaussian_splatting_tpu_torch.ops import projection as tj
from intro_to_gaussian_splatting_tpu_torch.ops import rasterize as tr
from intro_to_gaussian_splatting_tpu_torch.ops import relayout as tl
from intro_to_gaussian_splatting_tpu_torch.ops import ssim as ts
from intro_to_gaussian_splatting_tpu_torch.ops.binning import (
    bin_gaussians,
    num_groups_for,
    tile_grid,
)
from intro_to_gaussian_splatting_tpu_torch.ops.compositing import render_dense
from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
    GRAD_ROWS,
    project_gaussians,
)
from intro_to_gaussian_splatting_tpu_torch.ops.render import render
from intro_to_gaussian_splatting_tpu_torch.train import trainer as T
from tests import binning_cases

REPO = Path(__file__).resolve().parent.parent
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


def _scene(device, n, width, height, seed, opacity_hi=4.0,
           scales=(0.02, 0.25)):
    """Random gaussians in front of a ring camera, made with numpy."""
    rng = np.random.default_rng(seed)
    qvec, tvec = ring_cameras(1, width, height, radius=5.0, z=1.0,
                              seed=seed)[0]

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    model = GaussianModel(
        means=f32(rng.normal(0.0, 1.2, size=(n, 3))),
        sh=f32(rng.uniform(0.0, 1.0, size=(n, 3)))[:, None, :],
        log_scales=f32(np.log(rng.uniform(*scales, size=(n, 3)))),
        quats=f32(rng.normal(size=(n, 4))),
        opacity_logits=f32(rng.uniform(-2.0, opacity_hi, size=(n,))),
        active=torch.ones(n, dtype=torch.bool, device=device),
        color_space="rgb")
    focal = 0.9 * max(width, height)
    cam = make_camera(focal, focal, width, height, qvec, tvec, device=device)
    return model, cam


def _bins(case, device, cfg=None):
    """The scene of ``CASES[case]`` binned with its config (or ``cfg``)."""
    kw, case_cfg = CASES[case]
    cfg = cfg or case_cfg
    model, cam = _scene(device, **kw)
    ntx, nty = tile_grid(cam.width, cam.height, cfg.tile_size)
    with torch.no_grad():
        bins = bin_gaussians(project_gaussians(model, cam, cfg), cam.width,
                             cam.height, cfg)
    return cfg, num_groups_for(ntx * nty, cfg), bins


KERNELS = (tr.RASTERIZE_FWD, tr.RASTERIZE_BWD, tf.FUSED_LOSS, tl.UNTILE_CHW,
           tl.TILE_CHW, ts.SSIM_SUM, ts.SSIM_GRAD, ts.SSIM_VALUE_GRAD,
           tp.PROBE_ZERO, tp.PROBE_WINDOW, tb.SEGMENT_SUMS, tj.PROJECT_FWD,
           tj.PROJECT_BWD)


def rel_l2(got, want):
    got, want = got.double(), want.double()
    den = torch.linalg.norm(want)
    return float(torch.linalg.norm(got - want) / den) if den else float(
        torch.linalg.norm(got))


def ulps(got, want) -> int:
    """The largest distance between two float32 tensors in units in the
    last place (0 and -0 alike)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    if not got.numel():
        return 0
    return int((ordered(got) - ordered(want)).abs().max())


# the projection's float outputs, which carry a gradient
PROJ_FIELDS = ("mean2d", "depth", "conic", "color", "opacity")


def _projection_scene(device, n, seed, coeffs=16, edges=False, width=64,
                      height=48):
    """A seeded model of ``n`` gaussians (``coeffs`` SH coefficients, or
    raw RGB where ``coeffs`` is 0) around the origin and a ring camera
    looking at it, made with numpy. ``edges`` puts slots 0-7 behind the camera, makes 8-11
    inactive, 12-19 straddle the near plane (depth 0.2 within a few
    float32 ulps), gives 20-39 scales of 1e-4 (determinant under
    ``det_clamp``) and 40-59 round scales (discriminant under
    ``eig_floor``)."""
    rng = np.random.default_rng(seed)
    qvec, tvec = ring_cameras(1, width, height, radius=5.0, z=1.0,
                              seed=seed)[0]
    focal = 0.9 * max(width, height)
    cam = make_camera(focal, focal, width, height, qvec, tvec, device=device)
    means = rng.normal(0.0, 1.2, size=(n, 3))
    log_scales = np.log(rng.uniform(0.02, 0.25, size=(n, 3)))
    active = np.ones(n, bool)
    if edges:
        center = cam.cam_center.double().cpu().numpy()
        forward = cam.world2view[:3, 2].double().cpu().numpy()
        means[:8] = 1.5 * center + rng.normal(0.0, 0.1, size=(8, 3))
        active[8:12] = False
        near = 0.2 * (1.0 + np.arange(-4, 4) * 3e-7)
        means[12:20] = center + near[:, None] * forward
        log_scales[20:40] = np.log(1e-4)
        log_scales[40:60] = log_scales[40:60, :1]
    color = "rgb" if coeffs == 0 else "sh"

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    model = GaussianModel(
        means=f32(means), log_scales=f32(log_scales),
        quats=f32(rng.normal(size=(n, 4))),
        opacity_logits=f32(rng.uniform(-3.0, 4.0, size=(n,))),
        sh=f32(rng.uniform(0.0, 1.0, size=(n, 1, 3)) if color == "rgb"
               else rng.normal(0.0, 0.4, size=(n, coeffs, 3))),
        active=torch.as_tensor(active, device=device), color_space=color)
    return model, cam


def _cotangents(proj, seed, device):
    """Seeded standard-normal cotangents of the projection's float
    outputs, on every slot."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {f: torch.randn(getattr(proj, f).shape, generator=gen,
                           device=device) for f in PROJ_FIELDS}


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU the wrappers, forward and backward, run the plain
    versions and never build or launch a kernel."""
    def no_build(*args):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(cuda_build, "build", no_build)
    before = [k.launches for k in KERNELS]
    cfg, ng, bins = _bins("early_exit", "cpu")
    args = (bins.pair_records, bins.tile_starts, bins.tile_counts, ng, cfg)
    records = bins.pair_records.clone().requires_grad_(True)
    tiles = tr.rasterize_pairs(records, *args[1:])
    torch.testing.assert_close(tiles, tr.rasterize_pairs_reference(*args),
                               rtol=0, atol=0)
    g = torch.randn(tiles.shape, generator=torch.Generator().manual_seed(0))
    drec, = torch.autograd.grad(tiles, records, g)
    assert torch.equal(drec, tr.rasterize_pairs_backward_reference(
        *args[:3], tiles.detach(), g, ng, cfg))
    ntx, nty = tile_grid(48, 32, 16)
    tiles = tiles.detach().requires_grad_(True)
    img = tl.untile_chw_fast(tiles, ntx, nty, 16, 32, 48)
    assert torch.equal(img, tl.untile_chw(tiles[:, :3], ntx, nty, 16, 32, 48))
    g3 = torch.randn(img.shape, generator=torch.Generator().manual_seed(1))
    back, = torch.autograd.grad(img, tiles, g3)
    assert torch.equal(back, tl.tile_chw(g3, ng, 5, cfg.group_tiles, ntx,
                                         nty, 16))
    loss, mse = tf.fused_photometric_loss(tiles, g3.abs(), ntx, nty, 16, 32,
                                          48, 0.2)
    want = tf.fused_photometric_loss_reference(tiles, g3.abs(), ntx, nty, 16,
                                               32, 48, 0.2)
    assert torch.equal(loss, want[0]) and torch.equal(mse, want[1])
    pred = img.detach().requires_grad_(True)
    want = ts.ssim_grad_reference(pred, g3.abs(), 1.0,
                                  grad_target=False)[0] / (3 * 22 * 38)
    for precompute in (False, True):
        dx, = torch.autograd.grad(ts.fused_ssim(
            pred, g3.abs(), grad_target=False, precompute_grad=precompute),
            pred)
        torch.testing.assert_close(dx, want, rtol=1e-6, atol=0.0)
    assert torch.equal(tp.probe_zero(5, "cpu"), torch.zeros((5, 8, 256)))
    args = tp.probe_random_inputs(64, 512, device="cpu")
    assert torch.equal(tp.probe_window(*args),
                       tp.probe_window_reference(*args))
    model, cam = _projection_scene("cpu", 60, seed=4)
    probe = torch.zeros((60, 2), requires_grad=True)
    leaves = [getattr(model, n) for n in PARAM_NAMES] + [probe]
    got, want = (fn(model, cam, CFG, 2, probe) for fn in (
        tj.project_gaussians, tj.project_gaussians_reference))
    for field in PROJ_FIELDS + ("radius", "valid"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    cot = _cotangents(want, 5, "cpu")
    grads = [torch.autograd.grad([getattr(proj, f) for f in PROJ_FIELDS],
                                 leaves, [cot[f] for f in PROJ_FIELDS])
             for proj in (got, want)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert [k.launches for k in KERNELS] == before


def test_kernel_build_flags():
    sources = (tr.RASTERIZE_SOURCE, tr.RASTERIZE_BWD_SOURCE,
               tf.FUSED_LOSS_SOURCE, tl.UNTILE_SOURCE, tl.TILE_SOURCE,
               ts.SSIM_SOURCE, tp.SOURCE, tb.SEGMENT_SUMS_SOURCE,
               tj.PROJECTION_SOURCE)
    assert [k.source for k in KERNELS] == (
        list(sources[:-3]) + [ts.SSIM_SOURCE] * 2 + [tp.SOURCE] * 2
        + [tb.SEGMENT_SUMS_SOURCE] + [tj.PROJECTION_SOURCE] * 2)
    for src in sources:
        assert src.path.is_file()
        flags = cuda_build.NVCC_FLAGS + src.extra_flags
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "--use_fast_math" not in flags
        assert "__expf(" not in src.path.read_text()
        assert src.library().name.startswith(f"lib{src.name}-")
    for src in sources:
        assert "-fmad=false" in src.extra_flags
        assert "atomicAdd" not in src.path.read_text()


def test_tile_chw_fast_takes_three_channels():
    """``tile_chw_fast`` takes a 3-channel image on every device, as kernel
    B5-tile does, and refuses any other count before it dispatches."""
    ntx, nty = tile_grid(37, 21, 16)
    img = torch.randn((5, 21, 37), generator=torch.Generator().manual_seed(0))
    assert torch.equal(tl.tile_chw_fast(img[:3], 4, 5, 2, ntx, nty, 16),
                       tl.tile_chw(img[:3], 4, 5, 2, ntx, nty, 16))
    for c in (1, 5):
        with pytest.raises(ValueError, match="3-channel"):
            tl.tile_chw_fast(img[:c], 4, 5, 2, ntx, nty, 16)


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


# (width, height, tile size, group tiles, offset in floats of the inputs'
# views): every width % 4, ts = 32 with phantom tiles, views that are not
# 16-byte aligned, and more than 65,535 groups (257 x 257 tiles, one per
# group: about 340 MB of tiles)
B5_CASES = {
    "w84": (84, 52, 16, 4, 0),
    "w85": (85, 52, 16, 4, 0),
    "w86": (86, 52, 16, 4, 0),
    "w87": (87, 52, 16, 4, 0),
    "ts32_phantom": (85, 52, 32, 4, 0),
    "unaligned": (84, 52, 16, 4, 1),
    "unaligned_ts32_w87": (87, 53, 32, 3, 2),
    "groups_66049": (4112, 4112, 16, 1, 0),
}


def _b5_inputs(case, device):
    """Tiles and a (3, H, W) image from a seed, as views ``offset`` floats
    into their storage."""
    w, h, ts, gt, offset = B5_CASES[case]
    ntx, nty = tile_grid(w, h, ts)
    ng = num_groups_for(ntx * nty, RasterizerConfig(tile_size=ts,
                                                    group_tiles=gt))
    gen = torch.Generator(device=device).manual_seed(0)

    def at_offset(shape):
        x = torch.randn(shape, generator=gen, device=device)
        view = torch.empty(x.numel() + offset, device=device)[offset:]
        return view.copy_(x.reshape(-1)).view(shape)

    layout = (ntx, nty, ts, h, w)
    return (at_offset((ng, 5, gt, ts * ts)), at_offset((3, h, w)), ng, gt,
            layout)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(B5_CASES))
def test_b5_kernel_matches_plain_on_card(case, cuda_device):
    tiles, _, ng, gt, (ntx, nty, ts, h, w) = _b5_inputs(case, cuda_device)
    assert (ng > 65535) == (case == "groups_66049")
    before = tl.UNTILE_CHW.launches
    got = tl.untile_chw_fast(tiles, ntx, nty, ts, h, w)
    again = tl.untile_chw_fast(tiles, ntx, nty, ts, h, w)
    torch.cuda.synchronize()
    assert tl.UNTILE_CHW.launches == before + 2
    assert torch.equal(got, tl.untile_chw(tiles[:, :3], ntx, nty, ts, h, w))
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="contiguous"):
        tl.untile_chw_fast(tiles.transpose(0, 1), ntx, nty, ts, h, w)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda_device):
    """The card's render against the CPU path and against the dense oracle
    on the card."""
    kw, cfg = CASES["early_exit"]
    renders = {}
    for device in ("cpu", cuda_device):
        model, cam = _scene(device, **kw)
        with torch.no_grad():
            renders[str(device)] = render(model, cam, cfg).cpu()
    with torch.no_grad():
        dense = render_dense(model, cam, cfg).cpu()
    torch.testing.assert_close(renders["cuda"], renders["cpu"], **TOL)
    torch.testing.assert_close(renders["cuda"], dense, **TOL)


def _pair_stream(counts, opacity, scale, seed, device, ts=16, gt=4):
    """A hand-made (tile, depth)-sorted pair stream: ``counts[t]`` pairs in
    tile t, means inside the tile, opacities uniform in ``opacity``, axis
    scales (pixels) uniform in ``scale``, 37 junk sentinel columns after the
    last pair. Returns (config, num_groups, (records, tile_starts,
    tile_counts))."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    n = int(counts.sum())
    rec = rng.uniform(-5.0, 5.0, size=(16, n + 37)).astype(np.float32)
    rec[0:2, :n] = rng.uniform(-2.0, ts + 1.0, size=(2, n))
    sx, sy = rng.uniform(*scale, size=(2, n))
    rho = rng.uniform(-0.6, 0.6, size=n)
    det = (sx * sy) ** 2 * (1.0 - rho ** 2)
    rec[2, :n] = sy ** 2 / det                 # the inverse covariance
    rec[3, :n] = -rho * sx * sy / det
    rec[4, :n] = sx ** 2 / det
    rec[5, :n] = rng.uniform(*opacity, size=n)
    rec[6:10, :n] = np.array([[0.0], [ts - 1.0], [0.0], [ts - 1.0]])
    rec[10, :n] = np.repeat(np.arange(len(counts)), counts)
    rec[11:15, :n] = rng.uniform(0.0, 1.0, size=(4, n))
    rec[15, :n] = 1.0
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    cfg = RasterizerConfig(tile_size=ts, group_tiles=gt, groups_per_step=1)
    return cfg, num_groups_for(len(counts), cfg), tuple(
        torch.as_tensor(a, device=device) for a in (rec, starts, counts))


def _scene_stream(case, device, cfg=None):
    cfg, ng, bins = _bins(case, device, cfg)
    return cfg, ng, (bins.pair_records, bins.tile_starts, bins.tile_counts)


# B2's inputs: the scenes of CASES; one tile of 2,100 faint pairs among
# empty and one-pair tiles (a skewed load); dense opaque tiles where every
# pixel exits within a few pairs and the block stops (zeros for the rest);
# the early-exit scene at tile size 32
B2_CASES = {
    **{case: (lambda dev, case=case: _scene_stream(case, dev))
       for case in CASES},
    "skewed_2100": lambda dev: _pair_stream(
        [0, 1, 0, 2100, 1, 0, 0, 1, 0, 0, 1, 0, 3, 0, 1, 0, 0, 1],
        (0.001, 0.008), (1.5, 16.0), 21, dev),
    "dense_all_exit": lambda dev: _pair_stream(
        [90, 70, 200, 33, 64, 65, 1, 128], (0.97, 0.999), (48.0, 96.0), 22,
        dev),
    "ts32_early_exit": lambda dev: _scene_stream(
        "early_exit", dev,
        RasterizerConfig(tile_size=32, chunk_size=128, pairs_per_gaussian=32,
                         group_tiles=2)),
}


# B1 takes the same inputs as B2: several batches, tiles that never exit,
# tiles with thousands of pairs, tile size 32
@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(B2_CASES))
def test_b1_kernel_matches_plain_on_card(case, cuda_device):
    cfg, ng, args = B2_CASES[case](cuda_device)
    before = tr.RASTERIZE_FWD.launches
    got = tr.rasterize_pairs(*args, ng, cfg)
    torch.cuda.synchronize()
    assert tr.RASTERIZE_FWD.launches == before + 1
    want = tr.rasterize_pairs_reference(*args, ng, cfg)
    torch.testing.assert_close(got, want, **TOL)
    # kernel and plain version round alike step by step: bit for bit equal
    assert torch.equal(got, want)
    assert got.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(B2_CASES))
def test_b2_kernel_matches_plain_on_card(case, cuda_device):
    cfg, ng, args = B2_CASES[case](cuda_device)
    out = tr.rasterize_pairs(*args, ng, cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    g = torch.randn(out.shape, generator=gen, device=cuda_device)
    before = tr.RASTERIZE_BWD.launches
    got = tr._rasterize_bwd_cuda(*args, out, g, ng, cfg)
    again = tr._rasterize_bwd_cuda(*args, out, g, ng, cfg)
    torch.cuda.synchronize()
    assert tr.RASTERIZE_BWD.launches == before + 2
    assert torch.equal(got, again)
    want = tr.rasterize_pairs_backward_reference(*args, out, g, ng, cfg)
    for row in GRAD_ROWS:
        assert rel_l2(got[row], want[row]) <= 1e-4, row
    assert not got[[6, 7, 8, 9, 10, 15]].any()
    total = int(args[2].sum())
    assert not got[:, total:].any()
    # exact zeros wherever the plain version has them (pairs past every
    # pixel's exit among them); the dense case must have such pairs
    exited = ~want.any(dim=0)
    assert not got[:, exited].any()
    if case == "dense_all_exit":
        assert int(exited[:total].sum()) > 300


def _loss_inputs(device, h, w, seed):
    """Five-channel tiles with junk outside the image, and a target."""
    cfg = RasterizerConfig(group_tiles=4, groups_per_step=2)
    ntx, nty = tile_grid(w, h, 16)
    ng = num_groups_for(ntx * nty, cfg)
    gen = torch.Generator().manual_seed(seed)
    target = torch.rand((3, h, w), generator=gen)
    pred = (target + 0.15 * torch.randn((3, h, w), generator=gen)).clamp(
        0.0, 1.2)
    tiles = tl.tile_chw(pred, ng, 5, cfg.group_tiles, ntx, nty, 16)
    inside = tl.tile_chw(torch.ones((5, h, w)), ng, 5, cfg.group_tiles,
                         ntx, nty, 16) > 0
    junk = torch.empty(tiles.shape).uniform_(-3.0, 3.0, generator=gen)
    tiles = torch.where(inside, tiles, junk)
    return (tiles.to(device), target.to(device), ntx, nty, inside[:, :3])


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(75, 90), (64, 128), (11, 40), (40, 11),
                                 (33, 200), (130, 70), (3324, 5068)])
def test_b3_kernel_matches_plain_on_card(h, w, cuda_device):
    tiles, target, ntx, nty, inside = _loss_inputs(cuda_device, h, w, 0)
    args = (tiles, target, ntx, nty, 16, h, w, 0.2)
    before = tf.FUSED_LOSS.launches
    loss, mse, grad = tf._fused_loss_cuda(*args)
    again = tf._fused_loss_cuda(*args)
    torch.cuda.synchronize()
    assert tf.FUSED_LOSS.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip((loss, mse, grad), again))
    want = tf.fused_photometric_loss_reference(*args)
    assert float(loss) == pytest.approx(float(want[0]), rel=1e-5)
    assert float(mse) == pytest.approx(float(want[1]), rel=1e-5)
    assert rel_l2(grad, want[2]) <= 1e-4
    assert not grad[:, 3:].any()
    assert not grad[:, :3][~inside.to(cuda_device)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(B5_CASES))
def test_b5_tile_kernel_matches_plain_on_card(case, cuda_device):
    tiles, g3, ng, gt, (ntx, nty, ts, h, w) = _b5_inputs(case, cuda_device)
    want = tl.tile_chw(g3, ng, 5, gt, ntx, nty, ts)
    before = tl.TILE_CHW.launches
    got = tl.tile_chw_fast(g3, ng, 5, gt, ntx, nty, ts)
    again = tl.tile_chw_fast(g3, ng, 5, gt, ntx, nty, ts)
    back, = torch.autograd.grad(
        tl.untile_chw_fast(tiles.requires_grad_(True), ntx, nty, ts, h, w),
        tiles, g3)
    torch.cuda.synchronize()
    assert tl.TILE_CHW.launches == before + 3
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert torch.equal(back, want)


@pytest.mark.cuda
def test_render_tiled_one_tile_per_group_on_card(cuda_device):
    """``render_tiled`` at ``group_tiles=1`` on a 5068x3324 camera (65,936
    groups, past the grid's 65,535 in y and z) equals the same call at the
    default 64 tiles per group exactly: binning gives each tile the same
    pairs, in the same order, in both layouts."""
    model, cam = _scene(cuda_device, n=2000, width=5068, height=3324,
                        seed=3)
    images = {}
    for gt in (1, 64):
        cfg = RasterizerConfig(group_tiles=gt)
        before = tl.UNTILE_CHW.launches
        with torch.no_grad():
            images[gt] = tr.render_tiled(model, cam, cfg)
        torch.cuda.synchronize()
        assert tl.UNTILE_CHW.launches == before + 1
    ntx, nty = tile_grid(cam.width, cam.height, 16)
    assert num_groups_for(ntx * nty, RasterizerConfig(group_tiles=1)) > 65535
    assert images[1].abs().sum() > 0
    assert torch.equal(images[1], images[64])


@pytest.mark.cuda
def test_render_tiled_gradient_on_card_matches_cpu(cuda_device):
    """``render_tiled`` on the card carries a gradient (B1, B5-untile, then
    B5-tile, B2), equal to the CPU path's."""
    kw, cfg = CASES["early_exit"]
    grads = {}
    for device in ("cpu", cuda_device):
        model, cam = _scene(device, **kw)
        gen = torch.Generator().manual_seed(2)
        w = torch.randn((cam.height, cam.width, 3), generator=gen).to(device)
        before = tl.TILE_CHW.launches
        img = tr.render_tiled(model, cam, cfg)
        params = [getattr(model, n) for n in PARAM_NAMES]
        grads[str(device)] = [
            x.cpu() for x in torch.autograd.grad((img * w).sum(), params)]
        if device != "cpu":
            assert tl.TILE_CHW.launches == before + 1
    for name, got, want in zip(PARAM_NAMES, grads["cuda"], grads["cpu"]):
        assert rel_l2(got, want) <= 1e-4, name


@pytest.mark.cuda
def test_train_step_gradients_on_card(cuda_device):
    """One default step's loss and gradients on the card against the CPU
    path, and bit for bit the same from one backward pass to the next.
    (Splats of 0.08-0.3: with thinner ones the quaternion and scale
    gradients of the two paths part by more than the tolerance although
    B2 matches its plain version closely, f32 rounding of the two
    projections amplified by cancellation in the covariance's backward.)"""
    kw = dict(n=200, width=48, height=32, seed=11, scales=(0.08, 0.3))
    cfg = CFG
    tcfg = TrainConfig()
    runs = {}
    for device in ("cpu", cuda_device, cuda_device):
        model, cam = _scene(device, **kw)
        gen = torch.Generator().manual_seed(3)
        target = torch.rand((3, cam.height, cam.width), generator=gen)
        loss, mse, _, _, grads = T.camera_loss_and_grads(
            model, cam, None, None, target.to(device), cfg, tcfg)
        runs.setdefault(str(device), []).append(
            (loss.cpu(), mse.cpu(), {k: v.cpu() for k, v in grads.items()}))
    (cpu_loss, cpu_mse, cpu_grads), = runs["cpu"]
    (loss, mse, grads), (loss2, _, grads2) = runs["cuda"]
    assert float(loss) == pytest.approx(float(cpu_loss), rel=1e-5)
    assert float(mse) == pytest.approx(float(cpu_mse), rel=1e-5)
    assert torch.equal(loss, loss2)
    for name in grads:
        assert rel_l2(grads[name], cpu_grads[name]) <= 1e-4, name
        assert torch.equal(grads[name], grads2[name]), name


def _g1_bins(case, device, pairs_per_gaussian=None):
    """The scene of ``binning_cases.CASES[case]`` made and binned on
    ``device`` (at ``pairs_per_gaussian`` if given), the projection's
    gradient fields as leaves: (leaves, bins, the gather's autograd node,
    which holds perm, lo, hi and total_emit)."""
    kw, _ = binning_cases.CASES[case]
    kw = dict(kw)
    scales = (kw.pop("scale_lo", 0.02), kw.pop("scale_hi", 0.25))
    cfg = binning_cases.config(case, RasterizerConfig, CompatConfig)
    if pairs_per_gaussian:
        cfg = dataclasses.replace(cfg, pairs_per_gaussian=pairs_per_gaussian)
    model, cam = _scene(device, scales=scales, **kw)
    with torch.no_grad():
        proj = project_gaussians(model, cam, cfg)
    leaves = {f: getattr(proj, f).requires_grad_(True)
              for f in ("mean2d", "conic", "opacity", "color", "depth")}
    bins = bin_gaussians(dataclasses.replace(proj, **leaves), cam.width,
                         cam.height, cfg)
    return leaves, bins, bins.pair_records.grad_fn


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(binning_cases.CASES))
def test_g1_kernel_matches_plain_on_card(case, cuda_device):
    """G1, the gather's backward, against the float64 block sums and its
    plain version (the library chain) on the card: no further from the
    exact sums than the plain version (or within 1e-6), within relative L2
    1e-5 of it, exact zeros outside the gradient rows and for gaussians
    with no pairs (``overflow`` drops whole ones), bit for bit the same on
    repeat and for the same pairs in a pool twice the size, one launch per
    backward pass. The cotangent holds values in every row and in the
    sentinel slots, which G1 never reads."""
    leaves, bins, node = _g1_bins(case, cuda_device)
    perm, lo, hi = node.saved_tensors
    total, n, mp = node.total_emit, lo.shape[0], perm.shape[0]
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    g = torch.randn((16, mp), generator=gen, device=cuda_device)
    d = tb.gather_pairs_backward(g, perm, lo, hi, n, total)
    plain = tb.gather_pairs_backward_reference(g, perm, lo, hi, n)
    exact = binning_cases.emission_sums(g, perm, lo, hi, total)
    rows = list(GRAD_ROWS)
    err = rel_l2(d[rows], exact[rows])
    assert err <= max(rel_l2(plain[rows], exact[rows]), 1e-6), err
    assert rel_l2(d, plain) <= 1e-5
    others = [r for r in range(16) if r not in GRAD_ROWS]
    assert not d[others].any() and not d[:, lo == hi].any()
    if case == "overflow":
        assert bool((lo == hi).any())
    if case == "wide":      # lanes walk more than one pair each
        assert int((hi - lo).max()) > 64
    assert torch.equal(d, tb.gather_pairs_backward(g, perm, lo, hi, n,
                                                   total))

    # the same pairs in a larger pool: each emission slot's gradient the
    # same values, wherever the sort puts it
    g_em = torch.randn((16, 2 * mp), generator=gen, device=cuda_device)
    sums = []
    ppg = binning_cases.CASES[case][1]["pairs_per_gaussian"]
    for pool_ppg in (ppg, 2 * ppg):
        _, b, nd = _g1_bins(case, cuda_device, pool_ppg)
        p, l, h = nd.saved_tensors
        gp = torch.randn((16, p.shape[0]), generator=gen, device=cuda_device)
        gp[:, :nd.total_emit] = g_em[:, p[:nd.total_emit]]
        sums.append((tb.gather_pairs_backward(gp, p, l, h, n, nd.total_emit),
                     l, h, b.pair_records.shape[1]))
    (d1, l1, h1, mp1), (d2, l2, h2, mp2) = sums
    same = (l1 == l2) & (h1 == h2)
    assert mp2 > mp1 and bool(same.any())
    assert bool(same.all()) or case == "overflow"
    assert torch.equal(d1[:, same], d2[:, same])

    # through autograd: one launch per backward pass, bit for bit equal
    before = tb.SEGMENT_SUMS.launches
    grads = [torch.autograd.grad(bins.pair_records, list(leaves.values()),
                                 g, retain_graph=True) for _ in range(2)]
    assert tb.SEGMENT_SUMS.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _ssim_images(device, h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand((3, h, w), generator=gen)
    b = (a + 0.2 * torch.randn((3, h, w), generator=gen)).clamp(0.0, 1.0)
    return a.to(device), b.to(device)


@pytest.mark.cuda
# (11, 11) and (45, 75) cut the kernels' regions of pixels on every side;
# the last two cut B4a's 32 x 64 region of window tops on both axes and
# span several of them
@pytest.mark.parametrize("h,w", [(32, 48), (77, 131), (11, 11), (45, 75),
                                 (75, 203), (140, 267)])
def test_b4_kernels_match_plain_on_card(h, w, cuda_device):
    """B4a, B4b (both grad_target settings) and B4c against their plain
    versions; B4c against B4a and B4b (its value B4a's bit for bit); each
    the same on repeat."""
    a, b = _ssim_images(cuda_device, h, w, 0)
    c1, c2 = ts.L.C1, ts.L.C2
    g = torch.tensor(0.7, device=cuda_device)
    before = [k.launches for k in (ts.SSIM_SUM, ts.SSIM_GRAD,
                                   ts.SSIM_VALUE_GRAD)]
    value = ts._ssim_sum_cuda(a, b, c1, c2)
    assert torch.equal(value, ts._ssim_sum_cuda(a, b, c1, c2))
    assert float(value) == pytest.approx(
        float(ts.ssim_sum_reference(a, b)), rel=1e-5)
    for gt in (False, True):
        dx, dy = ts._ssim_grad_cuda(a, b, g, c1, c2, gt)
        again = ts._ssim_grad_cuda(a, b, g, c1, c2, gt)
        want = ts.ssim_grad_reference(a, b, g, c1, c2, gt)
        assert torch.equal(dx, again[0])
        assert rel_l2(dx, want[0]) <= 1e-4
        if gt:
            assert torch.equal(dy, again[1])
            assert rel_l2(dy, want[1]) <= 1e-4
        else:
            assert dy is None and again[1] is None
        v, ux, uy = ts._ssim_value_grad_cuda(a, b, c1, c2, gt)
        one = ts._ssim_grad_cuda(a, b, torch.ones((), device=cuda_device),
                                 c1, c2, gt)
        v2, ux2, uy2 = ts._ssim_value_grad_cuda(a, b, c1, c2, gt)
        assert torch.equal(v, v2) and torch.equal(ux, ux2)
        assert (uy is None) if not gt else torch.equal(uy, uy2)
        assert float(v) == pytest.approx(float(value), rel=1e-6)
        # B4c adds its windows as B4a does: the same value bit for bit
        assert torch.equal(v, value)
        assert rel_l2(ux, one[0]) <= 1e-5
        assert (uy is None) if not gt else rel_l2(uy, one[1]) <= 1e-5
    torch.cuda.synchronize()
    assert [k.launches for k in (ts.SSIM_SUM, ts.SSIM_GRAD,
                                 ts.SSIM_VALUE_GRAD)] == [
        before[0] + 2, before[1] + 6, before[2] + 4]


@pytest.mark.cuda
@pytest.mark.parametrize("precompute", [False, True])
def test_fused_ssim_on_card_matches_cpu(precompute, cuda_device):
    """``fused_ssim`` under autograd on the card (B4a then B4b, or B4c)
    against the CPU path."""
    runs = {}
    for device in ("cpu", cuda_device):
        a, b = _ssim_images(device, 45, 70, 1)
        x = a.requires_grad_(True)
        value = ts.fused_ssim(x, b, grad_target=False,
                              precompute_grad=precompute)
        dx, = torch.autograd.grad(1.0 - value, x)
        runs[str(device)] = (value.detach().cpu(), dx.cpu())
    assert float(runs["cuda"][0]) == pytest.approx(float(runs["cpu"][0]),
                                                   rel=1e-5)
    assert rel_l2(runs["cuda"][1], runs["cpu"][1]) <= 1e-4


@pytest.mark.cuda
def test_split_train_step_gradients_on_card(cuda_device):
    """One split-loss step (B1, B5-untile, B4a; B4b, B5-tile, B2) on the
    card against the CPU path, and bit for bit the same on repeat."""
    kw = dict(n=200, width=48, height=32, seed=11, scales=(0.08, 0.3))
    tcfg = TrainConfig(fused_loss=False)
    runs = {}
    for device in ("cpu", cuda_device, cuda_device):
        model, cam = _scene(device, **kw)
        gen = torch.Generator().manual_seed(3)
        target = torch.rand((cam.height, cam.width, 3), generator=gen)
        target = target.to(device)
        tiles = tr.image_to_tiles(target, CFG)
        mask = tr.tile_pixel_mask(cam.height, cam.width, CFG, device)
        before = ts.SSIM_GRAD.launches
        loss, mse, _, _, grads = T.camera_loss_and_grads(
            model, cam, tiles, mask, target.permute(2, 0, 1).contiguous(),
            CFG, tcfg)
        assert mse is None
        if device != "cpu":
            assert ts.SSIM_GRAD.launches == before + 1
        runs.setdefault(str(device), []).append(
            (loss.cpu(), {k: v.cpu() for k, v in grads.items()}))
    (cpu_loss, cpu_grads), = runs["cpu"]
    (loss, grads), (loss2, grads2) = runs["cuda"]
    assert float(loss) == pytest.approx(float(cpu_loss), rel=1e-5)
    assert torch.equal(loss, loss2)
    for name in grads:
        assert rel_l2(grads[name], cpu_grads[name]) <= 1e-4, name
        assert torch.equal(grads[name], grads2[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["script", "seeded_random",
                                    "multi_chunk"])
def test_probe_kernels_match_plain_on_card(inputs, cuda_device):
    """P1 overwrites every element of its output with 0 (exact); P2 within
    relative L2 1e-6 of its plain version (float32 sums in another order),
    bit-equal on repeat, rows past the table read as 0; "multi_chunk" has
    programs of no chunk (counts 0) and of three to five."""
    nt, mp = 3000, 1 << 14
    buf = torch.full((nt, 8, 256), float("nan"), device=cuda_device)
    tp._probe_zero_cuda(buf)
    assert torch.equal(buf, torch.zeros_like(buf))
    assert torch.equal(tp.probe_zero(nt, cuda_device), buf)
    if inputs == "script":
        args = tp.probe_inputs(nt, mp, device=cuda_device)
    else:
        args = tp.probe_random_inputs(nt, mp, seed=1, device=cuda_device)
    if inputs == "multi_chunk":
        counts = np.random.default_rng(2).integers(0, 130, size=nt)
        counts[::5] = 0
        args = (args[0], torch.from_numpy(counts.astype(np.int32)).to(
            cuda_device), args[2])
        chunks = tp.window_chunks(*args[:2])[1]
        assert int((chunks == 0).sum()) > 0 and int(chunks.max()) >= 3
    got = tp.probe_window(*args)
    want = tp.probe_window_reference(*args)
    assert rel_l2(got, want) <= 1e-6
    assert torch.equal(got, tp.probe_window(*args))
    starts = torch.tensor([mp - 8], dtype=torch.int32, device=cuda_device)
    counts = torch.tensor([40], dtype=torch.int32, device=cuda_device)
    rec = args[2]
    padded = torch.cat([rec, torch.zeros((64, 128), device=cuda_device)])
    assert torch.equal(tp.probe_window(starts, counts, rec),
                       tp.probe_window(starts, counts, padded))
    with pytest.raises(ValueError):
        tp.probe_window(args[0].long(), args[1], rec)


@pytest.mark.parametrize("fault", ["float64", "camera_requires_grad",
                                   "mixed_devices", "not_on_a_card"])
def test_projection_card_path_refuses(fault, monkeypatch):
    """The card path of ``project_gaussians`` checks its inputs before it
    builds or launches anything, and raises on each that J1 and J2 do not
    take (tensors on the CPU here, so the last check, that they lie on a
    card, refuses the inputs that pass the others). Inputs on two devices
    are refused on the CPU path too (a ``meta`` camera stands in for one on
    the card)."""
    def no_build(*args):
        raise AssertionError("the input check let a fault through")

    monkeypatch.setattr(cuda_build, "build", no_build)
    model, cam = _projection_scene("cpu", 12, seed=2)
    match = {"float64": "float32", "camera_requires_grad": "requires one",
             "mixed_devices": "device", "not_on_a_card": "on a card"}[fault]
    if fault == "float64":
        model = GaussianModel(**{n: getattr(model, n).detach().double()
                                 for n in PARAM_NAMES},
                              active=model.active, color_space="sh")
    elif fault == "camera_requires_grad":
        cam = dataclasses.replace(
            cam, fx=cam.fx.clone().requires_grad_(True))
    elif fault == "mixed_devices":
        cam = dataclasses.replace(cam,
                                  world2view=cam.world2view.to("meta"))
        with pytest.raises(ValueError, match=match):
            tj.project_gaussians(model, cam)
    with pytest.raises(ValueError, match=match):
        tj.check_card_inputs(model, cam)


# name: (gaussians, seed, SH coefficients (0: raw RGB), SH degree of the
# call (None: the model's), double sigmoid, edges); "cell_*" are the
# benchmark's cells
PROJ_CASES = {
    "rgb": (300, 1, 0, None, False, False),
    "sh0": (300, 2, 16, 0, False, False),
    "sh1": (300, 3, 16, 1, False, False),
    "sh2": (300, 4, 9, None, False, False),   # rows of 27 floats
    "sh3": (300, 5, 16, None, False, False),
    "double_sigmoid": (300, 6, 16, None, True, False),
    "edges": (400, 7, 16, None, False, True),
    "cell_render": None,
    "cell_train": None,
    "cell_30k": None,
}
# a large seed, past 32 signed bits, as the benchmark takes them
CELL_SEED = 3_000_000_019
# J1's fields that may differ from the plain version's, by at most this
# many ulps (the rest are bit-equal)
J1_ULPS = {}


def _cell_scene(case, device):
    """A cell's scene from gsbench/scene.py at ``CELL_SEED``: the 52,363
    points with SH 3 (higher coefficients normal(0, 0.1), as the render
    traffic makes them) and, for the train cell, in a pool of 4x the
    points whose free slots are the benchmark's; four ring cameras at
    5068x3324. The cells' own init has identity rotations and round 3-NN
    scales, at which the rotation's gradient is exactly zero: the points
    here take seeded random rotations and scales of 0.01-0.3 per axis,
    which exercise it. ``cell_30k`` is the treehill_3dgs_30k
    configuration's own scene, whole: 3.1M anisotropic, rotated gaussians
    of its recipe at 1267x831."""
    from gsbench import scene as gs
    name = "treehill_3dgs_30k" if case == "cell_30k" else "treehill_3dgs"
    cfg = json.loads((REPO / f"gsbench/configs/{name}.json").read_text())
    if case == "cell_30k":
        gen = gs.generator(CELL_SEED, device)
        xyz, rgb = gs.point_cloud(cfg, gen, device)
        params, active = gs.initial_params(cfg, xyz, rgb, xyz.shape[0], gen,
                                           sh_rest_std=0.1)
        return _cell_model_and_cameras(cfg, params, active, device)
    cfg = dict(cfg, init="constant", scale=0.05)
    gen = gs.generator(CELL_SEED, device)
    xyz, rgb = gs.point_cloud(cfg, gen, device)
    n = xyz.shape[0]
    capacity = 4 * n if case == "cell_train" else n
    params, active = gs.initial_params(cfg, xyz, rgb, capacity, gen,
                                       sh_rest_std=0.1)
    rng = np.random.default_rng(CELL_SEED)
    params["log_scales"][:n] = torch.as_tensor(
        np.log(rng.uniform(0.01, 0.3, size=(n, 3))), dtype=torch.float32)
    params["quats"][:n] = torch.as_tensor(rng.normal(size=(n, 4)),
                                          dtype=torch.float32)
    return _cell_model_and_cameras(cfg, params, active, device)


def _cell_model_and_cameras(cfg, params, active, device):
    from gsbench import scene as gs
    model = GaussianModel(**params, active=active, color_space="sh")
    w, h = cfg["width"], cfg["height"]
    focal = cfg["focal_per_width"] * w
    cams = [make_camera(focal, focal, w, h, gs.quaternion(r), t,
                        device=device)
            for r, t in gs.ring_poses(cfg, 4, CELL_SEED)]
    return model, cams


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PROJ_CASES))
def test_projection_kernels_match_plain_on_card(case, cuda_device):
    """J1 against ``project_gaussians_reference`` on the card: radius and
    valid equal on every gaussian, every float field bit-equal (J1_ULPS
    names the fields that are not, and by how many ulps). J2 against
    ``torch.autograd.grad`` of the plain forward on the card, seeded
    random cotangents on every slot: relative L2 <= 1e-5 per leaf (the
    same chain rule with its terms added in another order), exact zeros
    wherever autograd has them (SH coefficients above the degree, colour
    channels under the clamp; at the 30k configuration's 3.1M gaussians
    all but a few accidental ones), bit for bit on repeat. One launch of J1 per
    projection and of J2 per backward pass. The cell cases run four
    cameras each."""
    if PROJ_CASES[case] is None:
        model, cams = _cell_scene(case, cuda_device)
        # the 30k configuration's 2D dilation, 3DGS's low-pass
        dilation = 0.3 if case == "cell_30k" else 0.0
        degree, cfg = None, RasterizerConfig(cov2d_dilation=dilation)
    else:
        n, seed, coeffs, degree, double, edges = PROJ_CASES[case]
        model, cam = _projection_scene(cuda_device, n, seed, coeffs, edges)
        cams = [cam]
        cfg = RasterizerConfig(compat=CompatConfig(double_sigmoid=double))
    leaves = [getattr(model, n) for n in PARAM_NAMES]
    for i, cam in enumerate(cams):
        before = (tj.PROJECT_FWD.launches, tj.PROJECT_BWD.launches)
        with torch.no_grad():
            got = tj.project_gaussians(model, cam, cfg, degree)
            want = tj.project_gaussians_reference(model, cam, cfg, degree)
        assert tj.PROJECT_FWD.launches == before[0] + 1
        assert torch.equal(got.valid, want.valid)
        assert torch.equal(got.radius, want.radius)
        assert bool(want.valid.any())
        if case == "edges":
            assert not bool(want.valid[:12].any())
            near = want.depth[12:20]
            assert bool((near < cfg.frustum_min_z).any())
            assert bool((near >= cfg.frustum_min_z).any())
        for field in PROJ_FIELDS:
            a, b = getattr(got, field), getattr(want, field)
            assert ulps(a, b) <= J1_ULPS.get(field, 0), (field, ulps(a, b))

        cot = _cotangents(want, i, cuda_device)
        plain = tj.project_gaussians_reference(model, cam, cfg, degree)
        want_g = torch.autograd.grad(
            [getattr(plain, f) for f in PROJ_FIELDS], leaves,
            [cot[f] for f in PROJ_FIELDS], allow_unused=True)
        runs = []
        for _ in range(2):
            proj = tj.project_gaussians(model, cam, cfg, degree)
            runs.append(torch.autograd.grad(
                [getattr(proj, f) for f in PROJ_FIELDS], leaves,
                [cot[f] for f in PROJ_FIELDS]))
        assert tj.PROJECT_FWD.launches == before[0] + 3
        assert tj.PROJECT_BWD.launches == before[1] + 2
        for name, g, again, w, leaf in zip(PARAM_NAMES, *runs, want_g,
                                           leaves):
            w = torch.zeros_like(leaf) if w is None else w
            assert rel_l2(g, w) <= 1e-5, (name, rel_l2(g, w))
            if case == "cell_30k":
                # over 3.1M gaussians a float32 sum of mixed-sign terms in
                # autograd's chain lands on exactly 0 now and then (about
                # 2**-23 of the sums); J2, adding in another order, leaves
                # an ulp of its terms there (one of 9.3M scale entries,
                # -2.2e-9, on the card). A few such strays pass, each a
                # rounding of the leaf's size; a J2 fault at a structural
                # zero (a culled gaussian, a clamped channel) leaves many
                stray = g[(w == 0) & (g != 0)]
                assert stray.numel() <= 16, (name, stray.numel())
                assert bool((stray.abs() <= 1e-6 * w.abs().max()).all()), (
                    name, stray)
            else:
                assert not bool(g[w == 0].any()), name
            assert torch.equal(g, again), name
        if degree is not None and degree < 3:
            assert not bool(runs[0][4][:, (degree + 1) ** 2:].any())
        if case == "cell_30k":
            # anisotropic, rotated: the rotation carries a gradient
            quats = runs[0][PARAM_NAMES.index("quats")][want.valid]
            assert float((quats != 0).all(dim=1).float().mean()) > 0.99


@pytest.mark.cuda
def test_projection_round_gaussians_rotation_gradient(cuda_device,
                                                      monkeypatch):
    """Where a gaussian is round (three equal scales), Sigma = e I does not
    depend on its rotation: J2 writes exact zeros into the quaternion's
    gradient, where autograd through the plain chain in float32 leaves
    zeros and rounding noise. Every gaussian here is round, with a seeded
    random rotation. The true derivative reads about 0: a float64 autograd
    of the plain version's rotation part (``covariance_3d_channels``, the
    quaternion's only way into the outputs), given the float32 chain's
    cotangent of the six covariance channels, is under 1e-12 of the
    scales' gradient; the chain's own noise is under 1e-5 of it. J2's other
    leaves hold to the chain as in the test above."""
    model, cam = _projection_scene(cuda_device, 400, seed=10)
    params = {n: getattr(model, n).detach() for n in PARAM_NAMES}
    params["log_scales"] = params["log_scales"][:, :1].expand(-1, 3)
    model = GaussianModel(**{n: t.contiguous() for n, t in params.items()},
                          active=model.active, color_space="sh")
    leaves = [getattr(model, n) for n in PARAM_NAMES]
    channels = []

    def capture(log_scales, quats):
        out = covariance_3d_channels(log_scales, quats)
        channels.extend(out)
        return out

    monkeypatch.setattr(tj, "covariance_3d_channels", capture)
    plain = tj.project_gaussians_reference(model, cam)
    monkeypatch.undo()
    assert bool(plain.valid.all())
    cot = _cotangents(plain, 0, cuda_device)
    *want, = torch.autograd.grad(
        [getattr(plain, f) for f in PROJ_FIELDS], leaves + channels,
        [cot[f] for f in PROJ_FIELDS])
    want, g_sigma = want[:5], want[5:]
    ls64 = model.log_scales.detach().double().requires_grad_(True)
    q64 = model.quats.detach().double().requires_grad_(True)
    g_ls64, g_q64 = torch.autograd.grad(
        covariance_3d_channels(ls64, q64), (ls64, q64),
        [g.double() for g in g_sigma])
    scale = float(g_ls64.norm())
    assert float(g_q64.norm()) <= 1e-12 * scale
    assert float(want[2].norm()) <= 1e-5 * scale

    proj = tj.project_gaussians(model, cam)
    got = torch.autograd.grad([getattr(proj, f) for f in PROJ_FIELDS],
                              leaves, [cot[f] for f in PROJ_FIELDS])
    assert not bool(got[2].any())
    for name, g, w in zip(PARAM_NAMES, got, want):
        if name != "quats":
            assert rel_l2(g, w) <= 1e-5, (name, rel_l2(g, w))


@pytest.mark.cuda
def test_projection_saves_nothing_without_grad(cuda_device):
    """Under ``torch.no_grad()`` the card's projection launches J1 and
    saves no tensor for a backward; with grad, its node saves the five
    parameters and nothing else, and the densify probe's gradient is
    the mean2d cotangent."""
    model, cam = _projection_scene(cuda_device, 50, seed=8)
    packed = []

    def pack(t):
        packed.append(t)
        return t

    probe = torch.zeros((50, 2), device=cuda_device, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.no_grad():
            proj = tj.project_gaussians(model, cam)
        assert not packed
        assert all(getattr(proj, f).grad_fn is None for f in PROJ_FIELDS)
        proj = tj.project_gaussians(model, cam, mean2d_offset=probe)
    assert len(packed) == 5
    assert "ProjectGaussians" in type(proj.depth.grad_fn).__name__
    g = torch.randn((50, 2), device=cuda_device)
    d_probe, = torch.autograd.grad(proj.mean2d, probe, g)
    assert torch.equal(d_probe, g)
