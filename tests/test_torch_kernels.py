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
in another order). Every kernel's output is the same bit for bit from one
launch to the next.
"""

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
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import PARAM_NAMES
from intro_to_gaussian_splatting_tpu_torch.ops import cuda_build
from intro_to_gaussian_splatting_tpu_torch.ops import fused_loss as tf
from intro_to_gaussian_splatting_tpu_torch.ops import probe as tp
from intro_to_gaussian_splatting_tpu_torch.ops import rasterize as tr
from intro_to_gaussian_splatting_tpu_torch.ops import relayout as tl
from intro_to_gaussian_splatting_tpu_torch.ops import ssim as ts
from intro_to_gaussian_splatting_tpu_torch.ops.binning import (
    bin_gaussians,
    num_groups_for,
    tile_grid,
)
from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
    GRAD_ROWS,
    project_gaussians,
)
from intro_to_gaussian_splatting_tpu_torch.ops.render import render
from intro_to_gaussian_splatting_tpu_torch.train import trainer as T

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


def _bins(case, device):
    kw, cfg = CASES[case]
    model, cam = _scene(device, **kw)
    ntx, nty = tile_grid(cam.width, cam.height, cfg.tile_size)
    with torch.no_grad():
        bins = bin_gaussians(project_gaussians(model, cam, cfg), cam.width,
                             cam.height, cfg)
    return cfg, num_groups_for(ntx * nty, cfg), bins


KERNELS = (tr.RASTERIZE_FWD, tr.RASTERIZE_BWD, tf.FUSED_LOSS, tl.UNTILE_CHW,
           tl.TILE_CHW, ts.SSIM_SUM, ts.SSIM_GRAD, ts.SSIM_VALUE_GRAD,
           tp.PROBE_ZERO, tp.PROBE_WINDOW)


def rel_l2(got, want):
    got, want = got.double(), want.double()
    den = torch.linalg.norm(want)
    return float(torch.linalg.norm(got - want) / den) if den else float(
        torch.linalg.norm(got))


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
    assert [k.launches for k in KERNELS] == before


def test_kernel_build_flags():
    sources = (tr.RASTERIZE_SOURCE, tr.RASTERIZE_BWD_SOURCE,
               tf.FUSED_LOSS_SOURCE, tl.UNTILE_SOURCE, tl.TILE_SOURCE,
               ts.SSIM_SOURCE, tp.SOURCE)
    assert [k.source for k in KERNELS] == (
        list(sources[:-1]) + [ts.SSIM_SOURCE] * 2 + [tp.SOURCE] * 2)
    for src in sources:
        assert src.path.is_file()
        flags = cuda_build.NVCC_FLAGS + src.extra_flags
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "--use_fast_math" not in flags
        assert "__expf(" not in src.path.read_text()
        assert src.library().name.startswith(f"lib{src.name}-")
    for src in (tr.RASTERIZE_SOURCE, tr.RASTERIZE_BWD_SOURCE,
                tf.FUSED_LOSS_SOURCE, tl.UNTILE_SOURCE, tl.TILE_SOURCE,
                ts.SSIM_SOURCE, tp.SOURCE):
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
    kw, cfg = CASES["early_exit"]
    renders = {}
    for device in ("cpu", cuda_device):
        model, cam = _scene(device, **kw)
        with torch.no_grad():
            renders[str(device)] = render(model, cam, cfg).cpu()
    torch.testing.assert_close(renders["cuda"], renders["cpu"], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_b2_kernel_matches_plain_on_card(case, cuda_device):
    cfg, ng, bins = _bins(case, cuda_device)
    args = (bins.pair_records, bins.tile_starts, bins.tile_counts)
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
    total = int(bins.tile_counts.sum())
    assert not got[:, total:].any()


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
@pytest.mark.parametrize("h,w", [(75, 90), (64, 128)])
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
    projections amplified by cancellation in the covariance's backward;
    chip_smoke.py reports that case.)"""
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


def _ssim_images(device, h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand((3, h, w), generator=gen)
    b = (a + 0.2 * torch.randn((3, h, w), generator=gen)).clamp(0.0, 1.0)
    return a.to(device), b.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(32, 48), (77, 131)])
def test_b4_kernels_match_plain_on_card(h, w, cuda_device):
    """B4a, B4b (both grad_target settings) and B4c against their plain
    versions; B4c against B4a and B4b; each the same on repeat."""
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
        assert float(v) == pytest.approx(float(value), rel=1e-6)
        assert rel_l2(ux, one[0]) <= 1e-5
        assert (uy is None) if not gt else rel_l2(uy, one[1]) <= 1e-5
    torch.cuda.synchronize()
    assert [k.launches for k in (ts.SSIM_SUM, ts.SSIM_GRAD,
                                 ts.SSIM_VALUE_GRAD)] == [
        before[0] + 2, before[1] + 6, before[2] + 2]


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
@pytest.mark.parametrize("inputs", ["script", "seeded_random"])
def test_probe_kernels_match_plain_on_card(inputs, cuda_device):
    """P1 overwrites every element of its output with 0 (exact); P2 within
    relative L2 1e-6 of its plain version (float32 sums in another order),
    bit-equal on repeat, rows past the table read as 0."""
    nt, mp = 3000, 1 << 14
    buf = torch.full((nt, 8, 256), float("nan"), device=cuda_device)
    tp._probe_zero_cuda(buf)
    assert torch.equal(buf, torch.zeros_like(buf))
    assert torch.equal(tp.probe_zero(nt, cuda_device), buf)
    if inputs == "script":
        args = tp.probe_inputs(nt, mp, device=cuda_device)
    else:
        args = tp.probe_random_inputs(nt, mp, seed=1, device=cuda_device)
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
