"""Port vs JAX package: the rasterizer's plain versions against the Pallas
kernels (interpret mode) on the same bins, and the layout helpers.

rasterize_pairs: rtol 1e-4 / atol 1e-5 (the JAX kernel sums through f32
one-hot matmuls and segmented scans, the port sequentially per pixel). Its
gradient (B2): relative L2 difference <= 1e-4 per record row, the ROADMAP's
gradient gate, and exact zeros where the kernel must write them. Layout
helpers and their adjoints: exactly equal (they are permutations). The
CUDA kernels are held against these plain versions on the card in
test_torch_kernels.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.config import (
    CompatConfig,
    RasterizerConfig,
)
from intro_to_gaussian_splatting_tpu.ops import rasterize_pallas as jr
from intro_to_gaussian_splatting_tpu.ops.binning import (
    bin_gaussians,
    num_groups_for,
    tile_grid,
)
from intro_to_gaussian_splatting_tpu.ops.projection import project_gaussians
from intro_to_gaussian_splatting_tpu.ops.relayout_pallas import (
    untile_chw_fast as jax_untile_chw_fast,
)
from intro_to_gaussian_splatting_tpu_torch.ops import rasterize as tr
from intro_to_gaussian_splatting_tpu_torch.ops import relayout as tl
from intro_to_gaussian_splatting_tpu_torch.ops.projection import GRAD_ROWS
from tests.scenes import small_scene
from tests.test_torch_common import np_, port_config

CFG = RasterizerConfig(chunk_size=128, pairs_per_gaussian=32, group_tiles=2)

CASES = {
    # > 128 pairs in some tiles (several JAX chunks) and early exit
    "multi_chunk_early_exit": (dict(n=400, width=48, height=32, seed=3,
                                    opacity_hi=6.0), CFG),
    "partial_tiles": (dict(n=80, width=40, height=24, seed=5), CFG),
    # pixel bbox test, inclusive overlap, the CUDA threshold and alpha_min
    "reference_cuda_alpha_min": (dict(n=80, width=48, height=32, seed=7),
                                 dataclasses.replace(
                                     CFG, compat=CompatConfig.REFERENCE_CUDA,
                                     t_threshold=1e-3,
                                     alpha_min=1.0 / 255.0)),
}


# jitted: the eager op-by-op run is several times slower on the CPU
jax_bin = jax.jit(bin_gaussians, static_argnums=(1, 2, 3))
jax_rasterize = jax.jit(jr.rasterize_pairs, static_argnums=(2, 3, 4))


def _bins(case):
    scene_kw, cfg = CASES[case]
    raw, cam, model = small_scene(**scene_kw)
    ntx, nty = tile_grid(cam.width, cam.height, cfg.tile_size)
    ng = num_groups_for(ntx * nty, cfg)
    bins = jax_bin(project_gaussians(model, cam, cfg), cam.width,
                   cam.height, cfg)
    return cfg, ng, bins


def _port_args(bins, device="cpu"):
    return tuple(torch.from_numpy(np.array(x)).to(device) for x in (
        bins.pair_records, bins.tile_starts, bins.tile_counts))


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_pairs_matches_pallas(case):
    cfg, ng, bins = _bins(case)
    want = np.asarray(jax_rasterize(bins.pair_records, bins.group_starts,
                                    ng, cfg, True))
    got = tr.rasterize_pairs(*_port_args(bins), ng, port_config(cfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(np_(got), want, rtol=1e-4, atol=1e-5)
    if case == "multi_chunk_early_exit":
        assert np.asarray(bins.tile_counts).max() > cfg.chunk_size


def rel_l2(got, want):
    """||got - want|| / ||want|| (0 when both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.linalg.norm(got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_backward_matches_pallas(case):
    """B2's plain version against jax.vjp of the Pallas kernel, for a
    random cotangent of the (NG, 5, GT, 256) output."""
    cfg, ng, bins = _bins(case)
    out, vjp = jax.vjp(lambda r: jr.rasterize_pairs(
        r, bins.group_starts, ng, cfg, True), bins.pair_records)
    g = np.random.default_rng(0).normal(size=out.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    records, starts, counts = _port_args(bins)
    got = np_(tr.rasterize_pairs_backward_reference(
        records, starts, counts, torch.from_numpy(np.array(out)),
        torch.from_numpy(g), ng, port_config(cfg)))
    assert got.shape == want.shape
    for row in GRAD_ROWS:
        assert np.linalg.norm(want[row]) > 0, row
        assert rel_l2(got[row], want[row]) <= 1e-4, row
    # the bbox, tile-id and one rows, and the slots past the last tile
    assert not got[[6, 7, 8, 9, 10, 15]].any()
    total = int(np.asarray(bins.tile_counts).sum())
    assert total < got.shape[1] and not got[:, total:].any()


def test_evaluation_count_stops_at_each_pixel_exit():
    """The plain version counts the (pair, pixel) evaluations up to each
    pixel's exit: all of them with a threshold nothing reaches, fewer
    with early exit."""
    cfg, ng, bins = _bins("multi_chunk_early_exit")
    args = _port_args(bins)
    pairs = int(np.asarray(bins.tile_counts).sum())
    pix = cfg.tile_size ** 2
    _, ev = tr.rasterize_pairs_reference(*args, ng, port_config(cfg),
                                         count_evaluations=True)
    never = dataclasses.replace(port_config(cfg), t_threshold=0.0)
    _, ev_all = tr.rasterize_pairs_reference(*args, ng, never,
                                             count_evaluations=True)
    assert ev_all == pairs * pix
    assert 0 < ev < ev_all


def test_layout_helpers_match():
    w, h, ts, gt = 84, 52, 16, 4
    cfg = RasterizerConfig(tile_size=ts, group_tiles=gt, groups_per_step=3)
    ntx, nty = tile_grid(w, h, ts)
    ng = num_groups_for(ntx * nty, cfg)
    rng = np.random.default_rng(0)
    tiles = rng.standard_normal((ng, 5, gt, ts * ts)).astype(np.float32)
    tt = torch.from_numpy(tiles)

    want_chw = np.asarray(jax_untile_chw_fast(
        jnp.asarray(tiles[:, :4]), ntx, nty, ts, h, w, True))
    np.testing.assert_array_equal(
        np_(tl.untile_chw_fast(tt, ntx, nty, ts, h, w)), want_chw)
    np.testing.assert_array_equal(
        np_(tr.untile_chw(tt[:, :3], ntx, nty, ts, h, w)),
        np.asarray(jr.untile_chw(jnp.asarray(tiles[:, :3]), ntx, nty, ts, h,
                                 w)))
    np.testing.assert_array_equal(
        np_(tr.untile(tt, ntx, nty, ts, h, w)),
        np.asarray(jr.untile(jnp.asarray(tiles), ntx, nty, ts, h, w)))

    # the adjoint (B5-tile's plain version) against the Pallas VJP
    g = rng.standard_normal((3, h, w)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jax_untile_chw_fast(t, ntx, nty, ts, h, w,
                                                   True),
                     jnp.asarray(tiles[:, :4]))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = np_(tl.tile_chw(torch.from_numpy(g), ng, 5, gt, ntx, nty, ts))
    np.testing.assert_array_equal(got[:, :4], want)
    assert not got[:, 3:].any()
    tt.requires_grad_(True)
    back, = torch.autograd.grad(
        tl.untile_chw_fast(tt, ntx, nty, ts, h, w), tt,
        torch.from_numpy(g))
    np.testing.assert_array_equal(np_(back), got)

    img = rng.standard_normal((h, w, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np_(tr.image_to_tiles(torch.from_numpy(img), port_config(cfg))),
        np.asarray(jr.image_to_tiles(jnp.asarray(img), cfg)))
    np.testing.assert_array_equal(
        np_(tr.tile_pixel_mask(h, w, port_config(cfg))),
        np.asarray(jr.tile_pixel_mask(h, w, cfg)))
