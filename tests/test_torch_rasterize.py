"""Port vs JAX package: the rasterizer's plain versions against the Pallas
kernels (interpret mode) on the same bins, and the layout helpers.

rasterize_pairs: rtol 1e-4 / atol 1e-5 (the JAX kernel sums through f32
one-hot matmuls and segmented scans, the port sequentially per pixel). Its
gradient (B2): relative L2 difference <= 1e-4 per record row, the ROADMAP's
gradient gate, and exact zeros where the kernel must write them. Layout
helpers and their adjoints: exactly equal (they are permutations). The
CUDA kernels are held against these plain versions on the card in
test_torch_kernels.py.

Each case's JAX output and VJP come from one compiled program, shared by
the forward and the backward test and by the cases of equal shapes.
"""

import dataclasses
import functools

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
from tests.test_torch_common import FAST_COMPILE, jax_fast, np_, port_config

# one tile group per grid step: the JAX kernels unroll their body over the
# groups of a step, so this keeps their interpret-mode programs small
CFG = RasterizerConfig(chunk_size=128, pairs_per_gaussian=32, group_tiles=2,
                       groups_per_step=1)

CASES = {
    # > 128 pairs in some tiles (several JAX chunks) and early exit
    "multi_chunk_early_exit": (dict(n=400, width=48, height=32, seed=3,
                                    opacity_hi=6.0), CFG),
    # as many gaussians as above, so the JAX kernel's shapes and its
    # compiled program are the same
    "partial_tiles": (dict(n=400, width=40, height=24, seed=5), CFG),
    # pixel bbox test, inclusive overlap, the CUDA threshold and alpha_min;
    # phantom tiles in the last group and two groups per grid step
    "reference_cuda_alpha_min": (dict(n=80, width=48, height=32, seed=7),
                                 dataclasses.replace(
                                     CFG, compat=CompatConfig.REFERENCE_CUDA,
                                     t_threshold=1e-3, alpha_min=1.0 / 255.0,
                                     group_tiles=4, groups_per_step=2)),
}


@functools.lru_cache(maxsize=None)
def _bins(case):
    scene_kw, cfg = CASES[case]
    raw, cam, model = small_scene(**scene_kw)
    ntx, nty = tile_grid(cam.width, cam.height, cfg.tile_size)
    ng = num_groups_for(ntx * nty, cfg)
    bins = jax_fast(lambda: bin_gaussians(project_gaussians(model, cam, cfg),
                                          cam.width, cam.height, cfg))
    return cfg, ng, bins


_COMPILED = {}    # (ng, cfg, pool shape) -> the compiled forward and VJP


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The Pallas kernel's output and its VJP for a random cotangent of
    the (NG, 5, GT, 256) output: (out, cotangent, record gradient)."""
    cfg, ng, bins = _bins(case)
    g = np.random.default_rng(0).normal(
        size=(ng, 5, cfg.group_tiles, cfg.tile_size ** 2)).astype(np.float32)
    key = (ng, cfg, bins.pair_records.shape)
    if key not in _COMPILED:
        def fwd_vjp(records, group_starts, g):
            out, vjp = jax.vjp(lambda r: jr.rasterize_pairs(
                r, group_starts, ng, cfg, True), records)
            return out, vjp(g)[0]

        _COMPILED[key] = jax.jit(fwd_vjp).lower(
            bins.pair_records, bins.group_starts, g).compile(FAST_COMPILE)
    out, drec = _COMPILED[key](bins.pair_records, bins.group_starts, g)
    return np.asarray(out), g, np.asarray(drec)


def _port_args(bins, device="cpu"):
    return tuple(torch.from_numpy(np.array(x)).to(device) for x in (
        bins.pair_records, bins.tile_starts, bins.tile_counts))


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_pairs_matches_pallas(case):
    cfg, ng, bins = _bins(case)
    want = _jax_run(case)[0]
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
    out, g, want = _jax_run(case)
    records, starts, counts = _port_args(bins)
    got = np_(tr.rasterize_pairs_backward_reference(
        records, starts, counts, torch.from_numpy(out),
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
    pixel's exit and the pairs read up to each tile's last exit: every
    pair and evaluation with a threshold nothing reaches, fewer
    evaluations with early exit."""
    cfg, ng, bins = _bins("multi_chunk_early_exit")
    args = _port_args(bins)
    pairs = int(np.asarray(bins.tile_counts).sum())
    pix = cfg.tile_size ** 2
    _, ev, read = tr.rasterize_pairs_reference(*args, ng, port_config(cfg),
                                               count_evaluations=True)
    never = dataclasses.replace(port_config(cfg), t_threshold=0.0)
    _, ev_all, read_all = tr.rasterize_pairs_reference(
        *args, ng, never, count_evaluations=True)
    assert ev_all == pairs * pix and read_all == pairs
    assert 0 < ev < ev_all
    # a tile's pixels exit at different pairs: at least one evaluation per
    # pair read, at most every pixel of it
    assert 0 < read <= read_all and read <= ev <= read * pix


@pytest.mark.parametrize("w,h,ts,gt", [(84, 52, 16, 4), (85, 52, 32, 4)],
                         ids=["84x52_ts16", "85x52_ts32"])
def test_layout_helpers_match(w, h, ts, gt):
    cfg = RasterizerConfig(tile_size=ts, group_tiles=gt, groups_per_step=3)
    ntx, nty = tile_grid(w, h, ts)
    ng = num_groups_for(ntx * nty, cfg)
    rng = np.random.default_rng(0)
    tiles = rng.standard_normal((ng, 5, gt, ts * ts)).astype(np.float32)
    tt = torch.from_numpy(tiles)

    g = rng.standard_normal((3, h, w)).astype(np.float32)

    def untile_and_vjp(t, g):
        out, vjp = jax.vjp(lambda t: jax_untile_chw_fast(t, ntx, nty, ts, h,
                                                         w, True), t)
        return out, vjp(g)[0]

    want_chw, want = (np.asarray(x) for x in jax_fast(
        untile_and_vjp, jnp.asarray(tiles[:, :4]), g))
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
