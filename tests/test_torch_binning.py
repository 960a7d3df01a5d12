"""Port vs JAX package: bin_gaussians on the same JAX-projected gaussians.

Integers exactly equal (tile_starts, tile_counts, group_starts, num_pairs,
overflowed, pair_rank, pair_valid); pair_records within atol 1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest

from intro_to_gaussian_splatting_tpu.config import (
    CompatConfig,
    RasterizerConfig,
)
from intro_to_gaussian_splatting_tpu.ops import binning as jb
from intro_to_gaussian_splatting_tpu.ops.projection import project_gaussians
from intro_to_gaussian_splatting_tpu_torch.ops import binning as tb
from tests.scenes import small_scene
from tests.test_torch_common import np_, port_config, port_projection

BASE = RasterizerConfig(chunk_size=128, pairs_per_gaussian=32, group_tiles=2)

SCENE = dict(n=150, width=72, height=40, seed=12)
CASES = {
    "default": (SCENE, BASE),
    # a tiny pool: whole gaussians drop far-to-near
    "overflow": (SCENE, dataclasses.replace(BASE, pairs_per_gaussian=1)),
    "inclusive_overlap": (SCENE, dataclasses.replace(
        BASE, compat=CompatConfig.REFERENCE_CUDA)),
    # large splats clamped to 2 tiles per axis; odd group padding
    "max_span": (dict(SCENE, seed=14, scale_lo=0.3, scale_hi=0.8),
                 dataclasses.replace(BASE, max_span=2, group_tiles=3,
                                     groups_per_step=2)),
}
# jitted: the eager op-by-op run is several times slower on the CPU
jax_bin = jax.jit(jb.bin_gaussians, static_argnums=(1, 2, 3))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_gaussians_matches(case):
    scene_kw, cfg = CASES[case]
    raw, cam, model = small_scene(**scene_kw)
    proj = project_gaussians(model, cam, cfg)
    want = jax_bin(proj, cam.width, cam.height, cfg)
    got = tb.bin_gaussians(port_projection(proj), cam.width, cam.height,
                           port_config(cfg))
    for name in ("tile_starts", "tile_counts", "group_starts", "num_pairs",
                 "overflowed", "pair_rank", "pair_valid"):
        w, g = np.asarray(getattr(want, name)), np_(getattr(got, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(np_(got.pair_records),
                               np.asarray(want.pair_records), rtol=0,
                               atol=1e-6)
    if case == "overflow":
        assert bool(want.overflowed)
        assert int(want.num_pairs) > cfg.pairs_per_gaussian * 150
    else:
        assert not bool(want.overflowed)
    if case == "max_span":      # the clamp bites: some bbox spans > 2 tiles
        r, m = np.asarray(proj.radius), np.asarray(proj.mean2d)
        span = (np.floor(np.ceil(m[:, 0] + r) / 16)
                - np.floor(np.floor(m[:, 0] - r) / 16) + 1)
        assert (span[np.asarray(proj.valid)] > cfg.max_span).any()


def test_grid_helpers_match():
    for w, h, ts in ((5068, 3324, 16), (40, 24, 16), (16, 16, 16)):
        assert tb.tile_grid(w, h, ts) == jb.tile_grid(w, h, ts)
    cfg = RasterizerConfig(group_tiles=16, groups_per_step=16)
    for nt in (1, 65936, 65937):
        assert tb.num_groups_for(nt, port_config(cfg)) == \
            jb.num_groups_for(nt, cfg)
    assert tb.round_up(209452, 128) == jb.round_up(209452, 128)
