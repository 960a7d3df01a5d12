"""Port vs JAX package: bin_gaussians on the same JAX-projected gaussians.

Integers exactly equal (tile_starts, tile_counts, group_starts, num_pairs,
overflowed, pair_rank, pair_valid); pair_records within atol 1e-6. On the
CPU the gather's backward is the plain version (the two-level running sum
of ``_segment_sums``), held against the JAX package's gather VJP; the
invariant that kernel G1 relies on on the card (the emitted prefix of the
tile sort is a permutation of itself) holds in every case. The depth
order's gather lies inside the gather's autograd node, so no index
backward of PyTorch's runs, and the gradient is the one autograd gave
through ``records[:, order]`` bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.config import (
    CompatConfig,
    RasterizerConfig,
)
from intro_to_gaussian_splatting_tpu.ops import binning as jb
from intro_to_gaussian_splatting_tpu.ops.projection import project_gaussians
from intro_to_gaussian_splatting_tpu_torch.ops import binning as tb
from intro_to_gaussian_splatting_tpu_torch.ops import cuda_build
from intro_to_gaussian_splatting_tpu_torch.ops import projection as tp
from tests import binning_cases
from tests.scenes import small_scene
from tests.test_torch_common import (
    jax_fast,
    np_,
    port_config,
    port_projection,
)

CASES = {case: (scene, binning_cases.config(case, RasterizerConfig,
                                            CompatConfig))
         for case, (scene, _) in binning_cases.CASES.items()}
# jitted: the eager op-by-op run is several times slower on the CPU
jax_bin = jax.jit(jb.bin_gaussians, static_argnums=(1, 2, 3))
# the projection's fields that carry a gradient into the records
GRAD_FIELDS = ("mean2d", "conic", "opacity", "color", "depth")


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


def _port_bins(case):
    """The JAX-projected scene of ``CASES[case]``, binned by the port with
    the projection's gradient fields as leaves: (JAX projection, leaves,
    bins, the gather's autograd node, config, camera)."""
    scene_kw, cfg = CASES[case]
    _, cam, model = small_scene(**scene_kw)
    proj = project_gaussians(model, cam, cfg)
    port = port_projection(proj)
    leaves = {f: getattr(port, f).requires_grad_(True) for f in GRAD_FIELDS}
    bins = tb.bin_gaussians(dataclasses.replace(port, **leaves), cam.width,
                            cam.height, port_config(cfg))
    return proj, leaves, bins, bins.pair_records.grad_fn, cfg, cam


@pytest.mark.parametrize("case", sorted(CASES))
def test_emitted_prefix_is_a_permutation(case):
    """What G1 relies on: the depth order is a permutation of the
    gaussians, the tile sort's perm[:total_emit] is a permutation of [0,
    total_emit), every sorted slot from total_emit on holds the sentinel
    key, and every block [lo, hi) lies in the prefix. G1's function, the
    emitted gradients moved to emission order, each block summed and
    written to its gaussian, is then the plain version's."""
    _, _, bins, node, cfg, cam = _port_bins(case)
    order, perm, lo, hi = node.saved_tensors
    total = node.total_emit
    mp = bins.pair_records.shape[1]
    n = lo.shape[0]
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    assert perm.shape == (mp,) and 0 < total < mp
    assert torch.equal(torch.sort(perm[:total]).values, torch.arange(total))
    ntx, nty = tb.tile_grid(cam.width, cam.height, cfg.tile_size)
    sentinel = tb.num_groups_for(ntx * nty, cfg) * cfg.group_tiles
    keys = bins.pair_records[tp.REC_TILE].detach().long()  # f32-exact ids
    assert bool((keys[total:] == sentinel).all())
    assert bool((keys[:total] < ntx * nty).all())
    assert bool((lo <= hi).all()) and int(hi.max()) == total
    assert total == int(bins.num_pairs) or bool(bins.overflowed)
    # G1's function in float64
    g = torch.randn((tp.NUM_REC_ROWS, mp),
                    generator=torch.Generator().manual_seed(4))
    want = binning_cases.emission_sums(g, order, perm, lo, hi, total)
    others = [r for r in range(tp.NUM_REC_ROWS) if r not in tp.GRAD_ROWS]
    want[others] = 0.0
    got = tb.gather_pairs_backward_reference(g, order, perm, lo, hi)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_backward_on_cpu_matches_jax_vjp(case, monkeypatch):
    """On the CPU ``_GatherPairs.backward`` takes the plain version, once
    through ``_segment_sums`` and never through G1 (nothing built or
    launched), and its gradient is the JAX package's gather VJP, for a
    cotangent that, as the rasterizer backward's, is zero outside the
    gradient rows."""
    def no_build(*args):
        raise AssertionError("a CPU tensor reached the CUDA build")

    calls = []

    def counted(*args):
        calls.append(1)
        return plain(*args)

    plain = tb._segment_sums
    monkeypatch.setattr(cuda_build, "build", no_build)
    monkeypatch.setattr(tb, "_segment_sums", counted)
    launches = tb.SEGMENT_SUMS.launches
    proj, leaves, bins, _, cfg, cam = _port_bins(case)
    rng = np.random.default_rng(5)
    w = np.zeros(tuple(bins.pair_records.shape), np.float32)
    w[list(tp.GRAD_ROWS)] = rng.normal(size=(len(tp.GRAD_ROWS),
                                             w.shape[1]))
    got = torch.autograd.grad(bins.pair_records, list(leaves.values()),
                              torch.from_numpy(w))
    assert len(calls) == 1 and tb.SEGMENT_SUMS.launches == launches

    def vjp(fields, w):
        _, back = jax.vjp(lambda f: jb.bin_gaussians(
            dataclasses.replace(proj, **f), cam.width, cam.height,
            cfg).pair_records, fields)
        return back(w)[0]

    want = jax_fast(vjp, {f: getattr(proj, f) for f in GRAD_FIELDS}, w)
    # both round in float32, in other orders: a gaussian's sum of up to
    # 160 unit-scale terms parts by about 1e-5 (at most 1e-5 seen)
    for f, g in zip(GRAD_FIELDS, got):
        np.testing.assert_allclose(np_(g), np.asarray(want[f]), rtol=1e-5,
                                   atol=5e-5, err_msg=f)


def _node_names(fn):
    """The class names of every node of the autograd graph below ``fn``."""
    names, seen, stack = set(), set(), [fn]
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.add(type(f).__name__)
        stack.extend(nxt for nxt, _ in f.next_functions)
    return names


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_backward_has_no_index_backward(case):
    """The depth order's gather lies inside ``_GatherPairs``: no
    ``IndexBackward0`` between the pair records and the projection's
    leaves, and the gradient to those leaves is, bit for bit, that of
    autograd through ``pack_records(proj)[:, order]`` fed the gather's
    gradient in depth-rank order (the emitted pair gradients moved to
    emission order and each rank's block summed, rebuilt here)."""
    proj, leaves, bins, node, _, _ = _port_bins(case)
    assert "IndexBackward0" not in _node_names(bins.pair_records.grad_fn)
    order, perm, lo, hi = node.saved_tensors
    rng = np.random.default_rng(7)
    w = np.zeros(tuple(bins.pair_records.shape), np.float32)
    w[list(tp.GRAD_ROWS)] = rng.normal(size=(len(tp.GRAD_ROWS),
                                             w.shape[1]))
    w = torch.from_numpy(w)
    got = torch.autograd.grad(bins.pair_records, list(leaves.values()), w)

    rows = list(tp.GRAD_ROWS)
    g_em = torch.empty_like(w[rows])
    g_em[:, perm] = w[rows]
    d_rank = torch.zeros((tp.NUM_REC_ROWS, lo.shape[0]))
    d_rank[rows] = tb._segment_sums(g_em, lo, hi)
    records_rank = tp.pack_records(dataclasses.replace(
        port_projection(proj), **leaves))[:, order]
    assert "IndexBackward0" in _node_names(records_rank.grad_fn)
    want = torch.autograd.grad(records_rank, list(leaves.values()), d_rank)
    for f, a, b in zip(GRAD_FIELDS, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
