"""The binning cases shared by ``tests/test_torch_binning.py`` (the port
against the JAX package, on the CPU) and the card test of kernel G1 in
``tests/test_torch_kernels.py``: keywords of ``tests.scenes.small_scene``
and fields of ``RasterizerConfig``, which each file builds with its own
package's config classes; and the gather's gradient summed exactly. No
JAX here: the card's machine has none."""

import torch

SCENE = dict(n=150, width=72, height=40, seed=12)
BASE = dict(chunk_size=128, pairs_per_gaussian=32, group_tiles=2)
CASES = {
    "default": (SCENE, BASE),
    # a tiny pool: whole gaussians drop far-to-near
    "overflow": (SCENE, dict(BASE, pairs_per_gaussian=1)),
    "inclusive_overlap": (SCENE, dict(BASE, compat="REFERENCE_CUDA")),
    # large splats clamped to 2 tiles per axis; odd group padding
    "max_span": (dict(SCENE, seed=14, scale_lo=0.3, scale_hi=0.8),
                 dict(BASE, max_span=2, group_tiles=3, groups_per_step=2)),
    # wide splats: up to 160 pairs a gaussian, most of them over 32
    "wide": (dict(n=100, width=256, height=160, seed=15, scale_lo=0.2,
                  scale_hi=0.6), dict(BASE, pairs_per_gaussian=128)),
}


def config(case, config_cls, compat_cls):
    """``CASES[case]``'s config as a ``config_cls``, its ``compat`` preset
    looked up on ``compat_cls``."""
    fields = dict(CASES[case][1])
    if "compat" in fields:
        fields["compat"] = getattr(compat_cls, fields["compat"])
    return config_cls(**fields)


def emission_sums(g, order, perm, lo, hi, total):
    """The gather's gradient in float64: the (16, MP) sorted-order ``g``
    moved to emission order through the tile sort's ``perm``, each depth
    rank i's block [lo[i], hi[i]) summed and written to gaussian
    ``order[i]``, (16, N), in every row."""
    inv = torch.empty(total, dtype=torch.int64, device=g.device)
    inv[perm[:total]] = torch.arange(total, device=g.device)
    cum = torch.nn.functional.pad(torch.cumsum(g[:, inv].double(), dim=1),
                                  (1, 0))
    sums = torch.empty_like(cum[:, hi])
    sums[:, order] = cum[:, hi] - cum[:, lo]
    return sums
