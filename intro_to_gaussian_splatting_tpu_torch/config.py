"""Configuration dataclasses of the PyTorch/CUDA port.

Same fields, defaults and checks as ``intro_to_gaussian_splatting_tpu.config``
so that pair-pool rounding, sentinel tile ids and group padding come out
identical in both packages. Several knobs were shaped by the TPU; on the card
they mean:

  * ``chunk_size``: records a rasterizer block stages in shared memory per
    batch on the TPU; here it only rounds the pair pool (``max_pairs``) and
    sizes the trailing sentinel chunk, exactly as the JAX package does. The
    CUDA kernel stages its own fixed batch.
  * ``group_tiles`` / ``groups_per_step``: the output layout
    ``(NG, 5, GT, ts*ts)`` and the padding of the group count only. The card
    runs one block per tile whatever the grouping.
  * ``accum_precision``: ignored. The CUDA kernel always accumulates in plain
    f32 arithmetic, which is what ``"highest"`` means on the TPU.

``TrainConfig`` comes with the training slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CompatConfig:
    """Flags reproducing reference quirks; the defaults are the correct
    behaviours (see the JAX package's config for each quirk's origin)."""

    # apply the opacity sigmoid twice (reference CPU path)
    double_sigmoid: bool = False
    # blank the last partial tile row/column (reference CPU path)
    skip_last_tile: bool = False
    # a bbox touching the first pixel of the next tile still bins into it
    inclusive_tile_overlap: bool = False
    # reject pixels outside the gaussian's own bbox (reference CUDA path)
    pixel_bbox_test: bool = False

    REFERENCE_CPU = None  # filled in below
    REFERENCE_CUDA = None


CompatConfig.REFERENCE_CPU = CompatConfig(
    double_sigmoid=True,
    skip_last_tile=True,
    inclusive_tile_overlap=True,
    pixel_bbox_test=False,
)
CompatConfig.REFERENCE_CUDA = CompatConfig(
    double_sigmoid=False,
    skip_last_tile=False,
    inclusive_tile_overlap=True,
    pixel_bbox_test=True,
)


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Static knobs for the projection + binning + compositing pipeline."""

    tile_size: int = 16           # pixels per tile side
    chunk_size: int = 128         # pair-pool rounding (see module docstring)
    group_tiles: int = 64         # tiles per output group (layout only)
    t_threshold: float = 1e-4     # transmittance early-exit threshold
    alpha_clamp: float = 0.99     # per-gaussian alpha clamp
    alpha_min: float = 0.0        # skip contributions with alpha below this
    frustum_min_z: float = 0.2    # near-plane cull
    ewa_clamp: float = 1.3        # EWA xy clamp factor
    det_clamp: float = 1e-3       # 2D covariance determinant clamp
    eig_floor: float = 0.1        # eigenvalue discriminant floor
    radius_sigmas: float = 3.0    # screen-space radius in sigmas
    cov2d_dilation: float = 0.0   # low-pass dilation of the 2D covariance
    # pair-pool capacity as a multiple of the number of gaussians;
    # overflowing gaussians are dropped far-to-near, whole
    pairs_per_gaussian: int = 4
    max_span: int = 32            # cap on tiles a gaussian spans per axis
    accum_precision: str = "highest"  # ignored on the card (see above)
    groups_per_step: int = 4      # group-count padding (layout only)
    compat: CompatConfig = dataclasses.field(default_factory=CompatConfig)

    def __post_init__(self):
        assert self.tile_size > 0 and self.chunk_size > 0
        assert self.chunk_size % 128 == 0, \
            "chunk_size must be a multiple of the 128-lane f32 tile"
        assert (self.tile_size ** 2) % 128 == 0, \
            "tile_size^2 must fill whole 128-lane vector registers"
        assert self.group_tiles > 0
        assert self.alpha_clamp <= 0.9999, \
            "alpha must stay < 1 so transmittance is monotone"
        assert self.accum_precision in ("split3", "highest", "default")
        assert self.groups_per_step >= 1
