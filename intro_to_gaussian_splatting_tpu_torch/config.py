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

``TrainConfig`` has every field and default of the JAX package's, and the
trainer takes each of them.
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """3DGS optimization hyperparameters (the 3DGS paper's / gsplat's
    values, as in the JAX package)."""

    iterations: int = 7000
    lr_means: float = 1.6e-4        # scaled by scene extent
    lr_means_final: float = 1.6e-6
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_sh0: float = 2.5e-3
    lr_shN: float = 2.5e-3 / 20.0
    ssim_weight: float = 0.2        # loss = (1-w)*L1 + w*(1-SSIM)
    # True: the fused tile-space L1+SSIM value and gradient (kernel B3);
    # False: the split path (tile L1 + untile + SSIM, kernels B4a and B4b)
    fused_loss: bool = True
    sh_degree: int = 3
    sh_degree_interval: int = 1000  # raise active SH degree every N steps
    # densification
    densify_start: int = 500
    densify_stop: int = 15000
    densify_interval: int = 100
    densify_grad_threshold: float = 2e-4
    densify_scale_threshold: float = 0.01  # x scene extent: split vs clone
    prune_opacity_threshold: float = 5e-3
    opacity_reset_interval: int = 3000
    capacity_multiplier: float = 4.0  # fixed pool = multiplier * init count
    # cameras averaged per optimizer step (train_step_batched when > 1)
    camera_batch: int = 1
    seed: int = 0
    # periodic full-state saves (Trainer.checkpoint_dir), newest kept
    checkpoint_every: int = 0
    checkpoint_keep: int = 3
