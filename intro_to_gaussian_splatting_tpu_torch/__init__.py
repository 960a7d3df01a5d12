"""PyTorch/CUDA port of the gaussian-splatting framework, for the H100.

It sits beside the JAX package ``intro_to_gaussian_splatting_tpu``, which
stays the reference it is held against, and imports nothing of it or of JAX.
It renders views, trains a scene on one card, saves, resumes and scores it:

  io/        COLMAP readers and writers, PLY, the scene loader with its
             photos, synthetic scenes, dataset download
  models/    Camera, GaussianModel (nn.Module), spherical harmonics, KNN init
  ops/       projection, binning, dense oracle, tiled rasterizer (kernels B1
             and its backward B2), tile <-> image relayouts (kernels
             B5-untile and B5-tile), the fused L1+SSIM loss (kernel B3), the
             fused SSIM (kernels B4a-c), render dispatch, the point
             projection, the probe kernels P1 and P2
  train/     losses and metrics, densify/prune, Adam and the training step,
             the Trainer loop, checkpoints and PLY export, evaluation
  utils/     spans of the port's layers, kernel timing, the host C++
  scripts/   ``probe_kernel`` (P1 and P2 on the card)
  csrc/      the CUDA C++ kernels, built with nvcc at first use
  convert.py numpy -> port model, camera and training state (from the JAX
             package)
  cli.py     ``gstpu-torch render|points|info|train|eval|fetch``

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from intro_to_gaussian_splatting_tpu_torch.config import (
    CompatConfig,
    RasterizerConfig,
    TrainConfig,
)

__all__ = ["CompatConfig", "RasterizerConfig", "TrainConfig"]
