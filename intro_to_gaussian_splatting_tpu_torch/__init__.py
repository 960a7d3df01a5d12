"""PyTorch/CUDA port of the gaussian-splatting framework, for the H100.

It sits beside the JAX package ``intro_to_gaussian_splatting_tpu``, which
stays the reference it is held against, and imports nothing of it or of JAX.
It renders a view and trains one camera per step:

  io/        COLMAP readers, synthetic scenes
  models/    Camera, GaussianModel (nn.Module), spherical harmonics, KNN init
  ops/       projection, binning, dense oracle, tiled rasterizer (kernels B1
             and its backward B2), tile <-> image relayouts (kernels
             B5-untile and B5-tile), the fused L1+SSIM loss (kernel B3),
             render dispatch
  train/     losses and metrics, densify/prune, Adam and the training step,
             the Trainer loop
  csrc/      the CUDA C++ kernels, built with nvcc at first use
  convert.py numpy -> port model, camera and training state (from the JAX
             package)
  cli.py     ``gstpu-torch render`` / ``gstpu-torch info``

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from intro_to_gaussian_splatting_tpu_torch.config import (
    CompatConfig,
    RasterizerConfig,
    TrainConfig,
)

__all__ = ["CompatConfig", "RasterizerConfig", "TrainConfig"]
