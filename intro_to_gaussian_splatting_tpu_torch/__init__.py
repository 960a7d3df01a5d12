"""PyTorch/CUDA port of the gaussian-splatting framework, for the H100.

It sits beside the JAX package ``intro_to_gaussian_splatting_tpu``, which
stays the reference it is held against, and imports nothing of it or of JAX.
This slice is the render path:

  io/        COLMAP readers, synthetic scenes
  models/    Camera, GaussianModel (nn.Module), spherical harmonics, KNN init
  ops/       projection, binning, dense oracle, tiled rasterizer (kernel B1),
             tile -> image relayout (kernel B5-untile), render dispatch
  csrc/      the CUDA C++ kernels, built with nvcc at first use
  convert.py numpy -> port model/camera (weights from the JAX package)
  cli.py     ``gstpu-torch render`` / ``gstpu-torch info``

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from intro_to_gaussian_splatting_tpu_torch.config import (
    CompatConfig,
    RasterizerConfig,
)

__all__ = ["CompatConfig", "RasterizerConfig"]
