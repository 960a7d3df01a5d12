"""The benchmark's plain reference: 3D gaussian splatting in plain PyTorch.

It renders a view and takes a training step from the same inputs the
benchmark hands the program (gaussian parameters, camera poses, targets),
and imports nothing of the program. Float32 throughout, with TF32 off;
``precision="tf32"`` rounds the inputs of every matrix product and
convolution to TF32's 10-bit mantissa, which is the control the check has
to fail.

  camera.py     pinhole camera matrices from a pose
  projection.py 3D gaussians -> screen-space splats (autograd-able)
  binning.py    splats -> (tile, depth)-sorted pairs
  raster.py     compositing and its gradient, per depth rank (a frozen copy
                of the port's plain versions of its kernels B1 and B2)
  loss.py       (1 - w) * L1 + w * (1 - SSIM)
  train.py      one training step, Adam, densify and prune
  render.py     one view
"""
