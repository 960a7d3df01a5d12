"""Projection, binning, compositing and the tiled rasterizer.

The CUDA kernels (csrc/) are built and loaded at their first launch, never
at import, so every module here imports on a machine without a card."""
