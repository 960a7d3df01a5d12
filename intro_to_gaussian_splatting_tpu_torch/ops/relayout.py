"""Tile-group layout -> channel-major image, forward only.

``untile_chw_fast`` launches kernel B5-untile (csrc/untile_chw.cu) for a
tensor on the card and runs the plain version, ``untile_chw``, for a tensor
on the CPU. The gradient (the TPU package's ``_tile_kernel``) comes with the
training slice.
"""

from __future__ import annotations

import ctypes

import torch

from intro_to_gaussian_splatting_tpu_torch.ops.cuda_build import (
    CudaKernel,
    KernelSource,
)

UNTILE_SOURCE = KernelSource("untile_chw")
UNTILE_CHW = CudaKernel(UNTILE_SOURCE, "untile_chw", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p,
])


def untile_chw(tile_out: torch.Tensor, ntx: int, nty: int, ts: int,
               height: int, width: int) -> torch.Tensor:
    """(NG, C, GT, ts*ts) tile groups -> (C, H, W), channel-major: the plain
    version, a reshape and permute."""
    ng, c, gt, pix = tile_out.shape
    flat = tile_out.permute(0, 2, 1, 3).reshape(ng * gt, c, pix)
    img = flat[:ntx * nty].reshape(nty, ntx, c, ts, ts)
    img = img.permute(2, 0, 3, 1, 4).reshape(c, nty * ts, ntx * ts)
    return img[:, :height, :width].contiguous()


def untile_chw_fast(tile_out: torch.Tensor, ntx: int, nty: int, ts: int,
                    height: int, width: int) -> torch.Tensor:
    """The colour channels (the first 3) of (NG, C, GT, ts*ts) tile groups
    as a (3, H, W) image; the same values as ``untile_chw``."""
    channels = 3
    if not tile_out.is_cuda:
        return untile_chw(tile_out[:, :channels], ntx, nty, ts, height, width)
    ng, c, gt, pix = tile_out.shape
    if tile_out.dtype != torch.float32 or not tile_out.is_contiguous():
        raise ValueError("untile_chw_fast takes a contiguous float32 tensor")
    if pix != ts * ts or channels > c or ng * gt < ntx * nty:
        raise ValueError(f"tile layout {tuple(tile_out.shape)} does not hold "
                         f"a {ntx}x{nty} grid of {ts}x{ts} tiles")
    if ntx * ts < width or nty * ts < height:
        raise ValueError("image larger than the tile grid")
    if height > 65535:
        raise ValueError("untile_chw_fast takes images up to 65,535 rows")
    out = torch.empty((channels, height, width), dtype=torch.float32,
                      device=tile_out.device)
    UNTILE_CHW.launch(
        tile_out.data_ptr(), c, channels, gt, ntx, ts, height, width,
        out.data_ptr(), tile_out.device.index or 0,
        torch.cuda.current_stream(tile_out.device).cuda_stream)
    return out
