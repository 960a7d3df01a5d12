"""Tile-group layout <-> channel-major image, differentiable.

``untile_chw_fast`` is an ``autograd.Function``: its forward launches kernel
B5-untile (csrc/untile_chw.cu) and its backward kernel B5-tile
(csrc/tile_chw.cu) for tensors on the card; for tensors on the CPU both run
their plain versions, ``untile_chw`` and ``tile_chw``.
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
TILE_SOURCE = KernelSource("tile_chw")
TILE_CHW = CudaKernel(TILE_SOURCE, "tile_chw", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
])
CHANNELS = 3   # untile_chw_fast returns the colour channels


def untile_chw(tile_out: torch.Tensor, ntx: int, nty: int, ts: int,
               height: int, width: int) -> torch.Tensor:
    """(NG, C, GT, ts*ts) tile groups -> (C, H, W), channel-major: the plain
    version, a reshape and permute."""
    ng, c, gt, pix = tile_out.shape
    flat = tile_out.permute(0, 2, 1, 3).reshape(ng * gt, c, pix)
    img = flat[:ntx * nty].reshape(nty, ntx, c, ts, ts)
    img = img.permute(2, 0, 3, 1, 4).reshape(c, nty * ts, ntx * ts)
    return img[:, :height, :width].contiguous()


def tile_chw(img: torch.Tensor, num_groups: int, channels: int,
             group_tiles: int, ntx: int, nty: int, ts: int) -> torch.Tensor:
    """(c, H, W) image -> (NG, channels, GT, ts*ts) tile groups, zero
    outside the image, in the phantom tiles and in channels >= c: the plain
    version of kernel B5-tile, the explicit inverse permute of
    ``untile_chw``."""
    c, h, w = img.shape
    pad = torch.nn.functional.pad(img, (0, ntx * ts - w, 0, nty * ts - h))
    tiles = pad.reshape(c, nty, ts, ntx, ts).permute(1, 3, 0, 2, 4)
    tiles = tiles.reshape(nty * ntx, c, ts * ts)
    tiles = torch.nn.functional.pad(
        tiles, (0, 0, 0, channels - c, 0, num_groups * group_tiles - nty * ntx))
    return tiles.reshape(num_groups, group_tiles, channels, ts * ts).permute(
        0, 2, 1, 3).contiguous()


def _check_layout(ng, c, gt, pix, ntx, nty, ts, height, width):
    if pix != ts * ts or CHANNELS > c or ng * gt < ntx * nty:
        raise ValueError(f"tile layout {(ng, c, gt, pix)} does not hold "
                         f"a {ntx}x{nty} grid of {ts}x{ts} tiles")
    if ntx * ts < width or nty * ts < height:
        raise ValueError("image larger than the tile grid")
    if height > 65535 or ng > 65535 or ts * ts > 1024:
        raise ValueError("the relayout kernels take up to 65,535 image rows "
                         "and tile groups, and tiles of up to 1024 pixels")


def _untile_cuda(tile_out, ntx, nty, ts, height, width):
    ng, c, gt, pix = tile_out.shape
    if tile_out.dtype != torch.float32 or not tile_out.is_contiguous():
        raise ValueError("untile_chw_fast takes a contiguous float32 tensor")
    _check_layout(ng, c, gt, pix, ntx, nty, ts, height, width)
    out = torch.empty((CHANNELS, height, width), dtype=torch.float32,
                      device=tile_out.device)
    UNTILE_CHW.launch(
        tile_out.data_ptr(), c, CHANNELS, gt, ntx, ts, height, width,
        out.data_ptr(), tile_out.device.index or 0,
        torch.cuda.current_stream(tile_out.device).cuda_stream)
    return out


def _tile_cuda(img, num_groups, channels, group_tiles, ntx, nty, ts):
    c, height, width = img.shape
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("the B5-tile kernel takes a contiguous float32 "
                         "image")
    _check_layout(num_groups, channels, group_tiles, ts * ts, ntx, nty, ts,
                  height, width)
    out = torch.empty((num_groups, channels, group_tiles, ts * ts),
                      dtype=torch.float32, device=img.device)
    TILE_CHW.launch(
        img.data_ptr(), c, channels, num_groups, group_tiles, ntx, nty, ts,
        height, width, out.data_ptr(), img.device.index or 0,
        torch.cuda.current_stream(img.device).cuda_stream)
    return out


def tile_chw_fast(img: torch.Tensor, num_groups: int, channels: int,
                  group_tiles: int, ntx: int, nty: int,
                  ts: int) -> torch.Tensor:
    """``tile_chw`` through kernel B5-tile for an image on the card, the
    plain version for one on the CPU."""
    if img.is_cuda:
        return _tile_cuda(img, num_groups, channels, group_tiles, ntx, nty,
                          ts)
    return tile_chw(img, num_groups, channels, group_tiles, ntx, nty, ts)


class _UntileChw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tile_out, ntx, nty, ts, height, width):
        ng, c, gt, _ = tile_out.shape
        ctx.layout = (ng, c, gt, ntx, nty, ts)
        if tile_out.is_cuda:
            return _untile_cuda(tile_out, ntx, nty, ts, height, width)
        return untile_chw(tile_out[:, :CHANNELS], ntx, nty, ts, height,
                          width)

    @staticmethod
    def backward(ctx, g):
        ng, c, gt, ntx, nty, ts = ctx.layout
        d = tile_chw_fast(g.contiguous(), ng, c, gt, ntx, nty, ts)
        return d, None, None, None, None, None


def untile_chw_fast(tile_out: torch.Tensor, ntx: int, nty: int, ts: int,
                    height: int, width: int) -> torch.Tensor:
    """The colour channels (the first 3) of (NG, C, GT, ts*ts) tile groups
    as a (3, H, W) image; the same values as ``untile_chw``. Its gradient is
    the (NG, C, GT, ts*ts) tile layout of the image's, zero in channels
    >= 3, outside the image and in the phantom tiles."""
    return _UntileChw.apply(tile_out, ntx, nty, ts, height, width)
