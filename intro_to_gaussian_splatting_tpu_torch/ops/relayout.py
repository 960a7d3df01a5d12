"""Tile-group layout <-> channel-major image, differentiable.

``untile_chw_fast`` is an ``autograd.Function``: its forward launches kernel
B5-untile (csrc/untile_chw.cu) and its backward kernel B5-tile
(csrc/tile_chw.cu) for tensors on the card; for tensors on the CPU both run
their plain versions, ``untile_chw`` and ``tile_chw``.

Both kernels move strips of tiles through shared memory, a block per
strip on a 1-D grid, so they take any group count and image height. They
read or write the tile side as float4, and the image side as float4 where
its width is a multiple of 4 and its pointer 16-byte aligned, as 4 scalars
otherwise; the wrappers decide which from the shapes and pointers.
"""

from __future__ import annotations

import ctypes

import torch

from intro_to_gaussian_splatting_tpu_torch.ops.cuda_build import (
    CudaKernel,
    KernelSource,
)

UNTILE_SOURCE = KernelSource("untile_chw", ("-fmad=false",))
UNTILE_CHW = CudaKernel(UNTILE_SOURCE, "untile_chw", [
    ctypes.c_void_p, *[ctypes.c_int] * 9, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p,
])
TILE_SOURCE = KernelSource("tile_chw", ("-fmad=false",))
TILE_CHW = CudaKernel(TILE_SOURCE, "tile_chw", [
    ctypes.c_void_p, *[ctypes.c_int] * 10, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p,
])
CHANNELS = 3   # untile_chw_fast returns the colour channels
TILE_SIZES = (16, 32)    # the kernels' template instances
MAX_QUADS = 2 ** 31 - 1  # the kernels index tile slots in 32 bits


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
    if ts not in TILE_SIZES:
        raise ValueError(f"the relayout kernels take tiles of {TILE_SIZES} "
                         f"pixels a side, not {ts}")
    if ng * gt * pix // 4 > MAX_QUADS:
        raise ValueError("the relayout kernels take up to 2^31 - 1 float4s "
                         "of tile slots per channel")


def _vec_image(img: torch.Tensor, width: int) -> int:
    """1 where the image side can move as float4: whole float4 rows and a
    16-byte aligned pointer."""
    return int(width % 4 == 0 and img.data_ptr() % 16 == 0)


def _untile_cuda(tile_out, ntx, nty, ts, height, width):
    ng, c, gt, pix = tile_out.shape
    if tile_out.dtype != torch.float32 or not tile_out.is_contiguous():
        raise ValueError("untile_chw_fast takes a contiguous float32 tensor")
    _check_layout(ng, c, gt, pix, ntx, nty, ts, height, width)
    if tile_out.data_ptr() % 16:
        # the kernel reads the tiles as float4: a view at an offset that is
        # not 16-byte aligned (the rasterizer's output never is) is copied
        tile_out = tile_out.clone()
    out = torch.empty((CHANNELS, height, width), dtype=torch.float32,
                      device=tile_out.device)
    UNTILE_CHW.launch(
        tile_out.data_ptr(), c, CHANNELS, gt, ntx, nty, ts, height, width,
        _vec_image(out, width), out.data_ptr(), tile_out.device.index or 0,
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
        height, width, _vec_image(img, width), out.data_ptr(),
        img.device.index or 0,
        torch.cuda.current_stream(img.device).cuda_stream)
    return out


def tile_chw_fast(img: torch.Tensor, num_groups: int, channels: int,
                  group_tiles: int, ntx: int, nty: int,
                  ts: int) -> torch.Tensor:
    """``tile_chw`` of a 3-channel image (the gradient of
    ``untile_chw_fast``) through kernel B5-tile for an image on the card,
    the plain version for one on the CPU."""
    if img.shape[0] != CHANNELS:
        raise ValueError(f"tile_chw_fast takes a {CHANNELS}-channel image, "
                         f"not {img.shape[0]}")
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
    >= 3, outside the image and in the phantom tiles.

    On the card the kernel reads the tiles as float4: a ``tile_out`` whose
    pointer is not 16-byte aligned (a view at such an offset; the
    rasterizer's output never is) is first copied whole."""
    return _UntileChw.apply(tile_out, ntx, nty, ts, height, width)
