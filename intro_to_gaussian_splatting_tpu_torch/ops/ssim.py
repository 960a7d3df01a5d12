"""Fused SSIM of channel-major (3, H, W) images: value and pixel gradient.

The counterpart of the JAX package's ops/ssim_pallas.py, with its
signatures less ``interpret``:

  * ``fused_ssim_sum(pred, target, c1, c2, grad_target)``: the sum of the
    SSIM map over the (H-10) x (W-10) VALID 11x11 gaussian windows (sigma
    1.5) of the 3 channels. Its forward is kernel B4a, its backward kernel
    B4b, which recomputes the windows and spreads their coefficients back
    onto the pixels.
  * ``fused_ssim_sum_vg``: the same value, but its forward is kernel B4c,
    which computes the value and the gradient at unit cotangent in one pass
    and stores the gradient for the backward (for paths that always
    differentiate).
  * ``fused_ssim``: their mean, divided by 3 * (H-10) * (W-10).

Each is a ``torch.autograd.Function``. With ``grad_target=False`` (a
constant target, as in training) the target's gradient is not computed:
it is None, or zeros where autograd asks for it. For images on the card
the kernels of csrc/ssim.cu run; for images on the CPU the plain versions,
``ssim_sum_reference`` under autograd (``train/loss.ssim_chw``'s map,
summed), the oracle the JAX package holds its kernels against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from intro_to_gaussian_splatting_tpu_torch.ops.cuda_build import (
    CudaKernel,
    KernelSource,
)
from intro_to_gaussian_splatting_tpu_torch.train import loss as L

HALO = L.WINDOW - 1
# the tile of window tops whose SSIM goes into one partial slot: B4a and
# B4c add each tile's windows in the same order, so that B4c's value is
# B4a's bit for bit
BLOCK_ROWS, BLOCK_COLS = 16, 32

SSIM_SOURCE = KernelSource("ssim", ("-fmad=false",))
_COMMON = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_float, ctypes.c_float]
_TAIL = [ctypes.c_int, ctypes.c_void_p]          # device, stream
SSIM_SUM = CudaKernel(SSIM_SOURCE, "ssim_sum",
                      _COMMON + [ctypes.c_void_p] * 2 + _TAIL)        # B4a
SSIM_GRAD = CudaKernel(SSIM_SOURCE, "ssim_grad",
                       _COMMON + [ctypes.c_void_p] * 3 + _TAIL)       # B4b
SSIM_VALUE_GRAD = CudaKernel(SSIM_SOURCE, "ssim_value_grad",
                             _COMMON + [ctypes.c_void_p] * 4 + _TAIL)  # B4c

def _check(pred, target):
    if pred.dim() != 3 or pred.shape[0] != 3:
        raise ValueError(f"SSIM takes (3, H, W) images, got "
                         f"{tuple(pred.shape)}")
    if tuple(target.shape) != tuple(pred.shape):
        raise ValueError(f"target {tuple(target.shape)} and prediction "
                         f"{tuple(pred.shape)} differ in shape")
    if pred.shape[1] <= HALO or pred.shape[2] <= HALO:
        raise ValueError("image smaller than the SSIM window")


def ssim_sum_reference(pred: torch.Tensor, target: torch.Tensor,
                       c1: float = L.C1, c2: float = L.C2) -> torch.Tensor:
    """Plain version of kernel B4a: the summed SSIM map."""
    return torch.sum(L.ssim_chw(pred, target, c1=c1, c2=c2, reduce=False))


def ssim_grad_reference(pred, target, g, c1=L.C1, c2=L.C2,
                        grad_target=True):
    """Plain version of kernel B4b: ``g`` times the gradient of the summed
    map, (dpred, dtarget or None)."""
    with torch.enable_grad():
        x = pred.detach().requires_grad_(True)
        y = target.detach().requires_grad_(grad_target)
        s = ssim_sum_reference(x, y, c1, c2)
        grads = torch.autograd.grad(s, [x, y] if grad_target else [x])
    return g * grads[0], (g * grads[1] if grad_target else None)


def ssim_value_grad_reference(pred, target, c1=L.C1, c2=L.C2,
                              grad_target=True):
    """Plain version of kernel B4c: (sum, dpred, dtarget or None) at unit
    cotangent."""
    value = ssim_sum_reference(pred.detach(), target.detach(), c1, c2)
    one = torch.ones((), dtype=pred.dtype, device=pred.device)
    return (value,) + ssim_grad_reference(pred, target, one, c1, c2,
                                          grad_target)


@functools.lru_cache(maxsize=None)
def _taps(device: torch.device) -> torch.Tensor:
    """The (11,) gaussian taps on ``device``, copied there once."""
    return torch.from_numpy(L.ssim_kernel1d()).to(device)


def _cuda_args(pred, target, c1, c2):
    _check(pred, target)
    dev = pred.device
    for t in (pred, target):
        if (t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError("the SSIM kernels take contiguous float32 "
                             "images on one card")
    _, h, w = pred.shape
    return (pred.data_ptr(), target.data_ptr(), h, w, _taps(dev).data_ptr(),
            c1, c2)


def _launch_tail(dev):
    return dev.index or 0, torch.cuda.current_stream(dev).cuda_stream


def _partials(pred):
    _, h, w = pred.shape
    n = 3 * (-(-w // BLOCK_COLS)) * (-(-h // BLOCK_ROWS))
    return torch.empty((n,), dtype=torch.float32, device=pred.device)


def _ssim_sum_cuda(pred, target, c1, c2):
    args = _cuda_args(pred, target, c1, c2)
    out = torch.empty((), dtype=torch.float32, device=pred.device)
    SSIM_SUM.launch(*args, _partials(pred).data_ptr(), out.data_ptr(),
                    *_launch_tail(pred.device))
    return out


def _ssim_grad_cuda(pred, target, g, c1, c2, grad_target):
    args = _cuda_args(pred, target, c1, c2)
    g = g.to(dtype=torch.float32).contiguous()
    dx = torch.empty_like(pred)
    dy = torch.empty_like(target) if grad_target else None
    SSIM_GRAD.launch(*args, g.data_ptr(), dx.data_ptr(),
                     dy.data_ptr() if grad_target else None,
                     *_launch_tail(pred.device))
    return dx, dy


def _ssim_value_grad_cuda(pred, target, c1, c2, grad_target):
    args = _cuda_args(pred, target, c1, c2)
    out = torch.empty((), dtype=torch.float32, device=pred.device)
    dx = torch.empty_like(pred)
    dy = torch.empty_like(target) if grad_target else None
    SSIM_VALUE_GRAD.launch(*args, dx.data_ptr(),
                           dy.data_ptr() if grad_target else None,
                           _partials(pred).data_ptr(), out.data_ptr(),
                           *_launch_tail(pred.device))
    return out, dx, dy


def _target_grad(ctx, dy, target):
    """The target's gradient: ``dy``; without grad_target zeros, and only
    where autograd asks for one. ``target`` is (shape, dtype, device)."""
    if dy is not None or not ctx.needs_input_grad[1]:
        return dy
    shape, dtype, device = target
    return torch.zeros(shape, dtype=dtype, device=device)


def _meta(t):
    return t.shape, t.dtype, t.device


class _FusedSsimSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, c1, c2, grad_target):
        ctx.consts = (c1, c2, grad_target)
        ctx.save_for_backward(pred, target)
        if pred.is_cuda:
            return _ssim_sum_cuda(pred, target, c1, c2)
        _check(pred, target)
        return ssim_sum_reference(pred, target, c1, c2)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        c1, c2, grad_target = ctx.consts
        fn = _ssim_grad_cuda if pred.is_cuda else ssim_grad_reference
        dx, dy = fn(pred, target, g, c1, c2, grad_target)
        return dx, _target_grad(ctx, dy, _meta(target)), None, None, None


class _FusedSsimSumVG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, c1, c2, grad_target):
        if pred.is_cuda:
            value, dx, dy = _ssim_value_grad_cuda(pred, target, c1, c2,
                                                  grad_target)
        else:
            _check(pred, target)
            value, dx, dy = ssim_value_grad_reference(pred, target, c1, c2,
                                                      grad_target)
        ctx.save_for_backward(dx, dy)
        ctx.target = _meta(target)
        return value

    @staticmethod
    def backward(ctx, g):
        dx, dy = ctx.saved_tensors
        dy = None if dy is None else g * dy
        return g * dx, _target_grad(ctx, dy, ctx.target), None, None, None


def fused_ssim_sum(pred: torch.Tensor, target: torch.Tensor,
                   c1: float = L.C1, c2: float = L.C2,
                   grad_target: bool = True) -> torch.Tensor:
    """Sum of per-window SSIM over the 3 channels and the VALID 11x11
    windows of (3, H, W) images; divide by 3*(H-10)*(W-10) for the mean."""
    return _FusedSsimSum.apply(pred, target, c1, c2, grad_target)


def fused_ssim_sum_vg(pred: torch.Tensor, target: torch.Tensor,
                      c1: float = L.C1, c2: float = L.C2,
                      grad_target: bool = True) -> torch.Tensor:
    """Like ``fused_ssim_sum``, but the forward already computes and stores
    the pixel gradient: for paths that always differentiate."""
    return _FusedSsimSumVG.apply(pred, target, c1, c2, grad_target)


def fused_ssim(pred_chw: torch.Tensor, target_chw: torch.Tensor,
               c1: float = L.C1, c2: float = L.C2,
               grad_target: bool = True,
               precompute_grad: bool = False) -> torch.Tensor:
    """Mean SSIM over channel-major (3, H, W) images; numerically
    ``train.loss.ssim_chw``. Pass ``grad_target=False`` when the target is
    a constant; ``precompute_grad=True`` takes the one-pass value and
    gradient (B4c) instead of the forward and backward passes (B4a,
    B4b)."""
    _, h, w = pred_chw.shape
    count = 3.0 * (h - HALO) * (w - HALO)
    op = fused_ssim_sum_vg if precompute_grad else fused_ssim_sum
    return op(pred_chw, target_chw, c1, c2, grad_target) / count
