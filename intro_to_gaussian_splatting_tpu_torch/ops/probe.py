"""The probe kernels P1 and P2 (csrc/probe.cu) and their plain versions.

The counterparts of the two Pallas probes of the JAX package's
``scripts/probe_kernel.py``, which measure what a grid of 65,856 programs
costs on the device:

  * ``probe_zero`` (P1): every program writes one (8, 256) block of zeros,
    the floor of the per-program cost;
  * ``probe_window`` (P2): every program reads windows of 32 rows of a
    (MP, 128) record table and does the rasterizer's alpha, scan and
    payload arithmetic on 256 pixel lanes (see ``probe_window_reference``).

On the card they launch the kernels; for tensors on the CPU they run the
plain versions. The probe script's own inputs are ``probe_inputs``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
from intro_to_gaussian_splatting_tpu_torch.ops.cuda_build import (
    CudaKernel,
    KernelSource,
)

NT = 65856        # programs of the probe script's grid
PIX = 256         # pixel lanes of one program
OUT_ROWS = 8      # rows of one program's output block
G = 32            # window rows of one chunk
REC_COLS = 128    # columns of the record table
MP = 1 << 18      # rows of the probe script's record table

# Operations P2 does per (window row, pixel lane) element: dx, dy (2); the
# conic quadratic (9); -0.5 q, exp, the opacity product and the clip's two
# compares (5); -a, log1p, the max and the scan's add (4); s - s and its
# exp (2); w = T a (1); the three payload products and their three adds (6).
P2_OPS_PER_ELEMENT = 2 + 9 + 5 + 4 + 2 + 1 + 6

SOURCE = KernelSource("probe", ("-fmad=false",))
PROBE_ZERO = CudaKernel(SOURCE, "probe_zero", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
])
PROBE_WINDOW = CudaKernel(SOURCE, "probe_window", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
])


def probe_inputs(nt: int = NT, mp: int = MP, device=None):
    """The probe script's inputs: ``counts`` = 2 per program, ``starts`` =
    cumsum(counts) - 2, an all-ones (mp, 128) table."""
    device = resolve_device(device)
    counts = torch.full((nt,), 2, dtype=torch.int32, device=device)
    starts = (torch.cumsum(counts, 0) - 2).to(torch.int32)
    rec = torch.ones((mp, REC_COLS), dtype=torch.float32, device=device)
    return starts, counts, rec


def probe_random_inputs(nt: int = NT, mp: int = MP, seed: int = 0,
                        device=None):
    """Seeded inputs, made with numpy, that hold P2 to what the script's
    own cannot show (all-ones rows hide a wrong column): a random table
    whose rows light up some lanes (centres across the 256 lanes, a
    positive-definite conic, opacities in [0.05, 1)), counts of 0 to 40
    with every 7th 0, so that windows take zero, one or two chunks, and
    random starts inside the table."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 41, size=nt).astype(np.int32)
    counts[::7] = 0
    starts = rng.integers(0, mp - 2 * G, size=nt).astype(np.int32)
    rec = rng.uniform(0.0, 1.0, size=(mp, REC_COLS)).astype(np.float32)
    rec[:, 0:2] *= PIX
    rec[:, 2] = 0.002 + 0.05 * rec[:, 2]
    rec[:, 3] = 0.001 * (rec[:, 3] - 0.5)
    rec[:, 4] = 0.002 + 0.05 * rec[:, 4]
    rec[:, 5] = 0.05 + 0.95 * rec[:, 5]
    return tuple(torch.from_numpy(x).to(device)
                 for x in (starts, counts, rec))


def window_chunks(starts: torch.Tensor, counts: torch.Tensor):
    """(astart, nchunks) per program, as the TPU kernel computes them."""
    starts, counts = starts.long(), counts.long()
    astart = torch.div(starts, 8, rounding_mode="floor") * 8
    end = starts - astart + counts
    nchunks = torch.where(counts == 0, 0, (end + G - 1) // G)
    return astart, nchunks


def probe_zero_reference(nt: int, device) -> torch.Tensor:
    """P1's plain version: (nt, 8, 256) float32 zeros."""
    return torch.zeros((nt, OUT_ROWS, PIX), dtype=torch.float32,
                       device=device)


def probe_window_reference(starts: torch.Tensor, counts: torch.Tensor,
                           rec: torch.Tensor,
                           batch: int = 4096) -> torch.Tensor:
    """P2's plain version, vectorised over ``batch`` programs at a time.

    Per program t and chunk i < nchunks[t], the 32 table rows from
    astart[t] + 32 i (rows past the table read as 0) give, for pixel lane
    px = 0..255: dx = px - r0, dy = px - r1, q = r2 dx dx + 2 r3 dx dy +
    r4 dy dy, a = clip(r5 exp(-0.5 q), 0, 0.99), s the inclusive sum over
    the rows of max(log1p(-a), -30), w = exp(s - s) a, and the chunk adds
    sum w r6 + sum w r7 + sum w r8. Every row of a window counts, masked
    by nothing. Returns (nt, 8, 256), each program's sum on its 8 rows."""
    nt, mp = starts.shape[0], rec.shape[0]
    device = rec.device
    out = torch.empty((nt, OUT_ROWS, PIX), dtype=torch.float32,
                      device=device)
    if nt == 0:
        return out
    astart, nchunks = window_chunks(starts, counts)
    most = int(nchunks.max())
    px = torch.arange(PIX, dtype=torch.float32, device=device)
    rows = torch.arange(G, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    for lo in range(0, nt, batch):
        hi = min(lo + batch, nt)
        acc = torch.zeros((hi - lo, PIX), dtype=torch.float32, device=device)
        for i in range(most):
            r = astart[lo:hi, None] + i * G + rows              # (b, G)
            win = torch.where((r < mp)[..., None],
                              rec[r.clamp(max=mp - 1)], zero)    # (b, G, 128)
            col = [win[..., k:k + 1] for k in range(9)]          # (b, G, 1)
            dx = px - col[0]
            dy = px - col[1]
            q = col[2] * dx * dx + 2.0 * col[3] * dx * dy + col[4] * dy * dy
            a = torch.clamp(col[5] * torch.exp(-0.5 * q), 0.0, 0.99)
            s = torch.cumsum(torch.clamp(torch.log1p(-a), min=-30.0), dim=1)
            w = torch.exp(s - s) * a
            chunk = ((w * col[6]).sum(1) + (w * col[7]).sum(1)
                     + (w * col[8]).sum(1))
            acc = acc + torch.where((i < nchunks[lo:hi])[:, None], chunk,
                                    zero)
        out[lo:hi] = acc[:, None, :]
    return out


def probe_zero(nt: int = NT, device=None) -> torch.Tensor:
    """P1: (nt, 8, 256) float32 zeros, written by the kernel on the card
    (the plain version on the CPU)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return probe_zero_reference(nt, device)
    return _probe_zero_cuda(torch.empty((nt, OUT_ROWS, PIX),
                                        dtype=torch.float32, device=device))


def _probe_zero_cuda(out: torch.Tensor) -> torch.Tensor:
    """Kernel P1 into ``out``, a contiguous (nt, 8, 256) float32 tensor on
    the card."""
    if (out.dtype != torch.float32 or out.dim() != 3
            or tuple(out.shape[1:]) != (OUT_ROWS, PIX)
            or not out.is_contiguous()):
        raise ValueError("P1 writes a contiguous (nt, 8, 256) float32 tensor")
    PROBE_ZERO.launch(out.data_ptr(), out.shape[0], out.device.index or 0,
                      torch.cuda.current_stream(out.device).cuda_stream)
    return out


def probe_window(starts: torch.Tensor, counts: torch.Tensor,
                 rec: torch.Tensor) -> torch.Tensor:
    """P2 (see ``probe_window_reference``) through the kernel for tensors
    on the card, the plain version for tensors on the CPU. ``starts`` and
    ``counts`` are (NT,) int32 and >= 0, ``rec`` a contiguous (MP, 128)
    float32 table (16-byte aligned on the card)."""
    if not rec.is_cuda:
        return probe_window_reference(starts, counts, rec)
    nt = starts.shape[0]
    if (starts.dtype != torch.int32 or counts.dtype != torch.int32
            or counts.shape != (nt,) or starts.dim() != 1):
        raise ValueError("probe_window takes (NT,) int32 starts and counts")
    if (rec.dtype != torch.float32 or rec.dim() != 2
            or rec.shape[1] != REC_COLS or not rec.is_contiguous()):
        raise ValueError("probe_window takes a contiguous (MP, 128) float32 "
                         "table")
    if rec.data_ptr() % 16:
        raise ValueError("probe_window reads the table's rows as float4s: "
                         "it takes a 16-byte aligned table")
    if not (starts.device == counts.device == rec.device):
        raise ValueError("probe_window's inputs must be on one card")
    starts, counts = starts.contiguous(), counts.contiguous()
    out = torch.empty((nt, OUT_ROWS, PIX), dtype=torch.float32,
                      device=rec.device)
    PROBE_WINDOW.launch(starts.data_ptr(), counts.data_ptr(), rec.data_ptr(),
                        nt, rec.shape[0], out.data_ptr(),
                        rec.device.index or 0,
                        torch.cuda.current_stream(rec.device).cuda_stream)
    return out
