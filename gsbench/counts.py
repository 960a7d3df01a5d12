"""The yardstick: the card's published peaks, and the float32 operations and
bytes the work of a training step or a view needs, counted from the
reference's own binning of the step's or the view's inputs. Whatever
implements a kernel, these count the same work.

Peaks: one H100 SXM (NVIDIA's data sheet), at its 700 W limit: HBM3 at
3.35 TB/s and 67 TFLOP/s of float32 outside the tensor cores (the same
figures as the port's ``utils/profiling.py`` held when this was frozen).

The work of compositing depends on the data: a pixel stops at the pair
that would push its transmittance under the threshold. So B1 and B2 count
the (pair, pixel) evaluations up to each pixel's exit (``evaluations``)
and the records of the pairs up to each tile's last exit (``pairs_read``),
as the reference's compositing finds them. The operation counts per
evaluation, per pixel and per element are the port's (PERF.md section 6).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

F32 = 4
# record values a compositing pass reads per pair: mean (2), conic (3),
# opacity (1), payload (5)
RECORD_VALUES = 11
# the values of one pair's gradient that carry something back: mean (2),
# conic (3), opacity (1), colour (3), depth (1)
GRAD_VALUES = 10
OUT_CHANNELS = 5          # r, g, b, depth, alpha

# B1, per evaluation: dx, dy (2), the conic quadratic (9), the -0.5 scale
# (1), exp (1), opacity (1), clamp (2), 1 - a (1), T * (1 - a) (1), the
# threshold test (1), T * a (1), five multiply-adds into the sums (10)
B1_OPS_PER_EVALUATION = 30
# B2, per evaluation: the alpha terms (15), the threshold test (2), W and
# the colour cotangent (11), prefix, suffix and dalpha (6), the clamp mask
# (3), dalpha, dq (4), six geometry terms (19), four payload terms (4),
# ten adds into the pair's sums (10)
B2_OPS_PER_EVALUATION = 74
# B3, per pixel and channel: x^2, y^2, xy (3); five 11-tap blurs down and
# along (2 x 5 x 21); the SSIM terms (22); three window coefficients (15);
# three adjoint blurs (2 x 3 x 21); the gradient, L1 and MSE terms (14)
B3_OPS_PER_PIXEL = 3 + 2 * 5 * 21 + 22 + 15 + 2 * 3 * 21 + 14
# projection, per gaussian, before the colour: the view and clip
# transforms (2 x 4 x 7), the perspective divide and pixel map (8), the
# rotation from the quaternion (about 40) and Sigma = (R S)(R S)^T (45),
# J (8), M = J W (30), M Sigma M^T (6 x 5 + 3 x 5), the conic (8), the
# eigenvalue radius (9), the sigmoid (3)
PROJECTION_OPS = 2 * 4 * 7 + 8 + 40 + 45 + 8 + 30 + 45 + 8 + 9 + 3
# colour, per gaussian: the direction (9), then 2 operations per basis
# function and channel, + 0.5 and the clamp (6)
SH_BASIS = {0: 1, 1: 4, 2: 9, 3: 16}
# the projection's backward is counted as twice its forward
PROJECTION_BACKWARD_FACTOR = 2
# Adam, per parameter element: two moments (6), bias corrections (4), the
# square root, epsilon and division (3), the learning rate (1), the update
# and the active mask (2)
ADAM_OPS_PER_ELEMENT = 16


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time (ms) the card could take: the larger of the bytes
    over the HBM rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3


def projection_ops(gaussians: int, sh_degree: int) -> float:
    return gaussians * (PROJECTION_OPS + 9 + 2 * 3 * SH_BASIS[sh_degree]
                        + 6)


def b1(c: dict, tiles: int, ts: int = 16):
    """(bytes, ops) of the forward compositing of one view: the records
    of the pairs up to each tile's last exit, the tile ranges, the five
    output channels written."""
    nbytes = (F32 * RECORD_VALUES * c["pairs_read"] + 8 * tiles
              + F32 * OUT_CHANNELS * tiles * ts * ts)
    return nbytes, B1_OPS_PER_EVALUATION * c["evaluations"]


def b2(c: dict, tiles: int, ts: int = 16):
    """(bytes, ops) of the compositing's backward: the records of the
    pairs up to each tile's last exit, the tile ranges, the output and its
    cotangent of the tiles that have pairs, one gradient per pair."""
    nbytes = (F32 * RECORD_VALUES * c["pairs_read"] + 8 * tiles
              + 2 * F32 * OUT_CHANNELS * c["nonempty_tiles"] * ts * ts
              + F32 * GRAD_VALUES * c["pairs"])
    return nbytes, B2_OPS_PER_EVALUATION * c["evaluations"]


def b3(width: int, height: int):
    """(bytes, ops) of the fused loss: the rendered colour and the target
    read, the colour gradient written."""
    px = 3 * width * height
    return 3 * F32 * px, B3_OPS_PER_PIXEL * px


def b5_untile(width: int, height: int):
    """(bytes, ops) of the tile -> image relayout of the colour."""
    return 2 * F32 * 3 * width * height, 0


def adam_ops(slots: int, sh_coeffs: int) -> float:
    """Every slot's mean (3), scale (3), rotation (4), opacity (1) and
    ``sh_coeffs`` colour coefficients (3 each)."""
    return ADAM_OPS_PER_ELEMENT * slots * (11 + 3 * sh_coeffs)


def train_step_ops(c: dict, width: int, height: int, slots: int,
                   sh_degree: int, sh_coeffs: int) -> float:
    """Float32 operations of one training step: projection forward and
    backward over every slot at the active SH degree, B1, B2, B3 and
    Adam."""
    proj = projection_ops(slots, sh_degree) * (
        1 + PROJECTION_BACKWARD_FACTOR)
    return (proj + b1(c, 0)[1] + b2(c, 0)[1] + b3(width, height)[1]
            + adam_ops(slots, sh_coeffs))


def view_ops(c: dict, slots: int, sh_degree: int) -> float:
    """Float32 operations of one view: projection and B1."""
    return projection_ops(slots, sh_degree) + b1(c, 0)[1]
