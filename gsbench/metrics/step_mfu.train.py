"""The training step's float32 operations (gsbench/counts.py: projection
forward and backward at the active SH degree, B1, B2, B3, Adam, on the
reference's count of the traced steps' work) over the mean host ms of as
many steps run untraced just before the traced ones, as a share (%) of
the card's float32 peak."""

from gsbench import counts


def read(r):
    if r.units == 0 or r.untraced_s <= 0:
        return None
    c = r.counts
    ops = counts.train_step_ops(c, c["width"], c["height"], c["slots"],
                                c["sh_degree"], c["sh_coeffs"])
    return 100.0 * ops / (r.untraced_s / r.units) / counts.FP32_FLOP_PER_S
