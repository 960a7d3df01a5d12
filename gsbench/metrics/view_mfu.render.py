"""A view's float32 operations (gsbench/counts.py: projection at the
active SH degree and B1, on the reference's count of the traced views'
work) over the mean host ms of as many views run untraced just before the
traced ones, as a share (%) of the card's float32 peak."""

from gsbench import counts


def read(r):
    if r.units == 0 or r.untraced_s <= 0:
        return None
    c = r.counts
    ops = counts.view_ops(c, c["slots"], c["sh_degree"])
    return 100.0 * ops / (r.untraced_s / r.units) / counts.FP32_FLOP_PER_S
