"""Kernel J1's share (%) of its roofline: the least time the card could
take to project every slot of one view (the operations of
``counts.projection_ops`` at the view's SH degree; ``BYTES_PER_SLOT``
moved, against the published H100 peaks) over the kernel's mean device ms
per launch in the trace."""

from gsbench import counts

# a slot's inputs at SH 3 (means 12, scales 12, rotation 16, opacity 4,
# 48 SH coefficients 192, active 1) and its outputs (pixel position 8,
# depth 4, conic 12, radius 4, colour 12, opacity 4, valid 1)
BYTES_PER_SLOT = 237 + 45


def read(r):
    ms = r.kernel_ms("project_fwd_kernel")
    if not ms:
        return None
    c = r.counts
    return 100.0 * counts.bound_ms(
        BYTES_PER_SLOT * c["slots"],
        counts.projection_ops(c["slots"], c["sh_degree"])) / ms
