"""Kernel J2's share (%) of its roofline: the least time the card could
take for the projection's backward over every slot of one step (the
forward's operations of ``counts.projection_ops`` at the step's SH degree,
``PROJECTION_BACKWARD_FACTOR`` times; ``BYTES_PER_SLOT`` moved, against
the published H100 peaks) over the kernel's mean device ms per launch in
the trace."""

from gsbench import counts

# a slot's forward inputs again (237), the cotangents of its outputs (40)
# and the gradients of its parameters (236), at SH 3
BYTES_PER_SLOT = 513


def read(r):
    ms = r.kernel_ms("project_bwd_kernel")
    if not ms:
        return None
    c = r.counts
    ops = counts.projection_ops(c["slots"], c["sh_degree"]) * (
        counts.PROJECTION_BACKWARD_FACTOR)
    return 100.0 * counts.bound_ms(BYTES_PER_SLOT * c["slots"], ops) / ms
