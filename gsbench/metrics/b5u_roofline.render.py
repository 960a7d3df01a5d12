"""Kernel B5-untile's share (%) of its roofline: the least time the card could
take for the work of one view (gsbench/counts.py, on the reference's count,
against the published H100 peaks) over the kernel's mean device ms per
launch in the trace."""

from gsbench import counts


def read(r):
    ms = r.kernel_ms("::untile_chw_kernel")
    if not ms:
        return None
    c = r.counts
    return 100.0 * counts.bound_ms(
        *counts.b5_untile(c["width"], c["height"])) / ms
