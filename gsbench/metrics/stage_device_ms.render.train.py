"""Mean device ms of the port's ``render`` span in the traced training
steps (projection, binning and B1): the time between the CUDA events it
records at enter and exit, with no sync of its own
(``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    return spans.device_ms(r.trace, "render")
