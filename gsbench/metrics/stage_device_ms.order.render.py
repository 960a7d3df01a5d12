"""Mean device ms of the port's ``order`` span in the traced views: the
per-gaussian half of binning (the depth sort, the tile spans and the slot
offsets over every gaussian, with the pair count's sync), between the CUDA
events it records at enter and exit (``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    return spans.device_ms(r.trace, "order")
