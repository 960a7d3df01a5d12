"""Mean device ms of the port's ``optimizer`` span in the traced training
steps (Adam, ``Optimizer.step``): the time between the CUDA events it
records at enter and exit, with no sync of its own
(``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    return spans.device_ms(r.trace, "optimizer")
