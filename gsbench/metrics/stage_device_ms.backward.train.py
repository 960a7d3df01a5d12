"""Mean device ms of the port's ``backward`` span in the traced training
steps (``torch.autograd.grad``: B2, the gather's segment sums, the
projection's autograd): the time between the CUDA events it records at
enter and exit, with no sync of its own (``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    return spans.device_ms(r.trace, "backward")
