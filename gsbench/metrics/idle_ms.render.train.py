"""Idle ms of the card per training step while the host is inside the
port's ``render`` span (projection, binning and B1): each idle moment of
the traced window goes to the innermost span open on the host then, on
the trace's clock (``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    idle = spans.idle_ms(r.trace, "step", spans.TRAIN_STAGES)
    return None if idle is None else idle["render"]
