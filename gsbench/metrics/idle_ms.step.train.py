"""Idle ms of the card per training step while the host is inside the
port's ``step`` span but outside its ``render``, ``backward`` and
``optimizer`` spans: the loss, the densify statistics, the target lookup
and the loop (``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    idle = spans.idle_ms(r.trace, "step", spans.TRAIN_STAGES)
    return None if idle is None else idle["step"]
