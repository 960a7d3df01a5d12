"""Idle ms of the card per view while the host is inside the port's
``rasterize`` span (B1 and the checks before it): each idle moment of
the traced window goes to the innermost span open on the host then, on
the trace's clock (``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    idle = spans.idle_ms(r.trace, "view", spans.VIEW_STAGES)
    return None if idle is None else idle["rasterize"]
