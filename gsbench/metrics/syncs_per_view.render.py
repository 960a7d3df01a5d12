"""Blocking runtime calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy``) per
view that start inside the port's ``view`` spans, in the traced window;
the benchmark's own sync after each view lies outside them
(``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    counted = spans.syncs(r.trace, "view")
    return None if counted is None else counted["view"]
