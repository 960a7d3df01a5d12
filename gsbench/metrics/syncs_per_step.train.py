"""Blocking runtime calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy``) per
training step that start inside the port's ``step`` spans, in the traced
window (``gsbench/spans.py``)."""

from gsbench import spans


def read(r):
    counted = spans.syncs(r.trace, "step")
    return None if counted is None else counted["step"]
