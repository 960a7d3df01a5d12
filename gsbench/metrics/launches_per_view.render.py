"""CUDA kernel launches per view in the trace, library kernels
included."""


def read(r):
    n = r.trace.launches()
    return n / r.units if n and r.units else None
