"""Host ms of the step's render layer, synchronised before and after it, as
the benchmark calls the layers (mean of the traced run's stage steps)."""


def read(r):
    return r.stage_ms.get("render")
