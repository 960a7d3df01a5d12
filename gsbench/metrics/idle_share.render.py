"""The share (%) of time in which no operation ran on the card while the
rendering path ran: 1 - (the union of the device intervals in the trace)
/ (the host seconds of as many views run untraced just before the
traced ones). The traced window itself is stretched by the
profiler's cost per launch, which it would read as idle time."""


def read(r):
    t = r.trace
    if r.untraced_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / r.untraced_s)
