"""call_ms_p95: the 95th percentile of every window call's wall time (host
clock), each call ended by its synchronise. Its sample count, the window's
calls, is the result line's `attempted`."""

from portbench.yardstick import percentile


def read(cell, run):
    return percentile(run.calls_ms, 95) if run.calls_ms else None
