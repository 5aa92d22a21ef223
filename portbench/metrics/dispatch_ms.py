"""dispatch_ms: the host's own time in the program's hand-written entry
wrappers, a traced step (train) or call (rollouts), in ms: the union of
the "ge.entry.*" spans (utils/metrics span) from the card's first traced
operation on (spans.start), less the time inside CUDA runtime and driver
calls (cudaLaunchKernel, copies, syncs), where a full launch queue or a
copy holds the host on the card's work. What is left is each entry's
checks, layout conversions, and launches' own host code. Nothing where
the program opens no spans."""

from portbench import spans


def read(cell, run):
    if run.trace is None or not spans.per_unit(run) or not spans.program_has_spans():
        return None
    t = run.trace
    return 1e3 * spans.own_host_s(spans.entries(t), spans.runtime_calls(t)) / spans.per_unit(run)
