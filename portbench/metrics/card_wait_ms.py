"""card_wait_ms: the card's idle time while the host was inside the
program's own code, a traced step (train) or call (rollouts), in ms: the
traced part's idle gaps (Trace.gaps, no operation on the card) from the
card's first operation on (spans.start: before it the profiler starts)
intersected with the union of the program's "ge.*" spans (utils/metrics
span: torch.profiler ranges on the kernels' clock). idle_share counts
every idle gap; this counts those the program's host code left. Nothing
where the program opens no spans."""

from portbench import spans


def read(cell, run):
    if run.trace is None or not spans.per_unit(run) or not spans.program_has_spans():
        return None
    t = run.trace
    inside = spans.inside_s(spans.gaps(t), [(a, b) for _, a, b in spans.ranges(t)])
    return 1e3 * inside / spans.per_unit(run)
