"""The program's own spans in a traced part: the ranges that the port's
utils/metrics.span opens while torch.profiler records (named "ge.*", kept
in Trace.host_ops as user_annotation host operations, on the clock of the
card's kernels), what the card_wait_ms and dispatch_ms readers take from
them, and a split of a cell's traced run by span:

    python3 -m portbench.spans --workload <name> --seed <n>

runs the cell as `portbench.run --trace 1` does, for the benchmark's
run_seconds, and after run's own output prints one more JSON line: the
card's idle time and each span name's host time a step or call, the share
of idle time inside a span, and the largest idle gaps with the spans and
host operations around them.

The span readers start where the card's first traced operation starts:
before it the profiler is starting, which holds the first call's host and
leaves the card idle, and that is not the program's.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

PREFIX = "ge."
ENTRY = "ge.entry."
RUNTIME = re.compile(r"cu(da)?[A-Z]")  # CUDA runtime and driver calls
TOP_GAPS = 10


def program_has_spans() -> bool:
    """Whether the program opens spans (a program without them leaves its
    span metrics unread, not zero)."""
    from game_engine_tpu_torch.utils import metrics

    return hasattr(metrics, "span")


def per_unit(run) -> int:
    """The traced steps (train) or calls (rollouts), or 0."""
    return int(run.traced.get("steps") or run.traced.get("calls") or 0)


def start(trace) -> float:
    """The start of the card's first operation in the traced part (its
    start if none)."""
    firsts = [a for _, a, b in trace.device_ops if b > trace.lo and a < trace.hi]
    return max(trace.lo, min(firsts)) if firsts else trace.lo


def ranges(trace, named=lambda name: name.startswith(PREFIX)) -> list:
    """(name, start, end) of the host operations whose name satisfies
    `named` (the program's spans), clipped to [start(trace), trace.hi]."""
    lo, out = start(trace), []
    for name, a, b in trace.host_ops:
        a, b = max(a, lo), min(b, trace.hi)
        if named(name) and b > a:
            out.append((name, a, b))
    return out


def entries(trace) -> list:
    return ranges(trace, lambda name: name.startswith(ENTRY))


def runtime_calls(trace) -> list:
    return ranges(trace, RUNTIME.match)


def gaps(trace) -> list:
    """Trace.gaps after start(trace)."""
    lo = start(trace)
    return [(max(a, lo), b) for a, b in trace.gaps() if b > lo]


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint [start, end], in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def inside_s(gaps, intervals) -> float:
    """Seconds of the disjoint, ordered `gaps` that the union of
    `intervals` covers."""
    cover, total, j = merged(intervals), 0.0, 0
    for a, b in gaps:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total


def own_host_s(spans, calls) -> float:
    """Seconds inside the union of `spans` and outside the union of the
    CUDA runtime `calls`, where a full launch queue or a copy holds the
    host on the card."""
    cover = merged((a, b) for _, a, b in spans)
    return sum(b - a for a, b in cover) - inside_s(cover, [(a, b) for _, a, b in calls])


def _innermost(spans, t: float):
    best = None
    for s in spans:
        if s[1] <= t <= s[2] and (best is None or s[2] - s[1] < best[2] - best[1]):
            best = s
    return best


def split(cell, run) -> dict:
    """The traced part by span: the card_wait_ms and dispatch_ms readers'
    values; each span name's host time, self time (less its child spans),
    time in CUDA runtime calls, and the card's idle time while it was the
    innermost span, in ms a unit; the share of idle time inside any span;
    and the TOP_GAPS largest idle gaps, each with the innermost span and
    every host operation running at its middle, outermost first."""
    from portbench import spec

    trace, units = run.trace, per_unit(run)
    spans, calls, idle = ranges(trace), runtime_calls(trace), gaps(trace)
    by = {}
    for name, a, b in spans:
        rec = by.setdefault(name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0,
                                   "runtime_ms": 0.0, "card_wait_ms": 0.0})
        rec["count"] += 1
        rec["host_ms"] += (b - a) * 1e3
        kids = [(c, d) for n, c, d in spans if a <= c and d <= b and (c, d) != (a, b)]
        rec["self_ms"] += ((b - a) - inside_s([(a, b)], kids)) * 1e3
        rec["runtime_ms"] += inside_s([(a, b)], [(c, d) for _, c, d in calls]) * 1e3
    cuts = sorted({x for _, a, b in spans for x in (a, b)})
    for a, b in idle:
        edges = [a] + [c for c in cuts if a < c < b] + [b]
        for c, d in zip(edges, edges[1:]):
            s = _innermost(spans, (c + d) / 2)
            if s is not None:
                by[s[0]]["card_wait_ms"] += (d - c) * 1e3
    for rec in by.values():
        for k in ("host_ms", "self_ms", "runtime_ms", "card_wait_ms"):
            rec[k] /= units
    idle_s = sum(b - a for a, b in idle)
    top = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:TOP_GAPS]:
        t = (a + b) / 2
        s = _innermost(spans, t)
        around = sorted((op for op in trace.host_ops if op[1] <= t <= op[2]),
                        key=lambda op: op[1] - op[2])
        top.append({"ms": (b - a) * 1e3, "at_ms": (a - trace.lo) * 1e3,
                    "span": s[0] if s else None, "host_ops": [op[0][:80] for op in around]})
    read = {m: spec.load_module("metrics", m).read(cell, run)
            for m in ("card_wait_ms", "dispatch_ms")}
    return {"units": units, "start_ms": (start(trace) - trace.lo) * 1e3,
            "idle_ms": idle_s * 1e3 / units, **read,
            "idle_inside_spans": inside_s(idle, [(a, b) for _, a, b in spans]) / idle_s
            if idle_s else None,
            "spans": by, "top_gaps": top}


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(prog="portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    from portbench import harness, spec
    from portbench import run as bench_run

    kept, line = [], harness.result_line

    def keep(cell, run, trace, card):
        kept.append((cell, run))
        return line(cell, run, trace, card)

    harness.result_line = keep
    try:
        rc = bench_run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                             str(spec.benchmark()["run_seconds"]), "--trace", "1"])
    finally:
        harness.result_line = line
    if rc == 0:
        print(json.dumps(split(*kept[0])), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
