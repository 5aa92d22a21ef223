"""What every cell's run shares: inputs from the seed, the record of a
window, the traced part of it, the result line and its checks."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "game_engine_tpu")
TRACED = "portbench.traced"  # the profiler range around a run's traced part
GAP_NAME_CHARS = 160


def now() -> float:
    return time.perf_counter()


def room_seeds(seed: int, rooms: int) -> np.ndarray:
    """(rooms,) uint32 room seeds drawn from --seed."""
    return np.random.default_rng([seed, 1]).integers(0, 2 ** 32, size=rooms, dtype=np.uint32)


def stream_seed(seed: int, what: int) -> int:
    """A 62-bit seed for the torch generator `what` of a run."""
    return int(np.random.default_rng([seed, 2, what]).integers(0, 2 ** 62))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def gpu_line() -> str:
    """`name, power.limit` of the first card as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({type(e).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "unread"


@dataclasses.dataclass
class Check:
    """A number that decides `correct`, beside its limit (at most)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class Trace:
    """The device operations of a traced part of a window, read from the
    profiler's trace: (name, start s, end s) each, the part's span, and the
    host's operations (name, start s, end s) for naming idle gaps."""

    device_ops: list
    lo: float
    hi: float
    host_ops: list

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        from portbench.yardstick import union_s

        return union_s([(a, b) for _, a, b in self.device_ops], self.lo, self.hi)

    def ops(self, pred) -> list:
        """Device operations inside the span whose name satisfies pred, in
        order of start."""
        return [op for op in self.device_ops if pred(op[0]) and op[1] >= self.lo and op[2] <= self.hi]

    def gaps(self) -> list:
        """(start, end) of each stretch of the span with no device operation."""
        out, at = [], self.lo
        for _, a, b in sorted(self.device_ops, key=lambda op: op[1]):
            if a > at:
                out.append((at, min(a, self.hi)))
            at = max(at, b)
            if at >= self.hi:
                break
        if at < self.hi:
            out.append((at, self.hi))
        return [g for g in out if g[1] > g[0]]

    def host_at(self, t: float) -> str:
        """The innermost host operation running at time t."""
        best = None
        for name, a, b in self.host_ops:
            if a <= t <= b and name != TRACED and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        return best[0] if best else "host code outside any traced operation"

    def breakdown(self) -> dict:
        by_name = {}
        for name, a, b in self.device_ops:
            a, b = max(a, self.lo), min(b, self.hi)
            if b > a:
                by_name[name] = by_name.get(name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:GAP_NAME_CHARS], s] for n, s in top],
                "idle_gaps": [[self.host_at((a + b) / 2)[:GAP_NAME_CHARS], b - a]
                              for a, b in gaps]}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def read_trace(path: str) -> Trace:
    """A Trace from a torch.profiler Chrome trace holding one TRACED range."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    dev, host, span = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0)) * 1e-6
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((e["name"], a, b))
        elif cat in HOST_CATS:
            host.append((e["name"], a, b))
            if e["name"] == TRACED and cat == "user_annotation":
                span = (a, b)
    if span is None:
        raise RuntimeError("the profiler's trace holds no traced range")
    return Trace(dev, span[0], span[1], host)


class Tracer:
    """torch.profiler over a short part of a window: enter and exit after
    a synchronise, so the span holds the part's device work whole."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = record_function(TRACED)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                self._prof.export_chrome_trace(path)
                self.trace = read_trace(path)
        return False


@dataclasses.dataclass
class Run:
    """What a driver hands back: the window's record, the traced part, and
    the checks of what the timed path produced."""

    setup_s: float
    window_s: float
    work: int                  # env steps whose results were synchronised in the window
    attempted: int             # calls (or train steps) in the window
    failed: int
    memory_peak_bytes: int
    checks: list
    check_s: float = 0.0       # the reference's seconds after the window
    calls_ms: list = dataclasses.field(default_factory=list)   # each call's wall ms
    trace: Trace | None = None
    traced: dict = dataclasses.field(default_factory=dict)      # the traced part's counts and spans


def result_line(cell, run: Run, trace: bool, card: str) -> dict:
    """The contract's last line: the cell's end-to-end metrics (trace off)
    or per-layer metrics (trace on) that its readers find, then the checks."""
    import torch

    from portbench import spec

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module("metrics", m["name"]).read(cell, run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes, "card": card}
    line = {"correct": all(c.ok for c in run.checks), "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return line
