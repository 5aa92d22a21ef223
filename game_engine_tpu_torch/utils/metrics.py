"""Metrics + tracing.

Counterpart of game_engine_tpu/utils/metrics.py: on-device metric
reductions over the rooms axis; the program's spans (``span``: ranges in
``torch.profiler``'s trace, free while no profiler records) and its
train-step clock (``Clock``: CUDA events); and a ``torch.profiler`` trace
context that writes the spans out with the card's timeline.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Optional

import numpy as np
import torch

from game_engine_tpu_torch.core.state import GameState
from game_engine_tpu_torch.core.step import _alive
from game_engine_tpu_torch.gamespec.tables import Lowered


def room_metrics(lowered: Lowered, state: GameState) -> dict[str, torch.Tensor]:
    """Scalar metrics over the batch, as tensors on the state's device."""
    alive = _alive(lowered, state)
    dev = state.present.device
    out: dict[str, torch.Tensor] = {
        "rooms": torch.tensor(state.present.shape[0], dtype=torch.int32, device=dev),
        "done_rooms": state.done.sum(dtype=torch.int32),
        "mean_step": state.t.float().mean(),
        "mean_alive": alive.sum(1).float().mean(),
    }
    # win counts by winner code (team index+1 or player id)
    done = state.done
    for w in (1, 2):
        out[f"wins_{w}"] = ((state.winner == w) & done).sum(dtype=torch.int32)
    # phase occupancy histogram
    out["phase_hist"] = torch.bincount(state.phase.long(), minlength=lowered.NP)[
        :lowered.NP].to(torch.int32)
    return out


_OFF = contextlib.nullcontext()  # span's one context while no profiler records


def span(name: str):
    """A range of the program's host code named `name` in torch.profiler's
    trace, on the clock of the card's kernels there. While no profiler
    records it returns one shared no-op context and makes no other call
    into torch. The program's spans are named "ge.<layer>"; PERF.md lists
    each with the metric that reads it."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


class Clock:
    """Milliseconds between marks: CUDA events on a GPU, the host clock on
    the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def spans_ms(self) -> list:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """torch.profiler trace of the host and, where there is one, the card,
    written as a Chrome trace under log_dir; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def phase_names(lowered: Lowered) -> list[str]:
    return [p.name for p in lowered.game.phases]


def summarize(lowered: Lowered, state: GameState) -> dict[str, Any]:
    """Host-side readable summary (reads the device metrics once)."""
    m = {k: v.cpu().numpy() for k, v in room_metrics(lowered, state).items()}
    hist = m.pop("phase_hist")
    top = np.argsort(-hist)[:3]
    names = phase_names(lowered)
    return {
        **{k: v.item() for k, v in m.items()},
        "top_phases": {names[i]: int(hist[i]) for i in top if hist[i] > 0},
    }
