"""Metrics + tracing.

Counterpart of game_engine_tpu/utils/metrics.py: on-device metric
reductions over the rooms axis, a host-side throughput meter that waits
for the card before it reads the clock, and a ``torch.profiler`` trace
context for timeline profiling.
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


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Throughput:
    """Host-side steps/sec + episodes/sec meter. Where there is a card it
    waits for the card's queued work before it reads the clock, so a report
    counts the work, not its enqueueing."""

    def __init__(self):
        _sync()
        self.t0 = time.perf_counter()
        self.steps = 0
        self.episodes = 0

    def add(self, steps: int, episodes: int = 0) -> None:
        self.steps += steps
        self.episodes += episodes

    def report(self) -> dict[str, float]:
        _sync()
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "steps_per_sec": self.steps / dt,
            "episodes_per_sec": self.episodes / dt,
            "wall_s": dt,
        }


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
