"""Batched rollout engine: scripted policy, rollouts with auto-reset.

Counterpart of game_engine_tpu/core/engine.py. ``make_rollout`` is the
plain-torch rollout: a Python loop of scripted actions -> step -> episode
count -> auto-reset. ``rollout`` runs it for CPU tensors and launches the
CUDA rollout kernel (core/rollout_kernel.py) for CUDA tensors; the two are
bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from game_engine_tpu.gamespec.mechanics import ChoiceKind
from game_engine_tpu.gamespec.tables import Lowered
from game_engine_tpu_torch.core.state import M32, GameState, init_state, tables
from game_engine_tpu_torch.core.step import (
    GOLDEN,
    MIX,
    _alive,
    make_step,
    mul32,
    splitmix32,
)

_I32 = torch.int32


def scripted_actions(lowered: Lowered, state: GameState) -> torch.Tensor:
    """(B, P) int32 choices — vectorized twin of policies.scripted.oracle_policy.

    Uses (state.seed, state.t, player_id) as the decision-stream key; the
    engine's acceptance logic filters non-targeted/illegal emissions exactly
    like the oracle ignores them."""
    B, P = state.present.shape
    dev = state.present.device
    tabs = tables(lowered, dev)
    pid = torch.arange(1, P + 1, dtype=torch.int64, device=dev)[None, :]
    h0 = splitmix32((mul32(state.seed, MIX) + state.t.to(torch.int64)) & M32)
    h = splitmix32(h0[:, None] ^ mul32(pid, GOLDEN))  # (B, P)

    phl = state.phase.long()
    kind = tabs["choice_kind"][phl][:, None]  # (B, 1)
    kmax = tabs["choice_max"][phl][:, None]
    n_present = state.present.sum(1, dtype=_I32)[:, None]

    # TARGET: the k-th alive player with k = h % n_alive
    alive = _alive(lowered, state)
    n_alive = alive.sum(1)[:, None]  # int64
    k = torch.where(n_alive > 0, h % n_alive.clamp(min=1), 0)  # (B, P)
    cum = alive.to(torch.int64).cumsum(1)  # (B, q)
    # hit[b, chooser, candidate]; argmax takes the first hit
    hit = alive[:, None, :] & (cum[:, None, :] == (k + 1)[:, :, None])
    tgt = hit.to(_I32).argmax(2).to(_I32) + 1
    target_choice = torch.where(n_alive > 0, tgt, 0)

    hi = torch.where(kmax > 0, kmax, n_present).to(torch.int64)
    option_choice = (1 + h % hi.clamp(min=1)).to(_I32)

    choice = torch.where(
        kind == ChoiceKind.TARGET.value,
        target_choice,
        torch.where(
            kind == ChoiceKind.OPTION.value,
            option_choice,
            torch.where(kind == ChoiceKind.SUBMIT.value, 1, 0).to(_I32),
        ),
    )
    return torch.where(state.present, choice, 0)


def init_state_like(lowered: Lowered, state: GameState) -> GameState:
    """Fresh rooms preserving room size, with seed bumped (for auto-reset)."""
    B = state.present.shape[0]
    n = state.present.sum(1, dtype=_I32)
    new_seed = splitmix32(state.seed ^ 0xDECAF000)
    return init_state(lowered, B, n, new_seed, device=state.present.device)


def make_rollout(lowered: Lowered, num_steps: int, auto_reset: bool = True):
    """Build rollout(state) -> (state, episodes): num_steps steps in plain
    torch — the plain version of the CUDA rollout kernel.

    auto_reset: finished rooms restart with a bumped seed, so throughput
    benchmarks measure sustained env-steps/sec. episodes counts fresh
    completions only (`new.done & ~st.done`), as an int64 scalar tensor."""
    step = make_step(lowered)

    def rollout(state: GameState):
        episodes = torch.zeros((), dtype=torch.int64, device=state.present.device)
        for _ in range(num_steps):
            new = step(state, scripted_actions(lowered, state))
            episodes = episodes + (new.done & ~state.done).sum()
            state = new
            if auto_reset:
                fresh = init_state_like(lowered, state)
                d = state.done
                state = GameState(*(
                    torch.where(d.reshape((-1,) + (1,) * (old.dim() - 1)), f, old)
                    for f, old in zip(fresh, state)))
        return state, episodes

    return rollout


def rollout(lowered: Lowered, state: GameState, num_steps: int,
            auto_reset: bool = True):
    """num_steps engine steps with scripted bots -> (state, episodes).

    CUDA tensors go through the CUDA rollout kernel (one thread per room,
    all steps in one launch); CPU tensors through the plain-torch loop."""
    if state.present.is_cuda:
        from game_engine_tpu_torch.core.rollout_kernel import kernel_rollout

        return kernel_rollout(lowered, state, num_steps, auto_reset)
    if state.present.device.type != "cpu":
        raise ValueError(f"unsupported device {state.present.device}")
    return make_rollout(lowered, num_steps, auto_reset)(state)


class BatchedEngine:
    """Convenience wrapper bound to one game and one device."""

    def __init__(self, lowered: Lowered, device="cpu"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchedEngine(device='cuda'): no CUDA device available")
        self.lowered = lowered
        self.device = device
        self.step_fn = make_step(lowered)

    def init(self, batch: int, n_players, seeds) -> GameState:
        return init_state(self.lowered, batch, n_players, seeds, device=self.device)

    def step(self, state: GameState, actions) -> GameState:
        return self.step_fn(state, torch.as_tensor(actions, device=self.device))

    def bot_actions(self, state: GameState) -> torch.Tensor:
        return scripted_actions(self.lowered, state)

    def rollout(self, state: GameState, num_steps: int, auto_reset: bool = True):
        return rollout(self.lowered, state, num_steps, auto_reset)

    def phase_dsl_ids(self, state: GameState) -> np.ndarray:
        ids = tables(self.lowered, state.phase.device)["phase_dsl_id"]
        return ids[state.phase.long()].cpu().numpy()
