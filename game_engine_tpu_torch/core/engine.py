"""Batched rollout engine: scripted policy, rollouts with auto-reset.

Counterpart of game_engine_tpu/core/engine.py. ``make_rollout`` is the
plain-torch rollout: a Python loop of scripted actions -> step -> episode
count -> auto-reset. ``rollout`` runs it for CPU tensors and launches the
CUDA rollout kernel (core/rollout_kernel.py) for CUDA tensors; the two are
bit-identical.

``engine_step``, ``reset_done`` and ``bot_actions`` choose the same way for
one step, the reset of done rooms and the scripted bots, which the JAX
package jits once (its ``jit_step`` and jitted bots): CUDA tensors go
through the engine step entry ST (core/step_kernel.py, one launch each),
CPU tensors through the plain ``make_step``, ``reset_where_done`` and
``scripted_actions``. ``step_and_reset`` is an unroll's step: the step,
what the caller reads of the stepped rooms (ended, winner, the terminal
rewards) and the restart of the rooms it ended, one ST launch on the card
where the plain path composes make_step, ``terminal_rewards_plain`` and
reset_where_done. The train, league, evaluation and policy-loop unrolls
call it; the server and the search call the others.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.gamespec.mechanics import ChoiceKind
from game_engine_tpu_torch.gamespec.tables import LGameOver, Lowered
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


def reset_where_done(lowered: Lowered, state: GameState) -> GameState:
    """Rooms that are done restart (init_state_like); the rest stay. The
    plain version of ST's reset."""
    fresh = init_state_like(lowered, state)
    return _where_rooms(state.done, fresh, state)


def _game_over_mech(lowered: Lowered) -> LGameOver | None:
    return lowered.game_overs[0] if lowered.game_overs else None


def _team_codes(lowered: Lowered, go: LGameOver, device) -> torch.Tensor:
    """The game-over mechanic's team codes on `device`, copied there once
    and cached with the game's tables."""
    tabs = tables(lowered, device)
    if "team_codes" not in tabs:
        tabs["team_codes"] = torch.as_tensor(np.asarray(go.team_codes, np.int32), device=device)
    return tabs["team_codes"]


def terminal_rewards_plain(lowered: Lowered, state: GameState,
                           ended: torch.Tensor) -> torch.Tensor:
    """terminal_rewards's plain torch body."""
    go = _game_over_mech(lowered)
    B, P = state.present.shape
    dev = state.present.device
    if go is None:
        return torch.zeros((B, P), dtype=torch.float32, device=dev)
    if go.mode == "team" and go.team_str_slot >= 0 and go.team_codes:
        team = state.strs[..., go.team_str_slot].to(torch.int32)
        codes = _team_codes(lowered, go, dev)
        win_code = codes[(state.winner - 1).clamp(0, len(go.team_codes) - 1).long()]
        r = torch.where(team == win_code[:, None], 1.0, -1.0)
    elif go.mode == "score":
        pidx = torch.arange(1, P + 1, dtype=torch.int32, device=dev)[None, :]
        # zero-sum per room: losers split -1 across the room's actual seats
        n = state.present.sum(1).to(torch.float32)[:, None]
        r = torch.where(pidx == state.winner[:, None], 1.0, -1.0 / (n - 1).clamp_min(1))
    else:
        r = torch.zeros((B, P), dtype=torch.float32, device=dev)
    return torch.where(ended[:, None] & state.present, r, 0.0).to(torch.float32)


def _where_rooms(rooms: torch.Tensor, new: GameState, old: GameState) -> GameState:
    """`new`'s rooms where `rooms` (B,) holds, `old`'s elsewhere."""
    return GameState(*(torch.where(rooms.reshape((-1,) + (1,) * (o.dim() - 1)), n, o)
                       for n, o in zip(new, old)))


def _plain_step(lowered: Lowered):
    """make_step(lowered), built once a game (cached on the Lowered, as the
    tables are)."""
    cache = lowered.__dict__
    if "_torch_plain_step" not in cache:
        cache["_torch_plain_step"] = make_step(lowered)
    return cache["_torch_plain_step"]


def _device_of(state: GameState) -> str:
    device = state.present.device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device.type


def engine_step(lowered: Lowered, state: GameState, actions, keep=None):
    """One engine step on (B, P) actions (0 = none; converted to int32 as
    make_step converts them) -> (state, (B,) bool ended: done after the step
    and not before). With a (B,) bool `keep`, only those rooms step and the
    rest come back unchanged. CUDA tensors: one ST launch
    (step_kernel.kernel_step); CPU tensors: make_step."""
    kind = _device_of(state)
    actions = torch.as_tensor(actions, device=state.present.device).to(_I32)
    if kind == "cuda":
        from game_engine_tpu_torch.core.step_kernel import kernel_step

        return kernel_step(lowered, state, actions, keep)
    new = _plain_step(lowered)(state, actions)
    if keep is not None:
        new = _where_rooms(keep, new, state)
    return new, new.done & ~state.done


class StepReset(NamedTuple):
    """What step_and_reset gives an unroll."""

    state: GameState  # after the step, the rooms it ended restarted
    ended: torch.Tensor  # (B,) bool: done after the step and not before
    winner: torch.Tensor  # (B,) int32: the stepped rooms' winner (0 before the end)
    reward: torch.Tensor | None  # (B, P) f32 terminal rewards, with rewards=True


def step_and_reset(lowered: Lowered, state: GameState, actions, rewards: bool = False,
                   out: GameState | None = None) -> StepReset:
    """One engine step on (B, P) actions (converted to int32 as
    engine_step converts them), then the restart of the rooms that are
    done: (state, ended, the stepped winner, with `rewards` the terminal
    rewards of the stepped state). CUDA tensors: one ST launch
    (step_kernel.kernel_step_reset), writing into `out` when given (a state
    of the same rooms that the caller is done with); CPU tensors:
    make_step, terminal_rewards_plain and reset_where_done (`out` unused)."""
    kind = _device_of(state)
    if not (isinstance(actions, torch.Tensor) and actions.dtype == _I32
            and actions.device == state.present.device):
        actions = torch.as_tensor(actions, device=state.present.device).to(_I32)
    if kind == "cuda":
        from game_engine_tpu_torch.core.step_kernel import kernel_step_reset

        return StepReset(*kernel_step_reset(lowered, state, actions, rewards, out))
    nxt, ended = engine_step(lowered, state, actions)
    reward = terminal_rewards_plain(lowered, nxt, ended) if rewards else None
    return StepReset(reset_where_done(lowered, nxt), ended, nxt.winner, reward)


def reset_done(lowered: Lowered, state: GameState) -> GameState:
    """Done rooms restarted (init_state_like), the rest unchanged. CUDA
    tensors: one ST launch (step_kernel.kernel_reset_done); CPU tensors:
    reset_where_done."""
    if _device_of(state) == "cuda":
        from game_engine_tpu_torch.core.step_kernel import kernel_reset_done

        return kernel_reset_done(lowered, state)
    return reset_where_done(lowered, state)


def bot_actions(lowered: Lowered, state: GameState) -> torch.Tensor:
    """The scripted bots' (B, P) int32 actions. CUDA tensors: one ST launch
    (step_kernel.kernel_bot_actions); CPU tensors: scripted_actions."""
    if _device_of(state) == "cuda":
        from game_engine_tpu_torch.core.step_kernel import kernel_bot_actions

        return kernel_bot_actions(lowered, state)
    return scripted_actions(lowered, state)


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
                state = reset_where_done(lowered, state)
        return state, episodes

    return rollout


def rollout(lowered: Lowered, state: GameState, num_steps: int,
            auto_reset: bool = True):
    """num_steps engine steps with scripted bots -> (state, episodes).

    CUDA tensors go through the CUDA rollout kernel (a group of lanes per
    room, all steps in one launch); CPU tensors through the plain-torch loop."""
    if state.present.is_cuda:
        from game_engine_tpu_torch.core.rollout_kernel import kernel_rollout

        return kernel_rollout(lowered, state, num_steps, auto_reset)
    if state.present.device.type != "cpu":
        raise ValueError(f"unsupported device {state.present.device}")
    return make_rollout(lowered, num_steps, auto_reset)(state)


class BatchedEngine:
    """Convenience wrapper bound to one game and one device. Its step and
    bots are engine_step and bot_actions: ST on the card."""

    def __init__(self, lowered: Lowered, device=D.DEFAULT):
        self.lowered = lowered
        self.device = D.resolve(device)

    def init(self, batch: int, n_players, seeds) -> GameState:
        return init_state(self.lowered, batch, n_players, seeds, device=self.device)

    def step(self, state: GameState, actions, keep=None) -> GameState:
        """One engine step; with a (B,) bool `keep`, of those rooms only."""
        return engine_step(self.lowered, state, torch.as_tensor(actions, device=self.device),
                           keep)[0]

    def bot_actions(self, state: GameState) -> torch.Tensor:
        return bot_actions(self.lowered, state)

    def rollout(self, state: GameState, num_steps: int, auto_reset: bool = True):
        return rollout(self.lowered, state, num_steps, auto_reset)

    def phase_dsl_ids(self, state: GameState) -> np.ndarray:
        ids = tables(self.lowered, state.phase.device)["phase_dsl_id"]
        return ids[state.phase.long()].cpu().numpy()
