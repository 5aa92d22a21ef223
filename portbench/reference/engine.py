"""The plain engine loop: scripted bots, steps, rewards and auto-reset.

A frozen copy of the plain paths of the port's core/engine.py
(scripted_actions, reset_where_done, terminal_rewards_plain, make_rollout),
kept here so that the reference shares no code with the program.
``step_and_reset`` is the unroll's step as the plain path composes it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.gamespec.mechanics import ChoiceKind
from portbench.reference.gamespec.tables import LGameOver, Lowered
from portbench.reference.state import M32, GameState, init_state, tables
from portbench.reference.step import GOLDEN, MIX, _alive, make_step, mul32, splitmix32

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


def plain_step(lowered: Lowered):
    """make_step(lowered), built once a game (cached on the Lowered)."""
    cache = lowered.__dict__
    if "_reference_step" not in cache:
        cache["_reference_step"] = make_step(lowered)
    return cache["_reference_step"]


def step_and_reset(lowered: Lowered, state: GameState, actions: torch.Tensor):
    """One step on (B, P) int32 actions, then the restart of the rooms that
    are done -> (state, ended, the stepped state's terminal rewards)."""
    nxt = plain_step(lowered)(state, actions)
    ended = nxt.done & ~state.done
    return reset_where_done(lowered, nxt), ended, terminal_rewards_plain(lowered, nxt, ended)
