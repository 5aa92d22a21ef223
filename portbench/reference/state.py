"""GameState: struct-of-arrays room state as torch tensors, batched over rooms.

A frozen copy of the port's core/state.py (the state and its fresh rooms),
kept here so that the reference shares no code with the program.

Counterpart of game_engine_tpu/core/state.py: the same 15 fields with the
same shapes and dtypes, except ``seed``, which is int64 holding uint32
values (torch's uint32 lacks add, shifts and remainder on the CPU).
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Union

import numpy as np
import torch

from portbench.reference.gamespec.tables import Lowered

M32 = 0xFFFFFFFF

# per-phase arrays of Lowered that the step indexes by phase
_PHASE_TABLES = (
    "phase_is_action", "phase_target_pred", "phase_static_next",
    "phase_dsl_id", "choice_kind", "choice_max", "rec_bool_true",
    "rec_bool_false", "rec_num_slot", "rec_pdict_slot", "rec_pdict_src",
    "rec_pdict_trans", "rec_odict_slot",
)


class GameState(NamedTuple):
    """All tensors carry a leading batch (rooms) axis B."""

    bools: torch.Tensor  # (B, P, NB) bool
    nums: torch.Tensor  # (B, P, NN) int32
    strs: torch.Tensor  # (B, P, NS) int8
    pdict: torch.Tensor  # (B, P, NPD, P) int8
    odict: torch.Tensor  # (B, P, NOD) int8
    present: torch.Tensor  # (B, P) bool
    phase: torch.Tensor  # (B,) int32
    prev_phase: torch.Tensor  # (B,) int32, -1 at start
    acted: torch.Tensor  # (B, P) bool
    choice: torch.Tensor  # (B, P) int32
    choice_phase: torch.Tensor  # (B, P) int32, -1
    done: torch.Tensor  # (B,) bool
    winner: torch.Tensor  # (B,) int32
    t: torch.Tensor  # (B,) int32
    seed: torch.Tensor  # (B,) int64 holding uint32 values

    @property
    def batch(self) -> int:
        return self.present.shape[0]


_DTYPES = {
    "bools": torch.bool, "nums": torch.int32, "strs": torch.int8,
    "pdict": torch.int8, "odict": torch.int8, "present": torch.bool,
    "phase": torch.int32, "prev_phase": torch.int32, "acted": torch.bool,
    "choice": torch.int32, "choice_phase": torch.int32, "done": torch.bool,
    "winner": torch.int32, "t": torch.int32, "seed": torch.int64,
}


def tables(lowered: Lowered, device) -> dict:
    """The lowered per-phase arrays and bank defaults as tensors on `device`,
    built once per device and cached on the Lowered object (as the JAX
    package caches its jitted step there)."""
    device = torch.device(device)
    cache = lowered.__dict__.setdefault("_torch_tables", {})
    key = str(device)
    if key not in cache:
        tabs = {name: torch.as_tensor(np.asarray(getattr(lowered, name)),
                                      device=device)
                for name in _PHASE_TABLES}
        tabs["bool_defaults"] = torch.as_tensor(
            np.asarray(lowered.bool_defaults, bool), device=device)
        tabs["num_defaults"] = torch.as_tensor(
            np.asarray(lowered.num_defaults, np.int32), device=device)
        tabs["str_defaults"] = torch.as_tensor(
            np.asarray(lowered.str_defaults, np.int8), device=device)
        cache[key] = tabs
    return cache[key]


def _batched(x, batch: int, dtype, device) -> torch.Tensor:
    """x as a (batch,) tensor of `dtype` on `device`; a scalar is filled
    there (no host-to-device copy), wrapping as the int64 cast does."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device, dtype=dtype)
    elif np.ndim(x) == 0:
        return torch.full((batch,), int(np.asarray(x, dtype=np.int64)), dtype=torch.int64,
                          device=device).to(dtype)
    else:
        t = torch.as_tensor(np.asarray(x, dtype=np.int64), device=device).to(dtype)
    return t.broadcast_to((batch,)).clone()


def init_state(
    lowered: Lowered,
    batch: int,
    n_players: Union[int, np.ndarray, torch.Tensor],
    seeds: Union[int, np.ndarray, torch.Tensor],
    device: Union[str, torch.device] = "cuda",
) -> GameState:
    """Fresh rooms at the start phase with template-default fields, after
    the start phase's on-enter mechanics, on `device` (the card unless the
    caller asks for the CPU)."""
    from portbench.reference.step import apply_on_enter

    device = torch.device(device)
    P = lowered.P
    tabs = tables(lowered, device)
    n = _batched(n_players, batch, torch.int32, device)
    seed = _batched(seeds, batch, torch.int64, device) & M32
    present = torch.arange(P, device=device)[None, :] < n[:, None]
    lay = lowered.game.layout

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    state = GameState(
        bools=tabs["bool_defaults"].expand(batch, P, -1).clone(),
        nums=tabs["num_defaults"].expand(batch, P, -1).clone(),
        strs=tabs["str_defaults"].expand(batch, P, -1).clone(),
        pdict=full((batch, P, max(1, lay.n_pdict), P), 0, torch.int8),
        odict=full((batch, P, max(1, lay.n_odict)), 0, torch.int8),
        present=present,
        phase=full((batch,), lowered.game.start_index, torch.int32),
        prev_phase=full((batch,), -1, torch.int32),
        acted=full((batch, P), False, torch.bool),
        choice=full((batch, P), 0, torch.int32),
        choice_phase=full((batch, P), -1, torch.int32),
        done=full((batch,), False, torch.bool),
        winner=full((batch,), 0, torch.int32),
        t=full((batch,), 0, torch.int32),
        seed=seed,
    )
    entered = torch.ones((batch,), dtype=torch.bool, device=device)
    return apply_on_enter(lowered, state, entered, state.phase)
