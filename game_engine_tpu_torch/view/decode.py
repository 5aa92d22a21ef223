"""Decode engine arrays back into the reference's AgentState dict shape.

Counterpart of game_engine_tpu/view/decode.py over the port's GameState.

The inverse of the layout encoding: one room of GameState banks ->
``player_states`` dicts + phase fields, matching the AgentState schema the
reference syncs over useCoAgent (reference: src/lib/canvas/types.ts:338-360,
agent/game_agent_v2.py:97-117). Names are synthesized as "Player N" when the
room session provides none (the engine treats names as cosmetic)."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from game_engine_tpu_torch.core.state import GameState
from game_engine_tpu_torch.gamespec.layout import (
    BANK_ARR,
    BANK_BOOL,
    BANK_NUM,
    BANK_ODICT,
    BANK_PDICT,
    BANK_STR,
)
from game_engine_tpu_torch.gamespec.tables import Lowered


def decode_native(
    lowered: Lowered,
    read: dict[str, Any],
    n_players: int,
    player_names: Optional[dict[int, str]] = None,
) -> dict[str, Any]:
    """AgentState-shaped snapshot from a native CppRoom.read() dict."""
    game = lowered.game
    layout = game.layout
    names = player_names or {}
    n = n_players
    player_states: dict[str, Any] = {}
    for p in range(n):
        row: dict[str, Any] = {}
        for f in game.spec.declaration.fields:
            slot = layout.slot(f.name)
            if slot.bank == BANK_BOOL:
                row[f.name] = bool(read["bools"][p, slot.index])
            elif slot.bank == BANK_NUM:
                row[f.name] = int(read["nums"][p, slot.index])
            elif slot.bank == BANK_STR:
                row[f.name] = (
                    names.get(p + 1, f"Player {p + 1}")
                    if f.name == "name"
                    else slot.decode(int(read["strs"][p, slot.index]))
                )
            elif slot.bank == BANK_PDICT:
                # one numpy scalar read per cell (this runs after every
                # engine step via the projection path)
                cells = read["pdict"][p, slot.index]
                d: dict[str, Any] = {}
                for q in range(n):
                    c = int(cells[q])
                    if c:
                        d[str(q + 1)] = slot.decode(c)
                row[f.name] = d
            elif slot.bank == BANK_ODICT:
                row[f.name] = {"1": "submitted"} if int(read["odict"][p, slot.index]) else {}
            elif slot.bank == BANK_ARR:
                row[f.name] = []
        player_states[str(p + 1)] = row
    cp = game.phases[read["phase_index"]]
    dead = [
        str(p + 1)
        for p in range(n)
        if lowered.alive_bool >= 0 and not read["bools"][p, lowered.alive_bool]
    ]
    return {
        "player_states": player_states,
        "current_phase_id": cp.dsl_id,
        "current_phase_name": cp.name,
        "gameName": game.spec.name,
        "deadPlayers": dead,
        "done": bool(read["done"]),
        "winner": int(read["winner"]),
        "stateVersion": int(read["t"]),
    }


def decode_room(
    lowered: Lowered,
    state: GameState,
    b: int = 0,
    player_names: Optional[dict[int, str]] = None,
) -> dict[str, Any]:
    """AgentState-shaped snapshot of room b (delegates to decode_native).

    The room's fields are gathered on the state's device and come to the
    host in one copy, not one per field."""
    fields = ("bools", "nums", "strs", "pdict", "odict", "present")
    scal = ("phase", "done", "winner", "t")
    parts = [getattr(state, f)[b].reshape(-1).to(torch.int32) for f in fields]
    parts.append(torch.stack([getattr(state, f)[b].to(torch.int32) for f in scal]))
    flat = torch.cat(parts).cpu().numpy()
    read, at = {}, 0
    for f in fields:
        shape = tuple(getattr(state, f).shape[1:])
        n = int(np.prod(shape))
        read[f] = flat[at:at + n].reshape(shape)
        at += n
    phase, done, winner, t = (int(x) for x in flat[at:at + 4])
    read.update(phase_index=phase, done=bool(done), winner=winner, t=t)
    n = int(read.pop("present").sum())
    return decode_native(lowered, read, n, player_names)
