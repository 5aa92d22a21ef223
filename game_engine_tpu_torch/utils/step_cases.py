"""Inputs that drive the engine step past what the scripted bots do: actions
no bot emits, and a game whose rooms are born done.

ST, the engine step entry (core/step_kernel.py), takes whatever actions a
caller passes, so it is held against the plain make_step on these as well
as on the bots' actions: by its CPU tests through the g++ build and by
chip_smoke.py's engine_step check on the card.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def odd_actions(lowered, bots: torch.Tensor, rng, bots_share: float = 0.5) -> torch.Tensor:
    """(B, P) int32 actions on the bots' device: the bots' where a draw
    from the numpy Generator `rng` falls under `bots_share`, else what no
    bot emits: 0, negative numbers, seats past P, options past the phase's
    count, int32's extremes, and seats 1..P whatever they are (dead,
    absent, not targeted, already acted; rooms that are done get theirs
    too)."""
    B, P = bots.shape
    kmax = int(np.max(lowered.choice_max)) if np.size(lowered.choice_max) else 0
    odd = np.array([0, -1, -7, P + 1, P + 5, kmax + 1, INT32_MIN, INT32_MAX], np.int64)
    pick = rng.random((B, P))
    wild = np.where(pick < 0.2, odd[rng.integers(0, len(odd), (B, P))],
                    rng.integers(1, max(P, kmax) + 1, (B, P)))
    return torch.where(torch.as_tensor(pick < bots_share, device=bots.device), bots,
                       torch.as_tensor(wild.astype(np.int32), device=bots.device))


def born_done_doc() -> dict:
    """potlatch whose start phase declares `over` in 4-seat rooms: those
    rooms are born done, and every reset re-creates them done. A DSL
    document: both packages compile it."""
    import os

    import yaml

    from game_engine_tpu_torch.gamespec.parser import games_dir

    with open(os.path.join(games_dir(), "potlatch.yaml")) as f:
        doc = yaml.safe_load(f)
    doc["phases"][0]["mechanics"] = [{"effects": ["over 2 where nplayers == 4"]}]
    return doc


def born_done_game():
    """born_done_doc lowered by the port."""
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import parse_game_spec
    from game_engine_tpu_torch.gamespec.tables import lower

    return lower(compile_game(parse_game_spec(born_done_doc(), name="born-done")))
