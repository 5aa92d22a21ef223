"""Per-game breadth of the rollout kernel (K1) on one NVIDIA GPU.

Counterpart of game_engine_tpu/utils/bench_games.py: each game's batched
scripted rollout with auto-reset, BatchedEngine(lowered, "cuda").rollout,
which launches K1 (csrc/rollout.cu) once a call. The default list is the
JAX module's: the werewolf anchor and the games that work the effect-IR
interpreter hardest.

    python -m game_engine_tpu_torch.utils.bench_games [batch] [steps] [iters] [game ...]

Prints one JSON line a game with the JAX rows' fields (msteps_per_s and
us_per_step from the median of `iters` calls timed by CUDA events;
compile_s is the first call's host seconds, the kernel's build at first
use included), the launch's lanes a room (the kernel picks them from the
room count) and the card's name and power limit as `gpu`, then a summary
line with rel_to_anchor. Needs a card: without one it raises.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

DEFAULT_GAMES = (
    "werewolf",            # headline anchor (night/vote/roles)
    "gift-circle",         # incoming-transfer chains
    "handshake-pact",      # mutual-pact eqcount
    "speed-track",         # rank/collision
    "relic-draft",         # eqcount pool split
    "tide-pool",           # conditional reset press-your-luck
    "cult-of-the-depths",  # string-write conversion
    "raven-moot",          # llm-seam demo game
    "storm-forge",         # adversarial 6-block ~40-statement program
    "masquerade-gala",     # ST_DEAL every round (P10-as-IR hot path)
    "potlatch",            # declared composite terminal (ST_OVER chains)
)


LONG_INTERLUDES = 60  # long_game_doc's pauses: werewolf's 18 phases and these make 78


def long_game_doc(n_interludes: int = LONG_INTERLUDES, clauses: int = 19) -> dict:
    """A synthetic game past the bounds K1 had: werewolf with a chain of
    `n_interludes` pauses (ids 100 on, dense indices past 63) between the
    day's result and the win check, and a branch of the check that holds
    after a pause, a conjunction of `clauses` phase-history clauses (a
    condition tree of clauses + 1 nodes, whose phase masks set bits past
    63). A DSL document: both packages compile it."""
    import os

    import yaml

    from game_engine_tpu_torch.gamespec.parser import games_dir

    with open(os.path.join(games_dir(), "werewolf-(mafia).yaml")) as f:
        doc = yaml.safe_load(f)
    ph = doc["phases"]
    ids = [100 + k for k in range(n_interludes)]
    names = [f"Interlude {a}{b}" for a in "bcdfghjklmnpqrstvwxz" for b in "aeiou"][:n_interludes]
    check = ph[9]
    for k, pid in enumerate(ids):
        nxt = ({"id": ids[k + 1], "name": names[k + 1]} if k + 1 < n_interludes
               else {"id": 9, "name": check["name"]})
        ph[pid] = {"name": names[k], "description": "A pause before the check.",
                   "actions": [{"description": "Show a pause", "tools": ["createTextDisplay"]}],
                   "completion_criteria": {"type": "UI_displayed", "description": "Shown."},
                   "next_phase": nxt}
    ph[16]["next_phase"] = {"id": ids[0], "name": names[0]}
    branches = list(check["next_phase"].items())
    cond = "If " + " and ".join(["this check follows an interlude"] * clauses)
    check["next_phase"] = dict(branches[:2] + [(cond, {"id": 10, "name": ph[10]["name"]})]
                               + branches[2:])
    return doc


def long_game():
    """long_game_doc lowered by the port: 78 phases, a 20-node condition."""
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import parse_game_spec
    from game_engine_tpu_torch.gamespec.tables import lower

    return lower(compile_game(parse_game_spec(long_game_doc(), name="werewolf-long")))


def game_setup(game: str) -> tuple:
    """(lowered, n_players, n_phases) of a catalog game: the declared
    min_players, else the full table width, clipped to [4, max_players]."""
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower

    spec = load_builtin(game)
    compiled = compile_game(spec)
    n_players = (getattr(spec.declaration, "min_players", 0) or
                 compiled.config.max_players)
    n_players = min(max(n_players, 4), compiled.config.max_players)
    return lower(compiled), n_players, compiled.n_phases


def bench_game(game: str, batch: int, steps: int, iters: int, gpu: str = "") -> dict:
    """One game's row: `iters` chained calls of `steps` steps on `batch`
    rooms after one warm-up call, on the card."""
    import torch

    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.core.rollout_kernel import launch_plan

    lowered, n_players, n_phases = game_setup(game)
    eng = BatchedEngine(lowered, "cuda")  # raises without a card
    state = eng.init(batch, n_players, np.arange(batch, dtype=np.uint32))
    t0 = time.perf_counter()
    state, eps = eng.rollout(state, steps)
    total_eps = int(eps)
    compile_s = time.perf_counter() - t0

    durations = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, eps = eng.rollout(state, steps)
        end.record()
        total_eps += int(eps)  # synchronises
        durations.append(start.elapsed_time(end) / 1e3)
    durations.sort()
    med = durations[len(durations) // 2]
    return {
        "game": game,
        "n_players": n_players,
        "n_phases": n_phases,
        "msteps_per_s": batch * steps / med / 1e6,
        "us_per_step": med / steps * 1e6,
        "episodes": total_eps,
        "compile_s": compile_s,
        "lanes_per_room": launch_plan(lowered, batch)["lanes_per_room"],
        "gpu": gpu,
    }


def main(argv: list[str]) -> int:
    from game_engine_tpu_torch import device as D
    from game_engine_tpu_torch.bench import gpu_line

    D.resolve("cuda")  # raises without a card, before nvidia-smi is asked
    batch = int(argv[0]) if len(argv) > 0 else 4096
    steps = int(argv[1]) if len(argv) > 1 else 1024
    iters = int(argv[2]) if len(argv) > 2 else 5
    games = argv[3:] or list(DEFAULT_GAMES)

    gpu = gpu_line()
    rows = []
    for g in games:
        row = bench_game(g, batch, steps, iters, gpu)
        rows.append(row)
        print(json.dumps(row), flush=True)
    anchor = next((r for r in rows if r["game"] == "werewolf"), rows[0])
    print(json.dumps({
        "batch": batch, "steps": steps, "iters": iters,
        "anchor": anchor["game"],
        "rel_to_anchor": {r["game"]: r["msteps_per_s"] / anchor["msteps_per_s"] for r in rows},
        "gpu": gpu,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
