"""Measure the search-bot tier (policies/search.py) against scripted play.

Counterpart of game_engine_tpu/utils/eval_search.py, with the same
arguments and output keys. For a team game: minority-team win rate with
(a) everyone scripted, (b) the minority searching, (c) the majority
searching. For score/survivor games: seat 1 searching vs scripted. Also
times the search per decision (the serving-latency cost of the tier).
Deterministic: fixed seeds, so the win rates equal the JAX script's.

    python -m game_engine_tpu_torch.utils.eval_search [game] [rooms] \
        [rollouts] [horizon] [determinize] [--device cpu]

The `rooms` rooms play side by side as one batched state on the device:
each step, one ``actions_for_slots`` call (one launch of the search kernel
on the card) decides every seat of every live room, for at most 600 steps.
determinize=D>0 evaluates the INFORMATION-SET tier (SearchBots
determinize=D).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from game_engine_tpu_torch import device as D

MAX_STEPS = 600
SEED0 = 9000  # room i plays from seed SEED0 + i


def eval_game(game: str, rooms: int, rollouts: int, horizon: int,
              determinize: int = 0, device=D.DEFAULT) -> dict:
    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.policies.search import SearchBots

    lw = lower(compile_game(load_builtin(game)))
    go = lw.game_overs[0] if lw.game_overs else None
    sb = SearchBots(lw, rollouts=rollouts, horizon=horizon,
                    determinize=determinize, device=device)
    eng = BatchedEngine(lw, device)
    n = min(6, lw.P)

    def play(search_pred):
        """search_pred(strs) -> (B, P) bool: the seats that take their
        search decision, from the rooms' string banks before the step."""
        state = eng.init(rooms, n, np.arange(SEED0, SEED0 + rooms, dtype=np.uint32))
        decisions = 0
        t_search = 0.0
        for _ in range(MAX_STEPS):
            done = state.done.cpu().numpy()
            if done.all():
                break
            acts = eng.bot_actions(state)
            if search_pred is not None:
                live = np.flatnonzero(~done)
                t0 = time.perf_counter()
                sa = sb.actions_for_slots(state, live)
                sa_np = sa.cpu().numpy()
                t_search += time.perf_counter() - t0
                decisions += int(np.count_nonzero(sa_np))  # every searched seat, incl. unused
                use = search_pred(state.strs.cpu().numpy()) & (sa_np != 0)
                acts = torch.where(torch.as_tensor(use, device=sa.device), sa, acts)
            state = eng.step(state, acts)
        wins = int((state.winner.cpu().numpy() == 1).sum())
        return (wins / rooms, decisions,
                t_search / max(decisions, 1) if search_pred else 0.0)

    out = {"game": game, "rooms": rooms, "rollouts": rollouts,
           "horizon": horizon, "determinize": determinize,
           "n_players": n, "mode": go.mode if go else None}
    base, _, _ = play(None)
    out["scripted_minority_or_seat1_win"] = round(base, 4)
    if go and go.mode == "team":
        slot, min_code = go.team_str_slot, go.team_codes[0]

        def is_min(strs):
            return strs[:, :, slot].astype(np.int64) == min_code

        wmin, d1, lat1 = play(is_min)
        wmaj, d2, lat2 = play(lambda strs: ~is_min(strs))
        out["minority_search_win"] = round(wmin, 4)
        out["majority_search_minority_win"] = round(wmaj, 4)
        out["decisions"] = d1 + d2
        out["s_per_decision"] = round((lat1 + lat2) / 2, 5)
    else:
        def seat1(strs):
            return np.arange(lw.P)[None, :].repeat(len(strs), 0) == 0

        w1, d1, lat1 = play(seat1)
        out["seat1_search_win"] = round(w1, 4)
        out["decisions"] = d1
        out["s_per_decision"] = round(lat1, 5)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("game", nargs="?", default="werewolf", help="a catalog game, or all")
    ap.add_argument("rooms", nargs="?", type=int, default=200)
    ap.add_argument("rollouts", nargs="?", type=int, default=32)
    ap.add_argument("horizon", nargs="?", type=int, default=200)
    ap.add_argument("determinize", nargs="?", type=int, default=0)
    ap.add_argument("--device", default=D.DEFAULT, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.game != "all":
        print(json.dumps(eval_game(args.game, args.rooms, args.rollouts, args.horizon,
                                   args.determinize, args.device)))
        return

    # catalog balance sweep: one line per game. The pair (scripted
    # baseline, search swing) is a game-design QA signal — a baseline near
    # 0/1 that search cannot move marks a structurally degenerate game; a
    # big swing marks a skill-dominated one.
    import os

    from game_engine_tpu_torch.gamespec.parser import games_dir

    for fn in sorted(os.listdir(games_dir())):
        if not fn.endswith((".yaml", ".yml")):
            continue
        name = fn.rsplit(".", 1)[0]
        try:
            out = eval_game(name, args.rooms, args.rollouts, args.horizon, device=args.device)
        except ValueError as e:  # a game search cannot serve (no terminal rule, a room
            # the kernel cannot hold); a failed build or launch raises
            out = {"game": name, "skipped": str(e)[:120]}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
