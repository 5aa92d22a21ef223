"""Round-robin arena over mixed bot tiers, with Elo ratings.

Counterpart of game_engine_tpu/utils/arena.py, with its arguments and JSON
keys. `train/evaluate.py --matchup` compares learned checkpoints on the
batched path; this arena compares any serving tiers (scripted, lookahead
search, information-set search, learned checkpoints) pairwise on the
native simulator (native/lib.py CppGame), a room at a time, the way rooms
serve them. Every ordered pair (row plays the minority side / seat 1,
column the rest) plays `rooms` fixed-seed rooms; the win matrix feeds
train.evaluate.elo_fit (ratings + a minority-side handicap term).

    python -m game_engine_tpu_torch.utils.arena [game] [rooms] [tier ...] \\
        [--device cpu]

Tiers (repeatable, order = table order):
    scripted            the splitmix32 baseline policy
    search              full-information lookahead (rollouts=32, horizon=200)
    search-detD         information-set search over D determinizations
    <path>.npz          a learned checkpoint (policies/serve.py greedy)

Defaults: werewolf, 100 rooms, tiers = scripted search search-det8. On
--device cuda (the default; raises without a card) the search tiers launch
the search kernel (S) and the checkpoint tiers the policy-forward kernel
(K2); --device cpu runs their plain versions. Deterministic: fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from game_engine_tpu_torch import device as D

ROLLOUTS = 32
HORIZON = 200
SEED0 = 11000  # room i plays from seed SEED0 + i


def _make_tier(spec: str, lowered, device):
    """(name, actor-or-None): actor exposes native_actions(read, n, seed)."""
    from game_engine_tpu_torch.policies.search import SearchBots

    if spec == "scripted":
        return "scripted", None
    if spec == "search":
        return "search", SearchBots(lowered, rollouts=ROLLOUTS, horizon=HORIZON, device=device)
    m = re.fullmatch(r"search-det(\d+)", spec)
    if m:
        return spec, SearchBots(lowered, rollouts=ROLLOUTS, horizon=HORIZON,
                                determinize=int(m.group(1)), device=device)
    if spec.endswith(".npz") or "/" in spec:
        from game_engine_tpu_torch.policies import net as N
        from game_engine_tpu_torch.policies.serve import PolicyBots

        params, cfg = N.load_policy(spec, device)
        name = os.path.basename(spec).replace(".npz", "")
        return name, PolicyBots(lowered, params, cfg, spec)
    raise SystemExit(f"unknown tier spec {spec!r} (scripted | search | "
                     f"search-detD | checkpoint.npz)")


def protagonist_rule(lowered):
    """is_protag(pid, read) -> bool: the minority team's seats in a team
    game, seat 1 otherwise; raises SystemExit for a game with no terminal
    winner rule."""
    go = lowered.game_overs[0] if lowered.game_overs else None
    if go is None:
        raise SystemExit(f"game {lowered.game.spec.name!r} declares no terminal winner rule")
    if go.mode == "team":
        slot, min_code = go.team_str_slot, go.team_codes[0]
        return go, lambda pid, r: int(r["strs"][pid - 1, slot]) == min_code
    return go, lambda pid, r: pid == 1


def run_arena(game: str, rooms: int, tier_specs: list[str], device=D.DEFAULT) -> dict:
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.native import CppGame
    from game_engine_tpu_torch.train.evaluate import elo_fit

    device = D.resolve(device)
    lw = lower(compile_game(load_builtin(game)))
    go, is_protag = protagonist_rule(lw)
    eng = CppGame(lw)
    n = min(6, lw.P)
    tiers = [_make_tier(s, lw, device) for s in tier_specs]

    def play(actor_min, actor_maj) -> float:
        wins = 0
        for i in range(rooms):
            room = eng.room(n, SEED0 + i)
            for _ in range(600):
                r = room.read()
                if r["done"]:
                    break
                acts = room.policy_actions()
                a_min = (actor_min.native_actions(r, n, seed=SEED0 + i)
                         if actor_min is not None else {})
                a_maj = (actor_maj.native_actions(r, n, seed=SEED0 + i)
                         if actor_maj is not None else {})
                for pid in range(1, n + 1):
                    src = a_min if is_protag(pid, r) else a_maj
                    if pid in src:
                        acts[pid] = src[pid]
                room.step(acts)
            wins += room.read()["winner"] == 1
        return wins / rooms

    table: dict[str, dict[str, float]] = {}
    for ni, ai in tiers:
        table[ni] = {}
        for nj, aj in tiers:
            table[ni][nj] = round(play(ai, aj), 4)
            print(json.dumps({"event": "pair", "minority": ni,
                              "majority": nj, "win": table[ni][nj]}),
                  file=sys.stderr, flush=True)
    elo = elo_fit(table)
    return {"game": game, "rooms": rooms, "n_players": n, "mode": go.mode,
            "rows_play": "minority side" if go.mode == "team" else "seat 1",
            "rollouts": ROLLOUTS, "horizon": HORIZON,
            "table": table, "elo": elo}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("game", nargs="?", default="werewolf")
    ap.add_argument("rooms", nargs="?", type=int, default=100)
    ap.add_argument("tiers", nargs="*", default=None)
    ap.add_argument("--device", default=D.DEFAULT, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = run_arena(args.game, args.rooms, args.tiers or ["scripted", "search", "search-det8"],
                    args.device)
    print(json.dumps(out))
    names = list(out["table"])
    width = max(len(x) for x in names) + 2
    print("\nminority-side win rate (row vs column):", file=sys.stderr)
    print(" " * width + "  ".join(f"{x[:12]:>12}" for x in names), file=sys.stderr)
    for r in names:
        print(f"{r:<{width}}" + "  ".join(
            f"{out['table'][r][c]:>12.3f}" for c in names), file=sys.stderr)
    print(f"\nElo (minority handicap {out['elo']['minority_side_elo']:+.0f}):",
          file=sys.stderr)
    for nm, rt in out["elo"]["ratings"].items():
        print(f"  {nm:<{width}} {rt:+8.1f}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
