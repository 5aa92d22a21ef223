"""Standalone policy evaluation CLI of the PyTorch port.

    python -m game_engine_tpu_torch.train.evaluate --game werewolf \\
        --checkpoint /path/params.npz --batch 2048 --steps 512

Counterpart of game_engine_tpu/train/evaluate.py, with its flags and JSON
keys, plus --device (cuda by default, raising without a card) and
--no-fused. Loads a policy checkpoint (the JAX package's npz + .tree.json
layout) and reports cross-play win rates against the scripted baseline in
both directions. Without --checkpoint it evaluates a fresh policy. A
checkpoint's net (arch, hidden, heads) is read from its parameter shapes,
so --arch and --hidden matter only without one.

League matchup mode:

    python -m game_engine_tpu_torch.train.evaluate --game werewolf \\
        --matchup snapshots/*.npz --batch 2048 --steps 512

plays every ordered pair of checkpoints head-to-head (row policy as the
minority side, column policy as the majority), prints the win-rate matrix
and fits Elo ratings to it (elo_fit). On CUDA the two policies' forwards
go through the policy-forward kernel (K2) where it covers the net, unless
--no-fused; on the CPU, and with --no-fused, through the plain apply_net,
as the JAX script does.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.core.engine import step_and_reset
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.gamespec.compile import compile_game
from game_engine_tpu_torch.gamespec.parser import load_builtin
from game_engine_tpu_torch.gamespec.tables import lower
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train.ppo import PPOConfig, init_training, make_apply_fn, team_masks
from game_engine_tpu_torch.train.run import make_eval


def make_vs(lowered, cfg: PPOConfig, n_steps: int):
    """Head-to-head: params_min plays the minority side, params_maj the
    rest. Returns run(params_min, params_maj, state, generator, noise=None)
    -> (minority_wins, episodes) as host ints. The forward is
    ppo.make_apply_fn's (K2 with cfg.fused_net). Per step the minority's
    Gumbel draw comes before the majority's; ``noise[t]`` = (minority,
    majority) noise (B, P, A) replaces the draws. On the card the
    observation with its masks and the draws are OB's and SA's launches,
    the step with its winner and the reset one ST step_reset launch."""
    apply_fn = make_apply_fn(lowered, cfg)

    @torch.no_grad()
    def run(params_min, params_maj, state, generator=None, noise=None):
        wins = dones = 0
        spare = None
        for t in range(n_steps):
            g_min, g_maj = (None, None) if noise is None else noise[t]
            obs, legal, am = N.observe_all(lowered, state)
            a_min, _, _, _ = N.sample_actions(lowered, params_min, state, cfg.net, obs=obs,
                                              apply_fn=apply_fn, gumbel=g_min,
                                              generator=generator, legal=legal)
            a_maj, _, _, _ = N.sample_actions(lowered, params_maj, state, cfg.net, obs=obs,
                                              apply_fn=apply_fn, gumbel=g_maj,
                                              generator=generator, legal=legal)
            side = team_masks(lowered, state)
            actions = torch.where(am & side, a_min, torch.where(am, a_maj, 0))
            nxt = step_and_reset(lowered, state, actions, out=spare)
            wins = wins + (nxt.ended & (nxt.winner == 1)).sum()
            dones = dones + nxt.ended.sum()
            spare, state = (state if t else None), nxt.state
        return int(wins), int(dones)

    return run


def matchup_table(lowered, cfg: PPOConfig, checkpoints: list[str], batch: int, steps: int,
                  players: int, seed: int, device=D.DEFAULT, counts: dict | None = None) -> dict:
    """Win-rate matrix over frozen snapshots: entry [i][j] = minority-side
    win rate of policy i against policy j holding the majority. Pair (i,
    j) draws from a generator seeded seed + 31 i + j on `device`. A
    policy's name is its file's base name without .npz; its parameters
    load as new tensors. `counts`, when given, receives {(name_i, name_j):
    (minority wins, episodes)}."""
    device = D.resolve(device)
    pols = [(os.path.basename(p).replace(".npz", ""), N.load_policy(p, device)[0])
            for p in checkpoints]
    vs = make_vs(lowered, cfg, steps)
    table: dict[str, dict[str, float]] = {}
    for i, (ni, pi) in enumerate(pols):
        table[ni] = {}
        for j, (nj, pj) in enumerate(pols):
            state = init_state(lowered, batch, players,
                               np.arange(batch, dtype=np.uint32) + seed, device=device)
            gen = torch.Generator(device=device).manual_seed(seed + i * 31 + j)
            wins, dones = vs(pi, pj, state, gen)
            table[ni][nj] = round(wins / max(dones, 1), 4)
            if counts is not None:
                counts[ni, nj] = (wins, dones)
    return table


def elo_fit(table: dict, iters: int = 4000, lr: float = 0.5) -> dict:
    """Fit Elo ratings + a minority-side advantage to the matchup matrix.

    Model: P(row i beats column j when i plays the minority side) =
    sigmoid(s_i - s_j + b), where b absorbs the game's structural side
    asymmetry (werewolf's minority wins ~25% under uniform play, so b<0
    there). The diagonal (self-play) pins b directly since s_i - s_i = 0.
    Plain logistic regression by full-batch gradient descent; ratings are
    reported in Elo points (400/ln 10 per nat) centered at 0.
    """
    names = list(table)
    n = len(names)
    w = np.asarray([[table[r][c] for c in names] for r in names], np.float64)
    s = np.zeros(n)
    b = 0.0
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(s[:, None] - s[None, :] + b)))
        g = p - w  # dLoss/dlogit for the mean cross-entropy
        s -= lr * (g.sum(axis=1) - g.sum(axis=0)) / (2 * n)
        b -= lr * g.mean()
    scale = 400.0 / np.log(10.0)
    s = (s - s.mean()) * scale
    return {
        "ratings": {names[i]: round(float(s[i]), 1) for i in np.argsort(-s)},
        "minority_side_elo": round(float(b * scale), 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--game", default="werewolf")
    ap.add_argument("--device", default=D.DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--players", type=int, default=6)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--arch", default="mlp", choices=["mlp", "deepsets", "attn"])
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--no-fused", dest="fused", action="store_false", default=True,
                    help="the plain policy net on the card too (matchup mode)")
    ap.add_argument("--matchup", nargs="*", default=None,
                    help="checkpoint paths: head-to-head win-rate matrix")
    args = ap.parse_args(argv)

    device = D.resolve(args.device)
    lowered = lower(compile_game(load_builtin(args.game)))
    net_cfg = N.NetConfig(hidden=args.hidden, arch=args.arch)
    if args.matchup:
        # the checkpoints carry their own net: K2 where it covers the first one's
        ckpt_cfg = N.load_policy(args.matchup[0], "cpu")[1]
        cfg = PPOConfig(net=ckpt_cfg, fused_net=args.fused and device.type == "cuda")
        table = matchup_table(lowered, cfg, args.matchup, args.batch, args.steps,
                              args.players, args.seed, device)
        elo = elo_fit(table)
        out = {"game": args.game, "mode": "matchup",
               "rows_play": "minority side", "table": table, "elo": elo}
        print(json.dumps(out))
        names = list(table)
        width = max(len(n) for n in names) + 2
        print("\nminority-side win rate (row vs column):")
        print(" " * width + "  ".join(f"{n[:10]:>10}" for n in names))
        for r in names:
            print(f"{r:<{width}}" + "  ".join(f"{table[r][c]:>10.3f}" for c in names))
        print(f"\nElo (minority-side advantage {elo['minority_side_elo']:+.0f}):")
        for name, r in elo["ratings"].items():
            print(f"  {name:<{width}} {r:+8.1f}")
        return out
    if args.checkpoint:
        params, net_cfg = N.load_policy(args.checkpoint, device)
    cfg = PPOConfig(net=net_cfg)
    if not args.checkpoint:
        params, _ = init_training(lowered, cfg, torch.Generator().manual_seed(0), device=device)

    out = {"game": args.game, "checkpoint": args.checkpoint or "(random init)"}
    for name, side in (("learned_as_minority", True), ("learned_as_majority", False)):
        ev = make_eval(lowered, cfg, learned_side=side, n_steps=args.steps)
        state = init_state(lowered, args.batch, args.players,
                           np.arange(args.batch, dtype=np.uint32) + args.seed, device=device)
        wins, dones = ev(params, state, torch.Generator(device=device).manual_seed(args.seed))
        out[name] = {"minority_win_rate": round(wins / max(dones, 1), 4), "episodes": dones}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
