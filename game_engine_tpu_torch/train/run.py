"""PPO self-play training runner of the PyTorch port.

Usage:
    python -m game_engine_tpu_torch.train.run --arch attn --device cuda \
        --batch 4096 --updates 200 --eval-every 25

Counterpart of game_engine_tpu/train/run.py: self-play PPO over batched
rooms with cross-play evaluation against the scripted policy in both
directions, printing the same JSON event lines. On CUDA the deepsets/attn
net runs through the policy-net kernels unless --no-fused. --resume takes
a checkpoint of the JAX package's layout (npz + .tree.json, e.g.
docs/checkpoints/*.npz); --checkpoint writes one.

--league trains against a pool of frozen snapshots (train/league.py)
instead of mirror self-play, with the scripted policy as a permanent
anchor unless --no-league-anchor; --league-dir also saves each snapshot
(snap_u00001.npz, ...) for evaluate --matchup.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.gamespec.compile import compile_game
from game_engine_tpu_torch.gamespec.parser import load_builtin
from game_engine_tpu_torch.gamespec.tables import Lowered, lower
from game_engine_tpu_torch.core.engine import bot_actions, step_and_reset
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train.ppo import (PPOConfig, init_training, make_optimizer,
                                             make_train_step, team_masks)


def make_eval(lowered: Lowered, cfg: PPOConfig, learned_side: bool, n_steps: int = 256):
    """Cross-play: learned policy (plain apply_net) for one side, scripted
    for the other. Returns fn(params, state, generator) -> (wins_side,
    done_count) as host ints. On the card the observation with its masks
    and the draw are OB's and SA's launches (net.observe_all,
    sample_actions), the scripted side ST's bots (bot_actions), and the
    step with its winner and the reset one ST step_reset launch
    (engine.step_and_reset)."""

    @torch.no_grad()
    def run(params, state, generator):
        wins = dones = 0
        spare = None
        for t in range(n_steps):
            obs, legal, am = N.observe_all(lowered, state)
            la, _, _, _ = N.sample_actions(lowered, params, state, cfg.net, obs=obs,
                                           generator=generator, legal=legal)
            sa = bot_actions(lowered, state)
            side = team_masks(lowered, state)
            use_learned = side if learned_side else ~side
            actions = torch.where(am & use_learned, la, torch.where(am, sa, 0))
            nxt = step_and_reset(lowered, state, actions, out=spare)
            wins = wins + (nxt.ended & (nxt.winner == 1)).sum()  # minority team / side 1
            dones = dones + nxt.ended.sum()
            spare, state = (state if t else None), nxt.state
        return int(wins), int(dones)

    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--game", default="werewolf")
    ap.add_argument("--device", default=D.DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--players", type=int, default=6)
    ap.add_argument("--updates", type=int, default=100)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=4, help="PPO epochs per rollout")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--arch", default="mlp", choices=["mlp", "deepsets", "attn"])
    ap.add_argument("--loss-chunk", type=int, default=1,
                    help="timesteps per checkpointed chunk in the plain "
                         "deepsets/attn loss recompute (memory vs launches)")
    ap.add_argument("--fused", dest="fused", action="store_true", default=None,
                    help="use the policy-net kernels (deepsets/attn; see "
                         "policies/fused.py). Default on CUDA with supported shapes")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="force the plain policy net")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--eval-batch", type=int, default=1024)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--resume", default="", help="checkpoint path to resume params from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--league", action="store_true",
                    help="train against a pool of frozen snapshots "
                         "(prioritized opponent sampling) instead of mirror self-play")
    ap.add_argument("--league-snapshot-every", type=int, default=50)
    ap.add_argument("--no-league-anchor", dest="league_anchor",
                    action="store_false", default=True,
                    help="drop the scripted policy from the opponent pool (with no "
                         "weak anchor a long run's minority side can learn to resign)")
    ap.add_argument("--league-dir", default="",
                    help="also save each league snapshot here (for the "
                         "evaluate --matchup win-rate matrix)")
    args = ap.parse_args(argv)

    device = D.resolve(args.device)
    lowered = lower(compile_game(load_builtin(args.game)))
    net_cfg = N.NetConfig(hidden=args.hidden, arch=args.arch)
    fused = args.fused
    if fused is not False:
        from game_engine_tpu_torch.policies import fused as FZ

        mode = "forced" if fused else "auto"
        why = FZ.unsupported(lowered, net_cfg)
        if fused and why is not None:
            raise ValueError(f"--fused: {why}")
        fused = fused or FZ.runs_on_card(lowered, net_cfg, device)
        if fused:
            print(json.dumps({"event": "fused_net", "mode": mode, "disable_with": "--no-fused",
                              "forward": "tensor_core", "loss": "k4"}), flush=True)
    cfg = PPOConfig(horizon=args.horizon, epochs=args.epochs, lr=args.lr,
                    loss_chunk=args.loss_chunk, fused_net=fused, net=net_cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    init_gen = torch.Generator().manual_seed(args.seed)
    params, opt = init_training(lowered, cfg, init_gen, device=device)
    if args.resume:
        loaded, _ = N.load_policy(args.resume, device=device)
        for k, p in params.items():
            if k not in loaded or loaded[k].shape != p.shape:
                raise ValueError(f"--resume {args.resume}: param {k} missing or "
                                 f"shaped {tuple(loaded[k].shape) if k in loaded else None}, "
                                 f"expected {tuple(p.shape)}")
        params = {k: loaded[k] for k in params}
        opt = make_optimizer(params, cfg)
        print(json.dumps({"event": "resume", "from": args.resume}), flush=True)
    league = None
    if args.league:
        from game_engine_tpu_torch.train.league import League, make_league_train_step

        league = League(snapshot_every=args.league_snapshot_every, anchor=args.league_anchor)
        league.maybe_snapshot(params)
        league_step = make_league_train_step(lowered, cfg)
        if args.league_anchor:
            anchor_step = make_league_train_step(lowered, cfg, scripted_opponent=True)
        rng = np.random.default_rng(args.seed)
    train_step = make_train_step(lowered, cfg)
    state = init_state(lowered, args.batch, args.players,
                       np.arange(args.batch, dtype=np.uint32), device=device)
    evals = {
        "learned_as_minority": make_eval(lowered, cfg, learned_side=True),
        "learned_as_majority": make_eval(lowered, cfg, learned_side=False),
    }

    def run_evals():
        if args.eval_batch <= 0:
            return {}
        out = {}
        for name, ev in evals.items():
            es = init_state(lowered, args.eval_batch, args.players,
                            np.arange(args.eval_batch, dtype=np.uint32) + 777, device=device)
            wins, dones = ev(params, es, torch.Generator(device=device).manual_seed(123))
            out[name] = {"minority_win_rate": round(wins / max(dones, 1), 4), "episodes": dones}
        return out

    print(json.dumps({"event": "eval", "update": 0, **run_evals()}), flush=True)
    t0 = time.time()
    for u in range(1, args.updates + 1):
        if league is not None:
            opp_idx, opp = league.sample_opponent(rng)
            if opp_idx == league.ANCHOR_ID:
                state, metrics = anchor_step(params, params, opt, state, gen)
            else:
                state, metrics = league_step(params, opp, opt, state, gen)
            if float(metrics["episodes"]) > 0:  # no-episode updates carry no signal
                league.record_result(opp_idx, float(metrics["learner_win_rate"]))
            if league.maybe_snapshot(params) and args.league_dir:
                os.makedirs(args.league_dir, exist_ok=True)
                N.save_policy(os.path.join(args.league_dir, f"snap_u{u:05d}"), params,
                              meta={"attn_heads": cfg.net.attn_heads})
            metrics = dict(metrics, opponent=opp_idx, pool_size=len(league.params_pool))
        else:
            state, metrics = train_step(params, opt, state, gen)
        if u % 10 == 0 or u == args.updates:
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            m.update(event="train", update=u,
                     steps_per_sec=round(u * args.horizon * args.batch / (time.time() - t0), 1))
            print(json.dumps(m), flush=True)
        if u % args.eval_every == 0 or u == args.updates:
            print(json.dumps({"event": "eval", "update": u, **run_evals()}), flush=True)
            if args.checkpoint:
                N.save_policy(f"{args.checkpoint}_u{u}", params,
                              meta={"attn_heads": cfg.net.attn_heads})
    return params


if __name__ == "__main__":
    main()
