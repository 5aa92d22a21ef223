"""League self-play: a pool of frozen snapshots and opponent sampling.

Counterpart of game_engine_tpu/train/league.py. The learner trains against
past snapshots of itself instead of pure mirror self-play. Per update an
opponent is drawn from the pool (prioritized: opponents the learner loses
to are drawn more), rooms are split so the learner controls the minority
team in even rooms and the majority team in odd rooms (so both sides are
learned), and only learner-controlled seats enter the policy loss.
Snapshots join the pool on a fixed cadence; with ``anchor`` the scripted
policy stays in the draw as a permanent weak opponent.

A snapshot is a set of new tensors (``detach().clone()``), never views of
the learner's parameters, which the optimizer updates in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from game_engine_tpu_torch.core.engine import bot_actions, step_and_reset
from game_engine_tpu_torch.core.state import GameState
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train.ppo import (PPOConfig, Rollout, gae, make_apply_fn,
                                             make_update, team_masks)
from game_engine_tpu_torch.utils.metrics import Clock


@dataclasses.dataclass
class League:
    """Host-side snapshot pool with prioritized opponent sampling.

    Snapshots carry stable, monotonically assigned ids: once the pool is
    full every snapshot evicts the oldest entry, so list positions shift
    under the caller. sample_opponent therefore returns the id, and
    record_result resolves by id (a result for an evicted snapshot is
    dropped, never applied to a shifted neighbour)."""

    ANCHOR_ID = -1  # the scripted baseline's permanent pool id

    max_size: int = 8
    snapshot_every: int = 50
    # keep the scripted policy in the draw as a permanent weak anchor: a
    # snapshot-only pool converges to strong copies of the learner's own
    # majority play, and the minority side can learn to resign; losing to
    # the anchor raises its sampling weight and restores the gradient
    anchor: bool = True
    pool: list = dataclasses.field(default_factory=list)  # {id, params, winrate}
    _updates: int = 0
    _next_id: int = 0
    _anchor_winrate: float = 0.5

    @property
    def params_pool(self) -> list:
        return [e["params"] for e in self.pool]

    @property
    def learner_winrate(self) -> list:
        return [e["winrate"] for e in self.pool]

    def ids(self) -> list:
        return [e["id"] for e in self.pool]

    def maybe_snapshot(self, params) -> bool:
        self._updates += 1
        if (self._updates - 1) % self.snapshot_every == 0:
            self.pool.append({
                "id": self._next_id,
                "params": {k: v.detach().clone() for k, v in params.items()},
                "winrate": 0.5,  # EMA of the learner's win rate (sample losers more)
            })
            self._next_id += 1
            if len(self.pool) > self.max_size:
                self.pool.pop(0)
            return True
        return False

    def sample_opponent(self, rng: np.random.Generator) -> tuple[int, Any]:
        """Returns (id, params); (ANCHOR_ID, None) means the scripted anchor."""
        assert self.pool, "snapshot before sampling"
        w = [max(1e-3, 1.0 - e["winrate"]) for e in self.pool]
        ids = [(e["id"], e["params"]) for e in self.pool]
        if self.anchor:
            w.append(max(1e-3, 1.0 - self._anchor_winrate))
            ids.append((self.ANCHOR_ID, None))
        w = np.asarray(w)
        pos = int(rng.choice(len(w), p=w / w.sum()))
        return ids[pos]

    def record_result(self, sid: int, learner_win_rate: float, ema: float = 0.1) -> None:
        if sid == self.ANCHOR_ID:
            self._anchor_winrate = ((1 - ema) * self._anchor_winrate
                                    + ema * learner_win_rate)
            return
        for e in self.pool:
            if e["id"] == sid:
                e["winrate"] = (1 - ema) * e["winrate"] + ema * learner_win_rate
                return


def learner_controls(lowered: Lowered, state: GameState) -> torch.Tensor:
    """(B, P): the learner's seats; even rooms -> the minority side."""
    B = state.present.shape[0]
    side = team_masks(lowered, state)
    even = (torch.arange(B, device=side.device) % 2 == 0)[:, None]
    return torch.where(even, side, ~side) & state.present


def make_league_unroll(lowered: Lowered, cfg: PPOConfig, scripted_opponent: bool = False,
                       apply_fn=None):
    """unroll(params, opp_params, state, generator, noise=None) ->
    (state, traj, learner_won (T, B)): cfg.horizon steps with the learner's
    seats on `params` and the rest on `opp_params` (or the scripted policy).
    Per step one observation serves both sides; the learner's Gumbel draw
    comes before the opponent's. ``noise[t]`` = (learner, opponent) noise
    (B, P, A) replaces the draws (the opponent's is unused when scripted).
    ``apply_fn`` defaults to ppo.make_apply_fn: K2 with cfg.fused_net. The
    observation with its masks and the draws are OB's and SA's launches on
    the card, the scripted opponent ST's bots, and the step, its rewards and
    the reset one ST step_reset launch."""
    if apply_fn is None:
        apply_fn = make_apply_fn(lowered, cfg)

    @torch.no_grad()
    def unroll(params, opp_params, state: GameState, generator=None, noise=None):
        steps, won, spare = [], [], None
        for t in range(cfg.horizon):
            g_learn, g_opp = (None, None) if noise is None else noise[t]
            obs, legal, am = N.observe_all(lowered, state)
            a, logp, v, _ = N.sample_actions(lowered, params, state, cfg.net, obs=obs,
                                             apply_fn=apply_fn, gumbel=g_learn,
                                             generator=generator, legal=legal)
            if scripted_opponent:
                oa = bot_actions(lowered, state)
            else:
                oa, _, _, _ = N.sample_actions(lowered, opp_params, state, cfg.net, obs=obs,
                                               apply_fn=apply_fn, gumbel=g_opp,
                                               generator=generator, legal=legal)
            ctrl = learner_controls(lowered, state)
            actions = torch.where(am & ctrl, a, torch.where(am, oa, 0))
            nxt = step_and_reset(lowered, state, actions, rewards=True, out=spare)
            # the learner won: a learner-controlled seat got +1 at the end
            won.append(nxt.ended & (ctrl & (nxt.reward > 0)).any(1))
            spare, state = (state if t else None), nxt.state
            steps.append(Rollout(obs, actions, logp, v, nxt.reward, nxt.ended, am & ctrl, legal))
        return state, Rollout(*(torch.stack(xs) for xs in zip(*steps))), torch.stack(won)

    return unroll


def make_league_train_step(lowered: Lowered, cfg: PPOConfig, scripted_opponent: bool = False):
    """One league update: unroll against a frozen opponent, PPO on the
    learner's seats.

    Returns train_step(params, opp_params, opt, state, generator,
    noise=None) -> (state, metrics): `params` take cfg.epochs Adam steps in
    place (make_update: K4 with cfg.fused_net where it covers the net).
    metrics: loss, v_loss, entropy, episodes and learner_win_rate as
    tensors, unroll_ms / update_ms as floats. With `scripted_opponent` the
    opponent seats play the scripted policy and `opp_params` is unused (the
    League.anchor arm). The bootstrap value takes the unroll's forward
    (K2 with cfg.fused_net, one launch an update) where the JAX step takes
    the plain net: the same function within K2's tolerance."""
    apply_fn = make_apply_fn(lowered, cfg)
    unroll = make_league_unroll(lowered, cfg, scripted_opponent, apply_fn)
    update = make_update(lowered, cfg)

    def train_step(params, opp_params, opt: torch.optim.Optimizer, state: GameState,
                   generator=None, noise=None):
        dev = state.present.device
        clock = Clock(dev)
        clock.mark()
        state, traj, won = unroll(params, opp_params, state, generator, noise)
        with torch.no_grad():
            _, last_v = apply_fn(params, N.observe(lowered, state))
        adv, ret = gae(traj, last_v, cfg)
        clock.mark()
        zero = torch.zeros((), device=dev)
        loss, metrics = zero, {"v_loss": zero, "entropy": zero}
        for _ in range(cfg.epochs):
            loss, metrics = update(params, opt, traj, adv, ret)
        clock.mark()
        episodes = traj.done.sum()
        out = {"loss": loss.detach(), "v_loss": metrics["v_loss"].detach(),
               "entropy": metrics["entropy"].detach(), "episodes": episodes,
               "learner_win_rate": won.sum() / episodes.clamp_min(1)}
        out["unroll_ms"], out["update_ms"] = clock.spans_ms()
        return state, out

    return train_step
