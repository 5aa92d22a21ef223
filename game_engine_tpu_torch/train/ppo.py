"""PPO self-play over batched rooms.

Counterpart of game_engine_tpu/train/ppo.py. Zero-sum terminal rewards:
in team games every player whose team wins gets +1, losers -1, paid on the
episode-end step; in score games the winning player gets +1. Only players
whose action was relevant this step contribute to the policy loss;
everyone contributes to the value loss.

A train step unrolls T env steps with the learned policy (a Python loop
over net.observe_all, net.sample_actions and engine.step_and_reset: on the
card one launch each of OB, SA (csrc/observe.cu) and ST's step_reset
(csrc/rollout.cu: the step, the terminal rewards and the reset), with the
forward and torch.rand between, where the JAX unroll scans its jitted XLA
body),
computes GAE, then runs `epochs` full-batch clipped-PPO updates with
torch.optim.Adam (optax.adam's defaults). With ``fused_net`` the
deepsets/attn net runs through the policy-net kernels (policies/fused.py):
K2 in the unroll and the bootstrap value, K4 in each update (or K2 + K3
with ``fused_loss=False``).

Randomness comes from an explicit torch.Generator; it does not reproduce
jax.random's draws (sample_actions takes given noise for that).

With a mesh (parallel/mesh.py) the same step runs on every rank of a
(data, model) grid, as JAX's GSPMD program runs on every device:

  data   each rank unrolls its own rooms, drawing the sampling noise for
         the whole batch from a generator seeded alike on every rank and
         keeping its rows, so any split samples what one process samples.
         The loss normalises by the whole batch (the masked advantage
         mean and std, msum and n are sums over the data group), each
         rank's gradient is its rooms' share of the batch's, and one
         all-reduce over the data group sums the gradients, loss and
         metrics; Adam then takes the same step on every rank. K2 and K4
         run per rank as they are, with the batch's row weights from the
         host.
  model  the plain net's trunk split column/row over the model group
         (net.apply_net with the mesh); the kernels compute the whole
         trunk in one pass, so a model axis wider than 1 runs the plain
         net.

A mesh of one rank runs the same arithmetic as no mesh, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.core.engine import (  # noqa: F401  (re-exported)
    reset_done,
    step_and_reset,
    terminal_rewards_plain,
)
from game_engine_tpu_torch.core.state import GameState
from game_engine_tpu_torch.parallel.mesh import data_sums
from game_engine_tpu_torch.policies import net as N
# the actor mask is a predicate over the state (P2), kept beside the legal mask
from game_engine_tpu_torch.policies.net import actor_mask, actor_mask_plain  # noqa: F401
from game_engine_tpu_torch.utils.metrics import Clock, span


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    horizon: int = 32
    epochs: int = 4  # PPO epochs over each rollout
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    # timesteps recomputed per checkpointed chunk in the plain deepsets/attn
    # loss (the set-encoder activations are too big to hold for the whole
    # horizon at thousands of rooms)
    loss_chunk: int = 1
    # route the deepsets/attn net through the policy-net kernels
    fused_net: bool = False
    # with fused_net: one K4 pass per update instead of K2 forward + K3
    # backward through ppo_loss, where K4 covers the net (fused.supports)
    fused_loss: bool = True
    net: N.NetConfig = dataclasses.field(default_factory=N.NetConfig)


def _tensor_parallel(mesh) -> bool:
    return mesh is not None and mesh.model_size > 1


def make_apply_fn(lowered: Lowered, cfg: PPOConfig, mesh=None):
    """(params, obs) -> (logits, value): the fused kernels when enabled for
    a net of an arch they cover (raising for one past their bounds, see
    fused.unsupported), else the plain apply_net; the tensor-parallel plain
    net on a mesh with a model axis wider than 1."""
    if _tensor_parallel(mesh):
        return lambda params, obs: N.apply_net(params, obs, cfg.net, lowered, mesh)
    if cfg.fused_net:
        from game_engine_tpu_torch.policies import fused as FZ

        if FZ.covers_arch(cfg.net):
            return FZ.make_apply(lowered, cfg.net)
    return lambda params, obs: N.apply_net(params, obs, cfg.net, lowered)


def terminal_rewards(lowered: Lowered, state: GameState, ended: torch.Tensor) -> torch.Tensor:
    """(B, P) float32 rewards paid on the step an episode ends: OB's reward
    mode on CUDA tensors (one launch), terminal_rewards_plain on the CPU."""
    if state.present.device.type == "cuda":
        from game_engine_tpu_torch.policies import obs_kernel as OK

        return OK.kernel_rewards(lowered, state, ended)
    return terminal_rewards_plain(lowered, state, ended)


class Rollout(NamedTuple):
    obs: torch.Tensor  # (T, B, P, F) bf16
    actions: torch.Tensor  # (T, B, P) 1-based
    logp: torch.Tensor  # (T, B, P)
    value: torch.Tensor  # (T, B, P)
    reward: torch.Tensor  # (T, B, P)
    done: torch.Tensor  # (T, B) episode ended at this step
    mask: torch.Tensor  # (T, B, P) actor mask
    legal: torch.Tensor  # (T, B, P, A) legal-action mask used at sampling


def make_unroll(lowered: Lowered, cfg: PPOConfig, mesh=None):
    """unroll(params, state, generator) -> (state, Rollout): cfg.horizon
    steps of the learned policy. On the card a step is OB (observation,
    legal and actor masks), the forward, torch.rand, SA (the draw and the
    actor-masked actions) and ST's step_reset (the step, the terminal
    rewards of the stepped state, the restart of the rooms it ended, in one
    launch). From the second step on, the state the step consumed receives
    the next one (step_and_reset's `out`): only the caller's first state is
    kept."""
    apply_fn = (make_apply_fn(lowered, cfg, mesh)
                if cfg.fused_net or _tensor_parallel(mesh) else None)

    @torch.no_grad()
    def unroll(params, state: GameState, generator: torch.Generator):
        rows = None if mesh is None else mesh.room_rows(state.present.shape[0])
        steps, spare = [], None
        for t in range(cfg.horizon):
            obs, legal, mask = N.observe_all(lowered, state)
            actions, logp, v, _ = N.sample_actions(lowered, params, state, cfg.net, obs=obs,
                                                   apply_fn=apply_fn, generator=generator,
                                                   rows=rows, legal=legal, actor=mask)
            nxt = step_and_reset(lowered, state, actions, rewards=True, out=spare)
            spare, state = (state if t else None), nxt.state
            steps.append(Rollout(obs, actions, logp, v, nxt.reward, nxt.ended, mask, legal))
        return state, Rollout(*(torch.stack(xs) for xs in zip(*steps)))

    return unroll


def gae(traj: Rollout, last_value: torch.Tensor, cfg: PPOConfig):
    """(T, B, P) advantages + returns; bootstrap cut at episode ends."""
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    advs = []
    for t in range(traj.value.shape[0] - 1, -1, -1):
        v, r = traj.value[t], traj.reward[t]
        nonterm = 1.0 - traj.done[t][:, None].to(torch.float32)
        delta = r + cfg.gamma * v_next * nonterm - v
        adv_next = delta + cfg.gamma * cfg.lam * nonterm * adv_next
        v_next = v
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + traj.value


def ppo_loss(params, traj: Rollout, adv, ret, cfg: PPOConfig,
             lowered: Lowered | None = None, mesh=None):
    """Clipped-PPO loss -> (total, metrics). With a mesh, traj holds this
    rank's rooms and every returned value is their share of the data
    group's whole batch (normalised by the batch's msum, advantage mean and
    std, and room count): the shares sum to the batch's values."""
    if cfg.fused_net and cfg.net.arch in ("deepsets", "attn") and not _tensor_parallel(mesh):
        # the kernels hold no activations: the whole trajectory in one call
        logits, value = make_apply_fn(lowered, cfg)(params, traj.obs)
    elif cfg.net.arch in ("deepsets", "attn"):
        # recompute in chunks of timesteps with checkpointing, so the
        # backward holds one chunk's set-encoder activations at a time
        T = traj.obs.shape[0]
        C = max(1, min(cfg.loss_chunk, T))
        while T % C:  # largest divisor of T not above the requested chunk
            C -= 1
        outs = [checkpoint(lambda o: N.apply_net(params, o, cfg.net, lowered, mesh),
                           traj.obs[t:t + C], use_reentrant=False)
                for t in range(0, T, C)]
        logits = torch.cat([o[0] for o in outs])
        value = torch.cat([o[1] for o in outs])
    else:
        logits, value = N.apply_net(params, traj.obs, cfg.net, lowered, mesh)
    # the same legal-action masking as at sampling time
    logits = torch.where(traj.legal, logits, torch.full_like(logits, -1e9))
    logp_all = torch.log_softmax(logits, dim=-1)
    a_idx = (traj.actions.long() - 1).clamp(0, logits.shape[-1] - 1)
    logp = logp_all.gather(-1, a_idx[..., None])[..., 0]
    ratio = torch.exp(logp - traj.logp)

    m = traj.mask.to(torch.float32)
    msum, adv_sum = data_sums(mesh, m.sum(), (adv * m).sum())
    msum = msum.clamp_min(1.0)
    mean = adv_sum / msum
    (var_sum,) = data_sums(mesh, (m * (adv - mean) ** 2).sum())
    adv_n = (adv - mean) / (torch.sqrt(var_sum / msum) + 1e-8)
    pg = -torch.minimum(ratio * adv_n, ratio.clamp(1 - cfg.clip, 1 + cfg.clip) * adv_n)
    pg_loss = (pg * m).sum() / msum
    v_loss = 0.5 * ((value - ret) ** 2).mean()
    if mesh is not None:  # this rank's share of the mean over the batch's rooms
        v_loss = v_loss * (1.0 / mesh.data_size)
    ent = -(logp_all.exp() * logp_all).sum(-1)
    ent_loss = -(ent * m).sum() / msum
    total = pg_loss + cfg.vf_coef * v_loss + cfg.ent_coef * ent_loss
    return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": -ent_loss,
                   "ratio_mean": (ratio * m).sum() / msum}


def team_masks(lowered: Lowered, state: GameState) -> torch.Tensor:
    """(B, P) — the 'protagonist' side for cross-play eval: the minority
    team, speakers for speaker games, or seat 1 in free-for-all score games."""
    go = next(iter(lowered.game_overs), None)
    if go is not None and go.mode == "team" and go.team_codes:
        return state.strs[..., go.team_str_slot].to(torch.int32) == go.team_codes[0]
    if lowered.game.layout.get("is_speaker") is not None:
        return state.bools[..., lowered.game.layout.bool_index("is_speaker")]
    P = state.present.shape[1]
    seat1 = torch.arange(P, device=state.present.device)[None, :] == 0
    return seat1.expand(state.present.shape) & state.present


def make_loss_vg_fn(lowered: Lowered, cfg: PPOConfig, mesh=None):
    """((loss, metrics), grads) through K4 (one pass over the rows), or None
    when the config does not ask for it, the net's arch is not one K4
    covers or the trunk is split over a model axis; the update then runs
    ppo_loss through make_apply_fn (K2 + K3 with fused_net). A net past
    K4's bounds raises (see fused.unsupported). With a mesh, this rank's
    shares (see ppo_loss)."""
    if not (cfg.fused_net and cfg.fused_loss) or _tensor_parallel(mesh):
        return None
    from game_engine_tpu_torch.policies import fused as FZ

    if not FZ.covers_arch(cfg.net):
        return None
    mono = FZ.make_loss_vg(lowered, cfg.net, cfg.clip, cfg.vf_coef, cfg.ent_coef, mesh)

    def loss_vg(params, traj, adv, ret):
        return mono(params, traj.obs, traj.legal, traj.actions, traj.logp, adv, ret,
                    traj.mask)

    return loss_vg


def _sum_over_data(mesh, loss, metrics: dict, grads: list):
    """The rank's shares of the loss, metrics and gradients summed over the
    data group, in one collective."""
    keys = list(metrics)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1)]
                     + [metrics[k].detach().reshape(1) for k in keys])
    mesh.data_sum(flat)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[at], dict(zip(keys, flat[at + 1:].unbind())), out


def make_grad_fn(lowered: Lowered, cfg: PPOConfig, mesh=None):
    """grad_fn(params, traj, adv, ret) -> (loss, metrics, grads by name):
    the PPO loss of a trajectory and its parameter gradient, through K4
    (fused_loss), K2 + K3 (fused_net alone) or autograd over apply_net.
    With a mesh, the whole batch's values: this rank's shares summed over
    its data group."""
    loss_vg = make_loss_vg_fn(lowered, cfg, mesh)

    def grad_fn(params, traj: Rollout, adv, ret):
        names = list(params)
        if loss_vg is not None:
            (loss, metrics), grads = loss_vg(params, traj, adv, ret)
            grads = [grads[k] for k in names]
        else:
            loss, metrics = ppo_loss(params, traj, adv, ret, cfg, lowered, mesh)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        if mesh is not None:
            loss, metrics, grads = _sum_over_data(mesh, loss, metrics, grads)
        return loss, metrics, dict(zip(names, grads))

    return grad_fn


def make_update(lowered: Lowered, cfg: PPOConfig, mesh=None):
    """update(params, opt, traj, adv, ret) -> (loss, metrics): one Adam
    step of `params` in place on the PPO loss of a trajectory (make_grad_fn;
    with a mesh, on the data group's summed gradient)."""
    grad_fn = make_grad_fn(lowered, cfg, mesh)

    def update(params, opt: torch.optim.Optimizer, traj: Rollout, adv, ret):
        loss, metrics, grads = grad_fn(params, traj, adv, ret)
        for k, g in grads.items():
            params[k].grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss, metrics

    return update


def rollout_metrics(traj: Rollout, mesh=None) -> dict:
    """reward_per_step (f32) and episodes (int64) of a trajectory; with a
    mesh, of the data group's whole batch (one collective)."""
    reward = traj.reward.sum(-1).mean()
    episodes = traj.done.sum()
    if mesh is not None:
        both = mesh.data_sum(torch.stack([(reward * (1.0 / mesh.data_size)).double(),
                                          episodes.double()]))
        reward, episodes = both[0].to(reward.dtype), both[1].to(episodes.dtype)
    return {"reward_per_step": reward, "episodes": episodes}


def make_train_step(lowered: Lowered, cfg: PPOConfig, mesh=None):
    """train_step(params, opt, state, generator) -> (state, metrics): one
    unroll, GAE and cfg.epochs Adam updates of `params` in place. metrics
    holds the loss terms as tensors and unroll_ms / update_ms as floats.
    With a mesh (see the module docstring), `state` holds this rank's
    rooms, `params` its slices, every rank's generator is seeded alike,
    and the metrics are the data group's."""
    unroll = make_unroll(lowered, cfg, mesh)
    apply_fn = make_apply_fn(lowered, cfg, mesh)
    update = make_update(lowered, cfg, mesh)

    def train_step(params, opt: torch.optim.Optimizer, state: GameState,
                   generator: torch.Generator):
        with span("ge.train_step"):
            clock = Clock(state.present.device)
            clock.mark()
            with span("ge.unroll"):
                state, traj = unroll(params, state, generator)
                with torch.no_grad():
                    _, last_v = apply_fn(params, N.observe(lowered, state))
                adv, ret = gae(traj, last_v, cfg)
            clock.mark()
            with span("ge.update"):
                loss = torch.zeros((), device=state.present.device)  # epochs=0: rollout only
                metrics = {}
                for _ in range(cfg.epochs):
                    loss, metrics = update(params, opt, traj, adv, ret)
            clock.mark()
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            metrics.update(rollout_metrics(traj, mesh))
            metrics["unroll_ms"], metrics["update_ms"] = clock.spans_ms()
        return state, metrics

    return train_step


def init_training(lowered: Lowered, cfg: PPOConfig, generator: torch.Generator,
                  device=D.DEFAULT):
    """-> (params, optimizer): fresh params (leaf tensors that require
    grad) and torch.optim.Adam(lr) over them."""
    params = N.init_params(generator, N.obs_dim(lowered), N.action_space(lowered),
                           cfg.net, lowered, device=device)
    return params, make_optimizer(params, cfg)


def make_optimizer(params: dict, cfg: PPOConfig) -> torch.optim.Optimizer:
    for p in params.values():
        p.requires_grad_(True)
    return torch.optim.Adam(list(params.values()), lr=cfg.lr)
