"""Pipelined ("async") PPO learner: rollout collection overlapped with the
PPO update, with one update of parameter staleness.

Counterpart of game_engine_tpu/train/pipeline.py (make_pipeline and
run_pipelined; the multi-device submesh form is not ported). The stages:

    actor:   traj_{k+1} = unroll(theta_k, state_k)      (stale by one)
    learner: theta_{k+1} = ppo_epochs(theta_k, traj_k)

The PPO ratio prices the staleness: traj_k stores the behaviour policy's
log-probs, and the first epoch's clipped ratios treat theta_k as the sync
step treats any post-epoch parameters.

On one card the two stages are two CUDA streams. The actor stream has the
higher priority: its unroll is many small kernels that the block scheduler
should slot in as the update's K4 blocks retire, and a late actor holds
up the next round. The actor reads its own copy of the parameters,
refreshed on the actor stream by ``copy_`` once an event says the
learner's update is done; the learner's next update waits for that copy
before it writes the parameters again. Trajectories cross from the actor
stream to the learner stream after an event, and every tensor read on a
stream it was not allocated on is marked with ``record_stream``, so the
caching allocator does not hand its block to the next unroll while K4
still reads it. The kernels launch on the current stream and allocate
their scratch and packed weights there. No host synchronisation happens
inside the loop. Per round the host issues the update first, then the
next unroll, then the refresh: the unroll's Python dispatch then overlaps
the update's device time, while the copy keeps the staleness exact.

With rollout time r and update time u a round, the two streams can reach
1 / max(r, u) rounds/s against 1 / (r + u) serially, as far as the card
leaves room beside K4 for the unroll's kernels. On the CPU the same calls
run in order.
"""

from __future__ import annotations

import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train.ppo import (PPOConfig, gae, make_apply_fn, make_unroll,
                                             make_update)


def make_pipeline(lowered: Lowered, cfg: PPOConfig):
    """(collect, update):

    collect(params, state, generator) -> (state', traj, last_obs)
    update(params, opt, traj, last_obs) -> metrics: cfg.epochs Adam steps
        of `params` in place (K4 with cfg.fused_net where it covers the
        net), the bootstrap value from last_obs (K2 with cfg.fused_net).

    Placement is not decided here: each call runs on the current stream."""
    unroll = make_unroll(lowered, cfg)
    apply_fn = make_apply_fn(lowered, cfg)
    step_update = make_update(lowered, cfg)

    def collect(params, state, generator):
        state, traj = unroll(params, state, generator)
        # the bootstrap observation rides with the trajectory, so the
        # learner never touches engine state
        return state, traj, N.observe(lowered, state)

    def update(params, opt, traj, last_obs):
        with torch.no_grad():
            _, last_v = apply_fn(params, last_obs)
        adv, ret = gae(traj, last_v, cfg)
        loss = torch.zeros((), device=last_obs.device)
        metrics = {}
        for _ in range(cfg.epochs):
            loss, metrics = step_update(params, opt, traj, adv, ret)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["episodes"] = traj.done.sum()
        return metrics

    return collect, update


def _tensors(*trees):
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            yield tree
        elif isinstance(tree, dict):
            yield from _tensors(*tree.values())
        elif isinstance(tree, (tuple, list)):
            yield from _tensors(*tree)


def _used_on(stream, *trees) -> None:
    """Tell the caching allocator that `stream` reads these CUDA tensors."""
    for t in _tensors(*trees):
        if t.is_cuda:
            t.record_stream(stream)


def _refresh(a_params: dict, params: dict) -> None:
    with torch.no_grad():
        for k, v in a_params.items():
            v.copy_(params[k])


def run_pipelined(lowered: Lowered, cfg: PPOConfig, params: dict, opt, state, generator,
                  n_updates: int, pipeline=None, device=D.DEFAULT, overlap: bool = True):
    """Drive the two-stage pipeline for n_updates rounds: round k collects
    traj_{k+1} under theta_k and updates theta_k on traj_k, so traj_{k+1}
    is collected before the update that makes theta_{k+1}. `params` are
    updated in place; returns (state, last metrics).

    `device` is where params, state and generator lie: "cuda" (the
    default; raises without a card) runs the actor and the learner on two
    new streams, the actor's of the higher priority. "cpu", or
    overlap=False, runs the same calls in order on the current stream. Pass a prebuilt ``pipeline=(collect,
    update)`` to reuse it across calls."""
    device = D.resolve(device)
    if state.present.device.type != device.type:
        raise ValueError(f"state on {state.present.device}, run_pipelined on {device}")
    collect, update = pipeline if pipeline is not None else make_pipeline(lowered, cfg)
    if device.type == "cpu" or not overlap:
        a_params = {k: v.detach().clone() for k, v in params.items()}
        state, traj, last_obs = collect(a_params, state, generator)
        metrics = {}
        for _ in range(n_updates):
            nxt = collect(a_params, state, generator)
            metrics = update(params, opt, traj, last_obs)
            _refresh(a_params, params)
            state, traj, last_obs = nxt
        return state, metrics

    main = torch.cuda.current_stream(device)
    # a lower number is a higher priority
    actor = torch.cuda.Stream(device, priority=-1)
    learner = torch.cuda.Stream(device, priority=0)
    actor.wait_stream(main)
    learner.wait_stream(main)
    # the caller's tensors, read on the actor stream until main waits for it
    _used_on(actor, params, state)
    with torch.cuda.stream(actor):
        a_params = {k: v.detach().clone() for k, v in params.items()}
        state, traj, last_obs = collect(a_params, state, generator)
        ready = torch.cuda.Event()
        ready.record()
    copied = ready
    metrics = {}
    for _ in range(n_updates):
        with torch.cuda.stream(learner):
            learner.wait_event(ready)   # traj_k is written
            learner.wait_event(copied)  # the actor has read theta_k
            _used_on(learner, traj, last_obs)
            metrics = update(params, opt, traj, last_obs)
            updated = torch.cuda.Event()
            updated.record()
        with torch.cuda.stream(actor):
            state, traj, last_obs = collect(a_params, state, generator)
            ready = torch.cuda.Event()
            ready.record()
            actor.wait_event(updated)
            _refresh(a_params, params)
            copied = torch.cuda.Event()
            copied.record()
    main.wait_stream(actor)
    main.wait_stream(learner)
    _used_on(main, state, metrics)
    return state, metrics
