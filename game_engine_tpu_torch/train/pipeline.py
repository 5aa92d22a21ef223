"""Pipelined ("async") PPO learner: rollout collection overlapped with the
PPO update, with one update of parameter staleness.

Counterpart of game_engine_tpu/train/pipeline.py: make_pipeline,
run_pipelined, and the submesh form (submeshes, run_pipelined_sharded).
The stages:

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

The submesh form puts the two stages on two disjoint groups of ranks of a
torch.distributed world (parallel/mesh.py): the actor ranks collect with
the rooms split over them, each trajectory moves to the learner ranks
split on its room axis, the learner ranks run the data-parallel update,
and the new parameters move back to the actor ranks. The same math with
the same one update of staleness: the actors collect traj_{k+1} under
theta_k while the learners make theta_{k+1}. The hops are point-to-point
sends on the world's group; gloo's send and recv refuse CUDA tensors, so
under gloo they go through pinned host memory.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.parallel.mesh import Mesh, mesh_over, state_sharding
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train.ppo import (PPOConfig, Rollout, gae, make_apply_fn,
                                             make_unroll, make_update, rollout_metrics)


def make_pipeline(lowered: Lowered, cfg: PPOConfig, mesh=None):
    """(collect, update):

    collect(params, state, generator) -> (state', traj, last_obs)
    update(params, opt, traj, last_obs) -> metrics: cfg.epochs Adam steps
        of `params` in place (K4 with cfg.fused_net where it covers the
        net), the bootstrap value from last_obs (K2 with cfg.fused_net).

    Placement is not decided here: each call runs on the current stream.
    With a mesh, each runs on this rank's rooms as train/ppo.py's
    make_train_step does (the metrics are the data group's)."""
    unroll = make_unroll(lowered, cfg, mesh)
    apply_fn = make_apply_fn(lowered, cfg, mesh)
    step_update = make_update(lowered, cfg, mesh)

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
        metrics["episodes"] = rollout_metrics(traj, mesh)["episodes"]
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


# ---------------------------------------------------------------------------
# the submesh form: actor ranks and learner ranks
# ---------------------------------------------------------------------------

def submeshes(n_actor: int, n_learner: int, backend=None,
              device=D.DEFAULT) -> tuple[Mesh, Mesh]:
    """Two disjoint ('data', 'model') meshes over the world's ranks: ranks
    [0, n_actor) collect, [n_actor, n_actor + n_learner) update. Every rank
    of the world calls it."""
    if not dist.is_initialized():
        raise RuntimeError("submeshes needs a torch.distributed world (parallel.launch)")
    world = dist.get_world_size()
    if n_actor < 1 or n_learner < 1 or n_actor + n_learner > world:
        raise ValueError(f"need {n_actor}+{n_learner} ranks, the world has {world}")
    actor = mesh_over(np.arange(n_actor).reshape(n_actor, 1), backend, device)
    learner = mesh_over(np.arange(n_actor, n_actor + n_learner).reshape(n_learner, 1),
                        backend, device)
    return actor, learner


_TRAJ = Rollout._fields + ("last_obs",)
# the dtypes of make_unroll's trajectory and of the bootstrap observation
_TRAJ_DTYPES = {"obs": torch.bfloat16, "actions": torch.int32, "logp": torch.float32,
                "value": torch.float32, "reward": torch.float32, "done": torch.bool,
                "mask": torch.bool, "legal": torch.bool, "last_obs": torch.bfloat16}
# on the wire the wider types first, so every piece starts aligned to its type
_WIRE = sorted(_TRAJ, key=lambda f: -_TRAJ_DTYPES[f].itemsize)
_HEADER = 5  # a piece's ndim, then up to four dims


def _overlaps(actor: Mesh, learner: Mesh, i: int, j: int) -> bool:
    """Whether actor data index i and learner data index j hold rooms in
    common (equal shares of the same batch, in data order)."""
    a, n = actor.data_size, learner.data_size
    return i * n < (j + 1) * a and j * a < (i + 1) * n


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _send(t: torch.Tensor, dst: int, mesh: Mesh) -> None:
    """Send `t` to world rank dst: from the card under NCCL; under gloo,
    whose send refuses CUDA tensors, through pinned host memory."""
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    elif t.is_cuda:
        t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    dist.send(t, dst)


def _recv(shape, dtype, src: int, mesh: Mesh) -> torch.Tensor:
    """A tensor from world rank src, on the mesh's device (under gloo,
    whose recv refuses CUDA tensors, through pinned host memory)."""
    if mesh.backend == "nccl":
        buf = torch.empty(shape, dtype=dtype, device=mesh.device)
        dist.recv(buf, src)
        return buf
    host = torch.empty(shape, dtype=dtype, pin_memory=mesh.device.type == "cuda")
    dist.recv(host, src)
    return host.to(mesh.device, non_blocking=True)


def _send_traj(actor: Mesh, learner: Mesh, traj: Rollout, last_obs) -> None:
    """This actor's rooms of (traj, last_obs) to the learner ranks that
    hold them (room axis 1 of the trajectory, 0 of last_obs): for each, a
    header of the pieces' shapes, then their bytes."""
    per_a = last_obs.shape[0]
    per_l = per_a * actor.data_size // learner.data_size
    a0 = actor.data_index * per_a
    for j in range(learner.data_size):
        if not _overlaps(actor, learner, actor.data_index, j):
            continue
        lo, hi = max(a0, j * per_l) - a0, min(a0 + per_a, (j + 1) * per_l) - a0
        piece = {**{f: t[:, lo:hi] for f, t in zip(Rollout._fields, traj)},
                 "last_obs": last_obs[lo:hi]}
        pieces = [piece[f] for f in _WIRE]
        header = torch.full((len(pieces), _HEADER), -1, dtype=torch.int64)
        for i, t in enumerate(pieces):
            header[i, 0] = t.dim()
            header[i, 1:1 + t.dim()] = torch.tensor(t.shape)
        dst = int(learner.devices[j, 0])
        _send(header, dst, actor)
        _send(_flat(pieces), dst, actor)


def _recv_traj(actor: Mesh, learner: Mesh):
    """This learner's rooms of the trajectory, from every actor that holds
    some, joined in room order -> (traj, last_obs) on its device."""
    parts = []
    for i in range(actor.data_size):
        if not _overlaps(actor, learner, i, learner.data_index):
            continue
        src = int(actor.devices[i, 0])
        header = _recv((len(_WIRE), _HEADER), torch.int64, src, learner).cpu()
        shapes = [tuple(int(x) for x in row[1:1 + int(row[0])]) for row in header]
        sizes = [int(np.prod(sh)) * _TRAJ_DTYPES[f].itemsize for f, sh in zip(_WIRE, shapes)]
        buf = _recv((sum(sizes),), torch.uint8, src, learner)
        piece, at = {}, 0
        for f, sh, n in zip(_WIRE, shapes, sizes):
            piece[f] = buf[at:at + n].view(_TRAJ_DTYPES[f]).reshape(sh)
            at += n
        parts.append(piece)
    joined = {f: torch.cat([p[f] for p in parts], dim=0 if f == "last_obs" else 1)
              if len(parts) > 1 else parts[0][f] for f in _TRAJ}
    return Rollout(*(joined[f] for f in Rollout._fields)), joined["last_obs"]


def _send_params(learner: Mesh, actor: Mesh, params: dict) -> None:
    """The learner's parameters, flat, to every actor rank."""
    buf = torch.cat([p.detach().reshape(-1) for p in params.values()])
    for i in range(actor.data_size):
        _send(buf, int(actor.devices[i, 0]), learner)


def _recv_params(learner: Mesh, actor: Mesh, params: dict) -> None:
    """The first learner rank's parameters, copied into `params` in place."""
    n = sum(p.numel() for p in params.values())
    buf = _recv((n,), torch.float32, int(learner.devices[0, 0]), actor)
    at = 0
    with torch.no_grad():
        for p in params.values():
            p.copy_(buf[at:at + p.numel()].view_as(p))
            at += p.numel()


def run_pipelined_sharded(lowered: Lowered, cfg: PPOConfig, params: dict, opt, state,
                          generator, n_updates: int, actor_mesh: Mesh, learner_mesh: Mesh):
    """run_pipelined over two groups of ranks (submeshes): every rank of
    either mesh calls it with the same arguments. `state` holds all the
    rooms; the actor ranks collect from their share of them, under
    generators seeded alike, and the learner ranks update `params` (an
    optimizer over them in `opt`) on their share of each trajectory.

    Returns (state, metrics): an actor rank's rooms after the last collect
    and None; a learner rank's None and the last update's metrics (the
    learner group's). On every rank `params` ends as theta_{n_updates}:
    the learners made it and the actors received it."""
    if actor_mesh.member:
        collect = make_pipeline(lowered, cfg, actor_mesh)[0]
        state = state_sharding(actor_mesh, state)
        state, traj, last_obs = collect(params, state, generator)
        _send_traj(actor_mesh, learner_mesh, traj, last_obs)
        for k in range(n_updates):
            state, traj, last_obs = collect(params, state, generator)  # under theta_k
            _recv_params(learner_mesh, actor_mesh, params)  # theta_{k+1}
            if k + 1 < n_updates:
                _send_traj(actor_mesh, learner_mesh, traj, last_obs)
        return state, None
    if not learner_mesh.member:
        return None, None
    update = make_pipeline(lowered, cfg, learner_mesh)[1]
    traj, last_obs = _recv_traj(actor_mesh, learner_mesh)
    metrics = {}
    for k in range(n_updates):
        metrics = update(params, opt, traj, last_obs)
        if learner_mesh.data_index == 0:
            _send_params(learner_mesh, actor_mesh, params)
        if k + 1 < n_updates:
            traj, last_obs = _recv_traj(actor_mesh, learner_mesh)
    return None, metrics
