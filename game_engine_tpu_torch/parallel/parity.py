"""Rank bodies of the multi-device checks. Each is fn(rank, spec) for
parallel.launch.run_ranks and runs in every rank of the world: on the CPU
over gloo in tests/test_torch_parallel.py and tests/test_torch_pipeline.py,
and on the card in chip_smoke.py's multidevice phases (one card shared over
gloo, or with --multichip one card a rank over NCCL). `spec` is a dict of
plain values and numpy arrays:

  game, seats, rooms, start_seed   the rooms: init_state(game, rooms, seats,
                                   start_seed + arange(rooms)), all of them
                                   made on every rank and then sharded
  net, ppo                         NetConfig and PPOConfig keywords
  params / ckpt                    the whole parameters: numpy arrays, or a
                                   checkpoint path
  gen_seed                         every rank's sampling generator seed
  device, backend                  where the ranks run

Each returns numpy arrays (run_ranks copies tensors to the host) and the
kernels' launches it made.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.core.engine import BatchedEngine
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.gamespec.compile import compile_game
from game_engine_tpu_torch.gamespec.parser import load_builtin
from game_engine_tpu_torch.gamespec.tables import lower
from game_engine_tpu_torch.parallel.mesh import (Mesh, data_sums, gather_params, gather_state,
                                                 make_mesh, params_sharding, state_sharding)
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.train import ppo as P


@functools.lru_cache(maxsize=None)
def lowered_of(game: str):
    return lower(compile_game(load_builtin(game)))


def config_of(spec: dict) -> P.PPOConfig:
    return P.PPOConfig(**spec.get("ppo", {}), net=N.NetConfig(**spec["net"]))


def params_of(spec: dict, device) -> dict:
    if "ckpt" in spec:
        return N.load_policy(spec["ckpt"], device=device)[0]
    return N.params_from_numpy(spec["params"], device=device)


def start_of(spec: dict, device=D.DEFAULT):
    """All the rooms of the spec, on `device`."""
    lw = lowered_of(spec["game"])
    B = spec["rooms"]
    return init_state(lw, B, spec["seats"],
                      np.arange(B, dtype=np.uint32) + spec.get("start_seed", 0), device=device)


def launches() -> dict:
    """This process's kernel launches so far: K1, K2, K3, K4, ST (its four
    entries together, and each), OB's two entries and SA."""
    from game_engine_tpu_torch.core import step_kernel as SK
    from game_engine_tpu_torch.core.rollout_kernel import kernel_rollout
    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import obs_kernel as OK

    return {"rollout": kernel_rollout.launches,
            "policy_forward": FZ.kernel_forward.launches,
            "policy_backward": FZ.kernel_grads.launches,
            "ppo_loss_grad": FZ.kernel_loss_grads.launches,
            "engine_step": (SK.kernel_step.launches + SK.kernel_reset_done.launches
                            + SK.kernel_bot_actions.launches + SK.kernel_step_reset.launches),
            "step": SK.kernel_step.launches, "reset_done": SK.kernel_reset_done.launches,
            "bot_actions": SK.kernel_bot_actions.launches,
            "step_reset": SK.kernel_step_reset.launches,
            "observe": OK.kernel_observe.launches, "rewards": OK.kernel_rewards.launches,
            "sample": OK.kernel_sample.launches}


def since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items()}


def cards_held() -> list:
    """The cards this process has held a tensor on (a peak in the caching
    allocator's count). A kernel wrapper launches on its tensors' card, so
    a rank that held only its own card launched only there."""
    if not torch.cuda.is_initialized():
        return []
    return [c for c in range(torch.cuda.device_count()) if torch.cuda.max_memory_allocated(c)]


def rank_env(rank: int, spec: dict) -> dict:
    """Where this rank runs: its card (the mesh's device and torch's current
    one), the host CPUs it may use, and the world's sum of the ranks
    (one all_reduce on the card over spec["backend"])."""
    import os

    import torch.distributed as dist

    mesh = _mesh(spec, None)
    t = torch.full((1,), float(rank), device=mesh.device)
    dist.all_reduce(t)
    return {"device": str(mesh.device),
            "current_device": torch.cuda.current_device() if mesh.device.type == "cuda" else None,
            "cpus": sorted(os.sched_getaffinity(0)), "world_sum": float(t)}


def _mesh(spec: dict, n: int, model: int = 1) -> Mesh:
    return make_mesh(n, model, backend=spec.get("backend"), device=spec["device"])


def engine_rollout(rank: int, spec: dict) -> dict:
    """Scripted rollout of `steps` steps (auto-reset) on each rank's rooms
    of a mesh over the whole world (the rollout kernel K1 on the card):
    this rank's rooms, the data group's episodes and, gathered, all rooms."""
    mesh = _mesh(spec, None, spec.get("model", 1))
    lw = lowered_of(spec["game"])
    before = launches()
    state, eps = BatchedEngine(lw, mesh.device).rollout(
        state_sharding(mesh, start_of(spec, mesh.device)), spec["steps"])
    (eps,) = data_sums(mesh, eps)
    return {"coords": mesh.coords, "state": state, "episodes": int(eps),
            "gathered": gather_state(mesh, state), "launches": since(before)}


def first_update(rank: int, spec: dict) -> dict:
    """For each (n, model) of spec["meshes"], a mesh over the world's first
    n ranks, whose members take the first unroll and the first update's
    gradient from the same start (the others wait for the next mesh): the
    rooms after the unroll, its actions, its reward_per_step and episodes,
    the loss, metrics and the gathered gradients; on a one-rank mesh also
    each action's sampling margin (the gap between its score and the next
    best: a near tie where it is small).

    -> {"{n}x{model}": result} for the meshes this rank is in."""
    lw = lowered_of(spec["game"])
    cfg = config_of(spec)
    out = {}
    for n, model in spec["meshes"]:
        mesh = _mesh(spec, n, model)
        if mesh.member:
            out[f"{n}x{model}"] = _first_update_on(mesh, lw, cfg, spec)
    return out


def _first_update_on(mesh: Mesh, lw, cfg: P.PPOConfig, spec: dict) -> dict:
    params = params_sharding(mesh, {k: v.requires_grad_(True)
                                    for k, v in params_of(spec, mesh.device).items()})
    state = state_sharding(mesh, start_of(spec, mesh.device))
    gen = torch.Generator(mesh.device).manual_seed(spec["gen_seed"])
    before = launches()
    state, traj = P.make_unroll(lw, cfg, mesh)(params, state, gen)
    with torch.no_grad():
        _, last_v = P.make_apply_fn(lw, cfg, mesh)(params, N.observe(lw, state))
    adv, ret = P.gae(traj, last_v, cfg)
    loss, metrics, grads = P.make_grad_fn(lw, cfg, mesh)(params, traj, adv, ret)
    res = {"state": state, "actions": traj.actions.to(torch.int8), "loss": loss,
           "metrics": {**metrics, **P.rollout_metrics(traj, mesh)},
           "grads": gather_params(mesh, grads), "launches": since(before),
           "cards": cards_held(), "device": str(mesh.device)}
    if mesh.data_size == 1 and mesh.model_size == 1:
        res["margins"] = _margins(lw, cfg, params, traj, spec["gen_seed"], mesh)
    return res


@torch.no_grad()
def _margins(lw, cfg, params, traj, gen_seed: int, mesh: Mesh) -> torch.Tensor:
    """(T, B, P): the gap between the sampled action's score (masked logit
    plus Gumbel noise, redrawn from the same seed) and the best other one;
    inf where the seat did not act."""
    gen = torch.Generator(mesh.device).manual_seed(gen_seed)
    logits, _ = P.make_apply_fn(lw, cfg, mesh)(params, traj.obs)
    logits = torch.where(traj.legal, logits, torch.full_like(logits, -1e9))
    first, end, total = mesh.room_rows(traj.obs.shape[1])
    noise = torch.stack([N.gumbel_noise((total,) + tuple(logits.shape[2:]), gen,
                                        logits.device)[first:end]
                         for _ in range(traj.obs.shape[0])])
    top = (logits + noise).topk(2, dim=-1).values
    return torch.where(traj.mask, top[..., 0] - top[..., 1], torch.inf)


def dp_updates(rank: int, spec: dict) -> dict:
    """spec["updates"] train steps (make_train_step) on a data-parallel mesh
    of the world's first spec["n"] ranks, from the same start: this rank's
    parameters and Adam state after them (the replicas of a data group
    apply the same summed gradients, so they must end bit for bit equal),
    its device, its launches and the cards it held."""
    lw = lowered_of(spec["game"])
    cfg = config_of(spec)
    mesh = _mesh(spec, spec["n"])
    if not mesh.member:
        return {}
    params = params_sharding(mesh, params_of(spec, mesh.device))
    opt = P.make_optimizer(params, cfg)
    state = state_sharding(mesh, start_of(spec, mesh.device))
    gen = torch.Generator(mesh.device).manual_seed(spec["gen_seed"])
    step = P.make_train_step(lw, cfg, mesh)
    before = launches()
    for _ in range(spec["updates"]):
        state, _ = step(params, opt, state, gen)
    adam = {k: {s: v for s, v in opt.state[p].items()} for k, p in params.items()}
    return {"device": str(mesh.device), "params": params, "adam": adam,
            "launches": since(before), "cards": cards_held()}


def loss_grad(rank: int, spec: dict) -> dict:
    """The PPO loss, metrics and gradient of a fixed trajectory
    (spec["traj"]: numpy obs, actions, logp, mask, legal, adv, ret of shape
    (T, B, ...)) on a (spec["n"], spec["model"]) mesh: each rank takes its
    rooms, the gradients are summed over the data group and gathered over
    the model group; also this rank's rows of the net's logits and value."""
    lw = lowered_of(spec["game"])
    cfg = config_of(spec)
    mesh = _mesh(spec, spec["n"], spec.get("model", 1))
    params = params_sharding(mesh, {k: v.requires_grad_(True)
                                    for k, v in params_of(spec, mesh.device).items()})
    tr = spec["traj"]
    first, end, _ = mesh.room_rows(tr["obs"].shape[1] // mesh.data_size)

    def cut(name, dtype=None):
        t = torch.as_tensor(np.ascontiguousarray(tr[name][:, first:end]), device=mesh.device)
        return t if dtype is None else t.to(dtype)

    traj = P.Rollout(obs=cut("obs", torch.bfloat16), actions=cut("actions"), logp=cut("logp"),
                     value=None, reward=None, done=None, mask=cut("mask"), legal=cut("legal"))
    loss, metrics, grads = P.make_grad_fn(lw, cfg, mesh)(params, traj, cut("adv"), cut("ret"))
    with torch.no_grad():
        logits, value = P.make_apply_fn(lw, cfg, mesh)(params, traj.obs)
    return {"coords": mesh.coords, "loss": loss, "metrics": metrics,
            "grads": gather_params(mesh, grads), "logits": logits, "value": value}


def pipeline(rank: int, spec: dict) -> dict:
    """train/pipeline.py run_pipelined_sharded with spec["actors"] actor
    ranks and spec["learners"] learner ranks for spec["rounds"] rounds:
    this rank's role, its rooms (actors), the metrics (learners), the
    parameters it ends with and its launches."""
    from game_engine_tpu_torch.train.pipeline import run_pipelined_sharded, submeshes

    lw = lowered_of(spec["game"])
    cfg = config_of(spec)
    actor, learner = submeshes(spec["actors"], spec["learners"], spec.get("backend"),
                               spec["device"])
    mesh = actor if actor.member else learner
    if not mesh.member:
        return {"role": None}
    params = params_of(spec, mesh.device)
    opt = P.make_optimizer(params, cfg)
    gen = torch.Generator(mesh.device).manual_seed(spec["gen_seed"])
    before = launches()
    state, metrics = run_pipelined_sharded(lw, cfg, params, opt, start_of(spec, mesh.device),
                                           gen, spec["rounds"], actor, learner)
    return {"role": "actor" if actor.member else "learner", "coords": mesh.coords,
            "device": str(mesh.device), "state": state, "metrics": metrics, "params": params,
            "launches": since(before)}
