"""Entry points of the PyTorch port, the twins of the repository's root
__graft_entry__.py:

  entry()                one engine step plus the policy forward on 256
                         werewolf rooms (the mlp net at hidden 128):
                         (fn, example_args)
  dryrun_multichip(n)    the full PPO train step over an n-rank ('data' x
                         'model') mesh, model 2 when n is even: rooms split
                         over 'data', the trunk over 'model'; run until whole
                         episodes finish, then 3 timed steps
  _scaling_curve(n)      env-steps/s of the scripted rollout and of the train
                         step over meshes of 1, 2, 4, ... ranks, strong (a
                         fixed global batch) and weak (a fixed batch a rank),
                         with each step's time split into unroll, update,
                         collectives and host waits

    python -m game_engine_tpu_torch.graft_entry [n] [--device cpu] [--backend gloo]

A device of the JAX mesh is a rank here: dryrun_multichip and the curve
start their ranks with parallel.launch.run_ranks (one torch thread each).
On "cuda" the default backend is NCCL with one card a rank (rank r on
cuda:r, bound before it joins the world; more ranks than cards raise);
ranks that share one card run with backend="gloo". Ranks that share a
card also share its time, so there the curve measures what sharding
costs, not a speed-up: the same reading the JAX curve gives on virtual CPU
devices that share one core.
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.parallel.launch import run_ranks
from game_engine_tpu_torch.parallel.mesh import default_backend

CURVE_COUNTS = (1, 2, 4, 8, 16)


@functools.lru_cache(maxsize=None)
def _lowered():
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower

    return lower(compile_game(load_builtin("werewolf")))


def entry(device=D.DEFAULT):
    """(fn, example_args): fn(state, params) -> (state, logits, value), one
    engine step with scripted actions and the policy forward, on a batch of
    256 werewolf rooms of 8 seats on `device` (the bots and the step: ST's
    launches on the card)."""
    from game_engine_tpu_torch.core.engine import bot_actions, engine_step
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.policies import net as N

    device = D.resolve(device)
    lowered = _lowered()
    cfg = N.NetConfig(hidden=128, layers=2)
    params = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(lowered),
                           N.action_space(lowered), cfg, device=device)

    @torch.no_grad()
    def fn(state, params):
        state, _ = engine_step(lowered, state, bot_actions(lowered, state))
        logits, value = N.apply_net(params, N.observe(lowered, state), cfg, lowered)
        return state, logits, value

    state = init_state(lowered, 256, 8, np.arange(256, dtype=np.uint32), device=device)
    return fn, (state, params)


def _config(device, horizon: int, net: dict, epochs: int = 4):
    """PPOConfig with run.py's kernel choice: the policy-net kernels on the
    card where they cover the net (K2 in the unroll, K4 in the update)."""
    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train.ppo import PPOConfig

    net_cfg = N.NetConfig(**net)
    fused = FZ.runs_on_card(_lowered(), net_cfg, device)
    return PPOConfig(horizon=horizon, epochs=epochs, fused_net=fused, net=net_cfg)


def _start(mesh, cfg, batch: int, seats: int):
    """Parameters (seed 0), Adam and the rooms of a mesh's rank."""
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.parallel.mesh import params_sharding, state_sharding
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train.ppo import make_optimizer

    lw = _lowered()
    full = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(lw), N.action_space(lw),
                         cfg.net, lw, device="cpu")
    params = params_sharding(mesh, full)
    state = state_sharding(mesh, init_state(lw, batch, seats, np.arange(batch, dtype=np.uint32),
                                            device=mesh.device))
    return params, make_optimizer(params, cfg), state


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _dryrun_rank(rank: int, spec: dict) -> dict:
    from game_engine_tpu_torch.parallel import parity
    from game_engine_tpu_torch.parallel.mesh import make_mesh
    from game_engine_tpu_torch.train.ppo import make_train_step

    before = parity.launches()
    mesh = make_mesh(spec["n"], spec["model"], backend=spec["backend"], device=spec["device"])
    cfg = _config(mesh.device, 8, {"hidden": 64, "layers": 2})
    params, opt, state = _start(mesh, cfg, spec["batch"], 5)
    step = make_train_step(_lowered(), cfg, mesh)
    gen = torch.Generator(mesh.device).manual_seed(42)
    episodes = steps_run = 0
    t_start = time.perf_counter()
    metrics = {}
    for _ in range(16):  # 16 x horizon-8 updates: plenty for 5-seat werewolf
        state, metrics = step(params, opt, state, gen)
        episodes += int(metrics["episodes"])
        steps_run += 1
        if rank == 0:
            print(f"dryrun_multichip: update {steps_run} done (episodes={episodes}, "
                  f"t={time.perf_counter() - t_start:.1f}s)", flush=True)
        if episodes > 0 and steps_run >= 2:
            break
    if episodes <= 0:
        raise AssertionError("no episode completed under the sharded program")
    timed = 3
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step(params, opt, state, gen)
        episodes += int(metrics["episodes"])
    elapsed = time.perf_counter() - t0
    out = {"mesh": mesh.shape, "coords": mesh.coords, "device": str(mesh.device),
           "backend": mesh.backend, "batch": spec["batch"], "train_steps": steps_run + timed,
           "loss": float(metrics["loss"]), "episodes": episodes,
           "env_steps_per_s": spec["batch"] * cfg.horizon * timed / max(elapsed, 1e-9),
           "launches": parity.since(before)}
    if spec["curve"] is not None:  # in the same world: no second start of the ranks
        try:
            out["curve"] = _curve_rank(rank, spec["curve"])
        except Exception as e:  # noqa: BLE001 — the curve is diagnostics
            out["curve"] = {"error": repr(e)}
    return out


def dryrun_multichip(n_devices: int, device=D.DEFAULT, backend=None, scaling=True) -> dict:
    """Full PPO training over an n-rank mesh: rooms split on 'data' (dp), the
    policy trunk on 'model' (tp, model 2 when n is even); the gradient sums
    and the trunk's activation collectives are explicit. Runs the train
    step until whole episodes complete (at least 2 updates), then times 3
    more. With `scaling` (True, or a dict of _scaling_curve's shape
    keywords), out["scaling"] holds the curve, measured by the same ranks
    after the dryrun, or {"error": ...} if it failed: the curve is
    diagnostics, the dryrun does not fail on it."""
    device = D.resolve(device)
    model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    batch = max(2 * n_devices, 8)
    curve = (_curve_spec(n_devices, device, backend,
                         **(scaling if isinstance(scaling, dict) else {})) if scaling else None)
    spec = {"n": n_devices, "model": model, "batch": batch, "device": device.type,
            "backend": backend, "curve": curve}
    print(f"dryrun_multichip: mesh data={n_devices // model} model={model} ranks={n_devices} "
          f"on {device.type} batch={batch} horizon=8", flush=True)
    ranks = run_ranks(_dryrun_rank, n_devices, spec, backend=backend, device=device)
    out = {k: ranks[0][k] for k in ("mesh", "backend", "batch", "train_steps", "loss",
                                     "episodes", "env_steps_per_s")}
    out["devices"] = [r["device"] for r in ranks]
    out["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    print(f"dryrun_multichip ok: mesh={out['mesh']} batch={batch} "
          f"train_steps={out['train_steps']} loss={out['loss']:.4f} "
          f"episodes={out['episodes']} env_steps_per_s={out['env_steps_per_s']:.1f}",
          flush=True)
    if curve is not None:
        errors = [r["curve"]["error"] for r in ranks if "error" in r["curve"]]
        out["scaling"] = ({"error": errors[0]} if errors
                          else _assemble_curve([r["curve"] for r in ranks], curve))
        print("SCALING:", json.dumps(out["scaling"]), flush=True)
    return out


def _measure(mesh, spec: dict, batch: int) -> dict:
    """One point of the curve on a mesh's rank: 3 scripted rollouts and
    spec["train_steps"] train steps after one of each to warm up, each group
    timed on the host between barriers of the mesh."""
    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.parallel import parity
    from game_engine_tpu_torch.train.ppo import make_train_step

    cfg = _config(mesh.device, spec["horizon"], spec["net"], spec["epochs"])
    params, opt, state = _start(mesh, cfg, batch, spec["seats"])
    eng = BatchedEngine(_lowered(), mesh.device)
    group = mesh.data_group
    roll, _ = eng.rollout(state, spec["roll_steps"])
    _sync(mesh)
    before = parity.launches()
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(3):
        roll, _ = eng.rollout(roll, spec["roll_steps"])
    _sync(mesh)
    dist.barrier(group=group)
    rt = time.perf_counter() - t0
    rollout_launches = parity.since(before)

    step = make_train_step(_lowered(), cfg, mesh)
    gen = torch.Generator(mesh.device).manual_seed(42)
    state, _ = step(params, opt, state, gen)
    _sync(mesh)
    before = parity.launches()
    mesh.timing = {}
    spans = {"unroll_ms": 0.0, "update_ms": 0.0}
    n = spec["train_steps"]
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(params, opt, state, gen)
        for k in spans:
            spans[k] += m[k] / n
    _sync(mesh)
    dist.barrier(group=group)
    tt = time.perf_counter() - t0
    timing, mesh.timing = mesh.timing, None
    return {"rollout": batch * spec["roll_steps"] * 3 / rt,
            "train": batch * cfg.horizon * n / tt, "step_ms": tt / n * 1e3, **spans,
            "collective_ms": timing.get("collective_ms", 0.0) / n,
            "host_wait_ms": timing.get("host_wait_ms", 0.0) / n,
            "collectives": timing.get("collectives", 0) / n,
            "fused_net": cfg.fused_net,
            "launches": {"rollout": rollout_launches, "train": parity.since(before)}}


def _curve_rank(rank: int, spec: dict) -> dict:
    """This rank's points of the curve: {(d, series): point} for each mesh
    of the first d ranks that holds it."""
    from game_engine_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for d in spec["counts"]:
        mesh = make_mesh(d, 1, backend=spec["backend"], device=spec["device"])
        for series, batch in (("strong", spec["global_batch"]), ("weak", spec["per_rank"] * d)):
            if series == "weak" and batch == spec["global_batch"]:
                continue  # the series meet at the top count
            if mesh.member:
                out[f"{d}/{series}"] = _measure(mesh, spec, batch)
    return out


def _curve_spec(max_devices: int, device, backend=None, per_rank: int = 32,
                global_batch=None, horizon: int = 8, roll_steps: int = 32, epochs: int = 4,
                net=None, seats: int = 5, train_steps: int = 3) -> dict:
    counts = [d for d in CURVE_COUNTS if d <= max_devices]
    return {"counts": counts, "per_rank": per_rank,
            "global_batch": global_batch or per_rank * counts[-1], "horizon": horizon,
            "roll_steps": roll_steps, "epochs": epochs, "seats": seats,
            "train_steps": train_steps, "net": net or {"hidden": 64, "layers": 2},
            "device": torch.device(device).type, "backend": backend or default_backend(device)}


def _scaling_curve(max_devices: int, device=D.DEFAULT, backend=None, **shape) -> dict:
    """Env-steps/s of the scripted rollout and of the PPO train step over
    meshes of the first 1, 2, 4, ... (up to max_devices) ranks of one
    world, pure dp (model 1): strong at a fixed global batch (per_rank x
    the top count unless global_batch is given), weak at per_rank rooms a
    rank; each point times 3 rollouts of roll_steps steps and train_steps
    train steps (shape keywords: per_rank 32, global_batch, horizon 8,
    roll_steps 32, epochs 4, net mlp at hidden 64, seats 5, train_steps 3).
    Each point also holds the train step's split (means over the mesh's
    ranks, ms a step): unroll_ms and update_ms on the card's clock (CUDA
    events; the host's on the CPU), collective_ms, the host's time inside
    the collectives, and host_wait_ms, its time waiting for the card's
    queued work before each collective. The rates come from rank 0's host
    clock between barriers, so they are the slowest rank's."""
    device = D.resolve(device)
    spec = _curve_spec(max_devices, device, backend, **shape)
    ranks = run_ranks(_curve_rank, spec["counts"][-1], spec, backend=spec["backend"],
                      device=device)
    return _assemble_curve(ranks, spec)


def _assemble_curve(ranks: list, spec: dict) -> dict:
    """The curve from every rank's points (_curve_rank's results)."""
    counts = spec["counts"]
    curve = {"global_batch": spec["global_batch"], "per_device_batch": spec["per_rank"],
             "devices": counts, "horizon": spec["horizon"], "roll_steps": spec["roll_steps"],
             "net": spec["net"], "rollout": {}, "train": {}, "rollout_weak": {},
             "train_weak": {}, "split": {}, "split_weak": {},
             "launches": {"rollout": 0, "train": {}}}
    for d in counts:
        for series in ("strong", "weak"):
            key = f"{d}/{series}"
            if key not in ranks[0]:
                continue
            points = [r[key] for r in ranks if key in r]
            sfx = "" if series == "strong" else "_weak"
            curve["rollout" + sfx][str(d)] = ranks[0][key]["rollout"]
            curve["train" + sfx][str(d)] = ranks[0][key]["train"]
            curve["split" + sfx][str(d)] = {
                k: float(np.mean([p[k] for p in points]))
                for k in ("step_ms", "unroll_ms", "update_ms", "collective_ms", "host_wait_ms",
                          "collectives")}
            for p in points:
                curve["launches"]["rollout"] += p["launches"]["rollout"]["rollout"]
                for k, v in p["launches"]["train"].items():
                    curve["launches"]["train"][k] = curve["launches"]["train"].get(k, 0) + v
    top = str(counts[-1])  # where the series meet, the weak one was not run again
    for k in ("rollout", "train", "split"):
        curve[k + "_weak"].setdefault(top, curve[k][top])
    curve["fused_net"] = bool(ranks[0][f"{counts[0]}/strong"]["fused_net"])
    curve["backend"] = spec["backend"]
    curve["note"] = (f"ranks on {spec['device']} over {spec['backend']}; strong series "
                     f"(global batch {spec['global_batch']}) flat == no sharding overhead; "
                     f"weak series ({spec['per_rank']} rooms a rank) flat == linear dp "
                     "scaling, where every rank has a device of its own; ranks that share "
                     "one device share its time, so there the curve measures overhead. "
                     "collective_ms is the host's time inside each collective between two "
                     "synchronisations of the card: over NCCL it includes the NCCL "
                     "kernels' time and the wait for the group's last rank to arrive")
    for d in counts:
        if str(d) in curve["rollout"]:
            print(f"scaling: d={d} strong(roll={curve['rollout'][str(d)]:.1f}, "
                  f"train={curve['train'][str(d)]:.1f}) env-steps/s", flush=True)
    return curve


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks (default: the cards on cuda, 1 on the CPU)")
    ap.add_argument("--device", default=D.DEFAULT, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl (the default on cuda: one card a rank) or gloo")
    args = ap.parse_args(argv)
    device = D.resolve(args.device)
    fn, fargs = entry(device)
    state, logits, value = fn(*fargs)
    print("entry ok:", tuple(logits.shape), tuple(value.shape), flush=True)
    n = args.n or (torch.cuda.device_count() if device.type == "cuda" else 1)
    dryrun_multichip(n, device=device, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
