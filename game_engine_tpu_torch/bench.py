"""Headline benchmark of the port: env steps/s of the batched werewolf
rollout on one NVIDIA GPU, through the CUDA rollout kernel.

    python -m game_engine_tpu_torch.bench [rooms=4096] [steps=1024] [iters=16]
    python -m game_engine_tpu_torch.bench --policy [rooms=16384] [steps=128] [iters=4]

Prints one JSON line with the keys of the JAX package's bench.py:
  {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N,
   "detail": {"hard_sync_steps_per_s": ..., "episodes_completed": ...,
              "device": ..., ...}}
vs_baseline is against BASELINE.json's 1,000,000 env-steps/s target.
--policy measures the learned-policy self-play loop instead (the twin of
the root bench.py's policy_rollout_bench): observe, the mlp net's forward,
legal-masked sampling, the engine step and a reset where done, eager torch
a step (no kernel: the JAX loop runs these outside any Pallas kernel too).
Exits 2 when no CUDA device is present: the measurement never falls back to
the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def gpu_line() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi prints them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


INT32_LANES_PER_SM = 64  # int32 ALU lanes of one Hopper SM, an operation a clock each


def int32_ops_per_s() -> float:
    """The first GPU's int32 rate: SMs x 64 lanes x the top SM clock
    nvidia-smi reports."""
    import torch

    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(proc.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * INT32_LANES_PER_SM * mhz * 1e6


POLICY_SEED = 7  # the sampling generator's seed (jax.random.PRNGKey(7) in the JAX loop)


def policy_steps(lowered, params, cfg, state, n_steps: int, generator=None, gumbel=None):
    """n_steps of the learned-policy self-play loop -> (state, episodes, an
    int64 scalar tensor): each step observes, runs the net, samples legal
    actions (argmax of logits + Gumbel noise, jax.random.categorical's
    draw), keeps the actors' (actor_mask), steps the engine, counts fresh
    completions (nxt.done & ~st.done) and restarts the rooms that are done
    (on the card: OB, the forward, SA, then ST's step_reset, one launch for
    the step and the restart). The
    noise is gumbel[t] at step t when given (JAX's own draws in a test),
    else drawn from `generator`."""
    import torch

    from game_engine_tpu_torch.core.engine import step_and_reset
    from game_engine_tpu_torch.policies import net as N

    episodes = torch.zeros((), dtype=torch.int64, device=state.present.device)
    spare = None
    with torch.no_grad():
        for t in range(n_steps):
            obs, legal, am = N.observe_all(lowered, state)
            actions, _, _, _ = N.sample_actions(lowered, params, state, cfg, obs=obs,
                                                generator=generator, legal=legal, actor=am,
                                                gumbel=None if gumbel is None else gumbel[t])
            nxt = step_and_reset(lowered, state, actions, out=spare)
            episodes = episodes + nxt.ended.sum()
            spare, state = (state if t else None), nxt.state
    return state, episodes


def policy_rollout_bench(batch: int, inner_steps: int, iters: int) -> dict:
    """The root bench.py's policy_rollout_bench on the card: werewolf, 8
    seats, seeds arange(batch), NetConfig(hidden=256, layers=2) (the mlp),
    `iters` timed calls of `inner_steps` steps after one warm-up call."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.policies import net as N

    lowered = lower(compile_game(load_builtin("werewolf")))
    cfg = N.NetConfig(hidden=256, layers=2)
    params = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(lowered),
                           N.action_space(lowered), cfg, lowered, device="cuda")
    state = init_state(lowered, batch, 8, np.arange(batch, dtype=np.uint32), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(POLICY_SEED)
    state, eps = policy_steps(lowered, params, cfg, state, inner_steps, gen)
    int(eps)
    t0 = time.perf_counter()
    total = 0
    for _ in range(iters):
        state, eps = policy_steps(lowered, params, cfg, state, inner_steps, gen)
        total += int(eps)  # synchronises
    dt = time.perf_counter() - t0
    steps = batch * inner_steps * iters
    return {
        "metric": "policy_env_steps_per_sec_per_chip_werewolf",
        "value": steps / dt,
        "unit": "steps/s",
        "vs_baseline": steps / dt / 1_000_000,
        "detail": {"batch_rooms": batch, "inner_steps": inner_steps, "iters": iters,
                   "wall_s": dt, "episodes_completed": total, "hidden": cfg.hidden,
                   "arch": cfg.arch, "device": torch.cuda.get_device_name(0),
                   "gpu": gpu_line()},
    }


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device: this benchmark runs on the GPU only"}),
              file=sys.stderr)
        return 2
    if argv[:1] == ["--policy"]:
        argv = argv[1:]
        print(json.dumps(policy_rollout_bench(int(argv[0]) if len(argv) > 0 else 16384,
                                              int(argv[1]) if len(argv) > 1 else 128,
                                              int(argv[2]) if len(argv) > 2 else 4)))
        return 0
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.core.engine import BatchedEngine

    batch = int(argv[0]) if len(argv) > 0 else 4096
    inner_steps = int(argv[1]) if len(argv) > 1 else 1024
    iters = int(argv[2]) if len(argv) > 2 else 16

    lowered = lower(compile_game(load_builtin("werewolf")))
    eng = BatchedEngine(lowered, "cuda")
    state = eng.init(batch, 8, np.arange(batch, dtype=np.uint32))

    # warmup: builds the kernel on first use
    state, eps = eng.rollout(state, inner_steps)
    torch.cuda.synchronize()

    # hard sync after every call
    eps_all = []
    durations = []
    for _ in range(iters):
        t0 = time.perf_counter()
        state, eps = eng.rollout(state, inner_steps)
        torch.cuda.synchronize()
        durations.append(time.perf_counter() - t0)
        eps_all.append(eps)
    durations.sort()
    med = durations[len(durations) // 2]
    steps_per_iter = batch * inner_steps
    sps_sync = steps_per_iter / med

    # headline: calls queued back to back on the stream, one sync per group
    groups, iters_per_group = 4, max(4, iters // 2)
    group_rates = []
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(iters_per_group):
            state, eps = eng.rollout(state, inner_steps)
            eps_all.append(eps)
        torch.cuda.synchronize()
        group_rates.append(steps_per_iter * iters_per_group / (time.perf_counter() - t0))
    group_rates.sort()
    sps = group_rates[len(group_rates) // 2]
    print(json.dumps({
        "metric": f"env_steps_per_sec_per_gpu_werewolf_{batch}rooms",
        "value": sps,
        "unit": "steps/s",
        "vs_baseline": sps / 1_000_000,
        "detail": {
            "batch_rooms": batch,
            "inner_steps": inner_steps,
            "iters": iters,
            "pipelined_groups": groups,
            "iters_per_group": iters_per_group,
            "hard_sync_steps_per_s": sps_sync,
            "hard_sync_median_iter_s": med,
            "hard_sync_wall_s": sum(durations),
            "episodes_completed": int(torch.stack(eps_all).sum()),
            "device": torch.cuda.get_device_name(0),
            "gpu": gpu_line(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
