"""Headline benchmark of the port: env steps/s of the batched werewolf
rollout on one NVIDIA GPU, through the CUDA rollout kernel.

    python -m game_engine_tpu_torch.bench [rooms=4096] [steps=1024] [iters=16]

Prints one JSON line with the keys of the JAX package's bench.py:
  {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N,
   "detail": {"hard_sync_steps_per_s": ..., "episodes_completed": ...,
              "device": ..., ...}}
vs_baseline is against BASELINE.json's 1,000,000 env-steps/s target. Exits 2
when no CUDA device is present: the measurement never falls back to the CPU.
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


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device: this benchmark runs on the GPU only"}),
              file=sys.stderr)
        return 2
    from game_engine_tpu.gamespec.compile import compile_game
    from game_engine_tpu.gamespec.parser import load_builtin
    from game_engine_tpu.gamespec.tables import lower
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
