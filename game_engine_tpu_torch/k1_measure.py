"""Measurements of the rollout kernel (K1) on one NVIDIA GPU, beyond what
chip_smoke.py checks: where a step's cycles go and what a block size does
(this checkout against another: ab_measure.py rollout).

    python -m game_engine_tpu_torch.k1_measure

One JSON line each (werewolf, 8 seats, 1024 steps a call, 4096 and 65,536
rooms; every time is the mean of 3 calls after a warm-up, by CUDA events):

  env       the GPU's name and power limit and its int32 rate
  ptxas     the kernel's registers, stack and spills
  block     the kernel at 32 to 512 lanes a block: the launch's plan (lanes
            a room, dynamic shared memory, blocks and warps an SM holds)
            and ms at both sizes
  rooms     the kernel at 1024 to 65,536 rooms, with the lanes a room the
            launch chose
  sections  the -DGE_PROFILE build at 4096 rooms: the share of a lane's
            clock64() cycles by section of the step (bots, acceptance and
            records, branch conditions, reset, each effect program)
  ops       the -DGE_COUNT host build over the first call's 4096 rooms: the
            interpreter's least integer operations, and the time the card's
            int32 lanes need for them
  games     ms of 4096 rooms x 1024 steps for a few catalog games, with the
            words a lane holds and the launch's plan

Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import sys

STEPS = 1024
SIZES = (4096, 65536)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(lib, lowered, state, threads: int, reps: int = 3) -> float:
    import torch

    from game_engine_tpu_torch.core import rollout_kernel as RK

    def call(st):
        arrs, _ = RK._launch(lib, lowered, st, STEPS, True, threads)
        return RK.from_minor(arrs)

    state = call(state)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        state = call(state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas(lib) -> list:
    from game_engine_tpu_torch import _build

    return [ln.strip() for ln in _build.build_log(lib).splitlines()
            if "registers" in ln or "stack frame" in ln]


def main(argv: list) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_measure: no CUDA device", file=sys.stderr)
        return 2
    from game_engine_tpu_torch import _build
    from game_engine_tpu_torch.bench import gpu_line, int32_ops_per_s
    from game_engine_tpu_torch.core import rollout_kernel as RK
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.gamespec.compile import GameConfig, compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower

    gpu = gpu_line()
    rate = int32_ops_per_s()
    emit({"line": "env", "gpu": gpu, "int32_ops_per_s": rate})

    ww = lower(compile_game(load_builtin("werewolf")))
    starts = {B: init_state(ww, B, 8, np.arange(B, dtype=np.uint32), device="cuda")
              for B in (1024,) + SIZES[:1] + (16384,) + SIZES[1:]}

    lib = _build.cuda_lib()
    emit({"line": "ptxas", "ptxas": ptxas(lib)})
    for threads in (32, 64, 128, 256, 512):
        emit({"line": "block", "plan": {B: RK.launch_plan(ww, B, threads) for B in SIZES},
              "ms": {B: time_ms(lib, ww, starts[B], threads) for B in SIZES}, "gpu": gpu})

    for B, st in starts.items():
        emit({"line": "rooms", "rooms": B, **RK.launch_plan(ww, B),
              "ms": time_ms(lib, ww, st, 128), "gpu": gpu})

    cycles = RK.profile_rollout(ww, starts[SIZES[0]], STEPS)
    total = sum(cycles.values())
    emit({"line": "sections", "rooms": SIZES[0], "steps": STEPS,
          "cycles_per_room_step": total / (SIZES[0] * STEPS),
          "share": {k: v / total for k, v in sorted(cycles.items(), key=lambda kv: -kv[1])},
          "gpu": gpu})

    counts = RK.count_rollout(ww, init_state(ww, SIZES[0], 8, np.arange(SIZES[0], dtype=np.uint32),
                                             device="cpu"), STEPS)
    emit({"line": "ops", "rooms": SIZES[0], "steps": STEPS, **counts,
          "int_ops_per_room_step": counts["int_ops"] / (SIZES[0] * STEPS),
          "bound_ms": counts["int_ops"] / rate * 1e3, "gpu": gpu})

    for name, cfg, seats in (("werewolf", None, 8), ("two-truths-and-a-lie", GameConfig(), 4),
                             ("harbor-lots", None, 5), ("relic-draft", None, 8),
                             ("werewolf", GameConfig(max_players=12), 12),
                             ("werewolf", GameConfig(max_players=20), 20)):
        lw = lower(compile_game(load_builtin(name), cfg))
        st = init_state(lw, SIZES[0], seats, np.arange(SIZES[0], dtype=np.uint32), device="cuda")
        emit({"line": "games", "game": name, "P": lw.P, "seats": seats, "rooms": SIZES[0],
              "steps": STEPS, "words_per_lane": RK.block_size(lw)["words_per_lane"],
              **RK.launch_plan(lw, SIZES[0]), "ms": time_ms(lib, lw, st, 128), "gpu": gpu})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
