"""Count a rollout cell's integer operations a room-step, once.

    python3 -m portbench.count_ops <workload> [--seeds 0-11]

Runs the cell's rooms (the same room seeds as the benchmark draws) on the
host through the port's -DGE_COUNT build of the rollout kernel's body:
one call of the cell's steps from the fresh rooms uncounted, then the
next call counted, as a window's calls come after the warm-up. Prints one
JSON line a seed and then the summary that the configuration file keeps
as `ops_per_room_step` (the mean, the spread over seeds, the tree it was
counted at). The harness never counts: a change to the interpreter must
not move its own yardstick.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys

PROCS = 4  # worker processes, one seed each at a time


def count_seed(args) -> dict:
    workload, seed = args
    import torch

    from game_engine_tpu_torch.core.rollout_kernel import count_rollout, host_rollout
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_game_spec
    from game_engine_tpu_torch.gamespec.tables import lower

    from portbench import harness, spec

    torch.set_num_threads(1)
    cell = spec.cell(workload)
    cfg, w = cell.config, cell.workload
    lowered = lower(compile_game(load_game_spec(os.path.join(spec.ROOT, cfg["game_file"]))))
    rooms, steps = int(w["rooms"]), int(w["steps_per_call"])
    state = init_state(lowered, rooms, cfg["seats"], harness.room_seeds(seed, rooms), device="cpu")
    state, _ = host_rollout(lowered, state, steps)  # the warm-up call
    counts = count_rollout(lowered, state, steps)
    return {"seed": seed, "ops_per_room_step": counts["int_ops"] / (rooms * steps), **counts}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench.count_ops")
    ap.add_argument("workload")
    ap.add_argument("--seeds", default="0-11")
    a = ap.parse_args(argv)
    lo, hi = (int(x) for x in a.seeds.split("-"))
    seeds = list(range(lo, hi + 1))
    with multiprocessing.get_context("spawn").Pool(PROCS) as pool:
        rows = pool.map(count_seed, [(a.workload, s) for s in seeds])
    for r in rows:
        print(json.dumps(r))
    vals = [r["ops_per_room_step"] for r in rows]
    commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                            check=False).stdout.strip() or "unknown"
    print(json.dumps({"value": sum(vals) / len(vals), "min": min(vals), "max": max(vals),
                      "spread": (max(vals) - min(vals)) / (sum(vals) / len(vals)),
                      "seeds": a.seeds, "commit": commit}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
