"""The controls that `correct` has to fail, read at a cell's own size.

    python3 -m portbench.control --workload <name> --seeds 11,12,13 [--modes fp8,half,altered]

Runs on the card. Each control is the reference put in the program's
place and judged by the driver's own check, under the cell's limits, as a
benchmark run is. For a train cell: `fp8`, the reference
learner with every cast point of the net in float8 e4m3 (the nearest
precision below the configuration's bf16); `half`, the update over half
of the rooms with the mean taken over the rest; `altered`, one actor's
action moved to another legal choice where it is drawn. For a rollout
cell, whose engine states no precision: `no_reset`, the scripted rollout
with the auto-reset the configuration guarantees switched off. Prints one
JSON line a seed and control: `correct` as a run would give it, and every
number the check compares; the numbers that no limit holds go to standard
error, as in a run. The benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness, spec
from portbench.yardstick import net_dims


def train_control(cell, seed: int, mode: str, device) -> list:
    """The check of the reference learner in `mode` in the program's place."""
    from portbench.reference import lower_game
    from portbench.reference.state import init_state
    from portbench.reference.train import RefPPO

    drv = spec.load_module("drivers", "train")
    cfg, w = cell.config, cell.workload
    rooms = int(w["rooms"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lowered = lower_game(cfg["game_file"])
    d = net_dims(cfg)
    params0 = drv.init_weights(d, harness.stream_seed(seed, 0), device)
    state = init_state(lowered, rooms, cfg["seats"], harness.room_seeds(seed, rooms),
                       device=device)
    start = [x.cpu() for x in state]
    learner = RefPPO(lowered, d, cfg["ppo"], params0, harness.stream_seed(seed, 1), device,
                     precision="fp8" if mode == "fp8" else "bf16",
                     fault=None if mode == "fp8" else mode)
    recorded, losses, grad1 = [], [], None
    for _ in range(int(w["checked_steps"])):
        out, _ = learner.step(state)
        state = type(state)(*out.state)
        recorded.append(([getattr(out, k).cpu() for k in (
            "obs", "actions", "logp", "value", "reward", "done", "mask", "legal")],
            [x.cpu() for x in out.state]))
        losses.append(list(out.losses))
        if grad1 is None:
            grad1, terms1 = {k: v.cpu() for k, v in out.grad1.items()}, out.terms1
    program = {"start": start, "recorded": recorded, "losses": losses, "terms1": terms1,
               "grad1": grad1,
               "params": {k: v.detach().cpu() for k, v in learner.params.items()}}
    del learner
    return drv.check(cell, seed, {k: v.cpu() for k, v in params0.items()}, program, device)


def rollout_control(cell, seed: int, mode: str, device) -> list:
    """The rollout check of the plain rollout without auto-reset in the
    program's place (one warm-up call and one window call)."""
    from portbench.reference import lower_game
    from portbench.reference.state import init_state

    if mode != "no_reset":
        raise ValueError(f"no rollout control {mode!r}")
    drv = spec.load_module("drivers", "rollout")
    cfg, w = cell.config, cell.workload
    rooms, steps = int(w["rooms"]), int(w["steps_per_call"])
    lowered = lower_game(cfg["game_file"])
    seeds = harness.room_seeds(seed, rooms)
    start = init_state(lowered, rooms, cfg["seats"], seeds, device=device)
    warm_out, warm_eps = drv.reference_rollout(lowered, start, 1, steps, auto_reset=False)
    out, eps = drv.reference_rollout(lowered, warm_out, 1, steps, auto_reset=False)
    return drv.check(cfg, rooms, steps, seeds, start, warm_out, warm_eps,
                     (0, warm_out, out, eps), device, seed)


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default=None)
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload)
    train = cell.traffic == "train"
    modes = (a.modes or ("fp8,half,altered" if train else "no_reset")).split(",")
    for seed in (int(s) for s in a.seeds.split(",")):
        for mode in modes:
            t = harness.now()
            checks = (train_control if train else rollout_control)(cell, seed, mode, "cuda")
            print(json.dumps({"workload": a.workload, "seed": seed, "control": mode,
                              "seconds": harness.now() - t,
                              "correct": all(c.ok for c in checks),
                              **{c.name: c.value for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
