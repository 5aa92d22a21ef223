"""Traffic kind `rollout`: the scripted batched rollout, closed loop.

`BatchedEngine.rollout(state, steps_per_call)` back to back on `rooms`
rooms of the configuration's seats, with auto-reset; each call ends by
reading its episode count, which synchronises. The window's work is
rooms x steps_per_call a call, over every call that ended in it.

The check (reference: portbench/reference/engine.py, on the card after
the window) follows the program from the seed's own rooms: the fresh
rooms and the warm-up call from the reference's own start, then one
window call drawn from the seed from the state the program handed that
call, every field exactly: every room of the window call, one room in
CHECK_SHARE (drawn from the seed) of the warm-up; and each call's episode
count against the restarts its rooms record.
"""

from __future__ import annotations

import os
import random

import torch

from portbench import harness
from portbench.harness import Check, Run, now

CHECK_SHARE = 16   # the check follows one warm-up room in 16, drawn from the seed
MAX_RESETS = 4096  # more restarts than a call of any cell can make


def _program(config: dict, device: str):
    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_game_spec
    from game_engine_tpu_torch.gamespec.tables import lower

    from portbench.spec import ROOT

    lowered = lower(compile_game(load_game_spec(os.path.join(ROOT, config["game_file"]))))
    return BatchedEngine(lowered, device)


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda") -> Run:
    w, cfg = cell.workload, cell.config
    rooms, steps = int(w["rooms"]), int(w["steps_per_call"])
    eng = _program(cfg, device)
    seeds = harness.room_seeds(seed, rooms)
    start = eng.init(rooms, cfg["seats"], seeds)
    warm_out, eps = eng.rollout(start, steps)  # the warm-up call: the window's one shape
    warm_eps = int(eps)
    state = warm_out
    setup_s = now() - t0

    pick = random.Random(seed)
    sampled = None                      # (index, input, output, episodes) of one call
    calls_ms, traced, tracer = [], {}, None
    trace_from = int(w["trace_after_calls"])
    t_start = now()
    while True:
        i = len(calls_ms)
        if trace and i == trace_from:
            tracer = harness.Tracer().__enter__()
        a = now()
        prev = state
        state, eps = eng.rollout(state, steps)
        n_eps = int(eps)
        b = now()
        calls_ms.append((b - a) * 1e3)
        if pick.random() * (i + 1) < 1.0:   # a uniform sample of the window's calls
            sampled = (i, prev, state, n_eps)
        if tracer is not None and i + 1 == trace_from + int(w["trace_calls"]):
            tracer.__exit__(None, None, None)
            traced = {"calls": int(w["trace_calls"])}
            tracer_done, tracer = tracer, None
        if b - t_start >= seconds and (not trace or traced):
            break
    window_s = b - t_start
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    del prev, state
    t_check = now()
    checks = check(cfg, rooms, steps, seeds, start, warm_out, warm_eps, sampled, device, seed)
    check_s = now() - t_check
    return Run(setup_s=setup_s, window_s=window_s, work=len(calls_ms) * rooms * steps,
               attempted=len(calls_ms), failed=0, memory_peak_bytes=peak, checks=checks,
               check_s=check_s, calls_ms=calls_ms, traced=traced,
               trace=tracer_done.trace if trace else None)


def _rooms(state, idx):
    from portbench.reference.state import GameState

    return GameState(*(x[idx.to(x.device)] for x in state))


def restarts(before, after) -> int:
    """The restarts that took each room's seed from `before` to `after`
    (a restart bumps it, reset_where_done: splitmix32(seed ^ 0xDECAF000),
    and nothing else moves it), summed over the rooms: the episodes that
    ended, by the rooms' own record."""
    from portbench.reference.step import splitmix32

    s, goal = before.seed.clone(), after.seed.to(before.seed.device)
    n = torch.zeros_like(s)
    for _ in range(MAX_RESETS):
        left = s != goal
        if not bool(left.any()):
            return int(n.sum())
        s = torch.where(left, splitmix32(s ^ 0xDECAF000), s)
        n += left.to(n.dtype)
    raise ValueError("a room's seed is not reached by restarts")


def reference_rollout(lowered, state, calls: int, steps: int, auto_reset: bool = True):
    """The plain rollout, `calls` x `steps` steps -> (state, episodes)."""
    from portbench.reference.engine import make_rollout

    roll = make_rollout(lowered, steps, auto_reset)
    total = 0
    for _ in range(calls):
        state, eps = roll(state)
        total += int(eps)
    return state, total


def check(cfg: dict, rooms: int, steps: int, seeds, start, warm_out, warm_eps: int, sampled,
          device: str, seed: int) -> list:
    """The program's fresh rooms, its warm-up call (on one room in
    CHECK_SHARE, drawn from the seed: the rooms are independent) and one
    window call (every room) against the reference; each call's episode
    count against the restarts that the rooms record. Every number is exact
    (limit 0)."""
    from portbench.compare import words_differing
    from portbench.reference import lower_game
    from portbench.reference.state import GameState, init_state

    lowered = lower_game(cfg["game_file"])
    ref_start = init_state(lowered, rooms, cfg["seats"], seeds, device=device)
    start_words = words_differing(ref_start, start)
    gen = torch.Generator().manual_seed(harness.stream_seed(seed, 3))
    idx = torch.randperm(rooms, generator=gen)[:max(1, rooms // CHECK_SHARE)].sort().values
    _, given, out, eps = sampled
    # the sampled call from the state the program gave it, and the warm-up of
    # the sampled rooms from the reference's own start, as one batch of rooms
    given = GameState(*(x.to(device) for x in given))
    both = GameState(*(torch.cat([a, b]) for a, b in zip(given, _rooms(ref_start, idx))))
    ref_both, _ = reference_rollout(lowered, both, 1, steps)
    ref_out = _rooms(ref_both, torch.arange(rooms))
    ref_warm = _rooms(ref_both, torch.arange(rooms, rooms + len(idx)))
    start_words += words_differing(ref_warm, _rooms(warm_out, idx))
    eps_gap = abs(restarts(given, ref_out) - eps) + abs(restarts(start, warm_out) - warm_eps)
    return [Check("start_words_differing", start_words, 0),
            Check("call_words_differing", words_differing(ref_out, out), 0),
            Check("episodes_gap", eps_gap, 0)]
