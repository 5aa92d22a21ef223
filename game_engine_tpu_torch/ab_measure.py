"""This checkout's kernels against another checkout's on the same NVIDIA
GPU: K1 (rollout), S (search), K2-K4 (policy), SA (sample) or the paths
that step rooms a turn at a time (steps), each checkout measured in its own
process in the order other, this, this, other.

    python -m game_engine_tpu_torch.ab_measure {rollout,search,policy,sample,steps} [--other DIR]

DIR is another checkout of the repository, such as `git archive` of the
parent commit unpacked; without it only this checkout is measured. Each
process runs this file with DIR's (or this checkout's) package on its path,
so DIR needs no copy of this module. One JSON line each, every line with the
GPU's name and power limit:

  env       the GPU and the torch version
  ptxas     the kernels' library of the checkout: registers, stack, spills
  rollout   werewolf, 8 seats, 1024 steps at 4096 and 65,536 rooms through
            the checkout's `bench` module (median of 5 hard-synced calls),
            and at 4096 rooms the cycles of each step section by the
            -DGE_PROFILE build (profile_rollout)
  search    S at D = 0, 32 rollouts x 200 steps, on the first of 8192 live
            werewolf rooms of 6 players (depths 3, 7, 11 and 15 of a
            scripted rollout) that hold 1, 8, 64, 512 and 4096 waiting
            seats: the host ms of SearchBots.actions_for_slots and the
            decide and request kernels' ms on the same decisions
  policy    K2 (kernel_forward) and K3 (kernel_grads, seeded dl and dv) on
            32,768 rows, K4 (kernel_loss_grads) on 131,072: the attn
            checkpoint docs/checkpoints/attn_werewolf_u120.npz at hidden 256
            on 4096 werewolf rooms of 6 players in 8 seats, 4 steps of a
            scripted rollout
  sample    SA (kernel_sample with the actor mask) on OB's masks of
            werewolf rooms after 200 scripted steps (4 rooms of 8 as the
            floor, 4096, 16,384 and 65,536 of 8, 4096 of 6), f32 logits and
            uniforms from a seed: the device ms of one call queued behind a
            sleep kernel (CUDA events, median of 5) in the "uniform" mode
            and, on the same numbers taken as Gumbel noise, the "gumbel"
            mode (no logf), and the wrapper's host us a call (median of 20,
            no sync)
  steps     the paths that step rooms a turn at a time (ST, OB and SA
            move them): train steps at the learner's shape
            (make_train_step, 4096 werewolf rooms of 6, horizon 32, 4
            epochs, the attn checkpoint through K2 and K4; TRAIN_STEPS
            steps after a warm-up: unroll and update ms by the step's CUDA
            events, and the step's host seconds), the policy loop
            (bench.policy_rollout_bench: 16,384 rooms x 128 steps,
            LOOP_CALLS calls of one timed call each) and matchup pairs
            (evaluate.make_vs, 1024 rooms x 64 steps, the checkpoint
            against itself through K2; MATCHUP_PAIRS pairs after a warm-up;
            host ms); each with its median and its every value

Device times are medians of 5 calls after a warm-up, by CUDA events. Exits
2 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    del sys.path[0]  # run as a file (--child): the package's modules are not top-level names
KINDS = ("rollout", "search", "policy", "sample", "steps")
K1_ROOMS, K1_STEPS = (4096, 65536), 1024
S_SIZES, S_R, S_H = (1, 8, 64, 512, 4096), 32, 200
CKPT = "docs/checkpoints/attn_werewolf_u120.npz"
K2_ROOMS, K2_PLAYERS, K2_STEPS = 4096, 6, 4
TRAIN_STEPS, LOOP_CALLS, MATCHUP_PAIRS = 8, 5, 6  # the steps kind's spreads
SA_SIZES = ((4, 8), (4096, 8), (16384, 8), (65536, 8), (4096, 6))  # werewolf rooms, seats
SLEEP_CYCLES = 1_980_000  # torch.cuda._sleep's cycles of 1 ms at the H100's top SM clock


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def ptxas(lib) -> list:
    from game_engine_tpu_torch import _build

    return [ln.strip() for ln in _build.build_log(lib).splitlines()
            if "registers" in ln or "stack frame" in ln or "entry function" in ln]


def werewolf():
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower

    return lower(compile_game(load_builtin("werewolf")))


def rollout(label: str) -> None:
    import numpy as np

    from game_engine_tpu_torch import _build
    from game_engine_tpu_torch.core import rollout_kernel as RK
    from game_engine_tpu_torch.core.state import init_state

    emit({"line": "ptxas", "checkout": label, "report": ptxas(_build.cuda_lib())})
    ww = werewolf()
    B = K1_ROOMS[0]
    cycles = RK.profile_rollout(ww, init_state(ww, B, 8, np.arange(B, dtype=np.uint32),
                                               device="cuda"), K1_STEPS)
    emit({"line": "rollout_sections", "checkout": label, "rooms": B, "steps": K1_STEPS,
          "cycles_per_room_step": {k: v / (B * K1_STEPS) for k, v in
                                   sorted(cycles.items(), key=lambda kv: -kv[1])}})
    for rooms in K1_ROOMS:
        out = subprocess.run([sys.executable, "-m", "game_engine_tpu_torch.bench", str(rooms),
                              str(K1_STEPS), "5"], capture_output=True, text=True,
                             timeout=900, check=True)
        detail = json.loads(out.stdout.strip().splitlines()[-1])["detail"]
        emit({"line": "rollout", "checkout": label, "rooms": rooms,
              "ms": detail["hard_sync_median_iter_s"] * 1e3,
              "env_steps_per_s": detail["hard_sync_steps_per_s"]})


def search(label: str) -> None:
    import time

    import numpy as np
    import torch

    from game_engine_tpu_torch import _build
    from game_engine_tpu_torch.core import search_kernel as SK
    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.core.state import GameState
    from game_engine_tpu_torch.core.step import waiting_seats
    from game_engine_tpu_torch.policies.search import SearchBots

    emit({"line": "ptxas", "checkout": label, "report": ptxas(_build.search_lib())})
    lw = werewolf()
    eng = BatchedEngine(lw, "cuda")
    parts = []
    for k, depth in enumerate((3, 7, 11, 15)):
        st = eng.init(2048, 6, np.arange(2048, dtype=np.uint32) + 4096 * k)
        for _ in range(depth):
            st = eng.step(st, eng.bot_actions(st))
        parts.append(st)
    pool = GameState(*(torch.cat(f) for f in zip(*parts)))
    cum = np.cumsum(waiting_seats(lw, pool).sum(1).cpu().numpy())
    sb = SearchBots(lw, S_R, S_H, device="cuda")
    for size in S_SIZES:
        slots = list(range(int(np.searchsorted(cum, size)) + 1))
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            sb.actions_for_slots(pool, slots)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        sb.request_actions(pool, slots)
        src, table, _ = sb.last_launch()
        idx = torch.as_tensor(slots, dtype=torch.long, device="cuda")
        sub = GameState(*(f.index_select(0, idx) for f in pool))
        emit({"line": "search", "checkout": label, "decisions": size, "requests": len(table),
              "host_ms": statistics.median(host),
              "request_kernel_ms": median_ms(lambda: SK.kernel_search(lw, src, table, S_R, S_H,
                                                                      sb.scoring)),
              "decide_kernel_ms": median_ms(lambda: SK.kernel_decide(lw, sub, S_R, S_H,
                                                                     sb.scoring, sb.salt))})


def policy(label: str) -> None:
    import numpy as np
    import torch

    from game_engine_tpu_torch import _build
    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import ppo as P

    emit({"line": "ptxas", "checkout": label, "report": ptxas(_build.lossgrad_lib())})
    lw = werewolf()
    params, cfg = N.load_policy(os.path.join(ROOT, CKPT), device="cuda")
    d = FZ.dims_for(lw, cfg)
    eng = BatchedEngine(lw, "cuda")
    state = eng.init(K2_ROOMS, K2_PLAYERS, np.arange(K2_ROOMS, dtype=np.uint32) + 99)
    obs, legal, mask = [], [], []
    for _ in range(K2_STEPS):
        state = eng.step(state, eng.bot_actions(state))
        obs.append(N.observe(lw, state))
        legal.append(N.legal_action_mask(lw, state))
        mask.append(P.actor_mask(lw, state))
    obs, legal, mask = (torch.stack(x) for x in (obs, legal, mask))
    rows = obs.reshape(-1, d.F).to(torch.bfloat16).contiguous()
    one = rows[:K2_ROOMS * d.P]
    gen = torch.Generator(device="cuda").manual_seed(11)
    dl = torch.randn((one.shape[0], d.A), generator=gen, device="cuda")
    dv = torch.randn((one.shape[0],), generator=gen, device="cuda")
    u = torch.rand(legal.shape, generator=gen, device="cuda") * legal
    actions = (u.argmax(-1) + 1).to(torch.int32)
    shape = mask.shape
    logp = -torch.rand(shape, generator=gen, device="cuda")
    adv = torch.randn(shape, generator=gen, device="cuda")
    ret = torch.randn(shape, generator=gen, device="cuda")
    pcfg = P.PPOConfig()
    rowin = FZ._loss_rows(d, legal, actions, logp, adv, ret, mask, pcfg.vf_coef)
    emit({"line": "policy", "checkout": label, "rows_k2_k3": one.shape[0],
          "rows_k4": rows.shape[0],
          "k2_ms": median_ms(lambda: FZ.kernel_forward(d, one, params)),
          "k3_ms": median_ms(lambda: FZ.kernel_grads(d, one, dl, dv, params)),
          "k4_ms": median_ms(lambda: FZ.kernel_loss_grads(d, rows, rowin, params, pcfg.clip,
                                                          pcfg.ent_coef))})


def sample(label: str) -> None:
    import time

    import numpy as np
    import torch

    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.policies import obs_kernel as OK

    lw = werewolf()
    eng = BatchedEngine(lw, "cuda")
    for rooms, seats in SA_SIZES:
        state = eng.rollout(eng.init(rooms, seats, np.arange(rooms, dtype=np.uint32)), 200)[0]
        _, legal, actor = OK.kernel_observe(lw, state)
        gen = torch.Generator(device="cuda").manual_seed(rooms + seats)
        logits = torch.randn(legal.shape, generator=gen, device="cuda")
        u = torch.rand(legal.shape, generator=gen, device="cuda")
        device = {}
        for mode in ("uniform", "gumbel"):
            OK.kernel_sample(logits, legal, u, actor, mode)  # warm-up
            device[mode] = []
            for _ in range(5):  # one call behind a sleep kernel that outlasts its enqueue
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SLEEP_CYCLES)
                start.record()
                OK.kernel_sample(logits, legal, u, actor, mode)
                end.record()
                torch.cuda.synchronize()
                device[mode].append(start.elapsed_time(end))
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            OK.kernel_sample(logits, legal, u, actor)
            host.append((time.perf_counter() - t0) * 1e6)
        emit({"line": "sample", "checkout": label, "rooms": rooms, "seats": seats,
              "rows": int(actor.numel()), "ms": statistics.median(device["uniform"]),
              "ms_all": device["uniform"], "gumbel_ms": statistics.median(device["gumbel"]),
              "host_us": statistics.median(host)})


def steps(label: str) -> None:
    import time

    import numpy as np
    import torch

    from game_engine_tpu_torch.bench import policy_rollout_bench
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import evaluate as E
    from game_engine_tpu_torch.train import ppo as P

    lw = werewolf()
    params, net = N.load_policy(os.path.join(ROOT, CKPT), device="cuda")
    cfg = P.PPOConfig(horizon=32, epochs=4, fused_net=True, net=net)
    opt = P.make_optimizer(params, cfg)
    step = P.make_train_step(lw, cfg)
    state = init_state(lw, K2_ROOMS, K2_PLAYERS, np.arange(K2_ROOMS, dtype=np.uint32),
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    state, _ = step(params, opt, state, gen)
    unroll, update, wall = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(params, opt, state, gen)
        unroll.append(m["unroll_ms"])
        update.append(m["update_ms"])
        wall.append(time.perf_counter() - t0)
    rates = [K2_ROOMS * 32 / w for w in wall]
    emit({"line": "train_step", "checkout": label, "rooms": K2_ROOMS, "horizon": 32,
          "unroll_ms": statistics.median(unroll), "update_ms": statistics.median(update),
          "env_steps_per_s": statistics.median(rates), "unroll_ms_all": unroll,
          "update_ms_all": update, "env_steps_per_s_all": rates})
    loops = [policy_rollout_bench(16384, 128, 1)["value"] for _ in range(LOOP_CALLS)]
    emit({"line": "policy_loop", "checkout": label, "env_steps_per_s": statistics.median(loops),
          "env_steps_per_s_all": loops})
    vs = E.make_vs(lw, P.PPOConfig(fused_net=True, net=net), 64)
    start = init_state(lw, 1024, 6, np.arange(1024, dtype=np.uint32) + 5, device="cuda")
    times = []
    for k in range(MATCHUP_PAIRS + 1):
        t0 = time.perf_counter()
        vs(params, params, start, torch.Generator(device="cuda").manual_seed(k))
        times.append((time.perf_counter() - t0) * 1e3)
    emit({"line": "matchup_pair", "checkout": label, "rooms": 1024, "steps": 64,
          "ms": statistics.median(times[1:]), "ms_all": times[1:]})


def main(argv: list) -> int:
    import torch

    if not argv or argv[0] not in KINDS + ("--child",):
        print(f"usage: ab_measure {{{','.join(KINDS)}}} [--other DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_measure: no CUDA device", file=sys.stderr)
        return 2
    if argv[0] == "--child":  # --child KIND LABEL, from the checkout being measured
        {"rollout": rollout, "search": search, "policy": policy, "sample": sample,
         "steps": steps}[argv[1]](argv[2])
        return 0
    from game_engine_tpu_torch.bench import gpu_line

    gpu = gpu_line()
    emit({"line": "env", "gpu": gpu, "torch": torch.__version__})
    other = argv[argv.index("--other") + 1] if "--other" in argv else None
    for root in (other, ROOT, ROOT, other) if other else (ROOT,):
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", argv[0],
                              root], cwd=root, env={**os.environ, "PYTHONPATH": root},
                             capture_output=True, text=True, timeout=1800)
        if out.returncode != 0:
            raise RuntimeError(f"ab_measure {argv[0]} in {root} failed:\n{out.stderr[-3000:]}")
        for ln in out.stdout.splitlines():
            if ln.startswith("{"):
                emit({**json.loads(ln), "gpu": gpu})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
