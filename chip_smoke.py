#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

Drives the port's main path — BatchedEngine(werewolf, "cuda").rollout, the
batched scripted-bot rollout with auto-reset, 1024 steps per call at 4096
and 65,536 rooms of 8 seats — through the CUDA rollout kernel, which it
builds from csrc/ first. Phases, one JSON line each:

  env      torch/CUDA versions and the GPU's name and power limit
  build    nvcc build of csrc/rollout.cu, seconds and ptxas report
  compare  kernel vs the plain-torch rollout on the same CUDA inputs, all 15
           GameState fields and the episode count, exact: werewolf 4096x8
           (256 steps), two-truths 1024x4 and a generated game 1024x5 (128
           steps), and werewolf at two block sizes
  main     the main path at both sizes: env-steps/s of the kernel, and one
           timed call of the plain version from the same start, whose
           output must equal the kernel's first call exactly

Then a {"kernels": [...]} line, the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Any failure raises (nonzero exit). Without a
CUDA device, or outside a checkout of the repository, it exits 2 and prints
no result. Imports nothing of JAX.
"""

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "game_engine_tpu_torch/csrc/rollout.cu"
REPLACES = "game_engine_tpu/core/pallas_rollout.py:658"
STEPS = 1024
SIZES = (4096, 65536)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_abs_err(a, b, eps_a, eps_b) -> int:
    """Largest |kernel - plain| over every field and the episode count."""
    import torch

    err = abs(int(eps_a) - int(eps_b))
    for x, y in zip(a, b):
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def timed_ms(fn):
    """(result, device milliseconds) of one call, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "game_engine_tpu_torch")) or \
            not os.path.isdir(os.path.join(HERE, "game_engine_tpu")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(game_engine_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from game_engine_tpu.dslgen.generate import generate_from_description
    from game_engine_tpu.gamespec.compile import GameConfig, compile_game
    from game_engine_tpu.gamespec.parser import load_builtin, parse_game_spec
    from game_engine_tpu.gamespec.tables import lower
    from game_engine_tpu_torch import _build
    from game_engine_tpu_torch.bench import gpu_line
    from game_engine_tpu_torch.core.engine import BatchedEngine, make_rollout
    from game_engine_tpu_torch.core.rollout_kernel import kernel_rollout
    from game_engine_tpu_torch.core.state import init_state

    gpu = gpu_line()
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "gpu": gpu,
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    lib = _build.cuda_lib()
    ptxas = [ln.strip() for ln in _build.build_log(lib).splitlines()
             if "registers" in ln or "stack frame" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    ww = lower(compile_game(load_builtin("werewolf")))
    tt = lower(compile_game(load_builtin("two-truths-and-a-lie"), GameConfig()))
    doc = generate_from_description("assassins", "hidden-role night elimination game")
    gen = lower(compile_game(parse_game_spec(doc, name="assassins")))

    # -- kernel vs plain, bit-exact on the card ------------------------------
    worst = 0
    ww_threads = {}
    for name, lw, B, n, steps, threads in (
            ("werewolf", ww, 4096, 8, 256, 128),
            ("two-truths-and-a-lie", tt, 1024, 4, 128, 128),
            ("assassins", gen, 1024, 5, 128, 128),
            ("werewolf", ww, 4096, 8, 256, 64),
            ("werewolf", ww, 4096, 8, 256, 256)):
        start = init_state(lw, B, n, np.arange(B, dtype=np.uint32), device="cuda")
        launches = kernel_rollout.launches
        got, eps = kernel_rollout(lw, start, steps, threads_per_block=threads)
        torch.cuda.synchronize()
        if kernel_rollout.launches != launches + 1:
            raise AssertionError("kernel_rollout did not launch the kernel")
        ref, ref_eps = make_rollout(lw, steps)(start)
        err = max_abs_err(got, ref, eps, ref_eps)
        emit({"phase": "compare", "game": name, "rooms": B, "seats": n, "steps": steps,
              "threads_per_block": threads, "episodes": int(eps),
              "plain_episodes": int(ref_eps), "max_abs_err": err})
        if err != 0:
            bad = [f for f, x, y in zip(got._fields, got, ref) if not torch.equal(x, y)]
            raise AssertionError(f"{name}: kernel != plain in {bad}")
        if int(eps) <= 0:
            raise AssertionError(f"{name}: no episode completed in {steps} steps")
        if name == "werewolf":
            ww_threads[threads] = got
        worst = max(worst, err)
    for threads in (64, 256):  # blocks of rooms are independent
        if not all(torch.equal(x, y) for x, y in zip(ww_threads[threads], ww_threads[128])):
            raise AssertionError(f"werewolf at {threads} threads/block differs from 128")

    # -- the main path ---------------------------------------------------------
    eng = BatchedEngine(ww, "cuda")
    starts = {B: eng.init(B, 8, np.arange(B, dtype=np.uint32)) for B in SIZES}
    firsts, times, episodes = {}, {}, {}
    kernel_rollout.launches = 0
    for B in SIZES:
        state, eps = eng.rollout(starts[B], STEPS)  # warm-up call
        firsts[B] = (state, eps)
        times[B], episodes[B] = [], int(eps)
        for _ in range(5):
            (state, eps), ms = timed_ms(lambda: eng.rollout(state, STEPS))
            times[B].append(ms)
            episodes[B] += int(eps)
    main_launches = kernel_rollout.launches
    if main_launches != 2 * 6:
        raise AssertionError(f"main path launched the kernel {main_launches} times, expected 12")

    kernel_ms, plain_ms = {}, {}
    for B in SIZES:
        state, eps = firsts[B]
        # right answer: the plain version from the same start, every room
        (ref, ref_eps), plain_ms[B] = timed_ms(lambda: make_rollout(ww, STEPS)(starts[B]))
        err = max_abs_err(state, ref, eps, ref_eps)
        if err != 0:
            raise AssertionError(f"main path at {B} rooms: kernel != plain")
        worst = max(worst, err)
        if bool(state.done.any()) or not torch.equal(state.present, starts[B].present):
            raise AssertionError("auto-reset left a room done or changed room sizes")
        if not (0 <= int(state.phase.min()) and int(state.phase.max()) < ww.NP):
            raise AssertionError("phase index out of range")
        if episodes[B] <= 0:
            raise AssertionError(f"no episode completed at {B} rooms")
        kernel_ms[B] = statistics.median(times[B])
        emit({"phase": "main", "game": "werewolf", "rooms": B, "seats": 8, "steps": STEPS,
              "kernel_ms_per_call": times[B], "kernel_ms_median": kernel_ms[B],
              "env_steps_per_s": B * STEPS / (kernel_ms[B] / 1e3),
              "plain_ms": plain_ms[B],
              "plain_env_steps_per_s": B * STEPS / (plain_ms[B] / 1e3),
              "episodes_completed": episodes[B], "episodes_completed_ok": episodes[B] > 0,
              "first_call_max_abs_err_vs_plain": err, "gpu": gpu})

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    emit({"kernels": [{
        "name": "rollout", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_launches, "max_abs_err": worst,
        "ms": kernel_ms[SIZES[0]], "plain_ms": plain_ms[SIZES[0]]}]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
