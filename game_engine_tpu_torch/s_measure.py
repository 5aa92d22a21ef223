"""Measurements of the search kernel (S) on one NVIDIA GPU beyond what
chip_smoke.py checks: this checkout's entries against another checkout's on
the same card, at chip_smoke.py search_timing's shapes.

    python -m game_engine_tpu_torch.s_measure [--other DIR]

One JSON line each (werewolf, 6 seats, rollouts 32 x horizon 200, D = 0;
8192 live rooms at depths 3, 7, 11 and 15 of a scripted rollout, the first
rooms holding 1, 8, 64, 512 and 4096 waiting seats; every time is the
median of 5 calls, by CUDA events):

  env       the GPU's name and power limit
  ptxas     the search library's kernels: registers, stack and spills
  size      by decisions: the host ms of SearchBots.actions_for_slots
            (whatever route the checkout takes at D = 0, up to its choices
            on the host), the request kernel's ms on the same decisions as
            a request table (kernel_search), and where the checkout has it
            the decide kernel's ms (kernel_decide)
  other     with --other DIR (another checkout of the repository, such as
            `git archive` of the parent commit unpacked): the size lines of
            DIR and of this checkout in the order other, this, this,
            other, each in its own process run from that checkout

Exits 2 without a CUDA device.
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
SIZES = (1, 8, 64, 512, 4096)
R, H = 32, 200


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int = 5) -> float:
    import torch

    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def sizes(label: str) -> None:
    """The size lines of the game_engine_tpu_torch that Python imports here
    (this checkout's, or another's through --child)."""
    import time

    import numpy as np
    import torch

    from game_engine_tpu_torch.core import search_kernel as SK
    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.core.state import GameState
    from game_engine_tpu_torch.core.step import waiting_seats
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.policies.search import SearchBots

    lw = lower(compile_game(load_builtin("werewolf")))
    eng = BatchedEngine(lw, "cuda")
    parts = []
    for k, depth in enumerate((3, 7, 11, 15)):
        st = eng.init(2048, 6, np.arange(2048, dtype=np.uint32) + 4096 * k)
        for _ in range(depth):
            st = eng.step(st, eng.bot_actions(st))
        parts.append(st)
    pool = GameState(*(torch.cat(f) for f in zip(*parts)))
    cum = np.cumsum(waiting_seats(lw, pool).sum(1).cpu().numpy())
    sb = SearchBots(lw, R, H, device="cuda")
    for size in SIZES:
        slots = list(range(int(np.searchsorted(cum, size)) + 1))
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            sb.actions_for_slots(pool, slots)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        if hasattr(sb, "request_actions"):
            sb.request_actions(pool, slots)
        src, table, _ = sb.last_launch()
        line = {"line": "size", "checkout": label, "decisions": size, "requests": len(table),
                "host_ms": statistics.median(host),
                "request_kernel_ms": median_ms(lambda: SK.kernel_search(lw, src, table, R, H,
                                                                        sb.scoring))}
        if hasattr(SK, "kernel_decide"):
            idx = torch.as_tensor(slots, dtype=torch.long, device="cuda")
            sub = GameState(*(f.index_select(0, idx) for f in pool))
            line["decide_kernel_ms"] = median_ms(lambda: SK.kernel_decide(lw, sub, R, H,
                                                                          sb.scoring, sb.salt))
        emit(line)


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("s_measure: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--child"]:
        sizes(argv[1])
        return 0
    from game_engine_tpu_torch import _build
    from game_engine_tpu_torch.bench import gpu_line

    gpu = gpu_line()
    emit({"line": "env", "gpu": gpu, "torch": torch.__version__})
    log = _build.build_log(_build.search_lib())
    emit({"line": "ptxas", "report": [ln.strip() for ln in log.splitlines()
                                      if "registers" in ln or "stack frame" in ln]})
    other = argv[argv.index("--other") + 1] if "--other" in argv else None
    for root in (other, ROOT, ROOT, other) if other else (ROOT,):
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             cwd=root, env={**os.environ, "PYTHONPATH": root},
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f"s_measure in {root} failed:\n{out.stderr[-3000:]}")
        for ln in out.stdout.splitlines():
            if ln.startswith("{"):
                emit({**json.loads(ln), "gpu": gpu})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
