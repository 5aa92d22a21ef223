"""Run one cell of the port's benchmark once, on the card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's driver sets up (builds the
kernels into build/kernels/ on a checkout's first run, makes the inputs
and weights from --seed, warms up every shape the window uses), measures
for --seconds, then checks what the window produced against the plain
reference. The last line of standard output is one JSON object; the
checks, each number beside its limit, are the last lines of standard
error. Without a card, or with fewer cards than the cell asks for, it
exits 2 and prints no result: it never runs on the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs() -> None:
    """Every compiler cache inside the checkout, at fixed paths, so that
    only a checkout's first run builds (the kernels' own is build/kernels/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", sub)


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    import torch

    from portbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {n}; "
              "the benchmark does not run on the CPU", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    driver = spec.load_module("drivers", cell.traffic)
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = harness.result_line(cell, run, bool(args.trace), harness.gpu_line())
    print(f"portbench: set-up {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
          f"{run.attempted} calls, check {run.check_s:.3f} s", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
