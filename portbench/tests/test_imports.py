"""What the benchmark loads: never JAX or the JAX package, and the
reference nothing of the program. Each check runs in a fresh interpreter
and compares the top-level name of every loaded module whole (the port's
name begins with the JAX package's)."""

import json
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "game_engine_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


HARNESS = """
from portbench import compare, control, count_ops, harness, run, spec, yardstick
import portbench.reference.engine, portbench.reference.policy, portbench.reference.train
bench = spec.benchmark()
for t in {w["traffic"] for w in bench["workloads"]}:
    assert hasattr(spec.load_module("drivers", t), "run")
for m in bench["end_to_end"] + bench["per_layer"]:
    assert hasattr(spec.load_module("metrics", m["name"]), "read")
"""


def test_harness_drivers_metrics_and_reference_load_no_jax():
    loaded = _loaded(HARNESS)
    assert "portbench" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import portbench.reference.engine, portbench.reference.policy, "
                     "portbench.reference.train, portbench.reference.state\n"
                     "from portbench.reference import lower_game\n"
                     "lower_game('games/werewolf-(mafia).yaml')")
    assert "game_engine_tpu_torch" not in loaded and not loaded & FORBIDDEN


RUN = """
import copy
from portbench import harness, spec
cell = spec.cell("werewolf8.rollout")
cell.workload = dict(cell.workload, rooms=16, steps_per_call=8)
run = spec.load_module("drivers", "rollout").run(cell, 2 ** 40 + 3, 0.2, False,
                                                  harness.now(), device="cpu")
assert all(c.ok for c in run.checks)
assert harness.forbidden_modules() == []
"""


def test_a_run_with_the_program_loads_no_jax():
    loaded = _loaded(RUN)
    assert "game_engine_tpu_torch" in loaded and not loaded & FORBIDDEN
