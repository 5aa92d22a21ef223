"""The PyTorch port's plain rollout (scripted bots, auto-reset) against the
JAX package's jitted rollout: every GameState field and the episode count
equal, exactly. Mirrors tests/test_pallas.py's cases, plus a declared-`over`
game and rooms that are born done."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from game_engine_tpu.core.engine import make_rollout as jax_make_rollout
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu_torch.core.engine import BatchedEngine, make_rollout, rollout
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.utils.step_cases import born_done_doc
from tests.test_torch_state import Pair, assert_same_state, builtin_pair, doc_pair, lowered_game

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def born_done_game() -> Pair:
    """potlatch whose start phase declares `over` in 4-seat rooms: those
    rooms are born done, and every auto-reset re-creates them done."""
    return doc_pair(born_done_doc(), "born-done")


def assert_rollout_matches_jax(pair: Pair, B, n, steps):
    seeds = np.arange(B, dtype=np.uint32)
    ref, ref_eps = jax.jit(jax_make_rollout(pair.jax, steps, auto_reset=True))(
        jax_init_state(pair.jax, B, n, seeds))
    got, eps = make_rollout(pair.port, steps)(init_state(pair.port, B, n, seeds, device="cpu"))
    assert int(eps) == int(ref_eps), f"episodes {int(eps)} != {int(ref_eps)}"
    assert_same_state(ref, got)
    return int(eps)


@pytest.mark.parametrize("steps", [40, 130])
def test_werewolf_rollout_matches_jax(steps):
    eps = assert_rollout_matches_jax(lowered_game("werewolf"), 8, 6, steps)
    assert steps < 100 or eps > 0


def test_twotruths_rollout_matches_jax():
    assert assert_rollout_matches_jax(lowered_game("two-truths-and-a-lie"), 8, 4, 90) > 0


def test_generated_game_rollout_matches_jax():
    assert_rollout_matches_jax(lowered_game("assassins"), 8, 5, 80)


def test_declared_over_rollout_matches_jax():
    potlatch = builtin_pair("potlatch")
    assert assert_rollout_matches_jax(potlatch, 8, 4, 60) > 0


def test_born_done_rooms_are_not_counted():
    pair = born_done_game()
    lw = pair.port
    B, steps = 8, 60
    n = np.array([4, 5, 4, 6, 5, 4, 6, 5], np.int32)
    seeds = np.arange(B, dtype=np.uint32)
    start = init_state(lw, B, torch.as_tensor(n), seeds, device="cpu")
    assert start.done.tolist() == (n == 4).tolist()
    ref, ref_eps = jax.jit(jax_make_rollout(pair.jax, steps))(
        jax_init_state(pair.jax, B, n, seeds))
    got, eps = make_rollout(lw, steps)(start)
    assert_same_state(ref, got)
    assert int(eps) == int(ref_eps) > 0
    # the born-done rooms completed nothing: one room per size class alone
    lone, lone_eps = make_rollout(lw, steps)(init_state(lw, 1, 4, 0, device="cpu"))
    assert int(lone_eps) == 0 and bool(lone.done[0])


def test_rollout_dispatch_and_engine_api():
    lw = lowered_game("werewolf").port
    eng = BatchedEngine(lw, device="cpu")
    st = eng.init(4, 6, np.arange(4, dtype=np.uint32))
    a, ea = eng.rollout(st, 25)
    b, eb = rollout(lw, st, 25)
    c, ec = make_rollout(lw, 25)(st)
    assert int(ea) == int(eb) == int(ec)
    assert all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(a, b, c))
    ids = eng.phase_dsl_ids(a)
    assert ids.tolist() == [int(lw.phase_dsl_id[p]) for p in a.phase.tolist()]
    # no auto-reset: finished rooms stay finished
    d, _ = eng.rollout(st, 300, auto_reset=False)
    assert bool(d.done.all())
    stepped = eng.step(st, eng.bot_actions(st))
    assert stepped.t.tolist() == [1] * 4


def test_rollout_refuses_unsupported_devices(monkeypatch):
    lw = lowered_game("werewolf").port
    st = init_state(lw, 2, 6, 0, device="cpu")
    meta = type(st)(*(t.to("meta") for t in st))
    with pytest.raises(ValueError, match="unsupported device"):
        rollout(lw, meta, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedEngine(lw, "cuda")


def test_port_never_imports_jax():
    code = ("import sys; import game_engine_tpu_torch.core.engine, "
            "game_engine_tpu_torch.core.rollout_kernel, game_engine_tpu_torch.bench, "
            "chip_smoke; assert 'jax' not in sys.modules, sorted("
            "m for m in sys.modules if m.startswith('jax'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
