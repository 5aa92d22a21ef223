"""The PyTorch port's plain step against the oracle (every catalog game) and
against the JAX step (bank equality each step), plus the int32 overflow
program of test_int32_semantics.py. All comparisons are exact."""

import numpy as np
import pytest
import torch

from game_engine_tpu.core.engine import BatchedEngine as JaxBatchedEngine
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from game_engine_tpu_torch.core.engine import BatchedEngine, scripted_actions
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.core.step import make_step
from tests.test_int32_semantics import EXPECT, INT32_MIN, _wrap_lowered
from tests.test_parity import assert_state_matches
from tests.test_torch_state import assert_same_state, catalog_games, lowered_game


def run_oracle_parity(lowered, n_players, seed, max_steps):
    """One room through the torch step and the oracle, compared every step;
    returns the oracle room."""
    room = OracleRoom(lowered.game, n_players=n_players, seed=seed)
    step = make_step(lowered)
    state = init_state(lowered, 1, n_players, seed)
    assert_state_matches(lowered, room, state, 0, -1)
    for t in range(max_steps):
        oa = oracle_policy(room, t, seed)
        ea = scripted_actions(lowered, state)
        for pid, cv in oa.items():
            assert int(ea[0, pid - 1]) == cv, f"policy mismatch t={t} p{pid}"
        room.step(oa)
        state = step(state, ea)
        assert_state_matches(lowered, room, state, 0, t)
        if room.done:
            break
    return room


@pytest.mark.parametrize("game", catalog_games())
def test_every_catalog_game_oracle_parity(game):
    spec = load_builtin(game)
    lowered = lower(compile_game(spec))
    n = min(max(spec.declaration.min_players or 4, 4), lowered.P)
    room = run_oracle_parity(lowered, n, seed=17, max_steps=600)
    assert room.done, f"{game}: no finish in 600 steps"


@pytest.mark.parametrize("name,n", [("werewolf", 6), ("two-truths-and-a-lie", 4)])
def test_step_matches_jax_each_step(name, n):
    lw = lowered_game(name)
    B = 8
    seeds = np.arange(B, dtype=np.uint32) + 3
    jeng = JaxBatchedEngine(lw)
    jst = jax_init_state(lw, B, n, seeds)
    st = init_state(lw, B, n, seeds)
    step = make_step(lw)
    for t in range(100):
        ja = jeng.bot_actions(jst)
        ta = scripted_actions(lw, st)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=f"actions t={t}")
        jst = jeng.step(jst, ja)
        st = step(st, ta)
        assert_same_state(jst, st)
    assert bool(st.done.any()), "no room finished: the comparison missed terminal steps"


def test_overflow_program_oracle_parity():
    """Wrapping int32 sub/mul/add and INT32_MIN max/argmax keys (P20)."""
    lowered = _wrap_lowered()
    room = OracleRoom(lowered.game, n_players=4, seed=3)
    eng = BatchedEngine(lowered)
    state = eng.init(1, 4, 3)
    saw_program = False
    for t in range(24):
        room.step(oracle_policy(room, t, 3))
        state = eng.step(state, eng.bot_actions(state))
        assert_state_matches(lowered, room, state, 0, t)
        row = room.players[1]
        if row.get("rounds") == EXPECT["rounds"] and row.get("coins") == EXPECT["coins"]:
            saw_program = True
            for f, want in EXPECT.items():
                assert row[f] == want, (f, row[f], want)
            assert INT32_MIN <= row["gifts_received"] <= 2 ** 31 - 1
    assert saw_program, "the wrapping program never executed"
    nslot = lowered.game.layout.num_index("gifts_received")
    assert int(state.nums[0, 0, nslot]) == EXPECT["gifts_received"]


def test_step_does_not_mutate_its_input():
    lw = lowered_game("werewolf")
    st = init_state(lw, 4, 6, np.arange(4))
    before = [t.clone() for t in st]
    step = make_step(lw)
    for _ in range(30):
        step(st, scripted_actions(lw, st))
    assert all(torch.equal(a, b) for a, b in zip(before, st))
