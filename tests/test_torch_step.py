"""The PyTorch port's plain step against the oracle (every catalog game, and
the generated mechanic and mix DSLs of test_new_mechanics.py and
test_mix2.py) and against the JAX step (bank equality each step), plus the
int32 overflow program of test_int32_semantics.py. All comparisons are
exact."""

import os

import numpy as np
import pytest
import torch
import yaml

from game_engine_tpu.core.engine import BatchedEngine as JaxBatchedEngine
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.dslgen.generate import Blueprint, generate, generate_from_description
from game_engine_tpu.gamespec.parser import games_dir
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from game_engine_tpu_torch.core.engine import BatchedEngine, scripted_actions
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.core.step import make_step
from tests.test_int32_semantics import EXPECT, INT32_MIN, WRAP_PROGRAM, _wrap_lowered
from tests.test_parity import assert_state_matches
from tests.test_torch_state import (Pair, assert_same_state, builtin_pair, catalog_games,
                                    doc_pair, lowered_game)
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)


def run_oracle_parity(pair: Pair, n_players, seed, max_steps):
    """One room through the torch step (on the port's Lowered) and the
    oracle (on the JAX package's), compared every step; returns the oracle
    room."""
    lowered = pair.port
    room = OracleRoom(pair.jax.game, n_players=n_players, seed=seed)
    step = make_step(lowered)
    state = init_state(lowered, 1, n_players, seed, device="cpu")
    assert_state_matches(pair.jax, room, state, 0, -1)
    for t in range(max_steps):
        oa = oracle_policy(room, t, seed)
        ea = scripted_actions(lowered, state)
        for pid, cv in oa.items():
            assert int(ea[0, pid - 1]) == cv, f"policy mismatch t={t} p{pid}"
        room.step(oa)
        state = step(state, ea)
        assert_state_matches(pair.jax, room, state, 0, t)
        if room.done:
            break
    return room


@pytest.mark.parametrize("game", catalog_games())
def test_every_catalog_game_oracle_parity(game):
    pair = builtin_pair(game)
    spec = pair.jax.game.spec
    n = min(max(spec.declaration.min_players or 4, 4), pair.jax.P)
    room = run_oracle_parity(pair, n, seed=17, max_steps=600)
    assert room.done, f"{game}: no finish in 600 steps"


# the generated DSLs, built as tests/test_new_mechanics.py (archetypes) and
# tests/test_mix2.py (descriptions, and a blueprint with an extra) build them
MIX_DESCRIPTIONS = {
    "story-pot": (
        "Storytellers tell three statements and the table guesses which one is "
        "the lie; at each round start every player collects 1 coin from the "
        "story pot and raids a rival purse. Guess true, speak well, and the "
        "richest storyteller wins."),
    "gilded-court": (
        "Courtiers claim the Duke, Captain or Inquisitor roles and challenge "
        "each other's bluffs; at each showdown the court treasury pays out "
        "coins and holds a sealed-bid auction for gilded lots until the house "
        "closes. Outlast the court or collect the most lots."),
    "scrap-rally": (
        "Racers pick a speed each sprint and collide when they overtake on the "
        "same line; every movement pays a sponsorship coin, and racers raid a "
        "rival pit before the next lap. Reach the finish line or get rich "
        "trying."),
}
BLUEPRINTS = {
    "t-bluff": Blueprint(name="t-bluff", description="a bluff game", archetype="bluff"),
    "t-market": Blueprint(name="t-market", description="a market game", archetype="market"),
    "t-minority": Blueprint(name="t-minority", description="odd one out",
                            archetype="minority"),
    "court-raid": Blueprint(name="court-raid", description="d", archetype="bluff",
                            extras=("market",)),
}


def generated_doc(name):
    return (generate(BLUEPRINTS[name]) if name in BLUEPRINTS
            else generate_from_description(name, MIX_DESCRIPTIONS[name]))


def generated_lowered(name) -> Pair:
    return doc_pair(generated_doc(name), name)


@pytest.mark.parametrize("name,n,seed", [
    ("t-bluff", 5, 1), ("t-market", 6, 2), ("t-minority", 4, 1), ("story-pot", 5, 1),
    ("gilded-court", 6, 2), ("scrap-rally", 4, 0), ("court-raid", 5, 2)])
def test_generated_dsl_oracle_parity(name, n, seed):
    pair = generated_lowered(name)
    room = run_oracle_parity(pair, min(n, pair.jax.P), seed=seed, max_steps=900)
    assert room.done, f"{name}: no finish in 900 steps"


@pytest.mark.parametrize("name,n", [("werewolf", 6), ("two-truths-and-a-lie", 4)])
def test_step_matches_jax_each_step(name, n):
    pair = lowered_game(name)
    B = 8
    seeds = np.arange(B, dtype=np.uint32) + 3
    jeng = JaxBatchedEngine(pair.jax)
    jst = jax_init_state(pair.jax, B, n, seeds)
    st = init_state(pair.port, B, n, seeds, device="cpu")
    step = make_step(pair.port)
    for t in range(100):
        ja = jeng.bot_actions(jst)
        ta = scripted_actions(pair.port, st)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=f"actions t={t}")
        jst = jeng.step(jst, ja)
        st = step(st, ta)
        assert_same_state(jst, st)
    assert bool(st.done.any()), "no room finished: the comparison missed terminal steps"


def wrap_doc() -> dict:
    """tests/test_int32_semantics.py's gift-circle with the wrapping int32
    program (its _wrap_lowered), as a document."""
    doc = yaml.safe_load(open(os.path.join(games_dir(), "gift-circle.yaml")))
    doc["phases"][2]["mechanics"] = [{"effects": list(WRAP_PROGRAM)}]
    doc["phases"][2]["name"] = "Resolution"
    doc["phases"][2]["description"] = "Effects apply."
    doc["phases"][1]["next_phase"]["name"] = "Resolution"
    return doc


def wrap_pair() -> Pair:
    pair = doc_pair(wrap_doc(), "wrap-test")
    # the same game test_int32_semantics.py builds
    assert pair.jax.game.spec == _wrap_lowered().game.spec
    return pair


def test_overflow_program_oracle_parity():
    """Wrapping int32 sub/mul/add and INT32_MIN max/argmax keys (P20)."""
    pair = wrap_pair()
    lowered = pair.jax
    room = OracleRoom(lowered.game, n_players=4, seed=3)
    eng = BatchedEngine(pair.port, device="cpu")
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
    lw = lowered_game("werewolf").port
    st = init_state(lw, 4, 6, np.arange(4), device="cpu")
    before = [t.clone() for t in st]
    step = make_step(lw)
    for _ in range(30):
        step(st, scripted_actions(lw, st))
    assert all(torch.equal(a, b) for a, b in zip(before, st))
