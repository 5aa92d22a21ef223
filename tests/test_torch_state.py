"""GameState of the PyTorch port: init_state equals the JAX package's field by
field (values and dtypes), and state_from_numpy / state_to_numpy carry a
state across exactly."""

import os

import numpy as np
import pytest
import torch

from game_engine_tpu.core.state import GameState as JaxGameState
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.dslgen.generate import generate_from_description
from game_engine_tpu.gamespec.compile import GameConfig, compile_game
from game_engine_tpu.gamespec.parser import games_dir, load_builtin, parse_game_spec
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu_torch.core.state import (
    GameState,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from tests.test_parity import assert_state_matches


def catalog_games() -> list:
    return sorted(fn[:-5] for fn in os.listdir(games_dir()) if fn.endswith(".yaml"))


def lowered_game(name: str):
    """The slice's three test games: two shipped DSLs and a generated one."""
    if name == "assassins":
        doc = generate_from_description("assassins", "hidden-role night elimination game")
        return lower(compile_game(parse_game_spec(doc, name="assassins")))
    if name == "two-truths-and-a-lie":
        return lower(compile_game(load_builtin(name), GameConfig()))
    return lower(compile_game(load_builtin(name)))


def assert_same_state(ref, got: GameState) -> None:
    """ref: a JAX GameState (any object with numpy-convertible fields);
    got: a torch GameState. Equal values AND equal dtypes, field by field."""
    got_np = state_to_numpy(got)
    for name in JaxGameState._fields:
        want = np.asarray(getattr(ref, name))
        assert got_np[name].dtype == want.dtype, (name, got_np[name].dtype, want.dtype)
        np.testing.assert_array_equal(got_np[name], want, err_msg=f"field {name}")


GAMES = ["werewolf", "two-truths-and-a-lie", "assassins"]


@pytest.fixture(scope="module")
def games():
    return {name: lowered_game(name) for name in GAMES}


@pytest.mark.parametrize("name", GAMES)
@pytest.mark.parametrize("seats", ["min", "max"])
def test_init_state_matches_jax(games, name, seats):
    lw = games[name]
    n = lw.game.spec.declaration.min_players if seats == "min" else lw.P
    B = 4
    seeds = np.array([0, 1, 0x7FFFFFFF, 0xFFFFFFFF], np.uint32)
    ref = jax_init_state(lw, B, n, seeds)
    got = init_state(lw, B, n, seeds)
    assert got.batch == B
    assert int(got.present.sum()) == B * n
    assert_same_state(ref, got)


@pytest.mark.parametrize("game", catalog_games())
def test_init_state_every_seat_count_matches_oracle(game):
    """Every catalog game at every seat count from min_players to P: the
    fresh rooms (start-phase on-enter included) equal the oracle's."""
    lw = lower(compile_game(load_builtin(game)))
    lo = max(1, lw.game.spec.declaration.min_players or 1)
    sizes = list(range(lo, lw.P + 1))
    st = init_state(lw, len(sizes), torch.tensor(sizes), np.arange(len(sizes)) + 11)
    for b, n in enumerate(sizes):
        room = OracleRoom(lw.game, n_players=n, seed=b + 11)
        assert_state_matches(lw, room, st, b, -1)
        assert int(st.present[b].sum()) == n and int(st.seed[b]) == b + 11


def test_init_state_per_room_sizes(games):
    lw = games["werewolf"]
    n = np.array([4, 5, 8, 6], np.int32)
    seeds = np.arange(4, dtype=np.uint32) + 7
    assert_same_state(jax_init_state(lw, 4, n, seeds),
                      init_state(lw, 4, torch.as_tensor(n), torch.as_tensor(seeds.astype(np.int64))))


def test_numpy_round_trip(games):
    lw = games["werewolf"]
    ref = jax_init_state(lw, 3, 6, np.array([5, 0xFFFFFFFF, 0x80000000], np.uint32))
    st = state_from_numpy(ref)
    assert st.seed.dtype == torch.int64 and st.strs.dtype == torch.int8
    assert st.seed.tolist() == [5, 0xFFFFFFFF, 0x80000000]
    assert_same_state(ref, st)
    # and back: the numpy dict rebuilds the JAX state, and a mapping works too
    arrays = state_to_numpy(st)
    assert arrays["seed"].dtype == np.uint32
    assert_same_state(JaxGameState(**arrays), state_from_numpy(arrays))
