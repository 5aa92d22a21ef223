"""GameState of the PyTorch port: init_state equals the JAX package's field by
field (values and dtypes), and state_from_numpy / state_to_numpy carry a
state across exactly.

The port compiles its games with its own copy of gamespec, so every case
builds two Lowered games from the same YAML or generated document: the
JAX package's for the JAX functions and the oracle, the port's for the
port (``Pair`` below)."""

import copy
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from game_engine_tpu.core.state import GameState as JaxGameState
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.dslgen.generate import generate_from_description
from game_engine_tpu.dslgen.validate import errors, validate_doc
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
from game_engine_tpu_torch.gamespec import compile as PC
from game_engine_tpu_torch.gamespec import parser as PP
from game_engine_tpu_torch.gamespec import tables as PT
from tests.test_parity import assert_state_matches


class Pair(NamedTuple):
    """One game lowered twice: by the JAX package and by the port."""

    jax: object
    port: object


def builtin_pair(name: str, config: dict | None = None) -> Pair:
    """A catalog game, compiled with GameConfig(**config) when given."""
    jcfg = None if config is None else GameConfig(**config)
    pcfg = None if config is None else PC.GameConfig(**config)
    return Pair(lower(compile_game(load_builtin(name), jcfg)),
                PT.lower(PC.compile_game(PP.load_builtin(name), pcfg)))


def port_lowered_doc(doc: dict, name: str):
    """The port's Lowered of a DSL document (a copy: the parse may not
    touch the caller's)."""
    return PT.lower(PC.compile_game(PP.parse_game_spec(copy.deepcopy(doc), name=name)))


def doc_pair(doc: dict, name: str, validate: bool = True) -> Pair:
    """A DSL document through both compilers; the JAX side is validated
    first (as tests/test_new_mechanics.py and test_mix2.py do) unless
    `validate` is False."""
    port = port_lowered_doc(doc, name)
    if validate:
        issues, spec = validate_doc(copy.deepcopy(doc), name=name)
        assert spec is not None and not errors(issues), [str(i) for i in issues]
    else:
        spec = parse_game_spec(copy.deepcopy(doc), name=name)
    return Pair(lower(compile_game(spec)), port)


def catalog_games() -> list:
    return sorted(fn[:-5] for fn in os.listdir(games_dir()) if fn.endswith(".yaml"))


def lowered_game(name: str) -> Pair:
    """The slice's three test games: two shipped DSLs and a generated one."""
    if name == "assassins":
        doc = generate_from_description("assassins", "hidden-role night elimination game")
        return doc_pair(doc, "assassins", validate=False)
    if name == "two-truths-and-a-lie":
        return builtin_pair(name, {})
    return builtin_pair(name)


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
    n = lw.jax.game.spec.declaration.min_players if seats == "min" else lw.jax.P
    B = 4
    seeds = np.array([0, 1, 0x7FFFFFFF, 0xFFFFFFFF], np.uint32)
    ref = jax_init_state(lw.jax, B, n, seeds)
    got = init_state(lw.port, B, n, seeds, device="cpu")
    assert got.batch == B
    assert int(got.present.sum()) == B * n
    assert_same_state(ref, got)


@pytest.mark.parametrize("game", catalog_games())
def test_init_state_every_seat_count_matches_oracle(game):
    """Every catalog game at every seat count from min_players to P: the
    fresh rooms (start-phase on-enter included) equal the oracle's."""
    pair = builtin_pair(game)
    lw = pair.jax
    lo = max(1, lw.game.spec.declaration.min_players or 1)
    sizes = list(range(lo, lw.P + 1))
    st = init_state(pair.port, len(sizes), torch.tensor(sizes), np.arange(len(sizes)) + 11,
                    device="cpu")
    for b, n in enumerate(sizes):
        room = OracleRoom(lw.game, n_players=n, seed=b + 11)
        assert_state_matches(lw, room, st, b, -1)
        assert int(st.present[b].sum()) == n and int(st.seed[b]) == b + 11


def test_init_state_per_room_sizes(games):
    lw = games["werewolf"]
    n = np.array([4, 5, 8, 6], np.int32)
    seeds = np.arange(4, dtype=np.uint32) + 7
    assert_same_state(jax_init_state(lw.jax, 4, n, seeds),
                      init_state(lw.port, 4, torch.as_tensor(n),
                                 torch.as_tensor(seeds.astype(np.int64)), device="cpu"))


def test_numpy_round_trip(games):
    lw = games["werewolf"]
    ref = jax_init_state(lw.jax, 3, 6, np.array([5, 0xFFFFFFFF, 0x80000000], np.uint32))
    st = state_from_numpy(ref, device="cpu")
    assert st.seed.dtype == torch.int64 and st.strs.dtype == torch.int8
    assert st.seed.tolist() == [5, 0xFFFFFFFF, 0x80000000]
    assert_same_state(ref, st)
    # and back: the numpy dict rebuilds the JAX state, and a mapping works too
    arrays = state_to_numpy(st)
    assert arrays["seed"].dtype == np.uint32
    assert_same_state(JaxGameState(**arrays), state_from_numpy(arrays, device="cpu"))
