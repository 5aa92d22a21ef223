"""The port's own copy of the game compiler (game_engine_tpu_torch/gamespec,
native/pack.py) against the JAX package's: lower(compile_game(...)) equal
field by field, every numpy array (dtype, shape and values) and every node
of the compiled and lowered game, on all catalog games and on the generated
DSLs the engine tests build. Each port node must be the port's own class,
since the port's step refuses any other; the packed kernel blob must be the
same int32 array."""

import dataclasses
import enum

import numpy as np
import pytest

from game_engine_tpu.dslgen.generate import generate_from_description
from game_engine_tpu.native.pack import pack as jax_pack
from game_engine_tpu_torch.gamespec import parser as PP
from game_engine_tpu_torch.native.pack import pack
from tests.test_torch_state import builtin_pair, catalog_games, doc_pair
from tests.test_torch_step import BLUEPRINTS, MIX_DESCRIPTIONS, generated_doc, wrap_doc

JAX_PKG, PORT_PKG = "game_engine_tpu.", "game_engine_tpu_torch."


def _kind(x) -> str:
    """A class's module and name with the package prefix taken off."""
    mod = type(x).__module__
    for pkg in (PORT_PKG, JAX_PKG):
        if mod.startswith(pkg):
            return mod[len(pkg):] + "." + type(x).__qualname__
    return mod + "." + type(x).__qualname__


def assert_same_tree(want, got, path="lowered", seen=None):
    """want: the JAX package's object; got: the port's. Recursive equality
    of dataclasses, enums, containers, numpy arrays and plain values; a
    port object of a gamespec class must come from the port's package."""
    seen = set() if seen is None else seen
    key = (id(want), id(got))
    if key in seen:
        return
    seen.add(key)
    assert _kind(want) == _kind(got), f"{path}: {_kind(want)} != {_kind(got)}"
    if type(want).__module__.startswith(JAX_PKG):
        assert type(got).__module__.startswith(PORT_PKG), \
            f"{path}: {type(got).__module__} is not the port's"
    if isinstance(want, np.ndarray):
        assert want.dtype == got.dtype and want.shape == got.shape, \
            f"{path}: {want.dtype}{want.shape} != {got.dtype}{got.shape}"
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, enum.Enum):
        assert (want.name, want.value) == (got.name, got.value), path
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_same_tree(getattr(want, f.name), getattr(got, f.name),
                             f"{path}.{f.name}", seen)
    elif isinstance(want, dict):
        wk, gk = list(want), list(got)
        assert len(wk) == len(gk), f"{path}: {len(wk)} keys != {len(gk)}"
        for a, b in zip(wk, gk):  # insertion order is part of the result
            assert_same_tree(a, b, f"{path}<key>", seen)
            assert_same_tree(want[a], got[b], f"{path}[{a!r}]", seen)
    elif isinstance(want, (list, tuple, set, frozenset)):
        if isinstance(want, (set, frozenset)):
            want, got = sorted(want, key=repr), sorted(got, key=repr)
        assert len(want) == len(got), f"{path}: length {len(want)} != {len(got)}"
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same_tree(a, b, f"{path}[{i}]", seen)
    elif hasattr(want, "__dict__") and not callable(want):
        assert_same_tree(vars(want), vars(got), path, seen)
    else:
        assert want == got, f"{path}: {want!r} != {got!r}"


def assert_pair_equal(pair):
    assert_same_tree(pair.jax, pair.port)
    np.testing.assert_array_equal(pack(pair.port), jax_pack(pair.jax))


@pytest.mark.parametrize("game", catalog_games())
def test_catalog_game_lowers_the_same(game):
    assert_pair_equal(builtin_pair(game))


@pytest.mark.parametrize("name", sorted(BLUEPRINTS) + sorted(MIX_DESCRIPTIONS))
def test_generated_dsl_lowers_the_same(name):
    assert_pair_equal(doc_pair(generated_doc(name), name))


def test_generated_assassins_and_wrap_program_lower_the_same():
    doc = generate_from_description("assassins", "hidden-role night elimination game")
    assert_pair_equal(doc_pair(doc, "assassins", validate=False))
    assert_pair_equal(doc_pair(wrap_doc(), "wrap-test"))


def test_game_config_reaches_the_copy():
    pair = builtin_pair("werewolf", {"max_players": 12})
    assert pair.port.P == 12
    assert_pair_equal(pair)


def test_catalog_is_the_repository_games_dir():
    """parser.games_dir() climbs from the copy to the repository's games/."""
    from game_engine_tpu.gamespec.parser import games_dir

    assert PP.games_dir() == games_dir()
    assert len(catalog_games()) == 31


def test_the_comparison_sees_a_difference():
    a, b = builtin_pair("werewolf"), builtin_pair("potlatch")
    with pytest.raises(AssertionError):
        assert_same_tree(a.jax, b.port)
    with pytest.raises(AssertionError, match="not the port's"):
        assert_same_tree(a.jax, a.jax)
