"""The port's native simulator (game_engine_tpu_torch/native/lib.py over its
copy of gamesim.cpp, csrc/gamesim.cpp): a room stepped by CppRoom equals the
same room in the port's plain engine step and in the JAX package's
CppRoom, read() for read(), after every step — werewolf and two-truths (5
seeds each), a generated game and every catalog game; scripted self-play
counts the JAX package's episodes; the library is built into
build/kernels/."""

import os

import numpy as np
import pytest

from game_engine_tpu.native.lib import CppGame as JaxCppGame
from game_engine_tpu_torch import _build
from game_engine_tpu_torch.core.engine import scripted_actions
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.core.step import make_step
from game_engine_tpu_torch.native import CppGame, available
from tests.test_torch_net import one_torch_thread  # noqa: F401
from tests.test_torch_state import catalog_games, lowered_game

_ARRAYS = ("bools", "nums", "strs", "pdict", "odict", "acted", "choice", "choice_phase")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's simulator, loaded. Its build writes one shared
    temporary file name, so test workers that start together can lose that
    race and mark the library unavailable for their whole process; by the
    time a test runs the library is built: load it again."""
    from game_engine_tpu.native import lib

    if lib._lib is None:
        lib._build_error = None
    assert lib.available(), lib._build_error


def assert_reads_equal(a: dict, b: dict, ctx: str) -> None:
    assert a.keys() == b.keys(), ctx
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{ctx} {k}")
        else:
            assert a[k] == b[k], f"{ctx} {k}"


def assert_room_matches_state(read: dict, state, i: int, ctx: str) -> None:
    """CppRoom.read() against room i of the plain engine's GameState."""
    assert read["phase_index"] == int(state.phase[i]), f"{ctx} phase"
    assert read["prev_index"] == int(state.prev_phase[i]), f"{ctx} prev"
    assert read["done"] == bool(state.done[i]), f"{ctx} done"
    assert read["winner"] == int(state.winner[i]), f"{ctx} winner"
    assert read["t"] == int(state.t[i]), f"{ctx} t"
    for k in _ARRAYS:
        np.testing.assert_array_equal(np.asarray(read[k]).astype(np.int64),
                                      getattr(state, k)[i].numpy().astype(np.int64),
                                      err_msg=f"{ctx} {k}")


def run_differential(pair, n_players, seeds, max_steps=300):
    """Rooms of the given seeds through the port's CppRoom, the JAX
    package's CppRoom and the port's plain step (one batch), each seat's
    action the scripted policy's; equal after every step; all finish."""
    lw, jw = pair.port, pair.jax
    pg, jg = CppGame(lw), JaxCppGame(jw)
    rooms = [pg.room(n_players, s) for s in seeds]
    jrooms = [jg.room(n_players, s) for s in seeds]
    state = init_state(lw, len(seeds), n_players, np.asarray(seeds, np.uint32), device="cpu")
    step = make_step(lw)
    for t in range(max_steps + 1):
        for i, (r, jr) in enumerate(zip(rooms, jrooms)):
            read = r.read()
            assert_reads_equal(read, jr.read(), f"seed {seeds[i]} t={t}")
            assert_room_matches_state(read, state, i, f"seed {seeds[i]} t={t}")
        if all(r.read()["done"] for r in rooms):
            return
        for r, jr in zip(rooms, jrooms):
            acts = r.policy_actions()
            assert acts == jr.policy_actions()
            r.step(acts)
            jr.step(acts)
        state = step(state, scripted_actions(lw, state))
    raise AssertionError(f"rooms not done after {max_steps} steps")


def test_werewolf_native_parity():
    run_differential(lowered_game("werewolf"), 6, [0, 1, 2, 3, 4])


@pytest.mark.parametrize("n", [4, 7])
def test_werewolf_native_parity_room_sizes(n):
    run_differential(lowered_game("werewolf"), n, [10 + n, 20 + n])


def test_twotruths_native_parity():
    run_differential(lowered_game("two-truths-and-a-lie"), 4, [50, 51, 52, 53, 54])


def test_generated_game_native_parity():
    run_differential(lowered_game("assassins"), 5, [9, 10])


@pytest.mark.parametrize("game", catalog_games())
def test_every_catalog_game_native_parity(game):
    from tests.test_torch_state import builtin_pair

    pair = builtin_pair(game)
    spec = pair.port.game.spec
    n = min(max(getattr(spec.declaration, "min_players", 0) or 4, 4), pair.port.P)
    run_differential(pair, n, [17], max_steps=600)


def test_selfplay_counts_the_jax_episodes():
    pair = lowered_game("werewolf")
    got = CppGame(pair.port).selfplay(64, 8, 3, 400)
    assert got == JaxCppGame(pair.jax).selfplay(64, 8, 3, 400)
    assert got > 20


def test_write_restores_a_read():
    pair = lowered_game("werewolf")
    g = CppGame(pair.port)
    a, b = g.room(6, 5), g.room(6, 99)
    for _ in range(9):
        a.step(a.policy_actions())
    b.write(a.read())
    assert_reads_equal(b.read(), a.read(), "written")
    with pytest.raises(ValueError, match="words"):
        b.write({**a.read(), "bools": np.zeros((1, 1))})


def test_library_lands_in_build_kernels():
    assert available()
    lib = _build.gamesim_lib()
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    assert os.path.basename(lib._name).startswith("libgamesim_")


def test_long_game_native_parity_past_63_phases():
    """The 78-phase game (tests/test_torch_kernel_host.py long_doc: a
    20-node branch condition whose phase masks reach past 63): the port's
    CppRoom reads its masks' pool words and equals the plain step after
    every step, which the kernel's body and the JAX scan engine equal
    too. The JAX package's CppRoom keeps two words a mask and drops the
    later phases, so after a pause past phase 63 its check takes another
    branch: a divergence of the JAX native backend, pinned here."""
    from tests.test_torch_kernel_host import long_pair

    pair = long_pair()
    lw = pair.port
    seeds = [0, 2]  # rooms that play on past their first pause
    pg, jg = CppGame(lw), JaxCppGame(pair.jax)
    rooms = [pg.room(8, s) for s in seeds]
    jrooms = [jg.room(8, s) for s in seeds]
    state = init_state(lw, len(seeds), 8, np.asarray(seeds, np.uint32), device="cpu")
    step = make_step(lw)
    diverged = None
    for t in range(400):
        for i, r in enumerate(rooms):
            assert_room_matches_state(r.read(), state, i, f"seed {seeds[i]} t={t}")
            if diverged is None and r.read()["phase_index"] != jrooms[i].read()["phase_index"]:
                diverged = (t, jrooms[i].read()["prev_index"])
        if all(r.read()["done"] for r in rooms):
            break
        for r, jr in zip(rooms, jrooms):
            acts = r.policy_actions()
            r.step(acts)
            jr.step(acts)
        state = step(state, scripted_actions(lw, state))
    assert all(r.read()["done"] for r in rooms)
    assert diverged is not None and diverged[1] == lw.game.id_to_index[9]
