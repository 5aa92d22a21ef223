"""The search kernel's logic and the port's search bots against the JAX
package's C++ search (game_engine_tpu/native gamesim.cpp through
CppRoom.search / search_scores, policies/search.py SearchBots):

(a) ``host_search`` (the kernel's body, csrc/room_step.cuh, built by g++)
    gives every request's total exactly, and the argmax of its totals the
    C++ choice, at rollouts 32 x horizon 200, for every seat of ~20 live
    states of werewolf, cult-of-the-depths and two-truths-and-a-lie;
(b) ``search_scores_plain`` (eager torch) equals both at 3 x 40;
(c) the port's Determinizer equals the JAX one array for array, and the
    determinized (D = 8) decisions equal JAX SearchBots(determinize=8);
(g) the port's eval_search gives the JAX script's win rates;
(h) each route takes only its own tensors;
(i) the rooms the bots build on the host are the kernel's buffers, and a
    native room's deciding seats are the C++ search's.
The host-level cases (d)-(f) are in test_torch_search_host.py."""

import dataclasses

import numpy as np
import pytest
import torch

from game_engine_tpu.native.lib import CppGame as JaxCppGame
from game_engine_tpu.policies.search import Determinizer as JaxDeterminizer
from game_engine_tpu.policies.search import SearchBots as JaxSearchBots
from game_engine_tpu_torch.core import rollout_kernel as RK
from game_engine_tpu_torch.core import search_kernel as SK
from game_engine_tpu_torch.core.state import GameState
from game_engine_tpu_torch.core.step import waiting_seats
from game_engine_tpu_torch.policies.search import (
    Determinizer,
    SearchBots,
    _mix,
    make_search_bots,
)
from game_engine_tpu_torch.policies.serve import state_from_read
from tests.test_torch_native import jax_native  # noqa: F401
from tests.test_torch_net import one_torch_thread  # noqa: F401
from tests.test_torch_state import builtin_pair

GAMES = ("werewolf", "cult-of-the-depths", "two-truths-and-a-lie")


def live_rooms(pair, count: int, seed0: int, n: int | None = None):
    """`count` live JAX CppRooms of n seats (6, or P if fewer) at depths
    0-30 of a scripted rollout: [(room, read(), seed)], and the seats a
    room."""
    g = JaxCppGame(pair.jax)
    n = min(6, pair.jax.P) if n is None else n
    out, k = [], 0
    while len(out) < count:
        seed, k = seed0 + k, k + 1
        room = g.room(n, seed)
        for _ in range((5 * k) % 31):
            if room.read()["done"]:
                break
            room.step(room.policy_actions())
        if not room.read()["done"]:
            out.append((room, room.read(), seed))
    return out, n


def source_state(pair, rooms, n):
    ones = [state_from_read(pair.port, r, n, seed, "cpu") for _, r, seed in rooms]
    return GameState(*(torch.cat(f) for f in zip(*ones)))


def cpp_requests(pair, rooms, n, rollouts, horizon):
    """Every multi-candidate decision of every seat of the rooms through the
    JAX CppRoom -> (request rows, their C++ totals, [(first row, number of
    candidates, C++ choice)])."""
    sc = SK.scoring(pair.port)
    rows, want, decisions = [], [], []
    for i, (room, _, seed) in enumerate(rooms):
        salt = _mix(seed, 0)
        for pid in range(1, n + 1):
            args = (pid, rollouts, horizon, sc.mode, sc.team_slot, sc.team_codes, salt)
            totals = room.search_scores(*args)
            if totals is None or len(totals) < 2:
                continue
            decisions.append((len(rows), len(totals), room.search(*args)))
            for c, v in sorted(totals.items()):
                rows.append((i, pid - 1, c, salt))
                want.append(v)
    return rows, np.asarray(want, np.int64), decisions


def first_best(cands, totals):
    best_c, best = 0, None
    for c, v in zip(cands, totals):
        if best is None or v > best:
            best_c, best = c, v
    return best_c


@pytest.mark.parametrize("game", GAMES)
def test_host_search_equals_the_cpp_search(game):
    pair = builtin_pair(game)
    rooms, n = live_rooms(pair, 20, 300)
    rows, want, decisions = cpp_requests(pair, rooms, n, 32, 200)
    assert len(decisions) >= 10
    sc = SK.scoring(pair.port)
    got = SK.host_search(pair.port, source_state(pair, rooms, n),
                         SK.request_table(rows, "cpu"), 32, 200, sc).numpy()
    np.testing.assert_array_equal(got, want)
    for at, k, choice in decisions:
        cands = [rows[at + j][2] for j in range(k)]
        assert first_best(cands, got[at:at + k]) == choice


@pytest.mark.parametrize("game", GAMES)
def test_plain_search_equals_host_and_cpp(game):
    pair = builtin_pair(game)
    rooms, n = live_rooms(pair, 12, 700)
    rows, want, _ = cpp_requests(pair, rooms, n, 3, 40)
    src = source_state(pair, rooms, n)
    table = SK.request_table(rows, "cpu")
    sc = SK.scoring(pair.port)
    plain = SK.search_scores_plain(pair.port, src, table, 3, 40, sc).numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(SK.host_search(pair.port, src, table, 3, 40, sc).numpy(), want)


def test_determinizer_equals_jax():
    for game in ("werewolf", "cult-of-the-depths"):
        pair = builtin_pair(game)
        jd, pd = JaxDeterminizer(pair.jax), Determinizer(pair.port)
        rooms, n = live_rooms(pair, 6, 40)
        for _, r, seed in rooms:
            for p0 in range(n):
                for dseed in (seed, 1000 + p0):
                    a, b = jd.apply(r, p0, n, dseed), pd.apply(r, p0, n, dseed)
                    assert a.keys() == b.keys()
                    for k in a:
                        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{game} {k}")


@pytest.mark.parametrize("game", GAMES)
def test_determinized_decisions_equal_jax(game):
    pair = builtin_pair(game)
    jb = JaxSearchBots(pair.jax, rollouts=3, horizon=40, determinize=8)
    pb = SearchBots(pair.port, rollouts=3, horizon=40, determinize=8, device="cpu")
    assert pb.ckpt_path == jb.ckpt_path == "search(rollouts=3,horizon=40,salt=0,det=8)"
    rooms, n = live_rooms(pair, 16, 900)
    decided = 0
    for _, r, seed in rooms:
        want = jb.native_actions(r, n, seed=seed)
        assert pb.native_actions(r, n, seed=seed) == want
        decided += len(want)
    assert decided >= 5


@pytest.mark.parametrize("game", GAMES)
def test_full_information_decisions_equal_jax(game):
    """actions_for_slots over a batch of rooms (one search call) equals the
    JAX bots' native_actions room by room."""
    pair = builtin_pair(game)
    jb = JaxSearchBots(pair.jax, rollouts=3, horizon=40)
    pb = SearchBots(pair.port, rollouts=3, horizon=40, device="cpu")
    assert pb.ckpt_path == jb.ckpt_path
    rooms, n = live_rooms(pair, 10, 1300)
    got = pb.actions_for_slots(source_state(pair, rooms, n)).numpy()
    for i, (_, r, seed) in enumerate(rooms):
        want = jb.native_actions(r, n, seed=seed)
        assert {p + 1: int(c) for p, c in enumerate(got[i]) if c} == want


def test_eval_search_equals_the_jax_script():
    from game_engine_tpu.utils.eval_search import eval_game as jax_eval
    from game_engine_tpu_torch.utils.eval_search import eval_game

    want = jax_eval("werewolf", 4, 3, 40)
    got = eval_game("werewolf", 4, 3, 40, device="cpu")
    for k in want:
        if k != "s_per_decision":
            assert got[k] == want[k], k


def test_unsearchable_game_gives_no_bots(caplog):
    bare = dataclasses.replace(builtin_pair("werewolf").port, game_overs=())
    assert make_search_bots(bare, device="cpu") is None
    assert "search bots unavailable" in caplog.text
    with pytest.raises(ValueError, match="terminal"):
        SK.scoring(bare)


def test_each_route_takes_its_own_tensors():
    pair = builtin_pair("werewolf")
    rooms, n = live_rooms(pair, 2, 5)
    src = source_state(pair, rooms, n)
    table = SK.request_table([(0, 0, 1, 7)], "cpu")
    sc = SK.scoring(pair.port)
    with pytest.raises(ValueError, match="cuda"):
        SK.kernel_search(pair.port, src, table, 2, 10, sc)
    fields = {k: v.numpy() for k, v in zip(GameState._fields, src)}
    with pytest.raises(ValueError, match="cuda"):
        SK.kernel_search_arrays(pair.port, fields, [(0, 0, 1, 7)], 2, 10, sc, device="cpu")
    meta = GameState(*(f.to("meta") for f in src))
    with pytest.raises(ValueError, match="cpu"):
        SK.host_search(pair.port, meta, table.to("meta"), 2, 10, sc)
    with pytest.raises(ValueError, match="source room"):
        SK.host_search(pair.port, src, SK.request_table([(5, 0, 1, 7)], "cpu"), 2, 10, sc)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SearchBots(pair.port)  # the card by default


def test_count_search_counts_the_interpreter():
    pair = builtin_pair("werewolf")
    rooms, n = live_rooms(pair, 4, 60)
    rows, _, _ = cpp_requests(pair, rooms, n, 4, 60)
    counts = SK.count_search(pair.port, source_state(pair, rooms, n),
                             SK.request_table(rows, "cpu"), 4, 60, SK.scoring(pair.port))
    assert counts["hashes"] > 0 and counts["atoms"] > 0
    assert counts["int_ops"] > counts["atoms"]


@pytest.mark.parametrize("game", GAMES)
def test_host_built_rooms_are_the_kernels_buffers(game):
    """What kernel_search_arrays sends to the card: the bots' rooms built on
    the host (_fields_of_reads, _state_of) equal state_from_read's, and
    minor_arrays equals to_minor of the same rooms, buffer for buffer."""
    pair = builtin_pair(game)
    rooms, n = live_rooms(pair, 6, 80)
    src = source_state(pair, rooms, n)
    pb = SearchBots(pair.port, rollouts=2, horizon=10, device="cpu")
    fields = pb._fields_of_reads([dict(r, n=n, seed=seed) for _, r, seed in rooms])
    for name, want in zip(GameState._fields, src):
        np.testing.assert_array_equal(fields[name], want.numpy(), err_msg=name)
    for got, want in zip(SK.minor_arrays(pair.port, fields), RK.to_minor(src)):
        np.testing.assert_array_equal(got, want.numpy())
    for a, b in zip(pb._state_of(fields), src):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        SK.minor_arrays(pair.port, dict(fields, nums=fields["nums"][:, :, :0]))


@pytest.mark.parametrize("game", GAMES)
def test_native_rooms_decide_the_cpp_searchs_seats(game):
    """native_actions reads its room on the host: the seats it searches are
    those the C++ search decides for, a subset of the state's waiting
    seats."""
    pair = builtin_pair(game)
    rooms, n = live_rooms(pair, 12, 1700)
    pb = SearchBots(pair.port, rollouts=2, horizon=10, device="cpu")
    sc = SK.scoring(pair.port)
    deciding = 0
    for room, r, seed in rooms:
        got = pb._native_rows(r, n, seed)["waiting"][0]
        want = [room.search_scores(p + 1, 0, 0, sc.mode, sc.team_slot, sc.team_codes, 0)
                is not None for p in range(n)]
        np.testing.assert_array_equal(got[:n], want)
        assert not got[n:].any()
        waiting = waiting_seats(pair.port, state_from_read(pair.port, r, n, seed, "cpu"))
        assert not (got & ~waiting[0].numpy()).any()
        deciding += int(got.sum())
    assert deciding >= 5
