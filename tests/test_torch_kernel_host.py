"""The CUDA rollout kernel's own logic on the CPU: csrc/room_step.cuh built
with g++ through the host harness (csrc/rollout_host.cpp) against the
plain-torch rollout, exactly, plus the kernel wrapper's layout, packing and
argument checks. The kernel itself runs only on a GPU (chip_smoke.py)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from game_engine_tpu.core.engine import make_rollout as jax_make_rollout
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.native.pack import pack as jax_pack
from game_engine_tpu_torch.core.engine import make_rollout
from game_engine_tpu_torch.core.rollout_kernel import (
    check_game,
    max_block_nodes,
    max_cond_nodes,
    check_state,
    block_size,
    count_rollout,
    from_minor,
    game_array,
    group_lanes,
    host_rollout,
    kernel_rollout,
    to_minor,
)
from game_engine_tpu_torch.core.state import GameState, init_state
from game_engine_tpu_torch.utils.bench_games import LONG_INTERLUDES, long_game_doc
from game_engine_tpu_torch.gamespec.tables import LAlways, LAnd, LPrevPhaseIn
from game_engine_tpu_torch.native.pack import pack
from tests.test_torch_engine import born_done_game
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_state import (assert_same_state, builtin_pair, catalog_games, doc_pair,
                                    lowered_game)
from tests.test_torch_step import wrap_pair


def assert_host_matches_plain(lw, B, n, steps, seeds=None):
    """lw: the port's Lowered."""
    seeds = np.arange(B, dtype=np.uint32) if seeds is None else seeds
    got, eps = host_rollout(lw, init_state(lw, B, n, seeds, device="cpu"), steps)
    ref, ref_eps = make_rollout(lw, steps)(init_state(lw, B, n, seeds, device="cpu"))
    bad = [f for f, x, y in zip(GameState._fields, got, ref) if not torch.equal(x, y)]
    assert not bad, f"fields differ: {bad}"
    assert int(eps) == int(ref_eps)
    return int(eps)


@pytest.mark.parametrize("name,n,steps", [
    ("werewolf", 6, 130), ("werewolf", 8, 200), ("two-truths-and-a-lie", 4, 90),
    ("assassins", 5, 80),
])
def test_kernel_body_matches_plain(name, n, steps):
    assert assert_host_matches_plain(lowered_game(name).port, 8, n, steps) > 0


def test_kernel_body_overflow_program():
    lw = wrap_pair().port
    assert_host_matches_plain(lw, 8, 4, 16)
    got, _ = host_rollout(lw, init_state(lw, 8, 4, np.arange(8), device="cpu"), 16)
    nslot = lw.game.layout.num_index("gifts_received")
    assert int(got.nums[0, 0, nslot]) == 46341 * 46341 - 2 ** 32


def test_kernel_body_born_done_rooms():
    n = torch.tensor([4, 5, 4, 6, 5, 4, 6, 5])
    assert assert_host_matches_plain(born_done_game().port, 8, n, 60) > 0


def test_kernel_body_twelve_seats():
    lw = builtin_pair("werewolf", {"max_players": 12}).port
    assert lw.P == 12
    assert assert_host_matches_plain(lw, 4, torch.tensor([10, 12, 11, 12]), 150) > 0


@pytest.mark.parametrize("name,config,n", [
    ("werewolf", None, [5, 5, 7, 5]),           # 5 and 7 seats on an 8-lane group
    ("harbor-lots", None, [5, 6, 5, 7]),
    ("werewolf", {"max_players": 12}, [12, 9, 12, 11]),   # 12 of 16 lanes
    ("werewolf", {"max_players": 5}, [5, 4, 5, 5]),       # P itself no power of two
])
def test_kernel_body_rooms_narrower_than_their_group(name, config, n):
    lw = builtin_pair(name, config).port
    assert max(n) <= lw.P <= group_lanes(lw.P) and max(n) < group_lanes(lw.P)
    assert assert_host_matches_plain(lw, 4, torch.tensor(n), 120) > 0


@pytest.mark.parametrize("seats", [20, 32])
def test_kernel_body_more_seats_than_sixteen(seats):
    """Past what the kernel's first design compiled in (16 seats): a room on
    a whole warp."""
    lw = builtin_pair("werewolf", {"max_players": seats}).port
    assert lw.P == seats and group_lanes(seats) == 32
    n = torch.tensor([seats, seats - 1, 17, 6])
    assert assert_host_matches_plain(lw, 4, n, 150) > 0


@pytest.mark.parametrize("seats", [20, 32])
def test_kernel_body_matches_jax_past_sixteen_seats(seats):
    """The chain kernel body = plain = the JAX engine at widths no catalog
    game has: a fault the plain step and the kernel body shared would show
    against the JAX package only."""
    pair = builtin_pair("werewolf", {"max_players": seats})
    B, steps = 4, 150
    n = np.array([seats, seats - 1, 17, 6], np.int32)
    seeds = np.arange(B, dtype=np.uint32)
    ref, ref_eps = jax.jit(jax_make_rollout(pair.jax, steps, auto_reset=True))(
        jax_init_state(pair.jax, B, n, seeds))
    start = init_state(pair.port, B, torch.as_tensor(n), seeds, device="cpu")
    for rollout in (make_rollout(pair.port, steps), lambda st: host_rollout(pair.port, st, steps)):
        got, eps = rollout(start)
        assert_same_state(ref, got)
        assert int(eps) == int(ref_eps) > 0


def test_kernel_body_mixed_sizes_and_seeds():
    lw = lowered_game("werewolf").port
    n = torch.tensor([4, 8, 5, 7, 6, 8, 4, 5])
    seeds = torch.tensor([0, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000, 1, 2, 3, 0xDECAF000])
    assert_host_matches_plain(lw, 8, n, 150, seeds)


@pytest.mark.parametrize("game", catalog_games())
def test_every_catalog_game_kernel_body(game):
    lw = builtin_pair(game).port
    spec = lw.game.spec
    n = min(max(spec.declaration.min_players or 4, 4), lw.P)
    assert_host_matches_plain(lw, 4, n, 40)


def test_minor_layout_round_trip():
    lw = lowered_game("werewolf").port
    st, _ = make_rollout(lw, 17, auto_reset=False)(
        init_state(lw, 5, 6, np.array([0, 1, 0xFFFFFFFF, 0x80000000, 9]), device="cpu"))
    arrs = to_minor(st)
    assert [tuple(a.shape) for a in arrs] == [
        (6, 8, 5), (1, 8, 5), (3, 8, 5), (1, 8, 8, 5), (1, 8, 5), (8, 5), (3, 8, 5), (6, 5)]
    assert all(a.dtype == torch.int32 and a.is_contiguous() for a in arrs)
    assert arrs[7][5].tolist() == [int(np.int32(np.uint32(s))) for s in st.seed.tolist()]
    back = from_minor(arrs)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(back, st))


def test_game_array_directory():
    pair = lowered_game("werewolf")
    lw = pair.port
    gm = game_array(lw)
    blob = pack(lw)
    # the port's copy of pack.py gives the JAX package's blob
    np.testing.assert_array_equal(blob, jax_pack(pair.jax))
    assert len(gm) == 32 + len(blob) and gm.dtype == np.int32
    i = 1
    while i + 2 <= len(blob):
        sid, n = int(blob[i]), int(blob[i + 1])
        assert gm[16 + sid] == n
        np.testing.assert_array_equal(gm[gm[sid]:gm[sid] + n], blob[i + 2:i + 2 + n])
        i += 2 + n


def test_group_lanes():
    assert [group_lanes(p) for p in (1, 2, 3, 4, 5, 8, 9, 12, 16, 17, 20, 32, 33, 40, 72)] == [
        1, 2, 4, 4, 8, 8, 16, 16, 16, 32, 32, 32, 32, 32, 32]  # a warp past 32 seats


def test_shared_memory_is_sized_to_the_game():
    """Words a lane by hand: the bool, num and str fields, a pdict row of P
    a bank, the odict banks, present/acted/choice/choice_phase, the action
    and a scratch word, and the largest effect block's nodes."""
    ww = lowered_game("werewolf").port
    assert block_size(ww)["words_per_lane"] == (6 + 1 + 3 + 1 * 8 + 1 + 4) + 2 + 21 == 46
    assert len(game_array(ww)) == 1455
    assert block_size(ww, 128)["shared_bytes"] == 4 * (1455 + 46 * 128) == 29372
    assert block_size(ww, 64)["shared_bytes"] == 17596
    relic = builtin_pair("relic-draft").port
    assert block_size(relic)["words_per_lane"] == (6 + 3 + 1 + 1 * 8 + 1 + 4) + 2 + 53 == 78
    assert len(game_array(relic)) == 726
    assert block_size(relic, 128)["shared_bytes"] == 4 * (726 + 78 * 128) == 42840
    # twenty seats: the pdict row grows with P
    w20 = builtin_pair("werewolf", {"max_players": 20}).port
    assert block_size(w20)["words_per_lane"] == 46 + 12
    # forty seats: two columns a lane (a room of 64 columns on 32 lanes)
    w40 = builtin_pair("werewolf", {"max_players": 40}).port
    assert block_size(w40)["words_per_lane"] == 2 * (46 + 32)
    assert block_size(w40, 128)["shared_bytes"] == 4 * (len(game_array(w40)) + 156 * 128)
    assert block_size(ww, 128)["threads"] == 128 and block_size(ww, 1024)["threads"] == 1024
    assert block_size(ww)["max_shared_bytes"] == 232448  # 227 KB
    # a game whose rooms fit only a smaller block gets the largest halving
    layout = dataclasses.replace(ww.game.layout, n_odict=300)
    wide = dataclasses.replace(ww, game=dataclasses.replace(ww.game, layout=layout))
    size = block_size(wide, 256)
    assert size["words_per_lane"] == 46 + 299 and size["threads"] == 128
    assert size["shared_bytes"] == 4 * (len(game_array(wide)) + 345 * 128) <= 232448
    assert 4 * (len(game_array(wide)) + 345 * 256) > 232448
    assert block_size(wide, 192)["threads"] == 96  # halved in whole warps


@pytest.mark.parametrize("game", catalog_games())
def test_room_words_agree_with_the_kernel_layout(game):
    """The kernel's own layout (room_step.cuh layout_of), which sizes the
    launch, against the words a lane needs counted from the game's layout."""
    lw = builtin_pair(game).port
    lay = lw.game.layout
    nodes = max([len(nodes) for m in lw.mechanics for nodes, _ in m.blocks] or [0])
    assert game_array(lw)[0] == nodes
    state = (lay.n_bool + lay.n_num + lay.n_str + max(1, lay.n_pdict) * lw.P
             + max(1, lay.n_odict) + 4)
    size = block_size(lw, 128)
    assert size["words_per_lane"] == state + 2 + nodes
    assert size["threads"] == 128
    assert size["shared_bytes"] == 4 * (len(game_array(lw)) + size["words_per_lane"] * 128)
    check_game(lw)


def test_check_game_refuses_only_what_the_design_cannot_hold():
    """Seats past a warp, phases past 63 and condition trees past 16 nodes
    are held (the last one nested, as no DSL sentence lowers it: the body
    equals the plain rollout on it); what is refused is a room past the seat
    sets' words or past a one-warp block's shared memory, naming need and
    limit."""
    lw = lowered_game("werewolf").port
    check_game(lw)
    for seats in (32, 33, 72, 128):
        check_game(builtin_pair("werewolf", {"max_players": seats}).port)
    # werewolf's pdict row grows with the seats: at 256 a room's words pass
    # a one-warp block's shared memory before its seats pass the sets' words
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory.*<= 232448"):
        check_game(builtin_pair("werewolf", {"max_players": 256}).port)
    with pytest.raises(ValueError, match=r"P=257 seats.*8 words, P <= 256"):
        check_game(builtin_pair("werewolf", {"max_players": 257}).port)
    check_game(long_pair().port)  # NP = 78, a 20-node condition
    at = next(i for i, br in enumerate(lw.branches) if br)
    deep = lw.branches[at][0][0]
    assert not isinstance(deep, LAnd)
    for _ in range(24):
        deep = LAnd((deep, LAlways()))
    # first-match: where the deep tree holds, the room goes back to phase 0
    nested = dataclasses.replace(lw, branches=lw.branches[:at] + [[(deep, 0)] + lw.branches[at]]
                                 + lw.branches[at + 1:])
    assert max_cond_nodes(nested) == 49
    check_game(nested)
    assert_host_matches_plain(nested, 4, 8, 60)
    # a room too large for a one-warp block: need and limit are both named
    layout = dataclasses.replace(lw.game.layout, n_pdict=230)
    wide = dataclasses.replace(lw, game=dataclasses.replace(lw.game, layout=layout))
    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory.*<= 232448"):
        check_game(wide)


def test_count_rollout_counts_the_interpreters_operations():
    lw = lowered_game("werewolf").port
    st = init_state(lw, 4, 8, np.arange(4, dtype=np.uint32), device="cpu")
    counts = count_rollout(lw, st, 50)
    # one hash a room-step for the stream, one a seat for its action; deals
    # and resets add theirs
    assert counts["hashes"] >= 4 * 50 * (1 + 8)
    assert counts["atoms"] > 0 and counts["node_ops"] > 0 and counts["state_writes"] > 0
    assert counts["int_ops"] == (counts["atoms"] + counts["node_ops"]
                                 + counts["state_writes"] + 9 * counts["hashes"])
    assert count_rollout(lw, st, 50) == counts  # reset between runs


def test_wrapper_checks_raise():
    lw = lowered_game("werewolf").port
    st = init_state(lw, 2, 6, 0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_rollout(lw, st, 4)  # no silent CPU fallback
    with pytest.raises(ValueError, match="P=257"):
        check_game(builtin_pair("werewolf", {"max_players": 257}).port)
    check_game(lw)
    with pytest.raises(ValueError, match="field nums"):
        check_state(lw, st._replace(nums=st.nums.to(torch.int64)))
    with pytest.raises(ValueError, match="field strs has shape"):
        check_state(lw, st._replace(strs=st.strs[:, :, :1]))
    other = builtin_pair("potlatch").port
    with pytest.raises(ValueError):
        host_rollout(other, st, 4)


# -- past the kernels' earlier bounds: 32 seats, 63 phases, 16 condition nodes

@functools.lru_cache(maxsize=None)
def long_pair():
    pair = doc_pair(long_game_doc(), "werewolf-long", validate=False)
    assert pair.port.NP == pair.jax.NP == 18 + LONG_INTERLUDES
    return pair


@functools.lru_cache(maxsize=None)
def wide_pair(seats: int):
    return builtin_pair("werewolf", {"max_players": seats})


def test_long_game_reaches_past_the_old_bounds():
    """The synthetic game: 78 phases, a branch condition of 20 nodes whose
    phase masks set bits past 63, so the blob keeps them in the pool (longer
    than the JAX package's blob, whose two words drop them)."""
    pair = long_pair()
    lw = pair.port
    assert max_cond_nodes(lw) == 20
    conds = [c for br in lw.branches for c, _ in br]
    big = next(c for c in conds if isinstance(c, LAnd))
    assert len(big.items) == 19 and all(isinstance(c, LPrevPhaseIn) for c in big.items)
    assert np.flatnonzero(big.items[0].mask).max() > 63
    blob, jblob = pack(lw), jax_pack(pair.jax)
    assert len(blob) > len(jblob)  # the masks' third words, in the pool
    gm = game_array(lw)
    assert gm[0] == max_block_nodes(lw) and gm[16] == 20
    check_game(lw)


WIDE = {  # case: (pair, seats a room, steps)
    "werewolf-40": (lambda: wide_pair(40), [37, 40, 33], 300),
    "werewolf-72": (lambda: wide_pair(72), [72, 65], 200),
    "long": (long_pair, [8, 6, 7, 8], 300),
}


@pytest.mark.parametrize("case", sorted(WIDE))
def test_kernel_body_matches_jax_every_step_past_the_old_bounds(case):
    """The kernel's body (the g++ harness: 40 and 72 seats on the wide build,
    its seat sets 8 words; the 78-phase game's masks and 20-node condition
    through the room's stack) against the JAX scan engine, which
    tests/test_pallas.py holds bit-identical to the Pallas K1: every bank of
    every room after every step, and the episodes."""
    make, n, steps = WIDE[case]
    pair = make()
    B = len(n)
    seeds = np.arange(B, dtype=np.uint32) + 5
    jax_step = jax.jit(jax_make_rollout(pair.jax, 1, auto_reset=True))
    jst = jax_init_state(pair.jax, B, np.asarray(n, np.int32), seeds)
    st = init_state(pair.port, B, torch.as_tensor(n), seeds, device="cpu")
    episodes, after_pause = 0, 0
    night = pair.port.game.id_to_index[10]
    last_pause = pair.port.game.id_to_index[100 + LONG_INTERLUDES - 1] if case == "long" else -1
    for t in range(steps):
        paused = (st.prev_phase == last_pause) & (st.phase == pair.port.game.id_to_index[9])
        jst, j_eps = jax_step(jst)
        st, eps = host_rollout(pair.port, st, 1)
        assert_same_state(jst, st)
        assert int(eps) == int(j_eps), t
        episodes += int(eps)
        after_pause += int((paused & (st.phase == night)).sum())
    assert episodes > 0
    if case == "long":  # the 20-node branch held, after a pause past phase 63
        assert after_pause > 0
