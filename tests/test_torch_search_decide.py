"""The search kernel's decide entry (csrc/search.cu ge_search_decide) through
its g++ twin (core/search_kernel.host_decide: the same room_step.cuh stages
seat_candidates, decide_room, decide_rollout and decide_argmax, run on the
host) against the JAX package's search bots (policies/search.py SearchBots,
which run the C++ gs_room_search seat by seat), and the port's plain route
(SearchBots on the CPU: the host's enumeration and search_scores_plain):

(a) the same (rooms, P) choices on live rooms at several depths of
    werewolf, cult-of-the-depths and two-truths-and-a-lie, with another
    bot salt too, and the same totals as the plain route's requests;
(b) the rules: a done room and a seat that does not wait have no decision;
    a forced submit answers 1; a seat with one candidate takes it without
    rollouts; tied totals go to the lowest choice;
(c) the totals do not depend on the order of the rollouts (the kernel's
    groups pull them in any order);
(d) the card's entries take only CUDA tensors."""

import numpy as np
import pytest
import torch

from game_engine_tpu.policies.search import SearchBots as JaxSearchBots
from game_engine_tpu_torch.core import search_kernel as SK
from game_engine_tpu_torch.core.state import GameState
from game_engine_tpu_torch.gamespec.mechanics import ChoiceKind
from game_engine_tpu_torch.policies.search import SearchBots
from game_engine_tpu_torch.policies.serve import state_from_read
from tests.test_torch_native import jax_native  # noqa: F401
from tests.test_torch_net import one_torch_thread  # noqa: F401
from tests.test_torch_search import GAMES, cpp_requests, live_rooms, source_state
from tests.test_torch_state import builtin_pair

R, H = 3, 40  # rollouts x horizon: small, the tier-1 time


def choices(row) -> dict:
    return {p + 1: int(c) for p, c in enumerate(row) if c}


def twin(pair, source, rollouts=R, horizon=H, salt=0, shuffle=0):
    return SK.host_decide(pair.port, source, rollouts, horizon, SK.scoring(pair.port), salt,
                          shuffle)


def first_candidate(lowered, read: dict, n: int) -> int:
    """The lowest choice of a seat in the room's phase: the first alive seat
    of a target phase, else 1."""
    if lowered.choice_kind[read["phase_index"]] != ChoiceKind.TARGET.value:
        return 1
    bools = np.asarray(read["bools"])[:n]
    alive = bools[:, lowered.alive_bool] != 0 if lowered.alive_bool >= 0 else np.ones(n, bool)
    return 1 + int(np.flatnonzero(alive)[0])


def in_request_order(dec) -> np.ndarray:
    """The twin's totals of the decisions that rolled out, in the request
    table's order (rooms, seats and candidates ascending)."""
    counts, totals = dec.counts.reshape(-1).numpy(), dec.totals.numpy()
    return np.concatenate([totals[d, :c] for d, c in enumerate(counts) if c >= 2]
                          or [np.zeros(0, np.int64)])


@pytest.mark.parametrize("salt", [0, 0x5EED])
@pytest.mark.parametrize("game", GAMES)
def test_twin_decides_as_the_cpp_search(game, salt):
    pair = builtin_pair(game)
    rooms, n = live_rooms(pair, 14, 2100)
    jb = JaxSearchBots(pair.jax, rollouts=R, horizon=H, salt=salt)
    pb = SearchBots(pair.port, rollouts=R, horizon=H, salt=salt, device="cpu")
    source = source_state(pair, rooms, n)
    dec = twin(pair, source, salt=salt)
    plain = pb.actions_for_slots(source).numpy()
    np.testing.assert_array_equal(dec.actions.numpy(), plain)
    searched = 0
    for i, (_, r, seed) in enumerate(rooms):
        want = jb.native_actions(r, n, seed=seed)
        assert choices(dec.actions[i].tolist()) == want, i
        searched += len(want)
    assert searched >= 5
    _, _, totals = pb.last_launch()
    np.testing.assert_array_equal(in_request_order(dec), totals)
    decisions, requests, rollouts = dec.stats.tolist()
    assert (decisions, requests) == (pb.last_call["decisions"], pb.last_call["requests"])
    assert rollouts == requests * R


def test_twin_decides_as_the_cpp_search_in_rooms_past_a_warp():
    """40-seat werewolf rooms of 37 on the kernels' wide build (a room on 32
    lanes, seats 32-36 on lanes 0-4, the alive set two words, a target's
    candidates the k-th alive seat across them): the twin's choices and
    totals, and the request entry's twin's totals, equal the JAX package's
    search (SearchBots and its C++ search_scores, which hold a room's seats
    in vectors: no seat bound)."""
    pair = builtin_pair("werewolf", {"max_players": 40})
    rooms, n = live_rooms(pair, 28, 2100, n=37)
    rooms = [x for x in rooms if x[2] in (2101, 2119)]  # a night, a day vote
    jb = JaxSearchBots(pair.jax, rollouts=R, horizon=H)
    source = source_state(pair, rooms, n)
    dec = twin(pair, source)
    searched = 0
    for i, (_, r, seed) in enumerate(rooms):
        want = jb.native_actions(r, n, seed=seed)
        assert choices(dec.actions[i].tolist()) == want, i
        searched += len(want)
    assert searched >= 5
    assert int(dec.counts.max()) > 32  # candidates past a word, each with its total
    rows, want_totals, _ = cpp_requests(pair, rooms, n, R, H)
    np.testing.assert_array_equal(in_request_order(dec), want_totals)
    # the request entry's twin on the same decisions
    got = SK.host_search(pair.port, source, SK.request_table(rows, "cpu"), R, H,
                         SK.scoring(pair.port))
    np.testing.assert_array_equal(got.numpy(), want_totals)


@pytest.mark.parametrize("game", GAMES)
def test_shuffled_rollouts_give_the_same_totals(game):
    pair = builtin_pair(game)
    rooms, n = live_rooms(pair, 10, 2500)
    source = source_state(pair, rooms, n)
    ref = twin(pair, source)
    assert ref.stats[2] > 0
    for shuffle in (1, 0xC0FFEE):
        got = twin(pair, source, shuffle=shuffle)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_done_rooms_and_seats_that_do_not_wait_have_no_decision():
    pair = builtin_pair("werewolf")
    rooms, n = live_rooms(pair, 8, 40)
    jb = JaxSearchBots(pair.jax, rollouts=R, horizon=H)
    source = source_state(pair, rooms, n)
    dec = twin(pair, source._replace(done=torch.ones_like(source.done)))
    assert not dec.actions.any() and (dec.counts == -1).all()
    assert dec.stats.tolist() == [0, 0, 0]
    for _, r, seed in rooms:
        assert jb.native_actions(dict(r, done=True), n, seed=seed) == {}
    dec = twin(pair, source)
    assert (dec.actions[dec.counts < 0] == 0).all()
    assert (dec.counts[:, n:] == -1).all()  # the seats no one sits in


def test_a_forced_submit_answers_one():
    pair = builtin_pair("two-truths-and-a-lie")
    submit = [i for i, k in enumerate(pair.port.choice_kind) if k == ChoiceKind.SUBMIT.value]
    rooms, n = live_rooms(pair, 40, 3000)
    at = [x for x in rooms if x[1]["phase_index"] in submit]
    assert at, "no live room in a submit phase"
    jb = JaxSearchBots(pair.jax, rollouts=R, horizon=H)
    dec = twin(pair, source_state(pair, at, n))
    for i, (_, r, seed) in enumerate(at):
        want = jb.native_actions(r, n, seed=seed)
        assert want and set(want.values()) == {1}
        assert choices(dec.actions[i].tolist()) == want
    assert dec.stats[2] == 0  # a submit rolls nothing out


def test_one_candidate_is_taken_without_rollouts():
    """A target phase with one seat left alive: every waiting seat takes it."""
    pair = builtin_pair("werewolf")
    alive = pair.port.alive_bool
    rooms, n = live_rooms(pair, 30, 3300)
    target = [x for x in rooms
              if pair.port.choice_kind[x[1]["phase_index"]] == ChoiceKind.TARGET.value]
    assert target
    _, r, seed = target[0]
    bools = np.array(r["bools"], copy=True)
    bools[:, alive] = 0
    bools[n - 1, alive] = 1
    one = dict(r, bools=bools)
    want = JaxSearchBots(pair.jax, rollouts=R, horizon=H).native_actions(one, n, seed=seed)
    dec = twin(pair, state_from_read(pair.port, one, n, seed, "cpu"))
    assert choices(dec.actions[0].tolist()) == want
    assert dec.stats[2] == 0
    assert set(want.values()) <= {n}


@pytest.mark.parametrize("game", GAMES)
def test_tied_totals_go_to_the_lowest_choice(game):
    """At horizon 0 no rollout ends, every total is 0, and each seat takes
    its first candidate, as the C++ argmax does."""
    pair = builtin_pair(game)
    rooms, n = live_rooms(pair, 10, 3600)
    dec = twin(pair, source_state(pair, rooms, n), horizon=0)
    assert dec.stats[2] > 0 and not dec.totals.any()
    jb = JaxSearchBots(pair.jax, rollouts=R, horizon=0)
    for i, (_, r, seed) in enumerate(rooms):
        want = jb.native_actions(r, n, seed=seed)
        assert choices(dec.actions[i].tolist()) == want
        for p, c in want.items():
            if dec.counts[i, p - 1] >= 2:
                assert c == first_candidate(pair.port, r, n)


def test_the_card_entries_take_cuda_tensors():
    pair = builtin_pair("werewolf")
    rooms, n = live_rooms(pair, 2, 5)
    source = source_state(pair, rooms, n)
    sc = SK.scoring(pair.port)
    with pytest.raises(ValueError, match="cuda"):
        SK.kernel_decide(pair.port, source, R, H, sc, 0)
    fields = {k: v.numpy() for k, v in zip(GameState._fields, source)}
    with pytest.raises(ValueError, match="cuda"):
        SK.kernel_decide_arrays(pair.port, fields, R, H, sc, 0, device="cpu")
    meta = GameState(*(f.to("meta") for f in source))
    with pytest.raises(ValueError, match="cpu"):
        SK.host_decide(pair.port, meta, R, H, sc, 0)
    assert SK.candidates_a_seat(pair.port) == pair.port.P
    assert SK.candidates_a_seat(builtin_pair("two-truths-and-a-lie").port) >= 3


def test_the_bots_decide_route_with_the_twin_for_the_kernel(monkeypatch):
    """SearchBots' D = 0 route on the card (the slots selected where they
    lie, one decide launch, the actions written into the (B, P) table; a
    native room's fields in one copy), run here with the twin standing in
    for the kernel: the same choices and counts as the plain route, and no
    launch when the host mirror shows no seat waiting."""
    pair = builtin_pair("werewolf")
    rooms, n = live_rooms(pair, 12, 4100)
    source = source_state(pair, rooms, n)
    launches = []

    def decide(lowered, src, *args):
        launches.append(src.batch)
        return SK.host_decide(lowered, src, *args)

    def decide_arrays(lowered, fields, rollouts, horizon, sc, salt, device="cuda"):
        return decide(lowered, GameState(*(torch.as_tensor(fields[k]) for k in GameState._fields)),
                      rollouts, horizon, sc, salt)

    monkeypatch.setattr(SK, "kernel_decide", decide)
    monkeypatch.setattr(SK, "kernel_decide_arrays", decide_arrays)
    plain = SearchBots(pair.port, rollouts=R, horizon=H, device="cpu")
    card = SearchBots(pair.port, rollouts=R, horizon=H, device="cpu")
    card.route = "kernel"
    slots = [1, 3, 4, 7, 10]
    want = plain.actions_for_slots(source, slots)
    got = card.actions_for_slots(source, slots)
    assert torch.equal(got, want) and launches == [len(slots)]
    assert not got[[i for i in range(source.batch) if i not in slots]].any()
    assert card.last_call == plain.last_call
    assert torch.equal(card.actions_for_slots(source), plain.actions_for_slots(source))
    idle = {"waiting": np.zeros(tuple(source.present.shape), bool)}
    assert not card.actions_for_slots(source, slots, host=idle).any()
    assert launches == [len(slots), source.batch]
    for _, r, seed in rooms:
        assert card.native_actions(r, n, seed=seed) == plain.native_actions(r, n, seed=seed)
