"""The port's view layer (game_engine_tpu_torch/view/) against the JAX
package's: for the same seed and actions, decode_room gives the same
AgentState snapshot and the Projector the same items at every step
(werewolf and two-truths, as tests/test_view.py drives them), and
tests/test_view.py's own checks hold on the port's copies."""

import numpy as np
import pytest

from game_engine_tpu.core.engine import BatchedEngine as JaxEngine
from game_engine_tpu.core.engine import scripted_actions as jax_scripted
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from game_engine_tpu.view.decode import decode_room as jax_decode_room
from game_engine_tpu.view.project import Projector as JaxProjector
from game_engine_tpu_torch.core.engine import BatchedEngine
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.view.cards import clear_canvas, make_item, visible_to
from game_engine_tpu_torch.view.decode import decode_room
from game_engine_tpu_torch.view.notes import NotesLog
from game_engine_tpu_torch.view.project import Projector
from tests.test_torch_net import one_torch_thread  # noqa: F401
from tests.test_torch_state import builtin_pair


@pytest.fixture(scope="module")
def ww():
    return builtin_pair("werewolf")


@pytest.fixture(scope="module")
def ttal():
    return builtin_pair("two-truths-and-a-lie", {})


@pytest.mark.parametrize("game,n,seed,steps", [
    ("werewolf", 6, 3, 70), ("werewolf", 8, 11, 70), ("two-truths-and-a-lie", 3, 0, 90)])
def test_decode_and_projection_match_jax(game, n, seed, steps):
    """Both engines step B rooms with the same (JAX scripted) actions; every
    room's decoded snapshot, items and notes agree at every step."""
    pair = builtin_pair(game, {} if game.startswith("two") else None)
    B = 2
    jeng, peng = JaxEngine(pair.jax), BatchedEngine(pair.port, "cpu")
    seeds = np.asarray([seed, seed + 1], np.uint32)
    jst = jax_init_state(pair.jax, B, n, seeds)
    pst = init_state(pair.port, B, n, seeds, device="cpu")
    names = {1: "Ann", 2: "Bo"}
    jproj = [JaxProjector(pair.jax.game) for _ in range(B)]
    pproj = [Projector(pair.port.game) for _ in range(B)]
    jitems, pitems = [[] for _ in range(B)], [[] for _ in range(B)]
    jdead, pdead = [[] for _ in range(B)], [[] for _ in range(B)]
    notes = [NotesLog() for _ in range(B)]
    seen = set()
    for t in range(steps):
        for b in range(B):
            js = jax_decode_room(pair.jax, jst, b, names)
            ps = decode_room(pair.port, pst, b, names)
            assert ps == js, (t, b)
            jitems[b] = jproj[b].project(js, prev_items=jitems[b], prev_dead=jdead[b])
            pitems[b] = pproj[b].project(ps, prev_items=pitems[b], prev_dead=pdead[b])
            assert [i.to_json() for i in pitems[b]] == [i.to_json() for i in jitems[b]], (t, b)
            jdead[b], pdead[b] = list(js["deadPlayers"]), list(ps["deadPlayers"])
            notes[b].observe(ps)
            seen |= {i.type for i in pitems[b]}
        a = jax_scripted(pair.jax, jst)
        jst = jeng.step(jst, a)
        pst = peng.step(pst, np.array(a))
    assert bool(np.asarray(jst.done).any()), "no room finished: the drive is too short"
    assert all(n.recent(50) for n in notes)
    assert {"avatar_set", "phase_indicator"} & seen


def test_audience_gate():
    pub = make_item("1", "text_display", "hi", content="x")
    priv = make_item("2", "voting_panel", "vote", audience_type=False,
                     audience_ids=["2", "3"], votingId="v1", options=["a"])
    assert visible_to(pub, "1") and visible_to(pub, "9")
    assert not visible_to(priv, "1")
    assert visible_to(priv, "2") and visible_to(priv, "3")


def test_clear_canvas_keeps_avatars_and_exempt():
    items = [
        make_item("1", "avatar_set", "Avatars", avatarType="human"),
        make_item("2", "text_display", "x", content="x"),
        make_item("3", "death_marker", "dead", playerName="P2", playerId="2"),
        make_item("4", "timer", "t", duration=10),
    ]
    assert [i.id for i in clear_canvas(items, exempt=["death_marker"])] == ["1", "3"]
    assert [i.id for i in clear_canvas(items)] == ["1"]


def test_decode_matches_oracle_snapshot(ww):
    room = OracleRoom(ww.jax.game, n_players=5, seed=3)
    eng = BatchedEngine(ww.port, "cpu")
    state = eng.init(1, 5, np.uint32(3))
    for t in range(25):
        room.step(oracle_policy(room, t, 3))
        state = eng.step(state, eng.bot_actions(state))
    snap_o = room.snapshot()
    snap_e = decode_room(ww.port, state, 0)
    assert snap_e["current_phase_id"] == snap_o["current_phase_id"]
    for pid, row in snap_o["player_states"].items():
        for k, v in row.items():
            if k != "name":
                assert snap_e["player_states"][pid][k] == v, f"{pid}.{k}"


def test_projection_twotruths_statements(ttal):
    room = OracleRoom(ttal.jax.game, n_players=3, seed=0)
    proj = Projector(ttal.port.game)
    items, seen_types = [], set()
    for t in range(120):
        room.step(oracle_policy(room, t, 0))
        snap = room.snapshot()
        snap["stateVersion"] = t
        items = proj.project(snap, prev_items=items)
        seen_types |= {i.type for i in items}
        if snap["current_phase_id"] == 2:
            bi = [i for i in items if i.type == "broadcast_input"]
            assert bi and not bi[0].data["audience_type"]
        if room.done:
            break
    assert {"score_board", "statement_board", "turn_indicator"} <= seen_types


def test_singletons_do_not_duplicate_on_reprojection(ttal):
    room = OracleRoom(ttal.jax.game, n_players=3, seed=0)
    proj = Projector(ttal.port.game)
    snap = room.snapshot()
    snap["stateVersion"] = 0
    items = proj.project(snap)
    for _ in range(5):
        items = proj.project(snap, prev_items=items)
    assert sum(1 for i in items if i.type == "avatar_set") == 1
    assert sum(1 for i in items if i.type == "score_board") == 1


def test_item_ids_unique_and_numeric(ww):
    room = OracleRoom(ww.jax.game, n_players=4, seed=1)
    proj = Projector(ww.port.game)
    items = []
    for t in range(30):
        room.step(oracle_policy(room, t, 1))
        snap = room.snapshot()
        snap["stateVersion"] = t
        items = proj.project(snap, prev_items=items)
        ids = [i.id for i in items]
        assert len(ids) == len(set(ids))
        assert all(i.isdigit() and len(i) == 4 for i in ids)
