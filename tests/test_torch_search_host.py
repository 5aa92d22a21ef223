"""The port's game host with lookahead search bots (--bot-search), on the CPU
(the search's plain version), on both backends — tests/test_search_bot.py
and test_search_det.py moved onto the port, at small rollouts and horizon:

(d) decisions deterministic and legal; search bots serve and diverge from
    scripted play; the torch and native backends play the same rooms; a
    crash resumes bit for bit; a restart with other search settings is
    refused (410); a game with no searchable terminal rule serves
    scripted bots; checkpoint/search precedence;
(e) the JAX package's host (backend="native", bot_search=["all"]) and the
    port's host on either backend hold equal engine state and equal
    projected snapshots after every /continue;
(f) journals with search seats restore across packages both ways."""

import dataclasses
import json
import os

import pytest

from game_engine_tpu.server.manager import GameHost as JaxGameHost
from game_engine_tpu_torch.native import CppGame
from game_engine_tpu_torch.policies.search import SearchBots
from game_engine_tpu_torch.policies.serve import PolicyBots
from game_engine_tpu_torch.server.api import AppContext
from game_engine_tpu_torch.server.manager import GameHost
from tests.test_torch_native import jax_native  # noqa: F401
from tests.test_torch_net import one_torch_thread  # noqa: F401
from tests.test_torch_server import _comparable, _engine_state
from tests.test_torch_state import builtin_pair

SMALL = {"search_rollouts": 2, "search_horizon": 24}
CKPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "docs", "checkpoints")


def host(backend="native", **kw):
    return GameHost(backend=backend, device="cpu", **{**SMALL, **kw})


def play(h, rid, seed, game="werewolf", n=6, max_cycles=60):
    h.start_room(rid, game, n, seed=seed, human_seats=[1])
    snaps = []
    for _ in range(max_cycles):
        snap = h.run_until_input_needed(rid)
        snaps.append({k: snap[k] for k in ("current_phase_id", "done", "winner",
                                           "player_states")})
        if snap["done"]:
            break
        for pid in snap["waiting_on"]:
            h.queue_action(rid, pid, 1, text="a\nb\nc")
    return snaps


def test_search_deterministic_and_legal():
    """Same state + seed -> same actions (two instances); the search decides
    exactly the seats the scripted policy acts for, and the engine accepts
    every choice; a search-driven room terminates."""
    lw = builtin_pair("werewolf").port
    a, b = (SearchBots(lw, rollouts=2, horizon=30, device="cpu") for _ in range(2))
    room = CppGame(lw).room(6, 42)
    for _ in range(80):
        r = room.read()
        if r["done"]:
            break
        acts = a.native_actions(r, 6, seed=42)
        assert acts == b.native_actions(r, 6, seed=42)
        scripted = room.policy_actions()
        assert set(acts) == set(scripted)
        room.step(acts or scripted)
        r2 = room.read()
        for pid in acts:
            assert r2["acted"][pid - 1] or r2["phase_index"] != r["phase_index"]
    assert room.read()["done"], "search-driven room must terminate"


def test_search_bots_serve_and_diverge_from_scripted():
    hs = host(bot_search=["all"])
    hs.start_room("warm", "werewolf", 6, seed=1)
    assert isinstance(hs._policies["werewolf#r1"], SearchBots)
    assert hs._policies["werewolf#r1"].route == "plain"
    traj_s = play(hs, "rp", seed=7)
    traj_0 = play(host(), "rs", seed=7)
    assert traj_s[-1]["done"] and traj_0[-1]["done"]
    assert traj_s != traj_0  # the search tier actually drives the bots
    assert play(host(bot_search=["all"]), "rq", seed=7) == traj_s


def test_search_torch_native_backend_parity():
    """actions_for_slots on the batched torch state and native_actions on a
    C++ room give the same rooms, cycle for cycle (a second live room on
    the torch backend steps in the same batch)."""
    t = host("torch", bot_search=["all"])
    t.start_room("side", "werewolf", 6, seed=103, human_seats=[6])
    assert play(t, "r", seed=3) == play(host(bot_search=["all"]), "r", seed=3)


@pytest.mark.parametrize("backend", ["native", "torch"])
def test_search_room_crash_resume_bit_identical(tmp_path, backend):
    sp = str(tmp_path / "rooms.json")
    kw = dict(backend=backend, bot_search=["all"], device="cpu", **SMALL)
    ctx = AppContext(sp, **kw)
    _, d = ctx.handle("POST", "/api/rooms/create", {},
                      {"gameName": "werewolf", "playerName": "Ada"})
    rid = d["room"]["roomId"]
    ctx.handle("POST", "/api/rooms/add-bot", {}, {"roomId": rid})
    _, snap = ctx.handle("POST", f"/api/rooms/{rid}/start", {}, {"seed": 11})
    for _ in range(2):
        _, snap = ctx.handle("POST", f"/api/rooms/{rid}/continue", {}, {})
        if snap["done"]:
            break
        for pid in snap["waiting_on"]:
            ctx.handle("POST", f"/api/rooms/{rid}/vote", {}, {"playerId": pid, "option": 2})
    ref = ctx.host.snapshot(rid)
    ref_state = _engine_state(ctx.host, rid)
    del ctx  # kill -9

    ctx2 = AppContext(sp, **kw)
    snap2 = ctx2.host.snapshot(rid)
    assert snap2["stateVersion"] == ref["stateVersion"]
    assert snap2["player_states"] == ref["player_states"]
    assert _engine_state(ctx2.host, rid) == ref_state


@pytest.mark.parametrize("restart", [{}, {"bot_search": ["all"], "search_rollouts": 3}])
def test_search_room_refuses_mismatched_restart(tmp_path, restart):
    """A restart without --bot-search, or with other search settings, must
    refuse the replay: the journal header carries the search tag."""
    sp = str(tmp_path / "rooms.json")
    ctx = AppContext(sp, backend="native", bot_search=["all"], device="cpu", **SMALL)
    _, d = ctx.handle("POST", "/api/rooms/create", {},
                      {"gameName": "werewolf", "playerName": "Bo"})
    rid = d["room"]["roomId"]
    ctx.handle("POST", "/api/rooms/add-bot", {}, {"roomId": rid})
    ctx.handle("POST", f"/api/rooms/{rid}/start", {}, {"seed": 5})
    ctx.handle("POST", f"/api/rooms/{rid}/continue", {}, {})
    del ctx
    ctx2 = AppContext(sp, backend="native", device="cpu", **{**SMALL, **restart})
    code, _ = ctx2.handle("GET", f"/api/rooms/{rid}/state", {"playerId": ["1"]}, {})
    assert code == 410


def test_search_unavailable_game_falls_back_scripted():
    """A score-mode game is searchable and its rooms complete; a game with
    no terminal rule gets no search bots, so the host serves scripted."""
    h = host(bot_search=["all"])
    traj = play(h, "tt", seed=2, game="two-truths", n=4, max_cycles=80)
    assert traj[-1]["done"]
    assert isinstance(h._policies["two-truths#r1"], SearchBots)
    bare = dataclasses.replace(builtin_pair("werewolf").port, game_overs=())
    assert h._policy_for("werewolf", bare) is None


def test_search_precedence_most_specific_fragment_wins():
    """A checkpoint that does not fit werewolf is skipped for search; a
    fitting one beats search at equal specificity; a more specific search
    fragment beats a bare checkpoint."""
    cult = f"werewolf={os.path.join(CKPTS, 'attn_cult_u60.npz')}"
    ww = os.path.join(CKPTS, "attn_werewolf_u120.npz")
    cases = [({"bot_ckpts": [cult], "bot_search": ["all"]}, SearchBots),
             ({"bot_ckpts": [f"werewolf={ww}"], "bot_search": ["werewolf"]}, PolicyBots),
             ({"bot_ckpts": [ww], "bot_search": ["werewolf"]}, SearchBots)]
    for kw, want in cases:
        h = host(**kw)
        h.start_room("w", "werewolf", 6, seed=1)
        assert isinstance(h._policies["werewolf#r1"], want), kw


def test_determinized_search_tag_and_serving():
    h = host(bot_search=["all"], search_det=2)
    traj = play(h, "d", seed=9, max_cycles=3)
    assert h._policies["werewolf#r1"].ckpt_path == \
        "search(rollouts=2,horizon=24,salt=0,det=2)"
    assert traj


@pytest.mark.parametrize("backend", ["native", "torch"])
def test_jax_and_port_search_hosts_agree_after_every_continue(backend):
    j = JaxGameHost(backend="native", bot_search=["all"], **SMALL)
    p = host(backend, bot_search=["all"])
    for h in (j, p):
        h.start_room("r", "werewolf", 6, seed=31, human_seats=[1, 2])
    for it in range(60):
        sj, sp = j.run_until_input_needed("r"), p.run_until_input_needed("r")
        assert _engine_state(p, "r") == _engine_state(j, "r"), it
        assert _comparable(sp) == _comparable(sj), it
        if sj["done"]:
            break
        for pid in sj["waiting_on"]:
            for h in (j, p):
                h.queue_vote("r", pid, 1 + (it + pid) % 3)
    assert sj["done"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_search_journal_restores_across_packages(tmp_path, writer):
    """A journal with search seats (a compaction snapshot inside it and
    steps after it) written by either package's host restores in the
    other's hosts, both of the port's backends included, to the same
    engine state and projection."""
    pd = str(tmp_path / "journals")
    kw = dict(bot_search=["all"], persist_dir=pd, **SMALL)
    w = (JaxGameHost(backend="native", **kw) if writer == "jax"
         else GameHost(backend="native", device="cpu", **kw))
    w.SNAP_EVERY = 4
    w.start_room("r", "werewolf", 6, seed=21, human_seats=[1])
    for _ in range(3):
        snap = w.run_until_input_needed("r")
        for pid in snap["waiting_on"]:
            w.queue_vote("r", pid, 2)
    w.run_until_input_needed("r")
    with open(os.path.join(pd, "r.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0]["policy_ckpt"] == "search(rollouts=2,horizon=24,salt=0)"
    assert any(ln.get("e") == "snap" for ln in lines)
    ref = w.snapshot("r")
    ref_state = _engine_state(w, "r")
    readers = [GameHost(backend="native", device="cpu", **kw),
               GameHost(backend="torch", device="cpu", **kw),
               JaxGameHost(backend="native", **kw)]
    for r in readers:
        assert r.restore_room("r")
        assert _engine_state(r, "r") == ref_state
        got = r.snapshot("r")
        for k in ("stateVersion", "player_states", "phase_history", "waiting_on"):
            assert got[k] == ref[k], k
