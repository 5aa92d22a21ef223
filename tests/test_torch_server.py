"""The port's HTTP game host (game_engine_tpu_torch/server/) on the torch
backend, on the CPU:

- tests/test_server.py's and test_server_fixes.py's drives on
  ``backend="torch", device="cpu"``, the native-only cases moved onto the
  torch backend;
- the JAX package's ``GameHost(backend="jax")`` and the port's host, fed the
  same game, seed and votes, hold equal ``snapshot_state`` (and equal
  projected snapshots) after every /continue;
- a journal written by either host restores in the other bit for bit,
  compaction snapshots included;
- 65 rooms grow the 64-slot pool and the in-flight rooms come through it
  unchanged;
- with ``--chat-lm`` the port's host and the JAX host post equal chat
  messages, greedy and sampled, and ``make_server`` takes the chat flags;
- the JAX package's own ``jax`` backend raises; the native backend and
  search bots are tests/test_torch_native.py's and test_torch_search*.py's.
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch
import yaml

from game_engine_tpu.server.manager import GameHost as JaxGameHost
from game_engine_tpu_torch.gamespec.parser import games_dir
from game_engine_tpu_torch.server.api import AppContext, make_server
from game_engine_tpu_torch.server.journal import RoomJournal
from game_engine_tpu_torch.server.manager import GameHost, RoomGone
from tests.test_server import req
from tests.test_torch_net import one_torch_thread  # noqa: F401


def torch_host(**kw):
    return GameHost(device="cpu", **kw)


@pytest.fixture(scope="module")
def server():
    srv = make_server(port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()


def _play_http(srv, game, seed, players=("Alice",), vote=lambda it, pid: 1, cycles=120):
    code, d = req(srv, "POST", "/api/rooms/create", {"gameName": game, "playerName": players[0]})
    assert code == 200, d
    rid = d["room"]["roomId"]
    for name in players[1:]:
        req(srv, "POST", "/api/rooms/join", {"roomId": rid, "playerName": name})
    req(srv, "POST", "/api/rooms/add-bot", {"roomId": rid})
    code, snap = req(srv, "POST", f"/api/rooms/{rid}/start", {"seed": seed})
    assert code == 200, snap
    for it in range(cycles):
        code, snap = req(srv, "POST", f"/api/rooms/{rid}/continue")
        assert code == 200, snap
        assert snap.get("truncated") is False
        if snap["done"]:
            break
        assert snap["waiting_on"], "continue stopped without a human to act"
        for pid in snap["waiting_on"]:
            code, _ = req(srv, "POST", f"/api/rooms/{rid}/vote",
                          {"playerId": pid, "option": vote(it, pid)})
            assert code == 200
    return rid, snap


# -- tests/test_server.py on the torch backend ----------------------------------


def test_game_catalog(server):
    code, data = req(server, "GET", "/api/games")
    assert code == 200
    names = [g["name"] for g in data["games"]]
    assert any("werewolf" in n for n in names)
    assert any("two-truths" in n for n in names)


def test_full_lobby_and_game_flow(server):
    code, data = req(server, "POST", "/api/rooms/create",
                     {"gameName": "werewolf", "playerName": "Alice"})
    assert code == 200, data
    room_id = data["room"]["roomId"]
    assert data["player"]["id"] == 1 and data["player"]["isHost"]
    code, data = req(server, "POST", "/api/rooms/join", {"roomId": room_id, "playerName": "Bob"})
    assert code == 200 and data["player"]["id"] == 2
    code, data = req(server, "POST", "/api/rooms/add-bot", {"roomId": room_id})
    assert code == 200 and data["playerCount"] == 4
    code, _ = req(server, "POST", "/api/rooms/join", {"roomId": room_id, "playerName": "Bob"})
    assert code == 400
    code, data = req(server, "GET", "/api/rooms/list?game=werewolf-(mafia)")
    assert code == 200 and any(r["roomId"] == room_id for r in data["rooms"])
    code, snap = req(server, "POST", f"/api/rooms/{room_id}/start", {"seed": 7})
    assert code == 200, snap
    assert snap["current_phase_id"] == 0
    assert len(snap["player_states"]) == 4
    assert snap["player_states"]["1"]["name"] == "Alice"
    assert snap["player_states"]["2"]["name"] == "Bob"
    code, data = req(server, "GET", "/api/rooms/list?game=werewolf-(mafia)")
    assert not any(r["roomId"] == room_id for r in data["rooms"])
    assert snap["human_seats"] == [1, 2]
    for _ in range(80):
        code, snap = req(server, "POST", f"/api/rooms/{room_id}/continue")
        assert code == 200, snap
        assert snap.get("truncated") is False
        if snap["done"]:
            break
        assert snap["waiting_on"]
        for pid in snap["waiting_on"]:
            code, _ = req(server, "POST", f"/api/rooms/{room_id}/vote",
                          {"playerId": pid, "option": 1})
            assert code == 200
    assert snap["done"] and snap["winner"] in (1, 2)
    code, view1 = req(server, "GET", f"/api/rooms/{room_id}/state?playerId=1")
    assert code == 200
    for item in view1["items"]:
        assert item["data"]["audience_type"] or "1" in item["data"]["audience_ids"]
    hist = view1["phase_history"]
    assert hist[-1]["phase_id"] == 99
    assert all("phase_name" in h and "timestamp" in h for h in hist)


def test_two_truths_full_game(server):
    """test_server.py's native-backend drive, on the torch backend."""
    _, snap = _play_http(server, "two-truths", 3, players=("Nat",))
    assert snap["done"] and snap["winner"] >= 1


def test_overflow_action_is_ignored(server):
    code, d = req(server, "POST", "/api/rooms/create", {"gameName": "werewolf", "playerName": "Ovf"})
    room_id = d["room"]["roomId"]
    req(server, "POST", "/api/rooms/add-bot", {"roomId": room_id})
    req(server, "POST", f"/api/rooms/{room_id}/start", {"seed": 1})
    code, _ = req(server, "POST", f"/api/rooms/{room_id}/action", {"playerId": 1, "choice": 2**40})
    assert code == 200
    code, snap = req(server, "POST", f"/api/rooms/{room_id}/step")
    assert code == 200 and snap["current_phase_id"] == 1


def test_double_start_rejected_and_close_frees_slot(server):
    code, d = req(server, "POST", "/api/rooms/create", {"gameName": "werewolf", "playerName": "Dbl"})
    room_id = d["room"]["roomId"]
    req(server, "POST", "/api/rooms/add-bot", {"roomId": room_id})
    code, _ = req(server, "POST", f"/api/rooms/{room_id}/start", {"seed": 1})
    assert code == 200
    code, data = req(server, "POST", f"/api/rooms/{room_id}/start", {"seed": 2})
    assert code == 409, data
    code, data = req(server, "POST", f"/api/rooms/{room_id}/close")
    assert code == 200 and data["closed"]
    code, _ = req(server, "POST", f"/api/rooms/{room_id}/step")
    assert code == 409


def test_room_errors(server):
    assert req(server, "GET", "/api/rooms/nonexistent")[0] == 404
    assert req(server, "POST", "/api/rooms/create", {"gameName": "no-such-game"})[0] == 404
    assert req(server, "POST", "/api/rooms/nonexistent/step")[0] == 404
    code, data = req(server, "DELETE", "/api/rooms/nonexistent")
    assert code == 405 and "error" in data


def test_web_client_pages(server):
    conn_port = server.server_address[1]
    from http.client import HTTPConnection

    for path, ctype in (("/", "text/html"), ("/static/app.js", "text/javascript"),
                        ("/static/style.css", "text/css")):
        conn = HTTPConnection("127.0.0.1", conn_port, timeout=30)
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        assert resp.status == 200 and resp.getheader("Content-Type").startswith(ctype)
        assert body


def test_viewer_state_masks_hidden_roles(server):
    code, d = req(server, "POST", "/api/rooms/create",
                  {"gameName": "werewolf", "playerName": "Maskie"})
    room_id = d["room"]["roomId"]
    req(server, "POST", "/api/rooms/add-bot", {"roomId": room_id})
    req(server, "POST", f"/api/rooms/{room_id}/start", {"seed": 2})
    code, snap = req(server, "POST", f"/api/rooms/{room_id}/step")
    assert snap["current_phase_id"] == 1
    true_roles = {p: r["role"] for p, r in snap["player_states"].items()}
    code, view = req(server, "GET", f"/api/rooms/{room_id}/state?playerId=1")
    ps = view["player_states"]
    assert ps["1"]["role"] == true_roles["1"]
    my_team = snap["player_states"]["1"]["team"]
    for pid, row in ps.items():
        if pid == "1":
            continue
        if snap["player_states"][pid]["team"] == my_team and my_team == "werewolves":
            assert row["role"] == true_roles[pid]
        else:
            assert row["role"] is None and row["team"] is None


def test_crash_resume_restores_room_bit_identically(tmp_path):
    sp = str(tmp_path / "rooms.json")
    ctx = AppContext(sp, device="cpu")
    _, d = ctx.handle("POST", "/api/rooms/create", {}, {"gameName": "werewolf", "playerName": "Alice"})
    rid = d["room"]["roomId"]
    ctx.handle("POST", "/api/rooms/add-bot", {}, {"roomId": rid})
    ctx.handle("POST", f"/api/rooms/{rid}/start", {}, {"seed": 11})
    for _ in range(2):
        _, snap = ctx.handle("POST", f"/api/rooms/{rid}/continue", {}, {})
        assert not snap["done"]
        for pid in snap["waiting_on"]:
            ctx.handle("POST", f"/api/rooms/{rid}/vote", {}, {"playerId": pid, "option": 2})
    ctx.handle("POST", f"/api/rooms/{rid}/chat", {}, {"playerId": 1, "message": "who do you suspect?"})
    ref = ctx.host.snapshot(rid)
    _, ref_chat = ctx.handle("GET", f"/api/rooms/{rid}/chat", {"playerId": ["1"]}, {})
    del ctx

    ctx2 = AppContext(sp, device="cpu")
    code, _ = ctx2.handle("GET", f"/api/rooms/{rid}/state", {"playerId": ["1"]}, {})
    assert code == 200
    snap2 = ctx2.host.snapshot(rid)
    for k in ("stateVersion", "current_phase_id", "player_states", "phase_history"):
        assert snap2[k] == ref[k], k
    _, chat2 = ctx2.handle("GET", f"/api/rooms/{rid}/chat", {"playerId": ["1"]}, {})
    assert [(m["message"], m["timestamp"]) for m in chat2["messages"]] == \
        [(m["message"], m["timestamp"]) for m in ref_chat["messages"]]
    for _ in range(200):
        code, snap = ctx2.handle("POST", f"/api/rooms/{rid}/continue", {}, {})
        assert code == 200, snap
        if snap["done"]:
            break
        for pid in snap["waiting_on"]:
            ctx2.handle("POST", f"/api/rooms/{rid}/vote", {}, {"playerId": pid, "option": 1})
    assert snap["done"]


def test_orphaned_playing_room_marked_finished(tmp_path):
    sp = str(tmp_path / "rooms.json")
    ctx = AppContext(sp, device="cpu")
    _, d = ctx.handle("POST", "/api/rooms/create", {}, {"gameName": "two-truths", "playerName": "Orp"})
    rid = d["room"]["roomId"]
    ctx.handle("POST", "/api/rooms/add-bot", {}, {"roomId": rid})
    ctx.handle("POST", f"/api/rooms/{rid}/start", {}, {"seed": 1})
    os.remove(sp + ".rooms/" + rid + ".jsonl")
    del ctx
    ctx2 = AppContext(sp, device="cpu")
    code, data = ctx2.handle("POST", f"/api/rooms/{rid}/step", {}, {})
    assert code in (409, 410) and "error" in data
    _, room = ctx2.handle("GET", f"/api/rooms/{rid}", {}, {})
    assert room["room"]["status"] == "finished"


def test_free_text_statements_surface_in_state(server):
    code, d = req(server, "POST", "/api/rooms/create", {"gameName": "two-truths", "playerName": "Stmt"})
    room_id = d["room"]["roomId"]
    req(server, "POST", "/api/rooms/add-bot", {"roomId": room_id})
    code, snap = req(server, "POST", f"/api/rooms/{room_id}/start", {"seed": 5})
    assert code == 200, snap
    mine = ["I own a boat", "I hate pizza", "I ran a marathon"]
    seen_mine = seen_bot = False
    for _ in range(80):
        code, snap = req(server, "POST", f"/api/rooms/{room_id}/continue")
        assert code == 200, snap
        if snap["done"]:
            break
        for pid in snap["waiting_on"]:
            code, _ = req(server, "POST", f"/api/rooms/{room_id}/action",
                          {"playerId": pid, "choice": 1, "text": "\n".join(mine)})
            assert code == 200
        for p, row in snap["player_states"].items():
            stmts = row.get("statements") or {}
            if not stmts:
                continue
            assert stmts != {"1": "submitted"}
            seen_mine |= p == "1" and list(stmts.values()) == mine
            seen_bot |= p != "1" and len(stmts) == 3
    assert snap["done"] and seen_mine and seen_bot


def test_two_games_hosted_concurrently(server):
    rooms = {}
    for game in ("werewolf", "two-truths"):
        code, data = req(server, "POST", "/api/rooms/create",
                         {"gameName": game, "playerName": f"host-{game}"})
        rid = data["room"]["roomId"]
        req(server, "POST", "/api/rooms/add-bot", {"roomId": rid})
        code, snap = req(server, "POST", f"/api/rooms/{rid}/start", {"seed": 1})
        assert code == 200, snap
        rooms[game] = rid
    code, s1 = req(server, "POST", f"/api/rooms/{rooms['werewolf']}/step")
    code, s2 = req(server, "GET", f"/api/rooms/{rooms['two-truths']}/state?playerId=1")
    assert s1["current_phase_id"] == 1 and s2["current_phase_id"] == 0
    assert s2["gameName"].startswith("two-truths")


def test_corrupt_journal_event_fails_restore_cleanly(tmp_path):
    sp = str(tmp_path / "rooms.json")
    ctx = AppContext(sp, device="cpu")
    _, d = ctx.handle("POST", "/api/rooms/create", {}, {"gameName": "werewolf", "playerName": "C"})
    rid = d["room"]["roomId"]
    ctx.handle("POST", "/api/rooms/add-bot", {}, {"roomId": rid})
    ctx.handle("POST", f"/api/rooms/{rid}/start", {}, {"seed": 11})
    ctx.handle("POST", f"/api/rooms/{rid}/continue", {}, {})
    del ctx
    path = sp + ".rooms/" + rid + ".jsonl"
    lines = open(path).read().splitlines()
    lines[2] = json.dumps({"e": "chat", "text": "missing pid"})
    open(path, "w").write("\n".join(lines) + "\n")
    ctx2 = AppContext(sp, device="cpu")
    assert not ctx2.host.has_room(rid)
    assert ctx2.handle("GET", f"/api/rooms/{rid}/state", {"playerId": ["1"]}, {})[0] == 410
    assert os.path.exists(path)


def test_replay_injects_journaled_bot_reply_without_recompute(tmp_path):
    pd = str(tmp_path / "journals")
    calls = []

    def fake_lm(ctx):
        calls.append(ctx)
        return f"lm-reply-{len(calls)}"

    host = torch_host(persist_dir=pd)
    host._chat_lm_hook = fake_lm
    host.start_room("r1", "werewolf", 5, seed=4)
    host.post_chat("r1", 1, "hello there")
    host.post_chat("r1", 1, "to Bot 2: who looks guilty?")
    ref = host.chat_messages("r1", 1)
    assert any(m["message"].startswith("lm-reply") for m in ref)
    n_calls = len(calls)
    host2 = torch_host(persist_dir=pd)
    assert host2.restore_room("r1")
    got = host2.chat_messages("r1", 1)
    assert [(m["message"], m["id"]) for m in got] == [(m["message"], m["id"]) for m in ref]
    assert len(calls) == n_calls


def test_spectator_view_masks_everything_private():
    ctx = AppContext(None, device="cpu")
    _, d = ctx.handle("POST", "/api/rooms/create", {}, {"gameName": "werewolf", "playerName": "A"})
    rid = d["room"]["roomId"]
    ctx.handle("POST", "/api/rooms/add-bot", {}, {"roomId": rid})
    ctx.handle("POST", f"/api/rooms/{rid}/start", {}, {"seed": 2})
    ctx.handle("POST", f"/api/rooms/{rid}/continue", {}, {})
    code, spec = ctx.handle("GET", f"/api/rooms/{rid}/state", {"playerId": ["0"]}, {})
    assert code == 200
    assert all(r.get("role") is None for r in spec["player_states"].values())
    _, p1 = ctx.handle("GET", f"/api/rooms/{rid}/state", {"playerId": ["1"]}, {})
    assert p1["player_states"]["1"]["role"]
    assert len(spec["items"]) <= len(p1["items"])


# -- tests/test_server_fixes.py on the torch backend ----------------------------


def _gdir(tmp_path, *files):
    gdir = tmp_path / "games"
    gdir.mkdir(exist_ok=True)
    for fn in files:
        shutil.copy(os.path.join(games_dir(), fn), gdir / fn)
    return str(gdir)


def test_journal_torn_tail_repaired_on_reattach(tmp_path):
    path = str(tmp_path / "room.jsonl")
    j = RoomJournal(path)
    j.create({"game": "werewolf", "n": 5})
    j.append({"k": "step", "t": 1})
    j.append({"k": "step", "t": 2})
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"k": "st')
    RoomJournal(path).append({"k": "step", "t": 3})
    header, events = RoomJournal.load(path)
    assert header["game"] == "werewolf" and [e["t"] for e in events] == [1, 2, 3]
    with open(path, encoding="utf-8") as f:
        for line in f:
            json.loads(line)


def test_projection_cached_for_named_reads(tmp_path):
    host = torch_host(games_path=_gdir(tmp_path, "tide-pool.yaml"))
    host.start_room("r", "tide-pool", 4, seed=5, human_seats=[4])
    host.run_until_input_needed("r", max_steps=8)
    names = {1: "A", 2: "B", 3: "C", 4: "D"}
    a = host.snapshot("r", names)
    for _ in range(5):
        b = host.snapshot("r", names)
    assert [(i["id"], i["type"]) for i in a["items"]] == [(i["id"], i["type"]) for i in b["items"]]
    assert a["stateVersion"] == b["stateVersion"]


def test_post_chat_after_end_room_raises_room_gone(tmp_path):
    host = torch_host(games_path=_gdir(tmp_path, "tide-pool.yaml"))
    host.start_room("r", "tide-pool", 4, seed=1, human_seats=[1])
    host.end_room("r")
    with pytest.raises(RoomGone):
        host.post_chat("r", 1, "hello?", {1: "A"})


def test_exact_game_name_beats_substring(tmp_path):
    from game_engine_tpu_torch.gamespec.parser import load_game_spec

    gdir = _gdir(tmp_path, "auction-house.yaml")
    doc = yaml.safe_load(open(os.path.join(games_dir(), "auction-house.yaml")))
    doc["declaration"]["description"] = "A grander auction."
    with open(os.path.join(gdir, "a-grand-auction-house-hall.yaml"), "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
    n_decoy = load_game_spec(os.path.join(gdir, "a-grand-auction-house-hall.yaml")).name
    n_exact = load_game_spec(os.path.join(gdir, "auction-house.yaml")).name
    assert n_exact in n_decoy and n_decoy != n_exact
    assert torch_host(games_path=gdir)._game_slots(n_exact).lowered.game.spec.name == n_exact
    assert torch_host(games_path=gdir)._game_slots("grand-auction").lowered.game.spec.name \
        == n_decoy


def test_role_card_tool_renders_character_cards(tmp_path):
    from game_engine_tpu_torch.view.cards import TOOL_TO_CARD

    assert TOOL_TO_CARD["createRoleCard"] == "character_card"
    host = torch_host(games_path=_gdir(tmp_path, "midnight-circle.yaml"))
    host.start_room("r", "midnight-circle", 5, seed=3, human_seats=[1])
    snap = host.run_until_input_needed("r", max_steps=12)
    cards = [i for i in snap["items"] if i["type"] == "character_card"]
    assert cards
    for c in cards:
        d = c.get("data") or {}
        assert d.get("audience_type") is False and len(d.get("audience_ids") or []) == 1


def test_scoreboard_uses_game_over_score_field():
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.view.project import Projector

    proj = Projector(compile_game(load_builtin("tide-pool")))
    assert proj._score_field() == "pearls"
    snap = {"current_phase_id": 2, "done": False, "winner": 0, "deadPlayers": [],
            "player_states": {
                "1": {"name": "A", "pearls": 4, "stash": 0, "dive_pick": 0, "rounds": 1},
                "2": {"name": "B", "pearls": 2, "stash": 1, "dive_pick": 0, "rounds": 1}}}
    boards = [i for i in proj.project(snap) if i.type == "score_board"]
    assert {e["name"]: e["score"] for e in boards[-1].data.get("entries")} == {"A": 4, "B": 2}


def test_multi_terminal_winner_text_uses_ending_terminal():
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.view.project import Projector

    game = compile_game(load_builtin("gold-rush"))
    team_terms = [(p, m) for p in game.phases if p.terminal for m in p.program.on_enter
                  if getattr(m, "mode", None) == "team"]
    phase, mech = team_terms[0]
    snap = {"current_phase_id": phase.dsl_id, "done": True, "winner": 1,
            "player_states": {"1": {"name": "Alice"}}}
    assert Projector(game)._winner_text(1, snap) == mech.team_order[0]


def test_tier3_empty_targets_stay_private():
    from game_engine_tpu_torch.view.project import _audience

    assert _audience(3, "TIER 3 - PRIVATE: your role", [], ["1", "2"]) == (False, [])
    assert _audience(3, "TIER 3", ["2"], ["1", "2"])[1] == ["2"]


def test_serving_path_validates_games(tmp_path):
    gdir = _gdir(tmp_path, "tide-pool.yaml")
    doc = yaml.safe_load(open(os.path.join(gdir, "tide-pool.yaml")))
    doc["phases"][2]["next_phase"] = {"Otherwise the diving continues":
                                      {"id": 1, "name": "Depth Choice"}}
    with open(os.path.join(gdir, "broken.yaml"), "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
    host = torch_host(games_path=gdir)
    with pytest.raises(ValueError, match="failed validation"):
        host.start_room("r", "broken", 4, seed=1, human_seats=[1])
    host.start_room("ok", "tide-pool", 4, seed=1, human_seats=[1])


# -- the JAX host and the port's, request for request ---------------------------


def _engine_state(host, rid):
    key, slot = host._rooms[rid]
    return host._slots[key].snapshot_state(slot)


def _comparable(snap):
    """A projected snapshot without its wall clocks."""
    out = dict(snap)
    for k in ("phase_history", "game_notes"):
        out[k] = [{f: v for f, v in e.items() if f != "timestamp"} for e in snap[k]]
    return out


@pytest.mark.parametrize("game,n,humans,seed", [
    ("werewolf", 6, [1, 2], 5), ("werewolf", 8, [3], 17), ("two-truths", 4, [1], 2)])
def test_jax_and_torch_hosts_agree_after_every_continue(game, n, humans, seed):
    """The same game, seed, votes and texts into both hosts, with a second,
    bot-only room of the same game live beside it (so the batched step
    advances it too): equal engine state and equal projected snapshots
    after every /continue."""
    j, p = JaxGameHost(backend="jax"), torch_host()
    for h in (j, p):
        h.start_room("r", game, n, seed=seed, human_seats=humans)
        h.start_room("side", game, n, seed=seed + 100, human_seats=[n])
    for it in range(80):
        sj, sp = j.run_until_input_needed("r"), p.run_until_input_needed("r")
        for rid in ("r", "side"):
            assert _engine_state(p, rid) == _engine_state(j, rid), (it, rid)
        assert _comparable(sp) == _comparable(sj), it
        if sj["done"]:
            break
        for pid in sj["waiting_on"]:
            for h in (j, p):
                if it % 2:
                    h.queue_vote("r", pid, 1 + (it + pid) % 3)
                else:
                    h.queue_action("r", pid, 1 + (it + pid) % 4, text=f"line {it}\nline {pid}")
    assert sj["done"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_restores_across_packages(tmp_path, writer):
    """A journal written by either host (with a compaction snapshot inside
    it and steps after it) restores in the other to the same engine state,
    chat and projection. (Items are compared between the two readers: a
    restore in either package rebuilds them without the avatar set the live
    room had.)"""
    pd = str(tmp_path / "journals")
    w = JaxGameHost(backend="jax", persist_dir=pd) if writer == "jax" else torch_host(persist_dir=pd)
    w.SNAP_EVERY = 4
    w.start_room("r", "werewolf", 6, seed=21, human_seats=[1])
    for it in range(3):
        snap = w.run_until_input_needed("r")
        for pid in snap["waiting_on"]:
            w.queue_vote("r", pid, 2)
        w.post_chat("r", 1, "to Bot 2: who do you suspect?")
    w.run_until_input_needed("r")
    with open(os.path.join(pd, "r.jsonl")) as f:
        assert any(json.loads(ln).get("e") == "snap" for ln in f)
    ref = w.snapshot("r")
    ref_state = _engine_state(w, "r")
    ref_chat = w.chat_messages("r", 1)
    readers = [torch_host(persist_dir=pd), JaxGameHost(backend="jax", persist_dir=pd)]
    items = []
    for r in readers:
        assert r.restore_room("r")
        assert _engine_state(r, "r") == ref_state
        got = r.snapshot("r")
        for k in ("stateVersion", "player_states", "phase_history", "waiting_on"):
            assert got[k] == ref[k], k
        assert r.chat_messages("r", 1) == ref_chat
        items.append(got["items"])
    assert items[0] == items[1]


def test_pool_growth_keeps_in_flight_rooms():
    """65 live rooms of one game: the 64-slot pool doubles, and the rooms
    stepped before the growth keep their arrays (device and host mirror)
    and play on."""
    host = torch_host()
    for i in range(64):
        host.start_room(f"g{i}", "werewolf", 6, seed=i, human_seats=[1])
    for rid in ("g0", "g31", "g63"):
        host.run_until_input_needed(rid)
    gs = host._slots["werewolf#r1"]
    assert gs.capacity == 64 and not gs.free
    before = {rid: _engine_state(host, rid) for rid in ("g0", "g31", "g63")}
    dev_before = [f.clone() for f in gs.state]
    host.start_room("g64", "werewolf", 6, seed=64, human_seats=[1])
    assert gs.capacity == 128 and len(gs.free) == 63
    assert host._rooms["g64"][1] == 64
    for f, b in zip(gs.state, dev_before):
        assert f.shape[0] == 128 and torch.equal(f[:64], b)
    for rid, st in before.items():
        assert _engine_state(host, rid) == st
    ref = torch_host()
    ref.start_room("g64", "werewolf", 6, seed=64, human_seats=[1])
    assert _engine_state(host, "g64") == _engine_state(ref, "g64")
    for rid in ("g0", "g64"):
        assert host.run_until_input_needed(rid)["stateVersion"] >= 1
    for name, arr in gs.host.items():
        assert arr.shape[0] == 128, name
    mirror = gs.host
    for name, f in zip(type(gs.state)._fields, gs.state):
        want = f.numpy().astype(np.int64) if name == "seed" else f.numpy()
        np.testing.assert_array_equal(mirror[name], want, err_msg=name)


# -- the chat LM ------------------------------------------------------------------

CHAT_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "docs", "checkpoints", "chat_lm.npz")


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "sampled"])
def test_chat_lm_messages_equal_the_jax_hosts(temp, one_torch_thread):
    """--chat-lm on both hosts, the same seed and the same chat posts: equal
    chat messages (but their wall-clock timestamps), the learned tier
    answering on the port (its plain decode on the CPU) where it answers on
    the JAX host."""
    import functools

    j = JaxGameHost(backend="jax", chat_lm=CHAT_CKPT, chat_sample_temp=temp)
    p = torch_host(chat_lm=CHAT_CKPT, chat_sample_temp=temp)
    served = []
    hook = p._chat_lm_hook

    @functools.wraps(hook)
    def counted(ctx):
        out = hook(ctx)
        served.append(out)
        return out

    p._chat_lm_hook = counted
    assert (hook.sampling, j._chat_lm_hook.sampling) == (temp > 0, temp > 0)
    for h in (j, p):
        h.start_room("r", "werewolf", 6, seed=3, human_seats=[1])
        h.run_until_input_needed("r")
        h.post_chat("r", 1, "hello there")
        h.post_chat("r", 1, "to Bot 2: who is still alive?")
    def messages(h):  # without the wall clock
        return [{k: v for k, v in m.items() if k != "timestamp"} for m in h.chat_messages("r", 1)]

    assert messages(p) == messages(j)
    assert len(messages(p)) >= 4 and any(served)


def test_make_server_accepts_the_chat_lm_flags(tmp_path, one_torch_thread):
    srv = make_server(port=0, storage_path=str(tmp_path / "rooms.json"), device="cpu",
                      chat_lm=CHAT_CKPT, chat_sample_temp=0.8)
    hook = srv.ctx.host._chat_lm_hook
    assert hook.sampling and hook.grounded and hook.params["tok"].device.type == "cpu"
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        code, d = req(srv, "POST", "/api/rooms/create", {"gameName": "werewolf",
                                                          "playerName": "Vera"})
        rid = d["room"]["roomId"]
        req(srv, "POST", "/api/rooms/add-bot", {"roomId": rid})
        code, _ = req(srv, "POST", f"/api/rooms/{rid}/start", {"seed": 4})
        assert code == 200
        code, _ = req(srv, "POST", f"/api/rooms/{rid}/chat",
                      {"playerId": 1, "message": "to Bot 2: hello there"})
        assert code == 200
        code, chat = req(srv, "GET", f"/api/rooms/{rid}/chat?playerId=1")
        assert code == 200 and len(chat["messages"]) >= 2
    finally:
        srv.shutdown()


# -- what the port does not have -------------------------------------------------


@pytest.mark.parametrize("kw,item", [({"backend": "jax"}, "torch")])
def test_unported_backends_and_tiers_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        GameHost(device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=item):
        make_server(port=0, device="cpu", **kw)


def test_load_test_client_drives_the_cpu_server(tmp_path):
    """utils/load_test.py's Client against the port's server on the CPU:
    games complete with no request errors."""
    import time

    from game_engine_tpu_torch.utils.load_test import Client

    srv = make_server(0, str(tmp_path / "rooms.json"), device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    stop, stats, lock = threading.Event(), {}, threading.Lock()
    clients = [Client(srv.server_address[1], "werewolf", 2, stop, stats, lock, c)
               for c in range(2)]
    for c in clients:
        c.start()
    t0 = time.time()
    while stats.get("games_done", 0) < 2 and time.time() - t0 < 60:
        time.sleep(0.2)
    stop.set()
    for c in clients:
        c.join(timeout=30)
    srv.shutdown()
    assert stats.get("errors", 0) == 0, stats.get("error_samples")
    assert stats.get("games_done", 0) >= 2 and stats["continue"]


def test_chat_poster_passes_over_rooms_the_lobby_has_not_started(tmp_path):
    """chip_smoke.py's chat client against the port's server on the CPU. A
    room is in the host from the start of its /start call and playing in
    the lobby only after; a chat in between is answered 409 "room not
    started", so the client passes the room over and counts it, and chats
    there once the start has been answered, with no request errors."""
    import time

    import chip_smoke

    srv = make_server(0, str(tmp_path / "rooms.json"), device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    storage, host = srv.ctx.storage, srv.ctx.host
    lobby_may_go, set_thread = threading.Event(), storage.set_thread

    def held_set_thread(*a):  # hold /start between the host and the lobby
        lobby_may_go.wait(60)
        set_thread(*a)

    storage.set_thread = held_set_thread
    try:
        _, d = req(srv, "POST", "/api/rooms/create", {"gameName": "werewolf",
                                                       "playerName": "Vera"})
        rid = d["room"]["roomId"]
        req(srv, "POST", "/api/rooms/add-bot", {"roomId": rid})
        started = threading.Thread(
            target=req, args=(srv, "POST", f"/api/rooms/{rid}/start", {"seed": 4}))
        started.start()
        t0 = time.time()
        while not host.has_room(rid) and time.time() - t0 < 60:
            time.sleep(0.01)
        assert host.has_room(rid)
        code, d = req(srv, "POST", f"/api/rooms/{rid}/chat", {"playerId": 1, "message": "hi"})
        assert (code, d) == (409, {"error": "room not started"})

        def post(until) -> dict:
            stop, stats, lock = threading.Event(), {}, threading.Lock()
            poster = threading.Thread(target=chip_smoke.chat_poster, args=(
                srv.server_address[1], host, storage, stop, stats, lock))
            poster.start()
            t0 = time.time()
            while not (until(stats) or stats.get("errors")) and time.time() - t0 < 30:
                time.sleep(0.01)
            stop.set()
            poster.join(timeout=60)
            return stats

        held = post(lambda s: s.get("chat_unstarted_skips", 0) >= 3)
        assert held.get("chat_unstarted_skips", 0) >= 3 and "chat" not in held
        lobby_may_go.set()
        started.join(timeout=60)
        served = post(lambda s: len(s.get("chat", [])) >= 2)
        assert len(served.get("chat", [])) >= 2 and "chat_unstarted_skips" not in served
        for stats in (held, served):
            assert stats.get("errors", 0) == 0, stats.get("error_samples")
    finally:
        lobby_may_go.set()
        srv.shutdown()
