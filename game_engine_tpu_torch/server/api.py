"""HTTP API: the reference's rooms/lobby/games REST surface + play endpoints.

Counterpart of game_engine_tpu/server/api.py over the port's GameHost
(server/manager.py): the same routes and web client, served from the torch
backend on the card (``--device cuda``, the default) or on the CPU
(``--device cpu``, or ``--cpu``).

    python -m game_engine_tpu_torch.server.api --device cpu --port 8123

Routes (reference: SURVEY.md §2.4, src/app/api/*):
  GET  /api/games                      -> game catalog from games/*.yaml
  POST /api/rooms/create               {gameName, playerName}
  POST /api/rooms/join                 {roomId, playerName}
  POST /api/rooms/add-bot              {roomId}  (fills to min_players)
  GET  /api/rooms/list?game=...        joinable rooms
  GET  /api/rooms/<roomId>             room + players
  POST /api/rooms/<roomId>/start       initialize players + engine slot
  POST /api/rooms/<roomId>/chat        {playerId, message}  -> msg + bot reply
  GET  /api/rooms/<roomId>/chat?playerId=N  visible chat messages
  POST /api/rooms/<roomId>/action      {playerId, choice}   (queue)
  POST /api/rooms/<roomId>/vote        {playerId, option}   (queue, panel index)
  POST /api/rooms/<roomId>/step        advance one turn
  POST /api/rooms/<roomId>/continue    advance until human input needed
  GET  /api/rooms/<roomId>/state?playerId=N  -> AgentState + visible items
                                       (items audience-gated, private fields masked)
  GET  /api/rooms/<roomId>/notes       game_notes narrative log
  POST /api/generate-dsl               {gameName, gameDescription[, overwrite]}
                                       -> new game YAML (409 on name collision
                                       without overwrite=true)
  GET  /api/games/<name>/explain       compile-explain: attached mechanics,
                                       record programs, effect summaries,
                                       terminals, field visibility
  POST /api/explain                    {yaml[, gameName]} -> validate +
                                       explain UNSAVED YAML (author loop)
  GET  /api/debug/rooms                storage dump
  GET  /, /register, /library, /room, /play   web client pages
  GET  /static/<asset>                 client js/css (server/web/)

Plain stdlib http.server — the host service is IO-thin; the engine steps
and the policy bots run on the host's device (server/manager.py).
"""

from __future__ import annotations

import json
import os
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, unquote, urlparse

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.server.manager import GameHost, RoomGone
from game_engine_tpu_torch.server.storage import MemoryStorage


class StaticAsset(str):
    """A served file body carrying its content type (str subclass so the
    HTTP layer's string/JSON switch stays trivial)."""

    def __new__(cls, body: str, ctype: str):
        s = super().__new__(cls, body)
        s.ctype = ctype
        return s


def _load_llm_complete(llm_cmd: Optional[str], llm_entry: Optional[str],
                       timeout: float = 900):
    """Build a completion function for an external-model seam.

    llm_cmd:   shell command; receives the prompt on stdin and must print
               the completion on stdout. The generate-dsl default ceiling
               of 900 s mirrors the reference's poll limit
               (src/app/api/generate-dsl/route.ts:51-56); the chat seam
               uses a much shorter one (a chat bubble, not a game).
    llm_entry: 'module:function' Python entrypoint resolving to
               complete(prompt: str) -> str.
    """
    if llm_cmd:
        import subprocess

        def complete(prompt: str) -> str:
            p = subprocess.run(llm_cmd, shell=True, input=prompt.encode(),
                               capture_output=True, timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(
                    f"llm-cmd exited {p.returncode}: "
                    f"{p.stderr.decode(errors='replace')[:300]}")
            return p.stdout.decode(errors="replace")

        return complete
    if llm_entry:
        import importlib

        mod, _, fn = llm_entry.partition(":")
        complete = getattr(importlib.import_module(mod), fn or "complete")
        if not callable(complete):
            raise TypeError(f"llm entry {llm_entry!r} is not callable")
        return complete
    return None


class AppContext:
    def __init__(self, storage_path: Optional[str] = None, games_path: Optional[str] = None,
                 backend: str = "torch", chat_lm: Optional[str] = None,
                 bot_ckpts: Optional[list] = None, llm_cmd: Optional[str] = None,
                 llm_entry: Optional[str] = None,
                 chat_sample_temp: float = 0.0,
                 chat_llm_cmd: Optional[str] = None,
                 chat_llm_entry: Optional[str] = None,
                 bot_search: Optional[list] = None,
                 search_rollouts: int = 32,
                 search_horizon: int = 200,
                 search_det: int = 0,
                 device=D.DEFAULT):
        self.storage = MemoryStorage(storage_path)
        persist_dir = (storage_path + ".rooms") if storage_path else None
        # external chat model (reference ChatBotNode's gpt call,
        # agent/game_agent_v2.py:385): top responder tier, host-verified —
        # see server/chat_llm.py. 120 s ceiling: a chat bubble, not a game.
        chat_complete = _load_llm_complete(chat_llm_cmd, chat_llm_entry,
                                           timeout=120)
        self.host = GameHost(games_path, backend=backend, persist_dir=persist_dir,
                             chat_lm=chat_lm, bot_ckpts=bot_ckpts,
                             chat_sample_temp=chat_sample_temp,
                             chat_complete=chat_complete,
                             bot_search=bot_search, search_rollouts=search_rollouts,
                             search_horizon=search_horizon, search_det=search_det,
                             device=device)
        # /api/generate-dsl model seam (reference: 3 gpt-5 calls behind
        # src/app/api/generate-dsl/route.ts:19-48). A deployment brings its
        # own model as a shell command (prompt on stdin -> YAML on stdout)
        # or a Python entrypoint; without one the deterministic archetype
        # generator serves the endpoint, loudly, as before.
        self._llm_complete = _load_llm_complete(llm_cmd, llm_entry)
        self._restore_playing_rooms()

    def _restore_playing_rooms(self) -> None:
        """Crash recovery: replay journals for rooms persisted as 'playing';
        rooms whose journal is missing/corrupt are marked finished so clients
        get a clear 409 instead of a KeyError-shaped 400."""
        for room_id, room in list(self.storage.dump()["rooms"].items()):
            if room["status"] != "playing":
                continue
            try:
                ok = self.host.restore_room(room_id)
            except Exception:
                ok = False
            if not ok:
                self.storage.set_status(room_id, "finished")

    # -- web client (lobby flow + play canvas) ----------------------------------

    _PAGES = {
        "/": "library.html",  # registered users land in the library
        "/index.html": "library.html",
        "/register": "register.html",
        "/library": "library.html",
        "/room": "room.html",
        "/play": "play.html",
    }
    _STATIC_TYPES = {
        ".html": "text/html; charset=utf-8",
        ".js": "text/javascript; charset=utf-8",
        ".css": "text/css; charset=utf-8",
    }

    def _page_for(self, method: str, path: str) -> Optional[tuple[int, Any]]:
        """Serve the web client: lobby pages + /static assets (reference
        pages: register/game-library/room/play, SURVEY.md §2.4)."""
        if method != "GET":
            return None
        web = os.path.join(os.path.dirname(__file__), "web")
        name = self._PAGES.get(path)
        if name is None and path.startswith("/static/"):
            name = os.path.basename(path[len("/static/"):])
        if name is None:
            return None
        ext = os.path.splitext(name)[1]
        ctype = self._STATIC_TYPES.get(ext)
        full = os.path.join(web, name)
        if ctype is None or not os.path.isfile(full):
            return 404, {"error": f"no such asset {name!r}"}
        with open(full, "r", encoding="utf-8") as f:
            return 200, StaticAsset(f.read(), ctype)

    # -- handlers -------------------------------------------------------------

    def handle(self, method: str, path: str, query: dict, body: dict) -> tuple[int, Any]:
        route = (method, path)
        try:
            page = self._page_for(method, path)
            if page is not None:
                return page
            if route == ("GET", "/api/games"):
                return 200, {"games": self.host.list_games()}
            if route == ("POST", "/api/explain"):
                # author loop: validate + compile-explain UNSAVED YAML, so
                # a game can be iterated before it lands in games/
                import yaml as _yaml

                from game_engine_tpu_torch.dslgen.explain import explain_spec
                from game_engine_tpu_torch.dslgen.validate import errors, validate_doc

                try:
                    doc = _yaml.safe_load(str(body["yaml"]))
                except Exception as e:  # noqa: BLE001 — bad YAML is a 422
                    return 422, {"error": f"invalid YAML: {e}"}
                issues, spec = validate_doc(doc, name=str(
                    body.get("gameName", "draft")))
                out: dict[str, Any] = {
                    "issues": [str(i) for i in issues],
                    "errors": [str(i) for i in errors(issues)],
                }
                if spec is not None and not errors(issues):
                    try:
                        out["explain"] = explain_spec(spec)
                    except Exception as e:  # noqa: BLE001
                        out["errors"] = [f"game does not compile: {e}"]
                return (200 if not out["errors"] else 422), out
            m = re.match(r"^/api/games/([^/]+)/explain$", path)
            if m and method == "GET":
                # compile-explain for game authors: what the analyzer
                # attached per phase, record programs, effect summaries,
                # terminals, field visibility (dslgen/explain.py)
                from game_engine_tpu_torch.dslgen.explain import explain_spec

                name = unquote(m.group(1))  # clients quote '(' etc.
                try:
                    spec = self.host.game_spec(name)
                except KeyError:
                    return 404, {"error": f"unknown game {name!r}"}
                try:
                    return 200, explain_spec(spec)
                except Exception as e:  # noqa: BLE001 — a game that fails
                    # to compile should report the reason, not a 500 (and
                    # a compile-time KeyError must not read as 'unknown
                    # game' — the resolve has its own try above)
                    return 422, {"error": f"game does not compile: {e}"}
            if route == ("POST", "/api/rooms/create"):
                game = body["gameName"]
                cat = {g["name"]: g for g in self.host.list_games()}
                if game not in cat:
                    match = [n for n in cat if game.lower() in n.lower()]
                    if not match:
                        return 404, {"error": f"unknown game {game!r}"}
                    game = match[0]
                room, hostp = self.storage.create_room(
                    game, body.get("playerName", "Host"),
                    min_players=cat[game]["minPlayers"],
                )
                return 200, {"room": room.__dict__, "player": hostp.__dict__}
            if route == ("POST", "/api/rooms/join"):
                room = self.storage.get_room(body["roomId"])
                if room is None:
                    return 404, {"error": "room not found"}
                if room.status != "waiting":
                    return 409, {"error": "game already started"}
                p = self.storage.add_player(body["roomId"], body["playerName"])
                return 200, {"player": p.__dict__}
            if route == ("POST", "/api/rooms/add-bot"):
                room = self.storage.get_room(body["roomId"])
                if room is None:
                    return 404, {"error": "room not found"}
                added = []
                players = self.storage.get_players(room.roomId)
                while len(players) < room.minPlayers:
                    # bots named player2..N (reference: add-bot/route.ts:58-96)
                    p = self.storage.add_player(
                        room.roomId, f"player{len(players) + 1}", is_bot=True
                    )
                    added.append(p.__dict__)
                    players = self.storage.get_players(room.roomId)
                return 200, {"added": added, "playerCount": len(players)}
            if route == ("POST", "/api/generate-dsl"):
                # reference: 3 gpt-5 calls, ~10 min, 900s poll ceiling
                # (src/app/api/generate-dsl/route.ts); here: deterministic
                # generation + programmatic validation, milliseconds.
                import re as _re

                import yaml as _yaml

                from game_engine_tpu_torch.dslgen.generate import generate_from_description
                from game_engine_tpu_torch.dslgen.validate import errors as _errors, validate_doc

                name = _re.sub(r"[^a-z0-9-]+", "-", str(body["gameName"]).lower()).strip("-")
                if not name:
                    return 400, {"error": "gameName required"}
                gen_report: list[str] = []
                hook = None
                if self._llm_complete is not None:
                    from game_engine_tpu_torch.dslgen.llm_adapter import make_llm_hook

                    hook = make_llm_hook(self._llm_complete,
                                         report=gen_report)
                doc = generate_from_description(
                    name, str(body.get("gameDescription", "")),
                    report=gen_report, llm_hook=hook)
                issues, spec = validate_doc(doc, name=name)
                errs = _errors(issues)
                if errs or spec is None:
                    # keep-original-on-failure: nothing is written
                    return 422, {"error": "generated DSL failed validation",
                                 "issues": [str(i) for i in issues]}
                path = os.path.join(self.host._games_path, f"{name}.yaml")
                # a generated name can collide with an existing catalog
                # entry (gameName "two truths and a lie" sanitizes to the
                # parity-contract file's stem) — never clobber silently;
                # re-generating on purpose takes {"overwrite": true}
                if os.path.exists(path) and not body.get("overwrite"):
                    return 409, {"error": f"game {name!r} already exists; "
                                          "pass overwrite=true to replace it"}
                with open(path, "w", encoding="utf-8") as f:
                    _yaml.safe_dump(doc, f, sort_keys=False, allow_unicode=True)
                return 200, {
                    "name": name,
                    "filename": f"{name}.yaml",
                    # generation-honesty warnings (low description coverage)
                    # lead the list so clients surface them first
                    "warnings": gen_report + [str(i) for i in issues],
                    "yaml": _yaml.safe_dump(doc, sort_keys=False, allow_unicode=True),
                }
            if route == ("GET", "/api/rooms/list"):
                game = query.get("game", [None])[0]
                return 200, {"rooms": self.storage.list_rooms(game)}
            if route == ("GET", "/api/debug/rooms"):
                return 200, self.storage.dump()

            m = re.match(r"^/api/rooms/([^/]+)(?:/([a-z]+))?$", path)
            if m:
                room_id, action = m.group(1), m.group(2)
                room = self.storage.get_room(room_id)
                if room is None:
                    return 404, {"error": "room not found"}
                players = self.storage.get_players(room_id)
                names = {p.id: p.name for p in players}
                if method == "GET" and action is None:
                    return 200, {"room": room.__dict__, "players": [p.__dict__ for p in players]}
                if method == "POST" and action == "start":
                    if room.status != "waiting":
                        return 409, {"error": f"room already {room.status}"}
                    if len(players) < room.minPlayers:
                        return 409, {"error": f"need {room.minPlayers} players"}
                    thread = self.host.start_room(
                        room_id, room.gameName, len(players), seed=body.get("seed"),
                        rounds_per_player=int(body.get("roundsPerPlayer", 1)),
                        human_seats=[p.id for p in players if not p.isBot],
                        player_names=names,
                        # optional per-seat scripted/learned mix; default =
                        # every bot seat when a --bot-ckpt matches the game
                        policy_seats=[int(s) for s in body["policySeats"]]
                        if body.get("policySeats") is not None else None,
                    )
                    self.storage.set_thread(room_id, thread)
                    self.storage.set_status(room_id, "playing")
                    return 200, self.host.snapshot(room_id, names)
                if room.status == "playing" and action is not None and not self.host.has_room(room_id):
                    # persisted as playing but no live/restorable engine slot
                    # (e.g. journal lost) — a clear 410, not a KeyError 400
                    self.storage.set_status(room_id, "finished")
                    return 410, {"error": "room state lost; game marked finished"}
                if room.status in ("playing", "finished"):
                    if (action in ("state", "chat", "notes")
                            and not self.host.has_room(room_id)):
                        # finished room from a prior process / already closed
                        return 410, {"error": "room state no longer available"}
                    if method == "GET" and action == "state":
                        viewer = int(query.get("playerId", ["1"])[0])
                        return 200, self.host.visible_state(room_id, viewer, names)
                    if method == "POST" and action == "chat":
                        msgs = self.host.post_chat(
                            room_id, int(body["playerId"]), str(body["message"]), names
                        )
                        return 200, {"messages": msgs}
                    if method == "GET" and action == "chat":
                        viewer = int(query.get("playerId", ["1"])[0])
                        return 200, {"messages": self.host.chat_messages(room_id, viewer)}
                    if method == "GET" and action == "notes":
                        return 200, {"game_notes": self.host.game_notes(room_id)}
                if method == "POST" and action == "close":
                    self.host.end_room(room_id)
                    self.storage.set_status(room_id, "finished")
                    return 200, {"closed": True}
                if room.status != "playing":
                    msg = "game already finished" if room.status == "finished" else "room not started"
                    return 409, {"error": msg}
                if method == "POST" and action == "action":
                    # optional free-text content rides along with the choice;
                    # a text-only submit defaults to the SUBMIT marker (1)
                    text = body.get("text")
                    choice = int(body.get("choice", 1 if text is not None else 0))
                    self.host.queue_action(room_id, int(body["playerId"]), choice,
                                           text=text)
                    return 200, {"queued": True}
                if method == "POST" and action == "vote":
                    self.host.queue_vote(room_id, int(body["playerId"]), int(body["option"]))
                    return 200, {"queued": True}
                if method == "POST" and action == "step":
                    # with playerId the response is that viewer's filtered
                    # state (what the web client uses); the bare variant
                    # returns the host view. NOTE identity is client-asserted
                    # throughout this API (the reference has no auth either,
                    # and useCoAgent syncs FULL state to every client) —
                    # masking is an information-hygiene upgrade, not a
                    # security boundary.
                    snap = self.host.step(room_id)
                    if snap.get("done"):
                        self.storage.set_status(room_id, "finished")
                    if "playerId" in body:
                        snap = self.host.visible_state(
                            room_id, int(body["playerId"]), names)
                    return 200, snap
                if method == "POST" and action == "continue":
                    snap = self.host.run_until_input_needed(room_id)
                    if snap.get("done"):
                        self.storage.set_status(room_id, "finished")
                    if "playerId" in body:
                        truncated = snap.get("truncated", False)
                        snap = self.host.visible_state(
                            room_id, int(body["playerId"]), names)
                        snap["truncated"] = truncated
                    return 200, snap
            return 404, {"error": f"no route {method} {path}"}
        except RoomGone:
            return 410, {"error": "room state no longer available"}
        except KeyError as e:
            return 400, {"error": f"missing or unknown field: {e}"}
        except (ValueError, TypeError) as e:
            return 400, {"error": str(e)}


def make_server(port: int = 0, storage_path: Optional[str] = None,
                games_path: Optional[str] = None, backend: str = "torch",
                chat_lm: Optional[str] = None,
                bot_ckpts: Optional[list] = None,
                llm_cmd: Optional[str] = None,
                llm_entry: Optional[str] = None,
                chat_sample_temp: float = 0.0,
                chat_llm_cmd: Optional[str] = None,
                chat_llm_entry: Optional[str] = None,
                bot_search: Optional[list] = None,
                search_rollouts: int = 32,
                search_horizon: int = 200,
                search_det: int = 0,
                device=D.DEFAULT) -> ThreadingHTTPServer:
    """The HTTP server over a GameHost on `device` (the card unless the
    caller asks for the CPU; raises without one)."""
    ctx = AppContext(storage_path, games_path, backend=backend, chat_lm=chat_lm,
                     bot_ckpts=bot_ckpts, llm_cmd=llm_cmd, llm_entry=llm_entry,
                     chat_sample_temp=chat_sample_temp,
                     chat_llm_cmd=chat_llm_cmd,
                     chat_llm_entry=chat_llm_entry,
                     bot_search=bot_search, search_rollouts=search_rollouts,
                     search_horizon=search_horizon, search_det=search_det,
                     device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _respond(self):
            parsed = urlparse(self.path)
            m = re.match(r"^/api/rooms/([^/]+)/events$", parsed.path)
            if self.command == "GET" and m:
                return self._stream_events(m.group(1), parse_qs(parsed.query))
            body = {}
            if self.command == "POST":
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    try:
                        body = json.loads(self.rfile.read(length))
                    except json.JSONDecodeError:
                        body = {}
            code, payload = ctx.handle(
                self.command, parsed.path, parse_qs(parsed.query), body
            )
            if isinstance(payload, str):  # web-client page / static asset
                data = payload.encode()
                ctype = getattr(payload, "ctype", "text/html; charset=utf-8")
            else:
                data = json.dumps(payload).encode()
                ctype = "application/json"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _stream_events(self, room_id: str, query: dict):
            """Server-sent events: push the viewer-filtered state whenever
            stateVersion moves — the push half of the reference's useCoAgent
            bidirectional sync (reference: SURVEY.md §2.5 cross-process
            transport row; the round-1 client could only poll)."""
            import time as _time

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            last = None
            try:
                for _ in range(2400):  # ~12 min per connection; clients reconnect
                    # cheap change check first: the full snapshot (decode +
                    # projection + masking) is only built when t moved
                    ver = ctx.host.state_version(room_id)
                    if ver is None or ver != last:
                        code, snap = ctx.handle(
                            "GET", f"/api/rooms/{room_id}/state", query, {}
                        )
                        if code != 200:
                            self.wfile.write(
                                f"event: gone\ndata: {json.dumps(snap)}\n\n".encode()
                            )
                            self.wfile.flush()
                            return
                        # compare against the SAME composite the check
                        # reads — the snapshot's stateVersion is the bare
                        # engine t and would never equal (t<<20 | chat),
                        # turning the cheap check into a per-tick rebuild
                        last = ver
                        self.wfile.write(f"data: {json.dumps(snap)}\n\n".encode())
                        self.wfile.flush()
                    _time.sleep(0.3)
            except (BrokenPipeError, ConnectionResetError, OSError):
                return

        do_GET = _respond
        do_POST = _respond

        def _method_not_allowed(self):
            data = json.dumps({"error": "method not allowed"}).encode()
            self.send_response(405)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_PUT = _method_not_allowed
        do_DELETE = _method_not_allowed
        do_PATCH = _method_not_allowed

    class Server(ThreadingHTTPServer):
        # The stdlib default accept backlog (request_queue_size = 5) drops
        # connections under bursts: 20+ concurrent clients each opening a
        # fresh connection per request overflow the backlog whenever the
        # accept loop is starved for CPU, and the kernel RSTs the overflow
        # (ConnectionResetError 104 client-side — the round-2 soak flake).
        request_queue_size = 128
        daemon_threads = True

    server = Server(("127.0.0.1", port), Handler)
    server.ctx = ctx  # type: ignore[attr-defined]
    return server


def main(argv=None):  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8123)
    ap.add_argument("--storage", default="temp-rooms.json")
    ap.add_argument("--backend", default="torch", choices=["torch", "native"],
                    help="torch: the batched engine on --device (the "
                         "default); native: a C++ room a game on the host "
                         "(csrc/gamesim.cpp; the JAX package's default), "
                         "policy and search bots still on --device")
    ap.add_argument("--device", default=D.DEFAULT,
                    help="cuda (the card, the default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--chat-lm", default=None, metavar="CKPT_NPZ",
                    help="serve bot chat from the on-device transformer "
                         "(policies/chat_lm.py; the decode kernel on the "
                         "card) instead of the templates")
    ap.add_argument("--chat-sample-temp", type=float, default=0.0,
                    metavar="T",
                    help="roleplay tier: sample smalltalk chat kinds "
                         "(greeting/open chatter) at temperature T with "
                         "top-p 0.9 instead of greedy decoding — varied, "
                         "deterministic per message (needs --chat-lm); "
                         "state-reporting kinds stay greedy")
    ap.add_argument("--bot-ckpt", action="append", default=None,
                    metavar="[GAME=]CKPT_NPZ",
                    help="serve greedy learned-policy bots from a trained "
                         "checkpoint (policies/net.py) for matching games; "
                         "repeatable, e.g. --bot-ckpt "
                         "werewolf=docs/checkpoints/attn_werewolf_u120.npz")
    ap.add_argument("--bot-search", action="append", default=None,
                    metavar="GAME|all",
                    help="serve lookahead SEARCH bots (policies/search.py: "
                         "every legal choice rolled forward to termination "
                         "by the search kernel on the card, its plain "
                         "version on the CPU) for matching games; "
                         "repeatable. Needs no checkpoint; the most specific "
                         "--bot-ckpt/--bot-search fragment wins per game")
    ap.add_argument("--search-rollouts", type=int, default=32,
                    help="search-bot rollouts per candidate action")
    ap.add_argument("--search-horizon", type=int, default=200,
                    help="search-bot per-rollout step cap")
    ap.add_argument("--search-det", type=int, default=0, metavar="D",
                    help="information-set search: score candidates over D "
                         "hidden-state determinizations sampled under each "
                         "searcher's own observation mask instead of "
                         "reading the true room state (0 = full-information "
                         "lookahead). D*rollouts rollouts per candidate")
    ap.add_argument("--llm-cmd", default=None, metavar="SHELL_CMD",
                    help="external model for /api/generate-dsl: a shell "
                         "command receiving the generation prompt on stdin "
                         "and printing YAML on stdout (e.g. a curl to a "
                         "local model server); invalid output retries with "
                         "validator feedback, then falls back loudly to "
                         "the deterministic generator")
    ap.add_argument("--llm-entry", default=None, metavar="MODULE:FUNC",
                    help="like --llm-cmd but a Python entrypoint "
                         "complete(prompt)->str, imported in-process")
    ap.add_argument("--chat-llm-cmd", default=None, metavar="SHELL_CMD",
                    help="external chat model: free-form persona roleplay "
                         "as the top bot-chat tier (prompt on stdin, reply "
                         "on stdout; server/chat_llm.py builds the prompt "
                         "from visibility-gated state). Grounded answers "
                         "are verified host-side; failures fall through "
                         "to --chat-lm then the templates")
    ap.add_argument("--chat-llm-entry", default=None, metavar="MODULE:FUNC",
                    help="like --chat-llm-cmd but a Python entrypoint "
                         "complete(prompt)->str, imported in-process")
    args = ap.parse_args(argv)
    srv = make_server(args.port, args.storage, backend=args.backend,
                      chat_lm=args.chat_lm, bot_ckpts=args.bot_ckpt,
                      llm_cmd=args.llm_cmd, llm_entry=args.llm_entry,
                      chat_sample_temp=args.chat_sample_temp,
                      chat_llm_cmd=args.chat_llm_cmd,
                      chat_llm_entry=args.chat_llm_entry,
                      bot_search=args.bot_search,
                      search_rollouts=args.search_rollouts,
                      search_horizon=args.search_horizon,
                      search_det=args.search_det,
                      device="cpu" if args.cpu else args.device)
    print(f"game host listening on :{srv.server_address[1]}")
    srv.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
