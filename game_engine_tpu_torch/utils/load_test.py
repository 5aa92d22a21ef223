"""Sustained serving capacity: many live rooms, concurrent clients, real
HTTP, journaling on.

Counterpart of game_engine_tpu/utils/load_test.py over the port's server
(the torch backend by default, --backend native, scripted bots or
--bot-search). This harness measures the HOST under load — hundreds of journaled rooms driven
by concurrent clients playing complete games (continue / action / vote /
occasional chat and state reads) for a fixed wall-clock window. Reports
completed games, request throughput, and per-endpoint latency quantiles as
ONE JSON line.

    python -m game_engine_tpu_torch.utils.load_test --rooms 200 --clients 8 \
        --seconds 60 --device cuda

The reference serves one LangGraph thread per room with 4+ sequential LLM
calls per turn (reference: src/app/api/copilotkit/route.ts:22-48,
agent/game_agent_v2.py) — its capacity ceiling is the model API, not the
host. Here the ceiling IS the host, so it gets measured.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import tempfile
import threading
import time
import urllib.request


def _req(port: int, method: str, path: str, body=None, timeout=30):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        out = json.load(r)
    return out, (time.perf_counter() - t0) * 1e3


class Client(threading.Thread):
    """Owns a set of rooms; plays each to completion, then recreates it.
    Mirrors the web client's traffic: continue -> (action|vote on
    waiting_on) with a state read and a chat message sprinkled in."""

    def __init__(self, port: int, game: str, n_rooms: int, stop: threading.Event,
                 stats: dict, lock: threading.Lock, cid: int,
                 bots_per_room: int = 1):
        super().__init__(daemon=True)
        self.port, self.game, self.n_rooms = port, game, n_rooms
        self.stop, self.stats, self.lock, self.cid = stop, stats, lock, cid
        self.bots_per_room = bots_per_room

    def _record(self, ep: str, ms: float):
        with self.lock:
            self.stats.setdefault(ep, []).append(ms)

    def _new_room(self, i: int) -> str:
        out, ms = _req(self.port, "POST", "/api/rooms/create",
                       {"gameName": self.game,
                        "playerName": f"load{self.cid}_{i}"})
        self._record("create", ms)
        rid = out["room"]["roomId"]
        for _ in range(self.bots_per_room):
            _req(self.port, "POST", "/api/rooms/add-bot", {"roomId": rid})
        out, ms = _req(self.port, "POST", f"/api/rooms/{rid}/start",
                       {"seed": (self.cid * 1009 + i) & 0x7FFFFFFF})
        self._record("start", ms)
        return rid

    def run(self):
        rooms = {i: self._new_room(i) for i in range(self.n_rooms)}
        turn = 0
        while not self.stop.is_set():
            for i, rid in list(rooms.items()):
                if self.stop.is_set():
                    return
                try:
                    snap, ms = _req(self.port, "POST",
                                    f"/api/rooms/{rid}/continue")
                    self._record("continue", ms)
                    if snap.get("done"):
                        with self.lock:
                            self.stats["games_done"] = (
                                self.stats.get("games_done", 0) + 1)
                        rooms[i] = self._new_room(i)
                        continue
                    for pid in (snap.get("waiting_on") or []):
                        _, ms = _req(self.port, "POST",
                                     f"/api/rooms/{rid}/action",
                                     {"playerId": pid, "choice": 1,
                                      "text": "one\ntwo\nthree"})
                        self._record("action", ms)
                    turn += 1
                    if turn % 7 == 0:
                        _, ms = _req(self.port, "GET",
                                     f"/api/rooms/{rid}/state?playerId=1")
                        self._record("state", ms)
                    if turn % 23 == 0:
                        _, ms = _req(self.port, "POST",
                                     f"/api/rooms/{rid}/chat",
                                     {"playerId": 1,
                                      "message": "to Bot 2: hello there"})
                        self._record("chat", ms)
                except Exception as e:  # count, don't crash the run
                    with self.lock:
                        self.stats["errors"] = self.stats.get("errors", 0) + 1
                        self.stats.setdefault("error_samples", [])
                        if len(self.stats["error_samples"]) < 5:
                            self.stats["error_samples"].append(repr(e)[:120])


def _q(xs, p):
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(p * len(xs)))], 2) if xs else None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rooms", type=int, default=200, help="total live rooms")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--game", default="werewolf")
    ap.add_argument("--backend", default="torch", choices=["torch", "native"])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--storage", default=os.path.join(tempfile.gettempdir(),
                                                      "load_rooms.json"))
    ap.add_argument("--chat-lm", default=None)
    ap.add_argument("--bots-per-room", type=int, default=1,
                    help="add-bot calls per room; each fills the room to the "
                         "game's minimum seats (werewolf: 4, so 3 bots), so "
                         "calls after the first add nobody")
    ap.add_argument("--bot-search", action="append", default=None, metavar="GAME|all",
                    help="serve lookahead search bots for matching games")
    ap.add_argument("--search-det", type=int, default=0,
                    help="information-set search over D determinizations")
    ap.add_argument("--search-rollouts", type=int, default=32)
    ap.add_argument("--search-horizon", type=int, default=200)
    args = ap.parse_args()

    # journaling ON (persist_dir rides the storage path) — capacity with
    # durability, not a stripped-down demo
    for p in (args.storage, args.storage + ".rooms"):
        if os.path.exists(p):
            import shutil

            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)

    from game_engine_tpu_torch.server.api import make_server

    srv = make_server(0, args.storage, backend=args.backend,
                      chat_lm=args.chat_lm, bot_search=args.bot_search,
                      search_rollouts=args.search_rollouts,
                      search_horizon=args.search_horizon, search_det=args.search_det,
                      device=args.device)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    stop = threading.Event()
    stats: dict = {}
    lock = threading.Lock()
    per = max(1, args.rooms // args.clients)
    clients = [Client(port, args.game, per, stop, stats, lock, c,
                      bots_per_room=args.bots_per_room)
               for c in range(args.clients)]
    t0 = time.time()
    for c in clients:
        c.start()
    # setup happens inside client threads; the measurement window starts
    # once every client has its rooms live (wait for first continues)
    while time.time() - t0 < args.seconds:
        time.sleep(0.5)
    stop.set()
    for c in clients:
        c.join(timeout=30)
    wall = time.time() - t0

    lat = {ep: stats.get(ep, []) for ep in
           ("create", "start", "continue", "action", "state", "chat")}
    n_req = sum(len(v) for v in lat.values())
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(json.dumps({
        "rooms": per * args.clients, "clients": args.clients,
        "backend": args.backend, "device": args.device,
        "bot_tier": "search" if args.bot_search else "scripted",
        "search_det": args.search_det if args.bot_search else None,
        "wall_s": round(wall, 1),
        "requests": n_req, "req_per_s": round(n_req / wall, 1),
        "games_completed": stats.get("games_done", 0),
        "games_per_min": round(stats.get("games_done", 0) / wall * 60, 1),
        "errors": stats.get("errors", 0),
        "error_samples": stats.get("error_samples", []),
        "continue_ms": {p: _q(lat["continue"], q) for p, q in
                        (("p50", .5), ("p90", .9), ("p95", .95),
                         ("p99", .99))},
        "action_ms_p50": _q(lat["action"], .5),
        "state_ms_p50": _q(lat["state"], .5),
        "chat_ms_p50": _q(lat["chat"], .5),
        "max_rss_mb": round(rss_mb, 1),
    }))


if __name__ == "__main__":
    main()
