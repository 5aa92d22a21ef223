"""Room/lobby storage: in-memory maps with JSON-file persistence.

Mirrors the reference's MemoryStorage singleton (reference:
src/lib/storage/memory.ts:35-179): rooms + players keyed by roomId, a
monotonically increasing player id per room, write-through persistence to a
JSON file and reload-on-read so multiple processes see updates.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Optional


@dataclass
class Player:
    id: int
    name: str
    isHost: bool
    gamePlayerId: str
    isBot: bool = False


@dataclass
class Room:
    roomId: str
    gameName: str
    hostName: str
    status: str = "waiting"  # waiting | playing | finished
    maxPlayers: int = 8
    minPlayers: int = 1
    createdAt: float = field(default_factory=time.time)
    threadId: str = ""  # engine slot handle (reference kept a LangGraph thread id)


class MemoryStorage:
    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._lock = threading.RLock()
        self._rooms: dict[str, Room] = {}
        self._players: dict[str, list[Player]] = {}
        self._next_pid: dict[str, int] = {}
        if path and os.path.exists(path):
            self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self._path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        self._rooms = {k: Room(**v) for k, v in doc.get("rooms", {}).items()}
        self._players = {
            k: [Player(**p) for p in v] for k, v in doc.get("players", {}).items()
        }
        self._next_pid = {k: int(v) for k, v in doc.get("nextPlayerId", {}).items()}

    def _save(self) -> None:
        if not self._path:
            return
        doc = {
            "rooms": {k: asdict(v) for k, v in self._rooms.items()},
            "players": {k: [asdict(p) for p in v] for k, v in self._players.items()},
            "nextPlayerId": self._next_pid,
        }
        tmp = self._path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, self._path)

    # -- API -----------------------------------------------------------------

    def create_room(self, game_name: str, host_name: str, min_players: int,
                    max_players: int = 8) -> tuple[Room, Player]:
        with self._lock:
            self._refresh()  # mutators refresh first so _save() doesn't
            # clobber other processes' writes with stale in-memory state
            room = Room(
                roomId=str(uuid.uuid4()),
                gameName=game_name,
                hostName=host_name,
                minPlayers=min_players,
                maxPlayers=max_players,
            )
            host = Player(id=1, name=host_name, isHost=True, gamePlayerId="1")
            self._rooms[room.roomId] = room
            self._players[room.roomId] = [host]
            self._next_pid[room.roomId] = 2
            self._save()
            return room, host

    def _refresh(self) -> None:
        """Reload-on-read so concurrent processes see each other's writes
        (reference: memory.ts getRoom calls loadFromFile)."""
        if self._path:
            self._load()

    def get_room(self, room_id: str) -> Optional[Room]:
        with self._lock:
            self._refresh()
            return self._rooms.get(room_id)

    def get_players(self, room_id: str) -> list[Player]:
        with self._lock:
            self._refresh()
            return list(self._players.get(room_id, []))

    def add_player(self, room_id: str, name: str, is_bot: bool = False) -> Player:
        with self._lock:
            self._refresh()
            room = self._rooms[room_id]
            players = self._players[room_id]
            if len(players) >= room.maxPlayers:
                raise ValueError("room full")
            if any(p.name == name for p in players):
                raise ValueError("duplicate player name")
            pid = self._next_pid[room_id]
            self._next_pid[room_id] = pid + 1
            p = Player(id=pid, name=name, isHost=False, gamePlayerId=str(pid),
                       isBot=is_bot)
            players.append(p)
            self._save()
            return p

    def set_status(self, room_id: str, status: str) -> None:
        with self._lock:
            self._refresh()
            if room_id in self._rooms:
                self._rooms[room_id].status = status
                self._save()

    def set_thread(self, room_id: str, thread_id: str) -> None:
        with self._lock:
            self._refresh()
            if room_id in self._rooms:
                self._rooms[room_id].threadId = thread_id
                self._save()

    def list_rooms(self, game_name: Optional[str] = None,
                   joinable_only: bool = True) -> list[dict[str, Any]]:
        with self._lock:
            self._refresh()
            out = []
            for room in self._rooms.values():
                if game_name and room.gameName != game_name:
                    continue
                players = self._players.get(room.roomId, [])
                if joinable_only and (
                    room.status != "waiting" or len(players) >= room.maxPlayers
                ):
                    continue
                out.append({**asdict(room), "playerCount": len(players)})
            return out

    def room_by_thread(self, thread_id: str) -> Optional[Room]:
        with self._lock:
            for r in self._rooms.values():
                if r.threadId == thread_id:
                    return r
            return None

    def dump(self) -> dict[str, Any]:
        """Debug dump (reference: src/app/api/debug/rooms/route.ts)."""
        with self._lock:
            return {
                "rooms": {k: asdict(v) for k, v in self._rooms.items()},
                "players": {k: [asdict(p) for p in v] for k, v in self._players.items()},
            }
