"""Per-room event journal: crash-safe persistence by deterministic replay.

The reference persists in-flight game state in LangGraph platform threads
(reference: agent/game_agent_v2.py:1586-1587) and lobby state in
temp-rooms.json with reload-on-read (reference: src/lib/storage/memory.ts:
48-127). Here the engine is a pure function of (seed, DSL, actions), so a
room is fully recoverable from an append-only event log: one JSONL file per
room holding a header (game, players, seed) followed by every state-mutating
host event in order. Replaying the log through the normal GameHost code
paths reproduces engine state, chat, notes, free-text and phase history
bit-identically (SURVEY.md §2.5 fault-handling row).

File format (one JSON object per line, flushed per event):
  line 1: {"v": 1, "game": ..., "n_players": N, "seed": S,
           "rounds_per_player": R, "human_seats": [..], "names": {...}}
  then:   {"e": "step", "ts": T, "a": {"<pid>": choice, ...}}   merged human actions
          {"e": "chat", "pid": N, "text": ..., "ts": T}
          {"e": "text", "pid": N, "field": ..., "content": {...}}
          {"e": "snap", "engine": {...}, "chat": [...], ...}    compaction snapshot

Event timestamps ride along so replay reproduces phase_history and chat
clocks exactly, not just engine state.

Compaction: every GameHost.SNAP_EVERY step events the journal is rewritten
(atomic temp+rename) as header + one full state snapshot, so file size and
restore cost stay O(SNAP_EVERY) for arbitrarily long rooms; replay resumes
from the snapshot and re-runs only the tail (a ~10k-step room restores in
well under a second, tests/test_journal_compaction.py).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional


class RoomJournal:
    """Append-only JSONL journal for one room."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def create(self, header: dict[str, Any]) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "w", encoding="utf-8")
        self._fh.write(json.dumps({"v": 1, **header}) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def append(self, event: dict[str, Any]) -> None:
        if self._fh is None:  # reattached after restore
            self._repair_tail()
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(event) + "\n")
        self._fh.flush()

    def _repair_tail(self) -> None:
        """A crash mid-append can leave a torn final line. load() already
        drops it on restore, but appending after it would MERGE the next
        event into the fragment — one unparseable line mid-file that makes
        a second restart discard every later event. Truncate to the end of
        the last complete line before reattaching. (Compaction bounds the
        file, so reading it whole is fine.)"""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except OSError:
            return
        if not data or data.endswith(b"\n"):
            return
        cut = data.rfind(b"\n") + 1
        with open(self.path, "rb+") as f:
            f.truncate(cut)

    def rewrite(self, header: dict[str, Any], events: list[dict[str, Any]]) -> None:
        """Compaction: atomically replace the file with header + events
        (typically one state snapshot). Bounds both file size and replay
        cost for long-running rooms; subsequent appends continue normally."""
        self.close()
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({"v": 1, **header}) + "\n")
            for ev in events:
                f.write(json.dumps(ev) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def delete(self) -> None:
        self.close()
        try:
            os.remove(self.path)
        except OSError:
            pass

    @staticmethod
    def load(path: str) -> Optional[tuple[dict[str, Any], list[dict[str, Any]]]]:
        """(header, events) or None if missing/corrupt-header. A torn final
        line (crash mid-append) is dropped rather than failing the restore."""
        if not os.path.exists(path):
            return None
        header: Optional[dict[str, Any]] = None
        events: list[dict[str, Any]] = []
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail — keep everything before it
                if i == 0:
                    header = obj
                else:
                    events.append(obj)
        if header is None or "game" not in header:
            return None
        return header, events
