"""Game notes: the referee's narrative event log, derived from state diffs.

The reference's RefereeNode writes emoji-tagged game_notes ("🔴 CRITICAL
Player X has been eliminated", scoring summaries, phase narratives —
reference: agent/tools/backend_tools.py:42-84 note types,
agent/prompt/referee_system_prompt_1.txt:37-88 writing standards). Here the
notes are a pure function of consecutive AgentState snapshots: deaths,
eliminations, votes resolved, scores, reveals, phase transitions, and game
over — deterministic, no LLM.
"""

from __future__ import annotations

import time
from typing import Any, Optional

NOTE_TYPES = {
    "critical": "🔴",
    "death": "💀",
    "vote": "🗳️",
    "score": "🏆",
    "phase": "🔄",
    "reveal": "👁️",
    "protect": "🛡️",
    "win": "🎉",
    "info": "📝",
}


def _name(snap: dict, pid: str) -> str:
    return snap["player_states"].get(pid, {}).get("name") or f"Player {pid}"


def diff_notes(prev: Optional[dict[str, Any]], cur: dict[str, Any]) -> list[dict[str, Any]]:
    """Notes for what happened between two snapshots (one engine turn)."""
    notes: list[dict[str, Any]] = []

    def add(ntype: str, text: str) -> None:
        notes.append(
            {
                "type": ntype,
                "icon": NOTE_TYPES.get(ntype, "📝"),
                "text": text,
                "phase": cur.get("current_phase_name", ""),
                "timestamp": time.time(),
            }
        )

    if prev is None:
        add("info", f"Game '{cur.get('gameName', '')}' started with "
                    f"{len(cur.get('player_states', {}))} players.")
        return notes

    # phase transition
    if cur.get("current_phase_id") != prev.get("current_phase_id"):
        add("phase", f"Phase changed: {prev.get('current_phase_name', '?')} → "
                     f"{cur.get('current_phase_name', '?')}.")

    pp, cp = prev.get("player_states", {}), cur.get("player_states", {})

    # deaths (P6/P7 outcomes)
    prev_dead = {p for p, r in pp.items() if r.get("is_alive") is False}
    cur_dead = {p for p, r in cp.items() if r.get("is_alive") is False}
    for pid in sorted(cur_dead - prev_dead, key=int):
        role = cp[pid].get("role", "")
        add("critical", f"{_name(cur, pid)}"
            + (f" ({role})" if role else "")
            + " has been eliminated.")
    # protection save: a night-results phase entered with no new deaths
    lowered_name = cur.get("current_phase_name", "").lower()
    if ("night" in lowered_name or "morning" in lowered_name) and (
        "result" in lowered_name or "announce" in lowered_name
    ) and not (cur_dead - prev_dead) and cur.get("current_phase_id") != prev.get("current_phase_id"):
        add("protect", "No one was eliminated during the night.")

    # score changes (P8)
    for pid, row in cp.items():
        for field in ("total_score", "score", "points"):
            if field in row:
                old = pp.get(pid, {}).get(field, 0) or 0
                new = row.get(field, 0) or 0
                if new != old:
                    add("score", f"{_name(cur, pid)}: {old} → {new} points "
                                 f"({'+' if new >= old else ''}{new - old}).")
                break

    # reveals: the flag flips for everyone at once (SetBoolAll); attribute
    # the note to the speaker's statement
    revealed_now = any(
        row.get("lie_revealed") and not pp.get(pid, {}).get("lie_revealed")
        for pid, row in cp.items()
    )
    if revealed_now:
        for pid, row in cp.items():
            if row.get("is_speaker") and row.get("lie_index"):
                add("reveal", f"{_name(cur, pid)}'s secret was statement {row['lie_index']}.")
                break

    # votes recorded this turn
    for pid, row in cp.items():
        v = row.get("vote_choice", 0)
        if v and not (pp.get(pid, {}).get("vote_choice", 0)):
            add("vote", f"{_name(cur, pid)} voted for option {v}.")

    # game over (P11)
    if cur.get("done") and not prev.get("done"):
        add("win", f"Game over — winner: {cur.get('winner')}.")
    return notes


class NotesLog:
    """Per-room accumulating notes log (capped ring, last-N served)."""

    def __init__(self, max_notes: int = 200):
        self.max_notes = max_notes
        self.notes: list[dict[str, Any]] = []
        self._prev: Optional[dict[str, Any]] = None

    def observe(self, snapshot: dict[str, Any]) -> list[dict[str, Any]]:
        new = diff_notes(self._prev, snapshot)
        self._prev = {
            "player_states": {k: dict(v) for k, v in snapshot.get("player_states", {}).items()},
            "current_phase_id": snapshot.get("current_phase_id"),
            "current_phase_name": snapshot.get("current_phase_name"),
            "done": snapshot.get("done"),
            "winner": snapshot.get("winner"),
            "gameName": snapshot.get("gameName"),
        }
        self.notes.extend(new)
        if len(self.notes) > self.max_notes:
            self.notes = self.notes[-self.max_notes :]
        return new

    def recent(self, n: int = 20) -> list[dict[str, Any]]:
        return self.notes[-n:]
