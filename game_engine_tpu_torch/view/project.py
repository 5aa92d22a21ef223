"""The DM projection: phase -> canvas items.

Replaces the reference's ActionExecutor LLM (reference:
agent/game_agent_v2.py:1243-1568), which renders each phase by calling
frontend tools listed in the DSL phase's actions (first action always
clearCanvas, audience tiers in the action descriptions). Here the same
contract is a pure function: given the compiled game and an AgentState
snapshot, emit the items[] the reference DM would create — clear-before-
create, TIER 1/2/3 audience permissions, death-marker persistence
(reference: agent/prompt/ActionExecutor_system_prompt.txt:13-123).
"""

from __future__ import annotations

import re
from typing import Any, Optional

from game_engine_tpu_torch.gamespec.compile import CompiledGame, CompiledPhase
from game_engine_tpu_torch.gamespec.expr import eval_predicate
from game_engine_tpu_torch.gamespec.mechanics import ChoiceKind
from game_engine_tpu_torch.view.cards import Item, TOOL_TO_CARD, clear_canvas, make_item

_TIER_RE = re.compile(r"TIER\s*(\d)", re.IGNORECASE)
_NIGHT_NAME_RE = re.compile(r"(?:first\s+)?night\b", re.IGNORECASE)
_EXCEPT_RE = re.compile(r"\bexcept\b|\bwaiting\b|\bnon-|\bother players\b", re.IGNORECASE)
_EXEMPT_DEATH_RE = re.compile(r"exempt[^.]*death|death markers?[^.]*(persist|remain|exempt)", re.IGNORECASE)
# clearCanvas exemptions named in action descriptions ("exempt persistent
# scoreboard", "preserving scoreboard", ... — reference: clearCanvas
# exemptList semantics, src/app/page.tsx:2426-2443)
_EXEMPT_WORDS = {
    "score_board": re.compile(r"(exempt|preserv\w*|keep\w*)[^.]*score\s*board|score\s*board[^.]*(persist|remain|exempt)", re.IGNORECASE),
    "death_marker": _EXEMPT_DEATH_RE,
    "influence_set": re.compile(r"(exempt|preserv\w*|keep\w*)[^.]*influence|influence[^.]*(persist|remain|exempt)", re.IGNORECASE),
    "coin_display": re.compile(r"(exempt|preserv\w*|keep\w*)[^.]*(coin|purse)|(coin|purse)s?[^.]*(persist|remain|exempt)", re.IGNORECASE),
    "health_display": re.compile(r"(exempt|preserv\w*|keep\w*)[^.]*health|health[^.]*(persist|remain|exempt)", re.IGNORECASE),
}
# singleton card types: re-creating one replaces the existing item instead of
# stacking duplicates (reference: name-based idempotency in the create
# handlers, src/app/page.tsx:1177-1185)
_SINGLETON_TYPES = frozenset(
    {"avatar_set", "score_board", "turn_indicator", "statement_board",
     "night_overlay", "phase_indicator", "character_card"}
)


def _phase_targets(phase: CompiledPhase, snapshot: dict[str, Any]) -> list[str]:
    out = []
    for pid, row in snapshot.get("player_states", {}).items():
        if eval_predicate(phase.target_pred, row):
            out.append(str(pid))
    return out


def _alive_names(snapshot: dict[str, Any]) -> list[str]:
    names = []
    for pid, row in sorted(snapshot.get("player_states", {}).items(), key=lambda kv: int(kv[0])):
        if row.get("is_alive", True):
            names.append(row.get("name") or f"Player {pid}")
    return names


def _audience(tier: Optional[int], description: str, targets: list[str], all_ids: list[str]):
    """(audience_type, audience_ids) from the action's tier annotation.

    A TIER 3 private card with an EMPTY target set stays empty — falling
    back to all_ids would broadcast explicitly-private content (e.g. a
    role card whose targeted actor just died) to every seat. Tier-2 group
    messages likewise go to the (possibly empty) matching group."""
    if tier == 3 or (tier == 2 and not _EXCEPT_RE.search(description)):
        return False, list(targets)
    if tier == 2:  # group message to everyone except the actors
        ids = [i for i in all_ids if i not in targets] or all_ids
        return False, ids
    return True, []


class Projector:
    """Stateful item-id counter + per-room projection (one per room)."""

    def __init__(self, game: CompiledGame):
        self.game = game
        self._counter = 1000

    def _next_id(self, items: list[Item]) -> str:
        # id derivation: max(existing numeric ids, counter) + 1
        # (reference: src/app/page.tsx:855-862)
        self._sync_counter(items)
        self._counter += 1
        return str(self._counter)

    def _sync_counter(self, items: list[Item]) -> None:
        """Raise the counter above every numeric id in `items` — one scan
        is only load-bearing after a journal restore hands prev_items to a
        fresh Projector; the monotonic counter covers everything else."""
        for it in items:
            try:
                self._counter = max(self._counter, int(it.id))
            except ValueError:
                pass

    def project(
        self,
        snapshot: dict[str, Any],
        prev_items: Optional[list[Item]] = None,
        prev_dead: Optional[list[str]] = None,
    ) -> list[Item]:
        """Render the current phase of an AgentState snapshot into items."""
        game = self.game
        phase = game.phase_by_id(snapshot["current_phase_id"])
        spec_phase = game.spec.phases[phase.dsl_id]
        players = snapshot.get("player_states", {})
        all_ids = sorted(players, key=int)
        targets = _phase_targets(phase, snapshot)
        dead = snapshot.get("deadPlayers", [])
        newly_dead = [d for d in dead if d not in (prev_dead or [])]

        items = list(prev_items or [])
        for action in spec_phase.actions:
            m = _TIER_RE.search(action.description)
            tier = int(m.group(1)) if m else None
            for tool in action.tools:
                if tool == "clearCanvas":
                    exempt = [
                        t for t, rx in _EXEMPT_WORDS.items()
                        if rx.search(action.description)
                    ]
                    if dead and "death_marker" not in exempt:
                        exempt.append("death_marker")
                    items = clear_canvas(items, exempt=exempt)
                    continue
                if tool == "markPlayerDead":
                    # phases that ALSO list createDeathMarker render their
                    # markers through that card; a phase with only
                    # markPlayerDead must render here or the death is never
                    # shown (the caller advances prev_dead after every
                    # projection, consuming newly_dead)
                    phase_tools = {t for a in spec_phase.actions
                                   for t in a.tools}
                    if "createDeathMarker" not in phase_tools and newly_dead:
                        new_items = self._make(
                            "death_marker", tool, action.description, phase,
                            snapshot, False, [], targets, all_ids,
                            newly_dead, items)
                        items.extend(new_items)
                    continue
                card = TOOL_TO_CARD.get(tool)
                if card is None:
                    continue
                aud_type, aud_ids = _audience(tier, action.description, targets, all_ids)
                new_items = self._make(card, tool, action.description, phase, snapshot,
                                       aud_type, aud_ids, targets, all_ids, newly_dead, items)
                if card in _SINGLETON_TYPES and new_items:
                    items = [i for i in items if i.type != card]
                items.extend(new_items)
        # DM habit: night phases dim the canvas even when the DSL doesn't
        # list createNightOverlay (phase names beginning 'Night'/'First
        # Night'); the overlay clears with the next phase's clearCanvas
        if (_NIGHT_NAME_RE.match(phase.name)
                and not any(i.type == "night_overlay" for i in items)):
            items.append(make_item(self._next_id(items), "night_overlay", "Night",
                                   visible=True, title=phase.name, opacity=0.5))
        return items

    # -- per-card synthesis -------------------------------------------------

    def _make(self, card, tool, desc, phase, snapshot, aud_type, aud_ids,
              targets, all_ids, newly_dead, items) -> list[Item]:
        players = snapshot["player_states"]
        rp = phase.program.record
        sp = next((p for p in all_ids if players[p].get("is_speaker")), None)
        out: list[Item] = []

        self._sync_counter(items)

        def nid():
            self._counter += 1
            return str(self._counter)

        if card == "phase_indicator":
            out.append(make_item(nid(), card, phase.name, currentPhase=phase.name,
                                 description=desc))
        elif card == "text_display":
            out.append(make_item(nid(), card, phase.name, audience_type=aud_type,
                                 audience_ids=aud_ids, content=desc, type="info"))
        elif card == "voting_panel":
            if rp.choice_kind is ChoiceKind.TARGET:
                options = _alive_names(snapshot)
            else:
                hi = rp.choice_max if rp.choice_max > 0 else len(all_ids)
                options = [str(i) for i in range(1, hi + 1)]
                # guess votes read better as the actual statements (the
                # reference voters pick among the speaker's statements)
                stmts = (players.get(sp, {}).get("statements") or {}) if sp else {}
                if len(stmts) == hi:
                    options = [str(stmts.get(str(i + 1), i + 1)) for i in range(hi)]
            out.append(make_item(
                nid(), card, phase.name,
                audience_type=False, audience_ids=targets or all_ids,
                votingId=f"vote-{phase.dsl_id}-{snapshot.get('stateVersion', 0)}",
                title=desc or phase.name, options=options,
            ))
        elif card == "broadcast_input":  # createTextInputPanel
            out.append(make_item(
                nid(), card, phase.name,
                audience_type=False, audience_ids=targets or all_ids,
                title=desc, placeholder="Type here...", confirmLabel="Submit",
            ))
        elif card == "character_card":
            # TIER 3: one private role card per player
            for pid in all_ids:
                role = players[pid].get("role", "")
                out.append(make_item(
                    nid(), card, f"Role: {role or 'Unknown'}",
                    audience_type=False, audience_ids=[pid],
                    role=role, description=self._role_desc(role),
                ))
        elif card == "avatar_set":
            out.append(make_item(nid(), card, "Avatars", avatarType="human"))
        elif card == "score_board":
            score_field = self._score_field()
            entries = [
                {"id": pid, "name": players[pid].get("name", f"Player {pid}"),
                 "score": int(players[pid].get(score_field, 0) or 0)}
                for pid in all_ids
            ] if score_field else []
            out.append(make_item(nid(), card, "Scoreboard", title="Scoreboard",
                                 entries=entries, sort="desc"))
        elif card == "turn_indicator":
            if sp is not None:
                out.append(make_item(
                    nid(), card, "Current Speaker",
                    currentPlayerId=sp, playerName=players[sp].get("name", f"Player {sp}"),
                    label="Speaker",
                ))
        elif card == "statement_board":
            stmts = list((players.get(sp, {}).get("statements") or {}).values()) if sp else []
            revealed = bool(players.get(sp, {}).get("lie_revealed")) if sp else False
            lie = int(players.get(sp, {}).get("lie_index", 0) or 0) if sp else 0
            data = {"statements": stmts, "locked": True}
            if revealed and lie:
                data["highlightIndex"] = lie - 1
            out.append(make_item(nid(), card, "Statements", **data))
        elif card == "timer":
            out.append(make_item(nid(), card, "Timer", duration=10, label=phase.name))
        elif card == "result_display":
            out.append(make_item(nid(), card, "Results",
                                 content=self._result_content(phase, snapshot, newly_dead)))
        elif card == "death_marker":
            for pid in newly_dead:
                out.append(make_item(
                    nid(), card, f"{players.get(pid, {}).get('name', f'Player {pid}')} eliminated",
                    playerName=players.get(pid, {}).get("name", f"Player {pid}"),
                    playerId=pid, cause=phase.name,
                ))
        elif card == "night_overlay":
            out.append(make_item(nid(), card, "Night", visible=True, title=phase.name,
                                 opacity=0.5))
        elif card == "player_states_display":
            out.append(make_item(nid(), card, "Player States", title="Player States"))
        elif card == "player_actions_display":
            out.append(make_item(nid(), card, "Action Log", title="Player Actions"))
        else:
            out.append(make_item(nid(), card, phase.name, audience_type=aud_type,
                                 audience_ids=aud_ids))
        return out

    def _role_desc(self, role: str) -> str:
        for r in self.game.spec.declaration.roles:
            if r.name == role:
                return r.description
        return ""

    def _score_field(self) -> Optional[str]:
        # the compiled terminal rule names the score field for 13 of the
        # 25 catalog games (pearls, coins, position, ...); the name-based
        # candidates are only a fallback for games with no score terminal
        from game_engine_tpu_torch.gamespec.mechanics import GameOver

        for phase in self.game.phases:
            if not phase.terminal:
                continue
            for mech in phase.program.on_enter:
                if (isinstance(mech, GameOver) and mech.mode == "score"
                        and mech.score_field):
                    return mech.score_field
        for cand in ("total_score", "score", "points"):
            if cand in self.game.spec.declaration.field_names():
                return cand
        return None

    def _result_content(self, phase, snapshot, newly_dead) -> str:
        players = snapshot["player_states"]
        if snapshot.get("done"):
            w = snapshot.get("winner", 0)
            return f"Game over — winner: {self._winner_text(w, snapshot)}"
        if newly_dead:
            names = ", ".join(players.get(d, {}).get("name", f"Player {d}") for d in newly_dead)
            return f"{names} has been eliminated."
        return f"{phase.name}: no eliminations."

    def _winner_text(self, winner: int, snapshot: dict) -> str:
        if winner <= 0:
            return "none"
        # team games: winner indexes the minority-first team order
        from game_engine_tpu_torch.gamespec.mechanics import GameOver

        def _from(phase):
            for mech in phase.program.on_enter:
                if isinstance(mech, GameOver):
                    if mech.mode == "team" and winner <= len(mech.team_order):
                        return mech.team_order[winner - 1]
                    # score AND survivor winners are player ids
                    row = snapshot["player_states"].get(str(winner), {})
                    return row.get("name", f"Player {winner}")
            return None

        # the snapshot's current phase IS the terminal the game ended in —
        # multi-terminal games (gold-rush 98 score / 99 team) would
        # otherwise take the first terminal's mode in id order
        try:
            cur = self.game.phase_by_id(snapshot.get("current_phase_id"))
        except (KeyError, TypeError):
            cur = None
        if cur is not None and cur.terminal:
            t = _from(cur)
            if t is not None:
                return t
        for phase in self.game.phases:
            if phase.terminal:
                t = _from(phase)
                if t is not None:
                    return t
        return f"Player {winner}"
