"""Card-type catalog and audience gating — the UI contract.

Mirrors the reference's component model (reference:
src/lib/canvas/types.ts:19-45 CardType union, :14-17 AudiencePermissions,
:48-94 GamePosition + normalizer; gate semantics
src/components/canvas/CardRenderer.tsx:56-76) without any rendering — the
view layer here is data-only: a host UI (or the bundled server) consumes the
AgentState-shaped JSON exactly like the reference's useCoAgent sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

CARD_TYPES: tuple[str, ...] = (
    "character_card",
    "action_button",
    "phase_indicator",
    "text_display",
    "voting_panel",
    "avatar_set",
    "background_control",
    "result_display",
    "timer",
    "death_marker",
    "hands_card",
    "score_board",
    "coin_display",
    "statement_board",
    "reaction_timer",
    "night_overlay",
    "turn_indicator",
    "health_display",
    "influence_set",
    "broadcast_input",
    "player_states_display",
    "player_actions_display",
)

POSITIONS: tuple[str, ...] = (
    "top-left",
    "top-center",
    "top-right",
    "middle-left",
    "center",
    "middle-right",
    "bottom-left",
    "bottom-center",
    "bottom-right",
)

_POSITION_ALIASES = {
    "middle-center": "center",
    "center-center": "center",
    "middle-middle": "center",
    "mid-center": "center",
    "central": "center",
}


def normalize_position(position: str) -> str:
    """Common-mistake tolerant position normalizer
    (reference: src/lib/canvas/types.ts:73-94)."""
    p = (position or "").strip().lower()
    if p in POSITIONS:
        return p
    return _POSITION_ALIASES.get(p, "center")


# tool name -> card type, for the DM projection
TOOL_TO_CARD: dict[str, str] = {
    "createCharacterCard": "character_card",
    "createRoleCard": "character_card",  # hidden-role deal card (same UI)
    "createActionButton": "action_button",
    "createPhaseIndicator": "phase_indicator",
    "createTextDisplay": "text_display",
    "createVotingPanel": "voting_panel",
    "createAvatarSet": "avatar_set",
    "createBackgroundControl": "background_control",
    "createResultDisplay": "result_display",
    "createTimer": "timer",
    "createDeathMarker": "death_marker",
    "createHandsCard": "hands_card",
    "createScoreBoard": "score_board",
    "createCoinDisplay": "coin_display",
    "createStatementBoard": "statement_board",
    "createReactionTimer": "reaction_timer",
    "createNightOverlay": "night_overlay",
    "createTurnIndicator": "turn_indicator",
    "createHealthDisplay": "health_display",
    "createInfluenceSet": "influence_set",
    "createBroadcastInput": "broadcast_input",
    "createPlayerStatesDisplay": "player_states_display",
    "createPlayerActionsDisplay": "player_actions_display",
    "createTextInputPanel": "broadcast_input",  # floating text input panel
}

# default per-card positions (the DM's layout habits)
DEFAULT_POSITION: dict[str, str] = {
    "phase_indicator": "top-center",
    "text_display": "center",
    "voting_panel": "middle-right",
    "result_display": "center",
    "timer": "top-right",
    "score_board": "middle-left",
    "statement_board": "center",
    "turn_indicator": "top-left",
    "character_card": "middle-left",
    "death_marker": "bottom-left",
    "night_overlay": "center",
    "broadcast_input": "bottom-center",
}


@dataclasses.dataclass
class Item:
    """One canvas item (reference: src/lib/canvas/types.ts:298-304)."""

    id: str
    type: str
    name: str
    subtitle: str = ""
    data: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "type": self.type,
            "name": self.name,
            "subtitle": self.subtitle,
            "data": self.data,
        }


def make_item(
    item_id: str,
    card_type: str,
    name: str,
    *,
    audience_type: bool = True,
    audience_ids: Optional[list[str]] = None,
    position: Optional[str] = None,
    subtitle: str = "",
    **data: Any,
) -> Item:
    assert card_type in CARD_TYPES, card_type
    d: dict[str, Any] = {
        "audience_type": audience_type,
        "audience_ids": audience_ids or [],
        "position": normalize_position(position or DEFAULT_POSITION.get(card_type, "center")),
    }
    d.update(data)
    return Item(id=item_id, type=card_type, name=name, subtitle=subtitle, data=d)


def visible_to(item: Item, viewer_id: str) -> bool:
    """Audience gate (reference: CardRenderer.tsx:56-76): public items are
    visible to everyone; private ones only to listed player ids."""
    if item.data.get("audience_type", True):
        return True
    return str(viewer_id) in [str(x) for x in item.data.get("audience_ids", [])]


def clear_canvas(items: list[Item], exempt: Optional[list[str]] = None) -> list[Item]:
    """clearCanvas semantics: remove everything except avatar sets,
    character (role) cards, and explicitly exempted item ids/types
    (reference: src/app/page.tsx:2418-2455, tests/test_clearcanvas.js).

    character_card and statement_board persist like avatar_set: the
    player's hidden-role card and the current round's statements must
    survive phase clears — the reference DM re-creates them on demand, but
    with multi-phase Continue jumps they would otherwise only ever exist
    between two clears and no human would see them. Singleton replacement
    in the projector prevents stacking on re-creation."""
    exempt = exempt or []
    kept = []
    for it in items:
        if it.type in ("avatar_set", "character_card", "statement_board"):
            kept.append(it)
        elif it.id in exempt or it.type in exempt:
            kept.append(it)
    return kept
