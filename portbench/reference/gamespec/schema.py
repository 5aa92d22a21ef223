"""Typed schema for the YAML game DSL.

The DSL contract is defined by the reference's generation prompts
(reference: agent/prompt/dsl_declaration_generation_prompt.txt:15-60,
agent/prompt/dsl_phases_generation_prompt.txt:40-185) and the two shipped
games (reference: games/werewolf-(mafia).yaml, games/two-truths-and-a-lie.yaml).

Two root keys:
  declaration: metadata, roles, per-player state schema + template,
               players_example, audience_groups
  phases:      {int id: {name, description, actions[], completion_criteria,
               next_phase}}

``next_phase`` is either a direct {id, name}, a branch map of
natural-language condition -> {id, name} evaluated first-match-wins
(reference: agent/prompt/PhaseNode_system_prompt.txt:44-48), or null
(terminal phase).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class FieldType(enum.Enum):
    """Types allowed in declaration.player_states.<field>.type.

    Reference type-default rules: src/app/api/games/initialize-players/
    route.ts:115-141 (string->'', num->0, boolean->false, dict->{}, array->[]).
    """

    STRING = "string"
    NUM = "num"
    BOOLEAN = "boolean"
    DICT = "dict"
    ARRAY = "array"


_FIELD_TYPE_ALIASES = {
    "string": FieldType.STRING,
    "str": FieldType.STRING,
    "text": FieldType.STRING,
    "num": FieldType.NUM,
    "number": FieldType.NUM,
    "int": FieldType.NUM,
    "integer": FieldType.NUM,
    "float": FieldType.NUM,
    "boolean": FieldType.BOOLEAN,
    "bool": FieldType.BOOLEAN,
    "dict": FieldType.DICT,
    "object": FieldType.DICT,
    "map": FieldType.DICT,
    "array": FieldType.ARRAY,
    "list": FieldType.ARRAY,
}


def parse_field_type(raw: Any) -> FieldType:
    key = str(raw).strip().lower()
    if key not in _FIELD_TYPE_ALIASES:
        raise ValueError(f"unknown player_states field type: {raw!r}")
    return _FIELD_TYPE_ALIASES[key]


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One entry of declaration.player_states."""

    name: str
    type: FieldType
    example: Any = None
    description: str = ""
    default: Any = None  # from player_states_template (or type default)


@dataclasses.dataclass(frozen=True)
class RoleSpec:
    name: str
    description: str = ""


@dataclasses.dataclass(frozen=True)
class AudienceGroup:
    """Named player group with a Python-ish predicate string.

    e.g. selection_criteria: "player.team == 'werewolves' and
    player.is_alive == true" (reference: games/werewolf-(mafia).yaml:138-165).
    """

    name: str
    description: str = ""
    selection_criteria: str = ""


class CompletionType(enum.Enum):
    """completion_criteria.type (reference:
    agent/prompt/dsl_phases_generation_prompt.txt:119-150)."""

    UI_DISPLAYED = "UI_displayed"
    TIMER = "timer"
    PLAYER_ACTION = "player_action"


class WaitFor(enum.Enum):
    SINGLE = "single_player_choice"
    ALL = "all_players_action"
    MULTIPLE = "multiple_players_action"


@dataclasses.dataclass(frozen=True)
class CompletionCriteria:
    type: CompletionType
    description: str = ""
    wait_for: Optional[WaitFor] = None
    # target_players.{description, condition}: which players must act
    target_description: str = ""
    target_condition: str = ""


@dataclasses.dataclass(frozen=True)
class PhaseAction:
    """One DM render action: a description + the UI tool names to call."""

    description: str
    tools: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class NextPhaseBranch:
    """One branch of a conditional next_phase map (first-match-wins)."""

    condition: str  # natural-language sentence (the YAML map key)
    phase_id: int
    phase_name: str = ""


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    id: int
    name: str
    description: str
    actions: tuple[PhaseAction, ...]
    completion: CompletionCriteria
    # Exactly one of: branches (conditional), next_id (direct), or terminal.
    branches: tuple[NextPhaseBranch, ...] = ()
    next_id: Optional[int] = None
    next_name: str = ""
    # Explicit mechanic declarations (DSL `mechanics:` key, a framework
    # extension over the reference DSL): normalized (name, arg) pairs that
    # force analyzer attachment regardless of phase-text vocabulary. See
    # gamespec/mechanics.py HINTS and SEMANTICS.md P18.
    mechanic_hints: tuple[tuple[str, Any], ...] = ()

    @property
    def is_terminal(self) -> bool:
        return self.next_id is None and not self.branches


@dataclasses.dataclass(frozen=True)
class Declaration:
    description: str
    is_multiplayer: bool
    min_players: int
    roles: tuple[RoleSpec, ...]
    fields: tuple[FieldSpec, ...]
    # players_example rows: {player_id(int) -> {field -> value}}
    players_example: dict[int, dict[str, Any]]
    audience_groups: tuple[AudienceGroup, ...]
    # optional tool manifest under players_example.tools
    tools: tuple[str, ...] = ()

    def field(self, name: str) -> FieldSpec:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def field_names(self) -> list[str]:
        return [f.name for f in self.fields]


@dataclasses.dataclass(frozen=True)
class GameSpec:
    name: str
    declaration: Declaration
    phases: dict[int, PhaseSpec]  # keyed by DSL phase id (sparse ids ok)

    @property
    def phase_ids(self) -> list[int]:
        return sorted(self.phases)

    @property
    def start_phase_id(self) -> int:
        # Phase 0 is always "Game Introduction" per the DSL contract
        # (reference: agent/prompt/dsl_phases_generation_prompt.txt:95-106);
        # fall back to the lowest id for defensive robustness.
        return 0 if 0 in self.phases else self.phase_ids[0]
