"""Deterministic DSL generator.

The reference generates game DSLs with three sequential gpt-5 calls taking
~10 minutes (reference: agent/dsl_agent.py:157-371, README.md:48). This
module generates the same YAML contract deterministically (milliseconds)
from a structured Blueprint covering the thirteen social-game archetypes the
engine's mechanics library executes:

  * 'elimination' — hidden-roles night/day cycle (werewolf-like): an evil
    team secretly eliminates, optional protector/investigator roles, day
    plurality voting, team win conditions;
  * 'rounds'      — speaker-rotation guess games (two-truths-like): a
    rotating speaker submits content, others vote, guess scoring, fixed
    rounds per player;
  * 'battle'      — last-survivor elimination voting (no hidden roles);
  * 'bluff'       — Coup-style claim/challenge over hidden court roles and
    influence (P14);
  * 'market'      — resource income + simultaneous raids, first purse to
    the target wins (P12/P13);
  * 'minority'    — simultaneous-reveal odd-one-out: secret picks, the
    smallest group scores (P16).

Archetypes also COMPOSE: ``Blueprint.extras`` weaves additional mechanic
families into the base phase graph (``('market',)`` on ``'elimination'``
adds P12 income each morning, a P13 raid round each day, and a second
terminal won by the richest purse via P17 per-terminal winner modes — see
``games/gold-rush.yaml``). The mix matrix (``_MIXERS``) spans 8 (base,
extra) pairs: the market family weaves into elimination, battle, rounds,
bluff, and racing; the auction family into elimination, battle, and bluff
(witnesses: gold-rush, bounty-arena, story-pot, scrap-rally, relic-auction,
trophy-arena, gilded-court). Registered STACKS (``_STACKS``) compose BOTH
economy families onto one base — elimination/battle + market + auction
with three live terminals (witness: harbor-lots).

``generate_from_description`` maps a free-text description onto a Blueprint
by keyword (including mixes: a description with both night-role and economy
vocabulary composes elimination+market), and additionally MINES the
description for the cast: night-role names by convention (mafia/vampires
kill, healers protect, sheriffs investigate), duplicated killers ("two
vampires"), and the table size ("6 players"). An external LLM can be
plugged at the ``llm_hook`` seam where the reference called OpenAI — no
network is required built-in.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional

from game_engine_tpu_torch.dslgen import rules as RU


@dataclasses.dataclass(frozen=True)
class RoleDef:
    name: str
    team: str
    night_action: str = ""  # '', 'kill', 'protect', 'investigate'
    description: str = ""


@dataclasses.dataclass(frozen=True)
class Blueprint:
    name: str
    description: str
    archetype: str  # 'elimination' | 'rounds' | 'battle' | 'bluff' | 'market' | 'minority' | 'auction' | 'gifting' | 'conversion' | 'pressluck' | 'racing' | 'draft' | 'masquerade'
    min_players: int = 4
    roles: tuple[RoleDef, ...] = ()
    # mechanic MIXES composed into the base archetype's phase graph, e.g.
    # ('market',) on 'elimination' adds a coin economy (P12 income each
    # morning, a P13 raid round each day) and a second terminal phase won
    # by the richest purse (P17 per-terminal winner modes)
    extras: tuple[str, ...] = ()
    # Note: the "agreed number of speaking turns" is engine configuration
    # (GameConfig.rounds_per_player / the server's roundsPerPlayer start
    # option), not part of the generated DSL — the DSL's branch sentence
    # intentionally says "the agreed number".


WEREWOLF_LIKE_ROLES = (
    RoleDef("Civilian", "town", "", "No night action; votes during the day."),
    RoleDef("Assassin", "assassins", "kill", "At night, chooses one target to eliminate."),
    RoleDef("Guardian", "town", "protect", "At night, protects one player from elimination."),
    RoleDef("Seer", "town", "investigate", "At night, investigates one player's alignment."),
)


def _tool_action(description: str, *tools: str) -> dict[str, Any]:
    return {"description": description, "tools": list(tools)}


def _ui_phase(name: str, description: str, actions: list[dict], next_phase) -> dict[str, Any]:
    return {
        "name": name,
        "description": description,
        "actions": actions,
        "completion_criteria": {
            "type": "UI_displayed",
            "description": f"{name} has been displayed to all players.",
        },
        "next_phase": next_phase,
    }


def _action_phase(
    name: str,
    description: str,
    actions: list[dict],
    completion_desc: str,
    wait_for: str,
    target_desc: str,
    condition: str,
    next_phase,
) -> dict[str, Any]:
    return {
        "name": name,
        "description": description,
        "actions": actions,
        "completion_criteria": {
            "type": "player_action",
            "description": completion_desc,
            "wait_for": wait_for,
            "target_players": {"description": target_desc, "condition": condition},
        },
        "next_phase": next_phase,
    }


def _timer_phase(name: str, description: str, actions: list[dict], next_phase) -> dict[str, Any]:
    return {
        "name": name,
        "description": description,
        "actions": actions,
        "completion_criteria": {"type": "timer", "description": "Discussion timer has expired."},
        "next_phase": next_phase,
    }


# ---------------------------------------------------------------------------
# elimination archetype
# ---------------------------------------------------------------------------


def _gen_elimination(bp: Blueprint) -> dict[str, Any]:
    roles = bp.roles or WEREWOLF_LIKE_ROLES
    killer = next((r for r in roles if r.night_action == "kill"), None)
    filler = next((r for r in roles if not r.night_action), None)
    if killer is None or filler is None:
        raise ValueError(
            "elimination blueprints need one role with night_action='kill' "
            "and one action-less filler role"
        )
    protector = next((r for r in roles if r.night_action == "protect"), None)
    investigator = next((r for r in roles if r.night_action == "investigate"), None)
    evil_team, good_team = killer.team, filler.team

    fields = {
        "name": {"type": "string", "example": "Player A", "description": "Public display name."},
        "role": {"type": "string", "example": killer.name,
                 "description": f"Player's hidden role ({', '.join(r.name for r in roles)})."},
        "team": {"type": "string", "example": evil_team,
                 "description": f"Faction alignment ('{good_team}' or '{evil_team}')."},
        "is_alive": {"type": "boolean", "example": True,
                     "description": "Whether the player is still in the game."},
        "can_vote": {"type": "boolean", "example": True,
                     "description": "Whether the player may vote during day voting."},
        "night_action_eligible": {"type": "boolean", "example": True,
                                  "description": "Whether the player can take a night action."},
        "night_action_submitted": {"type": "boolean", "example": False,
                                   "description": "Whether the player has submitted their night action."},
        "selected_target_id": {"type": "num", "example": 2,
                               "description": "Target player ID for this player's night action (0 if none)."},
    }
    if investigator:
        fields["investigated_alignments"] = {
            "type": "dict",
            "example": {"2": good_team, "3": evil_team},
            "description": "Investigator's private memory mapping player IDs to alignments.",
        }
    template = {
        "name": "", "role": "", "team": "", "is_alive": True, "can_vote": True,
        "night_action_eligible": False, "night_action_submitted": False,
        "selected_target_id": 0,
    }
    if investigator:
        template["investigated_alignments"] = {}

    def example_row(name, role):
        row = dict(template)
        row.update(
            name=name, role=role.name, team=role.team,
            night_action_eligible=bool(role.night_action),
        )
        return row

    # pad the example table with filler rows (reference werewolf ships 8
    # example rows, mostly villagers) so that P10's surplus-takes-most-
    # common rule hands extra seats to the FILLER role, not to a
    # duplicated killer ("two bandits" must stay two at any table size)
    example_roles = list(roles) + [filler] * max(0, 8 - len(roles))
    players_example = {
        str(i + 1): example_row(nm, r)
        for i, (nm, r) in enumerate(zip(
            ["Alpha", "Beta", "Gamma", "Delta", "Echo", "Foxtrot", "Golf", "Hotel"],
            example_roles))
    }

    tools = [
        "clearCanvas", "createPhaseIndicator", "createTextDisplay", "createAvatarSet",
        "createVotingPanel", "createResultDisplay", "createTimer", "markPlayerDead",
        "createDeathMarker", "createCharacterCard",
    ]

    def night_phase(idx, role, first, nxt):
        prefix = "First Night" if first else "Night"
        if role.night_action == "kill":
            nm = f"{prefix} — {role.name}s Choose Target"
            desc = f"Alive {role.name}s privately choose a target to eliminate; others wait."
            comp = ("Votes/choices have been received from all alive "
                    f"{role.name}s, and relevant player state (player_states) has been "
                    "updated (night_action_submitted=true, selected_target_id set).")
            wait = "multiple_players_action"
        elif role.night_action == "protect":
            nm = f"{prefix} — {role.name} Protects"
            desc = f"The {role.name} privately chooses one player to protect from elimination this night."
            comp = (f"{role.name} has submitted a protection target and relevant player state "
                    "(player_states) has been updated (night_action_submitted=true, "
                    "selected_target_id set).")
            wait = "single_player_choice"
        else:
            nm = f"{prefix} — {role.name} Investigates"
            desc = f"The {role.name} privately investigates one player to learn their alignment."
            comp = (f"{role.name} has selected an investigation target and relevant player state "
                    "(player_states) has been updated (night_action_submitted=true, "
                    "investigated_alignments updated).")
            wait = "single_player_choice"
        return _action_phase(
            nm, desc,
            [
                _tool_action("Clear previous UI; exempt death markers", "clearCanvas"),
                _tool_action(f"TIER 1 - PUBLIC: Create night phase indicator ({nm})",
                             "createPhaseIndicator"),
                _tool_action(f"TIER 2 - GROUP: Show waiting message to all players except the {role.name}",
                             "createTextDisplay"),
                _tool_action(f"TIER 2 - GROUP: Create private voting panel for the {role.name} "
                             "to choose an alive target", "createVotingPanel"),
            ],
            comp, wait, f"Alive {role.name}s",
            f"player.role == '{role.name}' and player.is_alive == true",
            nxt,
        )

    night_roles = [r for r in (killer, protector, investigator) if r is not None]

    phases: dict[int, dict] = {}
    phases[0] = _ui_phase(
        "Game Introduction",
        "Introduce the game's rules, roles, and night/day flow to all players.",
        [
            _tool_action("Clear all previous UI elements", "clearCanvas"),
            _tool_action("Create public phase indicator", "createPhaseIndicator"),
            _tool_action("Display rules and win conditions", "createTextDisplay"),
            _tool_action("Create avatar set overlay for all players", "createAvatarSet"),
        ],
        {"id": 1, "name": "Role Assignment"},
    )
    phases[1] = _ui_phase(
        "Role Assignment",
        "Randomly assign roles to players and privately display each player's role card.",
        [
            _tool_action("Clear introduction UI", "clearCanvas"),
            _tool_action("TIER 1 - PUBLIC: Create phase indicator", "createPhaseIndicator"),
            _tool_action("TIER 3 - INDIVIDUAL: Create personal role card for each player",
                         "createCharacterCard"),
        ],
        {"id": 2, "name": "night-0"},
    )
    # deterministic id plan (werewolf-shaped):
    #   cycle 1: nights N1=[2..2+K-1], morning M1, discussion D1, voting V1,
    #            results R1, win-check W
    #   cycle 2: nights N2=[W+1..W+K], morning M2 -> W, discussion D2,
    #            voting V2, results R2 -> W
    K = len(night_roles)
    N1 = 2
    M1 = N1 + K
    D1, V1, R1, W = M1 + 1, M1 + 2, M1 + 3, M1 + 4
    N2 = W + 1
    M2 = N2 + K
    D2, V2, R2 = M2 + 1, M2 + 2, M2 + 3

    def morning_phase(name, nxt):
        return _ui_phase(
            name,
            "Resolve the night: apply the kill attempt versus protection, then announce "
            "any eliminations to all players.",
            [
                _tool_action("Clear night UI; exempt death markers so they persist", "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: Create morning phase indicator", "createPhaseIndicator"),
                _tool_action("TIER 1 - PUBLIC: Display elimination announcement", "createResultDisplay"),
                _tool_action("If a player was eliminated overnight, mark them dead",
                             "markPlayerDead", "createDeathMarker"),
            ],
            nxt,
        )

    def discussion_phase(name, nxt):
        return _timer_phase(
            name, "Open discussion among all players before voting.",
            [
                _tool_action("Clear morning UI; exempt death markers", "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: Create day discussion phase indicator",
                             "createPhaseIndicator"),
                _tool_action("TIER 1 - PUBLIC: Start a discussion timer", "createTimer"),
            ],
            nxt,
        )

    def voting_phase(name, nxt):
        return _action_phase(
            name, "All eligible (alive) players vote to eliminate one player.",
            [
                _tool_action("Clear discussion UI; exempt death markers", "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: Create day voting phase indicator",
                             "createPhaseIndicator"),
                _tool_action("TIER 2 - GROUP: Create voting panel for all eligible voters",
                             "createVotingPanel"),
            ],
            "All eligible voters have cast their votes and relevant player state "
            "(player_states) has been updated with voting selections.",
            "multiple_players_action", "All eligible voters",
            "player.can_vote == true and player.is_alive == true",
            nxt,
        )

    def results_phase(nxt):
        return _ui_phase(
            "Announce Day Voting Results",
            "Announce the player selected for elimination by day vote and update their status.",
            [
                _tool_action("Clear voting UI; exempt death markers", "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: Display the eliminated player", "createResultDisplay"),
                _tool_action("Mark the eliminated player dead", "markPlayerDead", "createDeathMarker"),
            ],
            nxt,
        )

    for i, r in enumerate(night_roles):
        nxt1 = {"id": N1 + i + 1, "name": "next"} if i + 1 < K else {"id": M1, "name": "Morning"}
        nxt2 = {"id": N2 + i + 1, "name": "next"} if i + 1 < K else {"id": M2, "name": "Morning"}
        phases[N1 + i] = night_phase(i, r, True, nxt1)
        phases[N2 + i] = night_phase(i, r, False, nxt2)
    phases[1]["next_phase"] = {"id": N1, "name": phases[N1]["name"]}
    phases[M1] = morning_phase("First Morning — Announce Night Results",
                               {"id": D1, "name": "First Day Discussion"})
    phases[D1] = discussion_phase("First Day Discussion", {"id": V1, "name": "First Day Voting"})
    phases[V1] = voting_phase("First Day Voting", {"id": R1, "name": "Results"})
    phases[R1] = results_phase({"id": W, "name": "Check Win Conditions"})
    phases[M2] = morning_phase("Morning — Announce Night Results",
                               {"id": W, "name": "Check Win Conditions"})
    phases[D2] = discussion_phase("Day Discussion", {"id": V2, "name": "Day Voting"})
    phases[V2] = voting_phase("Day Voting", {"id": R2, "name": "Results"})
    phases[R2] = results_phase({"id": W, "name": "Check Win Conditions"})
    phases[W] = {
        "name": "Check Win Conditions",
        "description": "Evaluate whether either side has won after the latest elimination.",
        "actions": [
            _tool_action("Prepare routing by evaluating living team counts", "clearCanvas"),
            _tool_action("TIER 1 - PUBLIC: Display status while win conditions are evaluated",
                         "createTextDisplay"),
        ],
        "completion_criteria": {
            "type": "UI_displayed",
            "description": "Win condition evaluation prepared.",
        },
        "next_phase": {
            f"If no living {killer.name}s remain (all {killer.name.lower()}s eliminated)": {
                "id": 99, "name": "Game Over"},
            f"If living {killer.name}s are equal to or outnumber living {filler.name}s": {
                "id": 99, "name": "Game Over"},
            "If this check follows a day elimination and the game continues": {
                "id": N2, "name": phases[N2]["name"]},
            "If this check follows a night resolution and the game continues": {
                "id": D2, "name": "Day Discussion"},
        },
    }
    phases[99] = _ui_phase(
        "Game Over — Final Results",
        "Display the final outcome based on win conditions and close the game.",
        [
            _tool_action("Clear non-persistent UI; exempt death markers", "clearCanvas"),
            _tool_action("TIER 1 - PUBLIC: Display the winning side", "createResultDisplay"),
        ],
        None,
    )

    groups = {
        killer.team: {
            "description": f"Alive players aligned with the {killer.team} faction.",
            "selection_criteria": f"player.team == '{killer.team}' and player.is_alive == true",
        },
        good_team: {
            "description": f"Alive players aligned with {good_team}.",
            "selection_criteria": f"player.team == '{good_team}' and player.is_alive == true",
        },
        "alive_players": {
            "description": "All players who are alive.",
            "selection_criteria": "player.is_alive == true",
        },
    }

    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": bp.min_players,
            # each distinct role declared ONCE (cast sizes live in
            # players_example rows; duplicates would skew P10 counts)
            "roles": [{"name": r.name, "description": r.description}
                      for r in {r.name: r for r in roles}.values()],
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools, "player_states": players_example},
            "audience_groups": groups,
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# rounds archetype
# ---------------------------------------------------------------------------


def _gen_rounds(bp: Blueprint) -> dict[str, Any]:
    fields = {
        "name": {"type": "string", "example": "Alex", "description": "Player's display name."},
        "is_speaker": {"type": "boolean", "example": True,
                       "description": "Whether this player is the current speaker."},
        "statements": {"type": "dict", "example": {"1": "A story.", "2": "Another story.", "3": "A third story."},
                       "description": "Content provided by the player when they are the speaker."},
        "statements_submitted": {"type": "boolean", "example": True,
                                 "description": "True after the speaker has provided their content."},
        "lie_index": {"type": "num", "example": 2,
                      "description": "Which statement (1-3) is the secret. Private to the speaker."},
        "lie_revealed": {"type": "boolean", "example": False,
                         "description": "Whether the secret has been revealed."},
        "can_vote": {"type": "boolean", "example": True,
                     "description": "Whether this player may vote this round."},
        "vote_choice": {"type": "num", "example": 2,
                        "description": "The statement number (1-3) this player selected. 0 if not yet voted."},
        "has_voted": {"type": "boolean", "example": True,
                      "description": "Whether this player has cast their vote this round."},
        "total_score": {"type": "num", "example": 3,
                        "description": "Cumulative points across rounds."},
        "rounds_as_speaker": {"type": "num", "example": 0,
                              "description": "Number of completed speaking turns across all rounds."},
    }
    template = {
        "name": "", "is_speaker": False, "statements": {}, "statements_submitted": False,
        "lie_index": 0, "lie_revealed": False, "can_vote": True, "vote_choice": 0,
        "has_voted": False, "total_score": 0, "rounds_as_speaker": 0,
    }
    tools = [
        "clearCanvas", "createPhaseIndicator", "createTextDisplay", "createAvatarSet",
        "createScoreBoard", "createTurnIndicator", "createTextInputPanel",
        "createVotingPanel", "createStatementBoard", "createTimer", "createResultDisplay",
    ]
    phases = {
        0: _ui_phase(
            "Game Introduction", "Introduce the rules, scoring, and turn rotation.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create phase indicator for introduction", "createPhaseIndicator"),
                _tool_action("Display game rules and scoring", "createTextDisplay"),
                _tool_action("Create player avatar set", "createAvatarSet"),
                _tool_action("Create initial scoreboard", "createScoreBoard"),
            ],
            {"id": 1, "name": "Round Start"},
        ),
        1: _ui_phase(
            "Round Start",
            "Select/confirm the current speaker, reset round voting eligibility, and brief players.",
            [
                _tool_action("Clear previous UI, exempt persistent scoreboard", "clearCanvas"),
                _tool_action("Create phase indicator for round start", "createPhaseIndicator"),
                _tool_action("Create turn indicator highlighting the current speaker",
                             "createTurnIndicator"),
            ],
            {"id": 2, "name": "Content Collection"},
        ),
        2: _action_phase(
            "Content Collection", "Current speaker privately submits their content for the round.",
            [
                _tool_action("Clear previous UI preserving scoreboard", "clearCanvas"),
                _tool_action("Create phase indicator", "createPhaseIndicator"),
                _tool_action("Create private text input for the speaker", "createTextInputPanel"),
            ],
            "Speaker has submitted content, and relevant player state (player_states) "
            "has been updated (statements set, statements_submitted=true).",
            "single_player_choice", "The current speaker", "player.is_speaker == true",
            {"id": 3, "name": "Secret Selection"},
        ),
        3: _action_phase(
            "Secret Selection", "Speaker privately picks which statement (1-3) is the secret.",
            [
                _tool_action("Clear previous UI, exempt scoreboard", "clearCanvas"),
                _tool_action("Create phase indicator", "createPhaseIndicator"),
                _tool_action("Create private voting panel for the speaker (options 1,2,3)",
                             "createVotingPanel"),
            ],
            "Speaker has selected the secret via voting panel, and relevant player state "
            "(player_states) has been updated (lie_index set).",
            "single_player_choice", "The current speaker", "player.is_speaker == true",
            {"id": 4, "name": "Discussion"},
        ),
        4: _timer_phase(
            "Discussion", "Display the content to all players and allow open discussion.",
            [
                _tool_action("Clear previous UI, preserve scoreboard", "clearCanvas"),
                _tool_action("Create phase indicator", "createPhaseIndicator"),
                _tool_action("Display the statements to all players", "createStatementBoard"),
                _tool_action("Create discussion timer", "createTimer"),
            ],
            {"id": 5, "name": "Voting Phase"},
        ),
        5: _action_phase(
            "Voting Phase", "All eligible non-speaker players vote on which statement (1-3) is the secret.",
            [
                _tool_action("Clear discussion UI, exempt scoreboard", "clearCanvas"),
                _tool_action("Create phase indicator", "createPhaseIndicator"),
                _tool_action("Create voting panel for eligible voters", "createVotingPanel"),
            ],
            "Votes have been received from all eligible voters and relevant player state "
            "(player_states) has been updated (has_voted=true, vote_choice set).",
            "multiple_players_action", "All eligible voters (non-speakers)",
            "player.is_speaker == false and player.can_vote == true",
            {"id": 6, "name": "Reveal Phase"},
        ),
        6: {
            "name": "Reveal Phase",
            "description": "Reveal the secret statement to all players.",
            "actions": [
                _tool_action("Clear voting UI, preserve scoreboard", "clearCanvas"),
                _tool_action("Create phase indicator", "createPhaseIndicator"),
                _tool_action("Display statements highlighting the secret", "createStatementBoard"),
                _tool_action("Show public reveal announcement", "createResultDisplay"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                # the reveal marker lives in the completion description — the
                # analyzer's SetBoolAll rule reads exactly this field (it is
                # where the reference's two-truths YAML carries it)
                "description": "Reveal Phase has been displayed to all "
                               "players (lie_revealed set to true).",
            },
            "next_phase": {"id": 7, "name": "Scoring Update"},
        },
        7: _ui_phase(
            "Scoring Update", "Tally points for correct guesses and speaker deception; update the scoreboard.",
            [
                _tool_action("Clear reveal UI", "clearCanvas"),
                _tool_action("Create phase indicator", "createPhaseIndicator"),
                _tool_action("Create updated scoreboard", "createScoreBoard"),
            ],
            {"id": 8, "name": "Check Round Progress"},
        ),
        8: {
            "name": "Check Round Progress",
            "description": "Evaluate whether all players have completed the agreed number of "
                           "speaking turns; otherwise continue to the next speaker.",
            "actions": [
                _tool_action("Clear scoring UI preserving scoreboard", "clearCanvas"),
                _tool_action("Create phase indicator", "createPhaseIndicator"),
                _tool_action("Display speaker rotation status", "createTextDisplay"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "Round progress has been evaluated.",
            },
            "next_phase": {
                "If all players have completed the agreed number of speaking turns": {
                    "id": 99, "name": "Game Over"},
                "Otherwise, continue to the next speaker's turn": {"id": 1, "name": "Round Start"},
            },
        },
        99: _ui_phase(
            "Game Over — Final Results", "Display the final standings and congratulate the winner.",
            [
                _tool_action("Clear previous UI elements", "clearCanvas"),
                _tool_action("Create final scoreboard", "createScoreBoard"),
                _tool_action("Create celebratory final result display", "createResultDisplay"),
            ],
            None,
        ),
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools, "player_states": {"1": {**template, "name": "Alex", "is_speaker": True}}},
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# battle archetype: last-survivor voting (no hidden roles, no scores)
# ---------------------------------------------------------------------------


def _gen_battle(bp: Blueprint) -> dict[str, Any]:
    fields = {
        "name": {"type": "string", "example": "Player A", "description": "Public display name."},
        "is_alive": {"type": "boolean", "example": True,
                     "description": "Whether the player is still in the game."},
        "can_vote": {"type": "boolean", "example": True,
                     "description": "Whether the player may vote this round."},
    }
    template = {"name": "", "is_alive": True, "can_vote": True}
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay", "createAvatarSet",
             "createVotingPanel", "createResultDisplay", "createTimer", "markPlayerDead",
             "createDeathMarker"]
    phases = {
        0: _ui_phase(
            "Game Introduction", "Introduce the elimination-voting rules to all players.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator", "createPhaseIndicator"),
                _tool_action("Display rules: vote someone out each round; last one standing wins",
                             "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Discussion"},
        ),
        1: _timer_phase(
            "Discussion", "Open discussion before the elimination vote.",
            [
                _tool_action("Clear previous UI; exempt death markers", "clearCanvas"),
                _tool_action("Create discussion phase indicator", "createPhaseIndicator"),
                _tool_action("Start a discussion timer", "createTimer"),
            ],
            {"id": 2, "name": "Elimination Vote"},
        ),
        2: _action_phase(
            "Elimination Vote", "All alive players vote to eliminate one player.",
            [
                _tool_action("Clear discussion UI; exempt death markers", "clearCanvas"),
                _tool_action("Create voting phase indicator", "createPhaseIndicator"),
                _tool_action("Create voting panel for all alive voters", "createVotingPanel"),
            ],
            "All eligible voters have cast their votes and relevant player state "
            "(player_states) has been updated with voting selections.",
            "multiple_players_action", "All alive voters",
            "player.can_vote == true and player.is_alive == true",
            {"id": 3, "name": "Announce Results"},
        ),
        3: _ui_phase(
            "Announce Vote Results",
            "Announce the player selected for elimination by the vote and update their status.",
            [
                _tool_action("Clear voting UI; exempt death markers", "clearCanvas"),
                _tool_action("Display the eliminated player", "createResultDisplay"),
                _tool_action("Mark the eliminated player dead", "markPlayerDead", "createDeathMarker"),
            ],
            {"id": 4, "name": "Check Survivors"},
        ),
        4: {
            "name": "Check Survivors",
            "description": "Evaluate whether only one player remains.",
            "actions": [
                _tool_action("Clear results UI; exempt death markers", "clearCanvas"),
                _tool_action("Display remaining player count", "createTextDisplay"),
            ],
            "completion_criteria": {"type": "UI_displayed",
                                    "description": "Survivor count evaluated."},
            "next_phase": {
                "If only one player remains alive": {"id": 99, "name": "Game Over"},
                "If two or more players remain alive, continue": {"id": 1, "name": "Discussion"},
            },
        },
        99: _ui_phase(
            "Game Over — Final Results", "Congratulate the last player standing.",
            [
                _tool_action("Clear non-persistent UI; exempt death markers", "clearCanvas"),
                _tool_action("Display the surviving winner", "createResultDisplay"),
            ],
            None,
        ),
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools,
                                "player_states": {"1": {**template, "name": "Alpha"}}},
            "audience_groups": {
                "alive_players": {
                    "description": "All players who are alive.",
                    "selection_criteria": "player.is_alive == true",
                },
            },
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# bluff archetype: Coup-style claim/challenge over hidden court roles (P14)
# ---------------------------------------------------------------------------

COURT_ROLES = (
    RoleDef("Duke", "court", "", "Commands taxes; a favourite claim."),
    RoleDef("Assassin", "court", "", "Strikes from the shadows."),
    RoleDef("Contessa", "court", "", "Blocks assassinations."),
)


def _gen_bluff(bp: Blueprint) -> dict[str, Any]:
    roles = bp.roles or COURT_ROLES
    nr = len(roles)
    fields = {
        "name": {"type": "string", "example": "Player A", "description": "Public display name."},
        "role": {"type": "string", "example": roles[0].name,
                 "description": "The player's hidden court role."},
        "is_alive": {"type": "boolean", "example": True,
                     "description": "Whether the player still holds influence."},
        "influence": {"type": "num", "example": 2,
                      "description": "Remaining influence; at zero the player is out."},
        "claim_choice": {"type": "num", "example": 1,
                         "description": f"The court role (1-{nr}) this player claims to hold; 0 if none."},
    }
    template = {"name": "", "role": "", "is_alive": True, "influence": 2,
                "claim_choice": 0}
    n_ex = max(bp.min_players, 4)
    example_states = {}
    for i in range(n_ex):
        example_states[str(i + 1)] = {
            **template, "name": f"Courtier {i + 1}",
            "role": roles[i % nr].name,
        }
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay", "createAvatarSet",
             "createCharacterCard", "createVotingPanel", "createResultDisplay",
             "createInfluenceSet", "markPlayerDead", "createDeathMarker", "createTimer"]
    phases = {
        0: _ui_phase(
            "Game Introduction",
            "Introduce the court: claim a role each round, challenge suspected bluffs, "
            "survive with your influence intact.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator", "createPhaseIndicator"),
                _tool_action("Display the rules of the court", "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Role Assignment"},
        ),
        1: _ui_phase(
            "Role Assignment",
            "Secretly assign each player a hidden court role.",
            [
                _tool_action("Clear introduction UI", "clearCanvas"),
                _tool_action("TIER 3: privately show each player their role card",
                             "createCharacterCard"),
                _tool_action("Show influence counters", "createInfluenceSet"),
            ],
            {"id": 2, "name": "Declarations"},
        ),
        2: _action_phase(
            "Declarations",
            f"Each living player declares which court role (1-{nr}) they claim to hold "
            "this round.",
            [
                _tool_action("Clear previous UI; exempt death markers and influence counters", "clearCanvas"),
                _tool_action("Create declaration phase indicator", "createPhaseIndicator"),
                _tool_action("Create the claim selection panel", "createVotingPanel"),
            ],
            "All living players have declared and claim_choice set to the chosen "
            f"option (1-{nr}).",
            "all_players_action", "All living players",
            "player.is_alive == true",
            {"id": 3, "name": "Challenges"},
        ),
        3: _action_phase(
            "Challenges",
            "Each living player chooses one player to challenge over their declaration.",
            [
                _tool_action("Clear declaration UI; exempt death markers and influence counters", "clearCanvas"),
                _tool_action("Create challenge phase indicator", "createPhaseIndicator"),
                _tool_action("Create the challenge target panel", "createVotingPanel"),
            ],
            "All living players have chosen a challenge target.",
            "all_players_action", "All living players",
            "player.is_alive == true",
            {"id": 4, "name": "Showdown"},
        ),
        4: _ui_phase(
            "Showdown",
            "Resolve the challenges: a caught bluffer loses 1 influence; a failed "
            "challenger loses 1 influence; players at zero influence are out.",
            [
                _tool_action("Clear challenge UI; exempt death markers and influence counters", "clearCanvas"),
                _tool_action("Display the showdown results", "createResultDisplay"),
                _tool_action("Mark players who lost their last influence",
                             "markPlayerDead", "createDeathMarker"),
                _tool_action("Update influence counters", "createInfluenceSet"),
            ],
            {"id": 5, "name": "Check the Court"},
        ),
        5: {
            "name": "Check the Court",
            "description": "Evaluate whether only one player still holds influence.",
            "actions": [
                _tool_action("Clear showdown UI; exempt death markers and influence counters", "clearCanvas"),
                _tool_action("Display remaining players", "createTextDisplay"),
            ],
            "completion_criteria": {"type": "UI_displayed",
                                    "description": "Court status evaluated."},
            "next_phase": {
                "If only one player remains alive": {"id": 99, "name": "Game Over"},
                "If two or more players remain alive, the court continues":
                    {"id": 2, "name": "Declarations"},
            },
        },
        99: _ui_phase(
            "Game Over — The Court Falls",
            "Congratulate the last courtier standing (a court with no survivors is a draw).",
            [
                _tool_action("Clear non-persistent UI; exempt death markers", "clearCanvas"),
                _tool_action("Display the surviving winner", "createResultDisplay"),
            ],
            None,
        ),
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            # each distinct role declared ONCE (cast sizes live in
            # players_example rows; duplicates would skew P10 counts)
            "roles": [{"name": r.name, "description": r.description}
                      for r in {r.name: r for r in roles}.values()],
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools, "player_states": example_states},
            "audience_groups": {
                "living_players": {
                    "description": "All players still holding influence.",
                    "selection_criteria": "player.is_alive == true",
                },
            },
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# market archetype: resource income + simultaneous raids (P12/P13)
# ---------------------------------------------------------------------------


def _gen_market(bp: Blueprint, win_coins: int = 10,
                income: int = 1) -> dict[str, Any]:
    fields = {
        "name": {"type": "string", "example": "Player A", "description": "Public display name."},
        "coins": {"type": "num", "example": 3,
                  "description": "The player's coin purse; first to "
                                 f"{win_coins} wins."},
    }
    template = {"name": "", "coins": 3}
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay", "createAvatarSet",
             "createCoinDisplay", "createVotingPanel", "createResultDisplay",
             "createScoreBoard", "createTimer"]
    phases = {
        0: _ui_phase(
            "Game Introduction",
            "Introduce the market: collect income, raid rivals, first to "
            f"{win_coins} coins wins.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator", "createPhaseIndicator"),
                _tool_action("Display the market rules", "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Market Income"},
        ),
        1: _ui_phase(
            "Market Income",
            f"Each player collects {income} "
            f"coin{'s' if income != 1 else ''} from the market stall.",
            [
                _tool_action("Clear previous UI", "clearCanvas"),
                _tool_action("Create income phase indicator", "createPhaseIndicator"),
                _tool_action("Show each purse", "createCoinDisplay"),
            ],
            {"id": 2, "name": "Raid Selection"},
        ),
        2: _action_phase(
            "Raid Selection",
            "Each player chooses one rival to raid at nightfall.",
            [
                _tool_action("Clear income UI", "clearCanvas"),
                _tool_action("Create raid phase indicator", "createPhaseIndicator"),
                _tool_action("Create the raid target panel", "createVotingPanel"),
            ],
            "All players have chosen a raid target.",
            "all_players_action", "All players",
            "player.coins >= 0",
            {"id": 3, "name": "Raid Resolution"},
        ),
        3: _ui_phase(
            "Raid Resolution",
            "Resolve the raids: each raided player loses coins to the raiders, one "
            "coin per successful raider.",
            [
                _tool_action("Clear raid UI", "clearCanvas"),
                _tool_action("Display the raid results", "createResultDisplay"),
                _tool_action("Update the scoreboard; exempt persistent scoreboard",
                             "createScoreBoard"),
            ],
            {"id": 4, "name": "Check Fortunes"},
        ),
        4: {
            "name": "Check Fortunes",
            "description": "Evaluate whether any purse has reached the target.",
            "actions": [
                _tool_action("Clear results UI; exempt persistent scoreboard", "clearCanvas"),
                _tool_action("Display the leading purse", "createTextDisplay"),
            ],
            "completion_criteria": {"type": "UI_displayed",
                                    "description": "Fortunes evaluated."},
            "next_phase": {
                f"If any player has {win_coins} or more coins":
                    {"id": 99, "name": "Game Over"},
                "Otherwise, the game continues": {"id": 1, "name": "Market Income"},
            },
        },
        99: _ui_phase(
            "Game Over — Richest Trader",
            "Congratulate the richest trader.",
            [
                _tool_action("Clear non-persistent UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Display the winner and final purses", "createResultDisplay"),
            ],
            None,
        ),
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools,
                                "player_states": {"1": {**template, "name": "Alpha"}}},
            "audience_groups": {},
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# minority archetype: simultaneous-reveal odd-one-out scoring (P16)
# ---------------------------------------------------------------------------


def _gen_minority(bp: Blueprint, n_options: int = 3, win_points: int = 5) -> dict[str, Any]:
    fields = {
        "name": {"type": "string", "example": "Player A", "description": "Public display name."},
        "pick_choice": {"type": "num", "example": 1,
                        "description": f"The door (1-{n_options}) this player picked "
                                       "this round; 0 before picking."},
        "points": {"type": "num", "example": 0,
                   "description": f"Cumulative points; first to {win_points} wins."},
    }
    template = {"name": "", "pick_choice": 0, "points": 0}
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay", "createAvatarSet",
             "createVotingPanel", "createResultDisplay", "createScoreBoard", "createTimer"]
    phases = {
        0: _ui_phase(
            "Game Introduction",
            f"Introduce the rules: pick one of {n_options} doors in secret; the "
            "smallest group scores. First to "
            f"{win_points} points wins.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator", "createPhaseIndicator"),
                _tool_action("Display the rules", "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Secret Picks"},
        ),
        1: _action_phase(
            "Secret Picks",
            f"Each player secretly picks one of the {n_options} doors.",
            [
                _tool_action("Clear previous UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Create pick phase indicator", "createPhaseIndicator"),
                _tool_action("Create the door pick panel", "createVotingPanel"),
            ],
            "All players have picked and pick_choice set to the chosen door "
            f"(1-{n_options}).",
            "all_players_action", "All players",
            "player.points >= 0",
            {"id": 2, "name": "The Reveal"},
        ),
        2: _ui_phase(
            "The Reveal",
            "Reveal all picks simultaneously: players in the minority group — "
            "the smallest group of doors — each score 1 point.",
            [
                _tool_action("Clear pick UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Display the reveal results", "createResultDisplay"),
                _tool_action("Update the scoreboard; exempt persistent scoreboard",
                             "createScoreBoard"),
            ],
            {"id": 3, "name": "Check Scores"},
        ),
        3: {
            "name": "Check Scores",
            "description": "Evaluate whether any player reached the target.",
            "actions": [
                _tool_action("Clear results UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Display the leading scores", "createTextDisplay"),
            ],
            "completion_criteria": {"type": "UI_displayed",
                                    "description": "Scores evaluated."},
            "next_phase": {
                f"If any player has {win_points} or more points":
                    {"id": 99, "name": "Game Over"},
                "Otherwise, the game continues": {"id": 1, "name": "Secret Picks"},
            },
        },
        99: _ui_phase(
            "Game Over — Sharpest Contrarian",
            "Congratulate the player who read the crowd best.",
            [
                _tool_action("Clear non-persistent UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Display the winner and final scores", "createResultDisplay"),
            ],
            None,
        ),
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools,
                                "player_states": {"1": {**template, "name": "Alpha"}}},
            "audience_groups": {},
        },
        "phases": phases,
    }


# auction archetype: income + sealed-bid lots (P12/P19)
# ---------------------------------------------------------------------------


def _gen_auction(bp: Blueprint, income: int = 2, bid_max: int = 5,
                 win_lots: int = 3) -> dict[str, Any]:
    fields = {
        "name": {"type": "string", "example": "Player A", "description": "Public display name."},
        "coins": {"type": "num", "example": 0,
                  "description": "Purse of coins used for bidding."},
        "bid_choice": {"type": "num", "example": 1,
                       "description": f"This round's sealed bid (1-{bid_max}); "
                                      "0 before bidding."},
        "points": {"type": "num", "example": 0,
                   "description": f"Lots won at auction; first to {win_lots} "
                                  "points wins."},
    }
    template = {"name": "", "coins": 0, "bid_choice": 0, "points": 0}
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay", "createAvatarSet",
             "createVotingPanel", "createResultDisplay", "createScoreBoard", "createTimer"]
    phases = {
        0: _ui_phase(
            "Game Introduction",
            f"Introduce the rules: collect {income} coins per round, then bid "
            "in secret for the lot; the highest bid wins it and pays. First "
            f"to {win_lots} lots wins.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator", "createPhaseIndicator"),
                _tool_action("Display the rules", "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Market Opens"},
        ),
        1: _ui_phase(
            "Market Opens",
            f"A new lot is presented and each player collects {income} coins.",
            [
                _tool_action("Clear previous UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Create market phase indicator", "createPhaseIndicator"),
                _tool_action("Display the lot on offer", "createTextDisplay"),
            ],
            {"id": 2, "name": "Sealed Bids"},
        ),
        2: _action_phase(
            "Sealed Bids",
            "Each player secretly seals a bid of coins for the lot.",
            [
                _tool_action("Clear previous UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Create bid phase indicator", "createPhaseIndicator"),
                _tool_action("Create the sealed bid panel", "createVotingPanel"),
            ],
            "All players have bid and bid_choice set to the sealed amount "
            f"(1-{bid_max}).",
            "all_players_action", "All players",
            "player.coins >= 0",
            {"id": 3, "name": "Auction Resolution"},
        ),
        3: _ui_phase(
            "Auction Resolution",
            "Open the bids: the highest bidder wins the lot and pays their "
            "bid from their purse (ties go to the lowest player id).",
            [
                _tool_action("Clear bid UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Display the winning bid", "createResultDisplay"),
                _tool_action("Update the scoreboard; exempt persistent scoreboard",
                             "createScoreBoard"),
            ],
            {"id": 4, "name": "Check Lots"},
        ),
        4: {
            "name": "Check Lots",
            "description": "Evaluate whether any player holds enough lots.",
            "actions": [
                _tool_action("Clear results UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Display the standings", "createTextDisplay"),
            ],
            "completion_criteria": {"type": "UI_displayed",
                                    "description": "Standings evaluated."},
            "next_phase": {
                f"If any player has {win_lots} or more points":
                    {"id": 99, "name": "Game Over"},
                "Otherwise, the game continues": {"id": 1, "name": "Market Opens"},
            },
        },
        99: _ui_phase(
            "Game Over — Master of the House",
            "Congratulate the player who won the most lots.",
            [
                _tool_action("Clear non-persistent UI; exempt persistent scoreboard",
                             "clearCanvas"),
                _tool_action("Display the winner and final lots", "createResultDisplay"),
            ],
            None,
        ),
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools,
                                "player_states": {"1": {**template, "name": "Alpha"}}},
            "audience_groups": {},
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# mechanic mixes: compose extra families into a base archetype's phase graph
# ---------------------------------------------------------------------------


def _weave_market(
    doc: dict[str, Any],
    *,
    income_phase_pred: Callable[[str], bool],
    income_sentence: str,
    check_name: str,
    coin_branch_before: Callable[[str], bool],
    raid_edge_pred: Callable[[str], bool],
    raid_desc: str,
    rich_terminal_name: str,
    win_coins: int,
    actor_phrase: str = "All alive players",
    actor_condition: str = "player.is_alive == true",
    panel_for: str = "living players",
    income_hint_gain: Optional[int] = None,
) -> dict[str, Any]:
    """Weave the market family (P12 income, P13 raids, richest-purse
    terminal) into an existing phase graph.

    Adds a `coins` purse field; the income sentence to every phase whose
    name satisfies ``income_phase_pred``; a raid round (TARGET selection +
    simultaneous resolution) spliced into the win-check branch matched by
    ``raid_edge_pred``; and terminal phase 98, reached when any purse hits
    ``win_coins``, won by the richest player (P17 per-terminal winner
    modes — the base archetype's own terminal keeps its rule).

    ``actor_phrase``/``actor_condition`` scope who raids — elimination-
    style bases keep the alive-player default; bases without an
    ``is_alive`` field pass a vacuously-true predicate in the same style
    their own action phases use (e.g. ``player.total_score >= 0``).
    ``income_hint_gain`` declares the income as an explicit P18
    ``{income: {coins: n}}`` hint instead of relying on sentence mining —
    required when the income phase carries a P20 effects program (text
    income mining is disabled on those phases; mechanics.py P12 rule).
    """
    decl = doc["declaration"]
    decl["player_states"]["coins"] = {
        "type": "num", "example": 2,
        "description": f"The player's coin purse; reaching {win_coins} "
                       "coins wins the game outright.",
    }
    decl["player_states_template"]["player_states"]["1"]["coins"] = 2
    for row in decl["players_example"]["player_states"].values():
        row["coins"] = 2
    decl["players_example"]["tools"] = list(decl["players_example"]["tools"]) + [
        "createCoinDisplay", "createScoreBoard",
    ]

    phases = doc["phases"]
    paid = False
    for ph in phases.values():
        if income_phase_pred(ph["name"]):
            ph["description"] += " " + income_sentence
            ph["actions"].append(_tool_action("Show each purse", "createCoinDisplay"))
            if income_hint_gain is not None:
                ph.setdefault("mechanics", []).append(
                    {"income": {"coins": income_hint_gain}})
            paid = True
    assert paid, "no income phase matched"

    W = next(pid for pid, ph in phases.items() if ph["name"] == check_name)
    max_id = max(pid for pid in phases if pid < 98)
    RS, RR = max_id + 1, max_id + 2
    assert RR < 98 and 98 not in phases

    branches = phases[W]["next_phase"]
    raid_return = None
    new_branches: dict[str, Any] = {}
    inserted = False
    for k, v in branches.items():
        if not inserted and coin_branch_before(k):
            new_branches[f"If any player has {win_coins} or more coins"] = {
                "id": 98, "name": rich_terminal_name}
            inserted = True
        if raid_edge_pred(k):
            raid_return = v
            v = {"id": RS, "name": "Raid Selection"}
        new_branches[k] = v
    assert inserted and raid_return is not None
    phases[W]["next_phase"] = new_branches
    phases[W]["description"] += " Also evaluate whether any purse reached the target."

    phases[RS] = _action_phase(
        "Raid Selection",
        raid_desc,
        [
            _tool_action("Clear previous UI; exempt death markers", "clearCanvas"),
            _tool_action("TIER 1 - PUBLIC: Create raid phase indicator",
                         "createPhaseIndicator"),
            _tool_action(f"TIER 2 - GROUP: Create the raid target panel for {panel_for}",
                         "createVotingPanel"),
            _tool_action("Show each purse", "createCoinDisplay"),
        ],
        f"{actor_phrase} have chosen a raid target.",
        "multiple_players_action", actor_phrase,
        actor_condition,
        {"id": RR, "name": "Raid Resolution"},
    )
    phases[RR] = _ui_phase(
        "Raid Resolution",
        "Resolve the raids: each raided player loses coins to their raiders, "
        "one coin per successful raider.",
        [
            _tool_action("Clear raid UI; exempt death markers", "clearCanvas"),
            _tool_action("TIER 1 - PUBLIC: Display the raid results", "createResultDisplay"),
            _tool_action("Show each purse", "createCoinDisplay"),
        ],
        raid_return,
    )
    phases[98] = _ui_phase(
        rich_terminal_name,
        "A fortune is made: congratulate the player with the most coins.",
        [
            _tool_action("Clear non-persistent UI; exempt death markers", "clearCanvas"),
            _tool_action("TIER 1 - PUBLIC: Display the winner and final purses",
                         "createResultDisplay"),
        ],
        None,
    )
    # explicit P18 winner declaration: bases with their own score-like
    # field (e.g. rounds' total_score) would otherwise win this terminal
    # on that field — the "Richest" name matches the generic score rule
    # and generic matches resolve score_like_field first (mechanics.py
    # _terminal_game_over)
    phases[98]["mechanics"] = [{"winner": {"score": "coins"}}]
    return doc


def _mix_elimination_market(doc: dict[str, Any], win_coins: int = 6) -> dict[str, Any]:
    """Elimination + economy: income each morning, raids on the
    night-continue edge, richest-purse terminal (team terminal unchanged)."""
    return _weave_market(
        doc,
        income_phase_pred=lambda name: "Morning" in name,
        income_sentence="Then each alive player collects 1 coin from the village treasury.",
        check_name="Check Win Conditions",
        coin_branch_before=lambda k: k.startswith("If this check follows"),
        raid_edge_pred=lambda k: "night resolution" in k,
        raid_desc="Each alive player chooses one rival to raid before the day's debate.",
        rich_terminal_name="Game Over — Richest Villager",
        win_coins=win_coins,
    )


def _mix_battle_market(doc: dict[str, Any], win_coins: int = 8) -> dict[str, Any]:
    """Battle + economy: bounty income at each vote result, raids before
    each new round, richest-purse terminal (survivor terminal unchanged —
    P17 keeps 'last player standing' survivor-won even though the coins
    field would otherwise flip the P11 default to score mode)."""
    return _weave_market(
        doc,
        income_phase_pred=lambda name: name == "Announce Vote Results",
        income_sentence="Then each alive player collects 1 coin from the bounty chest.",
        check_name="Check Survivors",
        coin_branch_before=lambda k: "continue" in k,
        raid_edge_pred=lambda k: "continue" in k,
        raid_desc="Each alive player chooses one rival to raid before the next round.",
        rich_terminal_name="Game Over — Richest Gladiator",
        win_coins=win_coins,
    )


def _weave_auction(
    doc: dict[str, Any],
    *,
    income_phase_pred: Callable[[str], bool],
    income_sentence: str,
    check_name: str,
    lot_branch_before: Callable[[str], bool],
    bid_edge_pred: Callable[[str], bool],
    bid_desc: str,
    lot_terminal_name: str,
    bid_max: int,
    close_coins: int,
    actor_phrase: str = "All alive players",
    actor_condition: str = "player.is_alive == true",
    panel_for: str = "living players",
    income_hint_gain: Optional[int] = None,
    skip_income: bool = False,
    lots_target: Optional[int] = None,
) -> dict[str, Any]:
    """Weave the auction family (P12 income, P19 sealed-bid lots) into an
    existing phase graph — the auction analogue of ``_weave_market``: a bid
    round (OPTION selection + highest-bid resolution) spliced into the
    branch matched by ``bid_edge_pred``, and terminal 97 reached when any
    purse reaches ``close_coins`` ("the auction house closes"), won by the
    player with the most lots (P17 score mode on `points`). Paying your
    bid is self-balancing — a lot winner's drained purse rarely wins the
    next lot — so a "first to N lots" trigger would be unreachable under
    random play; the purse-close trigger makes both terminals live, and
    rewards spending coins on lots over hoarding.

    STACKING on top of a market weave (``skip_income``/``lots_target``):
    the market family already pays income and already ends a runaway purse
    at ITS coin threshold, so the stacked auction skips its own income
    sentence and triggers terminal 97 on ``lots_target`` points instead —
    a second coins-threshold key would be shadowed by first-match-wins
    (and the market income keeps purses replenished, which makes a lots
    race reachable where the solo auction's was not). The existing coins
    field keeps the market weave's description with a bidding note
    appended."""
    decl = doc["declaration"]
    if "coins" in decl["player_states"]:
        assert skip_income and lots_target is not None, (
            "stacking the auction weave over an existing coins economy "
            "requires skip_income=True and a lots_target terminal")
        decl["player_states"]["coins"]["description"] = (
            decl["player_states"]["coins"]["description"].rstrip()
            + " Bids are paid from this purse.")
    else:
        decl["player_states"]["coins"] = {
            "type": "num", "example": 2,
            "description": "The player's coin purse used for bidding; when any "
                           f"purse reaches {close_coins} the auction house "
                           "closes.",
        }
    decl["player_states"]["bid_choice"] = {
        "type": "num", "example": 1,
        "description": f"This round's sealed bid (1-{bid_max}); 0 before "
                       "bidding.",
    }
    decl["player_states"]["points"] = {
        "type": "num", "example": 0,
        "description": "Lots won at auction (1 point apiece); the biggest "
                       "collector wins when the house closes.",
    }
    tmpl = decl["player_states_template"]["player_states"]["1"]
    tmpl["coins"], tmpl["bid_choice"], tmpl["points"] = 2, 0, 0
    for row in decl["players_example"]["player_states"].values():
        row["coins"], row["bid_choice"], row["points"] = 2, 0, 0
    extra_tools = ["createCoinDisplay", "createScoreBoard"]
    if skip_income:  # stacked over market: those tools are already listed
        extra_tools = [t for t in extra_tools
                       if t not in decl["players_example"]["tools"]]
    decl["players_example"]["tools"] = list(
        decl["players_example"]["tools"]) + extra_tools

    phases = doc["phases"]
    if not skip_income:
        paid = False
        for ph in phases.values():
            if income_phase_pred(ph["name"]):
                ph["description"] += " " + income_sentence
                ph["actions"].append(
                    _tool_action("Show each purse", "createCoinDisplay"))
                if income_hint_gain is not None:
                    ph.setdefault("mechanics", []).append(
                        {"income": {"coins": income_hint_gain}})
                paid = True
        assert paid, "no income phase matched"

    W = next(pid for pid, ph in phases.items() if ph["name"] == check_name)
    max_id = max(pid for pid in phases if pid < 97)
    BS, BR = max_id + 1, max_id + 2
    assert BR < 97 and 97 not in phases

    branches = phases[W]["next_phase"]
    bid_return = None
    new_branches: dict[str, Any] = {}
    inserted = False
    close_key = (f"If any player has {lots_target} or more points"
                 if lots_target is not None
                 else f"If any player has {close_coins} or more coins")
    for k, v in branches.items():
        if not inserted and lot_branch_before(k):
            new_branches[close_key] = {"id": 97, "name": lot_terminal_name}
            inserted = True
        if bid_edge_pred(k):
            bid_return = v
            v = {"id": BS, "name": "Sealed Bids"}
        new_branches[k] = v
    assert inserted and bid_return is not None
    phases[W]["next_phase"] = new_branches
    phases[W]["description"] += (
        " Also evaluate whether the lot race closed the auction house."
        if lots_target is not None else
        " Also evaluate whether any purse closed the auction house.")

    phases[BS] = _action_phase(
        "Sealed Bids",
        bid_desc,
        [
            _tool_action("Clear previous UI; exempt death markers", "clearCanvas"),
            _tool_action("TIER 1 - PUBLIC: Create bid phase indicator",
                         "createPhaseIndicator"),
            _tool_action(f"TIER 2 - GROUP: Create the sealed bid panel for {panel_for}",
                         "createVotingPanel"),
            _tool_action("Show each purse", "createCoinDisplay"),
        ],
        f"{actor_phrase} have bid and bid_choice set to the sealed amount "
        f"(1-{bid_max}).",
        "multiple_players_action", actor_phrase,
        actor_condition,
        {"id": BR, "name": "Auction Resolution"},
    )
    phases[BR] = _ui_phase(
        "Auction Resolution",
        "Open the bids: the highest bidder wins the lot and pays their bid "
        "from their purse (ties go to the lowest player id).",
        [
            _tool_action("Clear bid UI; exempt death markers", "clearCanvas"),
            _tool_action("TIER 1 - PUBLIC: Display the winning bid", "createResultDisplay"),
            _tool_action("Show each purse", "createCoinDisplay"),
        ],
        bid_return,
    )
    phases[97] = _ui_phase(
        lot_terminal_name,
        "The auction house closes: congratulate the player with the most "
        "points from won lots.",
        [
            _tool_action("Clear non-persistent UI; exempt death markers", "clearCanvas"),
            _tool_action("TIER 1 - PUBLIC: Display the winner and final lots",
                         "createResultDisplay"),
        ],
        None,
    )
    # explicit P18 winner declaration (see _weave_market's terminal note)
    phases[97]["mechanics"] = [{"winner": {"score": "points"}}]
    return doc


def _mix_elimination_auction(doc: dict[str, Any], bid_max: int = 5,
                             close_coins: int = 6) -> dict[str, Any]:
    """Elimination + auctions: income each morning, a sealed-bid lot round
    on the night-continue edge, house-closes terminal won by the biggest
    lot collector (team terminal unchanged — P17 keeps the base rule)."""
    return _weave_auction(
        doc,
        income_phase_pred=lambda name: "Morning" in name,
        income_sentence="Then each alive player collects 2 coins from the village treasury.",
        check_name="Check Win Conditions",
        lot_branch_before=lambda k: k.startswith("If this check follows"),
        bid_edge_pred=lambda k: "night resolution" in k,
        bid_desc="Each alive player seals a bid of coins for the dawn lot.",
        lot_terminal_name="Game Over — Master Collector",
        bid_max=bid_max,
        close_coins=close_coins,
    )


def _mix_battle_auction(doc: dict[str, Any], bid_max: int = 5,
                        close_coins: int = 10) -> dict[str, Any]:
    """Battle + auctions: bounty income at each vote result, a sealed-bid
    lot round before each new round, house-closes terminal won by the
    biggest lot collector (survivor terminal unchanged)."""
    return _weave_auction(
        doc,
        income_phase_pred=lambda name: name == "Announce Vote Results",
        income_sentence="Then each alive player collects 2 coins from the bounty chest.",
        check_name="Check Survivors",
        lot_branch_before=lambda k: "continue" in k,
        bid_edge_pred=lambda k: "continue" in k,
        bid_desc="Each alive player seals a bid of coins for the round's lot.",
        lot_terminal_name="Game Over — Master Collector",
        bid_max=bid_max,
        close_coins=close_coins,
    )


def _mix_rounds_market(doc: dict[str, Any], win_coins: int = 8) -> dict[str, Any]:
    """Rounds + economy: the statement-round loop pays 1 coin at every
    round start, a raid round is spliced onto the next-speaker edge, and a
    richest-purse terminal (98) coexists with the base standings terminal
    (P17 — the rounds terminal keeps score mode on total_score; coins is
    not in the default score-field preference list, mechanics.py)."""
    return _weave_market(
        doc,
        income_phase_pred=lambda name: name == "Round Start",
        income_sentence="Then each player collects 1 coin from the story pot.",
        check_name="Check Round Progress",
        coin_branch_before=lambda k: k.startswith("If all players have completed"),
        raid_edge_pred=lambda k: k.startswith("Otherwise"),
        raid_desc="Each player chooses one rival to raid before the next tale.",
        rich_terminal_name="Game Over — Richest Storyteller",
        win_coins=win_coins,
        actor_phrase="All players",
        actor_condition="player.total_score >= 0",
        panel_for="all players",
    )


def _mix_bluff_market(doc: dict[str, Any], win_coins: int = 8) -> dict[str, Any]:
    """Bluff + economy: the court pays 1 coin at every showdown, a raid
    round is spliced onto the court-continues edge, richest-purse terminal
    (98). The base survivor terminal stays survivor-won: bluff's influence
    field is a lives field, which blocks the resource fallback in the P11
    default, and the terminal text pins survivor via P17."""
    return _weave_market(
        doc,
        income_phase_pred=lambda name: name == "Showdown",
        income_sentence="Then each alive player collects 1 coin from the court treasury.",
        check_name="Check the Court",
        coin_branch_before=lambda k: k.startswith("If only one player"),
        raid_edge_pred=lambda k: "the court continues" in k,
        raid_desc="Each alive player chooses one rival to raid before the next declarations.",
        rich_terminal_name="Game Over — Richest Courtier",
        win_coins=win_coins,
    )


def _mix_racing_market(doc: dict[str, Any], win_coins: int = 15) -> dict[str, Any]:
    """Racing + economy: sponsorship income at every movement resolution
    (declared as an explicit P18 income hint — the resolution phase carries
    the P20 movement program, which disables text income mining), a raid
    round spliced onto the race-continues edge, richest-purse terminal
    (98). The base finish-line terminal keeps position mode via its
    explicit winner hint."""
    return _weave_market(
        doc,
        income_phase_pred=lambda name: name == "Movement Resolution",
        income_sentence="Then each racer collects 1 sponsorship coin.",
        check_name="Movement Resolution",
        coin_branch_before=lambda k: "position" in k,
        raid_edge_pred=lambda k: k.startswith("Otherwise"),
        raid_desc="Each racer chooses one rival's pit to raid before the next sprint.",
        rich_terminal_name="Game Over — Richest Racer",
        win_coins=win_coins,
        actor_phrase="All racers",
        actor_condition="player.position >= 0",
        panel_for="all racers",
        income_hint_gain=1,
    )


def _mix_bluff_auction(doc: dict[str, Any], bid_max: int = 4,
                       close_coins: int = 9) -> dict[str, Any]:
    """Bluff + auctions: treasury income at every showdown, a sealed-bid
    lot round on the court-continues edge, house-closes terminal (97) won
    by the biggest lot collector. The prize field `points` becomes the
    court's only score-like field, so both the AuctionScore prize and the
    97 terminal resolve to it; the base survivor terminal is pinned by its
    own text (P17)."""
    return _weave_auction(
        doc,
        income_phase_pred=lambda name: name == "Showdown",
        income_sentence="Then each alive player collects 2 coins from the court treasury.",
        check_name="Check the Court",
        lot_branch_before=lambda k: k.startswith("If only one player"),
        bid_edge_pred=lambda k: "the court continues" in k,
        bid_desc="Each alive player seals a bid of coins for the court's lot.",
        lot_terminal_name="Game Over — Master Collector",
        bid_max=bid_max,
        close_coins=close_coins,
    )


def _mix_elimination_market_auction(doc: dict[str, Any], win_coins: int = 6,
                                    bid_max: int = 2,
                                    lots_target: int = 2) -> dict[str, Any]:
    """STACKED mix: elimination + market + auction on one phase graph —
    morning income, a dawn sealed-bid lot round AND a day raid round each
    cycle, with THREE live terminals (team extinction 99, richest purse 98,
    first-to-N-lots 97). The stacked auction skips its own income (the
    market already pays) and triggers on lots, not a second coins threshold
    (first-match-wins would shadow it; see _weave_auction's stacking
    note)."""
    doc = _mix_elimination_market(doc, win_coins=win_coins)
    # the raid round rides the night-continue edge (from the market weave);
    # the lot round rides the DAY-continue edge — one of each per full
    # cycle. Sharing the night edge would run ~one auction per game (games
    # last 2-3 cycles), leaving the lots terminal unreachable.
    return _weave_auction(
        doc,
        income_phase_pred=lambda name: False,  # unused under skip_income
        income_sentence="",
        check_name="Check Win Conditions",
        lot_branch_before=lambda k: k.startswith("If this check follows"),
        bid_edge_pred=lambda k: "day elimination" in k,
        bid_desc="Each alive player seals a bid of coins for the dusk lot.",
        lot_terminal_name="Game Over — Master Collector",
        bid_max=bid_max,
        close_coins=0,
        skip_income=True,
        lots_target=lots_target,
    )


def _mix_battle_market_auction(doc: dict[str, Any], win_coins: int = 8,
                               bid_max: int = 2,
                               lots_target: int = 2) -> dict[str, Any]:
    """STACKED mix: battle + market + auction — bounty income, a lot round
    and a raid round before each new arena round; terminals: last survivor
    99, richest 98, first-to-N-lots 97."""
    doc = _mix_battle_market(doc, win_coins=win_coins)
    return _weave_auction(
        doc,
        income_phase_pred=lambda name: False,
        income_sentence="",
        check_name="Check Survivors",
        lot_branch_before=lambda k: "continue" in k,
        bid_edge_pred=lambda k: "continue" in k,
        bid_desc="Each alive player seals a bid of coins for the round's lot.",
        lot_terminal_name="Game Over — Master Collector",
        bid_max=bid_max,
        close_coins=0,
        skip_income=True,
        lots_target=lots_target,
    )


_MIXERS: dict[tuple[str, str], Callable[[dict], dict]] = {
    ("elimination", "market"): _mix_elimination_market,
    ("battle", "market"): _mix_battle_market,
    ("elimination", "auction"): _mix_elimination_auction,
    ("battle", "auction"): _mix_battle_auction,
    ("rounds", "market"): _mix_rounds_market,
    ("bluff", "market"): _mix_bluff_market,
    ("racing", "market"): _mix_racing_market,
    ("bluff", "auction"): _mix_bluff_auction,
}

# two-extra STACKS: applied as one canonical composition (market inside,
# auction on top) regardless of the blueprint's extras order
_STACKS: dict[tuple[str, frozenset], Callable[[dict], dict]] = {
    ("elimination", frozenset({"market", "auction"})):
        _mix_elimination_market_auction,
    ("battle", frozenset({"market", "auction"})):
        _mix_battle_market_auction,
}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def annotate_mechanics(doc: dict[str, Any]) -> dict[str, Any]:
    """Write P18 `mechanics:` hints mirroring the analyzer's attachment back
    into a generated doc (in place; returns it for chaining).

    Generated games are co-designed with the keyword detector, so detection
    already succeeds — the hints make the semantics EXPLICIT in the
    artifact: self-documenting YAML, robust to future vocabulary drift, and
    validator-enforced (every emitted hint must re-attach, SEMANTICS.md
    P18). The reference has no analogue; its referee re-reads the prose
    every turn (agent/prompt/referee_system_prompt_1.txt)."""
    from game_engine_tpu_torch.gamespec import mechanics as M
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import parse_game_spec

    game = compile_game(parse_game_spec(doc, name="annotate"))
    kills: set[int] = set()
    protects: set[int] = set()
    for cp in game.phases:
        for m in cp.program.on_enter:
            if isinstance(m, M.NightResolve):
                kills |= set(m.kill_phases)
                protects |= set(m.protect_phases)

    for cp in game.phases:
        # phase keys may be ints (the blueprint path) or strings (LLM
        # completions commonly quote them; the parser coerces either)
        ph = doc["phases"].get(cp.dsl_id)
        if ph is None:
            ph = doc["phases"].get(str(cp.dsl_id))
        if ph is None:
            continue
        hints: list[Any] = []
        rec = cp.program.record
        if rec.choice_kind is M.ChoiceKind.TARGET:
            hints.append("target")
        elif rec.choice_kind is M.ChoiceKind.OPTION:
            hints.append({"option": rec.choice_max} if rec.choice_max > 0
                         else "option")
        elif rec.choice_kind is M.ChoiceKind.SUBMIT:
            hints.append("submit")
        if cp.dsl_id in kills:
            hints.append("kill")
        if cp.dsl_id in protects:
            hints.append("protect")
        for m in cp.program.on_enter:
            if isinstance(m, M.RoleAssign):
                hints.append("role_assignment")
            elif isinstance(m, M.NightResolve):
                hints.append("night_resolution")
            elif isinstance(m, M.VoteElim):
                hints.append("vote_elimination")
            elif isinstance(m, M.SpeakerRotate):
                hints.append("speaker_rotation")
            elif isinstance(m, M.BluffChallenge):
                hints.append("bluff_challenge")
            elif isinstance(m, M.MinorityScore):
                hints.append("minority_score")
            elif isinstance(m, M.AuctionScore):
                hints.append("auction")
            elif isinstance(m, M.ResourceRaid):
                hints.append("raid")
            elif isinstance(m, M.ResourceIncome):
                hints.append({"income": {f: n for f, n in m.gains}})
            elif isinstance(m, M.GuessScore):
                hints.append("guess_score")
            elif isinstance(m, M.SetBoolAll):
                hints.extend({"reveal": f} for f in m.fields)
            elif isinstance(m, M.GameOver):
                if m.mode == "score":
                    hints.append({"winner": {"score": m.score_field}})
                elif m.mode == "survivor":
                    hints.append({"winner": "survivor"})
                elif m.mode == "team":
                    hints.append({"winner": "team"})
        # declared effect programs (P20) have no detection counterpart to
        # mirror — carry them over verbatim rather than dropping them
        existing = ph.get("mechanics") or []
        for e in (existing if isinstance(existing, list) else [existing]):
            if isinstance(e, dict) and "effects" in e:
                hints.append(e)
        if hints:
            ph["mechanics"] = hints
    return doc


def generate(bp: Blueprint) -> dict[str, Any]:
    extras = tuple(bp.extras)
    if len(set(extras)) != len(extras):
        raise ValueError(f"duplicate extras {extras!r}")
    doc = _generate_base(bp)
    if len(extras) >= 2:
        # two extras compose only through a registered STACK (one canonical
        # composition per base) — naive sequential weaving can silently
        # collide (equal coin-threshold branch keys drop a terminal edge by
        # dict assignment; double income breaks both balances), so
        # unregistered combinations are rejected loudly rather than
        # emitting a game with an unreachable terminal
        stack = _STACKS.get((bp.archetype, frozenset(extras)))
        if stack is None:
            raise ValueError(
                f"no stacked mix for archetype {bp.archetype!r} + extras "
                f"{extras!r} (registered: "
                f"{sorted((b, tuple(sorted(e))) for b, e in _STACKS)})")
        doc = stack(doc)
    elif extras:
        mixer = _MIXERS.get((bp.archetype, extras[0]))
        if mixer is None:
            raise ValueError(
                f"no mixer for archetype {bp.archetype!r} + extra "
                f"{extras[0]!r}")
        doc = mixer(doc)
    return annotate_mechanics(doc)


def _generate_base(bp: Blueprint) -> dict[str, Any]:
    if bp.archetype == "elimination":
        return _gen_elimination(bp)
    if bp.archetype == "rounds":
        return _gen_rounds(bp)
    if bp.archetype == "battle":
        return _gen_battle(bp)
    if bp.archetype == "bluff":
        return _gen_bluff(_mine_bluff_roles(bp))
    # archetypes with a declared victory threshold honor a "first to N"
    # in the description (digit or number word, _mine_first_to) — a
    # described "first to twenty coins" must not generate a 10-coin game
    if bp.archetype == "market":
        return _gen_market(
            bp, win_coins=_mine_first_to(bp.description, 10),
            income=_mine_income(bp.description, 1))
    if bp.archetype == "auction":
        return _gen_auction(bp, win_lots=_mine_first_to(bp.description, 3))
    if bp.archetype == "minority":
        return _gen_minority(
            bp, n_options=_mine_count(bp.description,
                                      r"doors?|options?|choices?|paths?",
                                      3, 2, 6),
            win_points=_mine_first_to(bp.description, 5))
    if bp.archetype == "conversion":
        return _gen_conversion(bp, max_rounds=_mine_rounds(bp.description, 12))
    if bp.archetype == "pressluck":
        return _gen_pressluck(
            bp, win_points=_mine_first_to(bp.description, 10),
            bust_limit=_mine_bust_limit(bp.description, 5),
            max_rounds=_mine_rounds(bp.description, 60))
    if bp.archetype == "racing":
        return _gen_racing(bp, track_len=_mine_first_to(bp.description, 10),
                           max_rounds=_mine_rounds(bp.description, 40))
    if bp.archetype == "masquerade":
        return _gen_masquerade(
            bp, mask_names=_mine_mask_names(bp.description),
            win_coins=_mine_first_to(bp.description, 12),
            max_rounds=_mine_rounds(bp.description, 40))
    if bp.archetype == "draft":
        return _gen_draft(
            bp, pool=_mine_count(bp.description,
                                 r"prizes?|relics?|items?|cards?|treasures?|lots?",
                                 6, 3, 10),
            max_rounds=_mine_rounds(bp.description, 5))
    if bp.archetype == "gifting":
        return _gen_gifting(bp, win_coins=_mine_first_to(bp.description, 12),
                            max_rounds=_mine_rounds(bp.description, 30))
    raise ValueError(f"unknown archetype {bp.archetype!r}")




# ---------------------------------------------------------------------------
# gifting archetype: player-to-player transfers through the P20 effect IR —
# the first generator family whose resolution is a declared effects program
# (no closed mechanic library entry exists for transfers)
# ---------------------------------------------------------------------------


def _gen_gifting(bp: Blueprint, win_coins: int = 12, start_coins: int = 3,
                 bonus: int = 2, max_rounds: int = 30) -> dict[str, Any]:
    fields = {
        "name": {"type": "string", "example": "Player A",
                 "description": "Public display name."},
        "coins": {"type": "num", "example": start_coins,
                  "description": f"The player's coin purse; reaching "
                                 f"{win_coins} coins wins."},
        "gifts_received": {"type": "num", "example": 0,
                           "description": "Total gifts received (public ledger)."},
        "rounds": {"type": "num", "example": 0,
                   "description": f"Completed gifting rounds (caps at {max_rounds})."},
    }
    template = {"name": "", "coins": start_coins, "gifts_received": 0,
                "rounds": 0}
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay",
             "createAvatarSet", "createVotingPanel", "createResultDisplay",
             "createCoinDisplay", "createScoreBoard"]
    phases = {
        0: _ui_phase(
            "Game Introduction",
            "Introduce the gifting circle, the popularity bonus, and the "
            f"{win_coins}-coin victory target.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator", "createPhaseIndicator"),
                _tool_action("Display rules and win conditions", "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Gift Selection"},
        ),
        1: _action_phase(
            "Gift Selection",
            "Every player secretly chooses one other player to gift a coin to.",
            [
                _tool_action("Clear previous UI", "clearCanvas"),
                _tool_action("Create gifting phase indicator", "createPhaseIndicator"),
                _tool_action("Create the gift target panel", "createVotingPanel"),
                _tool_action("Show each purse", "createCoinDisplay"),
            ],
            "All players have chosen a gift recipient.",
            "all_players_action", "All players",
            "player.coins >= 0",
            {"id": 2, "name": "Gift Exchange"},
        ),
        2: {
            "name": "Gift Exchange",
            "description": "Resolve the gifting: every giver with a coin "
                           "hands one to their chosen player, the most-gifted "
                           "player collects a popularity bonus from the bank, "
                           "and the round is tallied.",
            "actions": [
                _tool_action("Clear gifting UI", "clearCanvas"),
                _tool_action("Display who gifted whom and the bonus",
                             "createResultDisplay"),
                _tool_action("Show each purse", "createCoinDisplay"),
                _tool_action("Show the gifts-received ledger", "createScoreBoard"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "Gift Exchange has been displayed to all players.",
            },
            "next_phase": {
                f"If any player has {win_coins} or more coins":
                    {"id": 99, "name": "Game Over"},
                f"If any player has {max_rounds} or more rounds":
                    {"id": 99, "name": "Game Over"},
                "Otherwise the circle continues":
                    {"id": 1, "name": "Gift Selection"},
            },
            "mechanics": [{"effects": [
                "let giver = chose(1) and coins > 0 and choice != seat",
                "let got = incoming(1, choice, giver)",
                "let top = argmax(got, got > 0)",
                f"coins += got - if(giver, 1, 0) + if(seat == top, {bonus}, 0)",
                "gifts_received += got",
                "rounds += 1 where seat == 1",
            ]}],
        },
        99: _ui_phase(
            "Game Over — Richest Purse",
            "Congratulate the richest player in the circle.",
            [
                _tool_action("Clear non-persistent UI", "clearCanvas"),
                _tool_action("Display the winner and final purses",
                             "createResultDisplay"),
            ],
            None,
        ),
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools,
                                "player_states": {"1": {**template, "name": "Alpha"}}},
            "audience_groups": {},
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# conversion archetype: hidden-team recruitment through the P20 effect IR's
# string-write surface (team flips are vocab-coded SSet statements — the
# mechanic family that was inexpressible before round 4's general writes;
# the reference referee performs these as free update_player_state writes,
# agent/tools/backend_tools.py:204-225)
# ---------------------------------------------------------------------------


def _gen_conversion(bp: Blueprint, max_rounds: int = 12) -> dict[str, Any]:
    leader = next((r for r in bp.roles if r.night_action == "convert"), None)
    filler = next((r for r in bp.roles if not r.night_action), None)
    leader_name = leader.name if leader else "Prophet"
    filler_name = filler.name if filler else "Villager"
    fields = {
        "name": {"type": "string", "example": "Player A",
                 "description": "Public display name."},
        "role": {"type": "string", "example": leader_name,
                 "description": f"Hidden origin ({leader_name} or "
                                f"{filler_name}). Conversion changes team, "
                                "never role."},
        "team": {"type": "string", "example": "cult",
                 "description": "Current allegiance ('cult' or 'free'); "
                                "conversion flips free to cult."},
        "is_alive": {"type": "boolean", "example": True,
                     "description": "Whether the player is still in the game."},
        "role_revealed": {"type": "boolean", "example": False,
                          "description": "Whether this player's origin has "
                                         "been shown to all."},
        "rounds": {"type": "num", "example": 0,
                   "description": f"Completed night cycles (caps at "
                                  f"{max_rounds}, tracked on seat 1)."},
        "marks": {"type": "dict", "example": {"3": "claimed"},
                  "description": "The cult's private memory of whom each "
                                 "member has claimed."},
    }
    # template team defaults to 'free' (role assignment overwrites it per
    # role) so BOTH team literals survive vocabulary mining even when a
    # degraded doc ships without players_example ('cult' rides the field
    # example) — the conversion program's writes/compares must stay valid
    template = {"name": "", "role": "", "team": "free", "is_alive": True,
                "role_revealed": False, "rounds": 0, "marks": {}}

    def example_row(name, role, team):
        return {**template, "name": name, "role": role, "team": team}

    names = ["Alpha", "Beta", "Gamma", "Delta", "Echo", "Foxtrot", "Golf",
             "Hotel"]
    players_example = {
        "1": example_row(names[0], leader_name, "cult"),
        **{str(i + 2): example_row(nm, filler_name, "free")
           for i, nm in enumerate(names[1:])},
    }
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay",
             "createAvatarSet", "createVotingPanel", "createResultDisplay",
             "createTimer", "createRoleCard", "createNightOverlay",
             "markPlayerDead", "createScoreBoard"]
    phases = {
        0: _ui_phase(
            "Game Introduction",
            f"Introduce the hidden {leader_name.lower()}, the nightly "
            "conversion, and the day banishments.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator",
                             "createPhaseIndicator"),
                _tool_action("Display rules and win conditions",
                             "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Initiation"},
        ),
        1: {
            "name": "Initiation",
            "description": f"Deal the hidden origins: one {leader_name} "
                           f"begins the cult; every other player starts a "
                           f"free {filler_name}.",
            "mechanics": ["role_assignment"],
            "actions": [
                _tool_action("Clear the canvas", "clearCanvas"),
                _tool_action("TIER 3 - INDIVIDUAL: show each player their "
                             "private origin", "createRoleCard"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "Origins dealt.",
            },
            "next_phase": {"id": 2, "name": "Night Whisper"},
        },
        2: _action_phase(
            "Night Whisper",
            "The cult gathers in the dark; each living cult member whispers "
            "to one player they would claim.",
            [
                _tool_action("Clear the canvas, keep death markers",
                             "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: night indicator",
                             "createPhaseIndicator", "createNightOverlay"),
                _tool_action("TIER 2 - GROUP: private claiming panel for "
                             "the cult", "createVotingPanel"),
            ],
            "Every living cult member has whispered.",
            "multiple_players_action", "All living cult members",
            "player.team == 'cult' and player.is_alive == true",
            {"id": 3, "name": "Dawn"},
        ) | {"mechanics": ["target"]},
        3: {
            "name": "Dawn",
            "description": "Morning breaks; any player claimed by the cult "
                           "in the night quietly joins it.",
            "actions": [
                _tool_action("Clear the canvas, keep death markers",
                             "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: morning breaks with no "
                             "visible change", "createTextDisplay"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "Morning breaks.",
            },
            "next_phase": {"id": 4, "name": "Day Counsel"},
            "mechanics": [{"effects": [
                "let recruiter = chose(2) and team == 'cult' and alive and choice != seat",
                "let claimed = incoming(1, choice, recruiter) > 0",
                "marks[choice] = 'claimed' where recruiter",
                "team = 'cult' where team == 'free' and alive and claimed",
                "rounds += 1 where seat == 1",
            ]}],
        },
        4: _timer_phase(
            "Day Counsel",
            "The players gather and trade suspicions.",
            [
                _tool_action("Clear the canvas, keep death markers",
                             "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: counsel prompt",
                             "createTextDisplay", "createTimer"),
            ],
            {"id": 5, "name": "Accusation"},
        ),
        5: _action_phase(
            "Accusation",
            "Each living player points at the one they would banish.",
            [
                _tool_action("Clear the canvas, keep death markers",
                             "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: pointing panel for all "
                             "living players", "createVotingPanel"),
            ],
            "Every living player has pointed.",
            "all_players_action", "All living players",
            "player.is_alive == true",
            {"id": 6, "name": "Banishment"},
        ) | {"mechanics": ["target"]},
        6: {
            "name": "Banishment",
            "description": "The player most accused is banished and their "
                           "origin is shown to all.",
            "mechanics": ["vote_elimination"],
            "actions": [
                _tool_action("Clear the canvas, keep death markers",
                             "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: announce the banishment",
                             "createResultDisplay", "markPlayerDead"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "The banishment is shown.",
            },
            "next_phase": {"id": 7, "name": "Reckoning"},
        },
        7: {
            "name": "Reckoning",
            "description": "Count the living allegiances to learn whether "
                           "the cult has prevailed.",
            "actions": [
                _tool_action("Clear the canvas, keep death markers",
                             "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: brief reckoning display",
                             "createTextDisplay"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "Reckoning read; the route is set.",
            },
            "next_phase": {
                "If no living cult remain (the cult is broken), the game ends.":
                    {"id": 99, "name": "Game Over"},
                "If no living free remain (every player claimed), the game ends.":
                    {"id": 99, "name": "Game Over"},
                f"If any player has {max_rounds} or more rounds":
                    {"id": 99, "name": "Game Over"},
                "Otherwise, the cult calls another night.":
                    {"id": 2, "name": "Night Whisper"},
            },
        },
        99: {
            "name": "Game Over",
            "description": "The prevailing allegiance is named.",
            "mechanics": [{"winner": "team"}],
            "actions": [
                _tool_action("Clear the canvas, keep death markers",
                             "clearCanvas"),
                _tool_action("TIER 1 - PUBLIC: name the prevailing "
                             "allegiance", "createResultDisplay",
                             "createScoreBoard"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "The tale ends.",
            },
            "next_phase": None,
        },
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 5),
            "roles": [
                {"name": leader_name,
                 "description": "Begins the cult; whispers to one player "
                                "each night to convert them."},
                {"name": filler_name,
                 "description": "Starts free; votes by day and may be "
                                "converted by night."},
            ],
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools,
                                "player_states": players_example},
            "audience_groups": {
                # the group predicate must carry liveness: branch sentences
                # naming the group ("no living cult remain") resolve to this
                # criteria, and a banished cultist must not keep the
                # cult-broken terminal false forever
                "cult": {
                    "description": "The cult's private circle.",
                    "selection_criteria":
                        "player.team == 'cult' and player.is_alive == true",
                },
            },
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# pressluck archetype: press-your-luck banking through the P20 effect IR's
# conditional `reset` statement — the bust rule restores the stash to its
# template default when the round's growth would cross the limit (same
# block, later write wins — P20 statement order over snapshot reads)
# ---------------------------------------------------------------------------


def _gen_pressluck(bp: Blueprint, win_points: int = 10, bust_limit: int = 5,
                   max_rounds: int = 60) -> dict[str, Any]:
    fields = {
        "name": {"type": "string", "example": "Player A",
                 "description": "Public display name."},
        "points": {"type": "num", "example": 0,
                   "description": f"Banked points; {win_points} wins the game."},
        "stash": {"type": "num", "example": 0,
                  "description": f"Unbanked points at risk; swept to 0 past "
                                 f"{bust_limit}."},
        "pick": {"type": "num", "example": 0,
                 "description": "This round's choice (1-2 press on, 3 bank), "
                                "0 when unset."},
        "rounds": {"type": "num", "example": 0,
                   "description": f"Completed rounds (the game caps at "
                                  f"{max_rounds})."},
    }
    template = {"name": "", "points": 0, "stash": 0, "pick": 0, "rounds": 0}
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay",
             "createAvatarSet", "createVotingPanel", "createResultDisplay",
             "createScoreBoard"]
    phases = {
        0: _ui_phase(
            "Game Introduction",
            f"Introduce the press-your-luck run: grow a risky stash, bank "
            f"it before busting past {bust_limit}, first to {win_points} "
            "banked points wins.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator",
                             "createPhaseIndicator"),
                _tool_action("Display rules and win conditions",
                             "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Risk Choice"},
        ),
        1: _action_phase(
            "Risk Choice",
            "Every player secretly picks risk 1 or 2 to press on, or 3 to "
            "bank the stash.",
            [
                _tool_action("Clear previous UI", "clearCanvas"),
                _tool_action("Create risk choice phase indicator",
                             "createPhaseIndicator"),
                _tool_action("Create the risk pick panel (options 1-3) for "
                             "every player", "createVotingPanel"),
            ],
            "All players have picked and pick set for each.",
            "all_players_action", "All players",
            "player.points >= 0",
            {"id": 2, "name": "Bust Resolution"},
        ) | {"mechanics": [{"option": 3}]},
        2: {
            "name": "Bust Resolution",
            "description": "Resolve the round: stashes grow by the risk "
                           "taken, bankers convert the stash to points, and "
                           f"any stash grown past {bust_limit} busts to "
                           "nothing.",
            "actions": [
                _tool_action("Clear pick UI", "clearCanvas"),
                _tool_action("Display who banked, who pressed and who "
                             "busted", "createResultDisplay"),
                _tool_action("Show the standings", "createScoreBoard"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "Bust Resolution has been displayed to all "
                               "players.",
            },
            "next_phase": {
                f"If any player has {win_points} or more points":
                    {"id": 99, "name": "Game Over"},
                f"If any player has {max_rounds} or more rounds":
                    {"id": 99, "name": "Game Over"},
                "Otherwise the run continues":
                    {"id": 1, "name": "Risk Choice"},
            },
            "mechanics": [{"effects": [
                "let presser = chose(1) and pick > 0",
                "stash += pick where presser and pick <= 2",
                "points += stash where presser and pick == 3",
                "reset stash where presser and pick == 3",
                f"reset stash where presser and pick <= 2 and "
                f"stash + pick > {bust_limit}",
                "pick = 0",
                "rounds += 1 where seat == 1",
            ]}],
        },
        99: _ui_phase(
            "Game Over — Champion",
            "Congratulate the player with the most banked points.",
            [
                _tool_action("Clear non-persistent UI", "clearCanvas"),
                _tool_action("Display the winner and final points",
                             "createResultDisplay"),
            ],
            None,
        ) | {"mechanics": [{"winner": {"score": "points"}}]},
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools,
                                "player_states": {"1": {**template,
                                                        "name": "Alpha"}}},
            "audience_groups": {},
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# racing archetype: positional race through the P20 effect IR's eqcount
# collision rule — a racer advances only when nobody matched their speed
# ---------------------------------------------------------------------------


def _gen_racing(bp: Blueprint, track_len: int = 10,
                max_rounds: int = 40) -> dict[str, Any]:
    fields = {
        "name": {"type": "string", "example": "Player A",
                 "description": "Public display name."},
        "position": {"type": "num", "example": 0,
                     "description": f"Track position; {track_len} finishes "
                                    "the race."},
        "speed_pick": {"type": "num", "example": 0,
                       "description": "This round's secret speed (1-3), 0 "
                                      "when unset."},
        "rounds": {"type": "num", "example": 0,
                   "description": f"Completed racing rounds (caps at "
                                  f"{max_rounds})."},
    }
    template = {"name": "", "position": 0, "speed_pick": 0, "rounds": 0}
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay",
             "createAvatarSet", "createVotingPanel", "createResultDisplay",
             "createScoreBoard"]
    phases = {
        0: _ui_phase(
            "Game Introduction",
            f"Introduce the race: secret speeds, collisions on matched "
            f"picks, first to {track_len} wins.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator",
                             "createPhaseIndicator"),
                _tool_action("Display rules and win conditions",
                             "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Speed Selection"},
        ),
        1: _action_phase(
            "Speed Selection",
            "Every racer secretly picks a speed between 1 and 3 for this "
            "round.",
            [
                _tool_action("Clear previous UI", "clearCanvas"),
                _tool_action("Create speed selection phase indicator",
                             "createPhaseIndicator"),
                _tool_action("Create the speed pick panel (options 1-3) for "
                             "every racer", "createVotingPanel"),
            ],
            "All racers have picked and speed_pick set for each.",
            "all_players_action", "All racers",
            "player.position >= 0",
            {"id": 2, "name": "Movement Resolution"},
        ) | {"mechanics": [{"option": 3}]},
        2: {
            "name": "Movement Resolution",
            "description": "Resolve the round: every racer whose speed was "
                           "unique advances that many spaces; racers who "
                           "matched speeds collide and stay put.",
            "actions": [
                _tool_action("Clear pick UI", "clearCanvas"),
                _tool_action("Display who advanced and who collided",
                             "createResultDisplay"),
                _tool_action("Show the track standings", "createScoreBoard"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "Movement Resolution has been displayed to "
                               "all players.",
            },
            "next_phase": {
                f"If any player has {track_len} or more position":
                    {"id": 99, "name": "Game Over"},
                f"If any player has {max_rounds} or more rounds":
                    {"id": 99, "name": "Game Over"},
                "Otherwise the race continues":
                    {"id": 1, "name": "Speed Selection"},
            },
            "mechanics": [{"effects": [
                "let racer = chose(1) and speed_pick > 0",
                "position += speed_pick where racer and "
                "eqcount(speed_pick, racer) == 1",
                "speed_pick = 0",
                "rounds += 1 where seat == 1",
            ]}],
        },
        99: _ui_phase(
            "Game Over — Fastest Racer",
            "Congratulate the racer furthest along the track.",
            [
                _tool_action("Clear non-persistent UI", "clearCanvas"),
                _tool_action("Display the winner and final positions",
                             "createResultDisplay"),
            ],
            None,
        ) | {"mechanics": [{"winner": {"score": "position"}}]},
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools,
                                "player_states": {"1": {**template,
                                                        "name": "Alpha"}}},
            "audience_groups": {},
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# draft archetype: simultaneous exclusive claims from a shared shrinking
# pool through the P20 effect IR — rank(choice)==0 against the block-entry
# snapshot (lowest contested seat wins, the P6 tie convention)
# ---------------------------------------------------------------------------


def _gen_draft(bp: Blueprint, pool: int = 6,
               max_rounds: int = 5) -> dict[str, Any]:
    fields = {
        "name": {"type": "string", "example": "Player A",
                 "description": "Public display name."},
        **{f"has{i}": {"type": "boolean", "example": False,
                       "description": f"Holds prize {i} (worth {i} gold)."}
           for i in range(1, pool + 1)},
        "gold": {"type": "num", "example": 0,
                 "description": "Total value of the claimed prizes."},
        "pool_left": {"type": "num", "example": pool,
                      "description": "Prizes still unclaimed on the table."},
        "rounds": {"type": "num", "example": 0,
                   "description": f"Completed draft rounds (caps at "
                                  f"{max_rounds})."},
    }
    template = {"name": "", **{f"has{i}": False for i in range(1, pool + 1)},
                "gold": 0, "pool_left": pool, "rounds": 0}
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay",
             "createAvatarSet", "createVotingPanel", "createResultDisplay",
             "createScoreBoard"]
    claim_stmts = [
        f"has{i} = 1 where picker and choice == {i} and count(has{i}) == 0 "
        f"and rank(choice, picker) == 0" for i in range(1, pool + 1)]
    gold_expr = " + ".join(
        f"{i} * has{i}" if i > 1 else "has1" for i in range(1, pool + 1))
    pool_expr = f"{pool} - " + " - ".join(
        f"count(has{i})" for i in range(1, pool + 1))
    phases = {
        0: _ui_phase(
            "Game Introduction",
            f"Introduce the draft: {pool} prizes on the table, simultaneous "
            "secret claims, contested prizes go to the lowest seat.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator",
                             "createPhaseIndicator"),
                _tool_action("Display rules and win conditions",
                             "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Prize Pick"},
        ),
        1: _action_phase(
            "Prize Pick",
            f"Every collector secretly points at one of the {pool} prizes.",
            [
                _tool_action("Clear previous UI", "clearCanvas"),
                _tool_action("Create draft phase indicator",
                             "createPhaseIndicator"),
                _tool_action(f"Create the prize pick panel (options 1-{pool})"
                             " for every collector", "createVotingPanel"),
            ],
            "All collectors have pointed at a prize.",
            "all_players_action", "All collectors",
            "player.gold >= 0",
            {"id": 2, "name": "Claim Resolution"},
        ) | {"mechanics": [{"option": pool}]},
        2: {
            "name": "Claim Resolution",
            "description": "Resolve the claims: each unclaimed prize goes "
                           "to the lowest-seated collector pointing at it, "
                           "collections are revalued, and the table is "
                           "recounted.",
            "actions": [
                _tool_action("Clear pick UI", "clearCanvas"),
                _tool_action("Display who claimed what",
                             "createResultDisplay"),
                _tool_action("Show the collection values",
                             "createScoreBoard"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "Claim Resolution has been displayed to all "
                               "players.",
            },
            "next_phase": {
                "If any player has 0 or fewer pool_left":
                    {"id": 99, "name": "Game Over"},
                f"If any player has {max_rounds} or more rounds":
                    {"id": 99, "name": "Game Over"},
                "Otherwise the draft continues":
                    {"id": 1, "name": "Prize Pick"},
            },
            "mechanics": [{"effects": [
                "let picker = chose(1)",
                *claim_stmts,
                "---",
                f"gold = {gold_expr}",
                f"pool_left = {pool_expr}",
                "rounds += 1 where seat == 1",
            ]}],
        },
        99: _ui_phase(
            "Game Over — Richest Collection",
            "Congratulate the collector with the most valuable prizes.",
            [
                _tool_action("Clear non-persistent UI", "clearCanvas"),
                _tool_action("Display the winner and final collections",
                             "createResultDisplay"),
            ],
            None,
        ) | {"mechanics": [{"winner": {"score": "gold"}}]},
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 3),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {"tools": tools,
                                "player_states": {"1": {**template,
                                                        "name": "Alpha"}}},
            "audience_groups": {},
        },
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# masquerade archetype: identity rotation through the P20 effect IR's `deal`
# statement — a fresh mask permutation lands EVERY round (`deal mask salt
# rounds`), the mid-game re-deal the retired bespoke role-assign kernel
# could never express (round 4; catalog witness games/masquerade-gala.yaml)
# ---------------------------------------------------------------------------


def _gen_masquerade(bp: Blueprint,
                    mask_names: tuple[str, ...] = ("Fox", "Owl", "Crane"),
                    win_coins: int = 12,
                    max_rounds: int = 40) -> dict[str, Any]:
    rare, common, trap = mask_names[0], mask_names[1], mask_names[2]
    fields = {
        "name": {"type": "string", "example": "Player A",
                 "description": "Public display name."},
        "coins": {"type": "num", "example": 0,
                  "description": f"Coins earned; {win_coins} wins the game."},
        "mask": {"type": "string", "example": rare,
                 "description": f"The mask dealt this round ({rare}, "
                                f"{common} or {trap})."},
        "toast_pick": {"type": "num", "example": 0,
                       "description": "This round's choice (1 sip, 2 toast), "
                                      "0 when unset."},
        "rounds": {"type": "num", "example": 0,
                   "description": f"Completed rounds (the game caps at "
                                  f"{max_rounds})."},
    }
    template = {"name": "", "coins": 0, "mask": "", "toast_pick": 0,
                "rounds": 0}
    tools = ["clearCanvas", "createPhaseIndicator", "createTextDisplay",
             "createAvatarSet", "createVotingPanel", "createResultDisplay",
             "createScoreBoard"]
    # the example rows ARE the deal multiset (one rare, one trap, commons
    # fill — resolve_deals reads counts + most-common filler from here)
    example_masks = (rare, common, trap, common)
    example_names = ("Alpha", "Beta", "Gamma", "Delta")
    phases = {
        0: _ui_phase(
            "Game Introduction",
            f"Introduce the masquerade: a fresh mask is dealt every round, "
            f"and the race is to {win_coins} coins.",
            [
                _tool_action("Clear all previous UI elements", "clearCanvas"),
                _tool_action("Create public phase indicator",
                             "createPhaseIndicator"),
                _tool_action("Display rules and win conditions",
                             "createTextDisplay"),
                _tool_action("Create avatar set overlay", "createAvatarSet"),
            ],
            {"id": 1, "name": "Toast Choice"},
        ),
        1: _action_phase(
            "Toast Choice",
            "Every guest secretly picks 1 to sip quietly or 2 to make a "
            "bold toast.",
            [
                _tool_action("Clear previous UI", "clearCanvas"),
                _tool_action("Create toast choice phase indicator",
                             "createPhaseIndicator"),
                _tool_action("Create the toast pick panel (options 1-2) for "
                             "every guest", "createVotingPanel"),
            ],
            "All guests have picked and toast_pick set for each.",
            "all_players_action", "All guests",
            "player.coins >= 0",
            {"id": 2, "name": "Masked Reveal"},
        ) | {"mechanics": [{"option": 2}]},
        2: {
            "name": "Masked Reveal",
            "description": "Resolve the round: deal every guest a fresh "
                           f"mask, then quiet sippers earn 1 coin unless the "
                           f"{trap} mask found them and bold toasters earn 3 "
                           f"coins while wearing the {rare} mask.",
            "actions": [
                _tool_action("Clear pick UI", "clearCanvas"),
                _tool_action("Display the dealt masks and who earned coins",
                             "createResultDisplay"),
                _tool_action("Show the coin standings", "createScoreBoard"),
            ],
            "completion_criteria": {
                "type": "UI_displayed",
                "description": "Masked Reveal has been displayed to all "
                               "players.",
            },
            "next_phase": {
                f"If any player has {win_coins} or more coins":
                    {"id": 99, "name": "Game Over"},
                f"If any player has {max_rounds} or more rounds":
                    {"id": 99, "name": "Game Over"},
                "Otherwise the masquerade goes on":
                    {"id": 1, "name": "Toast Choice"},
            },
            "mechanics": [{"effects": [
                "deal mask salt rounds",
                "---",
                "coins += 1 where chose(1) and toast_pick == 1 and "
                f"mask != '{trap}'",
                "coins += 3 where chose(1) and toast_pick == 2 and "
                f"mask == '{rare}'",
                "toast_pick = 0",
                # per-seat salt: every seat must count rounds or its key
                # would never change between deals
                "rounds += 1",
            ]}],
        },
        99: _ui_phase(
            "Game Over — Toast of the Masquerade",
            "Congratulate the guest with the most coins.",
            [
                _tool_action("Clear non-persistent UI", "clearCanvas"),
                _tool_action("Display the winner and final coins",
                             "createResultDisplay"),
            ],
            None,
        ) | {"mechanics": [{"winner": {"score": "coins"}}]},
    }
    return {
        "declaration": {
            "description": bp.description,
            "is_multiplayer": True,
            "min_players": max(bp.min_players, 4),
            "player_states": fields,
            "player_states_template": {"player_states": {"1": template}},
            "players_example": {
                "tools": tools,
                "player_states": {
                    str(i + 1): {**template, "name": example_names[i],
                                 "mask": example_masks[i]}
                    for i in range(4)
                },
            },
            "audience_groups": {},
        },
        "phases": phases,
    }


# -- description mining: roles, counts, player minimums ----------------------
#
# The reference's generator is gpt-5 and accepts anything; the built-in path
# can still go well beyond fixed blueprints by mining the description for
# the cast: night-action roles by their conventional names, duplicated
# killers ("two mafia"), and the table size ("6 players").

_KILLER_NAME = r"(assassins?|werewol(?:f|ves)|mafia|killers?|murderers?|impostors?|vampires?|bandits?)"
_PROTECT_NAME = r"(doctors?|guardians?|bodyguards?|healers?|protectors?|angels?)"
_INVEST_NAME = r"(detectives?|seers?|sheriffs?|inspectors?|investigators?|oracles?|psychics?)"
_FILLER_NAME = r"(villagers?|civilians?|townsfolk|crew(?:mates?)?|citizens?)"
_NUM_WORDS = {"one": 1, "two": 2, "three": 3, "four": 4, "five": 5, "six": 6,
              "seven": 7, "eight": 8}
_PLAYERS_RE = re.compile(r"\b(\d+|" + "|".join(_NUM_WORDS) + r")\s+players?\b",
                         re.IGNORECASE)


def _count_before(description: str, match: re.Match) -> int:
    """'two mafia' / '2 werewolves' -> 2; default 1."""
    prefix = description[: match.start()].rstrip().rsplit(None, 1)
    if not prefix:
        return 1
    w = prefix[-1].lower()
    if w.isdigit():
        return max(1, min(4, int(w)))
    return max(1, min(4, _NUM_WORDS.get(w, 1)))


def _singular_title(name: str) -> str:
    from game_engine_tpu_torch.gamespec.conditions import _singularize

    s = _singularize(name)
    return s[:1].upper() + s[1:]


def _mine_elimination_roles(description: str) -> tuple[RoleDef, ...]:
    """Build a custom cast from conventional role names in the description;
    empty tuple when nothing beyond the defaults is named."""
    from game_engine_tpu_torch.gamespec.conditions import _pluralize

    roles: list[RoleDef] = []
    km = re.search(_KILLER_NAME, description, re.IGNORECASE)
    if km is None:
        return ()
    killer = _singular_title(km.group(1))
    evil_team = _pluralize(killer.lower())
    fm = re.search(_FILLER_NAME, description, re.IGNORECASE)
    filler = _singular_title(fm.group(1)) if fm else "Civilian"
    roles.append(RoleDef(filler, "town", "",
                         "No night action; votes during the day."))
    for _ in range(_count_before(description, km)):
        roles.append(RoleDef(killer, evil_team, "kill",
                             "At night, chooses one target to eliminate."))
    pm = re.search(_PROTECT_NAME, description, re.IGNORECASE)
    if pm:
        roles.append(RoleDef(_singular_title(pm.group(1)), "town", "protect",
                             "At night, protects one player from elimination."))
    im = re.search(_INVEST_NAME, description, re.IGNORECASE)
    if im:
        roles.append(RoleDef(_singular_title(im.group(1)), "town", "investigate",
                             "At night, investigates one player's alignment."))
    return tuple(roles)


def _mine_min_players(description: str, default: int) -> int:
    m = _PLAYERS_RE.search(description)
    if not m:
        return default
    w = m.group(1).lower()
    n = int(w) if w.isdigit() else _NUM_WORDS[w]
    return max(3, min(12, n))


_MINORITY_WORDS = re.compile(
    r"\b(minority|odd one out|contrarian|smallest group|blend(?:ing)? in)\b",
    re.IGNORECASE,
)
_BLUFF_WORDS = re.compile(
    r"\b(bluff\w*|coup|challeng\w*|call(?:ing)? (?:a|their|the) bluff|influence)\b",
    re.IGNORECASE,
)
_MARKET_WORDS = re.compile(
    r"\b(coin\w*|gold|trad\w*|market|raid\w*|steal\w*|loot\w*|resourc\w*|econom\w*|bidding)\b",
    re.IGNORECASE,
)
_GIFT_WORDS = re.compile(
    r"\b(gift\w*|secret santa|generos\w*|present exchange|"
    r"giv\w+ (?:a |one )?coins? to)\b", re.IGNORECASE)
_AUCTION_WORDS = re.compile(
    r"\b(auction\w*|sealed[- ]bids?|highest bid\w*|bid(?:s|ding)? (?:for|on|war))\b",
    re.IGNORECASE,
)
_RACING_WORDS = re.compile(
    r"\b(rac\w+|track|laps?|finish line|sprint\w*|speed\w*|"
    r"collid\w*|collision\w*|overtak\w*)\b", re.IGNORECASE)
# words the masquerade archetype genuinely models (the deal statement,
# choice flavor, table talk) — consumed for coverage accounting only when
# masquerade vocabulary is present, never used for archetype selection
_MASQ_CONTEXT = re.compile(
    r"\b(deals?|dealt|re-?deals?|fresh|guests?|sip\w*|toasts?\w*|"
    r"quiet\w*|bold\w*|ball(?:room)?s?|identit\w*|wear\w*|revel\w*)\b",
    re.IGNORECASE)
_MASQ_WORDS = re.compile(
    r"\b(masquerades?|masked ball|masks?|unmask\w*|costume\w*|"
    r"disguise\w*|gala)\b", re.IGNORECASE)
# "Fox, Owl and Crane masks" — the named masks become the deal multiset.
# One template, two compilations: cased for mining (proper-noun mask
# names), case-insensitive for coverage accounting over lowered text.
_MASQ_NAMES_TPL = (
    r"((?:{w}(?:,\s*(?:and\s+)?|\s+and\s+)){{2}}{w})\s+masks?")
_MASQ_NAMES_RX = re.compile(_MASQ_NAMES_TPL.format(w=r"[A-Z][a-z]+"))
_MASQ_NAMES_CI_RX = re.compile(
    _MASQ_NAMES_TPL.format(w=r"[a-z][a-z'-]+"), re.IGNORECASE)
_DRAFT_WORDS = re.compile(
    r"\b(drafts?|drafting|shared pool|shrinking pool|snake draft|"
    r"claim\w* (?:a |one )?(?:prize|relic|card|item)s?|"
    r"pick\w* from (?:a|the) (?:pool|table|pile))\b", re.IGNORECASE)
_PRESSLUCK_WORDS = re.compile(
    r"\b(press(?:es|ing)? (?:your |their |on)?luck|bust\w*|bank\w*|"
    r"push(?:es|ing)? (?:your |their )?luck|stash\w*|risk\w* it|"
    r"greed\w*|one more roll|cash(?:es|ing)? (?:out|in))\b",
    re.IGNORECASE)
_CONVERT_WORDS = re.compile(
    r"\b(convert\w*|recruit\w*|cults?|cultists?|indoctrinat\w*|"
    r"assimilat\w*|brainwash\w*|infect\w*|zombif\w*|"
    r"pull\w* (?:them |players? )?into the fold|join\w* the fold)\b",
    re.IGNORECASE)
_CONVERT_LEADER_NAME = (
    r"(prophets?|cult leaders?|high priest(?:ess)?e?s?|patient zero|"
    r"vampire lords?|puppet ?masters?|hive queens?|zombie kings?)")
_NIGHT_WORDS = re.compile(
    r"\b(night|hidden roles?|mafia|impostor|assassin|deduction|werewol\w+|secret(?:ly)? kill)\b",
    re.IGNORECASE,
)
# STRUCTURAL night-cycle vocabulary — a strict subset of _NIGHT_WORDS
# excluding the role-flavor tokens (assassin, deduction) that also appear
# in bluff-family games ("a bluffing and deduction game... the Assassin
# card" is Coup, not Werewolf; held-out eval witness: describe_coup in
# tests/fixtures/heldout_descriptions.json)
_NIGHT_STRUCT_WORDS = re.compile(
    r"\b(night|hidden roles?|mafia|impostor|werewol\w+|secret(?:ly)? kill)\b",
    re.IGNORECASE,
)
# core bluff identity words; "challenge"/"influence" alone are too common
# to outrank a night cycle, but bluff/coup name the family itself
_BLUFF_CORE_WORDS = re.compile(r"\b(bluff\w*|coup)\b", re.IGNORECASE)
_BATTLE_WORDS = re.compile(
    r"\b(last (?:one|player|man) standing|battle royale|survivor|sole survivor|vote.{0,20}out)\b",
    re.IGNORECASE,
)
# explicit raid vocabulary (a strict subset of _MARKET_WORDS): with auction
# vocabulary also present, it stacks BOTH economy families onto the base
_RAIDY_WORDS = re.compile(
    r"\b(raid\w*|steal\w*|loot\w*|plunder\w*|rob(?:s|bed|bing)?)\b",
    re.IGNORECASE,
)


# coverage accounting: vocabulary the "rounds" fallback genuinely models
# (two-truths-style statement/guess/score rounds) — selection never keys on
# it, but a description made of these words IS covered by the fallback
_ROUNDS_WORDS = re.compile(
    r"\b(statements?|truths?|lies?|lying|guess\w*|speak\w*|tell\w*|stor\w+|"
    r"quiz\w*|trivia|riddles?|clues?)\b", re.IGNORECASE)
# game furniture every archetype provides regardless of description
_FURNITURE_WORDS = frozenset("""
    game games play player players playing round rounds turn turns phase
    phases win wins winner winning lose loses loser losing score scores
    scoring point points vote votes voting voted eliminate eliminated
    elimination team teams group groups choose chooses chosen pick picks
    picked secret secretly private public reach reaches first most target
    targets discussion discuss timer start end final
""".split())
_STOPWORDS = frozenset("""
    a an the and or but of to in into with for on at by from is are was be
    been being as it its his her their they them he she who whom which that
    this these those then than when while each every all any some no not
    one two three four five six seven eight nine ten other others another
    more until after before during can may must will would should your you
    we our us out up down over under gets get got has have had does do did
    where there here
""".split())
# words the archetype TEMPLATES genuinely model even though selection never
# keys on them (income/raid/winner/night-cycle vocabulary of the generated
# phases) — counting them unconsumed would false-flag well-covered
# descriptions like "collect coins each morning and raid rival purses"
_COVERAGE_EXTRA = re.compile(
    r"\b(collects?|earns?|gains?|receives?|income|purses?|treasur\w+|"
    r"richest|wealth\w*|rivals?|morning|dawn|dusk|day|protect\w*|"
    r"investigat\w*|alignments?|suspic\w*|accus\w*|kill\w*|eliminat\w*|"
    r"survive\w*|lots?|prizes?|pays?|claims?|caught|crowd\w*|arena|"
    # nouns the count miners parameterize (doors -> n_options,
    # relics/cards/treasures -> draft pool)
    r"doors?|paths?|relics?|cards?|treasures?|items?|"
    # bluff-family flavor the challenge mechanic genuinely models
    r"liars?|lying|suspects?\w*)\b",
    re.IGNORECASE)


# Engine-machinery phrasing that EVERY generated DSL implements — phase
# graphs (next_phase branch maps), completion criteria, the night
# archetype's pinned kill->protect->investigate resolution (SEMANTICS.md
# P3/P4), role deals, speaker rotation, setup/turn phases. Credited by
# description_coverage ONLY (never by archetype selection, so catalog
# byte-pins are untouched): upstream-authored descriptions (the held-out
# set, reference game_draft/ + prompt examples) spend 20-40% of their
# content words describing this machinery, and leaving it "unconsumed"
# misreported implemented structure as a capability gap.
_STRUCTURE_RES = (
    # phase identifier chains: "role_assignment → first_night → ..." ARE
    # the phase graph the DSL emits
    re.compile(r"[\w()/]+(?:\s*(?:→|->)\s*[\w()/]+)+"),
    re.compile(r"\b(?:game\s+)?flow\s+navigation\b|\bstate\s+graph\b|"
               r"\bphase\s+graph\b|\bgame\s+flow\b", re.IGNORECASE),
    re.compile(r"\b(?:win|victory|exit|completion)\s+conditions?\b|"
               r"\bconditions?\s+(?:are\s+)?(?:met|checked)\b|"
               r"\bcheck\s+win\b", re.IGNORECASE),
    re.compile(r"\brole\s+assignment\b|\broles?\s+(?:are\s+)?assign\w*|"
               r"\bassigned\s+(?:hidden\s+)?roles?\b", re.IGNORECASE),
    re.compile(r"\b(?:night\s*/?\s*day|day[-/\s]?night)\s+cycles?\b|"
               r"\bcycles?\s+through\b", re.IGNORECASE),
    re.compile(r"\bresolution\s+order\b|\bresolve\s+in\s+order\b|"
               r"\bactions?\s+resolve\b|\bkill\s+attempts?\b|"
               r"\bprotection\s+checks?\b", re.IGNORECASE),
    re.compile(r"\bspeaker\s+rotation\b|\brotates?\b", re.IGNORECASE),
    re.compile(r"\bgame\s+setup\b|\binitial\s+setup\b|\bturn\s+order\b|"
               r"\bturn\s+start\b|\bgame\s+state\b", re.IGNORECASE),
    # mechanics the shipped rounds/two-truths blueprint implements
    # (games/two-truths-and-a-lie.yaml: statements dict with a lie index,
    # vote-the-lie, +1 per correct guesser, speaker scores when voters are
    # fooled, highest total wins; the free-text overlay accepts naturally
    # phrased statements, server/manager.py _normalize_text)
    re.compile(r"\btwo\s+true\b|\bone\s+false\b|\btrue,?\s+one\s+false\b|"
               r"\btrue\s+or\s+false\b", re.IGNORECASE),
    re.compile(r"\bcorrect(?:ly)?\s+(?:guess\w*|identif\w*|vot\w*)|"
               r"\bidentif\w*\s+the\s+(?:lie|false)\b", re.IGNORECASE),
    re.compile(r"\bfool\w*|\bdeceiv\w*|\bdeception\b", re.IGNORECASE),
    re.compile(r"\bpoints?\s+(?:are\s+)?awarded\b|\bawarded\s+points?\b|"
               r"\bhighest\s+(?:score|total|points?)\b", re.IGNORECASE),
    re.compile(r"\bshar\w+\s+(?:\w+\s+){0,2}statements?\b|"
               r"\bstatements?\s+about\s+themselves\b|"
               r"\bshar\w+\s+statements?\s+naturally\b", re.IGNORECASE),
)


def description_coverage(description: str) -> dict[str, Any]:
    """How much of a free-text description the deterministic generator's
    vocabularies actually consume — the honesty signal behind the
    low-coverage WARNING (the reference never silently substitutes a
    different game; without an external model this path otherwise would,
    reference: agent/dsl_agent.py:343-349).

    Returns {"score": 0..1, "content_words": n, "unconsumed": [...]}."""
    text = description.lower()
    words = [w for w in re.findall(r"[a-z][a-z'-]+", text)
             if w not in _STOPWORDS and len(w) >= 3]
    content = [w for w in words if w not in _FURNITURE_WORDS]
    if not content:
        return {"score": 1.0, "content_words": 0, "unconsumed": []}
    consumed: set[str] = set()
    vocab_res = (
        _NIGHT_WORDS, _BATTLE_WORDS, _MINORITY_WORDS, _BLUFF_WORDS,
        _MARKET_WORDS, _AUCTION_WORDS, _GIFT_WORDS, _CONVERT_WORDS,
        _PRESSLUCK_WORDS, _RACING_WORDS, _DRAFT_WORDS, _MASQ_WORDS,
        _ROUNDS_WORDS, _PLAYERS_RE, _COVERAGE_EXTRA,
    )
    if _MASQ_WORDS.search(text):
        for m in _MASQ_CONTEXT.finditer(text):
            consumed.update(re.findall(r"[a-z][a-z'-]+", m.group(0)))
    for m in _FIRST_TO_RX.finditer(text):
        consumed.update(re.findall(r"[a-z][a-z'-]+", m.group(0)))
    # named masks ("Fox, Owl and Crane masks") are understood: they become
    # the deal multiset of the masquerade archetype
    for m in _MASQ_NAMES_CI_RX.finditer(text):
        consumed.update(re.findall(r"[a-z][a-z'-]+", m.group(1)))
    # named court lists ("the Duke, Captain or Inquisitor cards") become
    # the bluff archetype's role set; "busting past 8" sets its ceiling
    for m in _COURT_NAMES_CI_RX.finditer(text):
        consumed.update(re.findall(r"[a-z][a-z'-]+", m.group(1)))
    for m in _BUST_LIMIT_CI_RX.finditer(text):
        consumed.update(re.findall(r"[a-z][a-z'-]+", m.group(0)))
    for rx in vocab_res:
        for m in rx.finditer(text):
            consumed.update(re.findall(r"[a-z][a-z'-]+", m.group(0)))
    for rx in _STRUCTURE_RES:
        for m in rx.finditer(text):
            consumed.update(re.findall(r"[a-z][a-z'-]+", m.group(0)))
    for pat in (_KILLER_NAME, _PROTECT_NAME, _INVEST_NAME, _FILLER_NAME,
                _CONVERT_LEADER_NAME):
        for m in re.finditer(pat, text, re.IGNORECASE):
            consumed.update(re.findall(r"[a-z][a-z'-]+", m.group(0)))
    # house-rule sentences the rules miner compiles to effect programs are
    # understood, not unconsumed prose
    consumed.update(RU.consumed_words(text))
    unconsumed = sorted({w for w in content if w not in consumed})
    score = 1.0 - len(unconsumed) / len(set(content))
    return {"score": round(score, 3), "content_words": len(set(content)),
            "unconsumed": unconsumed}


# below this fraction of consumed content words, the generated archetype
# game likely is NOT the described game — generation warns loudly
COVERAGE_WARN_THRESHOLD = 0.5


_NUM_WORDS_EXT = {**_NUM_WORDS, "nine": 9, "ten": 10, "eleven": 11,
                  "twelve": 12, "thirteen": 13, "fourteen": 14,
                  "fifteen": 15, "sixteen": 16, "twenty": 20}
_FIRST_TO_RX = re.compile(
    r"\bfirst\b(?:\s+\w+){0,2}?\s+to\s+(\d+|"
    + "|".join(_NUM_WORDS_EXT) + r")\b", re.IGNORECASE)


def _mine_first_to(description: str, default: int) -> int:
    """'First to twelve coins wins' -> 12 (digit or number word).

    Clamped to 2..60: a mined 1 would end the game on the first score and
    a huge target would outlive the engine's round caps — both are more
    plausibly mis-mined prose than intent."""
    m = _FIRST_TO_RX.search(description)
    if not m:
        return default
    tok = m.group(1).lower()
    return max(2, min(60, int(tok) if tok.isdigit() else _NUM_WORDS_EXT[tok]))


def _mine_rounds(description: str, default: int) -> int:
    """'play ten rounds' / 'best of 5 rounds' -> the round cap for
    archetypes that declare one. Clamped to 2..100."""
    m = re.search(r"\b(\d+|" + "|".join(_NUM_WORDS_EXT) + r")\s+rounds?\b",
                  description, re.IGNORECASE)
    if not m:
        return default
    tok = m.group(1).lower()
    return max(2, min(100, int(tok) if tok.isdigit() else _NUM_WORDS_EXT[tok]))


def _mine_bust_limit(description: str, default: int) -> int:
    """'busting past 8' / 'bust at 8' -> 8: the press-your-luck stash
    ceiling. Clamped to 3..20 (a limit of 1-2 busts almost every press)."""
    m = re.search(
        r"\bbust\w*\s+(?:past|at|over|above|beyond)\s+(\d+|"
        + "|".join(_NUM_WORDS_EXT) + r")\b", description, re.IGNORECASE)
    if not m:
        return default
    tok = m.group(1).lower()
    return max(3, min(20, int(tok) if tok.isdigit() else _NUM_WORDS_EXT[tok]))


# "the Duke, Captain or Inquisitor cards" — a 3-name proper-noun list
# with a mandatory roles/cards suffix becomes the bluff archetype's court
# (mandatory suffix, like the masquerade mask miner: a bare capitalized
# list is more plausibly player names)
_COURT_NAMES_RX = re.compile(
    r"((?:[A-Z][a-z]+(?:,\s*(?:and\s+|or\s+)?|\s+(?:and|or)\s+)){2}"
    r"[A-Z][a-z]+)\s+(?:roles?|cards?)")
# coverage-accounting twin over lowered text (the miner itself is cased)
_COURT_NAMES_CI_RX = re.compile(
    r"((?:[a-z][a-z'-]+(?:,\s*(?:and\s+|or\s+)?|\s+(?:and|or)\s+)){2}"
    r"[a-z][a-z'-]+)\s+(?:roles?|cards?)", re.IGNORECASE)
_BUST_LIMIT_CI_RX = re.compile(
    r"\bbust\w*\s+(?:past|at|over|above|beyond)\s+\w+\b", re.IGNORECASE)


def _mine_bluff_roles(bp: Blueprint) -> Blueprint:
    """Mine a described court ('claim the Duke, Captain or Inquisitor')
    into the bluff archetype's role set; keep the default court when no
    3-name proper-noun list appears. Explicit bp.roles win."""
    if bp.roles:
        return bp
    m = _COURT_NAMES_RX.search(bp.description)
    if not m:
        return bp
    names = re.findall(r"[A-Z][a-z]+", m.group(1))
    if len(names) != 3 or len(set(names)) != 3:
        return bp
    roles = tuple(RoleDef(n, "court", "", f"The {n} of the court.")
                  for n in names)
    return dataclasses.replace(bp, roles=roles)


def _mine_income(description: str, default: int) -> int:
    """'each trader collects 2 coins' -> 2 — the per-round income, mined
    with the same verb+amount shape the analyzer's P12 detector reads
    (mechanics.py _INCOME_RE), so the mined sentence always re-attaches."""
    m = re.search(
        r"\b(?:gains?|collects?|receives?|earns?)\s+(\d+|"
        + "|".join(_NUM_WORDS_EXT) + r")\s+coins?\b",
        description, re.IGNORECASE)
    if not m:
        return default
    tok = m.group(1).lower()
    return max(1, min(5, int(tok) if tok.isdigit() else _NUM_WORDS_EXT[tok]))


def _mine_count(description: str, noun_rx: str, default: int,
                lo: int, hi: int) -> int:
    """'pick one of 5 doors' / 'four prizes on the table' -> the count
    before the noun (digit or number word), clamped to [lo, hi]."""
    m = re.search(r"\b(\d+|" + "|".join(_NUM_WORDS_EXT) + r")\s+(?:"
                  + noun_rx + r")\b", description, re.IGNORECASE)
    if not m:
        return default
    tok = m.group(1).lower()
    return max(lo, min(hi, int(tok) if tok.isdigit() else _NUM_WORDS_EXT[tok]))


def _mine_mask_names(description: str) -> tuple[str, str, str]:
    """'the Fox, Owl and Crane masks' -> ('Fox', 'Owl', 'Crane'): first
    name is the rare paying mask, second the common filler, third the trap
    (declaration-order convention of the masquerade archetype)."""
    m = _MASQ_NAMES_RX.search(description)
    if not m:
        return ("Fox", "Owl", "Crane")
    names = tuple(re.findall(r"[A-Z][a-z]+", m.group(1)))
    return names if len(names) == 3 else ("Fox", "Owl", "Crane")


def keyword_selection(description: str) -> dict[str, Any]:
    """The deterministic keyword-dispatch decision, exposed as data:
    ``{"archetype", "roles", "extras", "matched"}``. ``matched`` is False
    exactly when NO selection vocabulary fired and the dispatch fell
    through to the "rounds" default — the blind spot the learned intent
    tier (dslgen/intent.py) covers. Pure refactor of the round-1..4
    cascade; ``generate_from_description`` consumes it unchanged."""
    roles: tuple[RoleDef, ...] = ()
    extras: tuple[str, ...] = ()
    # conversion vocabulary outranks night vocabulary: "the cult converts a
    # villager each night" is a recruitment game that happens to mention
    # night, not an elimination game — resolved by the P20 string-write IR
    if _CONVERT_WORDS.search(description):
        archetype = "conversion"
        lm = re.search(_CONVERT_LEADER_NAME, description, re.IGNORECASE)
        fm = re.search(_FILLER_NAME, description, re.IGNORECASE)
        roles = (
            RoleDef(_singular_title(lm.group(1)) if lm else "Prophet",
                    "cult", "convert",
                    "Begins the cult; converts one player each night."),
            RoleDef(_singular_title(fm.group(1)) if fm else "Villager",
                    "free", "",
                    "Starts free; votes by day, may be converted by night."),
        )
        return {"archetype": archetype, "roles": roles, "extras": (),
                "matched": True,
                "min_players": _mine_min_players(description, 5)}
    # night/role vocabulary FIRST: "werewolves steal gold at night" is an
    # elimination game that happens to mention market words, not a market
    # game (round-1 precedence, kept) — but if the description ALSO talks
    # economy, the market family is composed in as a mechanic mix.
    # EXCEPTION: when the family names itself bluff/Coup and the only
    # night hits are role flavor (assassin, deduction) with no structural
    # night cycle, the bluff branch below owns it (Coup's Assassin card
    # must not turn the game into werewolf; held-out witness describe_coup)
    bluff_owns = (_BLUFF_CORE_WORDS.search(description)
                  and not _NIGHT_STRUCT_WORDS.search(description))
    if not bluff_owns and (_NIGHT_WORDS.search(description)
                           or _mine_elimination_roles(description)):
        archetype = "elimination"
        roles = _mine_elimination_roles(description)
        if _AUCTION_WORDS.search(description):
            # auction vocabulary outranks bare economy; auction + explicit
            # raid vocabulary stacks BOTH families onto the night cycle
            extras = (("market", "auction")
                      if _RAIDY_WORDS.search(description) else ("auction",))
        elif _MARKET_WORDS.search(description):
            extras = ("market",)
    elif _GIFT_WORDS.search(description):
        # transfer vocabulary outranks bare economy words ("gift coins to
        # each other" is a gifting circle, not a raid market) — resolved by
        # the P20 effect-IR archetype
        archetype = "gifting"
    elif _PRESSLUCK_WORDS.search(description):
        # banking/bust vocabulary outranks bare economy words ("bank the
        # stash before busting" is a press-your-luck run, not a market) —
        # resolved by the P20 effect IR's conditional reset
        archetype = "pressluck"
    elif _DRAFT_WORDS.search(description):
        # draft vocabulary outranks economy words ("claim a prize from the
        # shared pool" is a draft, not a market) — IR rank()==0 claims
        archetype = "draft"
    elif _RACING_WORDS.search(description):
        # racers who also collect/raid coins get the market family woven
        # into the race loop (sponsorship income + pit raids + a richest
        # terminal beside the finish line)
        archetype = "racing"
        if _MARKET_WORDS.search(description):
            extras = ("market",)
    elif _MINORITY_WORDS.search(description):
        archetype = "minority"
    elif _BLUFF_WORDS.search(description):
        # a court that also bids for lots (auction vocabulary outranks
        # bare economy, as in the global dispatch below) or raids purses
        # composes that family into the claim/challenge loop
        archetype = "bluff"
        if _AUCTION_WORDS.search(description):
            extras = ("auction",)
        elif _MARKET_WORDS.search(description):
            extras = ("market",)
    elif _MASQ_WORDS.search(description):
        # mask/identity-rotation vocabulary: a fresh deal every round via
        # the IR's `deal ... salt` statement. Checked AFTER minority and
        # bluff — mask/costume words are common flavor in those families
        # ("hide behind costumes and challenge claims" is a bluff game)
        archetype = "masquerade"
    elif (_ROUNDS_WORDS.search(description) and _MARKET_WORDS.search(description)
          and not _AUCTION_WORDS.search(description)):
        # statement-round vocabulary + economy vocabulary = a storytelling
        # circle with a coin economy (story pot income, rival raids, a
        # richest-storyteller terminal beside the standings terminal);
        # auction vocabulary keeps the plain auction dispatch below
        archetype = "rounds"
        extras = ("market",)
    elif _AUCTION_WORDS.search(description):
        # auction vocabulary outranks generic economy words ("bidding" alone
        # is a market keyword; "bidding for lots" is an auction); with
        # survival vocabulary it composes into the battle graph instead
        if _BATTLE_WORDS.search(description):
            archetype = "battle"
            extras = (("market", "auction")
                      if _RAIDY_WORDS.search(description) else ("auction",))
        else:
            archetype = "auction"
    elif _MARKET_WORDS.search(description):
        # economy vocabulary + survival vocabulary = battle+market mix
        if _BATTLE_WORDS.search(description):
            archetype = "battle"
            extras = ("market",)
        else:
            archetype = "market"
    elif _BATTLE_WORDS.search(description):
        archetype = "battle"
    else:
        # pure fallthrough: NO selection vocabulary fired. "rounds" is the
        # round-1 default (statement/guess rounds genuinely model quiz-ish
        # descriptions); matched=False lets the learned intent tier weigh in
        min_players = _mine_min_players(description, 4)
        return {"archetype": "rounds", "roles": (), "extras": (),
                "matched": False, "min_players": min_players}
    min_players = _mine_min_players(
        description, max(4, len(roles)) if archetype == "elimination" else 4)
    return {"archetype": archetype, "roles": roles, "extras": extras,
            "matched": True, "min_players": min_players}


def generate_from_description(
    name: str,
    description: str,
    llm_hook: Optional[Callable[[str, str], dict]] = None,
    report: Optional[list[str]] = None,
) -> dict[str, Any]:
    """Free-text description -> DSL doc. ``llm_hook(name, description)`` can
    override with an external model (the seam where the reference called
    gpt-5); the built-in path is keyword archetype selection, backed by the
    learned intent classifier (dslgen/intent.py) exactly where the keyword
    cascade is blind (no selection vocabulary fired at all).

    ``report`` (optional, caller-provided list) receives WARNING strings —
    most importantly the low-description-coverage warning when the built-in
    vocabularies understood too little of the description to honor it —
    plus a notice when the learned tier picked the archetype."""
    if llm_hook is not None:
        return llm_hook(name, description)
    cov = description_coverage(description)
    sel = keyword_selection(description)
    archetype, roles, extras = sel["archetype"], sel["roles"], sel["extras"]
    min_players = sel["min_players"]
    learned_note = None
    if not sel["matched"] and not _ROUNDS_WORDS.search(description):
        # the cascade saw NOTHING it understands and the default "rounds"
        # archetype has no textual support either — ask the learned tier
        from game_engine_tpu_torch.dslgen import intent as I

        res = I.classify_default(description)
        if res is not None and res.confident and res.archetype != "rounds":
            archetype = res.archetype
            min_players = _mine_min_players(
                description, 5 if archetype == "conversion" else 4)
            learned_note = (
                f"NOTE: no selection vocabulary matched; the learned intent "
                f"classifier picked the '{res.archetype}' archetype "
                f"(confidence {res.confidence:.2f}). Parameters are that "
                "archetype's defaults unless mined from the description.")
    if report is not None and cov["score"] < COVERAGE_WARN_THRESHOLD:
        sample = ", ".join(cov["unconsumed"][:8])
        report.append(
            f"WARNING: description coverage {int(cov['score'] * 100)}% — "
            f"{len(cov['unconsumed'])} of {cov['content_words']} content "
            f"words were not understood by the deterministic generator "
            f"({sample}). The generated game is a best-effort archetype and "
            "likely does NOT match the description; plug an external model "
            "(dslgen/llm_adapter.py llm_hook) for arbitrary games.")
    if report is not None and learned_note is not None:
        report.append(learned_note)
    doc = generate(Blueprint(name=name, description=description,
                             archetype=archetype, roles=roles,
                             min_players=min_players, extras=extras))
    # house-rule sentences compile to a declared P20 effects program on the
    # archetype's round loop (dslgen/rules.py) — novel mechanics beyond the
    # archetype matrix, still fully deterministic
    mined_rules = RU.mine_rules(description)
    if mined_rules:
        RU.inject_rules(doc, mined_rules, report=report)
    return doc
