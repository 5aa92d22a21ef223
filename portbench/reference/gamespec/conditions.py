"""Compiler for natural-language next_phase branch conditions.

``next_phase`` branch keys are English sentences evaluated first-match-wins
by the reference's PhaseNode LLM (reference:
agent/prompt/PhaseNode_system_prompt.txt:44-48,106-120). This module pins
those judgment calls as a deterministic pattern compiler producing a small
room-level condition IR. The four pattern families (exactly the ones the
reference prompt documents) are:

  1. count comparisons over player groups
         "If no living Werewolves remain"            -> count(G) == 0
         "If living Werewolves equal to or outnumber living Villagers"
                                                      -> count(A) >= count(B)
  2. phase-history checks
         "If this check follows a day elimination"    -> prev_phase in {ids}
  3. all-player field checks
         "If all players have completed the agreed number of speaking turns"
                                                      -> all(field >= R)
  4. fallthrough
         "Otherwise, ..." / unrecognized              -> Always
         (unrecognized conditions compile to Always — this mirrors the
         reference's progression bias, PhaseNode_system_prompt.txt:4-12)

Group references resolve, in priority order, against: declared
audience_groups, team values, role names (singular/plural-insensitive).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

from portbench.reference.gamespec import expr
from portbench.reference.gamespec.expr import And, Atom, Pred, parse_predicate
from portbench.reference.gamespec.schema import FieldType, GameSpec

# ---------------------------------------------------------------------------
# Condition IR (room-level)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CountCmp:
    """count(players matching left) <op> (count(right) or constant)."""

    left: Pred
    op: str  # eq, ne, ge, le, gt, lt
    right: Union[Pred, int]


@dataclasses.dataclass(frozen=True)
class AllPresent:
    """Every present player satisfies pred."""

    pred: Pred


@dataclasses.dataclass(frozen=True)
class PrevPhaseIn:
    """The previously-occupied (distinct) phase id is in this set."""

    phase_ids: frozenset[int]


@dataclasses.dataclass(frozen=True)
class AlwaysTrue:
    pass


@dataclasses.dataclass(frozen=True)
class CondAnd:
    items: tuple["Cond", ...]


Cond = Union[CountCmp, AllPresent, PrevPhaseIn, AlwaysTrue, CondAnd]


# ---------------------------------------------------------------------------
# Tokenization helpers
# ---------------------------------------------------------------------------

_STOPWORDS = frozenset(
    "if this check the a an and or of to for has have are is was were been "
    "be it its their his her they them that those these there then than when "
    "continues continue game no one won remaining remain remains left "
    "otherwise next s".split()
)


def _tokens(text: str) -> list[str]:
    return [t for t in re.findall(r"[a-z0-9_]+", text.lower()) if t]


def _stem(tok: str) -> str:
    for suf in ("ings", "ing", "ions", "ion", "ers", "er", "es", "s", "ed"):
        if tok.endswith(suf) and len(tok) - len(suf) >= 3:
            return tok[: -len(suf)]
    return tok


# Synonym classes for matching condition phrases to phase names.
_SYNONYMS = {
    "elimination": "result",
    "eliminated": "result",
    "eliminate": "result",
    "result": "result",
    "results": "result",
    "announce": "result",
    "announcement": "result",
    "resolution": "result",
    "reveal": "result",
    "morning": "night",  # morning phases resolve the night
    "dawn": "night",
}


def _match_class(tok: str) -> str:
    return _SYNONYMS.get(tok, _stem(tok))


# ---------------------------------------------------------------------------
# Group resolution
# ---------------------------------------------------------------------------


def _singularize(word: str) -> str:
    w = word.lower()
    if w.endswith("ves"):
        return w[:-3] + "f"  # werewolves -> werewolf
    if w.endswith("ies"):
        return w[:-3] + "y"
    if w.endswith("s") and not w.endswith("ss"):
        return w[:-1]
    return w


def _pluralize(word: str) -> str:
    w = word.lower()
    if w.endswith("f"):
        return w[:-1] + "ves"
    if w.endswith("y"):
        return w[:-1] + "ies"
    return w + "s"


class ConditionContext:
    """Static game facts needed to compile conditions."""

    def __init__(self, spec: GameSpec, rounds_per_player: int = 1):
        self.spec = spec
        self.rounds_per_player = rounds_per_player
        decl = spec.declaration
        self.field_names = set(decl.field_names())
        self.has_alive = "is_alive" in self.field_names

        # audience groups compiled to predicates
        self.groups: dict[str, Pred] = {}
        for g in decl.audience_groups:
            try:
                self.groups[g.name.lower()] = parse_predicate(g.selection_criteria)
            except expr.PredicateError:
                continue

        # team vocabulary: every distinct string value of a field named/typed
        # like a team, mined from players_example + audience criteria literals
        self.team_field = "team" if "team" in self.field_names else None
        # lowercase lookup -> original-case value: predicates must carry the
        # stored spelling or the oracle's case-sensitive compare diverges
        # from the table path's case-insensitive vocab encoding
        self.teams: dict[str, str] = {}
        if self.team_field:
            for row in decl.players_example.values():
                v = row.get(self.team_field)
                if isinstance(v, str) and v:
                    self.teams.setdefault(v.lower(), v)
            for g in decl.audience_groups:
                for m in re.findall(r"'([^']+)'|\"([^\"]+)\"", g.selection_criteria):
                    s = m[0] or m[1]
                    if "team" in g.selection_criteria and s:
                        self.teams.setdefault(s.lower(), s)

        self.role_field = "role" if "role" in self.field_names else None
        self.roles = {r.name.lower(): r.name for r in decl.roles}

    def alive_pred(self) -> Optional[Atom]:
        if self.has_alive:
            return Atom("is_alive", "eq", True)
        return None

    def resolve_group(self, word: str, living: bool) -> Optional[Pred]:
        """Resolve a group word like 'Werewolves' to a player predicate."""
        w = word.lower()
        # fixed priority order — a set would make which of several
        # matching entries wins depend on hash order (determinism pin)
        candidates = list(dict.fromkeys((w, _singularize(w), _pluralize(w))))
        base: Optional[Pred] = None
        # 1. audience group (these already encode aliveness when relevant)
        for c in candidates:
            if c in self.groups:
                base = self.groups[c]
                living = False  # group criteria already handle aliveness
                break
        # 2. team value (original-case spelling for oracle parity)
        if base is None and self.team_field:
            for c in candidates:
                if c in self.teams:
                    base = Atom(self.team_field, "eq", self.teams[c])
                    break
        # 3. role name
        if base is None and self.role_field:
            for c in candidates:
                if c in self.roles:
                    base = Atom(self.role_field, "eq", self.roles[c])
                    break
        if base is None:
            return None
        if living and self.has_alive:
            return And((base, Atom("is_alive", "eq", True)))
        return base

    def resolve_field(self, phrase_tokens: list[str]) -> Optional[str]:
        """Find the player_states num field best matching phrase tokens."""
        stems = {_stem(t) for t in phrase_tokens if t not in _STOPWORDS}
        # prose may quote a snake_case field name verbatim ("pool_left")
        stems |= {_stem(p) for t in stems for p in t.split("_") if p}
        best, best_score = None, 0
        for f in self.spec.declaration.fields:
            if f.type is not FieldType.NUM:
                continue
            ftoks = {_stem(t) for t in _tokens(f.name.replace("_", " "))}
            # include description tokens at lower weight
            dtoks = {_stem(t) for t in _tokens(f.description)}
            score = 2 * len(stems & ftoks) + len(stems & dtoks)
            if score > best_score:
                best, best_score = f.name, score
        return best if best_score > 0 else None

    def match_phases(self, phrase: str) -> frozenset[int]:
        """Phases whose names/descriptions best match a 'follows X' phrase."""
        ptoks = {_match_class(t) for t in _tokens(phrase) if t not in _STOPWORDS}
        ptoks.discard("")
        scored: list[tuple[int, int]] = []
        for pid, ph in self.spec.phases.items():
            ntoks = {_match_class(t) for t in _tokens(ph.name)}
            score = len(ptoks & ntoks)
            if score:
                scored.append((score, pid))
        if not scored:
            return frozenset()
        top = max(s for s, _ in scored)
        return frozenset(pid for s, pid in scored if s == top)


# ---------------------------------------------------------------------------
# Pattern rules
# ---------------------------------------------------------------------------

_RE_OTHERWISE = re.compile(r"^\s*(otherwise|else|default)\b", re.IGNORECASE)
_RE_NONE_REMAIN = re.compile(
    r"\bno\s+(?:living\s+|alive\s+|more\s+)?([A-Za-z_]+)\s+(?:remain|remains|left|are left|exist)\b"
    r"|\ball\s+([A-Za-z_]+)\s+(?:are\s+|have been\s+|were\s+)?eliminated\b",
    re.IGNORECASE,
)
# articles must not be captured as the group word ("outnumber the living
# Villagers" used to capture 'the' -> unresolvable -> AlwaysTrue)
_ART = r"(?:the\s+|any\s+|all\s+)?"
_RE_GE = re.compile(
    r"\b" + _ART + r"(?:living\s+|alive\s+)?([A-Za-z_]+)\s+(?:are\s+)?equal(?:\s+to)?\s+or\s+outnumber\s+"
    + _ART + r"(?:living\s+|alive\s+)?([A-Za-z_]+)",
    re.IGNORECASE,
)
_RE_GT = re.compile(
    r"\b" + _ART + r"(?:living\s+|alive\s+)?([A-Za-z_]+)\s+outnumber\s+"
    + _ART + r"(?:living\s+|alive\s+)?([A-Za-z_]+)",
    re.IGNORECASE,
)
_RE_FOLLOWS = re.compile(r"\bfollows\s+(?:a\s+|an\s+|the\s+)?(.+)$", re.IGNORECASE)
_RE_ALL_COMPLETED = re.compile(
    r"\b(?:all|every|each)\s+players?\s+(?:has\s+|have\s+)?completed\b(.*)$", re.IGNORECASE
)
# "any player has/reaches/holds N or more <field>" -> count(field >= N) > 0
_RE_ANY_HAS = re.compile(
    r"\b(?:any|a|some|one)\s+player\s+(?:has|holds|reaches|owns|collects)\s+"
    r"(\d+)\s+or\s+more\s+([A-Za-z_ ]+?)\s*$",
    re.IGNORECASE,
)
# "any player has/drops to N or fewer <field>" -> count(field <= N) > 0
_RE_ANY_HAS_LE = re.compile(
    r"\b(?:any|a|some|one)\s+player\s+(?:has|holds|reaches|drops to|is down to)\s+"
    r"(\d+)\s+or\s+(?:fewer|less)\s+([A-Za-z_ ]+?)\s*$",
    re.IGNORECASE,
)
_RE_GAME_CONTINUES = re.compile(
    r"^\s*(?:and\s+)?(?:the\s+)?game\s+continues?\s*$|^\s*no\s+one\s+has\s+won\s*$", re.IGNORECASE
)
_RE_LAST_ONE = re.compile(
    r"\bonly\s+one\s+player\s+(?:remains|is left|remains alive|is alive)\b"
    r"|\bone\s+player\s+(?:remains|is left)(?:\s+alive|\s+standing)?\b",
    re.IGNORECASE,
)
_RE_MULTIPLE_REMAIN = re.compile(
    r"\b(?:two or more|more than one|multiple)\s+players?\s+(?:remain|are left|are still alive|are alive)\b",
    re.IGNORECASE,
)


def _compile_clause(clause: str, ctx: ConditionContext) -> tuple[Optional[Cond], bool]:
    """Compile one clause. Returns (cond | None, recognized)."""
    clause = clause.strip().rstrip(".:;")
    if not clause:
        return None, True
    if _RE_OTHERWISE.match(clause) or _RE_GAME_CONTINUES.match(clause):
        return AlwaysTrue(), True

    if ctx.has_alive:
        if _RE_LAST_ONE.search(clause):
            return CountCmp(left=Atom("is_alive", "eq", True), op="le", right=1), True
        if _RE_MULTIPLE_REMAIN.search(clause):
            return CountCmp(left=Atom("is_alive", "eq", True), op="gt", right=1), True

    m = _RE_NONE_REMAIN.search(clause)
    if m:
        word = m.group(1) or m.group(2)
        pred = ctx.resolve_group(word, living=True)
        if pred is None and word.lower() in ("players", "player", "souls",
                                             "contestants", "survivors"):
            # generic all-players phrasing: "no living players remain"
            pred = ctx.alive_pred()
        if pred is not None:
            return CountCmp(left=pred, op="eq", right=0), True

    m = _RE_GE.search(clause)
    if m:
        a = ctx.resolve_group(m.group(1), living=True)
        b = ctx.resolve_group(m.group(2), living=True)
        if a is not None and b is not None:
            return CountCmp(left=a, op="ge", right=b), True

    m = _RE_GT.search(clause)
    if m:
        a = ctx.resolve_group(m.group(1), living=True)
        b = ctx.resolve_group(m.group(2), living=True)
        if a is not None and b is not None:
            return CountCmp(left=a, op="gt", right=b), True

    m = _RE_ALL_COMPLETED.search(clause)
    if m:
        field = ctx.resolve_field(_tokens(m.group(1)))
        if field is not None:
            return AllPresent(Atom(field, "ge", ctx.rounds_per_player)), True

    m = _RE_ANY_HAS.search(clause)
    if m:
        field = ctx.resolve_field(_tokens(m.group(2)))
        if field is not None:
            return CountCmp(left=Atom(field, "ge", int(m.group(1))), op="gt", right=0), True

    m = _RE_ANY_HAS_LE.search(clause)
    if m:
        field = ctx.resolve_field(_tokens(m.group(2)))
        if field is not None:
            return CountCmp(left=Atom(field, "le", int(m.group(1))), op="gt", right=0), True

    m = _RE_FOLLOWS.search(clause)
    if m:
        phases = ctx.match_phases(m.group(1))
        if phases:
            return PrevPhaseIn(phases), True

    return None, False


def _split_clauses(text: str) -> list[str]:
    """Split a condition sentence on top-level 'and' conjunctions.

    Comparison phrases like "equal to or outnumber" must not be split, so we
    only split on " and " (the DSL uses 'and' for compound conditions,
    reference: PhaseNode_system_prompt.txt:58-62).
    """
    # strip a leading "If "
    text = re.sub(r"^\s*if\s+", "", text, flags=re.IGNORECASE)
    # drop parentheticals — they restate the main clause
    text = re.sub(r"\([^)]*\)", " ", text)
    return [c for c in re.split(r"\band\b", text, flags=re.IGNORECASE) if c.strip()]


def compile_branch_condition(text: str, ctx: ConditionContext) -> tuple[Cond, bool]:
    """Compile one branch sentence. Returns (cond, fully_recognized)."""
    conds: list[Cond] = []
    recognized_all = True
    any_recognized = False
    for clause in _split_clauses(text):
        cond, ok = _compile_clause(clause, ctx)
        if cond is not None and not isinstance(cond, AlwaysTrue):
            conds.append(cond)
        if ok:
            any_recognized = True
        else:
            recognized_all = False
    if not conds:
        # pure-fallthrough ("Otherwise...") or fully unrecognized sentence
        return AlwaysTrue(), any_recognized
    if len(conds) == 1:
        return conds[0], recognized_all
    return CondAnd(tuple(conds)), recognized_all


# ---------------------------------------------------------------------------
# Oracle-side evaluation
# ---------------------------------------------------------------------------


def eval_condition(
    cond: Cond,
    players: dict[int, dict],
    prev_phase_id: Optional[int],
) -> bool:
    """Evaluate a Cond over per-player dicts (the oracle path)."""
    if isinstance(cond, AlwaysTrue):
        return True
    if isinstance(cond, CondAnd):
        return all(eval_condition(c, players, prev_phase_id) for c in cond.items)
    if isinstance(cond, PrevPhaseIn):
        return prev_phase_id in cond.phase_ids
    if isinstance(cond, AllPresent):
        return all(expr.eval_predicate(cond.pred, p) for p in players.values())
    if isinstance(cond, CountCmp):
        lhs = sum(1 for p in players.values() if expr.eval_predicate(cond.left, p))
        rhs = (
            cond.right
            if isinstance(cond.right, int)
            else sum(1 for p in players.values() if expr.eval_predicate(cond.right, p))
        )
        return {
            "eq": lhs == rhs,
            "ne": lhs != rhs,
            "ge": lhs >= rhs,
            "le": lhs <= rhs,
            "gt": lhs > rhs,
            "lt": lhs < rhs,
        }[cond.op]
    raise TypeError(cond)
