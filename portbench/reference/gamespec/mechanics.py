"""Determinized game mechanics: the engine's pinned replacement for the
reference's LLM referee.

In the reference, game-state consequences (night-kill resolution, vote
tallies, eliminations, scoring, speaker rotation, role assignment) are
produced by RefereeNode, an LLM with prompt rules (reference:
agent/game_agent_v2.py:619-803, agent/prompt/referee_system_prompt_1.txt,
referee_system_prompt_2.txt). This module pins those judgment calls as a
deterministic rule-based analyzer: it scans the DSL and attaches to each
phase (a) a *record program* — which state fields an accepted player action
writes, parsed from the field mentions in completion_criteria.description —
and (b) *on-enter mechanics* — a small library of resolution ops detected
from phase names/descriptions.

PINNED SEMANTICS (the engine's contract; documented here once, implemented
identically by oracle/interp.py and core/step.py):

  P1  One action per player per phase; acceptance requires the player to be
      present, match the phase's target predicate, not have acted yet, and
      the choice to be legal (reference bot rules:
      agent/prompt/bot_behavior_system_prompt.txt one-action-per-phase,
      alive-target requirements).
  P2  TARGET choices must point at a present, alive player (1-based id).
      OPTION choices must be in [1, choice_max]. SUBMIT choices are
      free-content markers (any value accepted, recorded as 1).
  P3  player_action phases complete when every currently-targeted player has
      acted; vacuously complete when no player matches the target predicate.
      UI_displayed and timer phases auto-complete (timer phases are
      unconditional single-step advances; the reference's wall-clock timer is
      cosmetic — agent/prompt/PhaseNode_system_prompt.txt:14-19,
      src/app/page.tsx:1327-1335).
  P4  One phase transition per engine step (matches one reference turn).
  P5  Branch maps evaluate first-match-wins in DSL order; an unmatched
      sentence compiles to Always (progression bias); if nothing matches,
      the LAST branch is taken as fallback.
  P6  Vote tallies are pluralities with ties broken by LOWEST candidate id;
      zero votes means no effect.
  P7  Night resolution order: kill attempt -> protection check ->
      investigation (already recorded at choice time). The kill succeeds iff
      the plurality kill target is alive and differs from the protection
      target. Night bookkeeping fields written by the night phases reset to
      their template defaults on resolution.
  P8  Guess-vote scoring: each eligible voter whose choice equals the
      speaker's lie_index gains +1; the speaker gains +1 per voter who voted
      and was wrong ("fooled"). The speaker's rounds counter increments at
      the scoring phase.
  P9  Speaker rotation: next speaker is the present player with the minimum
      rounds counter, ties to lowest id; can_vote = not is_speaker; all
      round-scoped fields reset to template defaults.
  P10 Role assignment: the role multiset replicates players_example counts,
      with surplus players taking the most-common example role (ties to
      declaration order) and shortfall trimming filler first; the assignment
      permutation is splitmix32(seed, player) argsort — identical in
      oracle and jitted engine. Fields constant-per-role in players_example
      (team, eligibility flags, ...) are set alongside the role.
  P11 Winner on terminal entry: team games — the team whose alive count is
      maximal wins, ties favoring the minority team (by example count);
      score games — the player with max cumulative score, ties to lowest id.
  P19 Sealed-bid auctions: highest effective bid (min(bid, purse), >= 1)
      wins with ties to lowest id; winner pays the bid from the purse and
      gains +1 prize; bids reset to default after resolution.
  P17 Per-terminal winner modes: a terminal phase whose own text names an
      explicit winner rule overrides the game-wide P11 default — "richest /
      most <num-field> / highest score" selects score mode on the named
      field (falling back to the declared score-like then resource field),
      "last one standing / sole survivor" selects survivor mode, "the
      surviving team wins" selects team mode. Composed games (e.g.
      elimination + economy) can therefore end at different terminal
      phases with different winner rules.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Optional

from portbench.reference.gamespec import effects as FX
from portbench.reference.gamespec.expr import Pred, parse_predicate, PredicateError, TRUE


class MechanicHintError(ValueError):
    """A P18 hint that cannot take effect (loud-or-correct: the serving
    path never runs dslgen/validate.py, so a malformed declared hint must
    fail compilation rather than put a silent no-op phase in play)."""
from portbench.reference.gamespec.layout import (
    BANK_BOOL,
    BANK_NUM,
    BANK_ODICT,
    BANK_PDICT,
    BANK_STR,
    StateLayout,
)
from portbench.reference.gamespec.schema import CompletionType, GameSpec, PhaseSpec


class ChoiceKind(enum.Enum):
    NONE = 0
    TARGET = 1  # choice = 1-based player id, must be present & alive
    OPTION = 2  # choice in [1, choice_max]
    SUBMIT = 3  # free content; recorded as 1


@dataclasses.dataclass(frozen=True)
class RecordProgram:
    """Field writes applied when a player's action is accepted (P1/P2)."""

    choice_kind: ChoiceKind = ChoiceKind.NONE
    choice_max: int = 0
    set_bool_true: tuple[str, ...] = ()
    set_bool_false: tuple[str, ...] = ()
    write_choice_num: Optional[str] = None  # num field <- choice
    write_pdict: Optional[tuple[str, str]] = None  # (pdict field, source str field)
    mark_odict: Optional[str] = None  # odict field <- mark key set


@dataclasses.dataclass(frozen=True)
class NightResolve:
    """P7. kill/protect choices read from named phases via choice registers."""

    kill_phases: frozenset[int]
    protect_phases: frozenset[int]
    kill_pred: Pred  # must still hold for the chooser at resolve time
    protect_pred: Pred
    reset_bools: tuple[str, ...] = ()
    reset_nums: tuple[str, ...] = ()
    reveal_bools: tuple[str, ...] = ()  # P15: set true on the killed player
    # P6p: extra victim-seat immunity guard (effect-IR expression text from
    # a declared `night_resolution: {protect: ...}` hint); "" = none
    protect: str = ""


@dataclasses.dataclass(frozen=True)
class VoteElim:
    """P6. plurality elimination from votes cast in vote_phases."""

    vote_phases: frozenset[int]
    voter_pred: Pred
    reveal_bools: tuple[str, ...] = ()  # P15
    # P6p/P6w: declared `vote_elimination: {protect:|weight: ...}` hint
    # args — victim-seat immunity guard / per-voter weight (IR expression
    # text, parsed at lowering); "" = rounds-1-4 default
    protect: str = ""
    weight: str = ""


@dataclasses.dataclass(frozen=True)
class ResourceIncome:
    """P12. On phase entry, every present living player gains fixed amounts
    of numeric resource fields ("each alive player collects 1 coin")."""

    gains: tuple[tuple[str, int], ...]  # (num field, amount)


@dataclasses.dataclass(frozen=True)
class ResourceRaid:
    """P13. Simultaneous resource raids resolved from TARGET choices."""

    raid_phases: frozenset[int]
    raider_pred: Pred  # must still hold for the raider at resolve time
    res_field: str  # num resource field


@dataclasses.dataclass(frozen=True)
class MinorityScore:
    """P16. Simultaneous reveal: the smallest non-empty pick group scores.

    Picks are read from the num field the pick phase records (uniform with
    P14's claims). On entry: count picks per option among living pickers;
    if at least two distinct options were picked, every living player whose
    pick equals the least-picked option (ties to the lowest option index)
    gains +1 on the score field. Picks then reset to the field default so
    stale picks can't score next round."""

    pick_field: str  # num field holding the option picked (1-based)
    picker_pred: Pred
    score_field: str
    n_options: int  # static option count (the pick phase's choice_max)


@dataclasses.dataclass(frozen=True)
class AuctionScore:
    """P19. Sealed-bid auction resolved from OPTION-recorded bids.

    Bids are read from the num field the bid phase records (uniform with
    P16's picks). On entry: each living bidder's effective bid is
    min(bid, holdings) clamped at >= 0 — you cannot overbid your purse;
    bids below 1 do not compete. If any effective bid >= 1 exists, the
    highest effective bid wins, ties to the LOWEST player id (P6
    convention); the winner pays their effective bid from the resource
    field and gains +1 on the prize field. Bids then reset to the field
    default so stale bids can't win next round."""

    bid_field: str  # num field holding the sealed bid (1-based amount)
    bidder_pred: Pred
    res_field: str  # num purse the winning bid is paid from
    prize_field: str  # num field the winner gains +1 on


@dataclasses.dataclass(frozen=True)
class BluffChallenge:
    """P14. Coup-style claim/challenge resolution against hidden roles.

    Claims are read from the num FIELD the claim phase records (the choice
    register is shared per player, and the same player acts again in the
    challenge phase, overwriting it); challenges come from the TARGET
    register of the challenge phase."""

    claim_field: str  # num field: claimed role index (1-based), 0 = none
    challenge_phases: frozenset[int]  # TARGET register: challenged player
    claimant_pred: Pred
    challenger_pred: Pred
    role_field: str  # hidden identity (string field, claims index its roles)
    lives_field: str  # num field decremented on a lost claim/challenge
    reveal_bools: tuple[str, ...] = ()  # P15


@dataclasses.dataclass(frozen=True)
class GuessScore:
    """P8. two-truths style scoring."""

    speaker_field: str  # bool: is_speaker
    lie_field: str  # num: lie_index
    vote_field: str  # num: vote_choice
    voted_field: str  # bool: has_voted
    score_field: str  # num: total_score
    rounds_field: Optional[str]  # num: rounds_as_speaker (incremented here)


@dataclasses.dataclass(frozen=True)
class SpeakerRotate:
    """P9."""

    speaker_field: str
    rounds_field: str
    can_vote_field: Optional[str]
    reset_bools: tuple[str, ...] = ()
    reset_nums: tuple[str, ...] = ()
    reset_odicts: tuple[str, ...] = ()
    reset_pdicts: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class RoleAssign:
    """P10."""

    role_field: str
    # role name -> count weight from players_example
    role_counts: tuple[tuple[str, int], ...]
    # role name -> [(field, raw value)] constant-per-role settings
    role_fields: tuple[tuple[str, tuple[tuple[str, object], ...]], ...]
    filler_role: str


@dataclasses.dataclass(frozen=True)
class Effects:
    """P20: a declarative effect program (gamespec/effects.py) declared by
    the DSL under `mechanics: [{effects: [...]}]` — novel mechanics execute
    through the generic IR interpreter in every executor, no new kernels.
    The analyzer also re-expresses P12/P13/P19 through the same IR at
    lowering time (see tables.py)."""

    program: tuple  # effects.Program — tuple of statement blocks
    reveal_bools: tuple[str, ...] = ()  # P15 flags applied by `kill`


@dataclasses.dataclass(frozen=True)
class SetBoolAll:
    fields: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class GameOver:
    """P11."""

    mode: str  # 'team' | 'survivor' | 'score' | 'none'
    team_field: str = ""
    # minority-first team ordering for tie-breaks
    team_order: tuple[str, ...] = ()
    score_field: str = ""


Mechanic = object  # union of the above dataclasses


@dataclasses.dataclass(frozen=True)
class PhaseProgram:
    phase_id: int
    record: RecordProgram
    on_enter: tuple[Mechanic, ...]


# ---------------------------------------------------------------------------
# Detection helpers
# ---------------------------------------------------------------------------

_RE_FIELD_TRUE = re.compile(r"\b([A-Za-z_][A-Za-z0-9_]*)\s*(?:=|set to)\s*true\b", re.IGNORECASE)
_RE_FIELD_FALSE = re.compile(r"\b([A-Za-z_][A-Za-z0-9_]*)\s*(?:=|set to)\s*false\b", re.IGNORECASE)
_RE_FIELD_SET = re.compile(
    r"\b([A-Za-z_][A-Za-z0-9_]*)\s+(?:set|updated|recorded|filled)\b", re.IGNORECASE
)
_RE_RANGE = re.compile(
    r"\(\s*1\s*[-–]\s*(\d+)\s*\)|options?\s+1\s*(?:,\s*\d+)*\s*,\s*(\d+)",
    re.IGNORECASE)

_TARGET_WORDS = re.compile(
    r"\b(eliminat\w*|protect\w*|investigat\w*|target\w*|kill\w*|challeng\w*|raid\w*|steal\w*|rob\w*)\b",
    re.IGNORECASE,
)
_NIGHT_RESOLVE_RE = re.compile(
    r"(resolve|apply)[^.]*night|night[^.]*(resolution|resolve)|kill attempt[^.]*protection",
    re.IGNORECASE,
)
_VOTE_ELIM_RE = re.compile(
    r"eliminat\w*[^.]*\bvot\w+|\bvot\w+[^.]*eliminat\w*", re.IGNORECASE
)
_KILL_PHASE_RE = re.compile(r"\b(eliminate|kill|target to eliminate|choose\w* .*target)\b", re.IGNORECASE)
_PROTECT_PHASE_RE = re.compile(r"\bprotect", re.IGNORECASE)
_SCORE_RE = re.compile(r"\b(scor\w+|tally points|points)\b", re.IGNORECASE)
_ROTATE_RE = re.compile(
    r"\bround start\b|\b(select|confirm|choose|rotate|pick)\w*(?:/\w+)?[^.;]*\bspeaker\b",
    re.IGNORECASE,
)
_ROLE_ASSIGN_RE = re.compile(r"\b(assign\w*)\b[^.]*\brole|role assignment", re.IGNORECASE)
# P12 requires an everyone-subject ("each/all/every player(s) collects K
# <field>") — "the winner receives 3 coins" must NOT pay the whole room
_INCOME_RE = re.compile(
    r"\b(?:each|all|every)\s+(?:alive\s+|living\s+)?players?\s+"
    r"(?:gain|collect|receive|earn)s?\s+(\d+)\s+([A-Za-z_]+)",
    re.IGNORECASE,
)
def iter_text_income(description: str) -> list[tuple[str, int]]:
    """Public accessor for the P12 income-sentence miner: every
    ("each/all/every player(s) gains K <word>") match in *description* as
    (word_lowercase, amount) pairs, in order.  dslgen/rules.py builds its
    double-pay guard and income-preservation on this — keep it the single
    source of truth for what counts as a minable income sentence."""
    return [(m.group(2).lower(), int(m.group(1)))
            for m in _INCOME_RE.finditer(description)]


_RAID_RE = re.compile(
    r"\b(raid\w*|steal\w*|rob(?:s|bed|bing)?|plunder\w*|loot\w*)\b", re.IGNORECASE
)
_CHALLENGE_RE = re.compile(r"\bchalleng", re.IGNORECASE)
_MINORITY_RE = re.compile(
    r"\b(minority|odd one out|smallest group|least[- ]picked|fewest pick)", re.IGNORECASE
)
_AUCTION_RE = re.compile(
    r"\b(auction|highest\s+bid\w*|winning\s+bid|sealed[- ]bid|top\s+bidder)",
    re.IGNORECASE,
)
_RESOURCE_NAME_RE = re.compile(
    r"coin|gold|credit|money|chip|resource|token", re.IGNORECASE
)
_LIVES_NAME_RE = re.compile(r"influence|lives|hearts?|health|credibility", re.IGNORECASE)
_ROLE_REVEAL_RE = re.compile(r"role.*reveal|reveal.*role", re.IGNORECASE)
# P17: explicit winner rules in terminal-phase text
_OVER_SCORE_RE = re.compile(
    r"\brichest\b|most\s+([A-Za-z_]+)|highest\s+([A-Za-z_]+)"
    r"|top\s+scorer", re.IGNORECASE
)
_OVER_SURVIVOR_RE = re.compile(
    r"last\s+\w+\s+standing|sole\s+survivor|last\s+survivor", re.IGNORECASE
)
_OVER_TEAM_RE = re.compile(r"(?:winning|surviving)\s+team|team\s+wins", re.IGNORECASE)
_REVEAL_TRUE_RE = re.compile(r"\(\s*([A-Za-z_][A-Za-z0-9_]*)\s+set to true\s*\)", re.IGNORECASE)


def _safe_pred(src: str) -> Pred:
    try:
        return parse_predicate(src)
    except PredicateError:
        return TRUE


def _phase_text(ph: PhaseSpec) -> str:
    parts = [ph.name, ph.description, ph.completion.description, ph.completion.target_description]
    parts.extend(a.description for a in ph.actions)
    return " \n ".join(parts)


def _predecessors(spec: GameSpec) -> dict[int, set[int]]:
    preds: dict[int, set[int]] = {pid: set() for pid in spec.phases}
    for pid, ph in spec.phases.items():
        if ph.next_id is not None:
            preds[ph.next_id].add(pid)
        for b in ph.branches:
            preds[b.phase_id].add(pid)
    return preds


def _action_chain_before(spec: GameSpec, pid: int, preds: dict[int, set[int]]) -> list[int]:
    """Maximal unique-predecessor chain of player_action phases ending at pid."""
    chain: list[int] = []
    cur = pid
    seen = {pid}
    while True:
        ps = preds.get(cur, set())
        if len(ps) != 1:
            break
        prev = next(iter(ps))
        if prev in seen:
            break
        if spec.phases[prev].completion.type is not CompletionType.PLAYER_ACTION:
            break
        chain.append(prev)
        seen.add(prev)
        cur = prev
    chain.reverse()
    return chain


# ---------------------------------------------------------------------------
# Record programs
# ---------------------------------------------------------------------------


def build_record_program(ph: PhaseSpec, spec: GameSpec, layout: StateLayout) -> RecordProgram:
    if ph.completion.type is not CompletionType.PLAYER_ACTION:
        return RecordProgram()

    text = ph.completion.description
    decl = spec.declaration
    known = set(decl.field_names())

    set_true: list[str] = []
    set_false: list[str] = []
    write_num: Optional[str] = None
    write_pdict: Optional[tuple[str, str]] = None
    mark_odict: Optional[str] = None

    mentioned: list[str] = []
    for m in _RE_FIELD_TRUE.finditer(text):
        f = m.group(1)
        if f in known and layout.slot(f).bank == BANK_BOOL:
            set_true.append(f)
            mentioned.append(f)
    for m in _RE_FIELD_FALSE.finditer(text):
        f = m.group(1)
        if f in known and layout.slot(f).bank == BANK_BOOL:
            set_false.append(f)
            mentioned.append(f)
    for m in _RE_FIELD_SET.finditer(text):
        f = m.group(1)
        if f not in known or f in mentioned:
            continue
        bank = layout.slot(f).bank
        if bank == BANK_NUM and write_num is None:
            write_num = f
        elif bank == BANK_PDICT and write_pdict is None:
            # value source: the string field whose vocab covers the pdict's
            src = ""
            pvocab = set(v.lower() for v in layout.slot(f).vocab if v)
            for g in decl.fields:
                s = layout.get(g.name)
                if s is not None and s.bank == BANK_STR:
                    svocab = set(v.lower() for v in s.vocab if v)
                    if pvocab and pvocab <= svocab:
                        src = g.name
                        break
            write_pdict = (f, src)
        elif bank == BANK_ODICT and mark_odict is None:
            mark_odict = f
        elif bank == BANK_BOOL:
            set_true.append(f)
        mentioned.append(f)

    # choice kind (P2): text-input tools -> SUBMIT; option range on the
    # written num field -> OPTION; target-verb phases -> TARGET. A P18
    # choice-kind hint (`mechanics: [target]` / `[{option: 4}]` /
    # `[submit]`) outranks all of it — the detection verbs are English
    # vocabulary and an alien phrasing ("points at a soul") must be
    # pinnable without rewording the game.
    tools = {t for a in ph.actions for t in a.tools}
    kind = ChoiceKind.NONE
    cmax = 0
    kind_hint = next(
        ((h, a) for h, a in ph.mechanic_hints if h in CHOICE_HINTS), None)
    if kind_hint is not None:
        hname, harg = kind_hint
        kind = ChoiceKind[hname.upper()]
        if hname == "option" and harg is not None:
            try:
                cmax = int(harg)
            except (TypeError, ValueError):
                cmax = 0
    elif "createTextInputPanel" in tools and write_num is None:
        kind = ChoiceKind.SUBMIT
    else:
        if write_num is not None:
            fld = decl.field(write_num)
            rng = _RE_RANGE.search(f"{fld.description} {ph.description} " + " ".join(a.description for a in ph.actions))
            if rng:
                kind = ChoiceKind.OPTION
                cmax = int(rng.group(1) or rng.group(2))
        if kind is ChoiceKind.NONE:
            if _TARGET_WORDS.search(_phase_text(ph)) or write_pdict is not None:
                kind = ChoiceKind.TARGET
            elif write_num is not None:
                kind = ChoiceKind.OPTION
                cmax = 0  # 0 => engines bound the option by room size (P2)
            else:
                kind = ChoiceKind.SUBMIT

    return RecordProgram(
        choice_kind=kind,
        choice_max=cmax,
        set_bool_true=tuple(dict.fromkeys(set_true)),
        set_bool_false=tuple(dict.fromkeys(set_false)),
        write_choice_num=write_num,
        write_pdict=write_pdict,
        mark_odict=mark_odict,
    )


# ---------------------------------------------------------------------------
# Role assignment (P10)
# ---------------------------------------------------------------------------


def _build_role_assign(spec: GameSpec, layout: StateLayout) -> Optional[RoleAssign]:
    decl = spec.declaration
    if "role" not in set(decl.field_names()) or not decl.roles:
        return None
    # dedupe the declared role list by name: a generator that declares
    # "Bandit" twice ("two bandits") must not double-count example rows or
    # emit the role twice in role_counts (that compounded into an
    # every-seat-a-killer multiset); duplicated CAST sizes live in
    # players_example rows, not in the declaration list
    uniq_roles = list({r.name: r for r in decl.roles}.values())
    # example counts per role
    counts: dict[str, int] = {r.name: 0 for r in uniq_roles}
    rows_by_role: dict[str, list[dict]] = {r.name: [] for r in uniq_roles}
    for row in decl.players_example.values():
        rname = row.get("role")
        if isinstance(rname, str):
            for r in uniq_roles:
                if r.name.lower() == rname.lower():
                    counts[r.name] += 1
                    rows_by_role[r.name].append(row)
    if all(c == 0 for c in counts.values()):
        for r in uniq_roles:  # no example: one of each, first role fills
            counts[r.name] = 1
    maxc = max(counts.values())
    filler = next(r.name for r in uniq_roles if counts[r.name] == maxc)

    # constant-per-role field settings (skip role itself, names, cumulative)
    skip = {"role", "name"}
    role_fields: list[tuple[str, tuple[tuple[str, object], ...]]] = []
    for r in uniq_roles:
        rows = rows_by_role[r.name]
        settings: list[tuple[str, object]] = []
        if rows:
            for f in decl.fields:
                if f.name in skip or layout.slot(f.name).bank not in (BANK_BOOL, BANK_NUM, BANK_STR):
                    continue
                vals = {repr(row.get(f.name)) for row in rows if f.name in row}
                if len(vals) == 1:
                    # from a row that HAS the field — rows[0] may omit it,
                    # which would set the literal None ('None' for strings,
                    # False for bools) instead of the constant
                    v = next(row[f.name] for row in rows if f.name in row)
                    # only set if it differs across roles somewhere
                    others = {
                        repr(orow.get(f.name))
                        for oname, orows in rows_by_role.items()
                        if oname != r.name
                        for orow in orows
                    }
                    if others and others != vals:
                        settings.append((f.name, v))
        role_fields.append((r.name, tuple(settings)))

    return RoleAssign(
        role_field="role",
        role_counts=tuple((r.name, counts[r.name]) for r in uniq_roles),
        role_fields=tuple(role_fields),
        filler_role=filler,
    )


def role_multiset(ra: RoleAssign, n_players: int) -> list[str]:
    """P10: concrete role list (unpermuted) for n players."""
    return FX.deal_multiset(ra.role_counts, ra.filler_role, n_players)


def role_assign_program(ra: RoleAssign, layout: StateLayout) -> "FX.Program":
    """Lower a RoleAssign to an effect-IR program (round 4: the bespoke
    P10 kernels are deleted from all four executors; role assignment is a
    `deal` statement plus guarded constant-per-role writes).

    Block 1 deals the role multiset (salt 0 — bit-identical to the
    retired kernel); block 2 reads the just-dealt role and applies the
    constant-per-role example fields, exactly the retired kernel's
    role_settings pass."""
    block1 = (FX.SDeal(ra.role_field, counts=ra.role_counts,
                       filler=ra.filler_role),)
    sets: list = []
    for rname, fields in ra.role_fields:
        guard = FX.ECmp("eq", FX.EField(ra.role_field), FX.EStrLit(rname))
        for fname, val in fields:
            s = layout.slot(fname)
            if s.bank == BANK_BOOL:
                sets.append(FX.SSet(fname, FX.EConst(1 if val else 0),
                                    where=guard))
            elif s.bank == BANK_NUM:
                try:
                    iv = int(val)
                except (TypeError, ValueError):
                    continue
                sets.append(FX.SSet(fname, FX.EConst(iv), where=guard))
            elif s.bank == BANK_STR:
                sets.append(FX.SSet(fname, FX.EStrLit(str(val)), where=guard))
    return (block1, tuple(sets)) if sets else (block1,)


def resolve_deals(program: "FX.Program", spec: GameSpec,
                  layout: StateLayout) -> "FX.Program":
    """Fill declared `deal` statements' (counts, filler) from
    players_example (P10). `deal role` with a declared role list resolves
    exactly like the analyzer's Role Assignment detection (declaration
    order + example counts, surplus to the most-common role); any other
    string field resolves to its example value counts in first-appearance
    order, surplus to the most-common value (ties to first appearance).
    Loud-or-correct: raises EffectError when no example row gives the
    field a value."""
    if not any(isinstance(st, FX.SDeal)
               for block in program for st in block):
        return program
    decl = spec.declaration
    out_blocks = []
    for block in program:
        out: list = []
        for st in block:
            if not isinstance(st, FX.SDeal) or st.counts is not None:
                out.append(st)
                continue
            if st.field == "role" and decl.roles:
                ra = _build_role_assign(spec, layout)
                if ra is not None:
                    out.append(dataclasses.replace(
                        st, counts=ra.role_counts, filler=ra.filler_role))
                    continue
            counts: dict[str, int] = {}
            for row in decl.players_example.values():
                v = row.get(st.field)
                if isinstance(v, str) and v:
                    for k in counts:
                        if k.lower() == v.lower():
                            counts[k] += 1
                            break
                    else:
                        counts[v] = 1
            if not counts:
                raise FX.EffectError(
                    f"deal target {st.field!r} has no players_example "
                    "values to deal — every example row must give the "
                    "field a value so the multiset is defined")
            filler = max(counts.items(), key=lambda kv: kv[1])[0]
            out.append(dataclasses.replace(
                st, counts=tuple(counts.items()), filler=filler))
        out_blocks.append(tuple(out))
    return tuple(out_blocks)


def splitmix32(x: int) -> int:
    """Deterministic 32-bit mixer used for backend-independent permutations
    (identical results in pure Python and in int32 jax ops)."""
    x = (x + 0x9E3779B9) & 0xFFFFFFFF
    z = x
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
    return (z ^ (z >> 16)) & 0xFFFFFFFF


def role_permutation(seed: int, n_players: int) -> list[int]:
    """P10: player p receives role_multiset[perm[p]]; perm = argsort of
    per-player hash keys (ties by player index)."""
    keys = [(splitmix32((seed * 0x100 + p) & 0xFFFFFFFF), p) for p in range(n_players)]
    order = sorted(range(n_players), key=lambda p: keys[p])
    # order[i] = player holding rank i; invert: perm[player] = rank
    perm = [0] * n_players
    for rank, player in enumerate(order):
        perm[player] = rank
    return perm


# ---------------------------------------------------------------------------
# Full analysis
# ---------------------------------------------------------------------------


def _round_scoped_fields(spec: GameSpec, layout: StateLayout, programs: dict[int, RecordProgram],
                         cumulative: set[str]) -> tuple[list[str], list[str], list[str], list[str]]:
    """Fields written by record programs / reveals => reset on rotation (P9)."""
    bools: list[str] = []
    nums: list[str] = []
    odicts: list[str] = []
    pdicts: list[str] = []
    for rp in programs.values():
        for f in rp.set_bool_true + rp.set_bool_false:
            if f not in bools:
                bools.append(f)
        if rp.write_choice_num and rp.write_choice_num not in cumulative and rp.write_choice_num not in nums:
            nums.append(rp.write_choice_num)
        if rp.mark_odict and rp.mark_odict not in odicts:
            odicts.append(rp.mark_odict)
        if rp.write_pdict and rp.write_pdict[0] not in pdicts:
            pdicts.append(rp.write_pdict[0])
    # reveal-style bools set by UI phases
    for ph in spec.phases.values():
        m = _REVEAL_TRUE_RE.search(ph.completion.description)
        if m and layout.get(m.group(1)) is not None and layout.slot(m.group(1)).bank == BANK_BOOL:
            if m.group(1) not in bools:
                bools.append(m.group(1))
    return bools, nums, odicts, pdicts


# P18: explicit DSL mechanic declarations (`mechanics:` key on a phase) —
# the synonym-proof escape hatch from keyword detection. Maps hint name ->
# the mechanic class it must produce (dslgen/validate.py enforces that every
# hint results in an attached mechanic of its class, loudly).
HINTS: dict[str, type] = {
    "role_assignment": RoleAssign,
    "night_resolution": NightResolve,
    "vote_elimination": VoteElim,
    "speaker_rotation": SpeakerRotate,
    "bluff_challenge": BluffChallenge,
    "minority_score": MinorityScore,
    "auction": AuctionScore,
    "raid": ResourceRaid,
    "income": ResourceIncome,
    "guess_score": GuessScore,
    "winner": GameOver,
    "reveal": SetBoolAll,
    "effects": Effects,
}
# anchor hints: they mark an action phase as a night-resolution input rather
# than producing a mechanic on their own phase; validated as "consumed by
# some NightResolve" instead of by class
ANCHOR_HINTS = frozenset({"kill", "protect"})
# choice-kind hints: pin RecordProgram.choice_kind on a player_action phase
# (P2) instead of relying on target-verb/tool detection
CHOICE_HINTS = frozenset({"target", "option", "submit"})
# the mutually-exclusive resolution family: hinting any of these disables
# text triggers for the whole family on that phase. An `effects` program is
# itself a resolution declaration — a phase carrying one gets exactly its
# declared program (declaration outranks vocabulary, P18/P20).
_RESOLUTION_HINTS = frozenset(
    {"night_resolution", "vote_elimination", "bluff_challenge",
     "minority_score", "auction", "raid", "effects"})


def analyze(spec: GameSpec, layout: StateLayout) -> dict[int, PhaseProgram]:
    """Attach a PhaseProgram to every phase (the determinized referee)."""
    decl = spec.declaration
    fields = set(decl.field_names())
    preds_map = _predecessors(spec)

    records = {pid: build_record_program(ph, spec, layout) for pid, ph in spec.phases.items()}

    role_assign = _build_role_assign(spec, layout)

    # identify cumulative fields (incremented by scoring): total/score/rounds
    cumulative = {
        f.name
        for f in decl.fields
        if layout.slot(f.name).bank == BANK_NUM
        and re.search(r"total|cumulat|score|rounds", f.name + " " + f.description, re.IGNORECASE)
    }

    rs_bools, rs_nums, rs_odicts, rs_pdicts = _round_scoped_fields(spec, layout, records, cumulative)

    # P15: role-reveal-on-death fields (e.g. werewolf's role_revealed — the
    # reference referee reveals roles on elimination); matched by name only,
    # never lie_revealed-style round flags
    reveal_bools = tuple(
        f.name for f in decl.fields
        if layout.slot(f.name).bank == BANK_BOOL and _ROLE_REVEAL_RE.search(f.name)
    )

    def _num_field_for(word: str) -> Optional[str]:
        """Exact-ish num-field resolution: word, word+'s', word-'s'."""
        w = word.lower()
        for cand in (w, w + "s", w[:-1] if w.endswith("s") else w):
            if cand in fields and layout.slot(cand).bank == BANK_NUM:
                return cand
        return None

    # resource / lives fields for P13/P14 (by-name conventions)
    resource_field = next(
        (f.name for f in decl.fields
         if layout.slot(f.name).bank == BANK_NUM and _RESOURCE_NAME_RE.search(f.name)),
        None,
    )
    lives_field = next(
        (f.name for f in decl.fields
         if layout.slot(f.name).bank == BANK_NUM and _LIVES_NAME_RE.search(f.name)),
        None,
    )
    score_like_field = next(
        (f.name for f in decl.fields
         if layout.slot(f.name).bank == BANK_NUM
         and re.search(r"total_score|scores?$|points?$", f.name, re.IGNORECASE)),
        None,
    )

    # guess-score field resolution (requires a speaker flag: the mechanic is
    # speaker-centric, and lowering a missing field would fail)
    gs: Optional[GuessScore] = None
    if {"lie_index", "vote_choice", "total_score", "is_speaker"} <= fields:
        gs = GuessScore(
            speaker_field="is_speaker",
            lie_field="lie_index",
            vote_field="vote_choice",
            voted_field="has_voted" if "has_voted" in fields else "",
            score_field="total_score",
            rounds_field="rounds_as_speaker" if "rounds_as_speaker" in fields else None,
        )

    # team metadata for GameOver (P11)
    team_field = "team" if "team" in fields else ""
    team_counts: dict[str, int] = {}
    if team_field:
        for row in decl.players_example.values():
            t = row.get(team_field)
            if isinstance(t, str) and t:
                team_counts[t.lower()] = team_counts.get(t.lower(), 0) + 1
    team_order = tuple(sorted(team_counts, key=lambda t: (team_counts[t], t)))
    if team_field and not team_order:
        # no players_example: mine team values from audience criteria /
        # field examples; minority-first = teams whose name matches a
        # declared role (the 'evil' faction convention)
        vals: list[str] = []
        ex = decl.field(team_field).example
        if isinstance(ex, str) and ex:
            vals.append(ex.lower())
        for g in decl.audience_groups:
            if re.search(rf"\b{team_field}\b", g.selection_criteria):
                for m in re.findall(r"'([^']+)'|\"([^\"]+)\"", g.selection_criteria):
                    v = (m[0] or m[1]).lower()
                    if v and v not in vals:
                        vals.append(v)
        role_names = {r.name.lower() for r in decl.roles}

        def is_rolelike(team: str) -> bool:
            from portbench.reference.gamespec.conditions import _singularize

            s = _singularize(team)
            return s in role_names or team in role_names

        team_order = tuple(sorted(vals, key=lambda t: (not is_rolelike(t), t)))
    score_field = ""
    for cand in ("total_score", "score", "points"):
        if cand in fields and layout.slot(cand).bank == BANK_NUM:
            score_field = cand
            break
    if not score_field and resource_field and not lives_field:
        # resource games (P12/P13) are won on the resource count
        score_field = resource_field
    # P11 mode precedence: team > survivor (alive field, eliminations, no
    # teams) > score > none. Survivor = last player standing wins.
    has_elimination = "is_alive" in fields
    if team_field and team_order:
        game_over = GameOver(mode="team", team_field=team_field, team_order=team_order)
    elif has_elimination and not score_field:
        game_over = GameOver(mode="survivor")
    elif score_field:
        game_over = GameOver(mode="score", score_field=score_field)
    else:
        game_over = GameOver(mode="none")

    def _terminal_game_over(ph: PhaseSpec) -> GameOver:
        """P17: a terminal phase naming its own winner rule overrides the
        game-wide default — composed games end at different terminals with
        different modes (e.g. team extinction vs richest purse). An explicit
        `mechanics: [{winner: ...}]` hint (P18) outranks the text."""
        for hname, harg in ph.mechanic_hints:
            if hname != "winner":
                continue
            if isinstance(harg, tuple):  # {winner: {score: field}}
                kv = dict(harg)
                if "score" not in kv:
                    raise MechanicHintError(
                        f"winner mapping {sorted(kv)} has no 'score' key — "
                        "declare {winner: {score: <num field>}} or a mode "
                        "string (team/survivor/richest)")
                f = kv.get("score")
                f = f if (f in fields and layout.slot(f).bank == BANK_NUM) else None
                f = f or score_like_field or resource_field
                if f:
                    return GameOver(mode="score", score_field=f)
            elif harg in ("richest", "score", "highest_score"):
                f = score_like_field or resource_field or score_field
                if f:
                    return GameOver(mode="score", score_field=f)
            elif harg == "survivor" and has_elimination:
                return GameOver(mode="survivor")
            elif harg == "team" and team_field and team_order:
                return GameOver(mode="team", team_field=team_field,
                                team_order=team_order)
        text = ph.name + " " + ph.description
        m = _OVER_SCORE_RE.search(text)
        if m:
            # a named "most/highest <word>" must resolve to a declared num
            # field (or a generic score word) to claim score mode — falling
            # back on an unresolved name let prose like "the team with the
            # most members standing" hijack a team/survivor terminal
            named = ((m.group(1) or m.group(2)) or "").lower()
            if named and named not in ("score", "points", "scorer"):
                f = _num_field_for(named)
            else:
                f = score_like_field or resource_field
            if f:
                return GameOver(mode="score", score_field=f)
        if _OVER_SURVIVOR_RE.search(text) and has_elimination:
            return GameOver(mode="survivor")
        if _OVER_TEAM_RE.search(text) and team_field and team_order:
            return GameOver(mode="team", team_field=team_field, team_order=team_order)
        return game_over

    out: dict[int, PhaseProgram] = {}
    for pid, ph in spec.phases.items():
        mechanics: list[Mechanic] = []
        text = ph.name + " \n " + ph.description
        # P18: explicit `mechanics:` hints force attachment regardless of
        # vocabulary. Within the mutually-exclusive resolution family, any
        # hint disables text triggers so a hinted phase gets exactly the
        # declared resolution (text that happens to mention "night" cannot
        # shadow an explicit vote_elimination).
        hint_names = {h for h, _ in ph.mechanic_hints}
        res_hints = hint_names & _RESOLUTION_HINTS

        def _want(hint: str, text_hit) -> bool:
            if res_hints:
                return hint in res_hints
            return bool(text_hit)

        def _hint_args(hint: str) -> dict:
            """String kwargs of a parameterized resolution hint
            (`{vote_elimination: {protect: ..., weight: ...}}`)."""
            for h, harg in ph.mechanic_hints:
                if h == hint and isinstance(harg, tuple):
                    return {str(k): str(v) for k, v in harg}
            return {}

        if role_assign is not None and (
                _ROLE_ASSIGN_RE.search(text) or "role_assignment" in hint_names):
            mechanics.append(role_assign)

        # Rotation phases are UI phases that *prepare* the round — never the
        # player_action phases where the speaker themselves acts.
        rotate_hit = (_ROTATE_RE.search(ph.name) or _ROTATE_RE.search(ph.description)
                      or "speaker_rotation" in hint_names)
        if (
            rotate_hit
            and ph.completion.type is not CompletionType.PLAYER_ACTION
            and "is_speaker" in fields
            and "rounds_as_speaker" in fields
        ):
            mechanics.append(
                SpeakerRotate(
                    speaker_field="is_speaker",
                    rounds_field="rounds_as_speaker",
                    can_vote_field="can_vote" if "can_vote" in fields else None,
                    reset_bools=tuple(f for f in rs_bools if f != "is_speaker"),
                    reset_nums=tuple(rs_nums),
                    reset_odicts=tuple(rs_odicts),
                    reset_pdicts=tuple(rs_pdicts),
                )
            )

        if _want("night_resolution", _NIGHT_RESOLVE_RE.search(text)):
            chain = _action_chain_before(spec, pid, preds_map)

            # night anchors are ALSO vocabulary-detected, so they honor
            # their own P18 hints: `mechanics: [kill]` / `[protect]` on the
            # action phase marks it regardless of phrasing
            def _anchor(c: int, hint: str) -> bool:
                return hint in {h for h, _ in spec.phases[c].mechanic_hints}

            kill_ph = [c for c in chain
                       if (_anchor(c, "kill")
                           or (_KILL_PHASE_RE.search(_phase_text(spec.phases[c]))
                               and not _anchor(c, "protect")
                               and not _PROTECT_PHASE_RE.search(spec.phases[c].name)))]
            prot_ph = [c for c in chain
                       if (_anchor(c, "protect")
                           or _PROTECT_PHASE_RE.search(_phase_text(spec.phases[c])))
                       and c not in kill_ph]
            if kill_ph:
                # kill_pred comes from the FIRST kill phase only — P7 pins
                # "kill target = plurality of the killer-phase choices"
                # (one killer phase per night). kill_ph often contains
                # text-matched false positives (gold-rush's Sheriff
                # investigation mentions elimination), so OR-ing every
                # matched phase's predicate would let investigators vote
                # kills; a true two-killer night needs per-phase declared
                # `mechanics: [{effects: ...}]` programs instead.
                kill_pred = _safe_pred(
                    spec.phases[kill_ph[0]].completion.target_condition)
                protect_pred = (
                    _safe_pred(spec.phases[prot_ph[0]].completion.target_condition) if prot_ph else TRUE
                )
                reset_bools: list[str] = []
                reset_nums: list[str] = []
                for c in chain:
                    rp = records[c]
                    reset_bools.extend(rp.set_bool_true + rp.set_bool_false)
                    if rp.write_choice_num:
                        reset_nums.append(rp.write_choice_num)
                mechanics.append(
                    NightResolve(
                        kill_phases=frozenset(kill_ph),
                        protect_phases=frozenset(prot_ph),
                        kill_pred=kill_pred,
                        protect_pred=protect_pred,
                        reset_bools=tuple(dict.fromkeys(reset_bools)),
                        reset_nums=tuple(dict.fromkeys(reset_nums)),
                        reveal_bools=reveal_bools,
                        protect=_hint_args("night_resolution").get(
                            "protect", ""),
                    )
                )
        elif _want("vote_elimination", _VOTE_ELIM_RE.search(ph.description + " " + ph.name)):
            chain = _action_chain_before(spec, pid, preds_map)
            vote_ph = [c for c in chain if records[c].choice_kind is ChoiceKind.TARGET]
            if vote_ph:
                vp = vote_ph[-1]
                ve_args = _hint_args("vote_elimination")
                mechanics.append(
                    VoteElim(
                        vote_phases=frozenset({vp}),
                        voter_pred=_safe_pred(spec.phases[vp].completion.target_condition),
                        reveal_bools=reveal_bools,
                        protect=ve_args.get("protect", ""),
                        weight=ve_args.get("weight", ""),
                    )
                )
        elif (_want("bluff_challenge", _CHALLENGE_RE.search(text))
              and ph.completion.type is not CompletionType.PLAYER_ACTION
              and lives_field and "role" in fields and decl.roles):
            # P14: bluff-challenge resolution — claims from the preceding
            # OPTION phase, challenges from the preceding TARGET phase
            chain = _action_chain_before(spec, pid, preds_map)
            claim_ph = [c for c in chain
                        if records[c].choice_kind is ChoiceKind.OPTION
                        and records[c].write_choice_num]
            chal_ph = [c for c in chain if records[c].choice_kind is ChoiceKind.TARGET]
            if claim_ph and chal_ph:
                mechanics.append(
                    BluffChallenge(
                        claim_field=records[claim_ph[-1]].write_choice_num,
                        challenge_phases=frozenset({chal_ph[-1]}),
                        claimant_pred=_safe_pred(
                            spec.phases[claim_ph[-1]].completion.target_condition),
                        challenger_pred=_safe_pred(
                            spec.phases[chal_ph[-1]].completion.target_condition),
                        role_field="role",
                        lives_field=lives_field,
                        reveal_bools=reveal_bools,
                    )
                )
        elif (_want("minority_score", _MINORITY_RE.search(text))
              and ph.completion.type is not CompletionType.PLAYER_ACTION
              and score_like_field):
            # P16: simultaneous reveal — picks from the preceding OPTION
            # phase's recorded field, smallest non-empty group scores
            chain = _action_chain_before(spec, pid, preds_map)
            pick_ph = [c for c in chain
                       if records[c].choice_kind is ChoiceKind.OPTION
                       and records[c].write_choice_num
                       and records[c].choice_max > 0]
            if pick_ph:
                rp0 = records[pick_ph[-1]]
                mechanics.append(
                    MinorityScore(
                        pick_field=rp0.write_choice_num,
                        picker_pred=_safe_pred(
                            spec.phases[pick_ph[-1]].completion.target_condition),
                        score_field=score_like_field,
                        n_options=rp0.choice_max,
                    )
                )
        elif (_want("auction", _AUCTION_RE.search(text))
              and ph.completion.type is not CompletionType.PLAYER_ACTION
              and resource_field):
            # P19: sealed-bid auction — bids from the preceding OPTION
            # phase's recorded num field; prize defaults to the declared
            # score-like field (distinct from the purse)
            chain = _action_chain_before(spec, pid, preds_map)
            bid_ph = [c for c in chain
                      if records[c].choice_kind is ChoiceKind.OPTION
                      and records[c].write_choice_num
                      and records[c].write_choice_num != resource_field]
            prize = (score_like_field
                     if score_like_field and score_like_field != resource_field
                     else None)
            if bid_ph and prize:
                mechanics.append(
                    AuctionScore(
                        bid_field=records[bid_ph[-1]].write_choice_num,
                        bidder_pred=_safe_pred(
                            spec.phases[bid_ph[-1]].completion.target_condition),
                        res_field=resource_field,
                        prize_field=prize,
                    )
                )
        elif (_want("raid", _RAID_RE.search(text))
              and ph.completion.type is not CompletionType.PLAYER_ACTION
              and resource_field):
            # P13: simultaneous raid resolution from the preceding TARGET phase
            chain = _action_chain_before(spec, pid, preds_map)
            raid_ph = [c for c in chain if records[c].choice_kind is ChoiceKind.TARGET]
            if raid_ph:
                mechanics.append(
                    ResourceRaid(
                        raid_phases=frozenset({raid_ph[-1]}),
                        raider_pred=_safe_pred(
                            spec.phases[raid_ph[-1]].completion.target_condition),
                        res_field=resource_field,
                    )
                )

        # P12: fixed income on non-action phases ("each player collects 1
        # coin"); an explicit {income: {field: n}} hint declares the gains
        # directly and works on any phase type. A parameterized hint
        # OVERRIDES text mining entirely (declaration outranks vocabulary —
        # merging would pay hint + prose amounts on phases stating both).
        gains: list[tuple[str, int]] = []
        for hname, harg in ph.mechanic_hints:
            if hname == "income" and isinstance(harg, tuple):
                for f, n in harg:
                    if (f in fields and layout.slot(f).bank == BANK_NUM
                            and (f, int(n)) not in gains):
                        gains.append((f, int(n)))
        income_declared = bool(gains)
        if not income_declared and (
                "income" in hint_names
                or (ph.completion.type is not CompletionType.PLAYER_ACTION
                    and "effects" not in hint_names)):
            for mm in _INCOME_RE.finditer(text):
                f = _num_field_for(mm.group(2))
                if f is not None and (f, int(mm.group(1))) not in gains:
                    gains.append((f, int(mm.group(1))))
        if gains:
            mechanics.append(ResourceIncome(gains=tuple(gains)))

        if (gs is not None
                and (_SCORE_RE.search(ph.name) or "guess_score" in hint_names)
                and ph.completion.type is not CompletionType.PLAYER_ACTION):
            mechanics.append(gs)

        m = _REVEAL_TRUE_RE.search(ph.completion.description)
        if m and m.group(1) in fields and layout.slot(m.group(1)).bank == BANK_BOOL:
            mechanics.append(SetBoolAll(fields=(m.group(1),)))
        for hname, harg in ph.mechanic_hints:
            if (hname == "reveal" and isinstance(harg, str) and harg in fields
                    and layout.slot(harg).bank == BANK_BOOL
                    and not any(isinstance(mc, SetBoolAll) and harg in mc.fields
                                for mc in mechanics)):
                mechanics.append(SetBoolAll(fields=(harg,)))

        # P20: declared effect programs — parsed and checked here, attached
        # before any terminal GameOver so winner evaluation sees their
        # writes. A malformed program must fail COMPILATION, not silently
        # attach nothing: the serving path (GameHost -> compile_game) never
        # runs dslgen/validate.py, so swallowing the EffectError here would
        # put a room in play whose resolution phase is a no-op — violating
        # the P20 loud-or-correct contract (SEMANTICS.md). validate_doc
        # still re-parses the hint to attach the error to the right line.
        for hname, harg in ph.mechanic_hints:
            if hname != "effects" or harg is None:
                continue
            lines = list(harg) if isinstance(harg, tuple) else [harg]
            try:
                prog = FX.parse_program(
                    lines, reserved=frozenset(fields))
                prog = resolve_deals(prog, spec, layout)
                FX.check_program(
                    prog, layout, frozenset(spec.phases),
                    has_alive="is_alive" in fields,
                )
            except FX.EffectError as e:
                raise FX.EffectError(
                    f"phase {pid} ({ph.name!r}): effects program rejected: {e}"
                ) from e
            mechanics.append(Effects(program=prog, reveal_bools=reveal_bools))

        if ph.is_terminal:
            # a DECLARED `over` statement IS the terminal rule (P17): the
            # default GameOver would run after it and overwrite the winner
            declared_over = any(
                isinstance(mc, Effects)
                and any(isinstance(s, FX.SOver) for b in mc.program for s in b)
                for mc in mechanics)
            if not declared_over:
                mechanics.append(_terminal_game_over(ph))

        out[pid] = PhaseProgram(phase_id=pid, record=records[pid], on_enter=tuple(mechanics))
    return out
