"""Programmatic DSL validator.

The reference validates generated DSLs by prompting an LLM with a 976-line
rule list (reference: agent/prompt/dsl_validation_node_prompt.txt:10-19,
agent/dsl_agent.py:303-371). Here the same contract is enforced as code:
structural rules, graph reachability/termination, predicate and branch
compilability, and engine-semantics warnings. Issues carry a severity so a
generation pipeline can auto-repair or reject.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from game_engine_tpu_torch.gamespec import conditions as C
from game_engine_tpu_torch.gamespec import effects as FXw
from game_engine_tpu_torch.gamespec.compile import compile_game
from game_engine_tpu_torch.gamespec.expr import PredicateError, parse_predicate
from game_engine_tpu_torch.gamespec.parser import parse_game_spec
from game_engine_tpu_torch.gamespec.schema import CompletionType, GameSpec

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Issue:
    severity: str
    where: str
    message: str

    def __str__(self):
        return f"[{self.severity}] {self.where}: {self.message}"


def validate_doc(doc: Any, name: str = "game") -> tuple[list[Issue], GameSpec | None]:
    issues: list[Issue] = []
    if not isinstance(doc, dict):
        return [Issue(ERROR, "root", "document is not a mapping")], None
    for key in ("declaration", "phases"):
        if key not in doc:
            issues.append(Issue(ERROR, "root", f"missing root key {key!r}"))
    if any(i.severity == ERROR for i in issues):
        return issues, None
    try:
        spec = parse_game_spec(doc, name=name)
    except Exception as e:  # noqa: BLE001 — malformed docs must become Issues,
        # not crashes (the generation pipeline auto-repairs or rejects on them)
        return issues + [Issue(ERROR, "parse", f"{type(e).__name__}: {e}")], None
    issues.extend(validate_spec(spec))
    return issues, spec


def validate_spec(spec: GameSpec) -> list[Issue]:
    issues: list[Issue] = []
    decl = spec.declaration

    # -- declaration ---------------------------------------------------------
    if not decl.fields:
        issues.append(Issue(ERROR, "declaration", "player_states has no fields"))
    if decl.min_players < 1:
        issues.append(Issue(ERROR, "declaration", "min_players must be >= 1"))
    if decl.is_multiplayer and decl.min_players < 2:
        issues.append(Issue(WARNING, "declaration", "multiplayer game with min_players < 2"))
    for g in decl.audience_groups:
        try:
            parse_predicate(g.selection_criteria)
        except PredicateError as e:
            issues.append(Issue(ERROR, f"audience_groups.{g.name}", f"bad selection_criteria: {e}"))

    # -- phase structure -------------------------------------------------------
    if 0 not in spec.phases:
        issues.append(Issue(ERROR, "phases", "phase 0 (Game Introduction) is required"))
    terminals = [p for p in spec.phases.values() if p.is_terminal]
    if not terminals:
        issues.append(Issue(ERROR, "phases", "no terminal phase (next_phase: null)"))

    for pid, ph in spec.phases.items():
        where = f"phases.{pid}"
        if not ph.actions:
            issues.append(Issue(WARNING, where, "phase has no actions"))
        elif ph.actions[0].tools[:1] != ("clearCanvas",):
            # first action must clear the canvas (reference:
            # dsl_phases_generation_prompt.txt:100-106)
            issues.append(Issue(WARNING, where, "first action should be clearCanvas"))
        if decl.tools:
            for a in ph.actions:
                for t in a.tools:
                    if t not in decl.tools and t not in ("clearCanvas", "markPlayerDead"):
                        issues.append(
                            Issue(WARNING, where, f"tool {t!r} missing from tools manifest")
                        )
        comp = ph.completion
        if comp.type is CompletionType.PLAYER_ACTION and comp.wait_for is None:
            issues.append(Issue(WARNING, where, "player_action phase without wait_for"))
        if comp.type is CompletionType.PLAYER_ACTION and not comp.target_condition:
            issues.append(
                Issue(ERROR, where, "player_action phase without target_players.condition")
            )
        if comp.target_condition:
            # parse once: syntax errors + undeclared field references
            try:
                from game_engine_tpu_torch.gamespec.expr import collect_atoms

                pred = parse_predicate(comp.target_condition)
                for atom in collect_atoms(pred):
                    if atom.field not in decl.field_names():
                        issues.append(
                            Issue(
                                WARNING,
                                where,
                                f"target condition references undeclared field {atom.field!r}",
                            )
                        )
            except PredicateError as e:
                issues.append(Issue(ERROR, where, f"bad target condition: {e}"))

    # -- graph: reachability + termination ---------------------------------------
    succ: dict[int, list[int]] = {}
    for pid, ph in spec.phases.items():
        outs = []
        if ph.next_id is not None:
            outs.append(ph.next_id)
        outs.extend(b.phase_id for b in ph.branches)
        succ[pid] = outs
    start = spec.start_phase_id
    reach = {start}
    stack = [start]
    while stack:
        cur = stack.pop()
        for nxt in succ.get(cur, []):
            if nxt not in reach:
                reach.add(nxt)
                stack.append(nxt)
    for pid in spec.phases:
        if pid not in reach:
            issues.append(Issue(WARNING, f"phases.{pid}", "unreachable from phase 0"))
    # termination: terminal reachable from every reachable phase
    term_ids = {p.id for p in terminals}
    can_end = set(term_ids)
    changed = True
    while changed:
        changed = False
        for pid, outs in succ.items():
            if pid not in can_end and any(o in can_end for o in outs):
                can_end.add(pid)
                changed = True
    for pid in reach:
        if pid not in can_end and spec.phases[pid] and pid not in term_ids:
            issues.append(Issue(ERROR, f"phases.{pid}", "cannot reach any terminal phase"))

    # -- branch condition compilability -------------------------------------------
    ctx = C.ConditionContext(spec)
    for pid, ph in spec.phases.items():
        for b in ph.branches:
            _, ok = C.compile_branch_condition(b.condition, ctx)
            if not ok:
                issues.append(
                    Issue(
                        WARNING,
                        f"phases.{pid}.next_phase",
                        f"branch condition not recognized (compiles to fallthrough): {b.condition!r}",
                    )
                )

    # -- engine compile smoke --------------------------------------------------------
    try:
        game = compile_game(spec)
    except Exception as e:  # noqa: BLE001 — anything here is a validator finding
        issues.append(Issue(ERROR, "compile", f"engine compilation failed: {e}"))
        return issues
    issues.extend(_semantic_gap_issues(spec, game))
    issues.extend(_vocab_issues(spec, game))
    return issues


def _vocab_issues(spec: GameSpec, game) -> list[Issue]:
    """String literals in predicates must resolve against the mined slot
    vocabulary (layout.py _string_vocab) or the comparison is constant in
    every executor: the field can never hold an unminable value, so `==`
    never fires and `!=` always does — silently, identically in all four
    executors, where parity tests can't see it. Make it loud here (the
    effect-IR path already rejects these in effects.check_program)."""
    from game_engine_tpu_torch.gamespec.expr import collect_atoms
    from game_engine_tpu_torch.gamespec.layout import BANK_PDICT, BANK_STR

    issues: list[Issue] = []

    def check(pred, where: str) -> None:
        try:
            atoms = collect_atoms(pred)
        except PredicateError:
            return  # parse/complexity problems are reported elsewhere
        for a in atoms:
            slot = game.layout.get(a.field)
            if slot is None or slot.bank not in (BANK_STR, BANK_PDICT):
                continue
            vals = a.value if isinstance(a.value, tuple) else (a.value,)
            for v in vals:
                if isinstance(v, str) and not any(
                        x.lower() == v.lower() for x in slot.vocab):
                    issues.append(Issue(
                        WARNING, where,
                        f"string literal {v!r} is not in the mined "
                        f"vocabulary of field {a.field!r} "
                        f"({', '.join(repr(x) for x in slot.vocab if x)}) — "
                        "the field can never hold this value, so the "
                        "comparison is constant",
                    ))

    for cp in game.phases:
        check(cp.target_pred,
              f"phases.{cp.dsl_id}.completion_criteria.target_players.condition")
    for g in spec.declaration.audience_groups:
        try:
            check(parse_predicate(g.selection_criteria),
                  f"audience_groups.{g.name}")
        except PredicateError:
            pass
    return issues


# -- silent-no-op detection -------------------------------------------------------
#
# Mechanic attachment is keyword-driven (gamespec/mechanics.py); a DSL using
# synonyms outside the analyzer's vocabulary ("expel" for vote-elimination,
# "ritual" for night resolution) would compile into a game where all four
# executors agree on silently missing semantics — parity tests can't catch
# it. These checks make the gap loud.

import re as _re

# verbs that claim a state change in a phase description
_STATE_CHANGE_RE = _re.compile(
    r"\b(eliminat\w*|expel\w*|banish\w*|exil\w*|execut\w*|lynch\w*|kill\w*|"
    r"murder\w*|dies?|death|reviv\w*|resolv\w*|tall\w*|scor\w*|award\w*|"
    r"assign\w*|rotat\w*|swap\w*|transfer\w*|steal\w*|deduct\w*|increment\w*|"
    r"gains?\b|loses?\b|points? (?:are|go)|update\w* [a-z_]+ state)",
    _re.IGNORECASE,
)
# fields the engine itself reads/writes regardless of phase programs
_IMPLICIT_FIELDS = frozenset({"name", "is_alive", "role", "team"})

# phases that *describe* mechanics rather than perform them: rule
# introductions and pure evaluation/branch hubs ("Check Win Conditions")
_DESCRIBES_ONLY_RE = _re.compile(
    r"^\s*(check\w*|evaluat\w*|determin\w*|decid\w*|review\w*|announc\w*|"
    r"display\w*|show\w*|introduc\w*|explain\w*)\b",
    _re.IGNORECASE,
)


def _pred_fields(pred) -> set[str]:
    from game_engine_tpu_torch.gamespec.expr import collect_atoms

    try:
        return {a.field for a in collect_atoms(pred)}
    except Exception:  # noqa: BLE001 — defensive: malformed pred ≠ crash
        return set()


def _guard_expr_fields(src: str) -> set[str]:
    """Fields read by a P6p/P6w guard/weight expression (usage accounting;
    a malformed expr is reported by the hint validator, not here)."""
    if not src:
        return set()
    from game_engine_tpu_torch.gamespec import effects as FXm

    try:
        return FXm.program_fields(((FXm.SKill(where=FXm.parse_expr(src)),),))
    except Exception:  # noqa: BLE001
        return set()


def _cond_fields(cond) -> set[str]:
    if isinstance(cond, C.CondAnd):
        return set().union(*(_cond_fields(c) for c in cond.items))
    if isinstance(cond, C.CountCmp):
        out = _pred_fields(cond.left)
        if not isinstance(cond.right, int):
            out |= _pred_fields(cond.right)
        return out
    if isinstance(cond, C.AllPresent):
        return _pred_fields(cond.pred)
    return set()


def _semantic_gap_issues(spec: GameSpec, game) -> list[Issue]:
    from game_engine_tpu_torch.gamespec import mechanics as M

    issues: list[Issue] = []
    decl = spec.declaration

    # phase-id registers consumed by later resolution mechanics: an action
    # phase that only feeds a register legitimately writes no fields
    consumed: set[int] = set()
    touched: set[str] = set(_IMPLICIT_FIELDS)
    for g in decl.audience_groups:
        try:
            touched |= _pred_fields(parse_predicate(g.selection_criteria))
        except PredicateError:
            pass

    for cp in game.phases:
        touched |= _pred_fields(cp.target_pred)
        for b in cp.branches:
            touched |= _cond_fields(b.cond)
        rp = cp.program.record
        touched |= set(rp.set_bool_true) | set(rp.set_bool_false)
        for f in (rp.write_choice_num, rp.mark_odict):
            if f:
                touched.add(f)
        if rp.write_pdict:
            touched |= {x for x in rp.write_pdict if x}
        for mech in cp.program.on_enter:
            if isinstance(mech, M.NightResolve):
                consumed |= set(mech.kill_phases) | set(mech.protect_phases)
                touched |= set(mech.reset_bools) | set(mech.reset_nums)
                touched |= set(mech.reveal_bools)
                touched |= _guard_expr_fields(mech.protect)
            elif isinstance(mech, M.VoteElim):
                consumed |= set(mech.vote_phases)
                touched |= _pred_fields(mech.voter_pred)
                touched |= set(mech.reveal_bools)
                touched |= _guard_expr_fields(mech.protect)
                touched |= _guard_expr_fields(mech.weight)
            elif isinstance(mech, M.ResourceIncome):
                touched |= {f for f, _ in mech.gains}
            elif isinstance(mech, M.ResourceRaid):
                consumed |= set(mech.raid_phases)
                touched.add(mech.res_field)
                touched |= _pred_fields(mech.raider_pred)
            elif isinstance(mech, M.BluffChallenge):
                consumed |= set(mech.challenge_phases)
                touched |= {mech.role_field, mech.lives_field, mech.claim_field}
                touched |= set(mech.reveal_bools)
            elif isinstance(mech, M.MinorityScore):
                touched |= {mech.pick_field, mech.score_field}
                touched |= _pred_fields(mech.picker_pred)
            elif isinstance(mech, M.AuctionScore):
                touched |= {mech.bid_field, mech.res_field, mech.prize_field}
                touched |= _pred_fields(mech.bidder_pred)
            elif isinstance(mech, M.GuessScore):
                touched |= {mech.speaker_field, mech.lie_field, mech.vote_field,
                            mech.score_field}
                touched |= {f for f in (mech.voted_field, mech.rounds_field) if f}
            elif isinstance(mech, M.SpeakerRotate):
                touched |= {mech.speaker_field, mech.rounds_field}
                touched |= {f for f in (mech.can_vote_field,) if f}
                touched |= set(mech.reset_bools) | set(mech.reset_nums)
                touched |= set(mech.reset_odicts) | set(mech.reset_pdicts)
            elif isinstance(mech, M.RoleAssign):
                touched.add(mech.role_field)
                for _, settings in mech.role_fields:
                    touched |= {f for f, _ in settings}
            elif isinstance(mech, M.SetBoolAll):
                touched |= set(mech.fields)
            elif isinstance(mech, M.GameOver):
                touched |= {f for f in (mech.team_field, mech.score_field) if f}
            elif isinstance(mech, M.Effects):
                from game_engine_tpu_torch.gamespec import effects as FXm

                touched |= FXm.program_fields(mech.program)
                consumed |= FXm.program_choice_phases(mech.program)
                touched |= set(mech.reveal_bools)

    for cp in game.phases:
        ph = spec.phases[cp.dsl_id]
        where = f"phases.{cp.dsl_id}"
        # P18: explicit mechanic hints must land — an unknown hint name or a
        # hint that produced no mechanic of its class is a hard error (the
        # whole point of `mechanics:` is loud-or-correct)
        for hname, _harg in ph.mechanic_hints:
            cls = M.HINTS.get(hname)
            if hname in M.CHOICE_HINTS:
                if ph.completion.type is not CompletionType.PLAYER_ACTION:
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        f"choice-kind hint {hname!r} requires a "
                        "player_action completion",
                    ))
                elif cp.program.record.choice_kind.name.lower() != hname:
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        f"choice-kind hint {hname!r} did not take effect "
                        f"(record compiled to "
                        f"{cp.program.record.choice_kind.name})",
                    ))
                elif hname == "option" and _harg is not None:
                    try:
                        want_max = int(_harg)
                    except (TypeError, ValueError):
                        issues.append(Issue(
                            ERROR, f"{where}.mechanics",
                            f"option hint argument {_harg!r} is not an "
                            "integer choice maximum",
                        ))
                    else:
                        if cp.program.record.choice_max != want_max:
                            issues.append(Issue(
                                ERROR, f"{where}.mechanics",
                                f"option hint requested max {want_max} but "
                                f"the record compiled to "
                                f"{cp.program.record.choice_max}",
                            ))
            elif hname in M.ANCHOR_HINTS:
                sets = [
                    (mech.kill_phases if hname == "kill" else mech.protect_phases)
                    for other in game.phases
                    for mech in other.program.on_enter
                    if isinstance(mech, M.NightResolve)
                ]
                if not any(cp.dsl_id in s for s in sets):
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        f"anchor {hname!r} is not consumed by any "
                        "night_resolution phase downstream",
                    ))
            elif (hname in ("vote_elimination", "night_resolution")
                  and isinstance(_harg, tuple) and _harg):
                # P6p/P6w: parameterized resolution hints — guard/weight
                # expressions must be valid IR over declared fields HERE,
                # not at room creation
                from game_engine_tpu_torch.gamespec import effects as FXm

                allowed = ({"protect", "weight"}
                           if hname == "vote_elimination" else {"protect"})
                args = {str(k): str(v) for k, v in _harg}
                for k in sorted(set(args) - allowed):
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        f"{hname} hint argument {k!r} unknown "
                        f"(allowed: {', '.join(sorted(allowed))})"))
                for k in sorted(set(args) & allowed):
                    try:
                        e = FXm.parse_expr(args[k])
                        FXm.check_program(
                            ((FXm.SKill(where=e),),), game.layout,
                            frozenset(spec.phases),
                            has_alive="is_alive" in decl.field_names())
                    except FXm.EffectError as err:
                        issues.append(Issue(
                            ERROR, f"{where}.mechanics",
                            f"{hname} {k} expression rejected: {err}"))
                if not any(isinstance(mech, M.HINTS[hname])
                           for mech in cp.program.on_enter):
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        f"parameterized {hname} hint did not attach"))
            elif hname == "effects":
                # P20: re-parse the program to attach the EffectError to the
                # exact phase path (the analyzer raises at compile time, so
                # reaching here means it parsed; this guards the attachment)
                from game_engine_tpu_torch.gamespec import effects as FXm

                lines = list(_harg) if isinstance(_harg, tuple) else [_harg]
                try:
                    prog = FXm.parse_program(
                        [str(x) for x in lines if x is not None],
                        reserved=frozenset(decl.field_names()))
                    # `deal` statements carry no multiset until resolved
                    # against players_example — same pre-check step the
                    # analyzer runs (mechanics.analyze)
                    prog = M.resolve_deals(prog, spec, game.layout)
                    FXm.check_program(
                        prog, game.layout, frozenset(spec.phases),
                        has_alive="is_alive" in decl.field_names(),
                    )
                except FXm.EffectError as e:
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        f"effects program rejected: {e}"))
                else:
                    if not any(isinstance(mech, M.Effects)
                               for mech in cp.program.on_enter):
                        issues.append(Issue(
                            ERROR, f"{where}.mechanics",
                            "effects program parsed but was not attached"))
            elif cls is None:
                issues.append(Issue(
                    ERROR, f"{where}.mechanics",
                    f"unknown mechanic {hname!r} (known: "
                    f"{', '.join(sorted(M.HINTS) + sorted(M.ANCHOR_HINTS) + sorted(M.CHOICE_HINTS))})",
                ))
            elif not any(isinstance(mech, cls) for mech in cp.program.on_enter):
                if hname == "winner" and any(
                        isinstance(mech, M.Effects)
                        and any(isinstance(s, FXw.SOver)
                                for b in mech.program for s in b)
                        for mech in cp.program.on_enter):
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        "winner hint is overridden by a declared `over` "
                        "statement in the same phase — remove one of them"))
                    continue
                issues.append(Issue(
                    ERROR, f"{where}.mechanics",
                    f"declared mechanic {hname!r} could not be attached — "
                    "its anchors are missing (e.g. no preceding action phase "
                    "records the required choice, or a named field is not a "
                    "declared field of the right type)",
                ))
            elif hname == "winner":
                # terminals carry a GameOver unless a declared `over`
                # statement took the terminal rule; verify the hinted MODE
                # won, and a named score field was honored verbatim
                want = {"survivor": "survivor", "team": "team"}.get(
                    _harg if isinstance(_harg, str) else "", "score")
                got = next((mech for mech in cp.program.on_enter
                            if isinstance(mech, M.GameOver)), None)
                if got is None:
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        "winner hint is overridden by a declared `over` "
                        "statement in the same phase — remove one of them"))
                elif got.mode != want:
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        f"winner hint requested {want!r} mode but the game "
                        f"resolves to {got.mode!r} (missing fields/teams for "
                        "the requested mode?)",
                    ))
                elif isinstance(_harg, tuple):
                    named = dict(_harg).get("score")
                    if named and got.score_field != named:
                        issues.append(Issue(
                            ERROR, f"{where}.mechanics",
                            f"winner hint named score field {named!r} but "
                            f"the game resolves on {got.score_field!r} "
                            f"({named!r} is not a declared num field?)",
                        ))
            elif hname == "reveal":
                # same-class SetBoolAll from text must not mask a hint whose
                # named field is wrong — the DECLARED field must be revealed
                if not (isinstance(_harg, str) and any(
                        isinstance(mech, M.SetBoolAll) and _harg in mech.fields
                        for mech in cp.program.on_enter)):
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        f"reveal hint names {_harg!r} but no reveal of that "
                        "field was attached (not a declared boolean field?)",
                    ))
            elif hname == "income" and isinstance(_harg, tuple):
                want_gains = set()
                bad = []
                for f, n in _harg:
                    try:
                        want_gains.add((f, int(n)))
                    except (TypeError, ValueError):
                        bad.append((f, n))
                got_gains = set().union(*(
                    set(mech.gains) for mech in cp.program.on_enter
                    if isinstance(mech, M.ResourceIncome)))
                if bad or got_gains != want_gains:
                    issues.append(Issue(
                        ERROR, f"{where}.mechanics",
                        f"income hint declared {sorted(want_gains | set(bad))} "
                        f"but the phase pays {sorted(got_gains)} (field not a "
                        "declared num field, or a non-integer amount?)",
                    ))
        rp = cp.program.record
        writes = bool(rp.set_bool_true or rp.set_bool_false or rp.write_choice_num
                      or rp.write_pdict or rp.mark_odict)
        text = " ".join([ph.name, ph.description, ph.completion.description])
        if (ph.completion.type is CompletionType.PLAYER_ACTION
                and not writes and cp.dsl_id not in consumed):
            issues.append(Issue(
                WARNING, where,
                "player action is never recorded: no state field is written "
                "and no resolution mechanic consumes this phase's choices "
                "(unrecognized completion vocabulary?)",
            ))
        if (not cp.terminal and not cp.program.on_enter
                and cp.index != game.start_index  # rule intros describe, not do
                and not _DESCRIBES_ONLY_RE.match(ph.name)
                and not _DESCRIBES_ONLY_RE.match(ph.description)
                # timer phases are pure pacing (discussion before a vote
                # naturally *mentions* the upcoming elimination)
                and ph.completion.type not in (CompletionType.PLAYER_ACTION,
                                               CompletionType.TIMER)
                and _STATE_CHANGE_RE.search(text)):
            issues.append(Issue(
                WARNING, where,
                "description implies a state change but no mechanic was "
                "attached — likely a synonym outside the analyzer vocabulary "
                f"(matched {_STATE_CHANGE_RE.search(text).group(0)!r})",
            ))
        # a conditional-looking branch that compiled to unconditional True
        # shadows every branch after it (first-match-wins, P5)
        for i, b in enumerate(cp.branches):
            if (isinstance(b.cond, C.AlwaysTrue)
                    and i < len(cp.branches) - 1
                    and not b.condition_text.startswith("<")  # synthesized fallback
                    and not _re.match(r"\s*(otherwise|else)\b",
                                      b.condition_text, _re.IGNORECASE)):
                issues.append(Issue(
                    WARNING, f"{where}.next_phase",
                    f"branch {b.condition_text!r} compiled to 'always' but is "
                    "not last — later branches are unreachable",
                ))

    for f in decl.fields:
        if f.name not in touched:
            issues.append(Issue(
                WARNING, f"declaration.player_states.{f.name}",
                "field is never read or written by any phase, predicate, "
                "mechanic or branch condition",
            ))
    return issues


def errors(issues: list[Issue]) -> list[Issue]:
    return [i for i in issues if i.severity == ERROR]
