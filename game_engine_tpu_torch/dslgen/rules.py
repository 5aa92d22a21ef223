"""Deterministic rule-sentence mining -> declared P20 effect programs.

The reference synthesizes arbitrary described mechanics by handing the
whole description to gpt-5 (reference: agent/dsl_agent.py:157-371); our
deterministic generator previously understood mechanics only as whole
archetypes plus mined parameters (win targets, income, pool sizes).  This
module narrows the novel-mechanic residual: a bounded grammar of English
HOUSE-RULE sentences compiles directly to effect-IR statements
(gamespec/effects.py) and is woven onto the generated archetype's
per-round check phase as a declared ``mechanics: [{effects: [...]}]``
program — so "every round, each player gains 1 curse; anyone who reaches
three or more curses is eliminated" becomes a real executable mechanic in
ANY archetype, without an external model.

Grammar (v1) — each family maps to one IR statement:

  gain          "every round, each player gains 2 gems"
                    -> ``gems += 2 where alive``
  catchup       "each round, every player with fewer than 3 coins
                 collects 1 coin"
                    -> ``coins += 1 where alive and coins < 3``
  leader_tax    "every round, the richest player loses 1 coin"
                    -> ``coins -= 1 where alive and seat == argmax(coins, alive)``
  threshold_kill "anyone who reaches 3 or more curses is eliminated"
                    -> ``kill where curses >= 3``   (needs is_alive)

Grammar v2 — four more families over the
SAME IR plus the P6p/P6w parameterized resolution hints:

  transfer      "every round, the richest player gives 1 coin to the
                 poorest player" / "...the poorest player steals 1 coin
                 from the richest player"
                    -> paired ``coins -=/+= 1 where ... seat ==
                       argmax/argmin(coins, alive)`` writes from one
                       snapshot (conserved; unclamped like leader_tax)
  protection    "players with 3 or more shields cannot be eliminated"
                    -> ``{vote_elimination|night_resolution:
                         {protect: shields >= 3}}`` hint args (and the
                       same guard appended to mined threshold kills)
  vote_weight   "the vote of a player with 2 or more badges counts
                 double"
                    -> ``{vote_elimination: {weight: if(badges >= 2,
                         2, 1)}}``
  one_shot      "at the start of the game, each player receives 5 coins"
                    -> ``coins += 5 where alive and coins_opening_grant
                       == 0`` + ``coins_opening_grant = 1`` (synthesized
                       once-flag; paid on the loop phase's first entry)

Nouns resolve to existing numeric player_states fields (word / word+'s' /
singular, plus the score-alias bank); an unresolved noun SYNTHESIZES a new
num field (default 0) exactly the way the market weave synthesizes
``coins`` — declared rules may introduce their own resources.

Pinned honesty properties:
  * mined sentences count as consumed in description_coverage;
  * every injected statement (and every skip) is reported as a NOTE so the
    caller sees exactly what the generator understood;
  * zero matches on any catalog game description (byte-pinned generator
    outputs stay byte-identical; tests/test_dslgen_rules.py guards this).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

_NUM_WORDS = {
    "one": 1, "two": 2, "three": 3, "four": 4, "five": 5, "six": 6,
    "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "a dozen": 12, "thirteen": 13, "fourteen": 14,
    "fifteen": 15, "sixteen": 16, "twenty": 20,
}
_NUM_RX = r"(\d+|" + "|".join(_NUM_WORDS) + r")"
_EVERY_ROUND = r"(?:each|every)\s+(?:round|turn|morning|day|night)\b,?\s+"
_PLAYERS = r"(?:each|every|all)\s+(?:alive\s+|living\s+|surviving\s+)?players?\s+"
_GAINS = r"(?:gain|collect|earn|receive)s?\s+"
_NOUN = r"([a-z_]+)"


def _num(tok: str) -> int:
    tok = tok.lower()
    return int(tok) if tok.isdigit() else _NUM_WORDS[tok]


# sentence families; every pattern must start with a round-cadence or
# player-threshold anchor so plain archetype prose ("collect 2 coins",
# "first to twelve points") can never match — those belong to the
# existing parameter miners, not to rule injection.
_GAIN_RX = re.compile(
    _EVERY_ROUND + _PLAYERS + _GAINS + _NUM_RX + r"\s+" + _NOUN,
    re.IGNORECASE)
_CATCHUP_RX = re.compile(
    _EVERY_ROUND
    + r"(?:each|every|all)\s+players?\s+(?:with|holding)\s+"
    + r"(?:fewer|less)\s+than\s+" + _NUM_RX + r"\s+" + _NOUN + r"\s+"
    + _GAINS + _NUM_RX + r"\s+" + _NOUN,
    re.IGNORECASE)
_LEADER_TAX_RX = re.compile(
    _EVERY_ROUND
    + r"the\s+(?:richest|leading|top)\s+player\s+"
    + r"(?:loses|pays|forfeits|drops)\s+" + _NUM_RX + r"\s+" + _NOUN,
    re.IGNORECASE)
_LEADER_TAX_TRAIL_RX = re.compile(
    r"the\s+(?:richest|leading|top)\s+player\s+"
    + r"(?:loses|pays|forfeits|drops)\s+" + _NUM_RX + r"\s+" + _NOUN
    + r"\s+(?:each|every)\s+(?:round|turn|morning|day|night)\b",
    re.IGNORECASE)
_KILL_RX = re.compile(
    r"(?:anyone|any\s+player|players?)\s+(?:who\s+)?"
    + r"(?:reach(?:es)?|holds?|has|have|collects?)\s+" + _NUM_RX
    + r"\s+(?:or\s+more\s+)?" + _NOUN
    + r"\s+(?:is|are|gets?)\s+(?:eliminated|knocked\s+out|killed|"
    + r"out\s+of\s+the\s+game)",
    re.IGNORECASE)

# -- grammar v2 families: transfers, protection, vote
# weighting, one-shot grants — each lowers to EXISTING IR constructs
# (argmax/argmin transfers; P6p/P6w parameterized resolution hints; a
# synthesized once-flag), no executor changes.
_LEADER_WORDS = r"(richest|leading|top|wealthiest)"
_TRAILER_WORDS = r"(poorest|last[- ]place|trailing|lowest)"
_EITHER_SEL = rf"(?:{_LEADER_WORDS}|{_TRAILER_WORDS})"
_TRANSFER_RX = re.compile(
    _EVERY_ROUND + r"the\s+" + _EITHER_SEL
    + r"\s+player\s+(?:gives|pays|hands)\s+" + _NUM_RX + r"\s+" + _NOUN
    + r"\s+to\s+the\s+" + _EITHER_SEL + r"\s+player",
    re.IGNORECASE)
_STEAL_RX = re.compile(
    _EVERY_ROUND + r"the\s+" + _EITHER_SEL
    + r"\s+player\s+(?:steals|takes)\s+" + _NUM_RX + r"\s+" + _NOUN
    + r"\s+from\s+the\s+" + _EITHER_SEL + r"\s+player",
    re.IGNORECASE)
_PROTECT_RX = re.compile(
    r"(?:any\s+player|anyone|players?)\s+(?:with|holding)\s+" + _NUM_RX
    + r"\s+or\s+more\s+" + _NOUN
    + r"\s+(?:cannot|can\s*not|can't)\s+be\s+"
    + r"(?:eliminated|voted\s+out|killed|banished)",
    re.IGNORECASE)
_WEIGHT_RX = re.compile(
    r"(?:the\s+)?votes?\s+(?:of|from)\s+(?:a|any|each|every)\s+player\s+"
    + r"(?:with|holding)\s+" + _NUM_RX + r"\s+or\s+more\s+" + _NOUN
    + r"\s+counts?\s+(?:double|twice)",
    re.IGNORECASE)
_WEIGHT2_RX = re.compile(
    r"(?:any\s+player|anyone|players?)\s+(?:with|holding)\s+" + _NUM_RX
    + r"\s+or\s+more\s+" + _NOUN
    + r"\s+counts?\s+(?:double|twice)\s+when\s+voting",
    re.IGNORECASE)
_ONESHOT_RX = re.compile(
    r"(?:at\s+the\s+start\s+of\s+the\s+game|(?:on|in)\s+the\s+first\s+"
    r"round(?:\s+only)?|once\s+at\s+the\s+start),?\s+"
    r"(?:each|every|all)\s+players?\s+" + _GAINS + _NUM_RX + r"\s+" + _NOUN,
    re.IGNORECASE)


def _sel_kind(leader_group: Optional[str], trailer_group: Optional[str]) -> str:
    """argmax for richest/leading/top, argmin for poorest/last-place."""
    return "max" if leader_group else "min"


# score-ish nouns share the archetypes' score fields rather than
# synthesizing a parallel resource
_SCORE_ALIASES = ("points", "score", "total_score", "victory_points")


@dataclasses.dataclass(frozen=True)
class MinedRule:
    kind: str                  # gain | catchup | leader_tax | threshold_kill
                               # | transfer | protection | vote_weight
                               # | one_shot
    noun: str                  # resource noun as written (lowercased)
    amount: int                # gain/tax/transfer amount; protection /
                               # kill / weight threshold
    threshold: Optional[int]   # catchup "fewer than N" bound
    text: str                  # matched sentence span (coverage + NOTEs)
    src_sel: str = ""          # transfer: "max"|"min" selector of the payer
    dst_sel: str = ""          # transfer: selector of the receiver


def mine_rules(description: str) -> list[MinedRule]:
    """All rule sentences in the description, in match order, deduped."""
    found: list[tuple[int, MinedRule]] = []
    for m in _CATCHUP_RX.finditer(description):
        found.append((m.start(), MinedRule(
            "catchup", m.group(4).lower(), _num(m.group(3)),
            _num(m.group(1)), m.group(0))))
    catchup_spans = [(s, s + len(r.text)) for s, r in found]
    for m in _GAIN_RX.finditer(description):
        # a catchup sentence also contains a gain-shaped suffix; the
        # longer family owns the span
        if any(a <= m.start() < b for a, b in catchup_spans):
            continue
        found.append((m.start(), MinedRule(
            "gain", m.group(2).lower(), _num(m.group(1)), None, m.group(0))))
    taxed: set[tuple[str, int]] = set()
    for rx in (_LEADER_TAX_RX, _LEADER_TAX_TRAIL_RX):
        for m in rx.finditer(description):
            key = (m.group(2).lower(), _num(m.group(1)))
            if key in taxed:
                continue
            taxed.add(key)
            found.append((m.start(), MinedRule(
                "leader_tax", key[0], key[1], None, m.group(0))))
    for m in _KILL_RX.finditer(description):
        found.append((m.start(), MinedRule(
            "threshold_kill", m.group(2).lower(), _num(m.group(1)),
            None, m.group(0))))
    # round-5 families ------------------------------------------------------
    for rx, reversed_dir in ((_TRANSFER_RX, False), (_STEAL_RX, True)):
        for m in rx.finditer(description):
            a_sel = _sel_kind(m.group(1), m.group(2))
            b_sel = _sel_kind(m.group(5), m.group(6))
            if a_sel == b_sel:
                continue  # "richest gives to richest" is not a transfer
            # steal: the ACTOR is the receiver, the named "from" player pays
            src, dst = (b_sel, a_sel) if reversed_dir else (a_sel, b_sel)
            found.append((m.start(), MinedRule(
                "transfer", m.group(4).lower(), _num(m.group(3)),
                None, m.group(0), src_sel=src, dst_sel=dst)))
    for m in _PROTECT_RX.finditer(description):
        found.append((m.start(), MinedRule(
            "protection", m.group(2).lower(), _num(m.group(1)),
            None, m.group(0))))
    weight_spans: list[tuple[int, int]] = []
    for rx in (_WEIGHT_RX, _WEIGHT2_RX):
        for m in rx.finditer(description):
            if any(a <= m.start() < b for a, b in weight_spans):
                continue
            weight_spans.append((m.start(), m.start() + len(m.group(0))))
            found.append((m.start(), MinedRule(
                "vote_weight", m.group(2).lower(), _num(m.group(1)),
                None, m.group(0))))
    for m in _ONESHOT_RX.finditer(description):
        found.append((m.start(), MinedRule(
            "one_shot", m.group(2).lower(), _num(m.group(1)),
            None, m.group(0))))
    found.sort(key=lambda t: t[0])
    out, seen = [], set()
    for _, r in found:
        key = (r.kind, r.noun, r.amount, r.threshold, r.src_sel, r.dst_sel)
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out


_NUM_TYPES = {"num", "number", "int", "integer"}


def _resolve_field(noun: str, fields: dict[str, Any]) -> Optional[str]:
    """noun -> existing numeric field (word / word+'s' / singular / score
    aliases), or None when the rule must synthesize one."""
    def is_num(name: str) -> bool:
        f = fields.get(name)
        return isinstance(f, dict) and str(f.get("type", "")).lower() in _NUM_TYPES

    cands = [noun, noun + "s"]
    if noun.endswith("s"):
        cands.append(noun[:-1])
    if noun in ("point", "points", "score"):
        cands.extend(_SCORE_ALIASES)
    for c in cands:
        if is_num(c):
            return c
    return None


def _synth_field_name(noun: str) -> str:
    name = re.sub(r"[^a-z0-9_]", "", noun.lower())
    if not name or not name[0].isalpha():
        name = "resource_" + name
    return name if name.endswith("s") else name + "s"


def _add_field(doc: dict[str, Any], name: str, why: str) -> None:
    decl = doc["declaration"]
    decl["player_states"][name] = {
        "type": "num", "example": 0,
        "description": f"Synthesized resource for the described rule: {why}",
    }
    decl["player_states_template"]["player_states"]["1"][name] = 0
    for row in decl["players_example"]["player_states"].values():
        row[name] = 0


def _successors(ph: dict[str, Any]) -> list[int]:
    nxt = ph.get("next_phase")
    if isinstance(nxt, dict) and "id" in nxt:
        return [nxt["id"]] if isinstance(nxt["id"], int) else []
    if isinstance(nxt, dict):
        return [v["id"] for v in nxt.values()
                if isinstance(v, dict) and isinstance(v.get("id"), int)]
    return []


def _loop_phase(doc: dict[str, Any]) -> Optional[int]:
    """The per-round check phase: the lowest-id phase that (a) sits on a
    cycle of the phase graph (it recurs every round) and (b) branches
    (dict next_phase — the win check), so the program's on-enter writes
    are visible to that check.  Falls back to any phase on a cycle."""
    phases = doc["phases"]

    def on_cycle(start: int) -> bool:
        seen: set[int] = set()
        frontier = list(_successors(phases[start]))
        while frontier:
            pid = frontier.pop()
            if pid == start:
                return True
            if pid in seen or pid not in phases:
                continue
            seen.add(pid)
            frontier.extend(_successors(phases[pid]))
        return False

    cyclic = [pid for pid in sorted(phases) if on_cycle(pid)]
    for pid in cyclic:
        nxt = phases[pid].get("next_phase")
        if isinstance(nxt, dict) and "id" not in nxt:
            return pid
    return cyclic[0] if cyclic else None


def _already_paid(doc: dict[str, Any], field: str) -> bool:
    """True when the archetype already pays recurring income into `field`
    (text-minable sentence or explicit {income: ...} hint on any phase) —
    an unconditional gain rule would double-pay it."""
    from game_engine_tpu_torch.gamespec.mechanics import iter_text_income

    for ph in doc["phases"].values():
        for hint in ph.get("mechanics", []):
            inc = hint.get("income") if isinstance(hint, dict) else None
            if isinstance(inc, dict) and field in inc:
                return True
        for w, _amount in iter_text_income(ph.get("description", "")):
            if field in (w, w + "s", w[:-1] if w.endswith("s") else w):
                return True
    return False


def _preserve_text_income(doc: dict[str, Any], pid: int) -> None:
    """Attaching an `effects` hint to a phase disables text income mining
    on it (mechanics.py P12 rule) — lift any minable income sentence in
    the anchor phase's description into an explicit {income: ...} hint
    first so the declared program cannot silently defund the archetype."""
    from game_engine_tpu_torch.gamespec.mechanics import iter_text_income

    ph = doc["phases"][pid]
    fields = doc["declaration"]["player_states"]
    gains: dict[str, int] = {}
    for w, amount in iter_text_income(ph.get("description", "")):
        f = _resolve_field(w, fields)
        if f is not None and f not in gains:
            gains[f] = amount
    if gains and not any(isinstance(h, dict) and "income" in h
                         for h in ph.get("mechanics", [])):
        ph.setdefault("mechanics", []).insert(0, {"income": gains})


def inject_rules(
    doc: dict[str, Any],
    rules: list[MinedRule],
    report: Optional[list[str]] = None,
) -> list[str]:
    """Weave mined rules into the generated doc as ONE declared effects
    program on the round-loop check phase (on-enter: the program's writes
    are visible to that phase's win-check branches).  Gains/taxes land in
    block 1; threshold kills in block 2 so they see the round's fresh
    values.  Returns the emitted statements (for tests); NOTEs describing
    every injection/skip are appended to ``report``."""
    def note(msg: str) -> None:
        if report is not None:
            report.append(msg)

    if not rules:
        return []
    pid = _loop_phase(doc)
    if pid is None:
        note("NOTE: described custom rules were mined but the generated "
             "phase graph has no round loop to attach them to; skipped: "
             + "; ".join(r.text for r in rules))
        return []
    fields = doc["declaration"]["player_states"]
    has_alive = "is_alive" in fields

    writes: list[str] = []
    kills: list[str] = []
    protect_exprs: list[str] = []
    weight_rule: Optional[tuple[str, int]] = None
    for r in rules:
        if (r.kind in ("threshold_kill", "protection")
                and not has_alive):
            note(f"NOTE: custom rule {r.text!r} needs player elimination "
                 "but this archetype has no is_alive field; skipped.")
            continue
        f = _resolve_field(r.noun, fields)
        if f is None:
            f = _synth_field_name(r.noun)
            if f not in fields:
                _add_field(doc, f, r.text)
                note(f"NOTE: custom rule {r.text!r} introduces a new "
                     f"resource — synthesized num field {f!r} (default 0).")
        if r.kind == "gain":
            if _already_paid(doc, f):
                note(f"NOTE: custom rule {r.text!r} skipped — the "
                     f"archetype already pays recurring {f!r} income "
                     "(double-pay guard).")
                continue
            stmt = f"{f} += {r.amount} where alive"
            writes.append(stmt)
        elif r.kind == "catchup":
            stmt = f"{f} += {r.amount} where alive and {f} < {r.threshold}"
            writes.append(stmt)
        elif r.kind == "leader_tax":
            stmt = f"{f} -= {r.amount} where alive and seat == argmax({f}, alive)"
            writes.append(stmt)
        elif r.kind == "threshold_kill":
            stmt = f"kill where {f} >= {r.amount}"
            kills.append(stmt)
        elif r.kind == "transfer":
            # leader->trailer (or reversed) directed transfer: both sides
            # write from the SAME block-entry snapshot so debit == credit
            # (conserved; unclamped like leader_tax). Distinct-seat guard
            # keeps a one-player standing (src == dst) a no-op.
            src = f"arg{r.src_sel}({f}, alive)"
            dst = f"arg{r.dst_sel}({f}, alive)"
            guard = f"alive and {src} != {dst}"
            stmt = f"{f} -= {r.amount} where {guard} and seat == {src}"
            writes.append(stmt)
            writes.append(
                f"{f} += {r.amount} where {guard} and seat == {dst}")
        elif r.kind == "one_shot":
            # opening grant, paid exactly once on the loop phase's first
            # entry via a synthesized once-flag (num 0/1, default 0)
            flag = f"{f}_opening_grant"
            if flag not in fields:
                _add_field(doc, flag, f"one-shot marker for: {r.text}")
            stmt = f"{f} += {r.amount} where alive and {flag} == 0"
            writes.append(stmt)
            writes.append(f"{flag} = 1")
        elif r.kind == "protection":
            protect_exprs.append(f"{f} >= {r.amount}")
            stmt = f"protect: {f} >= {r.amount}"
        elif r.kind == "vote_weight":
            if weight_rule is not None:
                note(f"NOTE: custom rule {r.text!r} skipped — a vote "
                     "weight rule is already declared (one per game).")
                continue
            weight_rule = (f, r.amount)
            stmt = f"weight: if({f} >= {r.amount}, 2, 1)"
        else:
            note(f"NOTE: mined rule {r.text!r} has unhandled kind "
                 f"{r.kind!r}; skipped.")
            continue
        note(f"NOTE: mined custom rule {r.text!r} -> "
             f"{stmt!r} on phase {pid} "
             f"({doc['phases'][pid]['name']!r}).")

    # protection guards every kill path: the archetype's vote / night
    # resolutions (P6p parameterized hints) AND any mined threshold kill
    if protect_exprs:
        shield = " or ".join(f"({e})" for e in protect_exprs)
        kills = [f"{k} and not ({shield})" for k in kills]
        if not _parameterize_resolution_hints(
                doc, {"vote_elimination", "night_resolution"},
                "protect", shield):
            note("NOTE: protection rule(s) mined but the phase graph "
                 "declares no vote_elimination/night_resolution hint — "
                 "they guard only mined threshold kills.")
    if weight_rule is not None:
        f, n = weight_rule
        if not _parameterize_resolution_hints(
                doc, {"vote_elimination"}, "weight",
                f"if({f} >= {n}, 2, 1)"):
            note("NOTE: vote-weight rule mined but the phase graph "
                 "declares no vote_elimination hint; skipped.")

    stmts = writes + (["---"] if writes and kills else []) + kills
    if not stmts:
        return []
    # well-formedness is part of the contract: a malformed emission must
    # fail HERE, not at room creation
    from game_engine_tpu_torch.gamespec import effects as FX

    FX.parse_program(stmts, reserved=frozenset(fields))
    _preserve_text_income(doc, pid)
    doc["phases"][pid].setdefault("mechanics", []).append({"effects": stmts})
    return stmts


def _parameterize_resolution_hints(
        doc: dict[str, Any], hint_names: set[str], key: str,
        expr: str) -> bool:
    """Attach `{key: expr}` to every matching resolution hint in the doc
    (P6p protect / P6w weight). String hints become dict form; existing
    dict args merge — an existing `protect` OR-joins with the new one, an
    existing `weight` is kept (first declaration wins). Returns True when
    at least one hint was parameterized."""
    changed = False
    for ph in doc["phases"].values():
        hints = ph.get("mechanics")
        if not isinstance(hints, list):
            continue
        for idx, h in enumerate(hints):
            if isinstance(h, str) and h in hint_names:
                hints[idx] = {h: {key: expr}}
                changed = True
            elif isinstance(h, dict):
                for name in (set(h) & hint_names):
                    cur = h[name] if isinstance(h[name], dict) else {}
                    if key == "protect" and cur.get("protect"):
                        cur["protect"] = f"({cur['protect']}) or ({expr})"
                    elif key in cur:
                        continue  # first declaration wins
                    else:
                        cur[key] = expr
                    h[name] = cur
                    changed = True
    return changed


def consumed_words(description: str) -> set[str]:
    """Words of every mined rule sentence — description_coverage counts
    them as understood."""
    out: set[str] = set()
    for r in mine_rules(description):
        out.update(re.findall(r"[a-z][a-z'-]+", r.text.lower()))
    return out
