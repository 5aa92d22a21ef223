"""Compile-explain: how the analyzer interpreted a game DSL.

``GET /api/games/<name>/explain`` serves this as JSON for game authors:
which mechanics attached to each phase, what each phase's accepted action
records, effect-program summaries, branch conditions, terminal winner
rules, and per-field information visibility. A deterministic analyzer
needs exactly this tool for authors to trust what the compiler will do
with their YAML — the reference has no analogue because its referee
re-reads the prose via an LLM every turn
(reference contrast: agent/prompt/referee_system_prompt_1.txt:6-88).
"""

from __future__ import annotations

from typing import Any

from game_engine_tpu_torch.gamespec import mechanics as M


def _describe_record(rec: M.RecordProgram) -> dict[str, Any]:
    kind = {
        M.ChoiceKind.NONE: "none",
        M.ChoiceKind.TARGET: "target (1-based player id, alive & present)",
        M.ChoiceKind.OPTION: (f"option (1..{rec.choice_max})"
                              if rec.choice_max > 0 else "option"),
        M.ChoiceKind.SUBMIT: "submit (free content, recorded as 1)",
    }[rec.choice_kind]
    writes = []
    writes += [f"{f} = true" for f in rec.set_bool_true]
    writes += [f"{f} = false" for f in rec.set_bool_false]
    if rec.write_choice_num:
        writes.append(f"{rec.write_choice_num} = choice")
    if rec.write_pdict:
        writes.append(f"{rec.write_pdict[0]}[target] = {rec.write_pdict[1]}")
    if rec.mark_odict:
        writes.append(f"{rec.mark_odict} marked")
    return {"choice": kind, "writes": writes}


def _describe_effects(m: M.Effects) -> str:
    blocks = len(m.program)
    stmts = sum(len(b) for b in m.program)
    writes: set[str] = set()
    kinds: set[str] = set()
    for b in m.program:
        for s in b:
            kinds.add(type(s).__name__[1:].lower())  # SKill -> kill
            f = getattr(s, "field", None)
            if f:
                writes.add(f)
    out = f"effects program: {blocks} block(s), {stmts} statement(s)"
    if writes:
        out += ", writes " + ", ".join(sorted(writes))
    if "kill" in kinds:
        out += ", kills"
    if "over" in kinds:
        out += ", declares game over"
    if "deal" in kinds:
        out += ", deals from a multiset table"
    return out


def describe_mechanic(m: Any) -> str:
    """One human-readable line per attached mechanic (P-rule cited)."""
    if isinstance(m, M.RoleAssign):
        counts = ", ".join(f"{n}x{c}" for n, c in m.role_counts)
        return (f"role_assignment (P10): deal {m.role_field} from "
                f"[{counts}], filler {m.filler_role!r}")
    if isinstance(m, M.NightResolve):
        return (f"night_resolution (P7): kill choices from phases "
                f"{sorted(m.kill_phases)}, protects from "
                f"{sorted(m.protect_phases)}"
                + (f", reveals {list(m.reveal_bools)}" if m.reveal_bools else ""))
    if isinstance(m, M.VoteElim):
        return (f"vote_elimination (P6): plurality from phases "
                f"{sorted(m.vote_phases)}, ties to lowest seat")
    if isinstance(m, M.ResourceIncome):
        gains = ", ".join(f"{f} += {n}" for f, n in m.gains)
        return f"income (P12): every alive player {gains}"
    if isinstance(m, M.ResourceRaid):
        return (f"raid (P13): simultaneous raids on {m.res_field} from "
                f"phases {sorted(m.raid_phases)}")
    if isinstance(m, M.MinorityScore):
        return (f"minority_score (P16): least-picked of {m.n_options} "
                f"options ({m.pick_field}) scores +1 on {m.score_field}")
    if isinstance(m, M.AuctionScore):
        return (f"auction (P19): sealed bids in {m.bid_field} capped by "
                f"{m.res_field}; winner pays and gains +1 {m.prize_field}")
    if isinstance(m, M.BluffChallenge):
        return (f"bluff_challenge (P14): claims in {m.claim_field} vs "
                f"hidden {m.role_field}; lost challenge costs "
                f"{m.lives_field}")
    if isinstance(m, M.GuessScore):
        return (f"guess_score (P8): votes in {m.vote_field} vs the "
                f"speaker's {m.lie_field}; scores {m.score_field}")
    if isinstance(m, M.SpeakerRotate):
        return (f"speaker_rotation (P9): next alive seat after the "
                f"current {m.speaker_field}")
    if isinstance(m, M.SetBoolAll):
        return f"reveal (P15): set {list(m.fields)} true for everyone"
    if isinstance(m, M.GameOver):
        if m.mode == "team":
            return (f"terminal (P11): winner by surviving team "
                    f"({m.team_field}; order {list(m.team_order)})")
        if m.mode == "score":
            return f"terminal (P11): winner by highest {m.score_field}"
        if m.mode == "survivor":
            return "terminal (P11): winner is the last player standing"
        return "terminal (P11): no winner rule (draw)"
    if isinstance(m, M.Effects):
        return _describe_effects(m) + " (P20)"
    return type(m).__name__


def explain_spec(spec) -> dict[str, Any]:
    """Compile a GameSpec and report the analyzer's interpretation."""
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.policies.net import field_visibility

    game = compile_game(spec)
    vis = field_visibility(lower(game))
    vis_name = {0: "public", 1: "self-only", 2: "team"}

    phases = []
    for cp in game.phases:
        nxt: Any
        if cp.terminal:
            nxt = None
        elif cp.branches:
            nxt = [
                {"condition": b.condition_text,
                 "recognized": b.recognized,
                 "to": game.phases[b.next_index].dsl_id}
                for b in cp.branches
            ]
        else:
            nxt = game.phases[cp.next_index].dsl_id
        phases.append({
            "id": cp.dsl_id,
            "name": cp.name,
            "completion": cp.completion.value
            if hasattr(cp.completion, "value") else str(cp.completion),
            "record": _describe_record(cp.program.record),
            "mechanics": [describe_mechanic(m) for m in cp.program.on_enter],
            "next": nxt,
            "terminal": cp.terminal,
        })

    fields = [
        {"name": name, "bank": slot.bank, "index": slot.index,
         "visibility": vis_name.get(vis.get(name, 0), "public")}
        for name, slot in sorted(game.layout.slots.items())
    ]
    return {
        "game": spec.name,
        "min_players": spec.declaration.min_players,
        "max_players": game.config.max_players,
        "n_phases": game.n_phases,
        "start_phase": game.phases[game.start_index].dsl_id,
        "roles": [r.name for r in spec.declaration.roles],
        "phases": phases,
        "fields": fields,
    }


def explain_game(name: str) -> dict[str, Any]:
    """Explain a catalog game by (fuzzy) name."""
    from game_engine_tpu_torch.gamespec.parser import load_builtin

    return explain_spec(load_builtin(name))


if __name__ == "__main__":
    import json
    import sys

    try:
        print(json.dumps(explain_game(sys.argv[1] if len(sys.argv) > 1
                                      else "werewolf"), indent=1))
    except BrokenPipeError:  # `… | head` is a normal way to use this
        pass
