"""LLM adapter for the DSL generator's ``llm_hook`` seam.

The reference generates arbitrary described games with three sequential
gpt-5 calls and validates the result with a 976-line prompt (reference:
agent/dsl_agent.py:157-371, agent/prompt/dsl_validation_node_prompt.txt).
This framework's deterministic generator covers its thirteen archetypes and
their mixes in milliseconds; for games OUTSIDE that space, this module is
the documented integration point — bring any completion function
(an API client, a local model, a human-in-the-loop editor) and get the
same contract the deterministic path guarantees:

    from game_engine_tpu_torch.dslgen.llm_adapter import make_llm_hook
    from game_engine_tpu_torch.dslgen.generate import generate_from_description

    def complete(prompt: str) -> str:
        ...  # e.g. call your model; return YAML (optionally fenced)

    doc = generate_from_description(
        "poker-night", "a five-card draw bluffing game ...",
        llm_hook=make_llm_hook(complete))

The adapter builds the prompt (DSL schema contract + P18 mechanics
vocabulary so the model can PIN semantics explicitly instead of relying
on keyword detection), parses the completion (stripping code fences),
validates with dslgen.validate, annotates P18 hints, and — like the
reference's keep-original-on-failure rule (agent/dsl_agent.py:343-349) —
falls back to the deterministic blueprint path if the model's output has
validation errors after ``max_retries`` attempts (each retry feeds the
validator's error list back into the prompt).

Environment note: this repo runs with zero network egress, so no client
is shipped; the adapter is fully exercised in tests with stub completion
functions (tests/test_llm_adapter.py).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import yaml

PROMPT_TEMPLATE = """You are designing a social-deduction party game as a YAML game DSL.

Game name: {name}
Game description: {description}

Produce ONLY a YAML document (no prose) with this structure:

declaration:
  description: <one paragraph>
  is_multiplayer: true
  min_players: <int>
  roles: [{{name, description}}, ...]
  player_states: {{<field>: {{type: string|num|boolean|dict, example, description}}, ...}}
  player_states_template: {{player_states: {{"1": {{<field>: <default>, ...}}}}}}
  players_example: {{player_states: {{"1": {{...}}, "2": {{...}}, ...}}}}
  audience_groups: {{<name>: {{description, selection_criteria}}, ...}}
phases:
  <id>:
    name: <phase name>
    description: <what happens>
    mechanics: [...]          # see the mechanics vocabulary below
    actions: [{{description, tools: [clearCanvas, ...]}}, ...]
    completion_criteria:
      type: player_action | UI_displayed | timer
      description: <when complete; name the fields an action writes>
      wait_for: all_players_action | single_player_choice | multiple_players_action
      target_players: {{description, condition: "player.<field> == <value> and ..."}}
    next_phase: {{id, name}}  # or a map of condition sentences -> {{id, name}},
                              # or null for a terminal phase

Rules:
- phase 0 is the introduction; exactly the phases you declare exist.
- every action phase's first tool is clearCanvas.
- branch maps evaluate first-match-wins; end with an "Otherwise, ..." branch.
- DECLARE MECHANICS EXPLICITLY with the `mechanics:` key instead of relying
  on phrasing. Vocabulary (P18): role_assignment, night_resolution,
  vote_elimination, speaker_rotation, bluff_challenge, minority_score,
  auction, raid, guess_score, {{income: {{<num field>: <amount>}}}},
  {{winner: team|survivor|richest|{{score: <num field>}}}} (terminal only),
  {{reveal: <bool field>}}, kill / protect (on night action phases), and
  the choice kinds target / {{option: <max>}} / submit on action phases.
- NOVEL RESOLUTION RULES are declared as an effects program:
  {{effects: [<statement>, ...]}} on the resolving phase. Statements are
  guarded per-player field writes evaluated simultaneously per block
  (split blocks with the statement "---"; later blocks see earlier
  blocks' writes):
    FIELD = EXPR | FIELD += EXPR | FIELD -= EXPR   [where EXPR]
    FIELD = 'Literal'                              (vocabulary string write)
    FIELD[choice] = 'Literal'                      (per-player dict write)
    kill [where EXPR]                              (death + role reveal)
    reset FIELD [where EXPR]                       (restore template default)
    deal FIELD [salt EXPR] [where EXPR]            (RNG-permute the field's
                                                    players_example values
                                                    over seats; a changing
                                                    salt re-deals each round)
    over EXPR [where EXPR]                         (end game; winner = EXPR
                                                    at the lowest seat)
  Expressions: int arithmetic on own fields, seat, nplayers, choice,
  chose(PHASE_ID), at(EXPR, FIELD), string compares FIELD == 'Value',
  let NAME = EXPR, and cross-player aggregations sum/max/min/count/
  argmax/argmin/rank/eqcount/incoming(...) over a predicate.
- every declared player_states field must be read or written by some phase.
{feedback}"""


def build_prompt(name: str, description: str,
                 feedback: Optional[list[str]] = None) -> str:
    """The generation prompt; validator errors from a failed attempt are
    appended so the model can repair them (the reference's validation-node
    loop, agent/dsl_agent.py:303-371)."""
    fb = ""
    if feedback:
        fb = ("\nYour previous attempt failed validation. Fix these issues:\n"
              + "\n".join(f"- {f}" for f in feedback))
    return PROMPT_TEMPLATE.format(name=name, description=description,
                                  feedback=fb)


def parse_completion(text: str) -> dict[str, Any]:
    """Completion text -> DSL doc dict. Strips markdown code fences; if the
    fence-stripped text is already a YAML mapping, use it as-is (a valid
    completion may order `phases:` before `declaration:`); only then fall
    back to the prose-stripping heuristic (drop everything before the first
    'declaration:' line)."""
    lines = [ln for ln in text.splitlines()
             if not ln.strip().startswith("```")]
    try:
        doc = yaml.safe_load("\n".join(lines))
    except yaml.YAMLError:
        doc = None
    if isinstance(doc, dict) and ("declaration" in doc or "phases" in doc):
        return doc
    for i, ln in enumerate(lines):
        if ln.startswith("declaration:"):
            lines = lines[i:]
            break
    doc = yaml.safe_load("\n".join(lines))
    if not isinstance(doc, dict):
        raise ValueError("completion is not a YAML mapping")
    return doc


def make_llm_hook(complete: Callable[[str], str], max_retries: int = 2,
                  report: Optional[list] = None):
    """Wrap a completion function into a ``generate_from_description``
    llm_hook. Validation errors are retried with feedback; a still-invalid
    result falls back to the deterministic blueprint path
    (keep-original-on-failure, reference: agent/dsl_agent.py:343-349).

    ``report`` (caller-provided list) is told LOUDLY when the fallback
    fires — the model's game was rejected and a deterministic archetype
    was substituted — plus the substitute's own coverage warning."""
    from game_engine_tpu_torch.dslgen.generate import annotate_mechanics
    from game_engine_tpu_torch.dslgen.validate import errors, validate_doc

    def hook(name: str, description: str) -> dict[str, Any]:
        feedback: Optional[list[str]] = None
        for _ in range(max_retries + 1):
            try:
                doc = parse_completion(complete(build_prompt(
                    name, description, feedback)))
                issues, spec = validate_doc(doc, name=name)
            except Exception as e:  # noqa: BLE001 — model output is untrusted
                feedback = [f"{type(e).__name__}: {e}"]
                continue
            errs = errors(issues)
            if not errs and spec is not None:
                return annotate_mechanics(doc)
            feedback = [str(i) for i in errs]
        # keep-original-on-failure: the deterministic path always works —
        # but never silently (the substitute may be a different game)
        if report is not None:
            detail = "; ".join(feedback or [])[:300]
            report.append(
                f"WARNING: external model output rejected after "
                f"{max_retries + 1} attempts ({detail}); deterministic "
                "fallback game substituted")
        from game_engine_tpu_torch.dslgen import generate as G

        return G.generate_from_description(name, description, llm_hook=None,
                                           report=report)

    return hook
