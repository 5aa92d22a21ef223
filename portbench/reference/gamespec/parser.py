"""YAML -> GameSpec parser with defensive normalization.

Mirrors the reference's tolerance rules:
  * int-or-str phase keys (reference: agent/tools/utils.py:19-31)
  * player_states_template 3-tier fallback: template row "1" -> first row ->
    synthesized from player_states schema type defaults
    (reference: src/app/api/games/initialize-players/route.ts:83-151)
  * type defaults string->'', num->0, boolean->false, dict->{}, array->[]
    (reference: src/app/api/games/initialize-players/route.ts:115-141)
"""

from __future__ import annotations

import os
from typing import Any, Optional

import yaml

from portbench.reference.gamespec.schema import (
    AudienceGroup,
    CompletionCriteria,
    CompletionType,
    Declaration,
    FieldSpec,
    FieldType,
    GameSpec,
    NextPhaseBranch,
    PhaseAction,
    PhaseSpec,
    RoleSpec,
    WaitFor,
    parse_field_type,
)

_TYPE_DEFAULTS = {
    FieldType.STRING: "",
    FieldType.NUM: 0,
    FieldType.BOOLEAN: False,
    FieldType.DICT: {},
    FieldType.ARRAY: [],
}


def _as_int(key: Any) -> Optional[int]:
    try:
        return int(str(key).strip())
    except (TypeError, ValueError):
        return None


def _as_bool(v: Any, default: bool = False) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("true", "yes", "1")
    if v is None:
        return default
    return bool(v)


def _named_mapping(raw: Any, what: str) -> dict[str, Any]:
    """Normalize a mapping-expected DSL section that may arrive list-shaped.

    Generated docs sometimes emit ``player_states: [is_alive, role]`` or
    ``audience_groups: [{name: wolves, ...}]``. Accept: a dict verbatim, a
    list of names (-> empty metas), a list of dicts with a 'name' key.
    Anything else raises a clear ValueError instead of an AttributeError
    deep in .items() (the module's defensive-normalization contract).
    """
    if raw is None:
        return {}
    if isinstance(raw, dict):
        return raw
    if isinstance(raw, (list, tuple)):
        out: dict[str, Any] = {}
        for e in raw:
            if isinstance(e, dict) and e.get("name"):
                out[str(e["name"])] = e
            elif isinstance(e, str) and e:
                out[e] = {}
        return out
    raise ValueError(f"game DSL {what} must be a mapping, got {type(raw).__name__}")


def _parse_fields(decl: dict[str, Any]) -> list[FieldSpec]:
    raw_fields = _named_mapping(decl.get("player_states"), "player_states")
    template = decl.get("player_states_template") or {}
    # template may be nested under a 'player_states' key, then keyed by id "1"
    trows = template.get("player_states", template) if isinstance(template, dict) else {}
    trow: dict[str, Any] = {}
    if isinstance(trows, dict) and trows:
        # tier 1: row "1"; tier 2: first row
        for key in list(trows):
            if _as_int(key) == 1 and isinstance(trows[key], dict):
                trow = trows[key]
                break
        else:
            first = next(iter(trows.values()))
            if isinstance(first, dict):
                trow = first

    fields = []
    for name, meta in raw_fields.items():
        meta = meta if isinstance(meta, dict) else {}
        try:
            ftype = parse_field_type(meta.get("type", "string"))
        except ValueError:
            ftype = FieldType.STRING
        default = trow.get(name, _TYPE_DEFAULTS[ftype])
        # tier 3 defense: a template value of the wrong shape falls back to
        # the schema type default.
        if ftype is FieldType.BOOLEAN:
            default = _as_bool(default)
        elif ftype is FieldType.NUM and not isinstance(default, (int, float)):
            default = 0
        elif ftype is FieldType.DICT and not isinstance(default, dict):
            default = {}
        elif ftype is FieldType.ARRAY and not isinstance(default, list):
            default = []
        elif ftype is FieldType.STRING and not isinstance(default, str):
            default = str(default)
        fields.append(
            FieldSpec(
                name=str(name),
                type=ftype,
                example=meta.get("example"),
                description=str(meta.get("description", "")),
                default=default,
            )
        )
    return fields


def _parse_players_example(decl: dict[str, Any]) -> tuple[dict[int, dict[str, Any]], tuple[str, ...]]:
    pe = decl.get("players_example") or {}
    if not isinstance(pe, dict):  # tolerate list-/string-shaped authoring mistakes
        return {}, ()
    tools = tuple(str(t) for t in pe.get("tools", []) or [])
    rows = pe.get("player_states", pe) or {}
    out: dict[int, dict[str, Any]] = {}
    if isinstance(rows, dict):
        for key, row in rows.items():
            pid = _as_int(key)
            if pid is not None and isinstance(row, dict):
                out[pid] = dict(row)
    return out, tools


def _parse_completion(raw: Any) -> CompletionCriteria:
    raw = raw if isinstance(raw, dict) else {}
    rtype = str(raw.get("type", "UI_displayed")).strip()
    type_map = {c.value.lower(): c for c in CompletionType}
    ctype = type_map.get(rtype.lower(), CompletionType.UI_DISPLAYED)

    wait_for = None
    raw_wait = raw.get("wait_for")
    if raw_wait is not None:
        wmap = {w.value.lower(): w for w in WaitFor}
        wait_for = wmap.get(str(raw_wait).strip().lower())

    tgt = raw.get("target_players") or {}
    if not isinstance(tgt, dict):
        tgt = {}
    return CompletionCriteria(
        type=ctype,
        description=str(raw.get("description", "")),
        wait_for=wait_for,
        target_description=str(tgt.get("description", "")),
        target_condition=str(tgt.get("condition", "")),
    )


def _parse_mechanic_hints(raw: Any) -> tuple[tuple[str, Any], ...]:
    """Normalize the DSL `mechanics:` key (framework extension; see
    SEMANTICS.md P18) into hashable (name, arg) pairs.

    Accepted entry forms::

        mechanics: vote_elimination              # single string
        mechanics: [night_resolution, ...]       # list of strings
        mechanics: [{income: {coins: 2}}, ...]   # parameterized
        mechanics: [{winner: richest}]           # or {winner: {score: coins}}
        mechanics: [{reveal: role_revealed}]

    Dict args become sorted item tuples so PhaseSpec stays hashable; unknown
    names are kept verbatim — dslgen/validate.py rejects them loudly."""
    if raw is None:
        return ()
    entries = raw if isinstance(raw, (list, tuple)) else [raw]
    out: list[tuple[str, Any]] = []
    def _freeze(v: Any) -> Any:
        # recursively hashable: nested lists/dicts inside a dict arg would
        # otherwise make PhaseSpec unhashable far from the parse site
        if isinstance(v, dict):
            return tuple(sorted((str(a), _freeze(b)) for a, b in v.items()))
        if isinstance(v, (list, tuple)):
            return tuple(_freeze(x) for x in v)
        return v

    for e in entries:
        if isinstance(e, dict):
            for k, v in e.items():
                name = str(k).strip().lower().replace("-", "_")
                if isinstance(v, dict):
                    arg: Any = tuple(sorted((str(a), _freeze(b)) for a, b in v.items()))
                elif isinstance(v, (list, tuple)):
                    arg = tuple(str(x) for x in v)
                elif v is None:
                    arg = None
                else:
                    arg = str(v)
                out.append((name, arg))
        else:
            # NEVER drop an entry: a malformed one (int, null, ...) must
            # surface as an unknown-mechanic validator ERROR, not vanish
            out.append((str(e).strip().lower().replace("-", "_"), None))
    return tuple(out)


def _parse_phase(pid: int, raw: dict[str, Any]) -> PhaseSpec:
    actions = []
    for a in raw.get("actions") or []:
        if isinstance(a, dict):
            tools = tuple(str(t) for t in (a.get("tools") or []))
            actions.append(PhaseAction(description=str(a.get("description", "")), tools=tools))
        elif isinstance(a, str):
            actions.append(PhaseAction(description=a, tools=()))

    nxt = raw.get("next_phase")
    branches: list[NextPhaseBranch] = []
    next_id: Optional[int] = None
    next_name = ""
    if isinstance(nxt, dict):
        if "id" in nxt:  # direct {id, name}
            next_id = _as_int(nxt.get("id"))
            next_name = str(nxt.get("name", ""))
        else:  # branch map: condition sentence -> {id, name}; YAML preserves
            # insertion order, which defines first-match-wins priority
            # (reference: agent/prompt/PhaseNode_system_prompt.txt:44-48).
            for cond, target in nxt.items():
                if isinstance(target, dict):
                    bid = _as_int(target.get("id"))
                    if bid is not None:
                        branches.append(
                            NextPhaseBranch(
                                condition=str(cond),
                                phase_id=bid,
                                phase_name=str(target.get("name", "")),
                            )
                        )
                else:
                    bid = _as_int(target)
                    if bid is not None:
                        branches.append(NextPhaseBranch(condition=str(cond), phase_id=bid))
    elif nxt is not None:
        next_id = _as_int(nxt)

    return PhaseSpec(
        id=pid,
        name=str(raw.get("name", f"Phase {pid}")),
        description=str(raw.get("description", "")),
        actions=tuple(actions),
        completion=_parse_completion(raw.get("completion_criteria")),
        branches=tuple(branches),
        next_id=next_id,
        next_name=next_name,
        mechanic_hints=_parse_mechanic_hints(raw.get("mechanics")),
    )


def parse_game_spec(doc: dict[str, Any], name: str = "game") -> GameSpec:
    """Parse a loaded YAML document into a GameSpec."""
    if not isinstance(doc, dict):
        raise ValueError("game DSL must be a mapping with 'declaration' and 'phases'")
    decl = doc.get("declaration") or {}
    raw_phases = doc.get("phases") or {}

    roles = tuple(
        RoleSpec(name=str(r.get("name", "")), description=str(r.get("description", "")))
        for r in (decl.get("roles") or [])
        if isinstance(r, dict) and r.get("name")
    )
    fields = tuple(_parse_fields(decl))
    players_example, tools = _parse_players_example(decl)
    groups = tuple(
        AudienceGroup(
            name=str(gname),
            description=str((g if isinstance(g, dict) else {}).get("description", "")),
            selection_criteria=str((g if isinstance(g, dict) else {}).get("selection_criteria", "")),
        )
        for gname, g in _named_mapping(decl.get("audience_groups"), "audience_groups").items()
    )

    # preserve a declared 0 (don't `or 1` it away) so validate.py's
    # "min_players must be >= 1" ERROR stays reachable for the 0 case
    min_players = _as_int(decl.get("min_players"))
    declaration = Declaration(
        description=str(decl.get("description", "")),
        is_multiplayer=_as_bool(decl.get("is_multiplayer"), default=True),
        min_players=1 if min_players is None else min_players,
        roles=roles,
        fields=fields,
        players_example=players_example,
        audience_groups=groups,
        tools=tools,
    )

    if isinstance(raw_phases, (list, tuple)):
        # list-shaped phases: take each item's declared id, else 1-based index
        raw_phases = {
            (p.get("id", i + 1) if isinstance(p, dict) else i + 1): p
            for i, p in enumerate(raw_phases)
        }
    if not isinstance(raw_phases, dict):
        raise ValueError("game DSL phases must be a mapping of phase id -> phase")
    phases: dict[int, PhaseSpec] = {}
    for key, raw in raw_phases.items():
        pid = _as_int(key)
        if pid is None or not isinstance(raw, dict):
            continue
        phases[pid] = _parse_phase(pid, raw)
    if not phases:
        raise ValueError("game DSL has no parseable phases")

    # Defensive: drop dangling next ids (point them at a terminal sentinel by
    # marking the branch/next as terminal) — mirrors the reference's phase-id
    # normalization (reference: agent/game_agent_v2.py:1172-1204).
    valid = set(phases)
    fixed: dict[int, PhaseSpec] = {}
    for pid, ph in phases.items():
        branches = tuple(b for b in ph.branches if b.phase_id in valid)
        next_id = ph.next_id if ph.next_id in valid else None
        if branches != ph.branches or next_id != ph.next_id:
            ph = PhaseSpec(
                id=ph.id,
                name=ph.name,
                description=ph.description,
                actions=ph.actions,
                completion=ph.completion,
                branches=branches,
                next_id=next_id,
                next_name=ph.next_name if next_id is not None else "",
                mechanic_hints=ph.mechanic_hints,
            )
        fixed[pid] = ph

    return GameSpec(name=name, declaration=declaration, phases=fixed)


def load_game_spec(path: str, name: Optional[str] = None) -> GameSpec:
    """Load a GameSpec from a YAML file path."""
    with open(path, "r", encoding="utf-8") as f:
        doc = yaml.safe_load(f)
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    return parse_game_spec(doc, name=name)


def games_dir() -> str:
    """Repo-local games/ directory (the DSL data assets)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "games")


def load_builtin(name: str) -> GameSpec:
    """Load one of the shipped game DSLs by (fuzzy) name.

    Mirrors the reference's load-by-gameName scan of games/*.yaml
    (reference: agent/tools/utils.py:557-581).
    """
    d = games_dir()
    want = name.lower().replace(" ", "-")
    files = [fn for fn in sorted(os.listdir(d)) if fn.endswith((".yaml", ".yml"))]
    stems = {fn: os.path.splitext(fn)[0].lower() for fn in files}
    # exact stem match wins; the substring fallback needs a meaningful
    # query (>= 3 chars), or a blank/1-char name silently loads the
    # alphabetically-first game instead of failing
    for fn, stem in stems.items():
        if stem == want:
            return load_game_spec(os.path.join(d, fn))
    if len(want) >= 3:
        for fn, stem in stems.items():
            if want in stem or stem in want:
                return load_game_spec(os.path.join(d, fn))
    raise FileNotFoundError(f"no game DSL matching {name!r} in {d}")
