"""Compiler for the DSL's Python-ish per-player predicate strings.

Grammar observed in the DSL (reference: games/werewolf-(mafia).yaml:138-165,
games/two-truths-and-a-lie.yaml completion target conditions):

    player.team == 'werewolves' and player.is_alive == true
    player.role in ['Doctor', 'Detective'] and player.is_alive == true
    player.is_speaker == false and player.can_vote == true

Strategy: normalize YAML-style booleans (true/false) to Python, parse with the
stdlib ``ast`` module in eval mode, then walk a whitelisted node set into a
small predicate IR (And/Or/Not/Atom/Const). The IR has two consumers:

  * the oracle interpreter evaluates it directly over per-player dicts;
  * the table lowerer converts it to disjunctive normal form over a global
    atom list so the jitted engine can evaluate *all* predicates for *all*
    players as one masked-reduction over a (rooms, players, atoms) tensor.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Any, Union

# ---------------------------------------------------------------------------
# Predicate IR
# ---------------------------------------------------------------------------

_OPS = ("eq", "ne", "ge", "le", "gt", "lt", "in", "notin")


@dataclasses.dataclass(frozen=True)
class Atom:
    """field <op> value — one comparison on a player_states field."""

    field: str
    op: str  # one of _OPS
    value: Any  # scalar or tuple of scalars for in/notin

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"bad atom op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class And:
    items: tuple["Pred", ...]


@dataclasses.dataclass(frozen=True)
class Or:
    items: tuple["Pred", ...]


@dataclasses.dataclass(frozen=True)
class Not:
    item: "Pred"


@dataclasses.dataclass(frozen=True)
class Const:
    value: bool


Pred = Union[Atom, And, Or, Not, Const]

TRUE = Const(True)
FALSE = Const(False)

# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

_BOOL_WORD = re.compile(r"\b(true|false|null|none)\b", re.IGNORECASE)
_PY_BOOL = {"true": "True", "false": "False", "null": "None", "none": "None"}

_CMP_OPS = {
    ast.Eq: "eq",
    ast.NotEq: "ne",
    ast.GtE: "ge",
    ast.LtE: "le",
    ast.Gt: "gt",
    ast.Lt: "lt",
    ast.In: "in",
    ast.NotIn: "notin",
}

_FLIP = {"eq": "eq", "ne": "ne", "ge": "le", "le": "ge", "gt": "lt", "lt": "gt"}


class PredicateError(ValueError):
    pass


_QUOTED = re.compile(r"('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\")")


def _normalize(src: str) -> str:
    """YAML booleans -> Python, but never inside quoted string literals
    (a value like 'none' or 'true-believer' must survive verbatim)."""
    parts = _QUOTED.split(src)
    return "".join(
        p if i % 2 else _BOOL_WORD.sub(lambda m: _PY_BOOL[m.group(0).lower()], p)
        for i, p in enumerate(parts)
    )


def _literal(node: ast.AST) -> Any:
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        return tuple(_literal(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _literal(node.operand)
        if isinstance(v, (int, float)):
            return -v
    raise PredicateError(f"unsupported literal: {ast.dump(node)}")


def _field_ref(node: ast.AST) -> str | None:
    """player.<field> or a bare field name."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        if node.value.id in ("player", "p", "self"):
            return node.attr
    if isinstance(node, ast.Name) and node.id not in ("True", "False", "None"):
        return node.id
    # player['field'] subscript form
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        if node.value.id in ("player", "p", "self"):
            try:
                key = _literal(node.slice)
            except PredicateError:
                return None
            if isinstance(key, str):
                return key
    return None


def _compare(node: ast.Compare) -> Pred:
    if len(node.ops) != 1 or len(node.comparators) != 1:
        # chain a < b < c -> conjunction of pairs
        preds = []
        left = node.left
        for op, right in zip(node.ops, node.comparators):
            preds.append(_compare(ast.Compare(left=left, ops=[op], comparators=[right])))
            left = right
        return And(tuple(preds))

    op_cls = type(node.ops[0])
    if op_cls not in _CMP_OPS:
        raise PredicateError(f"unsupported comparison op {op_cls.__name__}")
    op = _CMP_OPS[op_cls]

    lf = _field_ref(node.left)
    rf = _field_ref(node.comparators[0])
    if lf is not None and rf is None:
        value = _literal(node.comparators[0])
        return _make_atom(lf, op, value)
    if lf is None and rf is not None and op not in ("in", "notin"):
        value = _literal(node.left)
        return _make_atom(rf, _FLIP[op], value)
    raise PredicateError(f"comparison must be field <op> literal: {ast.dump(node)}")


def _make_atom(field: str, op: str, value: Any) -> Pred:
    # normalize boolean equality into canonical form field == True/False
    if op in ("eq", "ne") and isinstance(value, bool):
        want = value if op == "eq" else (not value)
        return Atom(field=field, op="eq", value=want)
    if op in ("in", "notin") and not isinstance(value, tuple):
        value = (value,)
    # null comparisons have no pinned semantics: the table lowering would
    # int(None)-crash on num fields and truthy-coerce on bool fields while
    # the oracle evaluates `v == None` as always-False — reject loudly
    # instead of diverging (the three-way parity invariant).
    vals = value if isinstance(value, tuple) else (value,)
    if any(v is None for v in vals):
        raise PredicateError(
            f"null/none comparison on field {field!r} is not supported — "
            "compare against a concrete value")
    # ordered comparisons on string literals would diverge: the oracle
    # compares lexicographically, the engine compares vocab codes in
    # mining order. No catalog game needs a string ordering; reject.
    if op in ("ge", "le", "gt", "lt") and any(isinstance(v, str) for v in vals):
        raise PredicateError(
            f"ordered comparison {op} against string literal on field "
            f"{field!r} is not supported — use ==/!=/in")
    return Atom(field=field, op=op, value=value)


def _walk(node: ast.AST) -> Pred:
    if isinstance(node, ast.BoolOp):
        items = tuple(_walk(v) for v in node.values)
        return And(items) if isinstance(node.op, ast.And) else Or(items)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return Not(_walk(node.operand))
    if isinstance(node, ast.Compare):
        return _compare(node)
    if isinstance(node, ast.Constant) and isinstance(node.value, bool):
        return Const(node.value)
    # bare `player.is_alive` used as a truthy boolean
    field = _field_ref(node)
    if field is not None:
        return Atom(field=field, op="eq", value=True)
    raise PredicateError(f"unsupported predicate node: {ast.dump(node)}")


def parse_predicate(src: str) -> Pred:
    """Compile a DSL predicate string into the Pred IR.

    Empty / whitespace strings compile to Const(True) (no restriction),
    matching the reference's behavior of treating a missing condition as
    "everyone" in target matching.
    """
    src = (src or "").strip()
    if not src:
        return TRUE
    try:
        tree = ast.parse(_normalize(src), mode="eval")
    except SyntaxError as e:
        raise PredicateError(f"cannot parse predicate {src!r}: {e}") from e
    return _walk(tree.body)


# ---------------------------------------------------------------------------
# Evaluation over plain dicts (oracle path)
# ---------------------------------------------------------------------------


def _eq(v: Any, t: Any) -> bool:
    """Equality with case-insensitive strings.

    The table lowering resolves string literals against the slot vocab
    case-insensitively (tables.py _lower_atom, layout.py Slot.encode), so
    the jitted/native executors match 'Werewolf' == 'werewolf'. The oracle
    must agree or three-way parity breaks on any
    casing mismatch between a DSL literal and the stored vocab spelling.
    """
    if isinstance(v, str) and isinstance(t, str):
        return v.lower() == t.lower()
    return v == t


def _atom_eval(atom: Atom, player: dict[str, Any]) -> bool:
    v = player.get(atom.field)
    t = atom.value
    try:
        if atom.op == "eq":
            return _eq(v, t)
        if atom.op == "ne":
            return not _eq(v, t)
        if atom.op == "in":
            return any(_eq(v, x) for x in t)
        if atom.op == "notin":
            return not any(_eq(v, x) for x in t)
        if v is None:
            return False
        if atom.op == "ge":
            return v >= t
        if atom.op == "le":
            return v <= t
        if atom.op == "gt":
            return v > t
        if atom.op == "lt":
            return v < t
    except TypeError:
        return False
    raise AssertionError(atom.op)


def eval_predicate(pred: Pred, player: dict[str, Any]) -> bool:
    if isinstance(pred, Const):
        return pred.value
    if isinstance(pred, Atom):
        return _atom_eval(pred, player)
    if isinstance(pred, And):
        return all(eval_predicate(p, player) for p in pred.items)
    if isinstance(pred, Or):
        return any(eval_predicate(p, player) for p in pred.items)
    if isinstance(pred, Not):
        return not eval_predicate(pred.item, player)
    raise TypeError(pred)


# ---------------------------------------------------------------------------
# DNF lowering (jitted-engine path)
# ---------------------------------------------------------------------------


def _negate_atom(atom: Atom) -> Pred:
    neg = {"eq": "ne", "ne": "eq", "ge": "lt", "lt": "ge", "le": "gt", "gt": "le", "in": "notin", "notin": "in"}
    return Atom(field=atom.field, op=neg[atom.op], value=atom.value)


def _push_not(pred: Pred) -> Pred:
    """Negation normal form."""
    if isinstance(pred, Not):
        inner = pred.item
        if isinstance(inner, Const):
            return Const(not inner.value)
        if isinstance(inner, Atom):
            return _negate_atom(inner)
        if isinstance(inner, And):
            return Or(tuple(_push_not(Not(p)) for p in inner.items))
        if isinstance(inner, Or):
            return And(tuple(_push_not(Not(p)) for p in inner.items))
        if isinstance(inner, Not):
            return _push_not(inner.item)
    if isinstance(pred, And):
        return And(tuple(_push_not(p) for p in pred.items))
    if isinstance(pred, Or):
        return Or(tuple(_push_not(p) for p in pred.items))
    return pred


MAX_DNF_TERMS = 64


def to_dnf(pred: Pred) -> list[list[Atom]]:
    """Lower a Pred to a list of conjunctive terms of atoms (OR of ANDs).

    ``in``/``notin`` atoms are expanded into eq/ne atoms. An empty term list
    means constant-False; a term that is an empty list means constant-True.
    """
    pred = _push_not(pred)

    def expand(p: Pred) -> list[list[Atom]]:
        if isinstance(p, Const):
            return [[]] if p.value else []
        if isinstance(p, Atom):
            if p.op == "in":
                if len(p.value) > MAX_DNF_TERMS:
                    raise PredicateError("predicate too complex (DNF blowup)")
                return [[Atom(p.field, "eq", v)] for v in p.value]
            if p.op == "notin":
                return [[Atom(p.field, "ne", v) for v in p.value]]
            return [[p]]
        if isinstance(p, Or):
            out: list[list[Atom]] = []
            for item in p.items:
                out.extend(expand(item))
                if len(out) > MAX_DNF_TERMS:
                    raise PredicateError("predicate too complex (DNF blowup)")
            return out
        if isinstance(p, And):
            terms: list[list[Atom]] = [[]]
            for item in p.items:
                sub = expand(item)
                # incremental cap: the full cross product must never be
                # materialized before the size check runs, or the guard
                # fails its memory purpose on e.g. two large `in` lists
                new: list[list[Atom]] = []
                for t in terms:
                    for s in sub:
                        new.append(t + s)
                        if len(new) > MAX_DNF_TERMS:
                            raise PredicateError(
                                "predicate too complex (DNF blowup)")
                terms = new
            return terms
        raise TypeError(p)

    return expand(pred)


def collect_atoms(pred: Pred) -> list[Atom]:
    """All eq/ne/cmp atoms appearing in the DNF of a predicate."""
    out: list[Atom] = []
    for term in to_dnf(pred):
        for a in term:
            if a not in out:
                out.append(a)
    return out
