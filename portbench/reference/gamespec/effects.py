"""Generic resolution-effect IR (P20) — novel mechanics without new kernels.

The reference's referee is an LLM that can apply *any* describable rule by
writing arbitrary player-state fields (reference:
agent/tools/backend_tools.py:204-225 `update_player_state`,
agent/prompt/referee_system_prompt_1.txt:6-88). Rounds 1-2 of this engine
determinized that power as a closed library of hand-written mechanic
families, each implemented four times (oracle / XLA / C++ / Pallas). This
module replaces the per-family kernels with a small declarative effect
language: guarded field writes over per-player integer expressions with
cross-player aggregations (incoming transfers, group counts, ranks,
argmax/argmin selectors). Each executor implements ONE interpreter for the
IR; a new mechanic family lands by writing IR + tests only.

Two entry points produce effect programs:

  * the analyzer re-expresses the P12 income / P13 raid / P19 auction
    families as IR programs (builders at the bottom of this module) —
    bit-identical traces to the retired bespoke kernels;
  * a DSL phase may declare its own program under the P18 `mechanics:` key:

        mechanics:
          - effects:
              - "let giver = chose(2) and alive and coins > 0 and choice != seat"
              - "coins += incoming(1, choice, giver) - if(giver, 1, 0)"

PINNED SEMANTICS (P20, see SEMANTICS.md):
  * A program is a sequence of BLOCKS (statement lists split on "---").
    Within a block every expression reads the block-entry snapshot of the
    state ("simultaneous" resolution — raids, trades and collisions resolve
    from pre-phase values); writes land in statement order, later writes to
    the same field override earlier ones. Blocks sequence: block k+1 reads
    the state written by block k.
  * Statements implicitly apply only to PRESENT seats of rooms entering the
    phase; cross-player aggregations (incoming / eqcount / rank / sum /
    count / argmax / ...) likewise range over present seats only.
  * All values are int32. Booleans are 0/1; comparisons yield 0/1; `and`,
    `or`, `not`, `if`, and `where` treat any nonzero value as true.
  * `kill` applies the standard death rule (P15): clears is_alive (when
    declared) and sets the role-reveal flags; a dead seat cannot die again.
  * Aggregation identities: empty sum/count = 0; empty max/min = 0; empty
    argmax/argmin = 0 (no player). argmax/argmin ties resolve to the LOWEST
    seat id (the P6 convention).

Expression surface (the textual mini-language):

  statements   let NAME = EXPR
               FIELD = EXPR [where EXPR]       (bool or num field)
               FIELD = 'literal' [where EXPR]  (string field; vocab-coded —
                                                conversion / recruitment)
               FIELD[KEY] = 'literal' [where EXPR]
                                               (player-keyed dict entry;
                                                keys outside 1..n no-op)
               FIELD += EXPR [where EXPR]      (num field)
               FIELD -= EXPR [where EXPR]
               kill [where EXPR]
               reset FIELD [where EXPR]         (restore template default)
               deal FIELD [salt EXPR] [where EXPR]
                                                (RNG-permute the field's
                                                 players_example multiset
                                                 over present seats — P10;
                                                 salt 0 = the initial deal,
                                                 a nonzero salt re-deals)
               over EXPR [where EXPR]           (end the game; winner =
                                                 EXPR at the lowest seat)
               ---                              (block separator)
  builtins     seat        1-based own seat id
               n_players   number of present seats in the room
               choice      own choice register (1-based target / option)
               alive       1 if is_alive (or present when undeclared)
               present     1 if the seat is occupied
               chose(ID[, ID...])  1 if the own choice register was recorded
                                   in one of the named DSL phases
  functions    min(a,b)  max(a,b)  abs(a)  clamp(x,lo,hi)  if(c,a,b)
               at(v, i)            v evaluated at seat i (0 if i invalid)
               incoming(v, k, m)   sum of v over seats q with k[q] == seat
                                   and m[q] (k defaults to choice, m to 1)
               eqcount(k[, m])     count of seats q with k[q] == k[self]
                                   and m[q] (includes self when m[self])
               rank(k[, m])        count of seats q < self with k[q] ==
                                   k[self] and m[q]
               sum(v[, m]) count(m) reduce_max(v[, m]) reduce_min(v[, m])
               argmax(k[, m]) argmin(k[, m])   winning seat id (ties low)
  operators    + - *   == != >= <= > <   and or not   ( )
               'string' literals only against string fields (== / !=)
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Union

from portbench.reference.gamespec.expr import Pred
from portbench.reference.gamespec.layout import (
    BANK_BOOL,
    BANK_NUM,
    BANK_ODICT,
    BANK_PDICT,
    BANK_STR,
    StateLayout,
)


class EffectError(ValueError):
    """Loud-or-correct: any malformed effect program raises (the validator
    surfaces it as an ERROR Issue; analyze() never silently drops one)."""


# ---------------------------------------------------------------------------
# Expression / statement AST (field references by NAME; lowering resolves)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EConst:
    value: int


@dataclasses.dataclass(frozen=True)
class EStrLit:
    """String literal — only legal compared (==/!=) against a string field."""

    value: str


@dataclasses.dataclass(frozen=True)
class EField:
    name: str


@dataclasses.dataclass(frozen=True)
class ESeat:
    pass


@dataclasses.dataclass(frozen=True)
class ENPlayers:
    pass


@dataclasses.dataclass(frozen=True)
class EChoice:
    pass


@dataclasses.dataclass(frozen=True)
class EChoseIn:
    """1 if the seat's choice register was recorded in one of these phases."""

    phases: frozenset[int]  # DSL phase ids


@dataclasses.dataclass(frozen=True)
class EAlive:
    pass


@dataclasses.dataclass(frozen=True)
class EPresent:
    pass


@dataclasses.dataclass(frozen=True)
class EPredRef:
    """Embedded selection-criteria predicate (analyzer-built programs)."""

    pred: Pred


@dataclasses.dataclass(frozen=True)
class EBin:
    op: str  # add sub mul min max
    a: "Expr"
    b: "Expr"


@dataclasses.dataclass(frozen=True)
class ECmp:
    op: str  # eq ne ge le gt lt
    a: "Expr"
    b: "Expr"


@dataclasses.dataclass(frozen=True)
class ENot:
    a: "Expr"


@dataclasses.dataclass(frozen=True)
class EAnd:
    a: "Expr"
    b: "Expr"


@dataclasses.dataclass(frozen=True)
class EOr:
    a: "Expr"
    b: "Expr"


@dataclasses.dataclass(frozen=True)
class EWhere:
    """if(c, a, b) — select."""

    c: "Expr"
    a: "Expr"
    b: "Expr"


@dataclasses.dataclass(frozen=True)
class EAt:
    """val evaluated at seat idx (1-based); 0 when idx out of [1, P]."""

    val: "Expr"
    idx: "Expr"


@dataclasses.dataclass(frozen=True)
class EIncoming:
    """sum over present seats q of val[q] where key[q] == own seat, mask[q]."""

    val: "Expr"
    key: "Expr"
    mask: "Expr"


@dataclasses.dataclass(frozen=True)
class EEqCount:
    """count of present seats q with key[q] == key[self] and mask[q]."""

    key: "Expr"
    mask: "Expr"


@dataclasses.dataclass(frozen=True)
class ERank:
    """count of present seats q < self with key[q] == key[self] and mask[q]."""

    key: "Expr"
    mask: "Expr"


@dataclasses.dataclass(frozen=True)
class EReduce:
    """Room-level reduction broadcast to all seats; empty mask -> 0."""

    kind: str  # sum max min count
    val: "Expr"
    mask: "Expr"


@dataclasses.dataclass(frozen=True)
class EArgBest:
    """1-based seat id of the max/min key over the mask; ties to the LOWEST
    seat id; 0 when the mask is empty (broadcast to all seats)."""

    kind: str  # max min
    key: "Expr"
    mask: "Expr"


Expr = Union[
    EConst, EStrLit, EField, ESeat, ENPlayers, EChoice, EChoseIn, EAlive,
    EPresent, EPredRef, EBin, ECmp, ENot, EAnd, EOr, EWhere, EAt, EIncoming,
    EEqCount, ERank, EReduce, EArgBest,
]

ONE = EConst(1)
ZERO = EConst(0)


@dataclasses.dataclass(frozen=True)
class SSet:
    field: str
    value: Expr
    where: Expr = ONE


@dataclasses.dataclass(frozen=True)
class SAdd:
    field: str
    value: Expr
    where: Expr = ONE


@dataclasses.dataclass(frozen=True)
class SKill:
    where: Expr = ONE


@dataclasses.dataclass(frozen=True)
class SReset:
    """reset FIELD — restore the declared template default (P9
    round-scoped resets; works on every bank)."""

    field: str
    where: Expr = ONE


@dataclasses.dataclass(frozen=True)
class SSetKey:
    """FIELD[KEY] = 'literal' — write one entry of a player-keyed dict
    field (the reference referee records per-player memories this way,
    e.g. investigated_alignments; backend_tools.py:204-225)."""

    field: str
    key: Expr
    value: Expr  # EStrLit (vocab-coded at lowering)
    where: Expr = ONE


@dataclasses.dataclass(frozen=True)
class SOver:
    """over EXPR — end the game with winner = EXPR (P11/P17 terminal
    rules as IR). Both the guard and the value are evaluated at the
    LOWEST seat (seat 1, always present) since terminal expressions are
    room-uniform aggregations; winner 0 means 'nobody'."""

    value: Expr
    where: Expr = ONE


@dataclasses.dataclass(frozen=True)
class SDeal:
    """deal FIELD [salt EXPR] [where EXPR] — RNG-permute the field's
    players_example multiset over the present seats (P10 as IR; the last
    bespoke kernel family, deleted from all four executors in round 4).

    Pinned semantics (SEMANTICS.md P10): seat q (0-based) draws the u32
    key splitmix32(seed*256 + q + u32(salt_q)*0x9E3779B9); absent seats
    key 0xFFFFFFFF; rank = stable ascending order (key ties to the lower
    seat). The written value is deal_multiset(counts, filler, n)[rank]
    for n present seats. With the default salt 0 this is bit-identical
    to the retired LRoleAssign kernel; a nonzero salt (e.g. a round
    counter) re-deals with a fresh permutation — mid-game re-deals the
    bespoke kernel could never express. The rank is computed over ALL
    present seats; `where` only gates which seats' writes land.

    (counts, filler) are resolved from the declaration's players_example
    by mechanics.resolve_deals; the parser leaves counts None and
    check_program rejects unresolved deals."""

    field: str
    # value name -> example-count weight; None until resolve_deals runs
    counts: Optional[tuple[tuple[str, int], ...]] = None
    filler: str = ""  # surplus seats take this (the most-common) value
    salt: Expr = ZERO
    where: Expr = ONE


def deal_multiset(counts, filler: str, n_players: int) -> list[str]:
    """The concrete n-player multiset a deal permutes (P10): replicate the
    example counts, extend with the filler, trim SURPLUS filler copies
    first (at least one filler always survives while trimming), then trim
    from the end of declaration order. Pinned by the golden fixture."""
    base: list[str] = []
    for name, c in counts:
        base.extend([name] * c)
    if len(base) < n_players:
        base.extend([filler] * (n_players - len(base)))
    elif len(base) > n_players:
        while len(base) > n_players and base.count(filler) > 1:
            base.remove(filler)
        while len(base) > n_players:
            base.pop()
    return base


Stmt = Union[SSet, SAdd, SKill, SReset, SSetKey, SOver, SDeal]
Block = tuple[Stmt, ...]
Program = tuple[Block, ...]  # blocks sequence; statements within a block
# read the block-entry snapshot


# ---------------------------------------------------------------------------
# Tokenizer + recursive-descent parser for the textual language
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+)"
    r"|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<str>'[^']*'|\"[^\"]*\")"
    r"|(?P<op>\+=|-=|==|!=|>=|<=|>|<|\+|-|\*|\(|\)|\[|\]|,|=))"
)

_KEYWORDS = frozenset({"let", "kill", "where", "and", "or", "not", "if"})
_BUILTIN_NAMES = {
    "seat": ESeat(),
    "n_players": ENPlayers(),
    "nplayers": ENPlayers(),
    "choice": EChoice(),
    "alive": EAlive(),
    "present": EPresent(),
    "true": EConst(1),
    "false": EConst(0),
}
# function name -> (min arity, max arity)
_FUNCS = {
    "chose": (1, 64),
    "min": (2, 2),
    "max": (2, 2),
    "abs": (1, 1),
    "clamp": (3, 3),
    "if": (3, 3),
    "at": (2, 2),
    "incoming": (1, 3),
    "eqcount": (1, 2),
    "rank": (1, 2),
    "sum": (1, 2),
    "count": (1, 1),
    "reduce_max": (1, 2),
    "reduce_min": (1, 2),
    "argmax": (1, 2),
    "argmin": (1, 2),
}


def _tokenize(src: str) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            rest = src[pos:].strip()
            if not rest:
                break
            raise EffectError(f"bad token at {rest[:20]!r} in {src!r}")
        pos = m.end()
        if m.group("num") is not None:
            out.append(("num", m.group("num")))
        elif m.group("name") is not None:
            out.append(("name", m.group("name")))
        elif m.group("str") is not None:
            out.append(("str", m.group("str")[1:-1]))
        else:
            out.append(("op", m.group("op")))
    out.append(("end", ""))
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]], env: dict[str, Expr]):
        self.toks = tokens
        self.i = 0
        self.env = env  # let-bindings, substituted inline

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_op(self, op: str) -> None:
        k, v = self.next()
        if k != "op" or v != op:
            raise EffectError(f"expected {op!r}, got {v!r}")

    # precedence: or < and < not < cmp < additive < multiplicative < unary
    def expr(self) -> Expr:
        return self.or_()

    def or_(self) -> Expr:
        a = self.and_()
        while self.peek() == ("name", "or"):
            self.next()
            a = EOr(a, self.and_())
        return a

    def and_(self) -> Expr:
        a = self.not_()
        while self.peek() == ("name", "and"):
            self.next()
            a = EAnd(a, self.not_())
        return a

    def not_(self) -> Expr:
        if self.peek() == ("name", "not"):
            self.next()
            return ENot(self.not_())
        return self.cmp()

    def cmp(self) -> Expr:
        a = self.add()
        k, v = self.peek()
        if k == "op" and v in ("==", "!=", ">=", "<=", ">", "<"):
            self.next()
            b = self.add()
            op = {"==": "eq", "!=": "ne", ">=": "ge", "<=": "le", ">": "gt", "<": "lt"}[v]
            return ECmp(op, a, b)
        return a

    def add(self) -> Expr:
        a = self.mul()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                b = self.mul()
                a = EBin("add" if v == "+" else "sub", a, b)
            else:
                return a

    def mul(self) -> Expr:
        a = self.unary()
        while self.peek() == ("op", "*"):
            self.next()
            a = EBin("mul", a, self.unary())
        return a

    def unary(self) -> Expr:
        if self.peek() == ("op", "-"):
            self.next()
            inner = self.unary()
            if isinstance(inner, EConst):
                # fold so -2147483648 (INT32_MIN) is representable: the
                # positive literal alone would fail the int32 range check
                return EConst(-inner.value)
            return EBin("sub", ZERO, inner)
        return self.atom()

    def atom(self) -> Expr:
        k, v = self.next()
        if k == "num":
            return EConst(int(v))
        if k == "str":
            return EStrLit(v)
        if k == "op" and v == "(":
            e = self.expr()
            self.expect_op(")")
            return e
        if k == "name":
            low = v.lower()
            if self.peek() == ("op", "("):
                return self.call(low)
            if low in self.env:
                return self.env[low]
            if low in _BUILTIN_NAMES:
                return _BUILTIN_NAMES[low]
            return EField(v)
        raise EffectError(f"unexpected token {v!r}")

    def call(self, fname: str) -> Expr:
        if fname not in _FUNCS:
            raise EffectError(f"unknown function {fname!r}()")
        self.expect_op("(")
        args: list[Expr] = []
        if self.peek() != ("op", ")"):
            args.append(self.expr())
            while self.peek() == ("op", ","):
                self.next()
                args.append(self.expr())
        self.expect_op(")")
        lo, hi = _FUNCS[fname]
        if not (lo <= len(args) <= hi):
            raise EffectError(
                f"{fname}() takes {lo}..{hi} arguments, got {len(args)}")
        a = args
        if fname == "chose":
            ids = []
            for e in a:
                if not isinstance(e, EConst):
                    raise EffectError("chose() arguments must be integer phase ids")
                ids.append(e.value)
            return EChoseIn(frozenset(ids))
        if fname == "min":
            return EBin("min", a[0], a[1])
        if fname == "max":
            return EBin("max", a[0], a[1])
        if fname == "abs":
            return EWhere(ECmp("ge", a[0], ZERO), a[0], EBin("sub", ZERO, a[0]))
        if fname == "clamp":
            return EBin("min", EBin("max", a[0], a[1]), a[2])
        if fname == "if":
            return EWhere(a[0], a[1], a[2])
        if fname == "at":
            return EAt(a[0], a[1])
        if fname == "incoming":
            key = a[1] if len(a) > 1 else EChoice()
            mask = a[2] if len(a) > 2 else ONE
            return EIncoming(a[0], key, mask)
        if fname == "eqcount":
            return EEqCount(a[0], a[1] if len(a) > 1 else ONE)
        if fname == "rank":
            return ERank(a[0], a[1] if len(a) > 1 else ONE)
        if fname == "sum":
            return EReduce("sum", a[0], a[1] if len(a) > 1 else ONE)
        if fname == "count":
            return EReduce("count", ONE, a[0])
        if fname == "reduce_max":
            return EReduce("max", a[0], a[1] if len(a) > 1 else ONE)
        if fname == "reduce_min":
            return EReduce("min", a[0], a[1] if len(a) > 1 else ONE)
        if fname == "argmax":
            return EArgBest("max", a[0], a[1] if len(a) > 1 else ONE)
        if fname == "argmin":
            return EArgBest("min", a[0], a[1] if len(a) > 1 else ONE)
        raise EffectError(f"unhandled function {fname!r}")  # pragma: no cover


def parse_statement(src: str, env: dict[str, Expr]) -> Optional[Stmt]:
    """Parse one statement line; `let` lines bind into env and return None."""
    toks = _tokenize(src)
    if toks[0] == ("end", ""):
        raise EffectError("empty statement")
    # let NAME = EXPR
    if toks[0] == ("name", "let"):
        if len(toks) < 4 or toks[1][0] != "name" or toks[2] != ("op", "="):
            raise EffectError(f"malformed let: {src!r}")
        name = toks[1][1].lower()
        if name in _KEYWORDS or name in _BUILTIN_NAMES or name in _FUNCS:
            raise EffectError(f"let name {name!r} shadows a builtin")
        p = _Parser(toks[3:], env)
        e = p.expr()
        if p.peek()[0] != "end":
            raise EffectError(f"trailing tokens in {src!r}")
        env[name] = e
        return None
    # kill [where EXPR]
    if toks[0] == ("name", "kill"):
        if toks[1][0] == "end":
            return SKill()
        if toks[1] != ("name", "where"):
            raise EffectError(f"malformed kill: {src!r}")
        p = _Parser(toks[2:], env)
        w = p.expr()
        if p.peek()[0] != "end":
            raise EffectError(f"trailing tokens in {src!r}")
        return SKill(where=w)
    # over EXPR [where EXPR]  (terminal winner rule; `over = ...` stays a
    # field write so a game may still declare a field literally named over)
    if (toks[0] == ("name", "over")
            and toks[1] not in (("op", "="), ("op", "["), ("op", "+="),
                                ("op", "-="))):
        p = _Parser(toks[1:], env)
        value = p.expr()
        where: Expr = ONE
        if p.peek() == ("name", "where"):
            p.next()
            where = p.expr()
        if p.peek()[0] != "end":
            raise EffectError(f"trailing tokens in {src!r}")
        return SOver(value, where)
    # deal FIELD [salt EXPR] [where EXPR]  (`deal = ...` stays a field
    # write so a game may still declare a field literally named deal)
    if (toks[0] == ("name", "deal") and len(toks) > 1
            and toks[1][0] == "name"
            and toks[1][1] not in ("where", "salt")):
        field = toks[1][1]
        p = _Parser(toks[2:], env)
        salt: Expr = ZERO
        where: Expr = ONE
        if p.peek() == ("name", "salt"):
            p.next()
            salt = p.expr()
        if p.peek() == ("name", "where"):
            p.next()
            where = p.expr()
        if p.peek()[0] != "end":
            raise EffectError(f"trailing tokens in {src!r}")
        return SDeal(field, salt=salt, where=where)
    # reset FIELD [where EXPR]
    if toks[0] == ("name", "reset") and len(toks) > 1 and toks[1][0] == "name":
        field = toks[1][1]
        if toks[2][0] == "end":
            return SReset(field)
        if toks[2] != ("name", "where"):
            raise EffectError(f"malformed reset: {src!r}")
        p = _Parser(toks[3:], env)
        w = p.expr()
        if p.peek()[0] != "end":
            raise EffectError(f"trailing tokens in {src!r}")
        return SReset(field, where=w)
    # FIELD (= | += | -=) EXPR [where EXPR]
    # FIELD [ KEY ] = EXPR [where EXPR]        (player-keyed dict write)
    if toks[0][0] != "name":
        raise EffectError(f"statement must start with a field name: {src!r}")
    field = toks[0][1]
    if toks[1] == ("op", "["):
        p = _Parser(toks[2:], env)
        key = p.expr()
        if p.next() != ("op", "]"):
            raise EffectError(f"missing ] in dict write: {src!r}")
        if p.next() != ("op", "="):
            raise EffectError(f"dict writes only support =: {src!r}")
        value = p.expr()
        where: Expr = ONE
        if p.peek() == ("name", "where"):
            p.next()
            where = p.expr()
        if p.peek()[0] != "end":
            raise EffectError(f"trailing tokens in {src!r}")
        return SSetKey(field, key, value, where)
    k, v = toks[1]
    if k != "op" or v not in ("=", "+=", "-="):
        raise EffectError(f"expected =, += or -= after {field!r}: {src!r}")
    p = _Parser(toks[2:], env)
    value = p.expr()
    where: Expr = ONE
    if p.peek() == ("name", "where"):
        p.next()
        where = p.expr()
    if p.peek()[0] != "end":
        raise EffectError(f"trailing tokens in {src!r}")
    if v == "=":
        return SSet(field, value, where)
    if v == "-=":
        value = EBin("sub", ZERO, value)
    return SAdd(field, value, where)


def parse_expr(src: str) -> Expr:
    """Parse one standalone guard/weight expression — the payload of a
    declared `vote_elimination: {protect:|weight: ...}` or
    `night_resolution: {protect: ...}` hint (P6p/P6w). Same surface as
    statement right-hand sides; no `let` environment."""
    toks = _tokenize(str(src))
    if toks[0] == ("end", ""):
        raise EffectError("empty guard/weight expression")
    p = _Parser(toks, {})
    e = p.expr()
    if p.peek()[0] != "end":
        raise EffectError(f"trailing tokens in expression {src!r}")
    return e


def parse_program(lines: list, *, strict_lines: bool = True,
                  reserved=frozenset()) -> Program:
    """Parse an `effects:` hint payload (list of statement strings; "---"
    entries split blocks) into a Program. `let` bindings are scoped to the
    whole program and substituted inline.

    `reserved` (the game's declared field names, passed by the analyzer
    and the validator) makes `let coins = ...` over a declared field a
    loud error: the binding would silently shadow every subsequent READ
    of the field while statement heads kept writing the real field —
    the parser substitutes env names before check_program can see the
    collision."""
    if isinstance(lines, (str, bytes)):
        lines = [lines]
    reserved = frozenset(reserved)
    env: dict[str, Expr] = {}
    blocks: list[Block] = []
    cur: list[Stmt] = []
    for raw in lines:
        s = str(raw).strip()
        if not s:
            continue
        if set(s) == {"-"}:  # block separator
            if cur:
                blocks.append(tuple(cur))
                cur = []
            continue
        before = set(env)
        st = parse_statement(s, env)
        clash = (set(env) - before) & reserved
        if clash:
            raise EffectError(
                f"let binding {sorted(clash)[0]!r} shadows a declared state "
                "field — rename the binding")
        if st is not None:
            cur.append(st)
    if cur:
        blocks.append(tuple(cur))
    if not blocks and strict_lines:
        raise EffectError("effect program has no statements")
    return tuple(blocks)


# ---------------------------------------------------------------------------
# Static checking (loud-or-correct)
# ---------------------------------------------------------------------------


_EXPR_TYPES = (
    EConst, EStrLit, EField, ESeat, ENPlayers, EChoice, EChoseIn, EAlive,
    EPresent, EPredRef, EBin, ECmp, ENot, EAnd, EOr, EWhere, EAt, EIncoming,
    EEqCount, ERank, EReduce, EArgBest,
)


def _walk(e: Expr):
    """Yield every Expr node (does not descend into EPredRef predicates)."""
    yield e
    if isinstance(e, EPredRef):
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, _EXPR_TYPES):
            yield from _walk(v)


def check_program(
    program: Program,
    layout: StateLayout,
    known_phase_ids: frozenset[int],
    *,
    has_alive: bool,
) -> None:
    """Raise EffectError on any reference the engine cannot execute."""

    def check_expr(e: Expr) -> None:
        for node in _walk(e):
            if isinstance(node, EField):
                slot = layout.get(node.name)
                if slot is None:
                    raise EffectError(f"unknown field {node.name!r}")
                if slot.bank not in (BANK_BOOL, BANK_NUM, BANK_STR):
                    raise EffectError(
                        f"field {node.name!r} is a {slot.bank} field — only "
                        "boolean, num and string fields are readable in effects")
            elif isinstance(node, EStrLit):
                pass  # context checked below
            elif isinstance(node, EConst):
                # all IR values are int32 (SEMANTICS.md); an out-of-range
                # literal would already differ between executors at load
                if not -(2**31) <= node.value <= 2**31 - 1:
                    raise EffectError(
                        f"constant {node.value} is outside int32 — all "
                        "effect values are 32-bit signed integers")
            elif isinstance(node, EChoseIn):
                for pid in node.phases:
                    if pid not in known_phase_ids:
                        raise EffectError(f"chose({pid}): no phase with id {pid}")
            elif isinstance(node, ECmp):
                for a, b in ((node.a, node.b), (node.b, node.a)):
                    if isinstance(a, EStrLit):
                        if node.op not in ("eq", "ne"):
                            raise EffectError(
                                "string literals only compare with == / !=")
                        if not isinstance(b, EField) or (
                                layout.get(b.name) is not None
                                and layout.slot(b.name).bank != BANK_STR):
                            raise EffectError(
                                f"string literal {a.value!r} must be compared "
                                "against a string field")
                        bslot = layout.get(b.name)
                        if bslot is not None and not any(
                                v.lower() == a.value.lower()
                                for v in bslot.vocab):
                            raise EffectError(
                                f"string literal {a.value!r} is not in the "
                                f"vocabulary of field {b.name!r} "
                                f"({', '.join(repr(v) for v in bslot.vocab if v)})"
                                " — the comparison could never be true")
                # field-vs-field compares involving a string field: the
                # executors compare vocab CODES, which only align when the
                # two fields share one vocabulary (each field's vocab is
                # mined independently in first-appearance order) — make
                # the silent-wrong cases loud instead
                fa, fb = node.a, node.b
                if isinstance(fa, EField) and isinstance(fb, EField):
                    sa, sb = layout.get(fa.name), layout.get(fb.name)
                    if (sa is not None and sb is not None
                            and BANK_STR in (sa.bank, sb.bank)):
                        if sa.bank != sb.bank:
                            raise EffectError(
                                f"{fa.name!r} and {fb.name!r} compare a "
                                "string field against a non-string field — "
                                "compare the string field against a "
                                "vocabulary literal instead")
                        if (fa.name != fb.name
                                and node.op in ("eq", "ne")
                                and tuple(v.lower() for v in sa.vocab)
                                != tuple(v.lower() for v in sb.vocab)):
                            raise EffectError(
                                f"{fa.name!r} and {fb.name!r} have different "
                                "vocabularies — their codes do not align, so "
                                "==/!= between them would be silently wrong; "
                                "give both fields identical example value "
                                "sets or compare against literals")
            elif isinstance(node, (EBin, EAnd, EOr, EWhere, EAt, EIncoming,
                                   EEqCount, ERank, EReduce, EArgBest, ENot)):
                for f in dataclasses.fields(node):
                    v = getattr(node, f.name)
                    if isinstance(v, EStrLit):
                        raise EffectError(
                            f"string literal {v.value!r} outside an ==/!= "
                            "comparison with a string field")

    for block in program:
        for st in block:
            if isinstance(st, SKill):
                check_expr(st.where)
                if not has_alive:
                    raise EffectError(
                        "kill requires a declared is_alive boolean field")
                continue
            if isinstance(st, SOver):
                if isinstance(st.value, EStrLit) or isinstance(st.where, EStrLit):
                    raise EffectError("string literals cannot be written")
                check_expr(st.value)
                check_expr(st.where)
                continue
            slot = layout.get(st.field)
            if slot is None:
                raise EffectError(f"unknown field {st.field!r} in write")
            if isinstance(st, SReset):
                if slot.bank not in (BANK_BOOL, BANK_NUM, BANK_STR,
                                     BANK_ODICT, BANK_PDICT):
                    raise EffectError(
                        f"reset target {st.field!r} is a {slot.bank} field — "
                        "only boolean, num, string and dict fields reset")
                check_expr(st.where)
                continue
            if isinstance(st, SDeal):
                if slot.bank != BANK_STR:
                    raise EffectError(
                        f"deal target {st.field!r} must be a string field "
                        f"(it is {slot.bank})")
                if st.counts is None:
                    raise EffectError(
                        f"deal target {st.field!r} has no players_example "
                        "values to deal — every example row must give the "
                        "field a value so the multiset is defined")
                for name in [n for n, _c in st.counts] + [st.filler]:
                    if not any(v.lower() == name.lower()
                               for v in slot.vocab):
                        raise EffectError(
                            f"deal multiset value {name!r} is not in the "
                            f"vocabulary of field {st.field!r}")
                if isinstance(st.salt, EStrLit) or isinstance(st.where, EStrLit):
                    raise EffectError("string literals cannot be written")
                check_expr(st.salt)
                check_expr(st.where)
                continue
            def _vocab_write_ok(lit: EStrLit) -> None:
                if lit.value == "":
                    return  # '' clears (code 0 is reserved for unset)
                if not any(v.lower() == lit.value.lower()
                           for v in slot.vocab):
                    raise EffectError(
                        f"string literal {lit.value!r} is not in the "
                        f"vocabulary of field {st.field!r} "
                        f"({', '.join(repr(v) for v in slot.vocab if v)})"
                        " — the write could never round-trip")

            if isinstance(st, SSetKey):
                # FIELD[KEY] = 'literal': player-keyed dict entry write
                if slot.bank != BANK_PDICT:
                    raise EffectError(
                        f"keyed write target {st.field!r} must be a "
                        f"player-keyed dict field (it is {slot.bank})")
                if not isinstance(st.value, EStrLit):
                    raise EffectError(
                        f"dict write to {st.field!r} takes a quoted literal "
                        "from the field's value vocabulary")
                _vocab_write_ok(st.value)
                if isinstance(st.key, EStrLit) or isinstance(st.where, EStrLit):
                    raise EffectError("string literals cannot be written")
                check_expr(st.key)
                check_expr(st.where)
                continue
            if isinstance(st, SAdd) and slot.bank != BANK_NUM:
                raise EffectError(
                    f"+= / -= target {st.field!r} must be a num field "
                    f"(it is {slot.bank})")
            if isinstance(st, SSet) and slot.bank == BANK_STR:
                # FIELD = 'literal': vocab-coded string write (conversion /
                # recruitment mechanics — team flips, role changes; the
                # reference referee writes these freely via
                # update_player_state, backend_tools.py:204-225)
                if not isinstance(st.value, EStrLit):
                    raise EffectError(
                        f"string field {st.field!r} can only be assigned a "
                        "quoted literal from its vocabulary")
                _vocab_write_ok(st.value)
                if isinstance(st.where, EStrLit):
                    raise EffectError("string literals cannot be written")
                check_expr(st.where)
                continue
            if isinstance(st, SSet) and slot.bank not in (BANK_BOOL, BANK_NUM):
                raise EffectError(
                    f"= target {st.field!r} must be a boolean, num or "
                    f"string field (it is {slot.bank})")
            if isinstance(st.value, EStrLit) or isinstance(st.where, EStrLit):
                raise EffectError("string literals cannot be written")
            check_expr(st.value)
            check_expr(st.where)


def program_fields(program: Program) -> set[str]:
    """Every field name the program reads or writes (validator bookkeeping)."""
    out: set[str] = set()
    for block in program:
        for st in block:
            if not isinstance(st, (SKill, SOver)):
                out.add(st.field)
            for e in _stmt_exprs(st):
                for node in _walk(e):
                    if isinstance(node, EField):
                        out.add(node.name)
    return out


def _stmt_exprs(st: Stmt) -> tuple:
    if isinstance(st, (SKill, SReset)):
        return (st.where,)
    if isinstance(st, SDeal):
        return (st.salt, st.where)
    if isinstance(st, SSetKey):
        return (st.key, st.value, st.where)
    return (st.value, st.where)


def program_choice_phases(program: Program) -> set[int]:
    """DSL phase ids consumed through chose() registers."""
    out: set[int] = set()
    for block in program:
        for st in block:
            for e in _stmt_exprs(st):
                for node in _walk(e):
                    if isinstance(node, EChoseIn):
                        out |= node.phases
    return out


# ---------------------------------------------------------------------------
# Lowering: AST -> flat node pool (shared encoding for XLA / Pallas / C++)
# ---------------------------------------------------------------------------
#
# A lowered block is (nodes, stmts):
#   nodes: tuple of 4-int rows [kind, p0, p1, p2], children strictly before
#          parents, deduplicated — an expression DAG in evaluation order;
#   stmts: tuple of 6-int rows [skind, bank, slot, value_node,
#   where_node, key_node] — key_node carries ST_SETD keys and ST_DEAL
#   salt nodes, 0 elsewhere.
# The encoding is position-independent ints only, so native/pack.py ships it
# to the C++ simulator verbatim.

(NK_CONST, NK_FIELD, NK_SEAT, NK_NPLAYERS, NK_CHOICE, NK_CHOSEIN, NK_ALIVE,
 NK_PRESENT, NK_PRED, NK_BIN, NK_CMP, NK_NOT, NK_AND, NK_OR, NK_WHERE,
 NK_AT, NK_INCOMING, NK_EQCOUNT, NK_RANK, NK_REDUCE, NK_ARGBEST) = range(21)

BIN_ADD, BIN_SUB, BIN_MUL, BIN_MIN, BIN_MAX = range(5)
_BIN_CODE = {"add": BIN_ADD, "sub": BIN_SUB, "mul": BIN_MUL,
             "min": BIN_MIN, "max": BIN_MAX}
RED_SUM, RED_MAX, RED_MIN, RED_COUNT = range(4)
_RED_CODE = {"sum": RED_SUM, "max": RED_MAX, "min": RED_MIN,
             "count": RED_COUNT}
ARG_MAX, ARG_MIN = range(2)
_ARG_CODE = {"max": ARG_MAX, "min": ARG_MIN}
_CMP_CODE = {"eq": 0, "ne": 1, "ge": 2, "le": 3, "gt": 4, "lt": 5}  # OP_*

ST_SET, ST_ADD, ST_KILL, ST_RESET, ST_SETD, ST_OVER, ST_DEAL = range(7)
# bank codes in stmt rows / NK_FIELD — match tables.AB_*
FXB_BOOL, FXB_NUM, FXB_STR, FXB_ODICT, FXB_PDICT = range(5)

# stmt rows are 6 ints: (kind, bank, slot, value_node, where_node, key_node);
# key_node is meaningful only for ST_SETD (player-keyed dict entry writes)
LoweredBlock = tuple[tuple[tuple[int, int, int, int], ...],
                     tuple[tuple[int, int, int, int, int, int], ...]]


class _NodePool:
    def __init__(self):
        self.rows: list[tuple[int, int, int, int]] = []
        self.index: dict[tuple[int, int, int, int], int] = {}

    def add(self, kind: int, p0: int = 0, p1: int = 0, p2: int = 0) -> int:
        row = (int(kind), int(p0), int(p1), int(p2))
        if row not in self.index:
            self.index[row] = len(self.rows)
            self.rows.append(row)
        return self.index[row]


def lower_program(
    program: Program,
    layout: StateLayout,
    add_pred,  # Callable[[Pred], int] — tables._PredPool.add_pred
    phase_mask_words,  # Callable[[frozenset[int]], tuple[int, int]]
    has_alive: bool,
    deal_tables: Optional[list] = None,  # out: (P+1, P) int-tuple tables
    max_players: int = 0,  # table height for ST_DEAL rows
) -> tuple[LoweredBlock, ...]:
    """Lower a checked Program into flat blocks (ints only).

    ST_DEAL statements expand their (counts, filler) multisets into
    vocab-coded (max_players+1, max_players) tables appended to
    `deal_tables` (the stmt row's value slot holds the table index).
    Callers lowering deal-bearing programs must pass both a sink list and
    the game's max seat count, and carry the tables alongside the blocks
    (tables.LEffect.deal_tables)."""

    def lower_block(block: Block) -> LoweredBlock:
        pool = _NodePool()

        def lx(e: Expr) -> int:
            if isinstance(e, EConst):
                return pool.add(NK_CONST, e.value)
            if isinstance(e, EField):
                slot = layout.slot(e.name)
                bank = {BANK_BOOL: FXB_BOOL, BANK_NUM: FXB_NUM,
                        BANK_STR: FXB_STR}[slot.bank]
                return pool.add(NK_FIELD, bank, slot.index)
            if isinstance(e, ESeat):
                return pool.add(NK_SEAT)
            if isinstance(e, ENPlayers):
                return pool.add(NK_NPLAYERS)
            if isinstance(e, EChoice):
                return pool.add(NK_CHOICE)
            if isinstance(e, EChoseIn):
                lo, hi = phase_mask_words(e.phases)
                return pool.add(NK_CHOSEIN, lo, hi)
            if isinstance(e, EAlive):
                return pool.add(NK_ALIVE) if has_alive else pool.add(NK_PRESENT)
            if isinstance(e, EPresent):
                return pool.add(NK_PRESENT)
            if isinstance(e, EPredRef):
                return pool.add(NK_PRED, add_pred(e.pred))
            if isinstance(e, EBin):
                return pool.add(NK_BIN, _BIN_CODE[e.op], lx(e.a), lx(e.b))
            if isinstance(e, ECmp):
                a, b = e.a, e.b
                op = e.op
                # string-literal compares lower to encoded code compares
                if isinstance(a, EStrLit) and isinstance(b, EField):
                    a, b = b, a
                if isinstance(b, EStrLit):
                    code = layout.slot(a.name).encode(b.value)
                    return pool.add(NK_CMP, _CMP_CODE[op], lx(a),
                                    pool.add(NK_CONST, code))
                return pool.add(NK_CMP, _CMP_CODE[op], lx(a), lx(b))
            if isinstance(e, ENot):
                return pool.add(NK_NOT, lx(e.a))
            if isinstance(e, EAnd):
                return pool.add(NK_AND, lx(e.a), lx(e.b))
            if isinstance(e, EOr):
                return pool.add(NK_OR, lx(e.a), lx(e.b))
            if isinstance(e, EWhere):
                return pool.add(NK_WHERE, lx(e.c), lx(e.a), lx(e.b))
            if isinstance(e, EAt):
                return pool.add(NK_AT, lx(e.val), lx(e.idx))
            if isinstance(e, EIncoming):
                return pool.add(NK_INCOMING, lx(e.val), lx(e.key), lx(e.mask))
            if isinstance(e, EEqCount):
                return pool.add(NK_EQCOUNT, lx(e.key), lx(e.mask))
            if isinstance(e, ERank):
                return pool.add(NK_RANK, lx(e.key), lx(e.mask))
            if isinstance(e, EReduce):
                return pool.add(NK_REDUCE, _RED_CODE[e.kind], lx(e.val),
                                lx(e.mask))
            if isinstance(e, EArgBest):
                return pool.add(NK_ARGBEST, _ARG_CODE[e.kind], lx(e.key),
                                lx(e.mask))
            raise EffectError(f"cannot lower {type(e).__name__}")

        stmts: list[tuple[int, int, int, int, int, int]] = []
        for st in block:
            if isinstance(st, SKill):
                stmts.append((ST_KILL, 0, 0, 0, lx(st.where), 0))
                continue
            if isinstance(st, SOver):
                stmts.append((ST_OVER, 0, 0, lx(st.value), lx(st.where), 0))
                continue
            if isinstance(st, SReset):
                slot = layout.slot(st.field)
                if slot.bank == BANK_ODICT:
                    stmts.append((ST_RESET, FXB_ODICT, slot.index, 0,
                                  lx(st.where), 0))
                elif slot.bank == BANK_PDICT:
                    stmts.append((ST_RESET, FXB_PDICT, slot.index, 0,
                                  lx(st.where), 0))
                elif slot.bank == BANK_STR:
                    stmts.append((ST_SET, FXB_STR, slot.index,
                                  pool.add(NK_CONST, slot.encode(slot.default)),
                                  lx(st.where), 0))
                elif slot.bank == BANK_BOOL:
                    stmts.append((ST_SET, FXB_BOOL, slot.index,
                                  pool.add(NK_CONST, 1 if slot.default else 0),
                                  lx(st.where), 0))
                elif slot.bank == BANK_NUM:
                    try:
                        dv = int(slot.default or 0)
                    except (TypeError, ValueError):
                        dv = 0  # non-numeric template default reads as 0
                        # everywhere (tables.num_default does the same)
                    stmts.append((ST_SET, FXB_NUM, slot.index,
                                  pool.add(NK_CONST, dv),
                                  lx(st.where), 0))
                else:  # arr and friends never pass check_program
                    raise EffectError(
                        f"reset target {st.field!r} is a {slot.bank} field")
                continue
            if isinstance(st, SDeal):
                # deal FIELD — vocab-coded multiset table, RNG-permuted
                # assignment (P10 as IR). Table row n is the n-player
                # multiset, 0-padded to max_players columns; row 0 all-pad.
                slot = layout.slot(st.field)
                if st.counts is None:
                    raise EffectError(
                        f"deal {st.field!r} was not resolved before lowering")
                if deal_tables is None or max_players <= 0:
                    raise EffectError(
                        "deal statement lowered without a deal_tables sink")
                table = tuple(
                    tuple(slot.encode(name) for name in
                          deal_multiset(st.counts, st.filler, n))
                    + (0,) * (max_players - n)
                    for n in range(max_players + 1)
                )
                deal_tables.append(table)
                stmts.append((ST_DEAL, FXB_STR, slot.index,
                              len(deal_tables) - 1, lx(st.where),
                              lx(st.salt)))
                continue
            if isinstance(st, SSetKey):
                # FIELD[KEY] = 'literal' — vocab-coded pdict entry write
                slot = layout.slot(st.field)
                code = slot.encode(st.value.value)
                stmts.append((ST_SETD, FXB_PDICT, slot.index,
                              pool.add(NK_CONST, code), lx(st.where),
                              lx(st.key)))
                continue
            slot = layout.slot(st.field)
            if isinstance(st, SSet) and slot.bank == BANK_STR:
                # FIELD = 'literal' — vocab-coded string write (conversion)
                code = slot.encode(st.value.value)
                stmts.append((ST_SET, FXB_STR, slot.index,
                              pool.add(NK_CONST, code), lx(st.where), 0))
                continue
            bank = {BANK_BOOL: FXB_BOOL, BANK_NUM: FXB_NUM}[slot.bank]
            skind = ST_SET if isinstance(st, SSet) else ST_ADD
            stmts.append((skind, bank, slot.index, lx(st.value), lx(st.where),
                          0))
        return tuple(pool.rows), tuple(stmts)

    return tuple(lower_block(b) for b in program)


# ---------------------------------------------------------------------------
# Analyzer builders: P12 / P13 / P19 as IR programs
# ---------------------------------------------------------------------------


def income_program(gains: tuple[tuple[str, int], ...]) -> Program:
    """P12: every present living player gains the fixed amounts."""
    stmts = tuple(SAdd(field, EConst(amount), where=EAlive())
                  for field, amount in gains)
    return (stmts,)


def raid_program(raid_phases: frozenset[int], raider_pred: Pred,
                 res_field: str) -> Program:
    """P13: simultaneous raids from the TARGET register (SEMANTICS.md).

    Each target loses min(max(res, 0), #raiders), distributed one coin
    apiece to its lowest-id raiders; all reads from pre-phase values."""
    raider = EAnd(
        EAnd(EChoseIn(raid_phases), EPredRef(raider_pred)),
        EAnd(EAlive(), ECmp("ne", EChoice(), ESeat())),
    )
    tgt = EWhere(raider, EChoice(), ZERO)
    n_raiders = EIncoming(ONE, tgt, raider)
    loss = EBin("min", EBin("max", EField(res_field), ZERO), n_raiders)
    rank = ERank(tgt, raider)
    gain = EAnd(ECmp("gt", tgt, ZERO), ECmp("lt", rank, EAt(loss, tgt)))
    return ((SAdd(res_field, EBin("sub", gain, loss)),),)


def auction_program(bid_field: str, bidder_pred: Pred, res_field: str,
                    prize_field: str, bid_default: int) -> Program:
    """P19: sealed-bid auction — highest effective bid wins, ties to the
    lowest seat; the winner pays from the purse and gains +1 prize; bids
    reset so stale values cannot win later rounds."""
    bidder = EAnd(EPredRef(bidder_pred), EAlive())
    eff_raw = EBin("max",
                   EBin("min", EField(bid_field),
                        EBin("max", EField(res_field), ZERO)),
                   ZERO)
    eff = EWhere(bidder, eff_raw, ZERO)
    winner = EArgBest("max", eff, ECmp("ge", eff, ONE))
    is_winner = ECmp("eq", ESeat(), winner)
    return ((
        SAdd(res_field, EBin("sub", ZERO, eff), where=is_winner),
        SAdd(prize_field, ONE, where=is_winner),
        SSet(bid_field, EConst(bid_default)),
    ),)


def _plurality_expr(phases: frozenset[int], pred: Pred,
                    weight: Optional[Expr] = None) -> Expr:
    """P6 plurality as IR: the 1-based seat receiving the most choices from
    seats whose register was recorded in `phases` and who still match
    `pred`; ties to the LOWEST candidate seat (EArgBest pins it); 0 when no
    votes. Bit-identical to the retired _plurality kernels: votes received
    by seat s = |{q present: choice[q] == s, chose-in-phase, pred(q)}|,
    winner = lowest seat of the max count when any count >= 1.

    `weight` (declared vote_elimination {weight: ...} hint, P6w) evaluates
    per VOTER seat — "counts double" rules; None keeps the 1-per-voter
    default bit-identical to rounds 1-4."""
    voter = EAnd(EChoseIn(phases), EPredRef(pred))
    votes = EIncoming(weight if weight is not None else ONE,
                      EChoice(), voter)
    return EArgBest("max", votes, ECmp("ge", votes, ONE))


def vote_elim_program(vote_phases: frozenset[int], voter_pred: Pred,
                      protect: Optional[Expr] = None,
                      weight: Optional[Expr] = None) -> Program:
    """P6: plurality elimination — the seat with the most votes dies (P15
    reveal via the kill statement's reveal_bools); zero votes => no effect;
    a dead target stays dead with no new reveal (the `alive` gate).

    Declared-hint extensions (P6p/P6w, SEMANTICS.md):
      protect — guard expression evaluated at the VICTIM seat; a seat
        matching it cannot die from this vote ("cannot be eliminated
        while..." house rules);
      weight  — per-voter vote weight expression ("counts double")."""
    victim = _plurality_expr(vote_phases, voter_pred, weight)
    where = EAnd(ECmp("eq", ESeat(), victim), EAlive())
    if protect is not None:
        where = EAnd(where, ENot(protect))
    return ((SKill(where=where),),)


def night_resolve_program(
    kill_phases: frozenset[int], protect_phases: frozenset[int],
    kill_pred: Pred, protect_pred: Pred,
    resets: tuple[str, ...],
    protect: Optional[Expr] = None,
) -> Program:
    """P7: kill target = plurality of killer-phase choices, protection =
    plurality of protector-phase choices; the kill succeeds iff the target
    is alive and differs from the protected seat. Night bookkeeping fields
    then reset to their template defaults ((field, default) pairs) — one
    block: every read is the phase-entry snapshot, resets land after the
    death writes exactly like the retired kernels.

    `protect` (declared night_resolution {protect: ...} hint, P6p) is an
    extra victim-seat guard beyond the doctor's choice — state-based
    immunity house rules; None keeps rounds 1-4 bit-identical."""
    kt = _plurality_expr(kill_phases, kill_pred)
    pt = _plurality_expr(protect_phases, protect_pred)
    die = EAnd(EAnd(ECmp("eq", ESeat(), kt), ECmp("ne", kt, pt)), EAlive())
    if protect is not None:
        die = EAnd(die, ENot(protect))
    stmts: list = [SKill(where=die)]
    stmts.extend(SReset(f) for f in resets)
    return (tuple(stmts),)


def minority_program(pick_field: str, picker_pred: Pred, score_field: str,
                     n_options: int) -> Program:
    """P16: smallest non-empty pick group scores. Group sizes via eqcount
    over living pickers with in-range picks; the winning option is read off
    the seat minimizing count*(C+1) + pick (least-picked group first, then
    lowest option index — the pinned tie order); a lone group (fewer than
    two distinct options) scores nobody. Picks reset so stale values can't
    score next round."""
    pick = EField(pick_field)
    grouped = EAnd(
        EAnd(EPredRef(picker_pred), EAlive()),
        EAnd(ECmp("ge", pick, ONE), ECmp("le", pick, EConst(n_options))),
    )
    cnt = EEqCount(pick, grouped)
    key = EBin("add", EBin("mul", cnt, EConst(n_options + 1)), pick)
    win_opt = EAt(pick, EArgBest("min", key, grouped))
    leaders = EAnd(grouped, ECmp("eq", ERank(pick, grouped), ZERO))
    two_groups = ECmp("ge", EReduce("count", ONE, leaders), EConst(2))
    gain = EAnd(EAnd(grouped, ECmp("eq", pick, win_opt)), two_groups)
    return ((
        SAdd(score_field, ONE, where=gain),
        SReset(pick_field),
    ),)


def set_bool_all_program(fields: tuple[str, ...]) -> Program:
    """Reveal effects: set each boolean for every present player."""
    return (tuple(SSet(f, ONE) for f in fields),)


def guess_score_program(speaker_field: str, lie_field: str, vote_field: str,
                        voted_field: Optional[str], score_field: str,
                        rounds_field: Optional[str]) -> Program:
    """P8: each voter whose choice equals the speaker's lie index gains +1;
    the speaker gains +1 per voter who voted and was wrong ("fooled"); the
    speaker's rounds counter increments. Speaker = lowest-id present seat
    with the speaker flag; no speaker => no effect."""
    if not speaker_field:
        return ((),)
    sp = EArgBest("min", ESeat(), EField(speaker_field))
    has_sp = ECmp("ge", sp, ONE)
    lie = EAt(EField(lie_field), sp)
    voted: Expr = EField(voted_field) if voted_field else ONE
    is_voter = EAnd(voted, ECmp("ne", ESeat(), sp))
    correct = EAnd(is_voter, ECmp("eq", EField(vote_field), lie))
    fooled = EReduce("count", ONE, EAnd(is_voter, ENot(correct)))
    is_sp = ECmp("eq", ESeat(), sp)
    stmts: list = [
        SAdd(score_field, ONE, where=EAnd(correct, has_sp)),
        SAdd(score_field, fooled, where=is_sp),
    ]
    if rounds_field:
        stmts.append(SAdd(rounds_field, ONE, where=is_sp))
    return (tuple(stmts),)


def bluff_challenge_program(claim_field: str, challenge_phases: frozenset[int],
                            claimant_pred: Pred, challenger_pred: Pred,
                            role_field: str, roles: tuple[str, ...],
                            lives_field: str) -> Program:
    """P14: Coup-style claim/challenge resolution (SEMANTICS.md).

    One block — every read is the phase-entry snapshot, so losses
    accumulate simultaneously from pre-phase lives. Per challenger q the
    "lowest-id challenger of q's target" flag is rank(target, valid)==0;
    per claimant p, truth is the or-chain of (claim==k) and
    (role=='roles[k]') string compares. A seat can lose twice (lying
    claimant who is also the first challenger of an honest claim). Death
    = lost at least one life and lives hit 0 (the max-clamp floor)."""
    alive_claim = EAnd(EPredRef(claimant_pred), EAlive())
    claim = EWhere(alive_claim, EField(claim_field), ZERO)
    chal = EAnd(EAnd(EChoseIn(challenge_phases), EPredRef(challenger_pred)),
                EAlive())
    tgt = EWhere(EAnd(chal, ECmp("ne", EChoice(), ESeat())), EChoice(), ZERO)
    valid = ECmp("ge", tgt, ONE)
    first = EAnd(valid, ECmp("eq", ERank(tgt, valid), ZERO))
    challenged = ECmp("ge", EIncoming(ONE, tgt, valid), ONE)
    contested = EAnd(challenged, ECmp("ge", claim, ONE))
    truth: Expr = ZERO
    for k, rname in enumerate(roles):
        hit = EAnd(ECmp("eq", claim, EConst(k + 1)),
                   ECmp("eq", EField(role_field), EStrLit(rname)))
        truth = hit if truth is ZERO else EOr(truth, hit)
    honest = EAnd(contested, truth)
    lying = EAnd(contested, ENot(truth))
    loss = EBin("add", lying, EAnd(first, EAt(honest, tgt)))
    lives = EField(lives_field)
    return ((
        SSet(lives_field, EBin("max", EBin("sub", lives, loss), ZERO)),
        SKill(where=EAnd(EAnd(ECmp("ge", loss, ONE),
                              ECmp("le", EBin("sub", lives, loss), ZERO)),
                         EAlive())),
    ),)


def speaker_rotate_program(speaker_field: str, rounds_field: str,
                           can_vote_field: Optional[str],
                           reset_fields: tuple[str, ...]) -> Program:
    """P9: next speaker = present player with the minimum rounds counter,
    ties to the lowest seat (argmin pins both); can_vote = not is_speaker;
    round-scoped fields (any bank, including dict banks) reset to their
    template defaults via `reset`."""
    sp = EArgBest("min", EField(rounds_field), ONE)
    is_sp = ECmp("eq", ESeat(), sp)
    stmts: list = [SSet(speaker_field, is_sp)]
    if can_vote_field:
        stmts.append(SSet(can_vote_field, ENot(is_sp)))
    stmts.extend(SReset(f) for f in reset_fields)
    return (tuple(stmts),)


def game_over_program(mode: str, team_field: Optional[str] = None,
                      team_order: tuple = (),
                      score_field: Optional[str] = None) -> Program:
    """P11/P17: terminal winner rules as ONE IR statement — the last
    bespoke scoring kernels deleted from all four executors (VERDICT r4).

    * team:     winner = 1 + index of the FIRST team (minority-first
                order) whose living-member count equals the max count
                (reference tie rule: ties favor the minority team).
    * survivor: winner = lowest living seat, 0 when none.
    * score:    winner = argmax of the score field over present seats,
                ties to the lowest seat (P6 convention).
    * none:     winner = 0.
    """
    if mode == "team" and team_field and team_order:
        alive = EAlive()
        counts = [EReduce("count", ONE,
                          EAnd(ECmp("eq", EField(team_field), EStrLit(str(t))),
                               alive))
                  for t in team_order]
        best = counts[0]
        for c in counts[1:]:
            best = EBin("max", best, c)
        win: Expr = ZERO
        for idx in range(len(team_order) - 1, -1, -1):
            win = EWhere(ECmp("eq", counts[idx], best), EConst(idx + 1), win)
        return ((SOver(win),),)
    if mode == "survivor":
        return ((SOver(EArgBest("min", ESeat(), EAlive())),),)
    if mode == "score" and score_field:
        return ((SOver(EArgBest("max", EField(score_field), ONE)),),)
    return ((SOver(ZERO),),)


def game_over_program_for(go, layout: StateLayout) -> Program:
    """game_over_program with the legacy kernels' field guards: a team
    mode whose team field is missing/non-string (or with no team order)
    and a score mode whose score field is missing/non-num degrade to
    winner = 0, exactly like the retired bespoke kernels' else-branches."""
    mode = go.mode
    if mode == "team":
        ts = layout.get(go.team_field) if go.team_field else None
        if ts is None or ts.bank != BANK_STR or not go.team_order:
            mode = "none"
    if mode == "score":
        ss = layout.get(go.score_field) if go.score_field else None
        if ss is None or ss.bank != BANK_NUM:
            mode = "none"
    return game_over_program(mode, go.team_field or None,
                             tuple(go.team_order), go.score_field or None)
