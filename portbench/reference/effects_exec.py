"""A frozen copy of the port's core/effects_exec.py, kept here so that the reference
shares no code with the program.

Effect-IR interpreter for the plain-torch step (P20).

Counterpart of game_engine_tpu/core/effects_exec.py. The expression DAG is
walked in pool order (children strictly before parents), one tensor per
node; statements then write through the ops adapter (core/step._EffectOps)
in declared order. Every expression of a block reads the snapshot taken at
the block's start.

The ops protocol (step._EffectOps implements it):
  snapshot()                 capture the read-state for the next block
  const(v)                   0-d int32 literal
  field(bank, slot)          FXB_BOOL / FXB_NUM / FXB_STR bank read
  seat() nplayers() choice() chosein(lo, hi) alive() present_i() pred(i)
  bin(op, a, b) cmp(op, a, b) not_(a) and_(a, b) or_(a, b) where_(c, a, b)
  at(val, idx)  incoming(val, key, mask)  eqcount(key, mask)  rank(key, mask)
  reduce(kind, val, mask)  argbest(kind, key, mask)
  argbest_ranged(kind, key, mask, key_range)
  stmt_mask(where_val, active) -> write mask (AND present AND active)
  write_bool / write_num / write_str / write_pdict / reset_dict / deal
  kill(mask, reveal_slots)  game_over(val, mask)  flush()
"""

from __future__ import annotations

from portbench.reference.gamespec import effects as FX

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1
_FULL_RANGE = (_I32_MIN, _I32_MAX)


def _clip_range(cand):
    return cand if _I32_MIN <= cand[0] and cand[1] <= _I32_MAX else _FULL_RANGE


def static_ranges(nodes, P: int) -> list:
    """Abstract int32 value range per node (Python ints).

    Constants, seat/count builtins and aggregation arities give tight
    bounds; field and choice reads are unknown (full int32). Feeds
    ops.argbest_ranged, which packs a key with a proven small range and the
    seat tie-break into one reduce. Bounds that could overflow widen to the
    full range, so packing is never tried where it could wrap."""
    out: list = []
    for kind, p0, p1, p2 in nodes:
        if kind == FX.NK_CONST:
            r = (p0, p0)
        elif kind == FX.NK_SEAT:
            r = (1, P)
        elif kind == FX.NK_NPLAYERS:
            r = (0, P)
        elif kind in (FX.NK_CHOSEIN, FX.NK_ALIVE, FX.NK_PRESENT,
                      FX.NK_PRED, FX.NK_CMP, FX.NK_NOT, FX.NK_AND,
                      FX.NK_OR):
            r = (0, 1)
        elif kind == FX.NK_BIN:
            (alo, ahi), (blo, bhi) = out[p1], out[p2]
            if p0 == FX.BIN_ADD:
                cand = (alo + blo, ahi + bhi)
            elif p0 == FX.BIN_SUB:
                cand = (alo - bhi, ahi - blo)
            elif p0 == FX.BIN_MUL:
                prods = (alo * blo, alo * bhi, ahi * blo, ahi * bhi)
                cand = (min(prods), max(prods))
            elif p0 == FX.BIN_MIN:
                cand = (min(alo, blo), min(ahi, bhi))
            else:
                cand = (max(alo, blo), max(ahi, bhi))
            r = _clip_range(cand)
        elif kind == FX.NK_WHERE:
            (alo, ahi), (blo, bhi) = out[p1], out[p2]
            r = (min(alo, blo), max(ahi, bhi))
        elif kind == FX.NK_AT:
            lo, hi = out[p0]
            r = (min(lo, 0), max(hi, 0))  # invalid index reads 0
        elif kind == FX.NK_INCOMING:
            lo, hi = out[p0]
            r = _clip_range((min(0, P * lo), max(0, P * hi)))
        elif kind in (FX.NK_EQCOUNT, FX.NK_RANK):
            r = (0, P)
        elif kind == FX.NK_REDUCE:
            if p0 == FX.RED_COUNT:
                r = (0, P)
            elif p0 == FX.RED_SUM:
                lo, hi = out[p1]
                r = _clip_range((min(0, P * lo), max(0, P * hi)))
            else:  # masked max/min; empty reduces to 0
                lo, hi = out[p1]
                r = (min(lo, 0), max(hi, 0))
        elif kind == FX.NK_ARGBEST:
            r = (0, P)
        else:  # NK_FIELD, NK_CHOICE: unknown
            r = _FULL_RANGE
        out.append(r)
    return out


def _eval_node(kind: int, p0: int, p1: int, p2: int, vals: list, ops, ranges):
    if kind == FX.NK_CONST:
        return ops.const(p0)
    if kind == FX.NK_FIELD:
        return ops.field(p0, p1)
    if kind == FX.NK_SEAT:
        return ops.seat()
    if kind == FX.NK_NPLAYERS:
        return ops.nplayers()
    if kind == FX.NK_CHOICE:
        return ops.choice()
    if kind == FX.NK_CHOSEIN:
        return ops.chosein(p0, p1)
    if kind == FX.NK_ALIVE:
        return ops.alive()
    if kind == FX.NK_PRESENT:
        return ops.present_i()
    if kind == FX.NK_PRED:
        return ops.pred(p0)
    if kind == FX.NK_BIN:
        return ops.bin(p0, vals[p1], vals[p2])
    if kind == FX.NK_CMP:
        return ops.cmp(p0, vals[p1], vals[p2])
    if kind == FX.NK_NOT:
        return ops.not_(vals[p0])
    if kind == FX.NK_AND:
        return ops.and_(vals[p0], vals[p1])
    if kind == FX.NK_OR:
        return ops.or_(vals[p0], vals[p1])
    if kind == FX.NK_WHERE:
        return ops.where_(vals[p0], vals[p1], vals[p2])
    if kind == FX.NK_AT:
        return ops.at(vals[p0], vals[p1])
    if kind == FX.NK_INCOMING:
        return ops.incoming(vals[p0], vals[p1], vals[p2])
    if kind == FX.NK_EQCOUNT:
        return ops.eqcount(vals[p0], vals[p1])
    if kind == FX.NK_RANK:
        return ops.rank(vals[p0], vals[p1])
    if kind == FX.NK_REDUCE:
        return ops.reduce(p0, vals[p1], vals[p2])
    if kind == FX.NK_ARGBEST:
        return ops.argbest_ranged(p0, vals[p1], vals[p2], ranges[p1])
    raise ValueError(f"unknown effect node kind {kind}")


def run_effect(mech, ops, active) -> None:
    """Apply a T.LEffect through the ops adapter, masked by `active` (B,).

    Each block reads the snapshot taken at its start; writes land in
    statement order (P20)."""
    for block in mech.blocks:
        ops.snapshot()
        _apply_block(block, mech.reveal_bool_slots, ops, active,
                     mech.deal_tables)
        ops.flush()


def run_effects_merged(mechs, ops, actives) -> None:
    """Apply several SINGLE-BLOCK programs from ONE shared snapshot.

    Only valid when the programs' active masks are disjoint (mechanics on
    pairwise-distinct phases): each room runs at most one of them, so the
    merged pass equals sequential run_effect calls."""
    ops.snapshot()
    for mech, active in zip(mechs, actives):
        (block,) = mech.blocks
        _apply_block(block, mech.reveal_bool_slots, ops, active,
                     mech.deal_tables)
    ops.flush()


def _apply_block(block, reveal_bool_slots, ops, active, deal_tables=()) -> None:
    nodes, stmts = block
    ranges = static_ranges(nodes, ops.P)
    vals: list = []
    for kind, p0, p1, p2 in nodes:
        vals.append(_eval_node(kind, p0, p1, p2, vals, ops, ranges))
    for stmt in stmts:
        _emit_stmt(stmt, vals, ops, active, reveal_bool_slots, deal_tables)


def _emit_stmt(stmt, vals, ops, active, reveal_bool_slots, deal_tables) -> None:
    skind, bank, slot, vnode, wnode, knode = stmt
    w = ops.stmt_mask(vals[wnode], active)
    if skind == FX.ST_DEAL:
        # P10: vnode indexes the mech's multiset table; knode is the salt
        ops.write_str(slot, ops.deal(deal_tables[vnode], vals[knode]), w)
    elif skind == FX.ST_KILL:
        ops.kill(w, reveal_bool_slots)
    elif skind == FX.ST_RESET:
        # dict banks clear to empty (bool/num/str resets lower to ST_SET)
        ops.reset_dict(bank, slot, w)
    elif skind == FX.ST_SETD:
        # player-keyed dict entry write; key 0 / out-of-range = no-op
        ops.write_pdict(slot, vals[knode], vals[vnode], w)
    elif skind == FX.ST_OVER:
        # terminal winner rule (P11/P17): evaluated at the lowest seat
        ops.game_over(vals[vnode], w)
    elif skind == FX.ST_SET and bank == FX.FXB_BOOL:
        ops.write_bool(slot, vals[vnode], w)
    elif skind == FX.ST_SET and bank == FX.FXB_STR:
        ops.write_str(slot, vals[vnode], w)
    elif skind == FX.ST_SET:
        ops.write_num(slot, vals[vnode], w, add=False)
    else:
        ops.write_num(slot, vals[vnode], w, add=True)
