"""Serialize a Lowered game into a flat int32 blob for the C++ simulator.

Tag-length-value section stream; the C++ side (gamesim.cpp) and the CUDA
kernels (room_step.cuh) parse the same layout. The blob equals the JAX
package's for games of up to 63 phases; past that a branch condition's
phase mask moves to the pool (ceil((NP + 1) / 32) words), where the JAX
package's two words drop the later phases. All cross-references are
indices into pools, so the blob is fully position-independent. Semantics
carried here are exactly the pinned P1..P11 rules — the C++ sim is a third
implementation used for differential testing against the oracle and the
jitted engine, and as a sub-microsecond host-side step for interactive
serving.
"""

from __future__ import annotations

import numpy as np

from game_engine_tpu_torch.gamespec import effects as FX
from game_engine_tpu_torch.gamespec import tables as T
from game_engine_tpu_torch.gamespec.tables import Lowered

MAGIC = 0x47534D31  # 'GSM1'

SEC_HEADER = 1
SEC_ATOMS = 2
SEC_PRED_OFF = 3
SEC_TERM_OFF = 4
SEC_LITS = 5
SEC_PHASE = 6
SEC_RECTRUE = 7
SEC_RECFALSE = 8
SEC_PDTRANS = 9
SEC_CONDS = 10
SEC_BRANCH_OFF = 11
SEC_BRANCHES = 12
SEC_MECHS = 13
SEC_POOL = 14
SEC_DEFAULTS = 15
# SEC 16 was SEC_ROLETAB — retired in round 4 (P10 deals ride the pool
# inside MECH_EFFECTS ST_DEAL rows); the tag number stays reserved

COND_ALWAYS, COND_COUNTCMP, COND_ALLPRESENT, COND_PREVIN, COND_AND = range(5)
# NIGHT (P7), VOTE (P6), SCORE (P8), ROTATE (P9), ROLES (P10), SETBOOL,
# BLUFF (P14) and MINORITY (P16) are retired ids — those families
# now lower to MECH_EFFECTS programs; numbering stays stable for the C++ ABI.
(MECH_NIGHT, MECH_VOTE, MECH_SCORE, MECH_ROTATE, MECH_ROLES, MECH_SETBOOL,
 MECH_OVER, MECH_BLUFF, MECH_MINORITY, MECH_EFFECTS) = range(10)
OP_CODES = {"eq": 0, "ne": 1, "ge": 2, "le": 3, "gt": 4, "lt": 5}
MECH_PARAMS = 16


def _mask_words(mask: np.ndarray) -> list[int]:
    """(NP+1,) bool -> its 32-bit words (little), at least two: two words
    for NP <= 63, as the JAX package packs them; one more for each 32
    phases past that, where the JAX package's two words drop them."""
    bits = 0
    for i, b in enumerate(mask):
        if b:
            bits |= 1 << i
    n = max(2, (len(mask) + 31) // 32)
    return [_i32((bits >> (32 * k)) & 0xFFFFFFFF) for k in range(n)]


def _i32(x: int) -> int:
    """Clamp into signed int32 range for blob storage."""
    x = int(x) & 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


class _Pool:
    def __init__(self):
        self.data: list[int] = []

    def add(self, items) -> tuple[int, int]:
        off = len(self.data)
        self.data.extend(int(v) for v in items)
        return off, len(self.data) - off


def pack(lowered: Lowered) -> np.ndarray:
    lw = lowered
    P, NP = lw.P, lw.NP
    lay = lw.game.layout
    pool = _Pool()

    # -- conds ---------------------------------------------------------------
    conds: list[list[int]] = []  # rows of 5: type, p1..p4

    def add_cond(c) -> int:
        if isinstance(c, T.LAlways):
            row = [COND_ALWAYS, 0, 0, 0, 0]
        elif isinstance(c, T.LCountCmp):
            row = [COND_COUNTCMP, c.left_pred, OP_CODES[c.op], c.right_pred, c.right_const]
        elif isinstance(c, T.LAllPresent):
            row = [COND_ALLPRESENT, c.pred, 0, 0, 0]
        elif isinstance(c, T.LPrevPhaseIn):
            words = _mask_words(c.mask)
            if len(words) == 2:
                row = [COND_PREVIN, words[0], words[1], 0, 0]
            else:  # NP > 63: the words in the pool (offset, count)
                off, n = pool.add(words)
                row = [COND_PREVIN, off, n, 0, 0]
        elif isinstance(c, T.LAnd):
            kids = [add_cond(k) for k in c.items]
            off, n = pool.add(kids)
            row = [COND_AND, off, n, 0, 0]
        else:
            raise TypeError(c)
        conds.append(row)
        return len(conds) - 1

    branch_off = [0]
    branch_rows: list[list[int]] = []
    for i in range(NP):
        for cond, nxt in lw.branches[i]:
            branch_rows.append([add_cond(cond), nxt])
        branch_off.append(len(branch_rows))

    # -- mechanics -------------------------------------------------------------
    mech_rows: list[list[int]] = []

    def mech(type_, phase_index, params):
        row = [type_, phase_index] + [int(p) for p in params]
        row += [0] * (2 + MECH_PARAMS - len(row))
        mech_rows.append(row)

    for m in lw.mechanics:
        if isinstance(m, T.LEffect):
            # P20 effect program: per block [n_nodes, n_stmts,
            # node rows (4 ints), stmt rows (6 ints)], all in the pool.
            # ST_DEAL rows carry their (P+1, P) multiset table in the
            # pool too: the stmt row's value slot is rewritten from the
            # mech-local table index to the table's pool offset.
            table_off = [pool.add([v for trow in tab for v in trow])[0]
                         for tab in m.deal_tables]
            desc: list[int] = []
            for nodes, stmts in m.blocks:
                desc.append(len(nodes))
                desc.append(len(stmts))
                for row in nodes:
                    desc.extend(_i32(x) for x in row)
                for row in stmts:
                    if row[0] == FX.ST_DEAL:
                        row = (row[0], row[1], row[2],
                               table_off[row[3]], row[4], row[5])
                    desc.extend(_i32(x) for x in row)
            d_off, _ = pool.add(desc)
            rv_off, rv_n = pool.add(m.reveal_bool_slots)
            mech(MECH_EFFECTS, m.phase_index,
                 [d_off, len(m.blocks), rv_off, rv_n])
        else:
            raise TypeError(m)

    # -- preds CSR ---------------------------------------------------------------
    pred_off = [0]
    term_off = [0]
    lits: list[int] = []
    for terms in lw.preds:
        for term in terms:
            lits.extend(term)
            term_off.append(len(lits))
        pred_off.append(len(term_off) - 1)

    atoms = []
    for a in lw.atoms:
        const_code = -1 if a.const is None else (1 if a.const else 0)
        atoms.extend([a.bank, a.slot, a.op, _i32(a.value), const_code])

    # per-phase row
    phase_rows = []
    for i in range(NP):
        phase_rows.extend([
            int(lw.phase_is_action[i]), int(lw.phase_target_pred[i]),
            int(lw.phase_terminal[i]), int(lw.phase_static_next[i]),
            int(lw.choice_kind[i]), int(lw.choice_max[i]),
            int(lw.rec_num_slot[i]), int(lw.rec_pdict_slot[i]),
            int(lw.rec_pdict_src[i]), int(lw.rec_odict_slot[i]),
            int(lw.phase_dsl_id[i]),
        ])

    maxv = lw.rec_pdict_trans.shape[1]
    NB = lw.bool_defaults.shape[0]
    NN = lw.num_defaults.shape[0]
    NS = lw.str_defaults.shape[0]

    header = [
        P, NP, NB, NN, NS, lay.n_pdict, lay.n_odict,
        lw.alive_bool, lw.game.start_index, lw.name_str_slot,
        len(lw.atoms), len(lw.preds), maxv,
    ]

    def sec(sid, data):
        data = [int(x) for x in data]
        return [sid, len(data)] + data

    blob: list[int] = [MAGIC]
    blob += sec(SEC_HEADER, header)
    blob += sec(SEC_ATOMS, atoms)
    blob += sec(SEC_PRED_OFF, pred_off)
    blob += sec(SEC_TERM_OFF, term_off)
    blob += sec(SEC_LITS, lits)
    blob += sec(SEC_PHASE, phase_rows)
    blob += sec(SEC_RECTRUE, lw.rec_bool_true.astype(np.int32).flatten())
    blob += sec(SEC_RECFALSE, lw.rec_bool_false.astype(np.int32).flatten())
    blob += sec(SEC_PDTRANS, lw.rec_pdict_trans.flatten())
    blob += sec(SEC_CONDS, [v for row in conds for v in row])
    blob += sec(SEC_BRANCH_OFF, branch_off)
    blob += sec(SEC_BRANCHES, [v for row in branch_rows for v in row])
    blob += sec(SEC_MECHS, [v for row in mech_rows for v in row])
    blob += sec(SEC_POOL, pool.data)
    blob += sec(
        SEC_DEFAULTS,
        list(lw.bool_defaults.astype(np.int32)) + list(lw.num_defaults) + list(lw.str_defaults),
    )
    return np.asarray(blob, dtype=np.int32)
