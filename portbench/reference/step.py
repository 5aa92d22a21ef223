"""A frozen copy of the port's core/step.py, kept here so that the reference
shares no code with the program.

The plain-torch engine step: one game turn for a batch of rooms.

Counterpart of game_engine_tpu/core/step.py, with the same data flow:

  atoms -> predicate values -> action acceptance -> record writes ->
  completion gate -> first-match branch select -> transition ->
  masked on-enter mechanics

Every operation is an elementwise op, a gather or a small reduction over
the player axis, batched over rooms on axis 0. Semantics are pinned P1..P20
(gamespec/mechanics.py, SEMANTICS.md) and must stay bit-identical to the
JAX step and to oracle/interp.py. Integer rules: int32 sums pass
``dtype=torch.int32`` so they wrap as int32; uint32 hashing runs in int64
masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.gamespec import effects as FX
from portbench.reference.gamespec import tables as T
from portbench.reference.gamespec.mechanics import ChoiceKind
from portbench.reference.gamespec.tables import (
    AB_BOOL,
    AB_CONST,
    AB_NUM,
    Lowered,
    OP_EQ,
    OP_GE,
    OP_GT,
    OP_LE,
    OP_NE,
)
from portbench.reference.state import M32, GameState, tables

_I32 = torch.int32
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1
GOLDEN = 0x9E3779B9
MIX = 0x85EBCA6B


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 `a` in [0, 2**32) and a 32-bit constant,
    from partial products that stay inside int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """uint32 splitmix on int64 tensors holding uint32 values — must match
    gamespec.mechanics.splitmix32 exactly."""
    x = (x + GOLDEN) & M32
    z = mul32(x ^ (x >> 16), 0x85EBCA6B)
    z = mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


class PredEval:
    """Lazily evaluates lowered predicates over the current state banks."""

    def __init__(self, lowered: Lowered, state: GameState):
        self.lw = lowered
        self.state = state
        self._atom_cache: dict[int, torch.Tensor] = {}
        self._pred_cache: dict[int, torch.Tensor] = {}

    def _full(self, value: bool) -> torch.Tensor:
        return torch.full(self.state.present.shape, value, dtype=torch.bool,
                          device=self.state.present.device)

    def atom(self, idx: int) -> torch.Tensor:
        if idx in self._atom_cache:
            return self._atom_cache[idx]
        a = self.lw.atoms[idx]
        if a.bank == AB_CONST:
            v = self._full(bool(a.const))
        else:
            if a.bank == AB_BOOL:
                x = self.state.bools[..., a.slot].to(_I32)
            elif a.bank == AB_NUM:
                x = self.state.nums[..., a.slot]
            else:
                x = self.state.strs[..., a.slot].to(_I32)
            c = int(a.value)
            if a.op == OP_EQ:
                v = x == c
            elif a.op == OP_NE:
                v = x != c
            elif a.op == OP_GE:
                v = x >= c
            elif a.op == OP_LE:
                v = x <= c
            elif a.op == OP_GT:
                v = x > c
            else:
                v = x < c
        self._atom_cache[idx] = v
        return v

    def pred(self, idx: int) -> torch.Tensor:
        """(B, P) bool — does each player satisfy predicate idx (DNF)."""
        if idx in self._pred_cache:
            return self._pred_cache[idx]
        v = self._full(False)
        for term in self.lw.preds[idx]:
            tv = self._full(True)
            for ai in term:
                tv = tv & self.atom(ai)
            v = v | tv
        self._pred_cache[idx] = v
        return v

    def count(self, idx: int) -> torch.Tensor:
        """(B,) int32 — present players satisfying predicate idx."""
        return (self.pred(idx) & self.state.present).sum(1, dtype=_I32)


def _alive(lowered: Lowered, state: GameState) -> torch.Tensor:
    """(B, P) — is_alive if declared, else present."""
    if lowered.alive_bool >= 0:
        return state.bools[..., lowered.alive_bool] & state.present
    return state.present


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) bool one-hot of a 0-based index; out of range -> all false."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _gather_by_choice(vals: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """vals (B, P), choice (B, P) 1-based -> out[b, p] = vals[b, choice[b,p]-1];
    out-of-range choices read False / 0."""
    P = vals.shape[1]
    ok = (choice >= 1) & (choice <= P)
    got = torch.gather(vals, 1, torch.where(ok, choice - 1, 0).long())
    if vals.dtype == torch.bool:
        return got & ok
    return torch.where(ok, got, 0)


def _phase_mask_lookup(mask_np: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """Membership of a (dense index, -1 allowed) tensor in a static phase
    set given as an (NP+1,) mask indexed by index+1."""
    out = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    for m in np.nonzero(mask_np)[0] - 1:
        out = out | (idx == int(m))
    return out


class _EffectOps:
    """Ops adapter binding the effect interpreter (P20,
    core/effects_exec.py) to the (rooms, players) batch layout.

    Truthy intermediates stay bool and numerics int32, converting only at
    arithmetic and write boundaries. Writes to the bool/num/str banks are
    combined per slot and land at flush(): the pending column IS the
    statement-ordered result, so this equals writing each statement."""

    def __init__(self, lw: Lowered, st: GameState):
        self.lw = lw
        self.st = st
        B, P = st.present.shape
        self.B, self.P = B, P
        self.device = st.present.device
        self._seat = torch.arange(1, P + 1, dtype=_I32,
                                  device=self.device).expand(B, P)

    def snapshot(self):
        st = self.st
        self.sb, self.sn, self.ss = st.bools, st.nums, st.strs
        self.pe = PredEval(self.lw, st)
        # slot -> effective (B, P) column since the snapshot; flush() lands them
        self._pend = {"b": {}, "n": {}, "s": {}}

    # -- dtype helpers ------------------------------------------------------

    def const(self, v: int) -> torch.Tensor:
        """A 0-d int32 literal on the state's device: copied there once a
        value and cached with the game's tables (never written in place)."""
        consts = tables(self.lw, self.device).setdefault("ir_consts", {})
        if v not in consts:
            consts[v] = torch.tensor(v, dtype=_I32, device=self.device)
        return consts[v]

    @staticmethod
    def _b(x: torch.Tensor) -> torch.Tensor:
        """truthy -> bool (no-op when already bool)."""
        return x if x.dtype == torch.bool else x != 0

    @staticmethod
    def _i(x: torch.Tensor) -> torch.Tensor:
        """-> int32 (bools become 0/1)."""
        return x.to(_I32) if x.dtype == torch.bool else x

    def _bp(self, x: torch.Tensor) -> torch.Tensor:
        """broadcast to (B, P), preserving dtype."""
        return x.expand(self.B, self.P)

    # -- leaf reads ---------------------------------------------------------

    def field(self, bank, slot):
        if bank == FX.FXB_BOOL:
            return self.sb[..., slot]
        if bank == FX.FXB_NUM:
            return self.sn[..., slot]
        return self.ss[..., slot].to(_I32)

    def seat(self):
        return self._seat

    def nplayers(self):
        return self.st.present.sum(1, dtype=_I32)[:, None]

    def choice(self):
        return self.st.choice

    def chosein(self, lo, hi):
        bits = (int(lo) & M32) | ((int(hi) & M32) << 32)
        out = torch.zeros((self.B, self.P), dtype=torch.bool, device=self.device)
        for i in range(64):
            if (bits >> i) & 1:
                out = out | (self.st.choice_phase == i - 1)
        return out

    def alive(self):
        if self.lw.alive_bool >= 0:
            return self.sb[..., self.lw.alive_bool] & self.st.present
        return self.st.present

    def present_i(self):
        return self.st.present

    def pred(self, idx):
        return self.pe.pred(idx)

    # -- scalar ops ---------------------------------------------------------

    def bin(self, op, a, b):
        a, b = self._i(a), self._i(b)
        if op == FX.BIN_ADD:
            return a + b
        if op == FX.BIN_SUB:
            return a - b
        if op == FX.BIN_MUL:
            return a * b
        if op == FX.BIN_MIN:
            return torch.minimum(a, b)
        return torch.maximum(a, b)

    def cmp(self, op, a, b):
        a, b = self._i(a), self._i(b)
        return (a == b if op == 0 else a != b if op == 1
                else a >= b if op == 2 else a <= b if op == 3
                else a > b if op == 4 else a < b)

    def not_(self, a):
        return ~self._b(a)

    def and_(self, a, b):
        return self._b(a) & self._b(b)

    def or_(self, a, b):
        return self._b(a) | self._b(b)

    def where_(self, c, a, b):
        if a.dtype != b.dtype:
            a, b = self._i(a), self._i(b)
        return torch.where(self._b(c), a, b)

    # -- cross-player aggregations -----------------------------------------

    def _mask(self, mask):
        return self._b(self._bp(mask)) & self.st.present

    def at(self, val, idx):
        idx = self._bp(self._i(idx))
        ok = _gather_by_choice(self.st.present, idx)  # absent/invalid -> False
        got = _gather_by_choice(self._bp(val), idx)
        if val.dtype == torch.bool:
            return got & ok
        return torch.where(ok, got, 0)

    def incoming(self, val, key, mask):
        m = self._mask(mask)  # (B, q)
        hit = (self._bp(self._i(key))[:, :, None] == self._seat[:, None, :]) \
            & m[:, :, None]  # (B, q, p): q's key names seat p
        contrib = torch.where(hit, self._bp(self._i(val))[:, :, None], 0)
        return contrib.sum(1, dtype=_I32)

    def eqcount(self, key, mask):
        key = self._bp(self._i(key))
        eq = key[:, :, None] == key[:, None, :]  # (B, p, q)
        return (eq & self._mask(mask)[:, None, :]).sum(2, dtype=_I32)

    def rank(self, key, mask):
        key = self._bp(self._i(key))
        eq = key[:, :, None] == key[:, None, :]  # (B, p, q)
        ar = torch.arange(self.P, device=self.device)
        earlier = ar[None, None, :] < ar[None, :, None]
        return (eq & earlier & self._mask(mask)[:, None, :]).sum(2, dtype=_I32)

    def reduce(self, kind, val, mask):
        m = self._mask(mask)
        if kind == FX.RED_COUNT:
            return m.sum(1, keepdim=True, dtype=_I32)
        val = self._bp(self._i(val))
        if kind == FX.RED_SUM:
            return torch.where(m, val, 0).sum(1, keepdim=True, dtype=_I32)
        any_m = m.any(1, keepdim=True)
        if kind == FX.RED_MAX:
            # exact INT32_MIN sentinel: a true max over masked-in lanes
            best = torch.where(m, val, _I32_MIN).amax(1, keepdim=True)
        else:
            best = torch.where(m, val, _I32_MAX).amin(1, keepdim=True)
        return torch.where(any_m, best, 0)

    def argbest(self, kind, key, mask):
        # exact for ALL int32 keys: the win mask is re-ANDed with m, so a key
        # equal to the sentinel can neither fake an empty mask nor let a
        # masked-out seat win
        m = self._mask(mask)
        key = self._bp(self._i(key))
        any_m = m.any(1, keepdim=True)
        if kind == FX.ARG_MAX:
            best = torch.where(m, key, _I32_MIN).amax(1, keepdim=True)
        else:
            best = torch.where(m, key, _I32_MAX).amin(1, keepdim=True)
        win = m & (key == best)
        w = torch.where(win, self._seat, self.P + 1).amin(1, keepdim=True)
        return torch.where(any_m, w, 0)

    def argbest_ranged(self, kind, key, mask, key_range):
        """Single-reduce argbest when the static range analysis
        (effects_exec.static_ranges) proves that z = (key - lo) * (P + 2)
        +/- seat fits in int32: one masked max/min gives both the winning
        key and the lowest-seat tie-break (P6). Equal to argbest."""
        lo, hi = key_range
        P = self.P
        span = hi - lo
        if span < 0 or span > (2 ** 31 - 2 - P) // (P + 2):
            return self.argbest(kind, key, mask)  # could wrap: generic path
        m = self._mask(mask)
        k2 = self._bp(self._i(key)) - lo
        if kind == FX.ARG_MAX:
            # equal keys: larger (P - seat) = lower seat wins the max
            z = torch.where(m, k2 * (P + 2) + (P - self._seat), -1)
            zbest = z.amax(1, keepdim=True)
            return torch.where(zbest >= 0, P - zbest % (P + 2), 0)
        # ARG_MIN: equal keys: smaller (seat - 1) = lower seat wins the min
        z = torch.where(m, k2 * (P + 2) + (self._seat - 1), _I32_MAX)
        zbest = z.amin(1, keepdim=True)
        return torch.where(zbest < _I32_MAX, zbest % (P + 2) + 1, 0)

    def deal(self, table, salt):
        """ST_DEAL (P10): per-seat value code from the (P+1, P) multiset
        table, permuted by splitmix32 keys. Stable rank by O(P^2)
        comparisons: rank_p = #{q: key_q < key_p, or equal with q < p}."""
        st = self.st
        P = self.P
        pids = torch.arange(P, dtype=torch.int64, device=self.device)[None, :]
        saltu = self._bp(self._i(salt)).to(torch.int64) & M32
        keys = splitmix32((mul32(st.seed[:, None], 0x100) + pids
                           + mul32(saltu, GOLDEN)) & M32)
        keys = torch.where(st.present, keys, M32)
        ar = torch.arange(P, device=self.device)
        lt = keys[:, None, :] < keys[:, :, None]  # [b, p, q]: key_q < key_p
        tie = (keys[:, None, :] == keys[:, :, None]) & (
            ar[None, :, None] > ar[None, None, :])
        rank = (lt | tie).sum(2, dtype=_I32)
        n = st.present.sum(1, dtype=_I32)
        tabs = tables(self.lw, self.device)
        key = ("deal", table)
        if key not in tabs:
            tabs[key] = torch.as_tensor(np.asarray(table, np.int32),
                                        device=self.device)
        codes_rows = tabs[key][n.long()]  # (B, P)
        return _gather_by_choice(codes_rows, rank + 1)

    # -- statement writes ---------------------------------------------------

    def stmt_mask(self, wval, active):
        return self._b(self._bp(wval)) & self.st.present & active[:, None]

    def _cur(self, bank, slot):
        """Effective current column: the pending value if this slot was
        written since the snapshot, else the live bank."""
        pend = self._pend[bank]
        if slot in pend:
            return pend[slot]
        arr = {"b": self.st.bools, "n": self.st.nums, "s": self.st.strs}[bank]
        return arr[..., slot]

    def write_bool(self, slot, val, w):
        cur = self._cur("b", slot)
        self._pend["b"][slot] = torch.where(w, self._bp(self._b(val)), cur)

    def write_num(self, slot, val, w, add):
        cur = self._cur("n", slot)
        val = self._bp(self._i(val))
        self._pend["n"][slot] = torch.where(w, cur + val if add else val, cur)

    def write_str(self, slot, val, w):
        cur = self._cur("s", slot)
        self._pend["s"][slot] = torch.where(
            w, self._bp(self._i(val)).to(cur.dtype), cur)

    def flush(self):
        """Land every pending column: one copy per touched bank."""
        st = self.st
        banks = {}
        for tag, name in (("b", "bools"), ("n", "nums"), ("s", "strs")):
            if self._pend[tag]:
                arr = getattr(st, name).clone()
                for slot, col in self._pend[tag].items():
                    arr[..., slot] = col
                banks[name] = arr
        if banks:
            self.st = st._replace(**banks)
        self._pend = {"b": {}, "n": {}, "s": {}}

    def write_pdict(self, slot, key, val, w):
        """pdict[seat][key] = val for masked seats; keys naming absent seats
        write nothing (the pinned 1..n_players domain)."""
        cur = self.st.pdict[:, :, slot, :]  # (B, P, P)
        key = self._bp(self._i(key))  # (B, P) target seat ids, 1-based
        hot = (self._seat[:, None, :] == key[:, :, None]) \
            & self.st.present[:, None, :]
        val = self._bp(self._i(val)).to(cur.dtype)
        pdict = self.st.pdict.clone()
        pdict[:, :, slot, :] = torch.where(hot & w[:, :, None], val[:, :, None], cur)
        self.st = self.st._replace(pdict=pdict)

    def reset_dict(self, bank, slot, w):
        if bank == FX.FXB_ODICT:
            odict = self.st.odict.clone()
            odict[..., slot] = torch.where(w, 0, odict[..., slot])
            self.st = self.st._replace(odict=odict)
        else:
            pdict = self.st.pdict.clone()
            pdict[:, :, slot, :] = torch.where(w[..., None], 0,
                                               pdict[:, :, slot, :])
            self.st = self.st._replace(pdict=pdict)

    def kill(self, w, reveal_slots):
        """alive &= ~death, then reveals |= death (P15), statement-ordered."""
        if self.lw.alive_bool >= 0:
            cur = self._cur("b", self.lw.alive_bool)
            self._pend["b"][self.lw.alive_bool] = cur & ~w
        for slot in reveal_slots:
            cur = self._cur("b", slot)
            self._pend["b"][slot] = cur | w

    def game_over(self, val, w):
        """ST_OVER (P11/P17): done + winner from the lowest-seat lane (seat 1
        is always present, so lane 0 carries the room's trigger/value)."""
        trigger = w[:, 0]
        v0 = self._bp(self._i(val))[:, 0]
        self.st = self.st._replace(
            done=self.st.done | trigger,
            winner=torch.where(trigger, v0, self.st.winner))


def apply_on_enter(lowered: Lowered, state: GameState, entered: torch.Tensor,
                   new_phase: torch.Tensor) -> GameState:
    """Apply every mechanic masked by (entered & phase match).

    Consecutive single-block effect programs on pairwise-distinct phases
    share one snapshot and one statement pass: a room is in exactly one
    phase, so their active masks are disjoint and the merged pass equals
    sequential execution."""
    from portbench.reference.effects_exec import run_effect, run_effects_merged

    mechs = lowered.mechanics
    i = 0
    while i < len(mechs):
        m = mechs[i]
        if not isinstance(m, T.LEffect):
            raise TypeError(m)
        if len(m.blocks) == 1:
            group = [m]
            phases = {m.phase_index}
            j = i + 1
            while (j < len(mechs) and len(mechs[j].blocks) == 1
                   and mechs[j].phase_index not in phases):
                group.append(mechs[j])
                phases.add(mechs[j].phase_index)
                j += 1
            ops = _EffectOps(lowered, state)
            run_effects_merged(
                group, ops,
                [entered & (new_phase == g.phase_index) for g in group])
            state = ops.st
            i = j
        else:
            ops = _EffectOps(lowered, state)
            run_effect(m, ops, entered & (new_phase == m.phase_index))
            state = ops.st
            i += 1
    return state


def _eval_cond(cond, pe: PredEval, st: GameState) -> torch.Tensor:
    """(B,) bool value of a lowered branch condition (room level)."""
    if isinstance(cond, T.LAlways):
        return torch.ones(st.done.shape, dtype=torch.bool, device=st.done.device)
    if isinstance(cond, T.LAnd):
        v = _eval_cond(cond.items[0], pe, st)
        for c in cond.items[1:]:
            v = v & _eval_cond(c, pe, st)
        return v
    if isinstance(cond, T.LPrevPhaseIn):
        return _phase_mask_lookup(cond.mask, st.prev_phase)
    if isinstance(cond, T.LAllPresent):
        return pe.count(cond.pred) == st.present.sum(1, dtype=_I32)
    if isinstance(cond, T.LCountCmp):
        lhs = pe.count(cond.left_pred)
        rhs = int(cond.right_const) if cond.right_pred < 0 else pe.count(cond.right_pred)
        return {
            "eq": lambda: lhs == rhs,
            "ne": lambda: lhs != rhs,
            "ge": lambda: lhs >= rhs,
            "le": lambda: lhs <= rhs,
            "gt": lambda: lhs > rhs,
            "lt": lambda: lhs < rhs,
        }[cond.op]()
    raise TypeError(cond)


def make_step(lowered: Lowered):
    """Build step(state, actions) -> state. actions: (B, P) int32, 0 = none."""
    NP, P = lowered.NP, lowered.P
    # target predicate per phase, grouped so each distinct pred runs once
    by_pred: dict[int, list[int]] = {}
    for i, pi in enumerate(lowered.phase_target_pred):
        by_pred.setdefault(int(pi), []).append(i)

    def step(state: GameState, actions: torch.Tensor) -> GameState:
        tabs = tables(lowered, state.present.device)
        B = state.present.shape[0]
        pe_pre = PredEval(lowered, state)
        ph = state.phase
        phl = ph.long()
        is_action = tabs["phase_is_action"][phl]  # (B,)
        kind = tabs["choice_kind"][phl]
        kmax = tabs["choice_max"][phl]
        n_present = state.present.sum(1, dtype=_I32)

        # target predicate of the current phase, per room (P3)
        target = torch.zeros_like(state.present)
        for pi, phase_idxs in by_pred.items():
            hit = torch.zeros_like(state.done)
            for i in phase_idxs:
                hit = hit | (ph == i)
            target = torch.where(hit[:, None], pe_pre.pred(pi), target)
        targeted = target & state.present

        # --- action legality (P1/P2) ---
        c = actions.to(_I32)
        alive = _alive(lowered, state)
        tgt_alive = _gather_by_choice(alive, c)  # false when c out of range
        target_ok = (c >= 1) & (c <= P) & tgt_alive
        hi = torch.where(kmax > 0, kmax, n_present)[:, None]
        option_ok = (c >= 1) & (c <= hi)
        kind_b = kind[:, None]
        legal = torch.where(
            kind_b == ChoiceKind.TARGET.value,
            target_ok,
            torch.where(kind_b == ChoiceKind.OPTION.value, option_ok,
                        kind_b == ChoiceKind.SUBMIT.value),  # SUBMIT: any nonzero
        )
        accept = (is_action[:, None] & ~state.done[:, None] & targeted
                  & ~state.acted & (c != 0) & legal)
        c_norm = torch.where(kind_b == ChoiceKind.SUBMIT.value, 1, c)

        # --- record writes ---
        am = accept[..., None]
        bools = torch.where(am & tabs["rec_bool_true"][phl][:, None, :], True,
                            state.bools)
        bools = torch.where(am & tabs["rec_bool_false"][phl][:, None, :], False,
                            bools)
        num_sel = _one_hot(tabs["rec_num_slot"][phl], state.nums.shape[-1])
        nums = torch.where(am & num_sel[:, None, :], c_norm[..., None], state.nums)

        # pdict write: field[target] = target's source-string value,
        # translated into the pdict field's value vocab
        pd_slot = tabs["rec_pdict_slot"][phl]  # (B,)
        pd_src = tabs["rec_pdict_src"][phl]
        NS = state.strs.shape[-1]
        src_ok = (pd_src >= 0) & (pd_src < NS)
        src_bank = torch.gather(
            state.strs.to(_I32), 2,
            torch.where(src_ok, pd_src, 0).long()[:, None, None].expand(B, P, 1),
        )[..., 0]
        src_bank = torch.where(src_ok[:, None], src_bank, 0)  # (B, P)
        src_val = _gather_by_choice(src_bank, c)  # (B, P) target's code
        trans_rows = tabs["rec_pdict_trans"][phl]  # (B, MAXV)
        MAXV = trans_rows.shape[1]
        v_ok = (src_val >= 0) & (src_val < MAXV)
        src_tr = torch.gather(trans_rows, 1, torch.where(v_ok, src_val, 0).long())
        src_val = torch.where(v_ok & (pd_src[:, None] >= 0), src_tr, 0)
        pd_oh = _one_hot(pd_slot, state.pdict.shape[2])[:, None, :, None]
        tgt_oh = _one_hot(c - 1, P)[:, :, None, :]
        pd_mask = am[..., None] & pd_oh & tgt_oh
        pdict = torch.where(pd_mask, src_val.to(torch.int8)[..., None, None],
                            state.pdict)

        od_oh = _one_hot(tabs["rec_odict_slot"][phl], state.odict.shape[2])
        odict = torch.where(am & od_oh[:, None, :], 1, state.odict)

        acted = state.acted | accept
        choice = torch.where(accept, c_norm, state.choice)
        choice_phase = torch.where(accept, ph[:, None], state.choice_phase)
        state = state._replace(
            bools=bools, nums=nums, pdict=pdict, odict=odict,
            acted=acted, choice=choice, choice_phase=choice_phase,
        )

        # --- completion (P3) on post-ingest state ---
        pe = PredEval(lowered, state)
        need = targeted & ~acted
        complete = torch.where(is_action, ~need.any(1), True) & ~state.done

        # --- next-phase select (P4/P5): static map + first-match branches ---
        next_idx = tabs["phase_static_next"][phl]
        for i in range(NP):
            if lowered.branches[i]:
                nxt = torch.full((B,), lowered.branches[i][-1][1], dtype=_I32,
                                 device=ph.device)  # P5 fallback
                for cond, tgt_idx in reversed(lowered.branches[i]):
                    nxt = torch.where(_eval_cond(cond, pe, state), tgt_idx, nxt)
                next_idx = torch.where(ph == i, nxt, next_idx)

        trans = complete & (next_idx != ph)
        state = state._replace(
            phase=torch.where(trans, next_idx, ph),
            prev_phase=torch.where(trans, ph, state.prev_phase),
            acted=torch.where(trans[:, None], False, state.acted),
            t=state.t + 1,
        )

        # --- on-enter mechanics of the newly-entered phase ---
        return apply_on_enter(lowered, state, trans, state.phase)

    return step


def waiting_seats(lowered: Lowered, state: GameState) -> torch.Tensor:
    """(B, P) bool — the seats the current phase waits on: a player_action
    phase, the seat present, targeted by the phase's predicate and not yet
    acted, the room not done. The seats a search decides for."""
    pe = PredEval(lowered, state)
    is_action = tables(lowered, state.phase.device)["phase_is_action"][state.phase.long()]
    target = torch.zeros_like(state.present)
    by_pred: dict[int, list[int]] = {}
    for i, pi in enumerate(lowered.phase_target_pred):
        by_pred.setdefault(int(pi), []).append(i)
    for pi, idxs in by_pred.items():
        hit = torch.zeros_like(state.done)
        for i in idxs:
            hit = hit | (state.phase == i)
        target = torch.where(hit[:, None], pe.pred(pi), target)
    return (is_action[:, None] & target & state.present & ~state.acted
            & ~state.done[:, None])
