"""Plain-Python interpreter of a CompiledGame — the semantics oracle.

Counterpart of game_engine_tpu/oracle/interp.py, over the port's own
gamespec (the chat corpus and the probe evaluation play oracle rooms).

Readable and slow: one room, dict-based player states, direct IR evaluation.
The batched engine (core/step.py) must produce bit-identical
phase/vote/state/win traces against this interpreter; golden-parity tests
enforce that (SURVEY.md §4, BASELINE.json north star). The reference system
it determinizes is the LangGraph node pipeline
Router -> BotBehavior -> PhaseNode -> Referee -> ActionExecutor
(reference: agent/game_agent_v2.py:1570-1587); one ``step()`` here equals one
reference game turn.

All semantic rules implemented here are the pinned P1..P11 semantics
documented in gamespec/mechanics.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from game_engine_tpu_torch.gamespec import conditions as C
from game_engine_tpu_torch.gamespec import effects as FX
from game_engine_tpu_torch.gamespec import mechanics as M
from game_engine_tpu_torch.gamespec.compile import CompiledGame, CompiledPhase
from game_engine_tpu_torch.gamespec.expr import eval_predicate
from game_engine_tpu_torch.gamespec.mechanics import ChoiceKind
from game_engine_tpu_torch.gamespec.schema import CompletionType, FieldType


def _i32(x: int) -> int:
    """Wrap to int32 two's-complement (the pinned IR value domain: the torch
    and CUDA executors compute in int32; C++ uses int32_t)."""
    return ((int(x) + 2**31) & 0xFFFFFFFF) - 2**31


@dataclasses.dataclass
class OracleTrace:
    """Per-step observable record used by parity tests."""

    phase_id: int
    done: bool
    winner: int
    alive: tuple[bool, ...]
    acted: tuple[bool, ...]


class OracleRoom:
    """One game room interpreted in plain Python."""

    def __init__(self, game: CompiledGame, n_players: int, seed: int = 0):
        assert 1 <= n_players <= game.config.max_players
        self.game = game
        self.n = n_players
        self.seed = seed
        decl = game.spec.declaration

        self.players: dict[int, dict[str, Any]] = {}
        for pid in range(1, n_players + 1):
            row: dict[str, Any] = {}
            for f in decl.fields:
                if f.type in (FieldType.DICT,):
                    row[f.name] = {}
                elif f.type is FieldType.ARRAY:
                    row[f.name] = []
                else:
                    row[f.name] = f.default
            if "name" in row and not row["name"]:
                row["name"] = f"Player {pid}"
            self.players[pid] = row

        self.phase: CompiledPhase = game.phases[game.start_index]
        self.prev_phase_id: Optional[int] = None
        self.done = False
        self.winner = 0
        self.step_count = 0
        self.acted: set[int] = set()
        self.choice: dict[int, int] = {}
        self.choice_phase: dict[int, int] = {}
        # on-enter mechanics of the start phase
        self._apply_on_enter(self.phase)

    # -- predicates --------------------------------------------------------

    def _match(self, pred, pid: int) -> bool:
        return eval_predicate(pred, self.players[pid])

    def _targets(self, phase: CompiledPhase) -> list[int]:
        return [p for p in range(1, self.n + 1) if self._match(phase.target_pred, p)]

    # -- action acceptance (P1/P2) ------------------------------------------

    def _legal_choice(self, rp: M.RecordProgram, choice: int) -> Optional[int]:
        if rp.choice_kind is ChoiceKind.TARGET:
            if 1 <= choice <= self.n:
                tgt = self.players[choice]
                if "is_alive" not in tgt or tgt["is_alive"]:
                    return choice
            return None
        if rp.choice_kind is ChoiceKind.OPTION:
            hi = rp.choice_max if rp.choice_max > 0 else self.n
            return choice if 1 <= choice <= hi else None
        if rp.choice_kind is ChoiceKind.SUBMIT:
            return 1
        return None

    def _accept(self, pid: int, choice: int) -> bool:
        phase = self.phase
        if phase.completion is not CompletionType.PLAYER_ACTION:
            return False
        if pid in self.acted or not self._match(phase.target_pred, pid):
            return False
        rp = phase.program.record
        c = self._legal_choice(rp, choice)
        if c is None:
            return False
        row = self.players[pid]
        for f in rp.set_bool_true:
            row[f] = True
        for f in rp.set_bool_false:
            row[f] = False
        if rp.write_choice_num:
            row[rp.write_choice_num] = c
        if rp.write_pdict:
            field, src = rp.write_pdict
            if 1 <= c <= self.n:
                val = self.players[c].get(src, "") if src else ""
                row[field] = dict(row[field])
                row[field][str(c)] = val
        if rp.mark_odict:
            row[rp.mark_odict] = {"1": "submitted"}
        self.acted.add(pid)
        self.choice[pid] = c
        self.choice_phase[pid] = phase.dsl_id
        return True

    # -- resolution mechanics (P6-P11) ---------------------------------------

    def _apply_on_enter(self, phase: CompiledPhase) -> None:
        for mech in phase.program.on_enter:
            self.apply_mechanic(mech)

    def apply_mechanic(self, mech) -> None:
        """Apply ONE analyzer mechanic to the live room (tests use this to
        hand-check pinned semantics on crafted states)."""
        if isinstance(mech, M.RoleAssign):
            # P10 executes through the SAME effect-IR interpreter as every
            # other mechanic (round 4 — the bespoke kernel is deleted from
            # all four executors): a `deal` block + guarded role settings
            self._apply_effects(
                M.role_assign_program(mech, self.game.layout), ())
        elif isinstance(mech, M.NightResolve):
            self._apply_effects(
                FX.night_resolve_program(
                    mech.kill_phases, mech.protect_phases,
                    mech.kill_pred, mech.protect_pred,
                    (*mech.reset_bools, *mech.reset_nums),
                    protect=(FX.parse_expr(mech.protect)
                             if mech.protect else None)),
                mech.reveal_bools)
        elif isinstance(mech, M.VoteElim):
            self._apply_effects(
                FX.vote_elim_program(
                    mech.vote_phases, mech.voter_pred,
                    protect=(FX.parse_expr(mech.protect)
                             if mech.protect else None),
                    weight=(FX.parse_expr(mech.weight)
                            if mech.weight else None)),
                mech.reveal_bools)
        elif isinstance(mech, M.ResourceIncome):
            self._apply_effects(FX.income_program(mech.gains), ())
        elif isinstance(mech, M.ResourceRaid):
            self._apply_effects(
                FX.raid_program(mech.raid_phases, mech.raider_pred,
                                mech.res_field), ())
        elif isinstance(mech, M.BluffChallenge):
            self._apply_effects(
                FX.bluff_challenge_program(
                    mech.claim_field, mech.challenge_phases,
                    mech.claimant_pred, mech.challenger_pred,
                    mech.role_field,
                    tuple(r.name for r in self.game.spec.declaration.roles),
                    mech.lives_field),
                mech.reveal_bools)
        elif isinstance(mech, M.MinorityScore):
            self._apply_effects(
                FX.minority_program(mech.pick_field, mech.picker_pred,
                                    mech.score_field, mech.n_options), ())
        elif isinstance(mech, M.AuctionScore):
            try:
                bid_default = int(
                    self.game.spec.declaration.field(mech.bid_field).default)
            except (TypeError, ValueError):
                bid_default = 0
            self._apply_effects(
                FX.auction_program(mech.bid_field, mech.bidder_pred,
                                   mech.res_field, mech.prize_field,
                                   bid_default), ())
        elif isinstance(mech, M.Effects):
            self._apply_effects(mech.program, mech.reveal_bools)
        elif isinstance(mech, M.GuessScore):
            self._apply_effects(
                FX.guess_score_program(
                    mech.speaker_field, mech.lie_field, mech.vote_field,
                    mech.voted_field or None, mech.score_field,
                    mech.rounds_field or None), ())
        elif isinstance(mech, M.SpeakerRotate):
            self._apply_effects(
                FX.speaker_rotate_program(
                    mech.speaker_field, mech.rounds_field,
                    mech.can_vote_field or None,
                    (*mech.reset_bools, *mech.reset_nums,
                     *mech.reset_odicts, *mech.reset_pdicts)), ())
        elif isinstance(mech, M.SetBoolAll):
            self._apply_effects(FX.set_bool_all_program(mech.fields), ())
        elif isinstance(mech, M.GameOver):
            # P11/P17 terminal rules run through the SAME effect-IR
            # interpreter as every other mechanic (the bespoke winner
            # kernel is deleted from all four executors — VERDICT r4)
            self._apply_effects(
                FX.game_over_program_for(mech, self.game.layout), ())

    def _kill(self, pid: int, reveal_bools) -> None:
        """P15: death clears is_alive and reveals the role flags."""
        row = self.players[pid]
        if "is_alive" in row:
            row["is_alive"] = False
        for f in reveal_bools:
            row[f] = True

    # -- generic effect interpreter (P20) ------------------------------------
    #
    # ONE interpreter executes every effect program: the analyzer's P12
    # income / P13 raid / P19 auction re-expressions and any DSL-declared
    # `mechanics: [{effects: [...]}]` program. Within a block, every
    # expression reads the block-entry snapshot; writes land in statement
    # order; blocks sequence (SEMANTICS.md P20).

    def _fx_eval(self, e, p: int, snap: dict[int, dict]) -> int:
        ev = self._fx_eval
        layout = self.game.layout
        if isinstance(e, FX.EConst):
            return e.value
        if isinstance(e, FX.EField):
            slot = layout.get(e.name)
            v = snap[p].get(e.name)
            if slot is not None and slot.bank == "str":
                return slot.encode(v)
            if isinstance(v, bool):
                return 1 if v else 0
            try:
                return int(v or 0)
            except (TypeError, ValueError):
                return 0
        if isinstance(e, FX.ESeat):
            return p
        if isinstance(e, FX.ENPlayers):
            return self.n
        if isinstance(e, FX.EChoice):
            return self.choice.get(p, 0)
        if isinstance(e, FX.EChoseIn):
            return 1 if self.choice_phase.get(p) in e.phases else 0
        if isinstance(e, FX.EAlive):
            return 1 if snap[p].get("is_alive", True) else 0
        if isinstance(e, FX.EPresent):
            return 1
        if isinstance(e, FX.EPredRef):
            return 1 if eval_predicate(e.pred, snap[p]) else 0
        if isinstance(e, FX.EBin):
            # wrap to int32 like the torch/CUDA/C++ executors: Python's
            # unbounded ints would otherwise diverge on a DSL-declared
            # program that overflows (ADVICE r3); all IR values are int32
            a, b = ev(e.a, p, snap), ev(e.b, p, snap)
            return _i32({"add": a + b, "sub": a - b, "mul": a * b,
                         "min": min(a, b), "max": max(a, b)}[e.op])
        if isinstance(e, FX.ECmp):
            a, b = e.a, e.b
            if isinstance(a, FX.EStrLit) and isinstance(b, FX.EField):
                a, b = b, a
            if isinstance(b, FX.EStrLit):
                bv = layout.slot(a.name).encode(b.value)
                av = ev(a, p, snap)
            else:
                av, bv = ev(a, p, snap), ev(b, p, snap)
            return int({"eq": av == bv, "ne": av != bv, "ge": av >= bv,
                        "le": av <= bv, "gt": av > bv, "lt": av < bv}[e.op])
        if isinstance(e, FX.ENot):
            return int(ev(e.a, p, snap) == 0)
        if isinstance(e, FX.EAnd):
            return int(ev(e.a, p, snap) != 0 and ev(e.b, p, snap) != 0)
        if isinstance(e, FX.EOr):
            return int(ev(e.a, p, snap) != 0 or ev(e.b, p, snap) != 0)
        if isinstance(e, FX.EWhere):
            return ev(e.a, p, snap) if ev(e.c, p, snap) != 0 else ev(e.b, p, snap)
        if isinstance(e, FX.EAt):
            i = ev(e.idx, p, snap)
            return ev(e.val, i, snap) if 1 <= i <= self.n else 0
        if isinstance(e, FX.EIncoming):
            total = 0
            for q in range(1, self.n + 1):
                if ev(e.mask, q, snap) != 0 and ev(e.key, q, snap) == p:
                    total += ev(e.val, q, snap)
            # wrap like the executors' int32 adds (sequential int32
            # addition == one final wrap of the unbounded sum)
            return _i32(total)
        if isinstance(e, FX.EEqCount):
            kp = ev(e.key, p, snap)
            return sum(1 for q in range(1, self.n + 1)
                       if ev(e.mask, q, snap) != 0 and ev(e.key, q, snap) == kp)
        if isinstance(e, FX.ERank):
            kp = ev(e.key, p, snap)
            return sum(1 for q in range(1, p)
                       if ev(e.mask, q, snap) != 0 and ev(e.key, q, snap) == kp)
        if isinstance(e, FX.EReduce):
            vals = [ev(e.val, q, snap) for q in range(1, self.n + 1)
                    if ev(e.mask, q, snap) != 0]
            if e.kind == "sum":
                return _i32(sum(vals))
            if e.kind == "count":
                return len(vals)
            if not vals:
                return 0  # empty max/min pins to 0 (P20)
            return max(vals) if e.kind == "max" else min(vals)
        if isinstance(e, FX.EArgBest):
            pairs = [(q, ev(e.key, q, snap)) for q in range(1, self.n + 1)
                     if ev(e.mask, q, snap) != 0]
            if not pairs:
                return 0
            best = (max if e.kind == "max" else min)(v for _, v in pairs)
            return min(q for q, v in pairs if v == best)  # ties to lowest seat
        raise TypeError(e)

    def _apply_effects(self, program, reveal_bools) -> None:
        for block in program:
            snap = {q: dict(self.players[q]) for q in self.players}
            for st in block:
                if isinstance(st, FX.SDeal):
                    # P10: rank ALL seats by splitmix32 key (salt 0 = the
                    # retired bespoke kernel's permutation; ties to the
                    # lower seat); `where` only gates which writes land
                    ms = FX.deal_multiset(st.counts, st.filler, self.n)
                    keys = []
                    for q in range(self.n):
                        salt = self._fx_eval(st.salt, q + 1, snap) & 0xFFFFFFFF
                        keys.append(M.splitmix32(
                            (self.seed * 0x100 + q
                             + salt * 0x9E3779B9) & 0xFFFFFFFF))
                    order = sorted(range(self.n), key=lambda q: (keys[q], q))
                    for r, q in enumerate(order):
                        if self._fx_eval(st.where, q + 1, snap) != 0:
                            self.players[q + 1][st.field] = ms[r]
                    continue
                for p in range(1, self.n + 1):
                    if self._fx_eval(st.where, p, snap) == 0:
                        continue
                    if isinstance(st, FX.SOver):
                        # guard + value pinned to the lowest seat (room-
                        # uniform terminal expressions)
                        if p == 1:
                            self.done = True
                            self.winner = _i32(self._fx_eval(st.value, p, snap))
                        continue
                    if isinstance(st, FX.SKill):
                        self._kill(p, reveal_bools)
                        continue
                    if isinstance(st, FX.SReset):
                        slot = self.game.layout.slot(st.field)
                        from game_engine_tpu_torch.gamespec.layout import (
                            BANK_ODICT, BANK_PDICT, BANK_NUM, BANK_STR)
                        if slot.bank in (BANK_ODICT, BANK_PDICT):
                            dv = {}
                        elif slot.bank == BANK_STR:
                            # canonical vocab casing, like the lowered
                            # ST_SET const (encode->decode round trip)
                            dv = slot.decode(slot.encode(slot.default))
                        elif slot.bank == BANK_NUM:
                            try:  # non-numeric default reads as 0 in the
                                dv = int(slot.default or 0)  # coded banks
                            except (TypeError, ValueError):
                                dv = 0
                        else:
                            dv = bool(slot.default)
                        self.players[p][st.field] = dv
                        continue
                    row = self.players[p]
                    slot = self.game.layout.slot(st.field)
                    if isinstance(st, FX.SSetKey):
                        # FIELD[KEY] = 'literal' (pdict entry; keys outside
                        # 1..n write nothing — the pinned seat domain)
                        k = self._fx_eval(st.key, p, snap)
                        if 1 <= k <= self.n:
                            d = dict(row.get(st.field) or {})
                            d[str(k)] = slot.decode(slot.encode(st.value.value))
                            row[st.field] = d
                        continue
                    if isinstance(st, FX.SSet) and slot.bank == "str":
                        # vocab-coded string write (canonical vocab casing)
                        row[st.field] = slot.decode(slot.encode(st.value.value))
                        continue
                    v = self._fx_eval(st.value, p, snap)
                    if isinstance(st, FX.SAdd):
                        row[st.field] = _i32(int(row.get(st.field, 0) or 0) + v)
                    elif slot.bank == "bool":
                        row[st.field] = v != 0
                    else:
                        row[st.field] = v

    # -- transition (P3/P4/P5) ------------------------------------------------

    def _complete(self) -> bool:
        if self.phase.completion is CompletionType.PLAYER_ACTION:
            return all(p in self.acted for p in self._targets(self.phase))
        return True  # UI_displayed / timer auto-complete (P3)

    def _select_next(self) -> Optional[int]:
        phase = self.phase
        if phase.terminal:
            return None
        if phase.branches:
            for b in phase.branches:
                if C.eval_condition(b.cond, self.players, self.prev_phase_id):
                    return b.next_index
            return phase.branches[-1].next_index  # P5 fallback
        return phase.next_index

    def step(self, actions: Optional[dict[int, int]] = None) -> OracleTrace:
        """One engine step = one reference game turn.

        ``actions``: player id -> choice int (P2 encoding). Illegal or
        ineligible actions are silently ignored (the referee's invalid-vote
        rule, reference: agent/prompt/referee_system_prompt_1.txt:45-51).
        """
        self.step_count += 1
        if not self.done:
            if actions:
                for pid in sorted(actions):
                    if 1 <= pid <= self.n:
                        self._accept(pid, int(actions[pid]))
            if self._complete():
                nxt = self._select_next()
                if nxt is not None and nxt != self.phase.index:
                    self.prev_phase_id = self.phase.dsl_id
                    self.phase = self.game.phases[nxt]
                    self.acted = set()
                    self._apply_on_enter(self.phase)
        return self.trace()

    def trace(self) -> OracleTrace:
        return OracleTrace(
            phase_id=self.phase.dsl_id,
            done=self.done,
            winner=self.winner,
            alive=tuple(bool(self.players[p].get("is_alive", True)) for p in range(1, self.n + 1)),
            acted=tuple(p in self.acted for p in range(1, self.n + 1)),
        )

    # -- introspection helpers (tests / projection) ----------------------------

    def field_values(self, name: str) -> list[Any]:
        return [self.players[p].get(name) for p in range(1, self.n + 1)]

    def snapshot(self) -> dict[str, Any]:
        """AgentState-shaped dict (reference: src/lib/canvas/types.ts:338-360)."""
        return {
            "player_states": {str(p): dict(self.players[p]) for p in range(1, self.n + 1)},
            "current_phase_id": self.phase.dsl_id,
            "current_phase_name": self.phase.name,
            "done": self.done,
            "winner": self.winner,
        }
