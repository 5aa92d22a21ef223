"""Search bots: flat Monte-Carlo lookahead, on the card through the search kernel.

Counterpart of game_engine_tpu/policies/search.py, which runs the native C++
search (gamesim.cpp ``gs_room_search``) one seat at a time on one host core.
A bot evaluates every legal choice of its seat by rolling ``rollouts``
scripted continuations of the whole room, each up to ``horizon`` steps, and
picks the choice with the best total terminal outcome for itself. Scoring
mirrors train/ppo.py terminal_rewards: team games compare the seat's FINAL
team with the winning team's code, survivor and score games pay the winning
seat. Rollout k replays the same opponent stream for every candidate (common
random numbers), so every decision is a pure function of (room state, seed,
config) and journal replay reproduces search-bot rooms bit for bit.

On a CUDA device the full-information decisions (D = 0) of a call are made
on the card in one launch of the decide kernel (core/search_kernel.py
``kernel_decide``, csrc/search.cu), from the rooms where they are: which
seats wait, their candidates, the rollouts and the argmax, the same C++
rules as room_step.cuh code. The determinized tier (D > 0) samples its
worlds on the host: every (seat, world, candidate) goes into ONE request
table and one launch of the request kernel (``kernel_search_arrays``), and
the host reproduces the rest of the C++ search in numpy: the candidate
list, the no-decision, forced-submit and single-candidate rules, the
ascending strictly-greater argmax (ties to the lowest choice), the salts
and the world loop. On the CPU both tiers take that host route with the
plain version (``search_scores_plain``). The totals are exact integers, so
the decisions equal the C++ search's whatever the order of the launch.

Served via ``server.api --bot-search`` (server/manager.py).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Optional

import numpy as np
import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.core import search_kernel as SK
from game_engine_tpu_torch.core.state import _DTYPES, M32, GameState
from game_engine_tpu_torch.core.step import waiting_seats
from game_engine_tpu_torch.gamespec.mechanics import ChoiceKind, splitmix32

_log = logging.getLogger(__name__)
_SUBMIT = "submit"      # a forced submit: the C++ search answers 1
_SCORES_CAP = 1024      # CppRoom.search_scores's buffer: more candidates = no decision
_ARRAYS = ("bools", "nums", "strs", "pdict", "odict", "acted", "choice", "choice_phase")
_NP_DTYPES = {k: torch.empty(0, dtype=v).numpy().dtype for k, v in _DTYPES.items()}


def _mix(a: int, b: int) -> int:
    """Cheap 32-bit mix for the per-call salt (not a semantics surface —
    any deterministic function works; the rollout seed mixes further)."""
    x = ((a & 0xFFFFFFFF) * 0x9E3779B9 + (b & 0xFFFFFFFF) * 0x85EBCA6B)
    return x & 0xFFFFFFFF


def _perm_order(seed: int, k: int) -> list[int]:
    """Deterministic permutation of range(k): argsort of splitmix32 keys
    (ties by index) — the same construction as mechanics.role_permutation,
    so the determinizer's shuffles are backend-independent integer math."""
    return sorted(range(k), key=lambda j: (splitmix32((seed * 0x100 + j)
                                                      & 0xFFFFFFFF), j))


class Determinizer:
    """Information-set resampler for the determinized search tier (the JAX
    package's, line for line).

    The full-information search reads the TRUE room state. This class
    samples worlds a given searcher cannot distinguish from the truth under
    the observation mask the learned policy uses (policies/net.py):

      * PUBLIC fields, alive flags, phase, the searcher's own row, and
        (role/team of) reveal-flagged seats are copied unchanged;
      * hidden columns are jointly RELABELED among the seats they are
        hidden from — one permutation per hidden-seat group, so every
        per-seat bundle of hidden values moves together and the sampled
        world is internally consistent within each group;
      * the identity group (role/team + any TEAM-visible field) excludes
        seats the searcher coordinates with (the minority-team rule) and
        reveal-flagged seats.

    Relabeling preserves each hidden column's multiset — the public
    composition knowledge every player has — which makes this the
    uniform-determinization scheme of imperfect-information search.
    """

    def __init__(self, lowered):
        from game_engine_tpu_torch.policies.net import (
            _REVEAL_RE,
            _phase_public_acting,
            VIS_PUBLIC,
            VIS_TEAM,
            field_visibility,
            minority_team_code,
        )

        lay = lowered.game.layout
        self.lowered = lowered
        vis = field_visibility(lowered)
        self.minority = minority_team_code(lowered)
        ts = lay.get("team")
        self.team_idx = ts.index if (ts is not None and ts.bank == "str") else None
        self.reveal_idx = None
        for f in lowered.game.spec.declaration.fields:
            if _REVEAL_RE.search(f.name):
                rs = lay.get(f.name)
                if rs is not None and rs.bank == "bool":
                    self.reveal_idx = rs.index
                    break
        self.pub_acting = _phase_public_acting(lowered)
        # hidden slots: the identity group (role/team family + TEAM-visible
        # fields) and the plain private group (hidden from every other seat)
        self.ident_slots: list[tuple[str, int]] = []
        self.self_slots: list[tuple[str, int]] = []
        for f in lowered.game.spec.declaration.fields:
            v = vis.get(f.name, VIS_PUBLIC)
            if v == VIS_PUBLIC:
                continue
            s = lay.get(f.name)
            if s is None or s.bank not in ("bool", "num", "str", "pdict", "odict"):
                continue
            if f.name in ("role", "team") or v == VIS_TEAM:
                self.ident_slots.append((s.bank, s.index))
            else:
                self.self_slots.append((s.bank, s.index))

    def _hidden_seats(self, st: dict, p0: int, n: int) -> tuple[list[int], list[int]]:
        """(ident_group, self_group) 0-based seat lists hidden from p0."""
        others = [q for q in range(n) if q != p0]
        strs = np.asarray(st["strs"])
        bools = np.asarray(st["bools"])
        ident = []
        for q in others:
            if self.reveal_idx is not None and bools[q, self.reveal_idx]:
                continue  # P15: revealed seats' role/team is public
            if (self.minority is not None and self.team_idx is not None
                    and int(strs[p0, self.team_idx]) == self.minority
                    and int(strs[q, self.team_idx]) == int(strs[p0, self.team_idx])):
                continue  # the coordinating minority team sees its teammates
            ident.append(q)
        return ident, others

    def apply(self, st: dict, p0: int, n: int, dseed: int) -> dict:
        """One determinized copy of state dict `st` for searcher seat p0."""
        out = dict(st)
        for k in _ARRAYS:
            out[k] = np.array(st[k], copy=True)
        ident, selfg = self._hidden_seats(st, p0, n)
        banks = {"bool": "bools", "num": "nums", "str": "strs", "pdict": "pdict",
                 "odict": "odict"}

        def relabel(seats: list[int], slots: list[tuple[str, int]],
                    extras: bool, salt: int) -> None:
            if len(seats) < 2:
                return
            order = _perm_order(_mix(dseed, salt), len(seats))
            src = [seats[o] for o in order]
            for bank, idx in slots:
                a = out[banks[bank]]
                a0 = np.array(a, copy=True)
                a[seats, idx] = a0[src, idx]  # a pdict moves its whole row
            if extras:
                # pending decisions are private until resolved; who-acted
                # is public exactly when the phase selects actors by
                # public fields (net._phase_public_acting)
                keys = ["choice", "choice_phase"]
                if not bool(self.pub_acting[int(st["phase_index"])]):
                    keys.append("acted")
                for key in keys:
                    a = out[key]
                    a0 = np.array(a, copy=True)
                    a[seats] = a0[src]

        if ident == selfg:
            # the searcher coordinates with nobody (majority case): ONE
            # permutation moves each seat's whole hidden bundle together
            relabel(selfg, self.ident_slots + self.self_slots,
                    extras=True, salt=0x1DE47)
        else:
            # minority searcher: teammates' identity is visible but their
            # private bookkeeping is still hidden — two groups, each
            # internally consistent
            relabel(ident, self.ident_slots, extras=False, salt=0x1DE47)
            relabel(selfg, self.self_slots, extras=True, salt=0x5E1F5)
        return out


class SearchBots:
    """Per-game lookahead actor with the serving interface of
    policies/serve.py PolicyBots (``actions_for_slots`` for the torch
    backend, ``native_actions`` for the native one), on `device`: the search
    kernel on the card, its plain version on the CPU. There is no other
    route: a failed build or a refused launch raises."""

    def __init__(self, lowered, rollouts: int = 32, horizon: int = 200,
                 salt: int = 0, determinize: int = 0, device=D.DEFAULT):
        self.lowered = lowered
        self.rollouts = int(rollouts)
        self.horizon = int(horizon)
        self.salt = int(salt)
        # determinize=D>0: INFORMATION-SET search — score every candidate
        # in D hidden-state determinizations sampled under the searcher's
        # own observation mask (class Determinizer) and argmax the summed
        # totals, instead of reading the true state. D=0 is full information.
        self.determinize = int(determinize)
        self.scoring = SK.scoring(lowered)  # ValueError: nothing to search for
        if self.rollouts < 1 or self.horizon < 0:
            raise ValueError(f"rollouts={rollouts}, horizon={horizon}")
        self.device = D.resolve(device)
        self.route = "kernel" if self.device.type == "cuda" else "plain"
        if self.route == "kernel":
            SK.game_arrays(lowered, self.device)  # builds the library and checks the game
        self._det = Determinizer(lowered) if self.determinize > 0 else None
        # journal header tag, the JAX package's (server/manager.py records and
        # verifies it on replay like a checkpoint path), so journals cross
        det_tag = f",det={self.determinize}" if self.determinize > 0 else ""
        self.ckpt_path = (f"search(rollouts={self.rollouts},"
                          f"horizon={self.horizon},salt={self.salt}{det_tag})")
        self._last_call = {"decisions": 0, "requests": 0, "worlds": 0}
        self._stats = None  # the decide launch's Decided.stats on the card, read when asked
        self._last = None  # the last scoring's (sources, requests, totals), for checks
        self._cpp_game = None  # the native simulator's game and scratch rooms by seat
        self._cpp_rooms: dict = {}  # count, for native_actions' C++ rule
        _log.info("%s", json.dumps({"event": "bot_search", "game": lowered.game.spec.name,
                                    "tag": self.ckpt_path, "route": self.route}))

    # -- the C++ search's host rules, in numpy -----------------------------------

    def _candidates(self, bools: np.ndarray, present: np.ndarray, phase: int):
        """The searchable choices of a deciding seat (gamesim.cpp
        search_scores_core): the alive seats for a target phase, 1..max for
        an option phase, _SUBMIT for a submit phase; None when there are
        none."""
        lw = self.lowered
        kind = int(lw.choice_kind[phase])
        if kind == ChoiceKind.TARGET.value:
            alive = present if lw.alive_bool < 0 else present & bools[:, lw.alive_bool].astype(bool)
            cands = [q + 1 for q in range(lw.P) if alive[q]]
        elif kind == ChoiceKind.OPTION.value:
            hi = int(lw.choice_max[phase]) or int(present.sum())
            cands = list(range(1, hi + 1))
        elif kind == ChoiceKind.SUBMIT.value:
            return _SUBMIT
        else:
            return None
        return cands or None

    @staticmethod
    def _best(totals: dict) -> int:
        """The first strictly-best candidate in ascending order (the C++
        argmax: ties to the lowest choice)."""
        best_c, best_s = 0, None
        for c in sorted(totals):
            if best_s is None or totals[c] > best_s:
                best_c, best_s = c, totals[c]
        return best_c

    def _rows(self, state: GameState, slots: list[int], host) -> dict:
        """The state's fields and its waiting seats for `slots`, as numpy
        arrays indexed by position in `slots`: from `host` (a mirror of the
        state's fields and "waiting", by slot) when given, else from `state`
        (one device-to-host copy when it lies on the card)."""
        names = GameState._fields + ("waiting",)
        if host is not None:
            return {k: np.asarray(host[k])[slots] for k in names}
        idx = torch.as_tensor(slots, dtype=torch.long, device=state.present.device)
        sub = GameState(*(f.index_select(0, idx) for f in state))
        parts = list(zip(GameState._fields, sub)) + [("waiting", waiting_seats(self.lowered,
                                                                               sub))]
        flat = torch.cat([t.reshape(len(slots), -1).to(torch.int64) for _, t in parts],
                         dim=1).cpu().numpy()
        out, at = {}, 0
        for name, t in parts:
            width = int(np.prod(t.shape[1:], dtype=np.int64))
            out[name] = flat[:, at:at + width].reshape(t.shape)
            at += width
        return out

    @property
    def last_call(self) -> dict:
        """What the last call decided: {"decisions": waiting seats,
        "requests": candidates scored, "worlds": sampled worlds}; after a
        decide launch, read from the card when asked."""
        if self._stats is not None:
            decisions, requests, _ = self._stats.tolist()
            self._last_call = {"decisions": decisions, "requests": requests, "worlds": 0}
            self._stats = None
        return self._last_call

    def _scores(self, sources: dict, requests: list, plain: bool) -> np.ndarray:
        """Every request's total, its rooms `sources` (GameState fields as
        numpy arrays, a room a request names by index): one copy to the card
        and one launch of the request kernel there, or the plain version on
        the bots' device."""
        if not requests:
            return np.zeros(0, np.int64)
        args = (self.rollouts, self.horizon, self.scoring)
        if not plain:
            totals = SK.kernel_search_arrays(self.lowered, sources, requests, *args,
                                             device=self.device)
        else:
            SK.check_requests(self.lowered, np.asarray(requests, np.int64),
                              len(sources["phase"]))
            totals = SK.search_scores_plain(self.lowered, self._state_of(sources),
                                            SK.request_table(requests, self.device), *args)
        out = totals.cpu().numpy()
        self._last = (sources, requests, out)
        return out

    def last_launch(self) -> tuple:
        """What the last call scored, on the bots' device: (the source rooms
        as a GameState, the request table, the totals in numpy); None before
        any request. For checks against the plain and the C++ search."""
        if self._last is None:
            return None
        sources, requests, totals = self._last
        return self._state_of(sources), SK.request_table(requests, self.device), totals

    def _decide(self, slots: list[int], rows: dict, plain: bool) -> np.ndarray:
        """(len(slots), P) choices, 0 where a seat has no decision, for the
        rooms of `rows` (see _rows). The rooms with something to search (D =
        0) or the sampled worlds (D > 0) are scored in one _scores call."""
        P = self.lowered.P
        out = np.zeros((len(slots), P), np.int32)
        requests: list = []
        pending: list = []  # (position, seat, {candidate: [request rows]}, fixed totals)
        rooms: list = []    # D = 0: the positions the requests name, in order
        worlds: list = []   # D > 0: the sampled worlds the requests name
        n_decisions = 0
        for i in range(len(slots)):
            if rows["done"][i] or not rows["waiting"][i].any():
                continue
            present = rows["present"][i].astype(bool)
            n = int(present.sum())
            base = _mix(int(rows["seed"][i]), self.salt)
            st = None
            for p in np.flatnonzero(rows["waiting"][i]):
                p = int(p)
                n_decisions += 1
                if self._det is None:
                    cands = self._candidates(rows["bools"][i], present, int(rows["phase"][i]))
                    if cands is None:
                        continue
                    if cands == _SUBMIT or len(cands) == 1:
                        out[i, p] = 1 if cands == _SUBMIT else cands[0]
                        continue
                    if not rooms or rooms[-1] != i:
                        rooms.append(i)
                    at = len(requests)
                    requests += [(len(rooms) - 1, p, c, base) for c in cands]
                    pending.append((i, p, {c: [at + j] for j, c in enumerate(cands)}, {}))
                    continue
                if st is None:
                    st = self._read_of(rows, i)
                rows_by_c: dict = {}
                fixed: dict = {}
                decided = False
                for d in range(self.determinize):
                    dseed = _mix(base, ((p + 1) * 0x01000193 + d) & M32)
                    st_d = self._det.apply(st, p, n, dseed)
                    cands = self._candidates(st_d["bools"], present, int(st["phase_index"]))
                    if cands is None or (cands != _SUBMIT and len(cands) > _SCORES_CAP):
                        break  # no decision in this world: none in any later one
                    decided = True
                    if cands == _SUBMIT or len(cands) == 1:
                        fixed.setdefault(1 if cands == _SUBMIT else cands[0], 0)
                        continue
                    w = len(worlds)
                    worlds.append(st_d)
                    salt = _mix(base, (0xD0000001 + d) & M32)
                    for c in cands:
                        rows_by_c.setdefault(c, []).append(len(requests))
                        requests.append((w, p, c, salt))
                if decided:
                    pending.append((i, p, rows_by_c, fixed))
        self._last_call = {"decisions": n_decisions, "requests": len(requests),
                           "worlds": len(worlds)}
        self._stats = None
        totals = np.zeros(0, np.int64)
        if requests:
            sources = (self._fields_of_reads(worlds) if self._det is not None
                       else {k: rows[k][rooms] for k in GameState._fields})
            totals = self._scores(sources, requests, plain)
        for i, p, rows_by_c, fixed in pending:
            tot = dict(fixed)
            for c, at in rows_by_c.items():
                tot[c] = tot.get(c, 0) + int(totals[at].sum())
            if tot:
                out[i, p] = self._best(tot)
        return out

    def _read_of(self, rows: dict, i: int) -> dict:
        """Room i of `rows` as a CppRoom.read()-style state dict."""
        st = {"phase_index": int(rows["phase"][i]), "done": bool(rows["done"][i]),
              "winner": int(rows["winner"][i]), "prev_index": int(rows["prev_phase"][i]),
              "t": int(rows["t"][i]), "n": int(rows["present"][i].sum())}
        for k in _ARRAYS:
            st[k] = np.asarray(rows[k][i]).astype(np.int32)
        return st

    def _fields_of_reads(self, reads: list) -> dict:
        """CppRoom.read()-style room dicts, each with its seat count "n" (and
        its "seed" where known), as GameState fields: numpy arrays (W, ...)
        in the state's dtypes, as state_from_read would make them."""
        P = self.lowered.P
        n = np.asarray([r["n"] for r in reads])
        f = {k: np.stack([np.asarray(r[k]) for r in reads]) for k in _ARRAYS}
        f.update(present=np.arange(P)[None, :] < n[:, None],
                 phase=[r["phase_index"] for r in reads],
                 prev_phase=[r["prev_index"] for r in reads],
                 done=[r["done"] for r in reads], winner=[r["winner"] for r in reads],
                 t=[r["t"] for r in reads], seed=[r.get("seed", 0) & M32 for r in reads])
        return {k: np.asarray(f[k]).astype(np.int64).astype(_NP_DTYPES[k])
                for k in GameState._fields}

    def _state_of(self, fields: dict) -> GameState:
        """GameState fields in numpy as one GameState on the bots' device,
        in one host-to-device copy."""
        W = len(fields["phase"])
        flat = np.concatenate([np.asarray(fields[k]).reshape(W, -1).astype(np.int64)
                               for k in GameState._fields], axis=1)
        dev = torch.as_tensor(flat, device=self.device)
        out, at = {}, 0
        for k in GameState._fields:
            shape = np.shape(fields[k])
            width = int(np.prod(shape[1:], dtype=np.int64))
            out[k] = dev[:, at:at + width].reshape(shape).to(_DTYPES[k]).contiguous()
            at += width
        return GameState(**out)

    def _native_rows(self, read: dict, n_players: int, seed: int) -> dict:
        """One native room's _rows from its read() state, on the host. Its
        "waiting" seats are those the C++ search decides for: the room
        written to a scratch native room, gs_room_search_scores at zero
        rollouts (the C++ rule, no rollout) for each seat. A waiting seat it
        leaves out has no candidate in any world, so _decide would give it
        no choice either."""
        from game_engine_tpu_torch.native import CppGame

        rows = self._fields_of_reads([dict(read, n=n_players, seed=seed)])
        if self._cpp_game is None:
            self._cpp_game = CppGame(self.lowered)
        room = self._cpp_rooms.get(n_players)
        if room is None:
            room = self._cpp_rooms[n_players] = self._cpp_game.room(n_players, 0)
        room.write(read)
        sc = self.scoring
        rows["waiting"] = np.zeros((1, self.lowered.P), bool)
        for p in range(n_players):
            rows["waiting"][0, p] = room.search_scores(
                p + 1, 0, 0, sc.mode, sc.team_slot, sc.team_codes, 0) is not None
        return rows

    # -- the serving interface ---------------------------------------------------

    def _on_card(self) -> bool:
        """Whether the decisions are the decide kernel's: full information on
        a CUDA device."""
        return self.determinize == 0 and self.route == "kernel"

    def actions_for_slots(self, state: GameState, slots=None, host=None) -> torch.Tensor:
        """(B, P) int32 choices on the state's device for the rooms `slots`
        (None: every room), 0 for a seat with no decision and for the other
        rooms. Every decision of the call goes into one launch. `host`: a
        numpy mirror of the state's fields and its "waiting" seats by slot
        (server/manager.py _TorchSlots.host). At D = 0 on the card the rooms
        are selected where they lie and decided there (kernel_decide), with
        no launch when the mirror shows no seat waiting; else the mirror is
        read instead of the device."""
        if not self._on_card():
            return self.request_actions(state, slots, host)
        B, P = state.present.shape
        dev = state.present.device
        keep = list(range(B)) if slots is None else sorted({int(s) for s in slots})
        if not keep or (host is not None and not np.asarray(host["waiting"])[keep].any()):
            return torch.zeros((B, P), dtype=torch.int32, device=dev)
        if slots is None:
            sub, idx = state, None
        else:
            idx = torch.as_tensor(keep, dtype=torch.long, device=dev)
            sub = GameState(*(f.index_select(0, idx) for f in state))
        dec = SK.kernel_decide(self.lowered, sub, self.rollouts, self.horizon, self.scoring,
                               self.salt)
        self._stats = dec.stats
        if idx is None:
            return dec.actions
        return torch.zeros((B, P), dtype=torch.int32, device=dev).index_copy_(0, idx, dec.actions)

    def request_actions(self, state: GameState, slots=None, host=None,
                        plain: Optional[bool] = None) -> torch.Tensor:
        """actions_for_slots by the host's rules and one request table: the
        route of D > 0 and of the CPU, and at D = 0 on the card the check
        of the decide kernel. Scored by the request kernel on the card, or
        by the plain version (plain=True, and always on the CPU);
        last_launch() then gives what was scored."""
        B, P = state.present.shape
        slots = list(range(B)) if slots is None else sorted({int(s) for s in slots})
        out = np.zeros((B, P), np.int32)
        if slots:
            plain = self.route == "plain" or bool(plain)
            out[slots] = self._decide(slots, self._rows(state, slots, host), plain)
        return torch.as_tensor(out, device=state.present.device)

    def actions(self, state: GameState) -> np.ndarray:
        """(B, P) int32 numpy choices for every room of a batched state."""
        return self.actions_for_slots(state).cpu().numpy()

    def native_actions(self, read: dict[str, Any], n_players: int,
                       seed: int = 0) -> dict[int, int]:
        """{pid: choice} for one room's CppRoom.read() state. At D = 0 on the
        card its fields go there in one copy and the decide kernel decides
        (a done room or a phase without actions has no decision and no
        launch); else the waiting seats, candidates and requests are worked
        out on the host and the room goes to the bots' device with the
        request table only when a seat has something to search. Seats
        without a decision are omitted (the host then clears their action,
        matching the scripted policy's silence for those seats)."""
        if not self._on_card():
            acts = self._decide([0], self._native_rows(read, n_players, seed),
                                self.route == "plain")[0]
        elif read["done"] or not self.lowered.phase_is_action[int(read["phase_index"])]:
            return {}
        else:
            fields = self._fields_of_reads([dict(read, n=n_players, seed=seed)])
            dec = SK.kernel_decide_arrays(self.lowered, fields, self.rollouts, self.horizon,
                                          self.scoring, self.salt, self.device)
            self._stats = dec.stats
            acts = dec.actions[0].cpu().numpy()
        return {p + 1: int(acts[p]) for p in range(len(acts)) if acts[p] != 0}

    def native_room_actions(self, room, n_players: int, seed: int = 0) -> dict[int, int]:
        """native_actions on a live CppRoom's state (never mutated)."""
        return self.native_actions(room.read(), n_players, seed)


def make_search_bots(lowered, rollouts: int = 32, horizon: int = 200, salt: int = 0,
                     determinize: int = 0, device=D.DEFAULT) -> Optional[SearchBots]:
    """SearchBots, or None (with the reason logged) for a game with no
    searchable terminal rule — the host then serves scripted bots. Any
    other failure (a kernel that does not build, a game the kernel cannot
    hold) raises."""
    try:
        SK.scoring(lowered)
    except ValueError as e:
        _log.warning("search bots unavailable: %s", e)
        return None
    return SearchBots(lowered, rollouts=rollouts, horizon=horizon, salt=salt,
                      determinize=determinize, device=device)
