"""GameHost: interactive rooms hosted inside one batched engine state.

Counterpart of game_engine_tpu/server/manager.py. Two backends:
``torch`` (the default: every live room of a game is a slot of one batched
GameState on the host's device, ``_TorchSlots``, stepped by the port's
engine step) and ``native`` (a room a C++ ``CppRoom`` of the port's copy of
gamesim.cpp, ``_NativeRooms``, stepped on the host; the JAX package's
default). Bots are scripted, or greedy policy bots through the
policy-forward kernel (K2) on the card (``bot_ckpts``), or lookahead search
bots through the search kernel on the card (``bot_search``), on either
backend. ``chat_lm`` serves the learned chat tier (policies/chat_lm.py)
on the host's device: the chat decode kernel on the card, its plain version
on the CPU.

The reference binds one LangGraph thread per room and re-runs a 4-LLM
pipeline per turn (reference: src/app/api/rooms/create/route.ts:16-26,
SURVEY.md §3.2). Here every live room of a game occupies a slot in a single
batched GameState; a turn is one fused engine step applied only to the
requesting room (other slots are frozen via masked select). Human actions
arrive asynchronously into a host-side queue and are merged with on-device
bot-policy actions on the next step — the host/device action-queue design
from SURVEY.md §7. Any subset of seats can be human (the reference admits
multi-human broadcasting is unfinished, its README.md:22; here
it is first-class): the bot policy never emits for human seats (reference:
agent/prompt/bot_behavior_system_prompt.txt, ABSOLUTE HUMAN EXCLUSION),
and snapshots carry ``waiting_on`` — the human seats that must act.

Durability: every state-mutating host event (engine step with merged human
actions, chat post, free-text submit) is appended to a per-room JSONL
journal (server/journal.py); on restart, replaying the journal through the
same code paths restores live rooms bit-identically.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.core.engine import BatchedEngine
from game_engine_tpu_torch.core.state import GameState, init_state
from game_engine_tpu_torch.core.step import waiting_seats
from game_engine_tpu_torch.gamespec.compile import GameConfig, compile_game
from game_engine_tpu_torch.gamespec.mechanics import ChoiceKind
from game_engine_tpu_torch.gamespec.parser import games_dir, load_game_spec
from game_engine_tpu_torch.gamespec.tables import Lowered, lower
from game_engine_tpu_torch.view.project import Projector

import os

SLOTS_PER_GAME = 64
# the host mirror's numpy dtypes: the JAX package's, but for the seed
# (int64 holding uint32 values, as the port's GameState holds it)
_HOST_DTYPES = {
    "bools": bool, "nums": np.int32, "strs": np.int8, "pdict": np.int8,
    "odict": np.int8, "present": bool, "phase": np.int32, "prev_phase": np.int32,
    "acted": bool, "choice": np.int32, "choice_phase": np.int32, "done": bool,
    "winner": np.int32, "t": np.int32, "seed": np.int64, "waiting": bool,
}


_BOT_SUBMISSIONS = (
    "I once won a local chess tournament.",
    "I have never been on an airplane.",
    "I can cook a five-course meal from memory.",
    "I met my best friend in a lost-luggage line.",
    "I've read the same book eleven times.",
    "I once walked thirty kilometres in one day.",
    "I'm secretly afraid of escalators.",
    "I learned to juggle before I learned to swim.",
    "I've never tasted coffee.",
    "I once slept through an earthquake.",
    "I can name every country in South America.",
    "I keep a diary written entirely in code.",
)


def _bot_submission(seed: int, pid: int, field: str, example: Any) -> dict[str, str]:
    """Deterministic stand-in content for a bot's text submit (the reference's
    bots generate statements via LLM; here a seeded pick from a fixed pool)."""
    from game_engine_tpu_torch.gamespec.mechanics import splitmix32

    n = len(example) if isinstance(example, dict) and example else 3
    n = min(n, len(_BOT_SUBMISSIONS))  # distinctness loop must terminate
    out: dict[str, str] = {}
    used: set[int] = set()
    for i in range(n):
        h = splitmix32((seed * 977 + pid * 131 + i * 7 + len(field)) & 0xFFFFFFFF)
        k = h % len(_BOT_SUBMISSIONS)
        while k in used:  # distinct statements within one submission
            k = (k + 1) % len(_BOT_SUBMISSIONS)
        used.add(k)
        out[str(i + 1)] = _BOT_SUBMISSIONS[k]
    return out


def _normalize_text(text: Any) -> dict[str, str]:
    """Free text -> {"1": line, "2": line, ...} matching the reference's
    statements-dict shape (games/two-truths-and-a-lie.yaml:21-27)."""
    if isinstance(text, dict):
        return {str(k): str(v) for k, v in text.items() if str(v).strip()}
    if isinstance(text, (list, tuple)):
        return {str(i + 1): str(v) for i, v in enumerate(text) if str(v).strip()}
    lines = [ln.strip() for ln in str(text).split("\n") if ln.strip()]
    return {str(i + 1): ln for i, ln in enumerate(lines)}


class _TorchSlots:
    """Batched engine state + slot allocation for one compiled game, on the
    host's device, with a host mirror of every slot.

    Every read the host makes between steps (done, phase, step counter,
    alive seats, the seats a phase waits on, the decoded room, the journal
    snapshot) comes from ``self.host``: numpy copies of the state's fields
    and of the waiting matrix. The mirror is refreshed once after each step
    for the slots that stepped, and after an alloc or a restore for that
    slot, each time by one device-to-host copy (``_pull``). On a CUDA device
    that copy is the host's only wait for the card."""

    def __init__(self, lowered: Lowered, device, capacity: int = SLOTS_PER_GAME):
        self.lowered = lowered
        self.device = device
        self.engine = BatchedEngine(lowered, device)
        self.capacity = capacity
        self.state = init_state(lowered, capacity, lowered.P,
                                np.arange(capacity, dtype=np.uint32), device=device)
        self.host: dict[str, np.ndarray] = {}
        self._pull(list(range(capacity)))
        self.free = list(range(capacity))
        self.projectors: dict[int, Projector] = {}
        self.items: dict[int, list] = {}
        self.prev_dead: dict[int, list] = {}

    def _grow(self) -> None:
        """Double the batch when the slot pool is exhausted: 64 slots is
        the warm start, not a room cap. The live slots' tensors are copied
        into the larger batch unchanged."""
        old_cap, new_cap = self.capacity, self.capacity * 2
        tail = init_state(
            self.lowered, new_cap - old_cap, self.lowered.P,
            np.arange(old_cap, new_cap, dtype=np.uint32), device=self.device,
        )
        self.state = GameState(*(torch.cat([full, t], dim=0)
                                 for full, t in zip(self.state, tail)))
        self.capacity = new_cap
        self._pull(list(range(old_cap, new_cap)))
        self.free.extend(range(old_cap, new_cap))

    def _pull(self, slots: list[int]) -> None:
        """Refresh the host mirror's rows of `slots` (state fields and the
        waiting matrix) from the device, in one copy."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        sub = GameState(*(f.index_select(0, idx) for f in self.state))
        parts = list(zip(GameState._fields, sub)) + [("waiting", waiting_seats(self.lowered, sub))]
        flat = torch.cat([t.reshape(len(slots), -1).to(torch.int64) for _, t in parts],
                         dim=1).cpu().numpy()
        at = 0
        for name, t in parts:
            shape = tuple(t.shape[1:])
            width = int(np.prod(shape))
            arr = self.host.get(name)
            if arr is None or arr.shape[0] < self.capacity:
                grown = np.zeros((self.capacity,) + shape, _HOST_DTYPES[name])
                if arr is not None:
                    grown[:arr.shape[0]] = arr
                self.host[name] = arr = grown
            arr[slots] = flat[:, at:at + width].reshape((len(slots),) + shape)
            at += width

    def alloc(self, n_players: int, seed: int) -> int:
        if not self.free:
            self._grow()
        slot = self.free.pop(0)
        fresh = init_state(self.lowered, 1, n_players, np.uint32(seed), device=self.device)
        for full, one in zip(self.state, fresh):
            full[slot] = one[0]
        self._pull([slot])
        self.projectors[slot] = Projector(self.lowered.game)
        self.items[slot] = []
        self.prev_dead[slot] = []
        return slot

    def release(self, slot: int) -> None:
        self.free.append(slot)
        self.projectors.pop(slot, None)
        self.items.pop(slot, None)
        self.prev_dead.pop(slot, None)

    def step_slot(self, slot: int, human_actions: dict[int, int],
                  include_bots: bool = True,
                  human_seats: tuple[int, ...] = (1,),
                  policy=None, policy_seats: tuple[int, ...] = ()) -> None:
        """Advance only this slot by one engine step (others frozen).

        ``policy_seats`` decide via the greedy learned policy (--bot-ckpt);
        the remaining bot seats keep the scripted uniform-legal policy —
        a per-seat scripted/learned mix."""
        self.step_slots(
            [slot], {slot: human_actions}, {slot: human_seats},
            include_bots=include_bots, policy=policy,
            policy_seats={slot: tuple(policy_seats)},
        )

    def step_slots(self, slots: list[int],
                   human_actions: dict[int, dict[int, int]],
                   human_seats: dict[int, tuple],
                   include_bots: bool = True, policy=None,
                   policy_seats: Optional[dict[int, tuple]] = None) -> None:
        """Advance MANY slots in one engine step (rooms are independent
        along the batch axis, so a batched step equals per-slot steps).

        The actions are put together on the device: scripted bots, then the
        policy's greedy choices on policy seats, then the host's overrides
        (0 on human seats, the queued human choices). Only the slots in
        `slots` take the new state; the host mirror is then refreshed for
        them."""
        policy_seats = policy_seats or {}
        P = self.lowered.P
        dev = self.device
        if include_bots:
            actions = self.engine.bot_actions(self.state)
        else:
            actions = torch.zeros((self.capacity, P), dtype=torch.int32, device=dev)
        keep = np.zeros((self.capacity,), bool)
        pmask = np.zeros((self.capacity, P), bool)
        hmask = np.zeros((self.capacity, P), bool)
        hval = np.zeros((self.capacity, P), np.int32)
        for slot in slots:
            keep[slot] = True
            for pid in policy_seats.get(slot, ()):
                if 1 <= pid <= P:
                    pmask[slot, pid - 1] = True
            # human exclusion: policy never acts for human seats
            for pid in human_seats.get(slot, (1,)):
                if 1 <= pid <= P:
                    hmask[slot, pid - 1] = True
            for pid, choice in human_actions.get(slot, {}).items():
                if 1 <= pid <= P:
                    hmask[slot, pid - 1] = True
                    hval[slot, pid - 1] = int(choice)
        if include_bots and policy is not None and pmask.any():
            if hasattr(policy, "actions_for_slots"):
                # search bots: one launch for the decisions of the stepped
                # rooms, their candidates from the host mirror
                pa = policy.actions_for_slots(self.state, slots, host=self.host)
            else:
                pa = policy.greedy(self.state)
            actions = torch.where(torch.as_tensor(pmask, device=dev), pa, actions)
        actions = torch.where(torch.as_tensor(hmask, device=dev),
                              torch.as_tensor(hval, device=dev), actions)
        # the slots not stepped come back as they were (ST's keep mask on the card)
        self.state = self.engine.step(self.state, actions, keep=torch.as_tensor(keep, device=dev))
        self._pull(list(slots))

    # backend-agnostic accessors used by GameHost, all on the host mirror
    def snapshot_state(self, slot: int) -> dict[str, Any]:
        """JSON-able engine state of one slot (journal-compaction snapshots;
        the JAX package's field layout and values, so a journal written by
        either package restores in the other)."""
        h = self.host
        return {
            "phase_index": int(h["phase"][slot]), "done": bool(h["done"][slot]),
            "winner": int(h["winner"][slot]), "prev_index": int(h["prev_phase"][slot]),
            "t": int(h["t"][slot]), "seed": int(h["seed"][slot]),
            "n": int(h["present"][slot].sum()),
            "bools": h["bools"][slot].astype(int).tolist(),
            "nums": h["nums"][slot].tolist(),
            "strs": h["strs"][slot].astype(int).tolist(),
            "pdict": h["pdict"][slot].astype(int).tolist(),
            "odict": h["odict"][slot].astype(int).tolist(),
            "acted": h["acted"][slot].astype(int).tolist(),
            "choice": h["choice"][slot].tolist(),
            "choice_phase": h["choice_phase"][slot].tolist(),
        }

    def restore_state(self, slot: int, d: dict[str, Any]) -> None:
        P = self.lowered.P
        present = np.arange(P) < int(d["n"])
        values = {
            "bools": np.asarray(d["bools"], bool), "nums": np.asarray(d["nums"], np.int32),
            "strs": np.asarray(d["strs"], np.int8), "pdict": np.asarray(d["pdict"], np.int8),
            "odict": np.asarray(d["odict"], np.int8), "present": present,
            "acted": np.asarray(d["acted"], bool),
            "choice": np.asarray(d["choice"], np.int32),
            "choice_phase": np.asarray(d["choice_phase"], np.int32),
            "phase": np.int32(d["phase_index"]), "prev_phase": np.int32(d["prev_index"]),
            "done": np.bool_(d["done"]), "winner": np.int32(d["winner"]),
            "t": np.int32(d["t"]), "seed": np.int64(np.uint32(int(d["seed"]))),
        }
        for name, full in zip(GameState._fields, self.state):
            full[slot] = torch.as_tensor(values[name], device=self.device).to(full.dtype)
        self._pull([slot])

    def snapshot_raw(self, slot: int, names) -> dict[str, Any]:
        from game_engine_tpu_torch.view.decode import decode_native

        h = self.host
        read = {
            "bools": h["bools"][slot], "nums": h["nums"][slot],
            "strs": h["strs"][slot], "pdict": h["pdict"][slot],
            "odict": h["odict"][slot],
            "phase_index": int(h["phase"][slot]),
            "done": bool(h["done"][slot]), "winner": int(h["winner"][slot]),
            "t": int(h["t"][slot]),
        }
        n = int(h["present"][slot].sum())
        return decode_native(self.lowered, read, n, names)

    def is_done(self, slot: int) -> bool:
        return bool(self.host["done"][slot])

    def version(self, slot: int) -> int:
        return int(self.host["t"][slot])

    def phase_index(self, slot: int) -> int:
        return int(self.host["phase"][slot])

    def alive_ids(self, slot: int) -> list[int]:
        present = self.host["present"][slot]
        if self.lowered.alive_bool >= 0:
            alive = self.host["bools"][slot, :, self.lowered.alive_bool] & present
        else:
            alive = present
        return [p + 1 for p in range(len(alive)) if alive[p]]

    def must_act_seats(self, slot: int, seats) -> list[int]:
        """Human seats the current phase is waiting on (targeted, not acted)."""
        waiting = self.host["waiting"][slot]
        return [pid for pid in seats
                if 1 <= pid <= self.lowered.P and waiting[pid - 1]]

    def bot_turn_slots(self, humans_by_slot: dict[int, tuple]) -> list[int]:
        """Slots that are mid-bot-turn (not done, not waiting on any
        human), from the host mirror."""
        P = self.lowered.P
        waiting = self.host["waiting"]
        done = self.host["done"]
        out = []
        for slot, seats in humans_by_slot.items():
            if done[slot]:
                continue
            if not any(waiting[slot, pid - 1] for pid in seats
                       if 1 <= pid <= P):
                out.append(slot)
        return out


class _NativeRooms:
    """Native (C++) backend: one CppRoom of csrc/gamesim.cpp per slot,
    stepped on the host with no device dispatch; bit-identical to the
    torch backend (tests/test_torch_native.py). Policy bots decide on the
    host's device from the room's state sent there; search bots find the
    deciding seats on the host and send the room only to search it."""

    def __init__(self, lowered: Lowered, capacity: int = SLOTS_PER_GAME):
        from game_engine_tpu_torch.native import CppGame

        self.lowered = lowered
        self.game = CppGame(lowered)
        self.capacity = capacity
        self.free = list(range(capacity))
        self.rooms: dict[int, Any] = {}
        self.n_players: dict[int, int] = {}
        self.seeds: dict[int, int] = {}
        self.projectors: dict[int, Projector] = {}
        self.items: dict[int, list] = {}
        self.prev_dead: dict[int, list] = {}

    def alloc(self, n_players: int, seed: int) -> int:
        if not self.free:  # elastic pool, as _TorchSlots
            self.free.extend(range(self.capacity, self.capacity * 2))
            self.capacity *= 2
        slot = self.free.pop(0)
        self.rooms[slot] = self.game.room(n_players, seed)
        self.n_players[slot] = n_players
        self.seeds[slot] = int(seed) & 0xFFFFFFFF
        self.projectors[slot] = Projector(self.lowered.game)
        self.items[slot] = []
        self.prev_dead[slot] = []
        return slot

    def release(self, slot: int) -> None:
        self.free.append(slot)
        for d in (self.rooms, self.n_players, self.seeds, self.projectors,
                  self.items, self.prev_dead):
            d.pop(slot, None)

    def step_slot(self, slot: int, human_actions: dict[int, int],
                  include_bots: bool = True,
                  human_seats: tuple[int, ...] = (1,),
                  policy=None, policy_seats: tuple[int, ...] = ()) -> None:
        room = self.rooms[slot]
        actions = room.policy_actions() if include_bots else {}
        if include_bots and policy is not None and policy_seats:
            # the room's state read on the host: the same forward (PolicyBots,
            # on the bots' device) or search (SearchBots, whose rollout
            # streams the room seed feeds) as the torch backend
            pa = policy.native_actions(room.read(), self.n_players[slot],
                                       seed=self.seeds[slot])
            for pid in policy_seats:
                if pid in pa:
                    actions[pid] = pa[pid]
                else:
                    actions.pop(pid, None)
        for pid in human_seats:  # human exclusion
            actions.pop(pid, None)
        actions.update(human_actions)
        room.step(actions)

    def snapshot_state(self, slot: int) -> dict[str, Any]:
        """CppRoom.read() as JSON (the layout of _TorchSlots.snapshot_state,
        so journals cross backends and packages)."""
        r = self.rooms[slot].read()
        out = {k: (v.astype(int).tolist() if isinstance(v, np.ndarray) else v)
               for k, v in r.items() if k != "phase_id"}
        out["n"] = self.n_players[slot]
        out["seed"] = self.seeds[slot]
        return out

    def restore_state(self, slot: int, d: dict[str, Any]) -> None:
        self.rooms[slot].write(d)

    def snapshot_raw(self, slot: int, names) -> dict[str, Any]:
        from game_engine_tpu_torch.view.decode import decode_native

        return decode_native(self.lowered, self.rooms[slot].read(),
                             self.n_players[slot], names)

    def is_done(self, slot: int) -> bool:
        return bool(self.rooms[slot].read()["done"])

    def version(self, slot: int) -> int:
        return int(self.rooms[slot].read()["t"])

    def phase_index(self, slot: int) -> int:
        return int(self.rooms[slot].read()["phase_index"])

    def alive_ids(self, slot: int) -> list[int]:
        r = self.rooms[slot].read()
        n = self.n_players[slot]
        if self.lowered.alive_bool >= 0:
            return [p + 1 for p in range(n) if r["bools"][p, self.lowered.alive_bool]]
        return list(range(1, n + 1))

    def must_act_seats(self, slot: int, seats) -> list[int]:
        r = self.rooms[slot].read()
        phase = r["phase_index"]
        if r["done"] or not bool(self.lowered.phase_is_action[phase]):
            return []
        # targeted iff the phase's predicate holds for the seat's fields
        from game_engine_tpu_torch.gamespec.expr import eval_predicate
        from game_engine_tpu_torch.view.decode import decode_native

        snap = decode_native(self.lowered, r, self.n_players[slot])
        cp = self.lowered.game.phases[phase]
        return [
            pid for pid in seats
            if 1 <= pid <= self.n_players[slot]
            and not r["acted"][pid - 1]
            and eval_predicate(cp.target_pred, snap["player_states"][str(pid)])
        ]


class RoomGone(LookupError):
    """The room was ended between a caller's liveness check and the
    handler body (the global lock is released around slow sections)."""


class GameHost:
    """Rooms -> engine slots; human action queues; state/items projection."""

    # journal compaction period (step events between state snapshots); a
    # restore replays at most ~this many engine steps
    SNAP_EVERY = 256

    def __init__(self, games_path: Optional[str] = None, backend: str = "torch",
                 persist_dir: Optional[str] = None,
                 chat_lm: Optional[str] = None,
                 bot_ckpts: Optional[list[str]] = None,
                 chat_sample_temp: float = 0.0,
                 chat_complete=None,
                 bot_search: Optional[list[str]] = None,
                 search_rollouts: int = 32,
                 search_horizon: int = 200,
                 search_det: int = 0,
                 device=D.DEFAULT):
        """backend: 'torch' (the batched engine on `device`, the default) or
        'native' (the C++ per-room simulator on the host; the JAX package's
        default). 'jax' is the JAX package's own.
        device: the card ("cuda", the default; raises without one) unless
        the caller asks for the CPU; policy and search bots decide there on
        either backend.
        persist_dir: directory for per-room crash-recovery journals; None
        disables durability (tests, throwaway hosts).
        chat_lm: path to a policies/chat_lm.py checkpoint; bot chat then
        decodes on `device` (the decode kernel on the card) instead of
        using the template composer.
        chat_sample_temp: >0 enables the roleplay tier — smalltalk kinds
        (greeting/open chatter) decode with top-p/temperature sampling,
        deterministically seeded from the context (chat_lm.SAMPLE_KINDS);
        state-reporting kinds stay greedy.
        bot_ckpts: repeated 'game=path' (or bare 'path') policy checkpoint
        specs; matching games serve GREEDY learned-policy bots instead of
        the scripted uniform-legal policy (the reference's contextual LLM
        bots, agent/game_agent_v2.py:468-617), through K2 on the card.
        chat_complete: external chat model — completion function
        (prompt str -> reply str) serving free-form persona roleplay as
        the TOP responder tier (server/chat_llm.py; the reference's
        ChatBotNode gpt call, agent/game_agent_v2.py:385). Grounded
        verification and template fallback still apply host-side.
        bot_search: repeated game fragments ('' / 'all' matches every
        game); matching games serve flat Monte-Carlo LOOKAHEAD bots
        (policies/search.py: every legal choice rolled forward through the
        search kernel on the card, its plain version on the CPU).
        Precedence per game: the most specific fragment wins; a checkpoint
        beats search at equal specificity.
        search_rollouts/search_horizon: rollouts per candidate action and
        the per-rollout step cap. search_det: D>0 scores candidates over D
        hidden-state determinizations (information-set search)."""
        if backend not in ("torch", "native"):
            raise NotImplementedError(
                f"backend {backend!r}: the port serves backend='torch' or 'native' "
                "(the 'jax' backend is the JAX package's)")
        self._device = D.resolve(device)
        self._lock = threading.RLock()
        self._chat_lm_hook = None
        if chat_lm:
            from game_engine_tpu_torch.policies.chat_lm import make_lm_hook
            self._chat_lm_hook = make_lm_hook(
                chat_lm, sample_temp=chat_sample_temp, device=self._device)
        self._chat_ext = None
        if chat_complete is not None:
            from game_engine_tpu_torch.server.chat_llm import make_chat_llm_hook
            self._chat_ext = make_chat_llm_hook(chat_complete)
        self._bot_ckpts: dict = {}
        if bot_ckpts:
            from game_engine_tpu_torch.policies.serve import load_bot_policies
            self._bot_ckpts = load_bot_policies(bot_ckpts, self._device)
        # search-bot specs: game fragments, keyed like the checkpoints so
        # precedence can compare specificity
        self._bot_search: list[str] = [
            "" if s.strip().lower() in ("", "all") else s.strip().lower()
            for s in (bot_search or [])]
        self._search_rollouts = int(search_rollouts)
        self._search_horizon = int(search_horizon)
        self._search_det = int(search_det)
        # slots key -> PolicyBots | SearchBots | None
        self._policies: dict[str, Any] = {}
        self._policy_seats: dict[str, tuple[int, ...]] = {}  # per room
        self._backend = backend
        self._games_path = games_path or games_dir()
        self._spec_cache: dict[str, tuple[int, Any]] = {}  # path -> (mtime_ns, spec)
        self._persist_dir = persist_dir
        self._slots: dict[str, Any] = {}  # _TorchSlots or _NativeRooms
        self._rooms: dict[str, tuple[str, int]] = {}  # roomId -> (game, slot)
        self._queues: dict[str, dict[int, int]] = {}  # roomId -> {pid: choice}
        self._chats: dict[str, Any] = {}
        # per-room chat mutexes: chat replies compute their (possibly slow)
        # lm_hook decode OUTSIDE the global host lock; the room mutex keeps
        # per-room message/journal order deterministic
        self._chat_locks: dict[str, threading.Lock] = {}
        self._notes: dict[str, Any] = {}
        self._phase_history: dict[str, list] = {}
        self._humans: dict[str, tuple[int, ...]] = {}  # roomId -> human seats
        self._room_seed: dict[str, int] = {}
        self._names: dict[str, dict[int, str]] = {}
        # roomId -> {pid: {field: {key: text}}} free-text action content
        self._texts: dict[str, dict[int, dict[str, dict[str, str]]]] = {}
        self._text_rev: dict[str, int] = {}  # bumps invalidate _proj_cache
        # roomId -> ((engine t, text rev), deep-copied projected snapshot)
        self._proj_cache: dict[str, tuple[tuple[int, int], dict]] = {}
        self._journals: dict[str, Any] = {}
        self._journal_headers: dict[str, dict] = {}
        # per-room step count since the last journal compaction snapshot
        self._steps_since_snap: dict[str, int] = {}
        self._replaying = False
        self._replay_ts: Optional[float] = None
        self._seeds = 0

    # -- game catalog ----------------------------------------------------------

    def list_games(self) -> list[dict[str, Any]]:
        """Scan games/*.yaml (reference: src/app/api/games/route.ts:13-56).

        Parses ride the (path, mtime) spec cache: /api/rooms/create and
        /api/games hit this per request, and a cold re-parse of the whole
        catalog is ~600 ms — it was the dominant cost of room creation
        under load (utils/load_test.py)."""
        out = []
        for fn in sorted(os.listdir(self._games_path)):
            if not fn.endswith((".yaml", ".yml")):
                continue
            try:
                spec = self._load_spec_cached(
                    os.path.join(self._games_path, fn))
            except Exception:
                continue
            out.append(
                {
                    "name": spec.name,
                    "description": spec.declaration.description[:200],
                    "isMultiplayer": spec.declaration.is_multiplayer,
                    "minPlayers": spec.declaration.min_players,
                    "filename": fn,
                }
            )
        return out

    def _load_spec_cached(self, path: str):
        """Parse a catalog YAML, cached by (path, mtime) — the explain
        route resolves names per HTTP request and must not re-parse the
        whole catalog each click."""
        mtime = os.stat(path).st_mtime_ns
        hit = self._spec_cache.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
        spec = load_game_spec(path)
        self._spec_cache[path] = (mtime, spec)
        return spec

    def game_spec(self, game_name: str):
        """Resolve a catalog game by name against THIS host's games path:
        exact name wins, then substring fallback — ONE definition shared
        with room creation (_game_slots). Unparseable files are skipped
        (as in list_games) so one broken YAML can't block the rest.
        Raises KeyError when nothing matches."""
        fuzzy = None
        for fn in sorted(os.listdir(self._games_path)):
            if fn.endswith((".yaml", ".yml")):
                try:
                    s2 = self._load_spec_cached(
                        os.path.join(self._games_path, fn))
                except Exception:
                    continue
                if s2.name == game_name:
                    return s2
                if fuzzy is None and game_name.lower() in s2.name.lower():
                    fuzzy = s2
        if fuzzy is None:
            raise KeyError(f"unknown game {game_name!r}")
        return fuzzy

    def _game_slots(self, game_name: str, rounds_per_player: int = 1) -> _TorchSlots:
        key = f"{game_name}#r{rounds_per_player}"
        if key not in self._slots:
            # exact-name-wins + substring fallback, shared with the
            # explain route (one resolution definition, mtime-cached)
            spec = self.game_spec(game_name)
            # loud-or-correct on the SERVING path: /api/generate-dsl runs
            # the validator, but hand-dropped YAML reaches here directly —
            # a game with validator ERRORS (unattachable hints, broken
            # predicates, unreachable terminals) must fail room creation,
            # not play with silent no-op phases
            from game_engine_tpu_torch.dslgen.validate import errors, validate_spec

            errs = errors(validate_spec(spec))
            if errs:
                raise ValueError(
                    f"game {spec.name!r} failed validation: "
                    + "; ".join(str(e) for e in errs[:3]))
            lowered = lower(compile_game(spec, GameConfig(rounds_per_player=rounds_per_player)))
            if self._backend == "native":
                self._slots[key] = _NativeRooms(lowered)
            else:
                self._slots[key] = _TorchSlots(lowered, self._device)
            self._policies[key] = self._policy_for(game_name, lowered)
        return self._slots[key]

    def _policy_for(self, game_name: str, lowered):
        """Build the bot actor for a game: a greedy PolicyBots when a
        --bot-ckpt spec matches AND its parameter shapes fit the compiled
        game (checked by a plain dry forward, which launches no kernel — a
        mismatched checkpoint is skipped loudly, never served wrong; a
        kernel that fails later raises), or lookahead SearchBots when a
        --bot-search fragment matches. The most SPECIFIC matching fragment
        wins ('werewolf' beats ''); a checkpoint beats search at equal
        specificity, so `--bot-ckpt werewolf=… --bot-search all` serves the
        learned werewolf policy and search everywhere else."""
        name = game_name.lower()
        # (specificity, kind-rank, constructor) — kind-rank 0 = ckpt wins ties
        cands: list[tuple[int, int, Any]] = []
        for frag, (params, cfg, path) in self._bot_ckpts.items():
            if frag and frag not in name:
                continue

            def _mk_ckpt(params=params, cfg=cfg, path=path):
                from game_engine_tpu_torch.policies.serve import PolicyBots

                pb = PolicyBots(lowered, params, cfg, path)
                try:
                    pb.check_fits()
                except (ValueError, RuntimeError, KeyError, IndexError):
                    logging.getLogger(__name__).exception(
                        "bot checkpoint %s does not fit game %s; "
                        "trying the next bot tier", path, game_name)
                    return None
                return pb

            cands.append((len(frag), 0, _mk_ckpt))
        for frag in self._bot_search:
            if frag and frag not in name:
                continue

            def _mk_search():
                from game_engine_tpu_torch.policies.search import make_search_bots

                return make_search_bots(
                    lowered, rollouts=self._search_rollouts,
                    horizon=self._search_horizon, determinize=self._search_det,
                    device=self._device)

            cands.append((len(frag), 1, _mk_search))
        for _, _, mk in sorted(cands, key=lambda c: (-c[0], c[1])):
            actor = mk()
            if actor is not None:
                return actor
        return None

    # -- room lifecycle ---------------------------------------------------------

    def start_room(self, room_id: str, game_name: str, n_players: int,
                   seed: Optional[int] = None, rounds_per_player: int = 1,
                   human_seats: Optional[list[int]] = None,
                   player_names: Optional[dict[int, str]] = None,
                   policy_seats: Optional[list[int]] = None) -> str:
        with self._lock:
            key = f"{game_name}#r{rounds_per_player}"
            gs = self._game_slots(game_name, rounds_per_player)
            if not gs.free:
                # pool exhausted: first reclaim slots of finished rooms
                # (viewing a finished game is best-effort once capacity is
                # needed); if every slot holds a LIVE room, alloc() grows
                # the pool instead of failing — 64 slots is a warm start,
                # not a room cap
                for rid, (k, s) in list(self._rooms.items()):
                    if k == key and gs.is_done(s):
                        self.end_room(rid)
                        if gs.free:
                            break
            self._seeds += 1
            real_seed = seed if seed is not None else self._seeds
            slot = gs.alloc(n_players, real_seed)
            self._rooms[room_id] = (key, slot)
            self._queues[room_id] = {}
            from game_engine_tpu_torch.server.chat import ChatRoom
            from game_engine_tpu_torch.view.notes import NotesLog

            seats = tuple(sorted(human_seats)) if human_seats else (1,)
            self._humans[room_id] = seats
            # learned-policy bot seats: explicit list, or every bot seat
            # when a --bot-ckpt matches this game (per-seat scripted/learned
            # mix comes from passing a subset)
            policy = self._policies.get(key)
            if policy is None:
                pseats: tuple[int, ...] = ()
            elif policy_seats is not None:
                pseats = tuple(sorted(
                    p for p in policy_seats
                    if 1 <= p <= n_players and p not in seats))
            else:
                pseats = tuple(p for p in range(1, n_players + 1)
                               if p not in seats)
            self._policy_seats[room_id] = pseats
            self._room_seed[room_id] = int(real_seed)
            self._names[room_id] = dict(player_names or {})
            self._texts[room_id] = {}
            from game_engine_tpu_torch.gamespec import mechanics as _M
            from game_engine_tpu_torch.policies.net import field_visibility

            # the game's own information rules decide which fields the bot
            # responder answers truthfully vs guards (chat.py _field_answer).
            # Fields written by role assignment (night_action_eligible etc.)
            # are role-correlated, so chat guards them like the role itself
            # even where the observation contract treats them as public.
            chat_vis = dict(field_visibility(gs.lowered))
            for cp in gs.lowered.game.phases:
                for mech in cp.program.on_enter:
                    if isinstance(mech, _M.RoleAssign):
                        for _rname, settings in mech.role_fields:
                            for fname, _v in settings:
                                chat_vis[fname] = max(chat_vis.get(fname, 0), 1)
            from game_engine_tpu_torch.server.chat import phase_guide_from_spec

            self._chats[room_id] = ChatRoom(
                room_id, seed=real_seed, lm_hook=self._chat_lm_hook,
                visibility=chat_vis,
                phase_guide=phase_guide_from_spec(gs.lowered.game.spec))
            self._notes[room_id] = NotesLog()
            self._phase_history[room_id] = []
            ts0 = self._replay_ts if self._replay_ts is not None else time.time()
            self._open_journal(room_id, {
                "game": game_name, "n_players": n_players, "seed": real_seed,
                "rounds_per_player": rounds_per_player,
                "human_seats": list(seats),
                "names": {str(k): v for k, v in (player_names or {}).items()},
                "ts": ts0,
                # replay recomputes policy-bot actions deterministically
                # (greedy argmax); recording which checkpoint drove them
                # makes a mismatched restart detectable
                "policy_seats": list(pseats),
                "policy_ckpt": policy.ckpt_path if policy else None,
            })
            self._record_phase(room_id, gs, slot, ts=ts0)  # phase 0 entry
            return f"{game_name}:{slot}"

    def _open_journal(self, room_id: str, header: dict[str, Any]) -> None:
        if self._persist_dir is None or self._replaying:
            return
        from game_engine_tpu_torch.server.journal import RoomJournal

        j = RoomJournal(self._journal_path(room_id))
        j.create(header)
        self._journals[room_id] = j
        self._journal_headers[room_id] = dict(header)
        self._steps_since_snap[room_id] = 0

    def _journal_path(self, room_id: str) -> str:
        return os.path.join(self._persist_dir, f"{room_id}.jsonl")

    def _log_event(self, room_id: str, event: dict[str, Any]) -> None:
        if self._replaying:
            return
        j = self._journals.get(room_id)
        if j is not None:
            j.append(event)

    def _compact_journal(self, room_id: str) -> None:
        """Rewrite the room's journal as header + one full state snapshot:
        engine banks, chat, notes, free-text, phase history, projection
        state and pending action queue. Replay then resumes from the
        snapshot instead of re-running the whole game."""
        j = self._journals.get(room_id)
        header = self._journal_headers.get(room_id)
        if j is None or header is None:
            return
        slots_key, slot = self._rooms[room_id]
        gs = self._slots[slots_key]
        chat = self._chats[room_id]
        notes = self._notes[room_id]
        snap = {
            "e": "snap",
            "engine": gs.snapshot_state(slot),
            "chat": [m.to_json() for m in chat.messages],
            "notes": list(notes.notes),
            "notes_prev": notes._prev,
            "texts": {str(p): {str(f): dict(c) for f, c in fields.items()}
                      for p, fields in self._texts.get(room_id, {}).items()},
            "hist": list(self._phase_history.get(room_id, [])),
            "items": [i.to_json() for i in gs.items[slot]],
            "prev_dead": list(gs.prev_dead[slot]),
            "proj_counter": gs.projectors[slot]._counter,
            "queued": {str(k): int(v)
                       for k, v in self._queues.get(room_id, {}).items()},
        }
        j.rewrite(header, [snap])

    def _apply_snapshot(self, room_id: str, ev: dict[str, Any]) -> None:
        """Restore a room from a compaction snapshot (replay fast-path)."""
        import itertools

        from game_engine_tpu_torch.server.chat import ChatMessage
        from game_engine_tpu_torch.view.cards import Item

        slots_key, slot = self._rooms[room_id]
        gs = self._slots[slots_key]
        gs.restore_state(slot, ev["engine"])
        chat = self._chats[room_id]
        chat.messages = [ChatMessage(**m) for m in ev.get("chat", [])]
        mx = 0
        for m in chat.messages:
            try:
                mx = max(mx, int(m.id.rsplit("-", 1)[1]))
            except (ValueError, IndexError):
                pass
        chat._ids = itertools.count(mx + 1)
        notes = self._notes[room_id]
        notes.notes = list(ev.get("notes", []))
        notes._prev = ev.get("notes_prev")
        self._texts[room_id] = {
            int(p): {str(f): {str(k): str(v) for k, v in c.items()}
                     for f, c in fields.items()}
            for p, fields in (ev.get("texts") or {}).items()}
        self._phase_history[room_id] = list(ev.get("hist", []))
        gs.items[slot] = [Item(**d) for d in ev.get("items", [])]
        gs.prev_dead[slot] = list(ev.get("prev_dead", []))
        gs.projectors[slot]._counter = int(ev.get("proj_counter", 1000))
        self._queues[room_id] = {int(k): int(v)
                                 for k, v in (ev.get("queued") or {}).items()}

    def has_room(self, room_id: str) -> bool:
        with self._lock:
            return room_id in self._rooms

    def state_version(self, room_id: str) -> Optional[int]:
        """Cheap change detector for the SSE stream — no decode/projection.

        Combines the engine step counter with the chat length: chat posts
        don't step the engine, but other humans' clients must still be
        pushed (they fetch the chat log on every pushed render)."""
        with self._lock:
            entry = self._rooms.get(room_id)
            if entry is None:
                return None
            slots_key, slot = entry
            chat = self._chats.get(room_id)
            n_msgs = len(chat.messages) if chat else 0
            return (self._slots[slots_key].version(slot) << 20) | (n_msgs & 0xFFFFF)

    def end_room(self, room_id: str) -> None:
        with self._lock:
            slots_key, slot = self._rooms.pop(room_id, (None, None))
            self._queues.pop(room_id, None)
            self._chats.pop(room_id, None)
            self._chat_locks.pop(room_id, None)
            self._notes.pop(room_id, None)
            self._phase_history.pop(room_id, None)
            self._humans.pop(room_id, None)
            self._policy_seats.pop(room_id, None)
            self._room_seed.pop(room_id, None)
            self._names.pop(room_id, None)
            self._texts.pop(room_id, None)
            self._text_rev.pop(room_id, None)
            self._proj_cache.pop(room_id, None)
            self._journal_headers.pop(room_id, None)
            self._steps_since_snap.pop(room_id, None)
            j = self._journals.pop(room_id, None)
            if j is not None:
                j.delete()
            if slots_key is not None:
                self._slots[slots_key].release(slot)

    def restore_room(self, room_id: str) -> bool:
        """Replay a room's journal through the normal host paths, restoring
        engine state, chat, notes, free-text and phase history bit-identically
        (the reference analogue: LangGraph thread persistence + temp-rooms
        reload-on-read, src/lib/storage/memory.ts:48-127). Returns False when
        no (valid) journal exists."""
        if self._persist_dir is None:
            return False
        from game_engine_tpu_torch.server.journal import RoomJournal

        path = self._journal_path(room_id)
        loaded = RoomJournal.load(path)
        if loaded is None:
            return False
        header, events = loaded
        names = {int(k): v for k, v in (header.get("names") or {}).items()}
        with self._lock:
            self._replaying = True
            try:
                self._replay_ts = header.get("ts")
                self.start_room(
                    room_id, header["game"], int(header["n_players"]),
                    seed=int(header["seed"]),
                    rounds_per_player=int(header.get("rounds_per_player", 1)),
                    human_seats=[int(s) for s in header.get("human_seats", [1])],
                    player_names=names,
                    policy_seats=[int(s) for s in header["policy_seats"]]
                    if header.get("policy_seats") is not None else None,
                )
                # a restart with a different --bot-ckpt would recompute
                # DIFFERENT bot actions than the journal's steps produced —
                # refuse the replay rather than silently diverge
                want_ckpt = header.get("policy_ckpt")
                key = self._rooms[room_id][0]
                have = self._policies.get(key)
                have_ckpt = have.ckpt_path if have else None
                if header.get("policy_seats") and want_ckpt != have_ckpt:
                    raise ValueError(
                        f"journal was written with bot policy {want_ckpt!r} "
                        f"but the host serves {have_ckpt!r}")
                for ev in events:
                    kind = ev.get("e")
                    if kind == "step":
                        self._replay_ts = ev.get("ts")
                        q = {int(k): int(v) for k, v in (ev.get("a") or {}).items()}
                        self._step_once(room_id, q)
                    elif kind == "chat":
                        self._replay_ts = ev.get("ts")
                        self.post_chat(
                            room_id, int(ev["pid"]), str(ev["text"]), names,
                            replay_bot=ev.get("bot", GameHost._REPLAY_RECOMPUTE))
                    elif kind == "chat_reply":
                        # bot reply journaled as its own event (the trigger's
                        # "chat" event carries bot:None) so compaction between
                        # the two can never double-post either message
                        self._chats[room_id].post(
                            int(ev["pid"]), str(ev["name"]), str(ev["text"]),
                            visibility=str(ev.get("visibility", "public")),
                            target_audience=ev.get("audience"),
                            timestamp=ev.get("ts"))
                    elif kind == "text":
                        self._texts[room_id].setdefault(int(ev["pid"]), {})[
                            str(ev["field"])
                        ] = {str(k): str(v) for k, v in (ev.get("content") or {}).items()}
                        # live _store_text bumps the revision; replay must
                        # too, or a projection cached at this engine t keeps
                        # serving the pre-text overlay after restore
                        self._text_rev[room_id] = (
                            self._text_rev.get(room_id, 0) + 1)
                    elif kind == "snap":
                        self._apply_snapshot(room_id, ev)
            except Exception:
                # a corrupt mid-journal event must not leave a half-replayed
                # room registered (it would serve stale state instead of the
                # caller's clear 410); the journal file itself is preserved
                # as evidence (no RoomJournal is attached during replay)
                self._replaying = False
                self._replay_ts = None
                if room_id in self._rooms:
                    self.end_room(room_id)
                return False
            finally:
                self._replaying = False
                self._replay_ts = None
            # reattach the journal in append mode for new events
            j = RoomJournal(path)
            self._journals[room_id] = j
            self._journal_headers[room_id] = dict(header)
            self._steps_since_snap[room_id] = 0
            return True

    # -- chat ---------------------------------------------------------------------

    _REPLAY_RECOMPUTE = object()  # sentinel: journal predates reply recording

    def post_chat(self, room_id: str, player_id: int, text: str,
                  player_names: Optional[dict[int, str]] = None,
                  replay_bot: Any = _REPLAY_RECOMPUTE) -> list[dict[str, Any]]:
        """Append a chat message and generate the bot reply; returns the new
        messages (reference flow: page.tsx:321-351 -> ChatBotNode).

        ``replay_bot`` injects a journaled bot reply verbatim instead of
        recomputing it: restart recovery then never re-runs the responder
        (with ``--chat-lm`` that would be a full greedy decode per logged
        message) and cannot diverge if the operator restarts with a
        different checkpoint or no LM at all. The sentinel default keeps
        old journals (which carry no reply) on the recompute path."""
        with self._lock:
            chat_mutex = self._chat_locks.setdefault(room_id, threading.Lock())
        with chat_mutex:
            with self._lock:
                chat = self._chats.get(room_id)
                if chat is None or room_id not in self._rooms:
                    # ended between the caller's liveness check and here
                    # (the global lock is released around the chat mutex)
                    raise RoomGone(room_id)
                names = player_names or {}
                sender_name = names.get(player_id, f"Player {player_id}")
                # journal carries the wall clock so replay reproduces chat
                # timestamps exactly (the bot reply inherits the trigger's)
                ts = (self._replay_ts if self._replay_ts is not None
                      else time.time())
                msg = chat.post(player_id, sender_name, text, timestamp=ts)
                plan = None
                reply = None
                if replay_bot is GameHost._REPLAY_RECOMPUTE:
                    slots_key, slot = self._rooms[room_id]
                    gs = self._slots[slots_key]
                    # the PROJECTED snapshot: free-text submissions are
                    # overlaid (a raw snapshot still carries the engine's
                    # {"1": "submitted"} marker, so chat answers about
                    # statements/submitted fields would contradict the
                    # board every client renders)
                    snap = self._project_now(room_id, gs, slot, names)
                    # the history/advice intents ground on the notes log
                    # and the host's waiting set (chat.py _v2_extra);
                    # both are deterministic functions of engine state, so
                    # crash-recovery recompute replay stays bit-identical
                    self._attach_live_context(room_id, gs, slot, snap)
                    try:
                        plan = chat.plan_reply(player_id, sender_name, text,
                                               snap)
                        if plan is not None and self._chat_ext is not None:
                            # build the external tier's roleplay prompt
                            # under the SAME lock hold (it reads the live
                            # message list); the slow completion call runs
                            # unlocked below like the lm_hook decode
                            from game_engine_tpu_torch.server.chat_llm import (
                                roleplay_prompt,
                            )
                            plan["prompt"] = roleplay_prompt(
                                plan, snap,
                                [m.to_json()
                                 for m in chat.visible(plan["bot"])],
                                persona=plan.get("persona"),
                                visibility=chat.visibility,
                                game=slots_key.rsplit("#r", 1)[0])
                    except Exception:  # noqa: BLE001 — a responder crash must
                        # not lose the human's message from the journal:
                        # crash-recovery replay would silently diverge from
                        # the live ChatRoom. Journal bot: null, keep serving.
                        logging.getLogger(__name__).exception(
                            "chat responder failed; journaling trigger only")
                        plan = None
                elif replay_bot is not None:
                    reply = chat.post(
                        int(replay_bot["pid"]), str(replay_bot["name"]),
                        str(replay_bot["text"]),
                        visibility=str(replay_bot.get("visibility", "public")),
                        target_audience=replay_bot.get("audience"),
                        timestamp=ts,
                    )
                # Journal the trigger in the SAME lock hold as chat.post:
                # the lm decode below runs unlocked, and a concurrent step()
                # can compact the journal in that window — its snapshot
                # already contains the posted message, so a trigger event
                # appended after the snapshot would double-post on replay.
                # The bot reply is journaled as a separate follow-up event
                # ("chat_reply") under the second lock hold; a snapshot
                # taken between the two holds contains the trigger but not
                # the reply, and the chat_reply event replays exactly the
                # missing part.
                self._log_event(room_id, {
                    "e": "chat", "pid": player_id, "text": text, "ts": ts,
                    "bot": None,
                })
            # Model calls run OUTSIDE the global host lock — an external
            # completion round-trip or a full greedy decode (up to 128
            # sequential forwards with --chat-lm) must not block every
            # other room's HTTP requests. The per-room chat mutex keeps
            # this room's message order deterministic. Tier order:
            # external model > learned LM > template composer; a grounded
            # plan's reply is verified at each tier (grounded_reply_ok) —
            # an unfaithful external decode falls THROUGH to the learned
            # tier rather than straight to the template.
            lm_text = None
            from game_engine_tpu_torch.server.chat import (
                grounded_reply_ok,
                lm_may_serve,
            )
            if plan is not None and self._chat_ext is not None \
                    and plan.get("prompt"):
                try:
                    lm_text = self._chat_ext(plan["prompt"])
                except Exception:  # noqa: BLE001 — external models fail;
                    # the built-in tiers keep serving
                    logging.getLogger(__name__).exception(
                        "external chat model failed; falling through")
                    lm_text = None
                g = plan.get("grounded")
                if lm_text and g is not None \
                        and not grounded_reply_ok(lm_text, g):
                    lm_text = None
            if (lm_text is None and plan is not None
                    and chat.lm_hook is not None
                    and lm_may_serve(chat.lm_hook, plan)):
                try:
                    lm_text = chat.lm_hook(plan["context"])
                except Exception:  # noqa: BLE001 — fall back to the template
                    logging.getLogger(__name__).exception(
                        "chat lm_hook failed; using the template reply")
                    lm_text = None
            with self._lock:
                if plan is not None:
                    reply = chat.commit_reply(plan, lm_text)
                if reply is not None and replay_bot is GameHost._REPLAY_RECOMPUTE:
                    self._log_event(room_id, {
                        "e": "chat_reply", "pid": reply.playerId,
                        "name": reply.playerName, "text": reply.message,
                        "visibility": reply.visibility,
                        "audience": reply.target_audience,
                        "ts": reply.timestamp,
                    })
                out = [msg.to_json()]
                if reply is not None:
                    out.append(reply.to_json())
                return out

    def chat_messages(self, room_id: str, viewer_id: int) -> list[dict[str, Any]]:
        with self._lock:
            chat = self._chats.get(room_id)
            return [m.to_json() for m in chat.visible(viewer_id)] if chat else []

    def game_notes(self, room_id: str, n: int = 50) -> list[dict[str, Any]]:
        with self._lock:
            log = self._notes.get(room_id)
            return log.recent(n) if log else []

    # -- play -------------------------------------------------------------------

    def queue_action(self, room_id: str, player_id: int, choice: int,
                     text: Any = None) -> None:
        """Async human input (vote click, text submit, chat-driven action).

        Out-of-int32 choices become 0 (= no action) instead of overflowing
        the engine's int32 action arrays.

        ``text`` carries free-form content for SUBMIT phases (statements,
        written answers). The FSM records only the submit marker; the real
        text is stored host-side keyed by (player, odict field) and overlaid
        onto player_states in snapshots — matching the reference, where
        statements live in player_states and render on the statement board
        (reference: games/two-truths-and-a-lie.yaml:21-60 statements dict,
        src/app/page.tsx:2492-2507 promptUserText/createTextInputPanel)."""
        with self._lock:
            c = int(choice)
            if not (-(2**31) <= c < 2**31):
                c = 0
            self._queues.setdefault(room_id, {})[int(player_id)] = c
            if text is not None:
                self._store_text(room_id, int(player_id), text)

    def _store_text(self, room_id: str, player_id: int, text: Any) -> None:
        """Attach free-text content to the current phase's odict field."""
        slots_key, slot = self._rooms[room_id]
        gs = self._slots[slots_key]
        phase = gs.lowered.game.phases[gs.phase_index(slot)]
        field = phase.program.record.mark_odict
        if field is None:
            return  # not a text-submission phase; content has nowhere to land
        content = _normalize_text(text)
        if not content:
            return
        self._texts.setdefault(room_id, {}).setdefault(player_id, {})[field] = content
        self._text_rev[room_id] = self._text_rev.get(room_id, 0) + 1
        self._log_event(room_id, {"e": "text", "pid": player_id,
                                  "field": field, "content": content})

    def queue_vote(self, room_id: str, player_id: int, option_index: int) -> None:
        """Vote by option index (1-based position in the rendered panel).

        TARGET panels list alive players in id order, so option k maps to the
        k-th alive player; OPTION panels map straight through.
        """
        with self._lock:
            slots_key, slot = self._rooms[room_id]
            gs = self._slots[slots_key]
            kind = int(gs.lowered.choice_kind[gs.phase_index(slot)])
            if kind == ChoiceKind.TARGET.value:
                ids = gs.alive_ids(slot)
                choice = ids[option_index - 1] if 1 <= option_index <= len(ids) else 0
            else:
                choice = option_index
            self.queue_action(room_id, player_id, choice)

    def _step_once(self, room_id: str, q: dict[int, int]) -> None:
        """One engine step with the given merged human actions (journaled)."""
        slots_key, slot = self._rooms[room_id]
        gs = self._slots[slots_key]
        ts = self._replay_ts if self._replay_ts is not None else time.time()
        self._log_event(room_id, {"e": "step", "ts": ts,
                                  "a": {str(k): v for k, v in q.items()}})
        gs.step_slot(slot, q, human_seats=self._humans.get(room_id, (1,)),
                     policy=self._policies.get(slots_key),
                     policy_seats=self._policy_seats.get(room_id, ()))
        self._after_step(room_id, gs, slot, ts)

    def _after_step(self, room_id: str, gs, slot: int, ts: float) -> None:
        self._record_phase(room_id, gs, slot, ts=ts)
        # project every crossed phase: transient cards (role cards, death
        # markers, night overlays) and notes must reflect phases a
        # multi-step 'continue' jumps through, exactly as if a viewer had
        # watched each one
        self._project_now(room_id, gs, slot)
        # journal compaction: long-running rooms snapshot periodically so
        # both the file size and the restore cost stay O(SNAP_EVERY), not
        # O(room lifetime). AFTER projection: the snapshot must contain this
        # step's own items/notes.
        if not self._replaying and room_id in self._journals:
            c = self._steps_since_snap.get(room_id, 0) + 1
            if c >= self.SNAP_EVERY:
                self._compact_journal(room_id)
                c = 0
            self._steps_since_snap[room_id] = c

    def _step_batch(self, slots_key: str, primary_room: str,
                    q: dict[int, int]) -> None:
        """One batched engine dispatch advancing the primary room AND every
        other live room of the same game that is mid-bot-turn (not done, not
        waiting on a human, no queued input of its own). Rooms are
        independent along the batch axis, so each advanced room's state —
        and its journaled step event — is identical to a per-room step;
        amortizing the step across rooms is what makes a batched backend
        serve interactive load."""
        gs = self._slots[slots_key]
        _, primary_slot = self._rooms[primary_room]
        candidates = {
            s: self._humans.get(rid, (1,))
            for rid, (k, s) in self._rooms.items()
            if k == slots_key and rid != primary_room
            and not self._queues.get(rid)
        }
        eligible = set(gs.bot_turn_slots(candidates))
        rooms = [(primary_room, primary_slot)]
        rooms += [(rid, s) for rid, (k, s) in self._rooms.items()
                  if k == slots_key and s in eligible and rid != primary_room]
        ts = self._replay_ts if self._replay_ts is not None else time.time()
        for rid, _s in rooms:
            self._log_event(rid, {
                "e": "step", "ts": ts,
                "a": {str(k): v for k, v in (q if rid == primary_room else {}).items()},
            })
        gs.step_slots(
            [s for _r, s in rooms],
            {primary_slot: q},
            {s: self._humans.get(rid, (1,)) for rid, s in rooms},
            policy=self._policies.get(slots_key),
            policy_seats={s: self._policy_seats.get(rid, ())
                          for rid, s in rooms},
        )
        for rid, s in rooms:
            self._after_step(rid, gs, s, ts)

    def step(self, room_id: str) -> dict[str, Any]:
        """One game turn: merge queued human actions + bot policy, advance."""
        with self._lock:
            q = self._queues.get(room_id, {})
            self._queues[room_id] = {}
            self._step_once(room_id, q)
            return self.snapshot(room_id)

    def run_until_input_needed(self, room_id: str, max_steps: int = 4096) -> dict[str, Any]:
        """Advance until a human seat must act or the game ends — the
        'Continue' button semantics without manual clicking through bot-only
        phases. The engine guarantees progress on every non-human-gated step,
        so the loop always reaches a stop condition; max_steps is a pure
        safety bound and tripping it sets ``truncated`` in the snapshot so
        the client can re-invoke instead of mistaking it for 'your move'."""
        with self._lock:
            slots_key, slot = self._rooms[room_id]
            gs = self._slots[slots_key]
            seats = self._humans.get(room_id, (1,))
            truncated = True
            batched = isinstance(gs, _TorchSlots) and not self._replaying
            for _ in range(max_steps):
                q = self._queues.get(room_id, {})
                self._queues[room_id] = {}
                if batched:
                    self._step_batch(slots_key, room_id, q)
                else:
                    self._step_once(room_id, q)
                if gs.is_done(slot) or gs.must_act_seats(slot, seats):
                    truncated = False
                    break
            snap = self.snapshot(room_id)
            snap["truncated"] = truncated
            return snap

    def _record_phase(self, room_id: str, gs, slot: int,
                      ts: Optional[float] = None) -> None:
        """Lightweight phase_history tracking for phases crossed inside a
        multi-step 'continue' (reference: phase_history is appended on every
        PhaseNode transition, game_agent_v2.py:1206-1215)."""
        hist = self._phase_history.setdefault(room_id, [])
        cp = gs.lowered.game.phases[gs.phase_index(slot)]
        if not hist or hist[-1]["phase_id"] != cp.dsl_id:
            # during journal replay, use the original event's wall clock so
            # restored phase_history matches the pre-crash one exactly
            if ts is None:
                ts = self._replay_ts if self._replay_ts is not None else time.time()
            hist.append({"phase_id": cp.dsl_id, "phase_name": cp.name,
                         "timestamp": ts})

    # -- projection ---------------------------------------------------------------

    def _project_now(self, room_id: str, gs, slot: int,
                     player_names: Optional[dict[int, str]] = None) -> dict[str, Any]:
        """Decode + free-text overlay + notes diff + item projection.

        Called after EVERY engine step (not just at poll points) so items
        and game_notes reflect each crossed phase — transient cards like
        role cards, death markers and night overlays are created exactly as
        if a viewer had watched each phase; journal replay reproduces the
        same item/notes state.

        Results are cached per (engine t, text revision): the snapshot right
        after a step and the SSE/poll reads of unchanged state reuse the
        projection instead of re-decoding (deep-copied — callers mutate)."""
        import copy as _copy

        names = player_names or self._names.get(room_id)
        # cache key includes the names: API reads always pass the room's
        # name map, and a names-only gate would bypass the cache on every
        # poll/SSE push — re-running the projector per read churns item
        # ids and (for phases without clearCanvas) accumulates duplicate
        # items, breaking bit-identical replay of the items state
        ver = (gs.version(slot), self._text_rev.get(room_id, 0),
               tuple(sorted((names or {}).items())))
        cached = self._proj_cache.get(room_id)
        if cached is not None and cached[0] == ver:
            return _copy.deepcopy(cached[1])
        snap = gs.snapshot_raw(slot, names)
        # free-text overlay: submitted content replaces the FSM's odict
        # markers (content is cosmetic to the engine; see queue_action);
        # bots, which type nothing, get deterministic seeded stand-ins
        seats = self._humans.get(room_id, (1,))
        texts = self._texts.get(room_id, {})
        decl = {f.name: f for f in gs.lowered.game.spec.declaration.fields}
        for pid_str, row in snap["player_states"].items():
            pid = int(pid_str)
            for field in list(row):
                if row[field] != {"1": "submitted"}:
                    continue  # not an engine submit marker
                stored = texts.get(pid, {}).get(field)
                if stored is not None:
                    row[field] = dict(stored)
                elif pid not in seats:
                    f = decl.get(field)
                    row[field] = _bot_submission(
                        self._room_seed.get(room_id, 0), pid, field,
                        f.example if f else None,
                    )
        log = self._notes.get(room_id)
        if log is not None:
            log.observe(snap)
        proj = gs.projectors[slot]
        gs.items[slot] = proj.project(
            snap, prev_items=gs.items[slot], prev_dead=gs.prev_dead[slot]
        )
        gs.prev_dead[slot] = list(snap.get("deadPlayers", []))
        self._proj_cache[room_id] = (ver, _copy.deepcopy(snap))
        return snap

    def _attach_live_context(self, room_id: str, gs, slot,
                             snap: dict[str, Any]) -> None:
        """game_notes + waiting_on on a projected snap — ONE definition
        shared by the client-facing snapshot and the chat responder's
        view (the v2 intents quote exactly these; two hand-maintained
        copies would silently diverge)."""
        log = self._notes.get(room_id)
        if log is not None:
            snap["game_notes"] = log.recent(10)
        seats = self._humans.get(room_id, (1,))
        snap["human_seats"] = list(seats)
        snap["waiting_on"] = (
            [] if gs.is_done(slot) else gs.must_act_seats(slot, seats)
        )

    def snapshot(self, room_id: str, player_names: Optional[dict[int, str]] = None) -> dict[str, Any]:
        with self._lock:
            slots_key, slot = self._rooms[room_id]
            gs = self._slots[slots_key]
            snap = self._project_now(room_id, gs, slot, player_names)
            snap["roomId"] = room_id
            self._attach_live_context(room_id, gs, slot, snap)
            # phase_history entries {phase_id, phase_name, timestamp}
            # (reference: agent/game_agent_v2.py:1206-1215)
            self._record_phase(room_id, gs, slot)
            snap["phase_history"] = list(self._phase_history.get(room_id, []))
            snap["items"] = [i.to_json() for i in gs.items[slot]]
            snap["itemsCreated"] = len(snap["items"])
            snap["lastAction"] = (
                snap["game_notes"][-1]["text"] if snap.get("game_notes") else ""
            )
            return snap

    def visible_state(self, room_id: str, viewer_id: int,
                      player_names: Optional[dict[int, str]] = None,
                      mask_private: bool = True) -> dict[str, Any]:
        """AgentState filtered for one viewer: items by the audience gate,
        and (an upgrade over the reference, which syncs full player_states
        to every client) private fields masked by the game's information
        rules — hidden roles stay hidden from the other seats."""
        from game_engine_tpu_torch.view.cards import visible_to, Item

        snap = self.snapshot(room_id, player_names)
        snap["items"] = [
            it for it in snap["items"]
            if visible_to(Item(id=it["id"], type=it["type"], name=it["name"],
                               subtitle=it.get("subtitle", ""), data=it["data"]),
                          str(viewer_id))
        ]
        if mask_private:
            from game_engine_tpu_torch.policies.net import (
                VIS_SELF,
                VIS_TEAM,
                field_visibility,
                minority_team_code,
            )

            slots_key, slot = self._rooms[room_id]
            lowered = self._slots[slots_key].lowered
            vis = field_visibility(lowered)
            code = minority_team_code(lowered)
            team_slot = lowered.game.layout.get("team")
            minority = team_slot.decode(code) if (code is not None and team_slot) else None
            players = snap.get("player_states", {})
            my_team = players.get(str(viewer_id), {}).get("team")
            for pid, row in players.items():
                if pid == str(viewer_id):
                    continue
                # only the coordinating minority team sees its teammates
                coordinated = (
                    bool(my_team) and row.get("team") == my_team and my_team == minority
                )
                for field, v in vis.items():
                    if field not in row:
                        continue
                    if v == VIS_SELF or (v == VIS_TEAM and not coordinated):
                        row[field] = None
        return snap
