"""ctypes bindings of the native per-room simulator (csrc/gamesim.cpp).

Counterpart of game_engine_tpu/native/lib.py with the same classes and
methods. The library is the port's own copy of gamesim.cpp, built by
``_build.gamesim_lib`` into build/kernels/ (named by a hash of csrc/, written
to a per-process temporary file under the build lock). A failed build raises
with the compiler's output; ``available`` answers whether it builds.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional

import numpy as np

from game_engine_tpu_torch import _build
from game_engine_tpu_torch.native.pack import pack


def _lib() -> ctypes.CDLL:
    return _build.gamesim_lib()


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def available() -> bool:
    """Whether the simulator builds and loads here (API parity with the JAX
    package; the port's users get the build's error from CppGame instead)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


class CppGame:
    """A compiled game loaded into the native simulator."""

    def __init__(self, lowered):
        self._lib = lib = _lib()  # held for __del__, which may run at interpreter exit
        self.lowered = lowered
        self._blob = np.ascontiguousarray(pack(lowered), np.int32)
        self._h = lib.gs_create(_ptr(self._blob), len(self._blob))
        if not self._h:
            raise RuntimeError("gs_create rejected blob")
        self.state_size = lib.gs_state_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gs_destroy(self._h)
            self._h = None

    def room(self, n_players: int, seed: int) -> "CppRoom":
        return CppRoom(self, n_players, seed)

    def selfplay(self, rooms: int, n_players: int, seed0: int, steps: int) -> int:
        """Scripted self-play over many rooms; returns completed episodes."""
        return int(_lib().gs_selfplay(self._h, rooms, n_players, seed0 & 0xFFFFFFFF, steps))


class CppRoom:
    """One native room with the same step/read semantics as the oracle."""

    def __init__(self, game: CppGame, n_players: int, seed: int):
        self.game = game
        self.n = n_players
        self._lib = game._lib
        self._h = self._lib.gs_room_new(game._h, n_players, seed & 0xFFFFFFFF)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gs_room_destroy(self._h)
            self._h = None

    def step(self, actions: Optional[dict[int, int]] = None) -> None:
        P = self.game.lowered.P
        buf = np.zeros(P, np.int32)
        for pid, c in (actions or {}).items():
            if 1 <= pid <= P:
                buf[pid - 1] = int(c)
        _lib().gs_room_step(self._h, _ptr(buf))

    def search(self, pid: int, rollouts: int, max_steps: int, mode: int,
               team_slot: int, team_codes: "list[int] | tuple[int, ...]",
               salt: int) -> int:
        """Flat Monte-Carlo lookahead for one seat (gs_room_search); returns
        the chosen 1-based action or 0 when this seat has no decision /
        the game has no searchable terminal reward."""
        codes = np.asarray(team_codes or [0], np.int32)
        return int(_lib().gs_room_search(self._h, pid, rollouts, max_steps, mode, team_slot,
                                         _ptr(codes), len(codes), salt & 0xFFFFFFFF))

    def search_scores(self, pid: int, rollouts: int, max_steps: int,
                      mode: int, team_slot: int,
                      team_codes: "list[int] | tuple[int, ...]",
                      salt: int, cap: int = 1024) -> Optional[dict[int, int]]:
        """Per-candidate rollout score totals for one seat
        (gs_room_search_scores). Returns {candidate: total}, {1: 0} for a
        forced submit, or None when this seat has no decision. argmax over
        the dict in ascending candidate order reproduces search() exactly."""
        codes = np.asarray(team_codes or [0], np.int32)
        cands = np.zeros(cap, np.int32)
        scores = np.zeros(cap, np.int64)
        n = int(_lib().gs_room_search_scores(
            self._h, pid, rollouts, max_steps, mode, team_slot, _ptr(codes), len(codes),
            salt & 0xFFFFFFFF, _ptr(cands), _ptr(scores), cap))
        if n < 0:
            return {1: 0}
        if n == 0:
            return None
        return {int(cands[j]): int(scores[j]) for j in range(n)}

    def policy_actions(self) -> dict[int, int]:
        P = self.game.lowered.P
        buf = np.zeros(P, np.int32)
        _lib().gs_room_policy(self._h, _ptr(buf))
        return {p + 1: int(buf[p]) for p in range(P) if buf[p] != 0}

    def write(self, state: dict[str, Any]) -> None:
        """Inverse of read(): restore the room from a serialized state dict
        (journal-compaction snapshots)."""
        buf = np.concatenate([
            np.asarray([state["phase_index"], int(state["done"]),
                        state["winner"], state["prev_index"], state["t"]], np.int32),
            *(np.asarray(state[k], np.int32).reshape(-1)
              for k in ("bools", "nums", "strs", "pdict", "odict", "acted", "choice",
                        "choice_phase")),
        ])
        if len(buf) != self.game.state_size:
            raise ValueError(f"state has {len(buf)} words, the room {self.game.state_size}")
        _lib().gs_room_write(self._h, _ptr(buf))

    def read(self) -> dict[str, Any]:
        lw = self.game.lowered
        P = lw.P
        lay = lw.game.layout
        buf = np.zeros(self.game.state_size, np.int32)
        _lib().gs_room_read(self._h, _ptr(buf))
        k = 5
        NB, NN, NS = lay.n_bool, lay.n_num, lay.n_str
        NPD, NOD = lay.n_pdict, lay.n_odict
        out = {
            "phase_index": int(buf[0]),
            "phase_id": int(lw.phase_dsl_id[buf[0]]),
            "done": bool(buf[1]),
            "winner": int(buf[2]),
            "prev_index": int(buf[3]),
            "t": int(buf[4]),
        }
        out["bools"] = buf[k : k + P * NB].reshape(P, NB).astype(bool); k += P * NB
        out["nums"] = buf[k : k + P * NN].reshape(P, NN); k += P * NN
        out["strs"] = buf[k : k + P * NS].reshape(P, NS); k += P * NS
        out["pdict"] = buf[k : k + P * NPD * P].reshape(P, NPD, P); k += P * NPD * P
        out["odict"] = buf[k : k + P * NOD].reshape(P, NOD); k += P * NOD
        out["acted"] = buf[k : k + P].astype(bool); k += P
        out["choice"] = buf[k : k + P]; k += P
        out["choice_phase"] = buf[k : k + P]
        return out
