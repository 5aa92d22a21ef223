"""Checkpoint / resume + deterministic replay.

Counterpart of game_engine_tpu/utils/checkpoint.py, with the same files on
disk, so a checkpoint or an action log written by either package loads in
the other:

  * ``save_state``/``load_state`` — a GameState as npz, one array per field,
    step-indexed. The seed is int64 in the port and uint32 on disk.
  * ``save_tree``/``load_tree`` — a flat dict of parameters in the JAX
    package's save_tree layout (``net.save_policy`` / ``net.load_policy``).
  * ``ActionLog`` + ``replay`` — deterministic recovery from
    (seed, DSL, action log): the engine is a pure function of
    (state, actions), so re-running the logged actions from init
    reproduces any state bit-exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.core.state import GameState, state_from_numpy, state_to_numpy
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.policies import net as N


def save_state(path: str, state: GameState, step: Optional[int] = None) -> str:
    """Write a GameState checkpoint; returns the final path."""
    if step is not None:
        base, ext = os.path.splitext(path)
        path = f"{base}_step{step}{ext or '.npz'}"
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **state_to_numpy(state))
    os.replace(tmp, path)
    return path


def load_state(path: str, device=D.DEFAULT) -> GameState:
    """A GameState checkpoint on `device` (the card unless the caller asks
    for the CPU)."""
    with np.load(path) as z:
        return state_from_numpy({f: z[f] for f in GameState._fields}, device)


def save_tree(path: str, tree: dict, meta: dict | None = None) -> None:
    """Checkpoint a flat dict of tensors as npz + .tree.json (the sidecar
    named from the stem, as the JAX package names it); ``meta`` rides in the
    sidecar (e.g. the attn head count)."""
    N.save_policy(path, tree, meta)


def load_tree(path: str, like: Optional[dict] = None, device=D.DEFAULT) -> dict:
    """Restore a dict saved by save_tree (or the JAX package's save_tree of
    a flat dict) on `device`. ``like``, when given, must have the same keys."""
    params, _ = N.load_policy(path, device)
    if like is not None and sorted(like) != sorted(params):
        raise ValueError(f"checkpoint {path} holds {sorted(params)}, not {sorted(like)}")
    return params


# ---------------------------------------------------------------------------
# Action log + replay
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ActionLog:
    """Sparse per-step action record for deterministic replay."""

    game_name: str
    batch: int
    n_players: list[int]
    seeds: list[int]
    # steps[t] = {"b,p": choice} sparse nonzero actions
    steps: list[dict[str, int]] = dataclasses.field(default_factory=list)

    def record(self, actions) -> None:
        if isinstance(actions, torch.Tensor):
            actions = actions.cpu().numpy()
        nz = {}
        bs, ps = np.nonzero(actions)
        for b, p in zip(bs.tolist(), ps.tolist()):
            nz[f"{b},{p}"] = int(actions[b, p])
        self.steps.append(nz)

    def actions_at(self, t: int, P: int) -> np.ndarray:
        a = np.zeros((self.batch, P), np.int32)
        for key, c in self.steps[t].items():
            b, p = key.split(",")
            a[int(b), int(p)] = c
        return a

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "ActionLog":
        with open(path, "r", encoding="utf-8") as f:
            return cls(**json.load(f))


def replay(lowered: Lowered, log: ActionLog, until: Optional[int] = None,
           device=D.DEFAULT) -> GameState:
    """Re-run a logged run from init on `device`; bit-identical by purity."""
    from game_engine_tpu_torch.core.engine import BatchedEngine

    eng = BatchedEngine(lowered, device)
    state = eng.init(log.batch, np.asarray(log.n_players, np.int32),
                     np.asarray(log.seeds, np.int64))
    T = len(log.steps) if until is None else min(until, len(log.steps))
    for t in range(T):
        state = eng.step(state, log.actions_at(t, lowered.P))
    return state
