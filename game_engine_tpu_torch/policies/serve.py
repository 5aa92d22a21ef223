"""Serve trained policies as in-room bots (--bot-ckpt).

Counterpart of game_engine_tpu/policies/serve.py. Loads a policies/net.py
checkpoint and exposes GREEDY (argmax) action selection — deterministic
given the room state, so journal replay reproduces policy-bot rooms
bit-identically on the route that wrote the journal.

The forward is chosen once, when the bots are built:

  fused   ``fused.make_apply`` under ``torch.inference_mode()`` for a
          net of an arch the kernels cover: the policy-forward kernel (K2)
          on CUDA tensors, where a net past K2's seat, action or depth
          bounds raises; its plain version (``fused_forward_plain``) on
          CPU tensors, for nets within those bounds.
  plain   ``net.apply_net``, for every other net (mlp, multi-head attn).

The choice is logged once and never changes afterwards: a K2 that fails to
build or launch raises, it does not fall back to the plain forward. K2 and
the plain version can differ by one bf16 step in a logit, so a journal with
policy seats replays exactly on the route that wrote it; across routes the
actions agree wherever the top-two legal logits are clearly apart.

Checkpoints load through ``net.load_policy``, which infers the net config
(arch / hidden / heads) from the parameter shapes, so a bare
``--bot-ckpt werewolf=path.npz`` needs no extra flags.

On the native backend (server/manager.py ``_NativeRooms``) a room's
``CppRoom.read()`` becomes a one-room GameState on the bots' device
(``state_from_read``), so the same forward, K2 on the card, decides.
"""

from __future__ import annotations

import json
import logging
from typing import Any

import numpy as np
import torch

from game_engine_tpu_torch import device as D
from game_engine_tpu_torch.core.state import _DTYPES, GameState, init_state
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.policies import fused as FZ
from game_engine_tpu_torch.policies import net as N

_log = logging.getLogger(__name__)


def forward_route(lowered: Lowered, cfg: N.NetConfig, device) -> str:
    """Which forward PolicyBots runs for this net on `device`: K2
    ("tensor_core") on the card, "fused_plain" (K2's plain version) on the
    CPU, or "apply_net" for nets of an arch K2 does not cover. On the card
    a net past K2's bounds raises (fused.runs_on_card)."""
    if torch.device(device).type == "cuda":
        return "tensor_core" if FZ.runs_on_card(lowered, cfg, device) else "apply_net"
    return "fused_plain" if FZ.supports(lowered, cfg) else "apply_net"


class PolicyBots:
    """Greedy policy actor bound to one compiled game and one device (the
    device of its parameters)."""

    def __init__(self, lowered: Lowered, params: dict[str, Any],
                 cfg: N.NetConfig, ckpt_path: str = ""):
        self.lowered = lowered
        self.params = params
        self.cfg = cfg
        self.ckpt_path = ckpt_path
        self.device = next(iter(params.values())).device
        self.route = forward_route(lowered, cfg, self.device)
        if self.route == "apply_net":
            self._forward = lambda obs: N.apply_net(params, obs, cfg, lowered)
        else:
            apply = FZ.make_apply(lowered, cfg)
            self._forward = lambda obs: apply(params, obs)
        _log.info("%s", json.dumps({"event": "bot_policy", "ckpt": ckpt_path,
                                    "game": lowered.game.spec.name, "arch": cfg.arch,
                                    "hidden": cfg.hidden, "forward": self.route}))

    def check_fits(self) -> None:
        """Raise ValueError (or the forward's shape error) when the
        checkpoint does not fit the game: a plain forward over one fresh
        room must give (1, P, A) logits, and a net K2 covers must have
        exactly K2's parameter shapes. Launches no kernel."""
        lw = self.lowered
        st = init_state(lw, 1, min(4, lw.P), 0, device=self.device)
        with torch.inference_mode():
            logits, _ = N.apply_net(self.params, N.observe(lw, st), self.cfg, lw)
        want = (1, lw.P, N.action_space(lw))
        if tuple(logits.shape) != want:
            raise ValueError(f"logits {tuple(logits.shape)}, the game needs {want}")
        if self.route != "apply_net":
            for name, shape in FZ._param_shapes(FZ.dims_for(lw, self.cfg)).items():
                if tuple(self.params[name].shape) != shape:
                    raise ValueError(f"param {name} has shape "
                                     f"{tuple(self.params[name].shape)}, K2 needs {shape}")

    def _logits(self, state: GameState) -> tuple[torch.Tensor, torch.Tensor]:
        """((B, P, A) f32 logits, (B, P, A) legal mask): the observation and
        the mask in one OB launch on the card."""
        obs, mask, _ = N.observe_all(self.lowered, state, actor=False)
        return self._forward(obs)[0], mask

    def masked_logits(self, state: GameState) -> tuple[torch.Tensor, torch.Tensor]:
        """((B, P, A) f32 logits with illegal choices at -1e9, (B, P, A)
        legal mask)."""
        with torch.inference_mode():
            logits, mask = self._logits(state)
            return torch.where(mask, logits, torch.tensor(-1e9, dtype=logits.dtype,
                                                          device=logits.device)), mask

    def greedy(self, state: GameState) -> torch.Tensor:
        """(B, P) int32 greedy choices on the state's device: argmax over the
        legal-masked logits, 0 where the phase offers no legal choice.
        Deterministic — ties resolve to the lowest action index (the first
        maximum, as jnp.argmax), so replay is exact. On the card the argmax
        is SA's greedy mode (one launch); on the CPU first_argmax."""
        if state.present.device.type == "cuda":
            from game_engine_tpu_torch.policies import obs_kernel as OK

            with torch.inference_mode():
                logits, mask = self._logits(state)
                return OK.kernel_sample(logits, mask, actor=state.present, mode="greedy")[1]
        logits, mask = self.masked_logits(state)
        a = first_argmax(logits).to(torch.int32) + 1
        return torch.where(mask.any(-1) & state.present, a, 0)

    def actions(self, state: GameState):
        """(B, P) int32 numpy actions for a batched GameState."""
        return self.greedy(state).cpu().numpy()

    # -- native backend bridge ------------------------------------------------

    def state_from_native(self, read: dict[str, Any], n_players: int,
                          seed: int = 0) -> GameState:
        """One-room GameState on the bots' device from CppRoom.read()."""
        return state_from_read(self.lowered, read, n_players, seed, self.device)

    def native_actions(self, read: dict[str, Any], n_players: int,
                       seed: int = 0) -> dict[int, int]:
        """{pid: choice} for one native room (0-emissions dropped). The
        seed rides into GameState for interface parity with SearchBots —
        the greedy forward itself never reads it."""
        acts = self.actions(self.state_from_native(read, n_players, seed))[0]
        return {p + 1: int(acts[p]) for p in range(len(acts)) if acts[p] != 0}


def state_from_read(lowered: Lowered, read: dict[str, Any], n_players: int,
                    seed: int, device) -> GameState:
    """A one-room GameState on `device` from a CppRoom.read() state dict
    (the arrays the batched engine would hold for that room)."""
    present = np.arange(lowered.P) < n_players
    one = {
        "bools": np.asarray(read["bools"]).astype(bool), "nums": read["nums"],
        "strs": read["strs"], "pdict": read["pdict"], "odict": read["odict"],
        "present": present, "phase": read["phase_index"], "prev_phase": read["prev_index"],
        "acted": np.asarray(read["acted"]).astype(bool), "choice": read["choice"],
        "choice_phase": read["choice_phase"], "done": bool(read["done"]),
        "winner": read["winner"], "t": read["t"], "seed": int(seed) & 0xFFFFFFFF,
    }
    return GameState(**{
        name: torch.as_tensor(np.asarray(one[name], np.int64)[None], device=device).to(
            _DTYPES[name]) for name in GameState._fields})


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (torch.argmax does not
    promise which maximum it returns on every device)."""
    hit = x == x.max(-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    return torch.where(hit, idx, x.shape[-1]).min(-1).values


def load_bot_policies(specs: list[str], device=D.DEFAULT
                      ) -> dict[str, tuple[dict, N.NetConfig, str]]:
    """Parse repeated --bot-ckpt 'game=path' (or bare 'path', matching every
    game) into {game_fragment: (params, cfg, path)}, the parameters loaded
    once, as new tensors, on `device`."""
    out: dict[str, tuple[dict, N.NetConfig, str]] = {}
    for spec in specs or []:
        if "=" in spec:
            game, path = spec.split("=", 1)
        else:
            game, path = "", spec
        params, cfg = N.load_policy(path, device)
        out[game.strip().lower()] = (params, cfg, path)
    return out
