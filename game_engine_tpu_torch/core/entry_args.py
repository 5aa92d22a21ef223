"""Host-side argument checks shared by the hand-written entries that take a
GameState: ST (core/step_kernel.py) and OB and SA (policies/obs_kernel.py).
Each raises on bad input; none copies a tensor that is already contiguous."""

from __future__ import annotations

import ctypes

import torch

from game_engine_tpu_torch.core.rollout_kernel import check_state
from game_engine_tpu_torch.core.state import GameState
from game_engine_tpu_torch.gamespec.tables import Lowered

_ADDRESSES = ctypes.c_int64 * len(GameState._fields)


def checked_state(lowered: Lowered, state: GameState, kind: str, what: str) -> GameState:
    """The state, each field contiguous, once it is checked to lie on a
    device of `kind` with the GameState dtypes and this game's shapes."""
    device = state.present.device
    if device.type != kind:
        raise ValueError(f"{what} takes {'CUDA' if kind == 'cuda' else 'CPU'} tensors, "
                         f"got {device}")
    check_state(lowered, state)
    return GameState(*(t.contiguous() for t in state))


def rooms_arg(x: torch.Tensor, name: str, shape: tuple, dtype, device) -> torch.Tensor:
    """`x` made contiguous once it is checked to be a `shape` `dtype` tensor
    on `device`."""
    if not isinstance(x, torch.Tensor) or x.device != device or x.dtype != dtype \
            or tuple(x.shape) != shape:
        got = (f"{tuple(x.shape)} {x.dtype} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise ValueError(f"{name} must be {shape} {dtype} on {device}, got {got}")
    return x.contiguous()


def state_addresses(state: GameState):
    """The state's field addresses in GameState's order, as the entries'
    int64 array."""
    return _ADDRESSES(*(t.data_ptr() for t in state))
