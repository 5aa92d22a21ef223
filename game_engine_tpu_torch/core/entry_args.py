"""Host-side helpers shared by the hand-written entries that take a
GameState: ST (core/step_kernel.py) and OB and SA (policies/obs_kernel.py):
the argument checks, which raise on bad input and copy no tensor that is
already contiguous; a new state's allocation; the card guard and stream of
a launch. Each entry's host time is its caller's, a turn at a time, so each
does its work once per call with what it can cache per game, batch and
card."""

from __future__ import annotations

import contextlib
import ctypes
import weakref

import torch

from game_engine_tpu_torch.core.rollout_kernel import check_state
from game_engine_tpu_torch.core.state import _DTYPES, GameState
from game_engine_tpu_torch.gamespec.tables import Lowered

_ADDRESSES = ctypes.c_int64 * len(GameState._fields)
_ALIGN = 16  # bytes between fields of a new state's buffer


def _field_shapes(lowered: Lowered, batch: int) -> tuple:
    """Each field's shape for `batch` rooms of the game (check_state's)."""
    lay = lowered.game.layout
    B, P = batch, lowered.P
    return ((B, P, lay.n_bool), (B, P, lay.n_num), (B, P, lay.n_str),
            (B, P, max(1, lay.n_pdict), P), (B, P, max(1, lay.n_odict)), (B, P), (B,), (B,),
            (B, P), (B, P), (B, P), (B,), (B,), (B,), (B,))


def _spec(lowered: Lowered, batch: int) -> tuple:
    """((dtype, shape) of each field, the new-state buffer's plan), cached on
    the Lowered per batch: a field's byte offset in one buffer, aligned."""
    cache = lowered.__dict__.setdefault("_torch_state_spec", {})
    if batch not in cache:
        fields, plan, at = [], [], 0
        for name, shape in zip(GameState._fields, _field_shapes(lowered, batch)):
            dtype = _DTYPES[name]
            size = torch.empty((), dtype=dtype).element_size()
            n = 1
            for d in shape:
                n *= d
            fields.append((dtype, torch.Size(shape)))
            plan.append((dtype, shape, torch.empty(shape, device="meta").stride(), at // size))
            at += (n * size + _ALIGN - 1) // _ALIGN * _ALIGN
        cache[batch] = (tuple(fields), tuple(plan), max(at, _ALIGN))
    return cache[batch]


# The states last checked (or made here) for a game, by the address of
# their `present` tensor: weak references to the game and the fields, and
# the fields' addresses. A field's dtype, shape and storage change only by
# resize_ or set_, which nothing here does, so a state whose fields are
# still the same tensors needs no second check; an unroll's step takes the
# state the last one gave. Weak references hold no memory of the card; the
# least recently used entry is dropped.
_KNOWN: dict = {}
_KNOWN_MAX = 8


def _known(lowered: Lowered, state: GameState, kind: str):
    key = (id(state.present), id(lowered), kind)
    got = _KNOWN.pop(key, None)
    if got is None or got[0]() is not lowered or \
            not all(r() is t for r, t in zip(got[1], state)):
        return None
    _KNOWN[key] = got
    return got


def remember_state(lowered: Lowered, state: GameState, kind: str) -> GameState:
    """Mark `state` (contiguous, of the game's shapes, on a device of `kind`:
    an entry's own output) as checked, with its addresses."""
    _KNOWN[(id(state.present), id(lowered), kind)] = (
        weakref.ref(lowered), tuple(weakref.ref(t) for t in state), _addresses(state))
    while len(_KNOWN) > _KNOWN_MAX:
        del _KNOWN[next(iter(_KNOWN))]
    return state


def checked_state(lowered: Lowered, state: GameState, kind: str, what: str) -> GameState:
    """The state, each field contiguous, once it is checked to lie on a
    device of `kind` with the GameState dtypes and this game's shapes: one
    pass over the fields against shapes cached per batch (on a mismatch
    check_state names the field), and none for a state checked or made
    here a call before."""
    if _known(lowered, state, kind) is not None:
        return state
    device = state.present.device
    if device.type != kind:
        raise ValueError(f"{what} takes {'CUDA' if kind == 'cuda' else 'CPU'} tensors, "
                         f"got {device}")
    fields = _spec(lowered, state.present.shape[0])[0]
    contiguous = True
    for t, (dtype, shape) in zip(state, fields):
        if t.dtype != dtype or t.shape != shape or t.device != device:
            check_state(lowered, state)
            raise ValueError(f"{what}: the state does not fit the game")
        contiguous = contiguous and t.is_contiguous()
    if not contiguous:
        state = GameState(*(t.contiguous() for t in state))
    return remember_state(lowered, state, kind)


def new_state(lowered: Lowered, batch: int, device) -> GameState:
    """An uninitialised GameState of `batch` rooms on `device`: one
    allocation, each field a view of it in its own dtype (aligned), where
    fifteen allocations would each cost the caller's host."""
    _, plan, nbytes = _spec(lowered, batch)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    typed = {}
    fields = []
    for dtype, shape, stride, offset in plan:
        if dtype not in typed:
            typed[dtype] = buf.view(dtype)
        fields.append(typed[dtype].as_strided(shape, stride, offset))
    return GameState(*fields)


def rooms_arg(x: torch.Tensor, name: str, shape: tuple, dtype, device) -> torch.Tensor:
    """`x` made contiguous once it is checked to be a `shape` `dtype` tensor
    on `device`."""
    if not isinstance(x, torch.Tensor) or x.device != device or x.dtype != dtype \
            or tuple(x.shape) != shape:
        got = (f"{tuple(x.shape)} {x.dtype} on {x.device}" if isinstance(x, torch.Tensor)
               else type(x).__name__)
        raise ValueError(f"{name} must be {shape} {dtype} on {device}, got {got}")
    return x.contiguous()


def _addresses(state: GameState):
    return _ADDRESSES(*(t.data_ptr() for t in state))


def state_addresses(lowered: Lowered, state: GameState, kind: str):
    """A checked state's field addresses in GameState's order, as the
    entries' int64 array (remembered with it)."""
    got = _known(lowered, state, kind)
    return got[2] if got is not None else _addresses(state)


_NO_GUARD = contextlib.nullcontext()


def on_card(device: torch.device):
    """The guard that makes `device` the current card around a launch, or
    nothing when it already is (the guard costs the host a few us)."""
    if torch.cuda.current_device() == device.index:
        return _NO_GUARD
    return torch.cuda.device(device)


def card_stream(device: torch.device) -> int:
    """torch's current stream of `device`'s card as the raw handle a
    launch takes."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream
