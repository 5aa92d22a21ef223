"""Host side of the CUDA rollout kernel (csrc/rollout.cu).

Counterpart of game_engine_tpu/core/pallas_rollout.py: the state goes into
the kernel in the same room-minor int32 layout — every bank as
(bank, P, rooms), so one field of consecutive rooms is contiguous — and the
game's tables as the native/pack.py blob behind a directory of section
offsets. ``kernel_rollout`` checks its inputs, launches on torch's current
stream and counts its launches in ``kernel_rollout.launches``;
``host_rollout`` runs the kernel's per-room body compiled by g++ on CPU
tensors (the CPU tests' view of the kernel's logic).
"""

from __future__ import annotations

import numpy as np
import torch

from game_engine_tpu.gamespec import tables as T
from game_engine_tpu.gamespec.tables import Lowered
from game_engine_tpu.native.pack import pack
from game_engine_tpu_torch import _build
from game_engine_tpu_torch.core.state import _DTYPES, M32, GameState, tables

_I32 = torch.int32
_DIR_LEN = 16  # room_step.cuh DIR_LEN
_LIMIT_NAMES = ("P", "NB", "NN", "NS", "NPD", "NOD", "nodes per block",
                "branch condition nodes")


def to_minor(state: GameState) -> tuple:
    """GameState -> the kernel's int32 buffers, all contiguous:
    bools (NB,P,B), nums (NN,P,B), strs (NS,P,B), pdict (NPD,P,P,B),
    odict (NOD,P,B), present (P,B), regs (3,P,B) = acted/choice/choice_phase,
    scal (6,B) = phase/prev/done/winner/t/seed (seed bit-cast to int32)."""
    seed = state.seed & M32
    seed = torch.where(seed >= 2 ** 31, seed - 2 ** 32, seed)
    return (
        state.bools.permute(2, 1, 0).to(_I32).contiguous(),
        state.nums.permute(2, 1, 0).to(_I32).contiguous(),
        state.strs.permute(2, 1, 0).to(_I32).contiguous(),
        state.pdict.permute(2, 1, 3, 0).to(_I32).contiguous(),
        state.odict.permute(2, 1, 0).to(_I32).contiguous(),
        state.present.t().to(_I32).contiguous(),
        torch.stack([state.acted.t().to(_I32), state.choice.t().to(_I32),
                     state.choice_phase.t().to(_I32)]).contiguous(),
        torch.stack([state.phase.to(_I32), state.prev_phase.to(_I32),
                     state.done.to(_I32), state.winner.to(_I32),
                     state.t.to(_I32), seed.to(_I32)]).contiguous(),
    )


def from_minor(arrs: tuple) -> GameState:
    """Inverse of to_minor."""
    bools, nums, strs, pdict, odict, present, regs, scal = arrs
    return GameState(
        bools=bools.permute(2, 1, 0).to(torch.bool).contiguous(),
        nums=nums.permute(2, 1, 0).contiguous(),
        strs=strs.permute(2, 1, 0).to(torch.int8).contiguous(),
        pdict=pdict.permute(3, 1, 0, 2).to(torch.int8).contiguous(),
        odict=odict.permute(2, 1, 0).to(torch.int8).contiguous(),
        present=present.t().to(torch.bool).contiguous(),
        phase=scal[0].clone(), prev_phase=scal[1].clone(),
        done=scal[2].to(torch.bool), winner=scal[3].clone(), t=scal[4].clone(),
        seed=scal[5].to(torch.int64) & M32,
        acted=regs[0].t().to(torch.bool).contiguous(),
        choice=regs[1].t().contiguous(),
        choice_phase=regs[2].t().contiguous(),
    )


def game_array(lowered: Lowered) -> np.ndarray:
    """The pack.py blob behind a directory: dir[sid] = offset of section
    sid's data in the returned array, dir[16 + sid] = its length."""
    blob = pack(lowered)
    directory = np.zeros(2 * _DIR_LEN, np.int32)
    i = 1
    while i + 2 <= len(blob):
        sid, n = int(blob[i]), int(blob[i + 1])
        if 0 < sid < _DIR_LEN:
            directory[sid] = len(directory) + i + 2
            directory[_DIR_LEN + sid] = n
        i += 2 + n
    return np.concatenate([directory, blob])


def _cond_nodes(cond) -> int:
    if isinstance(cond, T.LAnd):
        return 1 + sum(_cond_nodes(c) for c in cond.items)
    return 1


def check_game(lowered: Lowered, limits: np.ndarray) -> None:
    """Raise ValueError when the game exceeds the kernel's compiled bounds."""
    lay = lowered.game.layout
    need = (
        lowered.P, lay.n_bool, lay.n_num, lay.n_str, max(1, lay.n_pdict),
        max(1, lay.n_odict),
        max([len(nodes) for m in lowered.mechanics for nodes, _ in m.blocks] or [0]),
        max([_cond_nodes(c) for br in lowered.branches for c, _ in br] or [0]),
    )
    for name, n, lim in zip(_LIMIT_NAMES, need, limits):
        if n > lim:
            raise ValueError(f"game needs {name}={n}; the rollout kernel is built for <= {lim}")


def _limits(lib) -> np.ndarray:
    out = np.zeros(len(_LIMIT_NAMES), np.int32)
    lib.ge_limits(out.ctypes.data)
    return out


def _game_tensor(lowered: Lowered, lib, device) -> torch.Tensor:
    """The checked game array on `device`, cached with the other tables."""
    tabs = tables(lowered, device)
    if "kernel_game" not in tabs:
        check_game(lowered, _limits(lib))
        tabs["kernel_game"] = torch.as_tensor(game_array(lowered), device=device)
    return tabs["kernel_game"]


def check_state(lowered: Lowered, state: GameState) -> None:
    """Raise ValueError unless every field is on one device with the
    GameState dtype and this game's shape."""
    lay = lowered.game.layout
    B, P = state.present.shape
    shapes = {
        "bools": (B, P, lay.n_bool), "nums": (B, P, lay.n_num),
        "strs": (B, P, lay.n_str), "pdict": (B, P, max(1, lay.n_pdict), P),
        "odict": (B, P, max(1, lay.n_odict)), "present": (B, P),
        "acted": (B, P), "choice": (B, P), "choice_phase": (B, P),
    }
    if P != lowered.P:
        raise ValueError(f"state has P={P} seats; the game has P={lowered.P}")
    dev = state.present.device
    for name, t in zip(state._fields, state):
        if t.device != dev:
            raise ValueError(f"field {name} on {t.device}, present on {dev}")
        if t.dtype != _DTYPES[name]:
            raise ValueError(f"field {name} is {t.dtype}, expected {_DTYPES[name]}")
        if tuple(t.shape) != shapes.get(name, (B,)):
            raise ValueError(f"field {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes.get(name, (B,))}")


def _args(game: torch.Tensor, arrs: tuple, eps: torch.Tensor, device) -> list:
    for a in (game, eps) + arrs:
        if a.device != device or a.dtype != _I32 or not a.is_contiguous():
            raise ValueError("rollout kernel buffers must be contiguous int32 "
                             f"on {device}")
    return [game.data_ptr(), game.numel()] + [a.data_ptr() for a in arrs] \
        + [eps.data_ptr()]


def kernel_rollout(lowered: Lowered, state: GameState, num_steps: int,
                   auto_reset: bool = True, threads_per_block: int = 128):
    """num_steps engine steps of every room in ONE launch of the CUDA
    rollout kernel -> (state, episodes). CUDA tensors only; raises on bad
    input or a refused launch. Bit-identical to engine.make_rollout."""
    device = state.present.device
    if device.type != "cuda":
        raise ValueError(f"kernel_rollout takes CUDA tensors, got {device}")
    if not 1 <= threads_per_block <= 1024:
        raise ValueError(f"threads_per_block={threads_per_block} not in [1, 1024]")
    if num_steps < 0:
        raise ValueError(f"num_steps={num_steps} < 0")
    check_state(lowered, state)
    lib = _build.cuda_lib()
    game = _game_tensor(lowered, lib, device)
    B = state.batch
    if B == 0 or num_steps == 0:
        return state, torch.zeros((), dtype=torch.int64, device=device)
    arrs = to_minor(state)
    eps = torch.empty(B, dtype=_I32, device=device)
    args = _args(game, arrs, eps, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ge_rollout(*args, B, num_steps, int(auto_reset),
                             threads_per_block, stream)
    if err != 0:
        raise RuntimeError("rollout kernel launch failed: "
                           + lib.ge_error_string(err).decode())
    kernel_rollout.launches += 1
    return from_minor(arrs), eps.sum(dtype=torch.int64)


kernel_rollout.launches = 0


def host_rollout(lowered: Lowered, state: GameState, num_steps: int,
                 auto_reset: bool = True):
    """The kernel's per-room body (csrc/room_step.cuh) built with g++ and
    run over the rooms on the host -> (state, episodes). CPU tensors only."""
    device = state.present.device
    if device.type != "cpu":
        raise ValueError(f"host_rollout takes CPU tensors, got {device}")
    check_state(lowered, state)
    lib = _build.host_lib()
    game = _game_tensor(lowered, lib, device)
    B = state.batch
    arrs = to_minor(state)
    eps = torch.zeros(B, dtype=_I32)
    if B and num_steps > 0:
        err = lib.ge_rollout_host(*_args(game, arrs, eps, device), B, num_steps,
                                  int(auto_reset))
        if err != 0:
            raise RuntimeError(f"host rollout failed ({err})")
    return from_minor(arrs), eps.sum(dtype=torch.int64)
