"""Host side of the CUDA rollout kernel (csrc/rollout.cu).

Counterpart of game_engine_tpu/core/pallas_rollout.py: the state goes into
the kernel in the same room-minor int32 layout — every bank as
(bank, P, rooms), so one field of consecutive rooms is contiguous — and the
game's tables as the native/pack.py blob behind a directory of section
offsets. The kernel runs a room on a group of lanes, one seat a lane (a
warp past 32 seats, a lane taking every 32nd seat), with the room's words in
shared memory sized to the game by the library itself (``block_size`` asks
it); ``check_game`` refuses only what that design cannot hold.
``kernel_rollout`` checks its inputs, launches on torch's current stream and
counts its launches in ``kernel_rollout.launches``; ``host_rollout`` runs the
kernel's per-room body compiled by g++ on CPU tensors (the CPU tests' view of
the kernel's logic). ``profile_rollout`` and ``count_rollout`` are measuring
tools over two more builds of the same source.
"""

from __future__ import annotations

import numpy as np
import torch

from game_engine_tpu_torch.gamespec import tables as T
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.native.pack import pack
from game_engine_tpu_torch import _build
from game_engine_tpu_torch.core.state import _DTYPES, M32, GameState, tables
from game_engine_tpu_torch.utils.metrics import span

_I32 = torch.int32
_DIR_LEN = 16        # room_step.cuh DIR_LEN
MAX_GROUP = 32       # room_step.cuh MAX_GROUP: a room's lanes are lanes of one warp
MAX_SEATS = 256      # room_step.cuh MAX_SEATS: a seat set's words in a wide room's registers
MIN_THREADS = 32     # room_step.cuh MIN_THREADS: the smallest block, one warp


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


def max_block_nodes(lowered: Lowered) -> int:
    """Effect-IR nodes of the game's largest block."""
    return max([len(nodes) for m in lowered.mechanics for nodes, _ in m.blocks] or [0])


def max_cond_nodes(lowered: Lowered) -> int:
    """Nodes of the game's largest branch-condition tree."""
    return max([_cond_nodes(c) for br in lowered.branches for c, _ in br] or [0])


def game_array(lowered: Lowered) -> np.ndarray:
    """The pack.py blob behind a directory: dir[sid] = offset of section
    sid's data in the returned array, dir[16 + sid] = its length; dir[0] =
    max_block_nodes, from which the kernel sizes a room's node values, and
    dir[16] = max_cond_nodes, from which it sizes a condition's stack."""
    blob = pack(lowered)
    directory = np.zeros(2 * _DIR_LEN, np.int32)
    directory[0] = max_block_nodes(lowered)
    directory[_DIR_LEN] = max_cond_nodes(lowered)
    i = 1
    while i + 2 <= len(blob):
        sid, n = int(blob[i]), int(blob[i + 1])
        if 0 < sid < _DIR_LEN:
            directory[sid] = len(directory) + i + 2
            directory[_DIR_LEN + sid] = n
        i += 2 + n
    return np.concatenate([directory, blob])


def group_lanes(P: int) -> int:
    """Lanes that run one room: the smallest power of two >= P, at most a
    warp (a room of more seats runs on 32 lanes)."""
    return min(MAX_GROUP, 1 << max(0, P - 1).bit_length())


def block_size(lowered: Lowered, threads: int = 128, lib=None) -> dict:
    """How the kernel sizes a block of the game when `threads` lanes are asked
    for, from room_step.cuh's own layout (size_report; `lib` is the library
    asked, the g++ build unless given): "words_per_lane", the int32 words a
    seat's lane holds in shared memory; "threads", the largest of `threads`,
    `threads` / 2, ... down to one warp whose block fits (0: none does);
    "shared_bytes", that block's game array and words (one warp's when none
    fits); "max_shared_bytes", the most a block can have; "st_threads" and
    "st_shared_bytes", the same two for the engine step entry's block
    (core/step_kernel.py), which also stages its rooms' fields."""
    gm = np.ascontiguousarray(game_array(lowered))
    out = np.zeros(6, np.int64)
    (lib or _build.host_lib()).ge_size(gm.ctypes.data, len(gm), threads, out.ctypes.data)
    return dict(zip(("words_per_lane", "threads", "shared_bytes", "max_shared_bytes",
                     "st_threads", "st_shared_bytes"), (int(x) for x in out)))


def _cond_nodes(cond) -> int:
    if isinstance(cond, T.LAnd):
        return 1 + sum(_cond_nodes(c) for c in cond.items)
    return 1


def check_game(lowered: Lowered, lib=None) -> None:
    """Raise ValueError for a game the rollout kernel's design cannot hold:
    more seats than a seat set's words hold, or rooms too large for a
    one-warp block's shared memory, the engine step entry's (which also
    stages the rooms' fields) as well as the rollout's (`lib`: the library
    whose sizing is asked, see block_size). Phases and branch conditions
    are sized to the game: the blob's phase masks take the words they need
    (pack.py), a condition's stack the room's words (room_step.cuh)."""
    if lowered.P > MAX_SEATS:
        raise ValueError(f"game needs P={lowered.P} seats; the rollout kernel keeps a "
                         f"room's seat sets in {MAX_SEATS // 32} words, P <= {MAX_SEATS}")
    size = block_size(lowered, MIN_THREADS, lib)
    if size["threads"] == 0:
        raise ValueError(f"game needs {size['shared_bytes']} bytes of shared memory for a "
                         f"block of {MIN_THREADS} lanes ({size['words_per_lane']} words a "
                         f"lane); a block can have <= {size['max_shared_bytes']}")
    if size["st_threads"] == 0:
        raise ValueError(f"game needs {size['st_shared_bytes']} bytes of shared memory for an "
                         f"engine step block of {MIN_THREADS} lanes (its words and its rooms' "
                         f"fields); a block can have <= {size['max_shared_bytes']}")


def _game_arrays(lowered: Lowered, device) -> tuple:
    """(the checked game array on `device`, the same array in numpy), cached
    with the other tables."""
    tabs = tables(lowered, device)
    if "kernel_game" not in tabs:
        check_game(lowered, _build.cuda_lib() if torch.device(device).type == "cuda"
                   else _build.host_lib())
        host = np.ascontiguousarray(game_array(lowered))
        tabs["kernel_game"] = (torch.as_tensor(host, device=device), host)
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
    """The state buffers' and eps's addresses, once all are checked."""
    for a in (game, eps) + arrs:
        if a.device != device or a.dtype != _I32 or not a.is_contiguous():
            raise ValueError("rollout kernel buffers must be contiguous int32 "
                             f"on {device}")
    return [a.data_ptr() for a in arrs] + [eps.data_ptr()]


def _require_cuda(state: GameState) -> None:
    device = state.present.device
    if device.type != "cuda":
        raise ValueError(f"kernel_rollout takes CUDA tensors, got {device}")


def _launch(lib, lowered: Lowered, state: GameState, num_steps: int, auto_reset: bool,
            threads_per_block: int, prof: torch.Tensor | None = None):
    """Check the inputs and launch `lib`'s rollout entry on torch's current
    stream -> (the minor-layout buffers, now holding the result; each room's
    episodes). Raises on bad input or a refused launch."""
    _require_cuda(state)
    device = state.present.device
    if not (MIN_THREADS <= threads_per_block <= 1024 and threads_per_block % 32 == 0):
        raise ValueError(f"threads_per_block={threads_per_block} is not a multiple of 32 "
                         f"in [{MIN_THREADS}, 1024]")
    if num_steps <= 0 or state.batch == 0:
        raise ValueError(f"nothing to launch: {state.batch} rooms, {num_steps} steps")
    with span("ge.K1.to_minor"):
        check_state(lowered, state)
        game, game_host = _game_arrays(lowered, device)
        arrs = to_minor(state)
    with span("ge.K1.launch"):
        eps = torch.empty(state.batch, dtype=_I32, device=device)
        args = [game.data_ptr(), game_host.ctypes.data, game.numel(),
                *_args(game, arrs, eps, device), state.batch, num_steps, int(auto_reset),
                threads_per_block]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if prof is None:
                err = lib.ge_rollout(*args, stream)
            else:
                err = lib.ge_rollout_profile(*args, prof.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("rollout kernel launch failed: "
                           + lib.ge_error_string(err).decode())
    return arrs, eps


def kernel_rollout(lowered: Lowered, state: GameState, num_steps: int,
                   auto_reset: bool = True, threads_per_block: int = 128):
    """num_steps engine steps of every room in ONE launch of the CUDA
    rollout kernel -> (state, episodes). CUDA tensors only; raises on bad
    input or a refused launch. Bit-identical to engine.make_rollout. A game
    whose rooms do not fit a block of threads_per_block lanes in shared
    memory gets the largest halving of it that fits. Spans: ge.entry.K1
    over the call, and within it ge.K1.to_minor (the checks, the game's
    arrays, the layout conversion), ge.K1.launch and ge.K1.from_minor (the
    conversion back and the episode sum)."""
    with span("ge.entry.K1"):
        _require_cuda(state)
        if num_steps >= 0 and (state.batch == 0 or num_steps == 0):
            check_state(lowered, state)
            return state, torch.zeros((), dtype=torch.int64, device=state.present.device)
        arrs, eps = _launch(_build.cuda_lib(), lowered, state, num_steps, auto_reset,
                            threads_per_block)
        kernel_rollout.launches += 1
        with span("ge.K1.from_minor"):
            return from_minor(arrs), eps.sum(dtype=torch.int64)


kernel_rollout.launches = 0


def launch_plan(lowered: Lowered, batch: int, threads_per_block: int = 128,
                device="cuda") -> dict:
    """How kernel_rollout's launch over `batch` rooms is sized on this card:
    the lanes that run a room (at least group_lanes(P); more while every room
    still holds a warp slot of the card at once), the dynamic shared memory
    of a block, the blocks an SM holds at a time, and the lanes of a block
    (the largest halving of threads_per_block whose rooms fit)."""
    device = torch.device(device)
    _, game_host = _game_arrays(lowered, device)
    out = np.zeros(4, np.int64)
    lib = _build.cuda_lib()
    with torch.cuda.device(device):  # the card whose SMs and limits are asked
        err = lib.ge_plan(game_host.ctypes.data, len(game_host), batch, threads_per_block,
                          out.ctypes.data)
    if err != 0:
        raise RuntimeError("rollout kernel plan failed: " + lib.ge_error_string(err).decode())
    threads = int(out[3])
    return {"threads_per_block": threads, "lanes_per_room": int(out[0]),
            "shared_bytes_per_block": int(out[1]), "blocks_per_sm": int(out[2]),
            "warps_per_sm": int(out[2]) * threads // 32}


PROFILE_SECTIONS = ("policy", "accept_records", "branch", "reset")  # then one a mechanic


def profile_rollout(lowered: Lowered, state: GameState, num_steps: int,
                    auto_reset: bool = True, threads_per_block: int = 128) -> dict:
    """A measuring tool: the rollout through the -DGE_PROFILE build of the
    kernel -> {section: clock64() cycles summed over every room}, sections
    being PROFILE_SECTIONS and "effects_<mechanic index>_phase_<phase>" for
    each effect program. Not counted in kernel_rollout.launches; the state
    is not returned."""
    prof = torch.zeros(32, dtype=torch.int64, device=state.present.device)
    _launch(_build.profile_lib(), lowered, state, num_steps, auto_reset,
            threads_per_block, prof)
    names = list(PROFILE_SECTIONS) + [
        f"effects_{i}_phase_{m.phase_index}" for i, m in enumerate(lowered.mechanics)]
    out = {}
    for k, cycles in enumerate(prof.tolist()):
        name = names[k] if k < min(len(names), 31) else "effects_rest"
        if cycles:
            out[name] = out.get(name, 0) + cycles
    return out


def _host_run(lib, lowered: Lowered, state: GameState, num_steps: int, auto_reset: bool):
    device = state.present.device
    if device.type != "cpu":
        raise ValueError(f"host_rollout takes CPU tensors, got {device}")
    check_state(lowered, state)
    game, _ = _game_arrays(lowered, device)
    B = state.batch
    arrs = to_minor(state)
    eps = torch.zeros(B, dtype=_I32)
    if B and num_steps > 0:
        err = lib.ge_rollout_host(game.data_ptr(), game.numel(),
                                  *_args(game, arrs, eps, device), B, num_steps,
                                  int(auto_reset))
        if err != 0:
            raise RuntimeError(f"host rollout failed ({err})")
    return from_minor(arrs), eps.sum(dtype=torch.int64)


def host_rollout(lowered: Lowered, state: GameState, num_steps: int,
                 auto_reset: bool = True):
    """The kernel's per-room body (csrc/room_step.cuh) built with g++ and
    run over the rooms on the host -> (state, episodes). CPU tensors only."""
    return _host_run(_build.host_lib(), lowered, state, num_steps, auto_reset)


COUNT_NAMES = ("atoms", "node_ops", "state_writes", "hashes")
# integer operations each counted event needs at the least: a compare for an
# atom, one for a write, splitmix32's add, three shift-xor pairs and two
# multiplies; an effect-IR node's are counted as such (room_step.cuh
# node_ops: none for a constant, one for a seat's own node, a read a seat a
# cross-seat node looks at, one pass a room for a room-level node)
COUNT_OPS = (1, 1, 1, 9)


def count_rollout(lowered: Lowered, state: GameState, num_steps: int,
                  auto_reset: bool = True) -> dict:
    """A measuring tool: the host body built with -DGE_COUNT over the rooms
    -> {name: count} of COUNT_NAMES, plus "int_ops", their sum weighted by
    COUNT_OPS: the integer operations the interpreter cannot do without on
    these rooms. CPU tensors only."""
    lib = _build.host_count_lib()
    lib.ge_counts_reset()
    _host_run(lib, lowered, state, num_steps, auto_reset)
    out = np.zeros(len(COUNT_NAMES), np.int64)
    lib.ge_counts_read(out.ctypes.data)
    counts = dict(zip(COUNT_NAMES, (int(x) for x in out)))
    counts["int_ops"] = int(sum(int(n) * w for n, w in zip(out, COUNT_OPS)))
    return counts
