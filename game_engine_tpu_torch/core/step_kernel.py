"""Host side of ST, the engine step entry (csrc/rollout.cu ge_step,
ge_reset_done and ge_bots).

The port's counterpart of what the JAX package compiles once and calls a
turn at a time: its jitted engine step (game_engine_tpu/core/step.py
jit_step), its jitted scripted bots (core/engine.py BatchedEngine) and the
init_state_like + where(done) reset of its unroll (train/ppo.py). Each is
one launch over the B rooms of a GameState's own tensors, a room on a group
of lanes, through room_step.cuh's room_policy, room_step and room_init: the
code K1 (core/rollout_kernel.py) runs, which is bit-identical to the plain
engine. The kernel reads every field in its own dtype and writes a new
GameState, so the caller's state is left as it was and nothing is
converted around the launch.

``kernel_step``, ``kernel_reset_done`` and ``kernel_bot_actions`` take CUDA
tensors, launch on torch's current stream inside the tensors' card guard,
count their launches, and make no host-device synchronisation: the launch
is sized by a plan that the card is asked for once per (game, batch, card)
and that is cached with the game's tables. ``host_step``,
``host_reset_done`` and ``host_bot_actions`` run the same entries built with
g++ on CPU tensors (the CPU tests' view of the kernel's logic);
``count_step`` counts one step's interpreter operations through the
-DGE_COUNT build. Bad input, a device that is neither CUDA nor CPU and a
refused launch raise; nothing falls back to the plain step.
"""

from __future__ import annotations

import numpy as np
import torch

from game_engine_tpu_torch import _build
from game_engine_tpu_torch.core.entry_args import checked_state, rooms_arg, state_addresses
from game_engine_tpu_torch.core.rollout_kernel import COUNT_NAMES, COUNT_OPS, _game_arrays
from game_engine_tpu_torch.core.state import GameState, tables
from game_engine_tpu_torch.gamespec.tables import Lowered

THREADS = 128  # lanes a block asked of the plan, as kernel_rollout asks


def _new_like(state: GameState) -> GameState:
    return GameState(*(torch.empty_like(t) for t in state))


def step_plan(lowered: Lowered, batch: int, device) -> tuple:
    """(lanes a room, lanes a block, shared bytes a block) of ST's launch
    over `batch` rooms of the game on `device`'s card: asked of the card
    once (ge_step_plan, launch_plan.cuh's rule for the step kernel) and
    cached with the game's tables of that card."""
    device = torch.device(device)
    plans = tables(lowered, device).setdefault("step_plans", {})
    if batch not in plans:
        _, game_host = _game_arrays(lowered, device)
        out = np.zeros(4, np.int64)
        lib = _build.cuda_lib()
        with torch.cuda.device(device):  # the card whose SMs and limits are asked
            err = lib.ge_step_plan(game_host.ctypes.data, len(game_host), batch, THREADS,
                                   out.ctypes.data)
        if err != 0:
            raise RuntimeError("engine step plan failed: " + lib.ge_error_string(err).decode())
        plans[batch] = (int(out[0]), int(out[3]), int(out[1]))
    return plans[batch]


def _launch(name: str, lowered: Lowered, state: GameState, *args) -> None:
    device = state.present.device
    game, game_host = _game_arrays(lowered, device)
    G, threads, smem = step_plan(lowered, state.batch, device)
    lib = _build.cuda_lib()
    with torch.cuda.device(device):
        err = getattr(lib, name)(game.data_ptr(), game_host.ctypes.data, game.numel(), *args,
                                 state.batch, G, threads, smem,
                                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"engine step entry {name} launch failed: "
                           + lib.ge_error_string(err).decode())


def _on_host(lib):
    """A runner of the entries' g++ build `lib` (name + "_host") in place of
    _launch."""
    def run(name: str, lowered: Lowered, state: GameState, *args) -> None:
        game, _ = _game_arrays(lowered, state.present.device)
        err = getattr(lib, name + "_host")(game.data_ptr(), game.numel(), *args, state.batch)
        if err != 0:
            raise RuntimeError(f"host engine step entry {name} failed ({err})")

    return run


def _step(run, kind: str, lowered: Lowered, state: GameState, actions, keep):
    st = checked_state(lowered, state, kind, "the engine step")
    B, P = st.present.shape
    device = st.present.device
    acts = rooms_arg(actions, "actions", (B, P), torch.int32, device)
    keep = None if keep is None else rooms_arg(keep, "keep", (B,), torch.bool, device)
    out = _new_like(st)
    ended = torch.empty(B, dtype=torch.bool, device=device)  # every room's is written
    if B == 0:
        return out, ended
    run("ge_step", lowered, st, state_addresses(st), state_addresses(out), acts.data_ptr(),
        None if keep is None else keep.data_ptr(), ended.data_ptr())
    return out, ended


def _reset_done(run, kind: str, lowered: Lowered, state: GameState) -> GameState:
    st = checked_state(lowered, state, kind, "the reset")
    out = _new_like(st)
    if st.batch:
        run("ge_reset_done", lowered, st, state_addresses(st), state_addresses(out))
    return out


def _bot_actions(run, kind: str, lowered: Lowered, state: GameState) -> torch.Tensor:
    st = checked_state(lowered, state, kind, "the scripted bots")
    actions = torch.empty(st.present.shape, dtype=torch.int32, device=st.present.device)
    if st.batch:
        run("ge_bots", lowered, st, state_addresses(st), actions.data_ptr())
    return actions


def kernel_step(lowered: Lowered, state: GameState, actions: torch.Tensor,
                keep: torch.Tensor | None = None):
    """One engine step of every room on the caller's (B, P) int32 actions
    (0 = none; any value, as make_step takes it) in one ST launch ->
    (new state, (B,) bool ended = done after and not before). Rooms outside
    the (B,) bool `keep` mask are copied through unchanged. Bit-identical
    to core/step.py make_step (and the seed, an int64, comes out as its
    uint32). CUDA tensors only."""
    out = _step(_launch, "cuda", lowered, state, actions, keep)
    kernel_step.launches += state.batch > 0
    return out


def kernel_reset_done(lowered: Lowered, state: GameState) -> GameState:
    """Every done room restarted as engine.init_state_like restarts it (its
    seats, the seed splitmix32(seed ^ 0xDECAF000)), the rest unchanged, in
    one ST launch: a new GameState, bit-identical to
    engine.reset_where_done. CUDA tensors only."""
    out = _reset_done(_launch, "cuda", lowered, state)
    kernel_reset_done.launches += state.batch > 0
    return out


def kernel_bot_actions(lowered: Lowered, state: GameState) -> torch.Tensor:
    """The scripted bots' (B, P) int32 actions in one ST launch,
    bit-identical to engine.scripted_actions. CUDA tensors only."""
    out = _bot_actions(_launch, "cuda", lowered, state)
    kernel_bot_actions.launches += state.batch > 0
    return out


kernel_step.launches = 0
kernel_reset_done.launches = 0
kernel_bot_actions.launches = 0


def host_step(lowered: Lowered, state: GameState, actions: torch.Tensor,
              keep: torch.Tensor | None = None):
    """kernel_step's entry built with g++ and run over the rooms on the
    host -> (state, ended). CPU tensors only."""
    return _step(_on_host(_build.host_lib()), "cpu", lowered, state, actions, keep)


def host_reset_done(lowered: Lowered, state: GameState) -> GameState:
    """kernel_reset_done's entry built with g++. CPU tensors only."""
    return _reset_done(_on_host(_build.host_lib()), "cpu", lowered, state)


def host_bot_actions(lowered: Lowered, state: GameState) -> torch.Tensor:
    """kernel_bot_actions's entry built with g++. CPU tensors only."""
    return _bot_actions(_on_host(_build.host_lib()), "cpu", lowered, state)


def count_step(lowered: Lowered, state: GameState, actions: torch.Tensor) -> dict:
    """A measuring tool: one host_step through the -DGE_COUNT build ->
    {name: count} of rollout_kernel.COUNT_NAMES and "int_ops", their sum
    weighted by COUNT_OPS: the integer operations the interpreter cannot do
    without for this step. CPU tensors only."""
    lib = _build.host_count_lib()
    lib.ge_counts_reset()
    _step(_on_host(lib), "cpu", lowered, state, actions, None)
    out = np.zeros(len(COUNT_NAMES), np.int64)
    lib.ge_counts_read(out.ctypes.data)
    counts = dict(zip(COUNT_NAMES, (int(x) for x in out)))
    counts["int_ops"] = int(sum(int(n) * w for n, w in zip(out, COUNT_OPS)))
    return counts
