"""Host side of ST, the engine step entry (csrc/rollout.cu ge_step,
ge_reset_done, ge_bots and ge_step_reset).

The port's counterpart of what the JAX package compiles once and calls a
turn at a time: its jitted engine step (game_engine_tpu/core/step.py
jit_step), its jitted scripted bots (core/engine.py BatchedEngine) and the
step, terminal rewards and init_state_like + where(done) reset of its
unroll body (train/ppo.py). Each is one launch over the B rooms of a
GameState's own tensors, a room on a group of lanes, through room_step.cuh's
room_policy, room_step and room_init: the code K1 (core/rollout_kernel.py)
runs, which is bit-identical to the plain engine. The kernel reads every
field in its own dtype and writes a new GameState (or the caller's spare
one), so the caller's state is left as it was and nothing is converted
around the launch.

``kernel_step``, ``kernel_reset_done``, ``kernel_bot_actions`` and
``kernel_step_reset`` take CUDA tensors, launch on torch's current stream
(inside the tensors' card guard when another card is current), count their
launches, run inside the span ge.entry.ST, and make no host-device
synchronisation: the launch is sized by a plan that the card is asked for
once per (game, batch, card) and that is cached with the game's tables, as
is what each launch passes. ``host_*`` run the same block body built with
g++ on CPU tensors (the CPU tests' view of the kernel's logic);
``count_step`` counts one step's interpreter operations through the
-DGE_COUNT build and ``profile_step`` times an entry's block sections
through the -DGE_PROFILE build. Bad input, a device that is neither CUDA
nor CPU and a refused launch raise; nothing falls back to the plain step.
"""

from __future__ import annotations

import numpy as np
import torch

from game_engine_tpu_torch import _build
from game_engine_tpu_torch.core.entry_args import (
    card_stream,
    checked_state,
    new_state,
    on_card,
    remember_state,
    rooms_arg,
    state_addresses,
)
from game_engine_tpu_torch.core.rollout_kernel import COUNT_NAMES, COUNT_OPS, _game_arrays
from game_engine_tpu_torch.core.state import GameState, tables
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.utils.metrics import span

THREADS = 128  # lanes a block asked of the plan, as kernel_rollout asks
# rooms a block of the g++ build (the card's: a block's lanes over a room's)
HOST_ROOMS_PER_BLOCK = 3
RW_NONE, RW_TEAM, RW_SCORE = range(3)  # room_step.cuh RewardRule modes


def reward_rule(lowered: Lowered) -> tuple:
    """(mode, team string slot, team codes as int32) of the game-over
    mechanic's terminal rewards, as engine.terminal_rewards_plain pays them:
    RW_TEAM for a team game with a team string and codes, RW_SCORE for a
    score game, RW_NONE otherwise."""
    go = lowered.game_overs[0] if lowered.game_overs else None
    if go is not None and go.mode == "team" and go.team_str_slot >= 0 and go.team_codes:
        return RW_TEAM, int(go.team_str_slot), np.asarray(go.team_codes, np.int32)
    if go is not None and go.mode == "score":
        return RW_SCORE, -1, np.zeros(0, np.int32)
    return RW_NONE, -1, np.zeros(0, np.int32)


def _reward_args(lowered: Lowered, device) -> tuple:
    """(mode, team slot, codes' address or None, n codes) for a launch on
    `device`, the codes copied there once and cached on the Lowered."""
    cache = lowered.__dict__.setdefault("_torch_reward_args", {})
    if device not in cache:
        mode, slot, codes = reward_rule(lowered)
        t = torch.as_tensor(codes, device=device)
        cache[device] = (t, (mode, slot, t.data_ptr() if len(codes) else None, len(codes)))
    return cache[device][1]


def step_plan(lowered: Lowered, batch: int, device, lib=None) -> tuple:
    """(lanes a room, lanes a block, shared bytes a block) of ST's launch
    over `batch` rooms of the game on `device`'s card: asked of the card
    once (ge_step_plan, launch_plan.cuh's rule for the step kernel and its
    staging) and cached with the game's tables of that card."""
    device = torch.device(device)
    lib = lib or _build.cuda_lib()
    plans = tables(lowered, device).setdefault("step_plans", {})
    if (batch, lib._name) not in plans:
        _, game_host = _game_arrays(lowered, device)
        out = np.zeros(4, np.int64)
        with torch.cuda.device(device):  # the card whose SMs and limits are asked
            err = lib.ge_step_plan(game_host.ctypes.data, len(game_host), batch, THREADS,
                                   out.ctypes.data)
        if err != 0:
            raise RuntimeError("engine step plan failed: " + lib.ge_error_string(err).decode())
        plans[batch, lib._name] = (int(out[0]), int(out[3]), int(out[1]))
    return plans[batch, lib._name]


def _launch_args(lowered: Lowered, batch: int, device, lib) -> tuple:
    """What every ST launch over `batch` rooms of the game on `device`
    passes besides its tensors: (game on the card, game on the host, its
    length) and (lanes a room, lanes a block, shared bytes), cached."""
    cache = lowered.__dict__.setdefault("_torch_st_launch", {})
    key = (batch, device, lib._name)
    if key not in cache:
        game, game_host = _game_arrays(lowered, device)
        cache[key] = ((game.data_ptr(), game_host.ctypes.data, game.numel()),
                      step_plan(lowered, batch, device, lib))
    return cache[key]


def _launcher(lib):
    """A runner of `lib`'s entries (the engine's build, or the profile's)
    on torch's current stream of the state's card."""
    def run(name: str, lowered: Lowered, state: GameState, *args) -> None:
        device = state.present.device
        game, plan = _launch_args(lowered, state.batch, device, lib)
        with on_card(device):
            err = getattr(lib, name)(*game, *args, state.batch, *plan, card_stream(device))
        if err != 0:
            raise RuntimeError(f"engine step entry {name} launch failed: "
                               + lib.ge_error_string(err).decode())

    return run


def _launch(name: str, lowered: Lowered, state: GameState, *args) -> None:
    _launcher(_build.cuda_lib())(name, lowered, state, *args)


def _on_host(lib, rooms_per_block: int = HOST_ROOMS_PER_BLOCK):
    """A runner of the entries' g++ build `lib` (name + "_host"), blocks of
    `rooms_per_block` rooms, in place of _launch."""
    def run(name: str, lowered: Lowered, state: GameState, *args) -> None:
        game, _ = _game_arrays(lowered, state.present.device)
        err = getattr(lib, name + "_host")(game.data_ptr(), game.numel(), *args, state.batch,
                                           rooms_per_block)
        if err != 0:
            raise RuntimeError(f"host engine step entry {name} failed ({err})")

    return run


def _spare(out: GameState | None, st: GameState, lowered: Lowered, kind: str) -> GameState:
    """`out` checked as a state of st's shapes on its device and not st
    itself (its buffers, as an unroll's spare state is), or a new state."""
    if out is None:
        return remember_state(lowered, new_state(lowered, st.batch, st.present.device), kind)
    out = checked_state(lowered, out, kind, "the spare state")
    if out.present.shape != st.present.shape or out.present.data_ptr() == st.present.data_ptr():
        raise ValueError("out must be another state of the same rooms, sharing no field")
    return out


def _step(run, kind: str, lowered: Lowered, state: GameState, actions, keep):
    st = checked_state(lowered, state, kind, "the engine step")
    B, P = st.present.shape
    device = st.present.device
    acts = rooms_arg(actions, "actions", (B, P), torch.int32, device)
    keep = None if keep is None else rooms_arg(keep, "keep", (B,), torch.bool, device)
    out = remember_state(lowered, new_state(lowered, B, device), kind)
    ended = torch.empty(B, dtype=torch.bool, device=device)  # every room's is written
    if B == 0:
        return out, ended
    run("ge_step", lowered, st, state_addresses(lowered, st, kind),
        state_addresses(lowered, out, kind), acts.data_ptr(),
        None if keep is None else keep.data_ptr(), ended.data_ptr())
    return out, ended


def _step_reset(run, kind: str, lowered: Lowered, state: GameState, actions, rewards: bool,
                out: GameState | None):
    st = checked_state(lowered, state, kind, "the engine step")
    B, P = st.present.shape
    device = st.present.device
    acts = rooms_arg(actions, "actions", (B, P), torch.int32, device)
    nxt = _spare(out, st, lowered, kind)
    ended = torch.empty(B, dtype=torch.bool, device=device)
    winner = torch.empty(B, dtype=torch.int32, device=device)
    reward = torch.empty((B, P), dtype=torch.float32, device=device) if rewards else None
    if B:
        run("ge_step_reset", lowered, st, state_addresses(lowered, st, kind),
            state_addresses(lowered, nxt, kind), acts.data_ptr(), ended.data_ptr(),
            winner.data_ptr(),
            None if reward is None else reward.data_ptr(), *_reward_args(lowered, device))
    return nxt, ended, winner, reward


def _reset_done(run, kind: str, lowered: Lowered, state: GameState) -> GameState:
    st = checked_state(lowered, state, kind, "the reset")
    out = remember_state(lowered, new_state(lowered, st.batch, st.present.device), kind)
    if st.batch:
        run("ge_reset_done", lowered, st, state_addresses(lowered, st, kind),
            state_addresses(lowered, out, kind))
    return out


def _bot_actions(run, kind: str, lowered: Lowered, state: GameState) -> torch.Tensor:
    st = checked_state(lowered, state, kind, "the scripted bots")
    actions = torch.empty(st.present.shape, dtype=torch.int32, device=st.present.device)
    if st.batch:
        run("ge_bots", lowered, st, state_addresses(lowered, st, kind), actions.data_ptr())
    return actions


def kernel_step(lowered: Lowered, state: GameState, actions: torch.Tensor,
                keep: torch.Tensor | None = None):
    """One engine step of every room on the caller's (B, P) int32 actions
    (0 = none; any value, as make_step takes it) in one ST launch ->
    (new state, (B,) bool ended = done after and not before). Rooms outside
    the (B,) bool `keep` mask are copied through unchanged. Bit-identical
    to core/step.py make_step (and the seed, an int64, comes out as its
    uint32). CUDA tensors only."""
    with span("ge.entry.ST"):
        out = _step(_launch, "cuda", lowered, state, actions, keep)
        kernel_step.launches += state.batch > 0
        return out


def kernel_step_reset(lowered: Lowered, state: GameState, actions: torch.Tensor,
                      rewards: bool = False, out: GameState | None = None):
    """The unroll's step, terminal rewards and reset in one ST launch ->
    (state: the step on the (B, P) int32 actions with the rooms it left
    done restarted; (B,) bool ended; (B,) int32 winner of the stepped
    rooms; with `rewards` the (B, P) f32 terminal rewards of the stepped
    state, else None): make_step, terminal_rewards_plain and
    reset_where_done, bit for bit. `out`, a state of the same rooms that
    shares no field with `state`, receives the result in place of a new
    one (the unrolls pass the state they are done with). CUDA tensors
    only."""
    with span("ge.entry.ST"):
        res = _step_reset(_launch, "cuda", lowered, state, actions, rewards, out)
        kernel_step_reset.launches += state.batch > 0
        return res


def kernel_reset_done(lowered: Lowered, state: GameState) -> GameState:
    """Every done room restarted as engine.init_state_like restarts it (its
    seats, the seed splitmix32(seed ^ 0xDECAF000)), the rest unchanged, in
    one ST launch: a new GameState, bit-identical to
    engine.reset_where_done. CUDA tensors only."""
    with span("ge.entry.ST"):
        out = _reset_done(_launch, "cuda", lowered, state)
        kernel_reset_done.launches += state.batch > 0
        return out


def kernel_bot_actions(lowered: Lowered, state: GameState) -> torch.Tensor:
    """The scripted bots' (B, P) int32 actions in one ST launch,
    bit-identical to engine.scripted_actions. CUDA tensors only."""
    with span("ge.entry.ST"):
        out = _bot_actions(_launch, "cuda", lowered, state)
        kernel_bot_actions.launches += state.batch > 0
        return out


kernel_step.launches = 0
kernel_step_reset.launches = 0
kernel_reset_done.launches = 0
kernel_bot_actions.launches = 0


def host_step(lowered: Lowered, state: GameState, actions: torch.Tensor,
              keep: torch.Tensor | None = None, rooms_per_block: int = HOST_ROOMS_PER_BLOCK):
    """kernel_step's block body built with g++ and run over blocks of
    `rooms_per_block` rooms on the host -> (state, ended). CPU tensors
    only."""
    return _step(_on_host(_build.host_lib(), rooms_per_block), "cpu", lowered, state, actions,
                 keep)


def host_step_reset(lowered: Lowered, state: GameState, actions: torch.Tensor,
                    rewards: bool = False, out: GameState | None = None,
                    rooms_per_block: int = HOST_ROOMS_PER_BLOCK):
    """kernel_step_reset's block body built with g++ -> (state, ended,
    winner, reward or None). CPU tensors only."""
    return _step_reset(_on_host(_build.host_lib(), rooms_per_block), "cpu", lowered, state,
                       actions, rewards, out)


def host_reset_done(lowered: Lowered, state: GameState,
                    rooms_per_block: int = HOST_ROOMS_PER_BLOCK) -> GameState:
    """kernel_reset_done's block body built with g++. CPU tensors only."""
    return _reset_done(_on_host(_build.host_lib(), rooms_per_block), "cpu", lowered, state)


def host_bot_actions(lowered: Lowered, state: GameState,
                     rooms_per_block: int = HOST_ROOMS_PER_BLOCK) -> torch.Tensor:
    """kernel_bot_actions's block body built with g++. CPU tensors only."""
    return _bot_actions(_on_host(_build.host_lib(), rooms_per_block), "cpu", lowered, state)


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


# room_step.cuh STS_*: a block's set-up (its runs), the copy in's issue,
# its wait (the blob and the state), the words in, the rooms' entry, the
# words out and the copy out
ST_SECTIONS = ("setup", "issue", "copy_in", "words_in", "rooms", "words_out", "copy_out")


def profile_step(lowered: Lowered, state: GameState, actions: torch.Tensor,
                 entry: str = "step_reset") -> dict:
    """A measuring tool: one ST launch through the -DGE_PROFILE build, the
    fused step_reset (with rewards) or the "step" or "reset" entry alone ->
    {section of ST_SECTIONS: clock64() cycles summed over the blocks}, a
    block's sections timed by its first thread between barriers. Not
    counted in the launch counts. CUDA tensors only."""
    lib = _build.profile_lib()
    prof = torch.zeros(len(ST_SECTIONS), dtype=torch.int64, device=state.present.device)
    run = _launcher(lib)
    with torch.cuda.device(prof.device):
        lib.ge_step_sections(prof.data_ptr())
        try:
            if entry == "step_reset":
                _step_reset(run, "cuda", lowered, state, actions, True, None)
            elif entry == "step":
                _step(run, "cuda", lowered, state, actions, None)
            else:
                _reset_done(run, "cuda", lowered, state)
        finally:
            lib.ge_step_sections(None)
    return dict(zip(ST_SECTIONS, prof.tolist()))
