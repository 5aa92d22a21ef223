"""Host side of OB, the observation entry, and SA, the sampling entry
(csrc/observe.cu ob_observe, ob_rewards and ob_sample).

The port's counterparts of what the JAX package fuses into its jitted
unroll around the policy-forward pallas_call: the observation
(net.observe), the legal-action mask (net.legal_action_mask), the actor
mask (net.actor_mask) and the terminal rewards
(train/ppo.py terminal_rewards) in OB; the Gumbel-max draw and the
log-softmax of net.sample_actions, with the actor-masked actions, in SA.
Each is one launch over GameState's own tensors (OB) or the forward's
logits (SA), bit-identical to the plain functions (logp within float
rounding of log_softmax).

``kernel_observe``, ``kernel_rewards`` and ``kernel_sample`` take CUDA
tensors, launch on torch's current stream inside the tensors' card guard,
count their launches, run inside the spans ge.entry.OB (the first two)
and ge.entry.SA, and make no host-device synchronisation: the game's
table (``ob_table``) is copied to each card once and cached with the
game's tables. ``host_observe``, ``host_rewards`` and ``host_sample`` run
the same bodies built with g++ (csrc/observe_host.cpp) on CPU tensors.
Bad input and a refused launch raise; nothing falls back to the plain
functions.
"""

from __future__ import annotations

import numpy as np
import torch

from game_engine_tpu_torch import _build
from game_engine_tpu_torch.core.entry_args import (
    card_stream,
    checked_state,
    on_card,
    rooms_arg,
    state_addresses,
)
from game_engine_tpu_torch.core.rollout_kernel import _game_arrays
from game_engine_tpu_torch.core.state import GameState, tables
from game_engine_tpu_torch.core.step_kernel import reward_rule
from game_engine_tpu_torch.gamespec.tables import Lowered
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.utils.metrics import span

# csrc/observe.cuh's table layout
HDR = 21
(T_P, T_NP, T_F0, T_F, T_A, T_TEAM_SLOT, T_MINORITY, T_HAS_MINORITY, T_REVEAL_SLOT,
 T_ALIVE_BOOL, T_NB, T_NN, T_NS, T_RW_MODE, T_RW_TEAM_SLOT, T_N_CODES, T_COLS, T_PHASES,
 T_CODES, T_LEN, T_FTAB) = range(HDR)
SRC_BOOL, SRC_NUM, SRC_STR, SRC_ACTED, SRC_ALIVE = range(5)
VIS_ACTED = 3  # after net's VIS_PUBLIC, VIS_SELF, VIS_TEAM
# a column's visibility bit (observe.cuh VB_*) by its visibility and whether
# a reveal flag opens it
VB_PUBLIC, VB_SELF, VB_SELF_RV, VB_TEAM, VB_TEAM_RV, VB_ACTED = range(6)
FT_INDEX, FT_OTHER = 0xFFFFF, 1 << 31
FT_VIEWER, FT_PHASE, FT_ALIVE = range(3)


def _column_bit(vis: int, reveal: int) -> int:
    if vis == N.VIS_PUBLIC:
        return VB_PUBLIC
    if vis == VIS_ACTED:
        return VB_ACTED
    if vis == N.VIS_SELF:
        return VB_SELF_RV if reveal else VB_SELF
    return VB_TEAM_RV if reveal else VB_TEAM


def feature_codes(P: int, NP: int, cols: list) -> np.ndarray:
    """The uint32 code of each feature f of a viewer's row (observe.cuh
    ftab): target t's column j, (column bit << 28) | (t << 20) | (t * F0 +
    j), below P * F0; then the viewer's one-hot, the phase's and the alive
    count, FT_OTHER | (kind << 29) | index."""
    F0 = len(cols)
    if P * F0 > FT_INDEX:
        raise ValueError(f"the observation's {P} x {F0} target features pass OB's {FT_INDEX}")
    codes = [(_column_bit(c[3], c[4]) << 28) | (t << 20) | (t * F0 + j)
             for t in range(P) for j, c in enumerate(cols)]
    codes += [FT_OTHER | (FT_VIEWER << 29) | p for p in range(P)]
    codes += [FT_OTHER | (FT_PHASE << 29) | i for i in range(NP)]
    codes.append(FT_OTHER | (FT_ALIVE << 29))
    return np.asarray(codes, np.uint32)
# rooms a block of the g++ build (the card's: ob_plan's, by the batch and the card)
HOST_ROOMS_PER_BLOCK = 3
SAMPLE_MODES = {"uniform": 0, "gumbel": 1, "greedy": 2}


def ob_table(lowered: Lowered) -> np.ndarray:
    """The game's facts OB needs beyond the blob, as int32: a header, a
    column a target's feature (source bank, slot, one-hot code, visibility,
    whether a reveal flag makes it public), a row a phase (who-acted is
    public, choice kind, choice max, is an action, target predicate), the
    game-over's team codes and the code of each feature of a viewer's row
    (feature_codes). The same derivations as observe_plain,
    legal_action_mask_plain, actor_mask_plain and
    ppo.terminal_rewards_plain."""
    lay = lowered.game.layout
    P, NP = lowered.P, lowered.NP
    vis = N.field_visibility(lowered)
    reveal_slot = -1
    for f in lowered.game.spec.declaration.fields:
        if N._REVEAL_RE.search(f.name):
            rs = lay.get(f.name)
            if rs is not None and rs.bank == "bool":
                reveal_slot = rs.index
                break
    cols = []
    for f in N._obs_fields(lowered):
        s = lay.slot(f.name)
        v = vis.get(f.name, N.VIS_PUBLIC)
        reveal = int(reveal_slot >= 0 and f.name in ("role", "team"))
        if s.bank == "bool":
            cols.append((SRC_BOOL, s.index, 0, v, reveal))
        elif s.bank == "num":
            cols.append((SRC_NUM, s.index, 0, v, reveal))
        elif s.bank == "str":
            cols += [(SRC_STR, s.index, code, v, reveal) for code in range(max(2, len(s.vocab)))]
    cols += [(SRC_ACTED, 0, 0, VIS_ACTED, 0), (SRC_ALIVE, 0, 0, N.VIS_PUBLIC, 0)]
    F0 = len(cols)
    if F0 != N._per_player_dim(lowered):
        raise AssertionError(f"OB's {F0} columns a target differ from the observation's "
                             f"{N._per_player_dim(lowered)}")
    team = lay.get("team")
    team_slot = team.index if team is not None and team.bank == "str" else -1
    code = N.minority_team_code(lowered)
    pub = N._phase_public_acting(lowered)
    n_preds = len(lowered.preds)
    phases = []
    for i in range(NP):
        pi = int(lowered.phase_target_pred[i])
        if not 0 <= pi < n_preds:
            raise ValueError(f"phase {i}'s target predicate {pi} is not one of {n_preds}")
        phases.append((int(pub[i]), int(lowered.choice_kind[i]), int(lowered.choice_max[i]),
                       int(lowered.phase_is_action[i] != 0), pi))
    rw_mode, rw_slot, codes = reward_rule(lowered)
    codes = [int(c) for c in codes]
    head = np.zeros(HDR, np.int64)
    head[[T_P, T_NP, T_F0, T_F, T_A]] = P, NP, F0, N.obs_dim(lowered), N.action_space(lowered)
    head[[T_TEAM_SLOT, T_MINORITY, T_HAS_MINORITY]] = team_slot, code or 0, code is not None
    head[[T_REVEAL_SLOT, T_ALIVE_BOOL]] = reveal_slot, lowered.alive_bool
    head[[T_NB, T_NN, T_NS]] = (len(lowered.bool_defaults), len(lowered.num_defaults),
                                len(lowered.str_defaults))
    head[[T_RW_MODE, T_RW_TEAM_SLOT, T_N_CODES]] = rw_mode, rw_slot, len(codes)
    ftab = feature_codes(P, NP, cols)
    head[T_COLS] = HDR
    head[T_PHASES] = HDR + 5 * F0
    head[T_CODES] = head[T_PHASES] + 5 * NP
    head[T_FTAB] = head[T_CODES] + len(codes)
    head[T_LEN] = head[T_FTAB] + len(ftab)
    out = np.concatenate([head, np.asarray(cols, np.int64).reshape(-1),
                          np.asarray(phases, np.int64).reshape(-1), np.asarray(codes, np.int64),
                          ftab.view(np.int32).astype(np.int64)])
    return out.astype(np.int32)


def _tables(lowered: Lowered, device) -> tuple:
    """(ob_table on `device`, on the host), built and copied once per
    (game, card) and cached with the game's tables."""
    tabs = tables(lowered, device)
    if "ob_table" not in tabs:
        host = ob_table(lowered)
        tabs["ob_table"] = (torch.as_tensor(host, device=device), host)
    return tabs["ob_table"]


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def observe_plan(lowered: Lowered, batch: int, device, lib=None) -> tuple:
    """(rooms a block, shared bytes a block) of OB's launch over `batch`
    rooms of the game on `device`'s card: asked of the card once (ob_plan:
    the fewest rooms a block that let one wave hold the launch, at most
    MAX_ROOMS) and cached with the game's tables of that card."""
    device = torch.device(device)
    lib = lib or _build.observe_lib()
    plans = tables(lowered, device).setdefault("observe_plans", {})
    if (batch, lib._name) not in plans:
        _, game_host = _game_arrays(lowered, device)
        _, tab_host = _tables(lowered, device)
        out = np.zeros(4, np.int64)
        with torch.cuda.device(device):  # the card whose SMs and limits are asked
            err = lib.ob_plan(game_host.ctypes.data, tab_host.ctypes.data, len(tab_host), batch,
                              out.ctypes.data)
        if err != 0:
            raise RuntimeError("observation entry plan failed: "
                               + lib.ob_error_string(err).decode())
        plans[batch, lib._name] = (int(out[0]), int(out[1]))
    return plans[batch, lib._name]


def _observe_args(lowered: Lowered, batch: int, device, lib) -> tuple:
    """What every OB launch over `batch` rooms on `device` passes besides
    its tensors: (game on the card and the host, table on the card and the
    host, its length) and (rooms a block, shared bytes), cached."""
    cache = lowered.__dict__.setdefault("_torch_ob_launch", {})
    key = (batch, device, lib._name)
    if key not in cache:
        game, game_host = _game_arrays(lowered, device)
        tab, tab_host = _tables(lowered, device)
        cache[key] = ((game.data_ptr(), game_host.ctypes.data, tab.data_ptr(),
                       tab_host.ctypes.data, len(tab_host)),
                      observe_plan(lowered, batch, device, lib))
    return cache[key]


def _launch_observe(lowered: Lowered, st: GameState, obs, legal, actor, masked: bool,
                    lib=None) -> None:
    device = st.present.device
    lib = lib or _build.observe_lib()
    tabs, plan = _observe_args(lowered, st.batch, device, lib)
    with on_card(device):
        err = lib.ob_observe(*tabs, state_addresses(lowered, st, "cuda"), _ptr(obs), _ptr(legal),
                             _ptr(actor),
                             st.batch, int(masked), *plan, card_stream(device))
    if err != 0:
        raise RuntimeError("observation entry ob_observe launch failed: "
                           + lib.ob_error_string(err).decode())


def _host_observe(rooms_per_block: int):
    def run(lowered: Lowered, st: GameState, obs, legal, actor, masked: bool) -> None:
        game, _ = _game_arrays(lowered, st.present.device)
        _, tab_host = _tables(lowered, st.present.device)
        err = _build.observe_host_lib().ob_observe_host(
            game.data_ptr(), tab_host.ctypes.data, len(tab_host),
            state_addresses(lowered, st, "cpu"),
            _ptr(obs), _ptr(legal), _ptr(actor), st.batch, int(masked), rooms_per_block)
        if err != 0:
            raise RuntimeError(f"host observation entry failed ({err})")

    return run


def _observe(run, kind: str, lowered: Lowered, state: GameState, masked: bool, obs: bool,
             legal: bool, actor: bool) -> tuple:
    st = checked_state(lowered, state, kind, "the observation")
    B, P = st.present.shape
    dev = st.present.device
    tab = _tables(lowered, dev)[1]
    out = (torch.empty((B, P, int(tab[T_F])), dtype=torch.bfloat16, device=dev) if obs else None,
           torch.empty((B, P, int(tab[T_A])), dtype=torch.bool, device=dev) if legal else None,
           torch.empty((B, P), dtype=torch.bool, device=dev) if actor else None)
    if B and any(x is not None for x in out):
        run(lowered, st, *out, masked)
    return out


def _launch_rewards(lowered: Lowered, st: GameState, ended, reward) -> None:
    device = st.present.device
    tab, tab_host = _tables(lowered, device)
    lib = _build.observe_lib()
    with on_card(device):
        err = lib.ob_rewards(tab.data_ptr(), tab_host.ctypes.data, len(tab_host),
                             state_addresses(lowered, st, "cuda"), ended.data_ptr(),
                             reward.data_ptr(), st.batch,
                             card_stream(device))
    if err != 0:
        raise RuntimeError("observation entry ob_rewards launch failed: "
                           + lib.ob_error_string(err).decode())


def _host_rewards(lowered: Lowered, st: GameState, ended, reward) -> None:
    _, tab_host = _tables(lowered, st.present.device)
    err = _build.observe_host_lib().ob_rewards_host(
        tab_host.ctypes.data, len(tab_host), state_addresses(lowered, st, "cpu"), ended.data_ptr(),
        reward.data_ptr(), st.batch)
    if err != 0:
        raise RuntimeError(f"host rewards entry failed ({err})")


def _rewards(run, kind: str, lowered: Lowered, state: GameState, ended) -> torch.Tensor:
    st = checked_state(lowered, state, kind, "the terminal rewards")
    B, P = st.present.shape
    dev = st.present.device
    ended = rooms_arg(ended, "ended", (B,), torch.bool, dev)
    reward = torch.empty((B, P), dtype=torch.float32, device=dev)
    if B:
        run(lowered, st, ended, reward)
    return reward


def _sample(kind: str, logits, legal, noise, actor, mode: str, run) -> tuple:
    if mode not in SAMPLE_MODES:
        raise ValueError(f"mode must be one of {sorted(SAMPLE_MODES)}, got {mode!r}")
    if not isinstance(logits, torch.Tensor) or logits.device.type != kind or logits.dim() < 1:
        raise ValueError(f"the sampling takes {'CUDA' if kind == 'cuda' else 'CPU'} logits, "
                         f"got {logits.device if isinstance(logits, torch.Tensor) else logits}")
    dev, shape = logits.device, tuple(logits.shape)
    logits = rooms_arg(logits, "logits", shape, torch.float32, dev)
    legal = rooms_arg(legal, "legal", shape, torch.bool, dev)
    greedy = mode == "greedy"
    if greedy:
        if noise is not None:
            raise ValueError("the greedy mode takes no noise")
    else:
        noise = rooms_arg(noise, "noise", shape, torch.float32, dev)
    if actor is not None:
        actor = rooms_arg(actor, "actor", shape[:-1], torch.bool, dev)
    # the three outputs are rows of one int32 buffer: one allocation a call
    out = torch.empty((3,) + shape[:-1], dtype=torch.int32, device=dev)
    actions = out[0]
    masked = out[1] if actor is not None or greedy else None
    logp = None if greedy else out[2].view(torch.float32)
    rows, A = actions.numel(), shape[-1]
    if rows:
        run(logits.data_ptr(), legal.data_ptr(), _ptr(noise), _ptr(actor), actions.data_ptr(),
            _ptr(masked), _ptr(logp), rows, A, SAMPLE_MODES[mode], dev)
    return actions, masked, logp


def _launch_sample(*args) -> None:
    *args, device = args
    lib = _build.observe_lib()
    with on_card(device):
        err = lib.ob_sample(*args, card_stream(device))
    if err != 0:
        raise RuntimeError("sampling entry ob_sample launch failed: "
                           + lib.ob_error_string(err).decode())


def _host_sample(*args) -> None:
    err = _build.observe_host_lib().ob_sample_host(*args[:-1])
    if err != 0:
        raise RuntimeError(f"host sampling entry failed ({err})")


def kernel_observe(lowered: Lowered, state: GameState, masked: bool = True, obs: bool = True,
                   legal: bool = True, actor: bool = True) -> tuple:
    """(obs (B, P, F) bf16, legal (B, P, A) bool, actor (B, P) bool) of every
    room in one OB launch, each None unless asked for: net.observe_plain
    (the masked view, or the full room with masked=False),
    net.legal_action_mask_plain and net.actor_mask_plain, bit for bit. CUDA
    tensors only."""
    with span("ge.entry.OB"):
        out = _observe(_launch_observe, "cuda", lowered, state, masked, obs, legal, actor)
        kernel_observe.launches += state.batch > 0 and (obs or legal or actor)
        return out


def kernel_rewards(lowered: Lowered, state: GameState, ended: torch.Tensor) -> torch.Tensor:
    """(B, P) f32 terminal rewards of the state after a step in OB's second
    mode (one launch): ppo.terminal_rewards_plain, bit for bit. CUDA
    tensors only."""
    with span("ge.entry.OB"):
        out = _rewards(_launch_rewards, "cuda", lowered, state, ended)
        kernel_rewards.launches += state.batch > 0
        return out


def kernel_sample(logits: torch.Tensor, legal: torch.Tensor, noise: torch.Tensor | None = None,
                  actor: torch.Tensor | None = None, mode: str = "uniform") -> tuple:
    """SA over (..., A) f32 logits and their legal mask, in one launch ->
    (actions (...,) int32 1-based: the first argmax of the legal-masked
    logits plus the noise; the actor-masked actions, where(actor, actions,
    0), or None without `actor`; logp (...,) f32, log_softmax of the masked
    logits at the action). mode "uniform": `noise` holds torch.rand's
    uniforms, turned into Gumbel noise as net.gumbel_noise turns them;
    "gumbel": the noise as it is; "greedy": no noise, no logp, and the
    masked actions are also 0 where no choice is legal (PolicyBots.greedy
    with actor = present). CUDA tensors only."""
    with span("ge.entry.SA"):
        out = _sample("cuda", logits, legal, noise, actor, mode, _launch_sample)
        kernel_sample.launches += out[0].numel() > 0
        return out


kernel_observe.launches = 0
kernel_rewards.launches = 0
kernel_sample.launches = 0


def host_observe(lowered: Lowered, state: GameState, masked: bool = True, obs: bool = True,
                 legal: bool = True, actor: bool = True,
                 rooms_per_block: int = HOST_ROOMS_PER_BLOCK) -> tuple:
    """kernel_observe's block body built with g++, blocks of
    `rooms_per_block` rooms. CPU tensors only."""
    return _observe(_host_observe(rooms_per_block), "cpu", lowered, state, masked, obs, legal,
                    actor)


def host_rewards(lowered: Lowered, state: GameState, ended: torch.Tensor) -> torch.Tensor:
    """kernel_rewards's body built with g++. CPU tensors only."""
    return _rewards(_host_rewards, "cpu", lowered, state, ended)


def host_sample(logits: torch.Tensor, legal: torch.Tensor, noise: torch.Tensor | None = None,
                actor: torch.Tensor | None = None, mode: str = "uniform") -> tuple:
    """kernel_sample's body built with g++. CPU tensors only."""
    return _sample("cpu", logits, legal, noise, actor, mode, _host_sample)



# observe.cuh OBS_*: the copy in's issue, its wait (the table, the predicate
# sections, the rooms' fields), stage 1 (the actor mask and what the
# observation is made of), stage 2 (the legal mask and the observation
# written)
OB_SECTIONS = ("issue", "copy", "rooms", "write")


def profile_observe(lowered: Lowered, state: GameState) -> dict:
    """A measuring tool: one OB launch (the masked observation and both
    masks) through the -DGE_PROFILE build -> {section of OB_SECTIONS:
    clock64() cycles summed over the blocks}, a block's sections timed by
    its first thread between barriers. Not counted in
    kernel_observe.launches. CUDA tensors only."""
    lib = _build.observe_profile_lib()
    prof = torch.zeros(len(OB_SECTIONS), dtype=torch.int64, device=state.present.device)
    with torch.cuda.device(prof.device):
        lib.ob_observe_sections(prof.data_ptr())
        try:
            _observe(lambda *a: _launch_observe(*a, lib=lib), "cuda", lowered, state, True,
                     True, True, True)
        finally:
            lib.ob_observe_sections(None)
    return dict(zip(OB_SECTIONS, prof.tolist()))
