"""Host side of the CUDA search kernels (csrc/search.cu).

The lookahead search bots (policies/search.py) score each legal choice of a
deciding seat by rolling scripted continuations of the whole room: the C++
search of the JAX package's native simulator (native/gamesim.cpp
``search_scores_core``, ``gs_room_search``). Rollout k of a candidate runs
the room reseeded from splitmix32(salt ^ t·0x85EBCA6B ^ 0x9E3779B9·(k+1))
(t: the room's step) for up to ``horizon`` steps of the scripted bots and
the engine step, with the seat's first action forced to the candidate, and
scores 0 unless done, else by ``Scoring``: team mode +1 when the seat's
final team is the winner's, else -1; score mode n-1 when the seat won, else
-1. A seat takes the first strictly greatest total in ascending candidate
order.

Two entries. ``kernel_decide`` makes the full-information decisions of a
batch of rooms on the card in one launch: which seats wait, their
candidates, the rollouts and the argmax, from the rooms and a salt, with no
round trip to the host (counts ``kernel_decide.launches``);
``kernel_decide_arrays`` does so for one room's fields held on the host,
sent in one copy. ``kernel_search`` scores a table of requests, one int32
row of ``REQ_INTS`` each: {source room, seat (0-based), candidate, salt},
a request's total the sum over its ``rollouts`` rollouts (one launch for
the whole table; counts ``kernel_search.launches``);
``kernel_search_arrays`` launches it on rooms held on the host as numpy
arrays, sent to the card with the table in one copy. Both run a persistent
grid whose groups of lanes pull rollouts from a device counter.

``host_decide`` and ``host_search`` run the kernels' bodies built by g++ on
CPU tensors (the CPU tests' route to the kernels' logic);
``search_scores_plain`` is the plain version in eager torch;
``count_search`` counts the interpreter's operations (the -DGE_COUNT build),
for the kernels' bound, and each rollout's steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from game_engine_tpu_torch import _build
from game_engine_tpu_torch.core import rollout_kernel as RK
from game_engine_tpu_torch.core.engine import scripted_actions
from game_engine_tpu_torch.core.state import M32, GameState, tables
from game_engine_tpu_torch.core.step import GOLDEN, MIX, make_step, mul32, splitmix32
from game_engine_tpu_torch.gamespec.tables import Lowered

REQ_INTS = 4         # room_step.cuh REQ_INTS: source room, seat, candidate, salt
THREADS = 128        # lanes a block asked of the launch (csrc/launch_plan.cuh halves it to fit)
MODE_TEAM, MODE_SCORE = 1, 2
STATS = ("decisions", "requests", "rollouts")  # Decided.stats: waiting seats, candidates
#                                                searched, rollouts run


class Scoring(NamedTuple):
    """How a finished rollout is scored for the deciding seat."""
    mode: int        # MODE_TEAM or MODE_SCORE
    team_slot: int   # the team string's slot (team mode), else -1
    team_codes: tuple  # the teams' codes by winner - 1 (team mode)


def scoring(lowered: Lowered) -> Scoring:
    """The game's terminal reward as search scores it (the JAX SearchBots'
    rule); ValueError for a game with no searchable terminal rule."""
    go = lowered.game_overs[0] if lowered.game_overs else None
    if go is None:
        raise ValueError(
            f"game {lowered.game.spec.name!r} declares no terminal "
            "winner rule (LGameOver) — search has nothing to optimize; "
            "serve scripted or learned bots instead")
    if go.mode == "team" and go.team_str_slot >= 0 and go.team_codes:
        return Scoring(MODE_TEAM, int(go.team_str_slot), tuple(int(c) for c in go.team_codes))
    if go.mode in ("score", "survivor"):  # both pay a 1-based winning seat
        return Scoring(MODE_SCORE, -1, ())
    raise ValueError(
        f"game {lowered.game.spec.name!r} terminal mode "
        f"{go.mode!r} carries no per-seat reward to search for")


class Decided(NamedTuple):
    """The full-information decisions of B rooms of P seats."""
    actions: torch.Tensor  # (B, P) int32: each seat's choice, 0 where it has none
    totals: torch.Tensor   # (B * P, C) int64: candidate j's total at decision room * P + seat
    stats: torch.Tensor    # (3,) int64 by STATS
    counts: torch.Tensor   # (B, P) int32: each seat's candidates, -1 where it does not wait


def candidates_a_seat(lowered: Lowered) -> int:
    """The most candidates a seat of the game can have (C of Decided.totals):
    a target's alive seats, or an option phase's choices."""
    return max(lowered.P, int(np.max(lowered.choice_max, initial=0)))


def check_requests(lowered: Lowered, requests: np.ndarray, n_sources: int) -> None:
    """Raise ValueError unless `requests` is an (n, REQ_INTS) integer table
    of source rooms in [0, n_sources), seats in [0, P) and candidates >= 1."""
    if requests.ndim != 2 or requests.shape[1] != REQ_INTS:
        raise ValueError(f"requests have shape {requests.shape}, expected (n, {REQ_INTS})")
    if len(requests) and not (
            (0 <= requests[:, 0]).all() and (requests[:, 0] < n_sources).all()
            and (0 <= requests[:, 1]).all() and (requests[:, 1] < lowered.P).all()
            and (requests[:, 2] >= 1).all()):
        raise ValueError("a request names no source room, no seat of the game or no choice")


def _request_rows(rows) -> np.ndarray:
    """(source, seat, candidate, salt) rows as the int32 table (the salt's
    uint32 bits)."""
    a = np.array(rows, np.int64).reshape(-1, REQ_INTS)
    a[:, 3] = (a[:, 3] & M32).astype(np.uint32).view(np.int32)
    return a.astype(np.int32)


def request_table(rows, device) -> torch.Tensor:
    """(source, seat, candidate, salt) rows as the int32 table on `device`
    (the salt's uint32 bits), in one host-to-device copy."""
    return torch.as_tensor(_request_rows(rows), device=device)


def minor_arrays(lowered: Lowered, fields: dict) -> list:
    """rollout_kernel.to_minor on the host: GameState fields as numpy arrays
    (W, ...) -> the kernel's int32 buffers in to_minor's order and layout.
    Raises ValueError unless the fields have this game's shapes."""
    lay = lowered.game.layout
    W, P = np.shape(fields["present"])
    want = {"bools": (W, P, lay.n_bool), "nums": (W, P, lay.n_num), "strs": (W, P, lay.n_str),
            "pdict": (W, P, max(1, lay.n_pdict), P), "odict": (W, P, max(1, lay.n_odict)),
            "present": (W, P), "acted": (W, P), "choice": (W, P), "choice_phase": (W, P)}
    if P != lowered.P:
        raise ValueError(f"rooms have P={P} seats; the game has P={lowered.P}")
    for name in GameState._fields:
        if np.shape(fields[name]) != want.get(name, (W,)):
            raise ValueError(f"field {name} has shape {np.shape(fields[name])}, "
                             f"expected {want.get(name, (W,))}")
    f = {k: np.asarray(v).astype(np.int32) for k, v in fields.items() if k != "seed"}
    seed = (np.asarray(fields["seed"]).astype(np.int64) & M32).astype(np.uint32).view(np.int32)
    return [f["bools"].transpose(2, 1, 0), f["nums"].transpose(2, 1, 0),
            f["strs"].transpose(2, 1, 0), f["pdict"].transpose(2, 1, 3, 0),
            f["odict"].transpose(2, 1, 0), f["present"].T,
            np.stack([f["acted"].T, f["choice"].T, f["choice_phase"].T]),
            np.stack([f["phase"], f["prev_phase"], f["done"], f["winner"], f["t"], seed])]


def _codes(lowered: Lowered, sc: Scoring, device) -> torch.Tensor:
    tabs = tables(lowered, device)
    key = ("search_codes", sc.team_codes)
    if key not in tabs:
        tabs[key] = torch.as_tensor(np.asarray(sc.team_codes or (0,), np.int32), device=device)
    return tabs[key]


def game_arrays(lowered: Lowered, device) -> tuple:
    """(the checked game array on `device`, the same array in numpy), the
    game checked against the search library that will run it (building it
    now: a failed build raises)."""
    tabs = tables(lowered, device)
    if "search_game" not in tabs:
        lib = (_build.search_lib() if torch.device(device).type == "cuda"
               else _build.search_host_lib())
        RK.check_game(lowered, lib)
        host = np.ascontiguousarray(RK.game_array(lowered))
        tabs["search_game"] = (torch.as_tensor(host, device=device), host)
    return tabs["search_game"]


def _check(lowered: Lowered, source: GameState, requests: torch.Tensor,
           rollouts: int, horizon: int, device_type: str) -> None:
    dev = source.present.device
    if dev.type != device_type:
        raise ValueError(f"expected {device_type} tensors, got {dev}")
    RK.check_state(lowered, source)
    if requests is not None and (
            requests.device != dev or requests.dtype != torch.int32 or requests.dim() != 2
            or requests.shape[1] != REQ_INTS or not requests.is_contiguous()):
        raise ValueError(f"requests must be a contiguous int32 (n, {REQ_INTS}) tensor on {dev}")
    if rollouts < 1 or horizon < 0:
        raise ValueError(f"rollouts={rollouts}, horizon={horizon}")


def _args(lowered: Lowered, sc: Scoring, bufs: list, B: int, req: int, n_req: int,
          rollouts: int, horizon: int, totals: torch.Tensor) -> list:
    """The entry's arguments after the game: the B source rooms' minor
    buffers and the n_req requests (addresses), the search, the totals."""
    codes = _codes(lowered, sc, totals.device)
    return bufs + [B, req, n_req, rollouts, horizon, sc.mode, sc.team_slot, codes.data_ptr(),
                   codes.numel(), totals.data_ptr()]


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"search kernel {what} failed: " + lib.ge_error_string(err).decode())


def _launch(lowered: Lowered, sc: Scoring, bufs: list, B: int, req: int, n_req: int,
            rollouts: int, horizon: int, device) -> torch.Tensor:
    """One launch of the request kernel over buffers on `device` -> the
    totals."""
    totals = torch.zeros(n_req, dtype=torch.int64, device=device)
    counter = torch.empty(1, dtype=torch.int64, device=device)
    game, game_host = game_arrays(lowered, device)
    lib = _build.search_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ge_search(game.data_ptr(), game_host.ctypes.data, game.numel(),
                            *_args(lowered, sc, bufs, B, req, n_req, rollouts, horizon, totals),
                            counter.data_ptr(), THREADS, 0, stream)
    _raise(lib, err, "launch")
    kernel_search.launches += 1
    return totals


def _launch_decide(lowered: Lowered, sc: Scoring, bufs: list, B: int, rollouts: int,
                   horizon: int, salt: int, device, lanes: int = 0, lib=None,
                   prof=None) -> Decided:
    """One launch of the decide kernel over B rooms' buffers on `device`."""
    game, game_host = game_arrays(lowered, device)
    lib = lib or _build.search_lib()
    P, C = lowered.P, candidates_a_seat(lowered)
    scratch = torch.empty(lib.ge_decide_scratch(B, P, C), dtype=torch.int64, device=device)
    actions = torch.empty((B, P), dtype=torch.int32, device=device)
    codes = _codes(lowered, sc, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ge_search_decide(game.data_ptr(), game_host.ctypes.data, game.numel(), *bufs,
                                   B, rollouts, horizon, sc.mode, sc.team_slot, codes.data_ptr(),
                                   codes.numel(), salt & M32, C, actions.data_ptr(),
                                   scratch.data_ptr(), THREADS, lanes,
                                   0 if prof is None else prof.data_ptr(), stream)
    _raise(lib, err, "decide launch")
    kernel_decide.launches += 1
    at = 2 * (5 + B * P * C + 2 * B * P)  # the int32 words after totals, starts, decision
    counts = scratch.view(torch.int32)[at:at + B * P].view(B, P)
    return Decided(actions, scratch[5:5 + B * P * C].view(B * P, C), scratch[1:4], counts)


def kernel_decide(lowered: Lowered, source: GameState, rollouts: int, horizon: int,
                  sc: Scoring, salt: int, lanes: int = 0) -> Decided:
    """The full-information decisions of every room of `source` (CUDA
    tensors) in ONE launch of the decide kernel, whose results stay on the
    card: each waiting seat's candidates, their rollouts and the argmax,
    the base salt of a room _mix(its seed, salt) (policies/search.py).
    Equal to the C++ search (gs_room_search) seat for seat, and to
    host_decide. `lanes`: lanes a rollout (0 = chosen on the card); raises
    on bad input or a refused launch."""
    _check(lowered, source, None, rollouts, horizon, "cuda")
    arrs = RK.to_minor(source)
    return _launch_decide(lowered, sc, [a.data_ptr() for a in arrs], source.batch, rollouts,
                          horizon, salt, source.present.device, lanes)


kernel_decide.launches = 0


def kernel_decide_arrays(lowered: Lowered, fields: dict, rollouts: int, horizon: int,
                         sc: Scoring, salt: int, device="cuda") -> Decided:
    """kernel_decide over rooms held on the host: `fields`, the GameState
    fields as numpy arrays (W, ...). Their minor buffers go to the card in
    ONE copy, then one launch."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"expected a cuda device, got {device}")
    if rollouts < 1 or horizon < 0:
        raise ValueError(f"rollouts={rollouts}, horizon={horizon}")
    _, ptrs = _one_copy(minor_arrays(lowered, fields), device)
    return _launch_decide(lowered, sc, ptrs, len(fields["phase"]), rollouts, horizon, salt,
                          device)


def profile_decide(lowered: Lowered, source: GameState, rollouts: int, horizon: int,
                   sc: Scoring, salt: int, lanes: int = 0) -> dict:
    """A measuring tool: kernel_decide through the -DGE_PROFILE build, whose
    groups time their rollouts by the card's global timer -> {"busy_share":
    the groups' time in rollouts over groups x the span from the first pull
    to the last exit, "span_ms", "groups", "rollouts"}. CUDA tensors."""
    _check(lowered, source, None, rollouts, horizon, "cuda")
    dev = source.present.device
    prof = torch.tensor([0, 2 ** 63 - 1, 0, 0, 0], dtype=torch.int64, device=dev)
    arrs = RK.to_minor(source)
    _launch_decide(lowered, sc, [a.data_ptr() for a in arrs], source.batch, rollouts, horizon,
                   salt, dev, lanes, _build.search_profile_lib(), prof)
    busy, first, last, groups, runs = prof.tolist()
    span = max(last - first, 1)
    return {"busy_share": busy / (max(groups, 1) * span), "span_ms": span / 1e6,
            "groups": groups, "rollouts": runs}


def _one_copy(parts: list, device) -> tuple:
    """numpy int32 arrays -> (one tensor on `device` holding them all, in one
    copy; the address of each)."""
    flat = torch.as_tensor(np.concatenate([np.ravel(p) for p in parts]), device=device)
    at, ptrs = 0, []
    for p in parts:
        ptrs.append(flat.data_ptr() + 4 * at)
        at += p.size
    return flat, ptrs


def kernel_search(lowered: Lowered, source: GameState, requests: torch.Tensor,
                  rollouts: int, horizon: int, sc: Scoring) -> torch.Tensor:
    """Every request's total in ONE launch of the CUDA search kernel ->
    (n,) int64 on the card. CUDA tensors only; raises on bad input or a
    refused launch. Equal to search_scores_plain and host_search. The
    request rows stay on the card unread (check_requests checks them where
    they are built); a row out of range scores 0."""
    _check(lowered, source, requests, rollouts, horizon, "cuda")
    device = source.present.device
    if requests.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    arrs = RK.to_minor(source)
    return _launch(lowered, sc, [a.data_ptr() for a in arrs], source.batch,
                   requests.data_ptr(), requests.shape[0], rollouts, horizon, device)


kernel_search.launches = 0


def kernel_search_arrays(lowered: Lowered, fields: dict, requests, rollouts: int,
                         horizon: int, sc: Scoring, device="cuda") -> torch.Tensor:
    """kernel_search over source rooms held on the host: `fields`, the
    GameState fields as numpy arrays (W, ...), and `requests`, the rows
    naming them. The rooms' minor buffers and the request table go to the
    card in ONE copy, then one launch -> (n,) int64 on the card. Nothing
    else runs on the card: callers whose rooms live on the host (the search
    bots: a server's host mirror, a native room, sampled worlds) pay one
    copy, one launch and the totals' copy back. Raises as kernel_search."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"expected a cuda device, got {device}")
    if rollouts < 1 or horizon < 0:
        raise ValueError(f"rollouts={rollouts}, horizon={horizon}")
    parts = minor_arrays(lowered, fields)
    W = len(fields["phase"])
    table = _request_rows(requests)
    check_requests(lowered, table, W)
    if len(table) == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    parts.append(table)
    flat, ptrs = _one_copy(parts, device)
    return _launch(lowered, sc, ptrs[:-1], W, ptrs[-1], len(table), rollouts, horizon, device)


def search_plan(lowered: Lowered, n_rollouts: int) -> dict:
    """How kernel_search's persistent grid over `n_rollouts` rollouts is
    sized on the current card (rollout_kernel.launch_plan's fields and the
    grid's blocks); kernel_decide's is the same at the most rollouts its
    rooms could need, its lanes chosen on the card by the same rule."""
    _, game_host = game_arrays(lowered, torch.device("cuda"))
    out = np.zeros(5, np.int64)
    lib = _build.search_lib()
    _raise(lib, lib.ge_search_plan(game_host.ctypes.data, len(game_host), n_rollouts,
                                   THREADS, out.ctypes.data), "plan")
    threads = int(out[3])
    return {"threads_per_block": threads, "lanes_per_room": int(out[0]),
            "shared_bytes_per_block": int(out[1]), "blocks_per_sm": int(out[2]),
            "warps_per_sm": int(out[2]) * threads // 32, "grid_blocks": int(out[4])}


def _host_run(lib, lowered: Lowered, source: GameState, requests: torch.Tensor,
              rollouts: int, horizon: int, sc: Scoring, steps=None) -> torch.Tensor:
    _check(lowered, source, requests, rollouts, horizon, "cpu")
    check_requests(lowered, requests.numpy(), source.batch)
    totals = torch.zeros(requests.shape[0], dtype=torch.int64)
    if requests.shape[0] == 0:
        return totals
    game, _ = game_arrays(lowered, "cpu")
    arrs = RK.to_minor(source)
    err = lib.ge_search_host(game.data_ptr(), game.numel(),
                             *_args(lowered, sc, [a.data_ptr() for a in arrs], source.batch,
                                    requests.data_ptr(), requests.shape[0], rollouts, horizon,
                                    totals), 0 if steps is None else steps.ctypes.data)
    if err != 0:
        raise RuntimeError(f"host search failed ({err})")
    return totals


def host_decide(lowered: Lowered, source: GameState, rollouts: int, horizon: int,
                sc: Scoring, salt: int, shuffle: int = 0) -> Decided:
    """The decide kernel's stages (room_step.cuh seat_candidates,
    decide_room, decide_rollout, decide_argmax) built with g++ and run on
    the host over every room of `source` (CPU tensors): the rollouts in
    order, or for shuffle != 0 in an order drawn from it. -> Decided."""
    _check(lowered, source, None, rollouts, horizon, "cpu")
    B, P, C = source.batch, lowered.P, candidates_a_seat(lowered)
    actions = torch.zeros((B, P), dtype=torch.int32)
    totals = torch.zeros((B * P, C), dtype=torch.int64)
    stats = torch.zeros(3, dtype=torch.int64)
    counts = torch.zeros((B, P), dtype=torch.int32)
    game, _ = game_arrays(lowered, "cpu")
    codes = _codes(lowered, sc, "cpu")
    arrs = RK.to_minor(source)
    lib = _build.search_host_lib()
    err = lib.ge_search_decide_host(game.data_ptr(), game.numel(),
                                    *[a.data_ptr() for a in arrs], B, rollouts, horizon,
                                    sc.mode, sc.team_slot, codes.data_ptr(), codes.numel(),
                                    salt & M32, C, actions.data_ptr(), totals.data_ptr(),
                                    stats.data_ptr(), counts.data_ptr(), shuffle & M32)
    if err != 0:
        raise RuntimeError(f"host decide failed ({err})")
    return Decided(actions, totals, stats, counts)


def host_search(lowered: Lowered, source: GameState, requests: torch.Tensor,
                rollouts: int, horizon: int, sc: Scoring) -> torch.Tensor:
    """The kernel's per-rollout body (room_step.cuh room_search_rollout)
    built with g++ and run over every request's rollouts on the host ->
    (n,) int64. CPU tensors only."""
    return _host_run(_build.search_host_lib(), lowered, source, requests, rollouts, horizon, sc)


def count_search(lowered: Lowered, source: GameState, requests: torch.Tensor,
                 rollouts: int, horizon: int, sc: Scoring) -> dict:
    """A measuring tool: the host body built with -DGE_COUNT over the
    requests -> rollout_kernel.COUNT_NAMES counts plus "int_ops", the integer
    operations the interpreter cannot do without on these rollouts, and
    "steps", each rollout's engine steps (numpy int32, request-major). CPU
    tensors only."""
    lib = _build.search_count_lib()
    lib.ge_counts_reset()
    steps = np.zeros(requests.shape[0] * rollouts, np.int32)
    _host_run(lib, lowered, source, requests, rollouts, horizon, sc, steps)
    out = np.zeros(len(RK.COUNT_NAMES), np.int64)
    lib.ge_counts_read(out.ctypes.data)
    counts = dict(zip(RK.COUNT_NAMES, (int(x) for x in out)))
    counts["int_ops"] = int(sum(int(n) * w for n, w in zip(out, RK.COUNT_OPS)))
    counts["steps"] = steps
    return counts


def search_scores_plain(lowered: Lowered, source: GameState, requests: torch.Tensor,
                        rollouts: int, horizon: int, sc: Scoring) -> torch.Tensor:
    """The plain version in eager torch, on the source's device -> (n,)
    int64: each request's source room replicated once a rollout into one
    GameState, reseeded, `horizon` steps of engine.scripted_actions and the
    engine step with [row, seat] = candidate at the first, then scored. A
    done room stays frozen under the step, which equals stopping it."""
    dev = source.present.device
    req = requests.to(device=dev, dtype=torch.int64)
    n = req.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    owner = torch.arange(n, device=dev).repeat_interleave(rollouts)
    k = torch.arange(rollouts, device=dev).repeat(n)
    seat, cand = req[owner, 1], req[owner, 2]
    state = GameState(*(f.index_select(0, req[owner, 0]) for f in source))
    t = state.t.to(torch.int64) & M32
    state = state._replace(seed=splitmix32((req[owner, 3] & M32) ^ mul32(t, MIX)
                                           ^ mul32(k + 1, GOLDEN)))
    rows = torch.arange(owner.numel(), device=dev)
    step = make_step(lowered)
    for s in range(horizon):
        actions = scripted_actions(lowered, state)
        if s == 0:
            actions[rows, seat] = cand.to(torch.int32)
        state = step(state, actions)
        if s % 8 == 7 and bool(state.done.all()):
            break  # every room has stopped
    if sc.mode == MODE_TEAM:
        codes = torch.as_tensor(sc.team_codes, dtype=torch.int64, device=dev)
        wi = (state.winner.to(torch.int64) - 1).clamp(0, len(sc.team_codes) - 1)
        team = state.strs[rows, seat, sc.team_slot].to(torch.int64)
        won = torch.where(team == codes[wi], 1, -1)
    else:
        n_seats = state.present.sum(1)
        won = torch.where(state.winner.to(torch.int64) == seat + 1, n_seats - 1, -1)
    score = torch.where(state.done, won, 0).to(torch.int64)
    return torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, owner, score)
