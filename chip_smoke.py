#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --multichip     (four cards: the multi-device slice)

Drives the port's paths through the hand-written CUDA kernels, which it
builds from csrc/ first (the league, the pipelined learner, the matchup
evaluator, the arena and the exploit probe are listed with the phases):

- the engine: BatchedEngine(werewolf, "cuda").rollout, the batched
  scripted-bot rollout with auto-reset, 1024 steps per call at 4096 and
  65,536 rooms of 8 seats, through the rollout kernel (K1: a room on a group
  of lanes, a seat a lane, its words in shared memory sized to the game);
- the learner: game_engine_tpu_torch.train.run.main, PPO self-play of the
  full-width attn net (docs/checkpoints/attn_werewolf_u120.npz) on 4096
  werewolf rooms, through the policy-net kernels, all three pipelines of
  tensor-core products (csrc/lossgrad.cu): the forward (K2) in the unroll,
  the one-pass PPO loss-grad (K4) in the update, and the backward (K3) in
  one more update with fused_loss=False.

Phases, one JSON line each:

  env             torch/CUDA versions and the GPU's name and power limit
  build           nvcc builds of csrc/rollout.cu, lossgrad.cu, search.cu
                  and chat_decode.cu, in parallel
                  (one nvcc each, started together): seconds and ptxas
                  reports (K1's and S's registers, stack and spill bytes
                  also as numbers, for the builds of rooms of up to 32
                  seats and of wider ones, and each of LM's three kernels')
  compare         K1 vs the plain-torch rollout on the same CUDA inputs, all
                  15 GameState fields and the episode count, exact: werewolf
                  4096x8 (256 steps) at 128, 64 and 256 lanes a block,
                  two-truths 1024x4 and harbor-lots 8192x5 (128 steps),
                  werewolf compiled for 12 seats (4096 rooms, a 16-lane
                  group) and for 20 seats (1024 rooms, a room a warp), one
                  plain run a case whatever the block size; each line has the launch's plan (lanes a room, dynamic shared
                  memory a block, blocks an SM holds) and the kernel's ms;
                  groups of 8, 16 and 32 lanes must all have run
  main            the engine path at both sizes: env-steps/s of the kernel,
                  the launch's plan, and one timed call of the plain version
                  from the same start, whose output must equal the kernel's
                  first call; K1's bound from the interpreter's integer
                  operations on these rooms, counted by the -DGE_COUNT host
                  build of the kernel's body (g++) over the first call
  bench_games     utils/bench_games.py: K1 against the plain rollout on each
                  of its DEFAULT_GAMES at the timed rooms and seeds (4096
                  rooms x 128 steps, all 15 fields and the episode count,
                  exact; bench_games_check, with the launch's lanes a room,
                  which the timed call must share), then each game's rate
                  at the module's defaults (4096 rooms x 1024 steps, the
                  median of 5 calls), one line a game
  engine_step     ST, the engine step entry (csrc/rollout.cu ge_step,
                  ge_reset_done, ge_bots and ge_step_reset, the unroll's
                  step, terminal rewards and reset in one launch, on
                  GameState's own tensors), bit for bit against make_step
                  (then torch.where over the keep mask), reset_where_done,
                  scripted_actions and, for the fused entry, make_step,
                  terminal_rewards_plain and reset_where_done (every
                  field, ended, the winner, the rewards' bits): every
                  catalog game, born-done rooms, werewolf at 40 and 72 seats
                  (the wide build) and the 78-phase game, 1024 rooms of
                  mixed sizes x 16 steps each, on actions no bot emits (0,
                  negative, past P, past the option count, int32's
                  extremes, any seat) mixed with the bots' and a keep mask;
                  every field, `ended` and the dtypes, the differences
                  and the largest |difference| counted on the card; then
                  werewolf at 4096 x 6, 8192 x 4, 16,384 x 3 and 65,536 x 3
                  from rooms spread over its phases by K1, so that 32, 16
                  and 8 lanes a room (the plan's picks for 8 seats) are
                  each held (engine_step_check, each case with its lanes a
                  room). Then its entries' device ms at 4096 and 65,536
                  werewolf rooms spread over the game's phases by K1 (each
                  launch queued behind a sleep kernel, CUDA events, median
                  of 5; and a call's span from an idle queue) beside the
                  plain versions' alike, the fused entry beside the step,
                  OB's rewards and the reset as three launches, the timed
                  calls' outputs held against the plain ones and their
                  lanes a room against the checked launches', the host us
                  a call (the step; the fused entry into a spare state, as
                  the unrolls call it; the three launches), the step's
                  bound (the -DGE_COUNT host build's integer operations on
                  that step, or the state's bytes in and out), and the
                  four wrappers under sync debug mode "error". ST's
                  launches are counted by path and entry (learner,
                  train_narrow, large_rooms, serving, serve_search,
                  eval_search, league, pipeline, matchup, multidevice,
                  policy_bench, serve_chat; each must launch it, and the
                  unroll paths a step_reset and no reset or OB rewards
                  launch of their own); the pipeline phase names the line
                  of every host wait of an unroll step, none in ST's
                  wrappers. With --profile, entry_sections: ST's fused
                  entry, step and reset and OB split by section of a block
                  (the -DGE_PROFILE builds' clock64() marks) at 4096 and
                  65,536 rooms; unroll_split: one train-unroll step at 4096
                  rooms by op under torch.profiler (observe, sample_actions
                  with K2, actor_mask, the engine step, terminal_rewards,
                  the reset: launches, host and device ms), on the eager
                  step, on ST and on the unroll as it runs (ST's
                  step_reset)
  compare_policy  K2, K3 and K4 vs their plain versions on observations of
                  a werewolf trajectory collected on the card (4096 rooms),
                  for the attn checkpoint and a deepsets net at hidden 256
                  (the tensor-core route): K2 (fused_forward_plain) and K3
                  (autograd through it, seeded dl/dv) on 32,768 rows, K4
                  timed on a 4-step slice (131,072 rows) against ppo_loss's
                  loss over the plain K2 + autograd, and its loss and
                  metrics also against ppo_loss + autograd through apply_net
                  (whose gradients, which round cotangents to bf16, are
                  reported); then K4 once at the train path's own shape, all
                  32 steps (1,048,576 rows, 32 chunks) in one call, against
                  the plain version summed over 131,072-row slices.
                  Tolerances of tests/test_fused_net.py, relative to the max
                  |ref|: forward 2e-2, gradients 5e-2, loss 2e-2; metrics
                  5e-2 absolute. With --profile, also the device time by
                  stage (torch.profiler) of one K2 and one K3 call at 32,768
                  rows and one K4 call at 131,072, and K2's time by rows
                  per chunk; and in `main` K1's clock cycles by section of
                  the step (the -DGE_PROFILE build of the kernel)
  compare_narrow  K2, K3 and K4 at widths whose storage the pipelines pad
                  (hidden 48: the trunk; hidden 96: the encoder's hp 48 too),
                  attn and deepsets nets, on the trajectory's first step
                  (32,768 rows) against their plain versions, same
                  tolerances; ms beside plain_ms
  packed_weights  the packed-weight cache across an optimizer step: K2
                  before and after one K4 update of the attn checkpoint must
                  differ, each must match plain on the parameters of that
                  moment, and repeated calls in between must pack nothing
  large_rooms     past the bounds the kernels had (32 seats, 63 phases, 16
                  condition nodes, 64 actions, 32 trunk layers), each case
                  on the kernels' own route: large_rooms_k1, K1 on werewolf
                  compiled for 40 and 72 seats (full rooms: the wide build,
                  a room on 32 lanes) and on bench_games.long_game (78
                  phases, a 20-node branch condition), exact against plain
                  at 1024 rooms x 128 steps (both timed, and the bound by
                  the -DGE_COUNT host build there), then BatchedEngine at
                  4096 x 1024 (3 timed calls); large_rooms_search, S's
                  decide entry on 40-seat rooms of 37 holding 512
                  decisions (rollouts 2 x horizon 40): the bots' route
                  against the plain route's choices and totals and the C++
                  search's, exact, and the kernel at the serving default
                  (32 x 200); large_rooms_policy, K2, K3 and K4 on 32,768
                  rows of the attn net at hidden 256 on rooms of 40 and 72
                  seats (A = 72) and of a 33-layer attn net at hidden 48,
                  against plain at the compare_policy tolerances;
                  large_rooms_train, one make_train_step update at 40
                  seats (512 rooms, horizon 8, one epoch) through K2 and K4
  train           the learner path: 3 updates of run.main at its defaults
                  (4096 rooms, 6 players, horizon 32, 4 epochs) from the attn
                  checkpoint; steps/s and the unroll/update split by CUDA
                  events; 33 tensor-core K2 and 4 K4 launches an update
  train_k3        one more update with fused_loss=False (K2 + K3)
  train_narrow    one update of run.main --hidden 48 (attn): its fused_net
                  event names K4, and it launches 33 K2 and 4 K4
  train_plain     one update of run.main with --no-fused (no kernel), for
                  the end-to-end comparison
  serve_scripted  the server: the port's HTTP game host (server/api.py on
                  the torch backend, journaling on) started in-process on
                  the card and driven for 20 s by utils/load_test.py's
                  Client at its default shape (200 werewolf rooms, 8
                  clients; the slot pool grows 64 -> 128 -> 256), one
                  add-bot a room (4 seats: the client's and 3 scripted
                  bots): requests/s, games/min, continue_ms
                  p50/p90/p99 and the engine steps behind them; 0 errors
  serve_policy    the same with --bots-per-room 5 (add-bot fills a room to
                  the game's minimum, so a room is still 4 seats: the
                  client's and 3 bots) and every bot seat on
                  greedy PolicyBots from the attn checkpoint, whose forward
                  is K2 on the tensor cores (launches > 0, all that route);
                  then three checks: (a) on the live states of the last
                  step K2's greedy actions equal the plain version's
                  wherever the top two legal logits are more than 1e-3
                  apart, its logits within 2e-2; (b) eight rooms of each
                  run restored from their journals into a fresh host on the
                  card give snapshot_state bit for bit; (c) eight scripted
                  rooms' journals replay on a CPU host to the same
                  snapshot_state. Also where a step of the server spends
                  its time (engine step, policy forward, host read) and K2
                  alone at 64-2048 rows: device time (the call's kernels
                  back to back behind a sleep kernel, CUDA events; its
                  launches from torch.profiler's trace, which holds the
                  ctypes entries' own), time on the card's clock (CUDA
                  events) and host time to enqueue, kept apart

  compare_search  the search kernels (S, csrc/search.cu) against their
                  plain versions on the card and against the port's C++
                  search on the host (CppRoom.search_scores and search):
                  werewolf, cult-of-the-depths, two-truths-and-a-lie, 64
                  live rooms each at several depths of a scripted rollout,
                  every seat, rollouts 32 x horizon 200. D = 0: the decide
                  entry's choices (the bots' route) against the plain
                  _decide's and the C++ search's, its totals and the
                  request entry's on the same decisions against
                  search_scores_plain and C++; D = 8: the request entry's
                  totals and choices; 0 differences
  search_timing   S by decisions a launch (1, 8, 64, 512, 4096 at D = 0;
                  1, 8, 64 at D = 8) on werewolf rooms: the host ms of
                  actions_for_slots, launches a call (one decide launch at
                  D = 0, one request launch at D = 8), the decide kernel's
                  ms and the request kernel's on the same decisions, the
                  bound by operations and the rollouts' steps (the
                  -DGE_COUNT host build) and the port's C++ search of the
                  same decisions on one host core; with --profile, at 512
                  and 4096 decisions, the decide kernel by lanes a rollout
                  (8, 16, 32) and its share of groups busy (the
                  -DGE_PROFILE build), and the rollouts' steps against a
                  static grid
  serve_search    the serving shape with --bot-search all on the torch
                  backend: the search's launches and its share of a step;
                  8 rooms restored from their journals bit for bit
  serve_native    the same on --backend native: the engine on the host, the
                  search on the card
  eval_search     utils/eval_search.py on the card: werewolf 200 rooms and
                  werewolf 100 rooms at D = 8, rollouts 32 x horizon 200;
                  win rates and decisions must equal the JAX script's
                  (EVAL_JAX)

  league          train/league.py at the learner's shape (attn hidden 256,
                  4096 werewolf rooms of 6, horizon 32, 4 epochs) from
                  docs/checkpoints/attn_werewolf_league_anchor_u600.npz:
                  one snapshot-arm update against
                  attn_werewolf_league_noanchor_u300.npz (65 K2 + 4 K4) and
                  one anchor-arm update (33 K2 + 4 K4), all on the tensor
                  cores, one packing of the weights per parameter state (5
                  and 4), a finite loss, a win rate in [0, 1], moved params;
                  league_sync_step: the sync train step from the same start;
                  league_run_main: run.main --league, 3 updates, a snapshot
                  each (33 or 65 K2 and 4 K4 an update), the last snapshot
                  reloads as the trained params
  pipeline        train/pipeline.py run_pipelined, 3 rounds at the same
                  shape, on two CUDA streams and in serial order from the
                  same start, in turns (serial, two streams, two streams,
                  serial): params and engine state bit for bit equal; each
                  stage's ms alone, each order's ms a call and a round and
                  train env-steps/s; the host's waits for the card in one
                  unroll step (torch's sync debug mode)
  matchup         evaluate.matchup_table over the four shipped attn werewolf
                  checkpoints (16 ordered pairs, 1024 rooms x 64 steps): the
                  K2 route twice (the same table), the plain route from the
                  same seeds, every entry within 3 binomial standard
                  errors; the Elo fits and ms a pair
  arena           utils/arena.py, werewolf, 16 rooms, tiers scripted,
                  search-det8 and the attn checkpoint, twice (the same
                  table): S and K2 (tensor cores) launched
  exploit         utils/eval_exploit.py, 32 rooms, rollouts 32 x horizon 200

  multidevice     the (data, model) mesh of parallel/mesh.py over ranks, at
                  the learner's shape (the attn checkpoint, 4096 werewolf
                  rooms of 6, horizon 32, 4 epochs):
                  multidevice_nccl: make_mesh(1) on a world of one over NCCL;
                  2 updates of the mesh-wrapped train step against the
                  mesh-less step from the same start, bit for bit, each
                  33 K2 + 4 K4 an update.
                  multidevice_dp: one gloo world of 4 processes sharing the
                  card (NCCL refuses two ranks on one card); meshes of its
                  first 1, 2 and 4 ranks each take the first unroll and the
                  first update's gradient (parallel/parity.py first_update):
                  at dp = 2 and 4 the rooms and actions exact against dp = 1
                  (a differing action is reported with its sampling margin),
                  the summed K4 gradients within 5e-2 (the error printed);
                  every rank 33 K2 and 1 K4 on the tensor cores.
                  multidevice_pipeline: train/pipeline.py
                  run_pipelined_sharded, 1 actor + 1 learner rank over gloo,
                  2 rounds, against run_pipelined here, bit for bit.
                  multidevice_dryrun: graft_entry.dryrun_multichip(4), a
                  (2, 2) mesh over gloo, until episodes finish.
                  multidevice_scaling: its curve at 1, 2 and 4 ranks, strong
                  (4096 rooms in all) and weak (1024 a rank), the rollout
                  through K1 (1024 steps a call) and the train step through
                  K2 + K4, with the split of a step into unroll, update,
                  collectives and host waits. Ranks that share one card
                  share its time: the curve measures what sharding costs
  --multichip     builds the kernels, then runs only the multi-device slice
                  over NCCL, one card a rank (rank r on cuda:r), at the same
                  shape; it raises with fewer than 4 cards:
                  multichip_env: every card's name and power limit, NCCL's
                  version, the cards' link (nvidia-smi topo -m where it
                  answers, else nvlink --status; a timed card-to-card
                  copy), the host's CPUs and /dev/shm's size; multichip_ranks: a world of 4
                  whose ranks report their cards and CPU affinity and sum
                  their ranks on the cards.
                  multidevice_dp over NCCL (each rank's K2 and K4 counted
                  on its own card, the four cards all different).
                  multidevice_replicas: 2 updates at dp = 4, every rank's
                  parameters and Adam state bit for bit rank 0's.
                  multidevice_pipeline: 1 actor + 1 learner on two cards
                  bit for bit against run_pipelined, then 1 + 2 on three,
                  its largest relative parameter difference within 5e-2.
                  multidevice_dryrun and multidevice_scaling over NCCL, the
                  curve's collective_ms holding the NCCL kernels' time.
                  Then a multichip_done line with the launches, every
                  card's nvidia-smi line and the last line (count 4)
  policy_bench    bench.py --policy at its defaults (16,384 werewolf rooms x
                  128 steps x 4 iters, the mlp at hidden 256): the
                  learned-policy self-play rate; no kernel on this path

  compare_chat    the chat LM's decode kernels (LM, csrc/chat_decode.cu: the
                  tensor-core prefill of every prompt row, then a cluster of
                  8 blocks a context for the generated tokens) against
                  decode_plain on the card, docs/checkpoints/chat_lm.npz at
                  full width: 64 corpus contexts of unseen rooms (seeds from
                  320) greedy in one call, and 32 of them sampled (T 0.8,
                  top-p 0.9) with salts 0-2 in one call. Tokens equal but
                  where the plain decode's top two logits are within 1e-3
                  (or a sampled draw within 1e-2 of a boundary of its CDF),
                  each such tie reported and counted; the head's logits at
                  the generated positions within 1e-2 of max|ref| (the plain
                  decode with float64 sums moves them by ~4e-3, reported);
                  the launches of each call (2 x layers - 1 prefill + 1)
  chat_timing     one reply: the prefill's and the decode's ms and their sum
                  (CUDA events around each part, median of 5), us a
                  generated position, launches a reply (asserted: 8), the
                  64-context batch's ms (median of 3), the decode's clusters
                  at once and resident layers, the plain decode's ms and
                  its kernel launches (torch.profiler), reply tokens/s, the
                  bound; the kernels' reply equal to plain's. With
                  --profile, the decode's cycles a position by stage
                  (csrc/chat_decode.cu built with -DCD_PROFILE)
  chat_probes     utils/eval_chat_probes.py on the card: composer,
                  student_fb and sampled_fb at ok_rate 1.0, beside the JAX
                  record (docs/chat_probe_eval_r5.json)
  serve_chat      the serving shape for 20 s with --chat-lm and the attn
                  policy bots, and one more client that only chats (closed
                  loop: a greeting, a status and a score question in turn):
                  chat_ms p50/p99, decode launches > 0, 0 errors, no plain
                  decode on the card
  train_chat_lm   train/chat_lm.py --device cuda at the shipped width
                  (d 192, 4 layers, max_len 832, batch 256), 20 steps on the
                  corpus of 8 rooms a game: steps/s, a finite falling loss,
                  the held-out evaluation's replies through the kernel

Then a {"kernels": [...]} line (each kernel's launches on the main paths,
ST's too,
by path in launches_by_path, the ranks' of the multidevice path included,
which of its routes ran there, its error, time, plain version's time and
bound: the larger of its operations over the card's peak for their type and
its bytes over 3.35 TB/s; bf16 at 989 TFLOP/s for K2-K4 and LM's products
(LM's float32 attention at 67 TFLOP/s), int32 at SMs x 64 lanes x the top
SM clock for K1 and S), the nvidia-smi line, and the last line
{"ok": true, "device": {...}}. Any failure raises (nonzero exit). Without a
CUDA device, or outside a checkout of the repository, it exits 2 and prints
no result. Imports nothing of JAX and nothing of the JAX package.
"""

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "game_engine_tpu_torch/csrc/rollout.cu"
REPLACES = "game_engine_tpu/core/pallas_rollout.py:658"
POLICY_SOURCE = {"policy_forward": "game_engine_tpu_torch/csrc/lossgrad.cu",
                 "policy_backward": "game_engine_tpu_torch/csrc/lossgrad.cu",
                 "ppo_loss_grad": "game_engine_tpu_torch/csrc/lossgrad.cu"}
NARROW = (48, 96)  # widths whose storage the pipelines pad: the trunk (48), the encoder too (96)
K2_PER_UPDATE = 33   # the unroll's 32 steps and the bootstrap value
POLICY_REPLACES = {"policy_forward": "game_engine_tpu/policies/fused.py:299",
                   "policy_backward": "game_engine_tpu/policies/fused.py:468",
                   "ppo_loss_grad": "game_engine_tpu/policies/fused.py:600"}
CKPT = "docs/checkpoints/attn_werewolf_u120.npz"
STEPS = 1024
SIZES = (4096, 65536)
ROOMS = 4096          # learner: rooms of the collected trajectory and of training
HORIZON = 32          # and its steps: one epoch of the train path
TOL_FWD, TOL_GRAD, TOL_LOSS, TOL_METRIC = 2e-2, 5e-2, 2e-2, 5e-2
# published peaks of one H100 SXM (dense): bf16 tensor cores, HBM bandwidth
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12
PEAK_F32 = 67e12  # float32 outside the tensor cores
# the server: utils/load_test.py's default shape (rooms, clients), 20 s a run
SERVE_ROOMS, SERVE_CLIENTS, SERVE_SECONDS = 200, 8, 20.0
SERVE_CHECK_ROOMS = 8
K2_SERVE_ROWS = (64, 256, 512, 1024, 2048)
TRAIN_ARGV = ["--device", "cuda", "--arch", "attn", "--hidden", "256", "--batch", str(ROOMS),
              "--players", "6", "--horizon", str(HORIZON), "--epochs", "4", "--updates", "3",
              "--eval-batch", "512", "--resume", CKPT]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_abs_err(a, b, eps_a, eps_b) -> int:
    """Largest |kernel - plain| over every field and the episode count."""
    import torch

    err = abs(int(eps_a) - int(eps_b))
    for x, y in zip(a, b):
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def timed_ms(fn):
    """(result, device milliseconds) of one call, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def ptxas_report(lib) -> list:
    from game_engine_tpu_torch import _build

    return [ln.strip() for ln in _build.build_log(lib).splitlines()
            if "registers" in ln or "stack frame" in ln]


def ptxas_by_kernel(lib, names) -> dict:
    """Registers, stack and spill bytes of each kernel of a library whose
    mangled name holds one of `names`, from the compiler's report."""
    import re

    from game_engine_tpu_torch import _build

    out, current = {}, None
    for ln in _build.build_log(lib).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            current = next((n for n in names if n in m.group(1)), None)
            if current:
                out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[current].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                                spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[current]["registers"] = int(m.group(1))
            current = None
    missing = [n for n in names if "registers" not in out.get(n, {})]
    if missing:
        raise AssertionError(f"no ptxas report of {missing}")
    return out


def mean_ms(fn, reps=3):
    """(result, mean device milliseconds per call) over `reps` calls after
    one warm-up call."""
    out = fn()
    times = []
    for _ in range(reps):
        out, ms = timed_ms(fn)
        times.append(ms)
    return out, statistics.mean(times)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|: the tests' measure of closeness."""
    return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-6))


def abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def policy_macs(d) -> tuple:
    """(forward, backward) multiply-adds a row of the policy net at dims d:
    every product of _fwd_body, and of _grad_body with no gradient for obs."""
    P, F0, hp, H, L, no, T = d.P, d.F0, d.hp, d.hidden, d.layers, d.n_opt, d.trunk_in
    a = 1 if d.has_attn else 0
    heads = H * (hp + no + 1)
    trunk = T * H + (L - 1) * H * H
    enc = P * hp * hp + a * (P * hp * 3 * hp + P * hp * hp)  # w_phi1, w_qkv, w_ao
    fwd = P * F0 * hp + enc + a * 2 * P * P * hp + trunk + heads + P * hp
    bwd = (P * F0 * hp + enc + trunk + heads) + (enc + trunk + heads) \
        + a * 4 * P * P * hp + 2 * P * hp
    return fwd, bwd


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms the card could take, "operations" or "bytes"): the larger
    of the bf16 operations over the tensor-core peak and the bytes over the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check(what: str, err: float, tol: float) -> None:
    if not err < tol:  # also catches NaN
        raise AssertionError(f"{what}: error {err} is not below {tol}")


def collect_trajectory(lowered, params, cfg):
    """A HORIZON-step trajectory of the plain-policy unroll (no kernel) from
    4096 fresh werewolf rooms of 6 players, with GAE advantages and returns:
    the shape of one epoch of the train path."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import ppo as P

    pcfg = P.PPOConfig(horizon=HORIZON, net=cfg)
    state = init_state(lowered, ROOMS, 6, np.arange(ROOMS, dtype=np.uint32) + 99, device="cuda")
    state, traj = P.make_unroll(lowered, pcfg)(params, state,
                                               torch.Generator(device="cuda").manual_seed(5))
    with torch.no_grad():
        _, last_v = N.apply_net(params, N.observe(lowered, state), cfg, lowered)
    adv, ret = P.gae(traj, last_v, pcfg)
    return traj, adv, ret


def compare_k2_k3(d, rows, params, name: str, reps: int = 3) -> tuple:
    """K2 and K3 (seeded dl, dv) on `rows` against their plain versions;
    raises past the tolerances or when a call did not launch its kernel.
    -> (fields of the phase's line, {kernel: {"max_abs_err", "max_rel_err",
    "ms", "plain_ms", "bound": (bound_ms, bound_by)}})."""
    import torch

    from game_engine_tpu_torch.policies import fused as FZ

    gen = torch.Generator(device="cuda").manual_seed(11)
    n = rows.shape[0]
    out, line = {}, {}
    ran = {k: fn.launches for k, fn in (("k2", FZ.kernel_forward), ("k3", FZ.kernel_grads))}

    (lk, vk), ms = mean_ms(lambda: FZ.kernel_forward(d, rows, params), reps)
    (lp, vp), plain_ms = mean_ms(lambda: FZ.fused_forward_plain(d, rows, params), reps)
    errs = (rel_err(lk, lp), rel_err(vk, vp))
    line.update(k2_logits_rel_err=errs[0], k2_value_rel_err=errs[1], k2_ms=ms,
                k2_plain_ms=plain_ms)
    check(f"K2 {name} logits", errs[0], TOL_FWD)
    check(f"K2 {name} value", errs[1], TOL_FWD)
    fwd_mac, bwd_mac = policy_macs(d)
    prm_bytes = 4 * sum(v.numel() for v in params.values())
    b2 = bound(2 * fwd_mac * n, nbytes(rows, lk, vk) + prm_bytes)
    out["policy_forward"] = {"max_abs_err": max(abs_err(lk, lp), abs_err(vk, vp)),
                             "max_rel_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                             "bound": b2}

    dl = torch.randn((n, d.A), generator=gen, device="cuda")
    dv = torch.randn((n,), generator=gen, device="cuda")

    def plain_grads():
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        lo, vo = FZ.fused_forward_plain(d, rows, leaves)
        g = torch.autograd.grad((lo * dl).sum() + (vo * dv).sum(), list(leaves.values()))
        return dict(zip(leaves, g))

    gk, ms = mean_ms(lambda: FZ.kernel_grads(d, rows, dl, dv, params), reps)
    gp, plain_ms = mean_ms(plain_grads, reps)
    errs = {k: rel_err(gk[k], gp[k]) for k in gp}
    line.update(k3_rel_err=errs, k3_ms=ms, k3_plain_ms=plain_ms)
    for k, e in errs.items():
        check(f"K3 {name} d{k}", e, TOL_GRAD)
    b3 = bound(2 * (fwd_mac + bwd_mac) * n, nbytes(rows, dl, dv) + 2 * prm_bytes)
    out["policy_backward"] = {"max_abs_err": max(abs_err(gk[k], gp[k]) for k in gp),
                              "max_rel_err": max(errs.values()), "ms": ms,
                              "plain_ms": plain_ms, "bound": b3}
    for k, fn in (("k2", FZ.kernel_forward), ("k3", FZ.kernel_grads)):
        if fn.launches - ran[k] != reps + 1:
            raise AssertionError(f"{k} {name}: expected {reps + 1} launches, got "
                                 f"{fn.launches - ran[k]}")
    line.update(bounds_ms={"k2": b2[0], "k3": b3[0]})
    return line, out


def policy_compare(lowered, traj, adv, ret, name: str, params, cfg,
                   profiled: bool = False) -> dict:
    """K2, K3 and K4 (the tensor-core route) against their plain versions on
    the card; raises past the tolerances. Returns {kernel: {"max_abs_err",
    "max_rel_err", "ms", "plain_ms", "bound": (bound_ms, bound_by), and
    K4's "epoch_*" check}}."""
    import torch

    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.train import ppo as P

    d = FZ.dims_for(lowered, cfg)
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = traj.obs[0].reshape(-1, d.F).contiguous()  # one step: 4096 rooms x 8 seats
    line = {"phase": "compare_policy", "arch": cfg.arch, "params": name,
            "hidden": cfg.hidden, "plan": FZ.kernel_plan(d), "rows_k2_k3": rows.shape[0]}
    fields, out = compare_k2_k3(d, rows, params, name)
    line.update(fields)
    fwd_mac, bwd_mac = policy_macs(d)
    prm_bytes = 4 * sum(v.numel() for v in params.values())

    # K4 timed on the trajectory's first 4 steps; logp_old moved off the
    # policy's own so that ratios fall on both sides of the clip band
    logp_old = traj.logp + 0.3 * torch.randn(traj.logp.shape, generator=gen, device="cuda")
    epoch = traj._replace(logp=logp_old)
    adv_e, ret_e = adv, ret
    tr = P.Rollout(*(x[:4] for x in epoch))
    adv, ret = adv_e[:4], ret_e[:4]
    pcfg = P.PPOConfig(net=cfg)
    rows4 = FZ._as_rows(d, tr.obs)

    def kernel_loss_grads():
        rowin = FZ._loss_rows(d, tr.legal, tr.actions, tr.logp, adv, ret, tr.mask, pcfg.vf_coef)
        return FZ.kernel_loss_grads(d, rows4, rowin, params, pcfg.clip, pcfg.ent_coef)

    def plain_loss_grads():  # K4's plain version: ppo_loss's loss over the plain K2
        rowin = FZ._loss_rows(d, tr.legal, tr.actions, tr.logp, adv, ret, tr.mask, pcfg.vf_coef)
        return FZ.loss_vg_plain(d, rows4, rowin, params, pcfg.clip, pcfg.ent_coef)

    def ppo_loss_grads():  # ppo_loss + autograd through the plain apply_net
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        loss, metrics = P.ppo_loss(leaves, tr, adv, ret, pcfg, lowered)
        g = torch.autograd.grad(loss, list(leaves.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), dict(zip(leaves, g))

    def loss_and_metrics(stats):
        pg, v, ent, ratio = (float(x) for x in stats)
        return pg + v - pcfg.ent_coef * ent, {"pg_loss": pg, "v_loss": v / pcfg.vf_coef,
                                              "entropy": ent, "ratio_mean": ratio}

    (gk4, sk4), ms = mean_ms(kernel_loss_grads)
    (gp4, sp4), plain_ms = mean_ms(plain_loss_grads)
    ((lx, mx), gx), ppo_ms = mean_ms(ppo_loss_grads)
    lk4, mk4 = loss_and_metrics(sk4)
    lp4, mp4 = loss_and_metrics(sp4)
    loss_err = max(abs(lk4 - ref) / (abs(ref) + 1e-6) for ref in (lp4, float(lx)))
    metric_errs = {k: max(abs(mk4[k] - mp4[k]), abs(mk4[k] - float(mx[k]))) for k in mp4}
    errs = {k: rel_err(gk4[k], gp4[k]) for k in gp4}
    rowin = FZ._loss_rows(d, tr.legal, tr.actions, tr.logp, adv, ret, tr.mask, pcfg.vf_coef)
    b4 = bound(2 * (fwd_mac + bwd_mac) * rows4.shape[0], nbytes(rows4, rowin) + 2 * prm_bytes)
    line.update(rows_k4=rows4.shape[0], k4_loss=lk4, k4_plain_loss=lp4,
                ppo_loss=float(lx), k4_loss_rel_err=loss_err, k4_metrics=mk4,
                k4_plain_metrics=mp4, ppo_loss_metrics={k: float(v) for k, v in mx.items()},
                k4_metric_abs_err=metric_errs, k4_grad_rel_err=errs,
                k4_grad_rel_err_vs_ppo_loss_autograd={k: rel_err(gk4[k], gx[k]) for k in gx},
                plain_grad_rel_err_vs_ppo_loss_autograd={k: rel_err(gp4[k], gx[k]) for k in gx},
                k4_ms=ms, k4_plain_ms=plain_ms, ppo_loss_autograd_ms=ppo_ms,
                bounds_ms={**line["bounds_ms"], "k4": b4[0]})
    if profiled:
        dl, dv = torch.zeros((rows.shape[0], d.A), device="cuda"), torch.ones(
            (rows.shape[0],), device="cuda")
        line["profile"] = {
            "k2": profile(lambda: FZ.kernel_forward(d, rows, params)),
            "k3": profile(lambda: FZ.kernel_grads(d, rows, dl, dv, params)),
            "k4": profile(lambda: FZ.kernel_loss_grads(d, rows4, rowin, params, pcfg.clip,
                                                       pcfg.ent_coef))}
        line["k2_ms_by_chunk_rows"] = k2_chunk_sweep(d, rows, params)
    k4_abs = max(abs_err(gk4[k], gp4[k]) for k in gp4)
    del gk4, gp4, gx

    # K4 at the train path's own shape: the whole epoch's rows in one call
    # (32 chunks, each adding into the same row-split slabs), against the
    # plain version summed in f64 over slices of the timed size. rowin's
    # row weights already hold the epoch's normalisation, so the slices'
    # sums add up to the whole.
    rows_e = FZ._as_rows(d, epoch.obs)
    rowin_e = FZ._loss_rows(d, epoch.legal, epoch.actions, epoch.logp, adv_e, ret_e, epoch.mask,
                            pcfg.vf_coef)
    (ge, se), epoch_ms = timed_ms(lambda: FZ.kernel_loss_grads(
        d, rows_e, rowin_e, params, pcfg.clip, pcfg.ent_coef))
    n4, n_e = rows4.shape[0], rows_e.shape[0]
    gpe = {k: torch.zeros(v.shape, dtype=torch.float64, device="cuda") for k, v in ge.items()}
    spe = torch.zeros(FZ.N_STATS, dtype=torch.float64, device="cuda")
    for at in range(0, n_e, n4):
        g, st = FZ.loss_vg_plain(d, rows_e[at:at + n4], rowin_e[at:at + n4], params,
                                 pcfg.clip, pcfg.ent_coef)
        for k in gpe:
            gpe[k] += g[k]
        spe += st
    lke, mke = loss_and_metrics(se)
    lpe, mpe = loss_and_metrics(spe)
    epoch_loss_err = abs(lke - lpe) / (abs(lpe) + 1e-6)
    epoch_metric_errs = {k: abs(mke[k] - mpe[k]) for k in mpe}
    epoch_errs = {k: rel_err(ge[k], gpe[k]) for k in gpe}
    line.update(rows_k4_epoch=n_e, k4_epoch_ms=epoch_ms, k4_epoch_loss=lke,
                k4_epoch_plain_loss=lpe, k4_epoch_loss_rel_err=epoch_loss_err,
                k4_epoch_metric_abs_err=epoch_metric_errs, k4_epoch_grad_rel_err=epoch_errs)
    emit(line)
    for tag, l_err, m_errs, g_errs in (("", loss_err, metric_errs, errs),
                                       (" epoch", epoch_loss_err, epoch_metric_errs,
                                        epoch_errs)):
        check(f"K4{tag} {name} loss", l_err, TOL_LOSS)
        for k, e in m_errs.items():
            check(f"K4{tag} {name} {k}", e, TOL_METRIC)
        for k, e in g_errs.items():
            check(f"K4{tag} {name} d{k}", e, TOL_GRAD)
    out["ppo_loss_grad"] = {
        "max_abs_err": max(k4_abs, max(abs_err(ge[k], gpe[k]) for k in gpe)),
        "max_rel_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms, "bound": b4,
        "epoch_rows": n_e, "epoch_max_rel_err": max(epoch_errs.values()),
        "epoch_loss_rel_err": epoch_loss_err, "epoch_ms": epoch_ms}
    return out


def profile(call, top=14) -> list:
    """Device milliseconds by kernel name over one call of a kernel wrapper
    (torch.profiler): [(name, ms, launches)], largest first. Each
    elementwise stage is its own each_kernel<lg::Stage> instantiation."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows_ = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us > 0:
            rows_.append((ev.key[:80], us / 1e3, ev.count))
    return sorted(rows_, key=lambda r: -r[1])[:top]


def k2_chunk_sweep(d, rows, params) -> dict:
    """K2's device milliseconds and host milliseconds to enqueue a call, by
    rows per chunk: why fused.FWD_CHUNK_ROWS is what it is."""
    import torch

    from game_engine_tpu_torch.policies import fused as FZ

    out, kept = {}, FZ.FWD_CHUNK_ROWS
    try:
        for chunk in (1024, 4096, 8192, 16384, 32768):
            FZ.FWD_CHUNK_ROWS = chunk
            _, ms = mean_ms(lambda: FZ.kernel_forward(d, rows, params), 5)
            t0 = time.perf_counter()
            for _ in range(10):
                FZ.kernel_forward(d, rows, params)
            host_ms = (time.perf_counter() - t0) / 10 * 1e3
            torch.cuda.synchronize()
            out[chunk] = {"ms": ms, "host_enqueue_ms": host_ms}
    finally:
        FZ.FWD_CHUNK_ROWS = kept
    return out


def compare_k4(d, tr, adv, ret, rows, params, name: str, gen) -> tuple:
    """K4 on a one-step Rollout `tr` (rows: its observations) against its
    plain version under the compare_policy tolerances, with logp_old the
    net's own log-prob of the taken action plus noise, so ratios fall on
    both sides of the clip band; raises past them or unless each call
    launched K4 once. -> ({"max_abs_err", "max_rel_err", "ms", "plain_ms",
    "bound"}, fields of the phase's line)."""
    import torch

    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.train import ppo as P

    pcfg = P.PPOConfig()
    logits, _ = FZ.fused_forward_plain(d, rows, params)
    legal = tr.legal.reshape(-1, d.A)
    lp = torch.log_softmax(torch.where(legal, logits, torch.full_like(logits, -1e9)), -1)
    taken = (tr.actions.reshape(-1, 1).long() - 1).clamp(0, d.A - 1)  # 0: no action
    own = lp.gather(1, taken)[:, 0]
    logp_old = own.reshape(tr.logp.shape) + 0.3 * torch.randn(
        tr.logp.shape, generator=gen, device="cuda")
    rowin = FZ._loss_rows(d, tr.legal, tr.actions, logp_old, adv, ret, tr.mask, pcfg.vf_coef)
    before = FZ.kernel_loss_grads.launches
    (gk, sk), ms = mean_ms(lambda: FZ.kernel_loss_grads(d, rows, rowin, params,
                                                        pcfg.clip, pcfg.ent_coef))
    if FZ.kernel_loss_grads.launches - before != 4:
        raise AssertionError(f"K4 {name}: expected 4 launches")
    (gp, sp), plain_ms = mean_ms(lambda: FZ.loss_vg_plain(d, rows, rowin, params,
                                                          pcfg.clip, pcfg.ent_coef))
    loss_k = float(sk[0] + sk[1] - pcfg.ent_coef * sk[2])
    loss_p = float(sp[0] + sp[1] - pcfg.ent_coef * sp[2])
    loss_err = abs(loss_k - loss_p) / (abs(loss_p) + 1e-6)
    mk = (sk / torch.tensor([1, pcfg.vf_coef, 1, 1], device="cuda")).tolist()
    mp = (sp / torch.tensor([1, pcfg.vf_coef, 1, 1], device="cuda")).tolist()
    metric_err = max(abs(a - b) for a, b in zip(mk, mp))
    errs = {k: rel_err(gk[k], gp[k]) for k in gp}
    fwd_mac, bwd_mac = policy_macs(d)
    prm_bytes = 4 * sum(v.numel() for v in params.values())
    b4 = bound(2 * (fwd_mac + bwd_mac) * rows.shape[0], nbytes(rows, rowin) + 2 * prm_bytes)
    check(f"K4 {name} loss", loss_err, TOL_LOSS)
    check(f"K4 {name} metrics", metric_err, TOL_METRIC)
    for k, e in errs.items():
        check(f"K4 {name} d{k}", e, TOL_GRAD)
    return ({"max_abs_err": max(abs_err(gk[k], gp[k]) for k in gp),
             "max_rel_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms, "bound": b4},
            {"k4_ms": ms, "k4_plain_ms": plain_ms, "k4_loss_rel_err": loss_err,
             "k4_metric_abs_err": metric_err, "k4_grad_rel_err": errs})


def compare_narrow(lowered, traj, adv, ret) -> dict:
    """K2, K3 and K4 at the widths whose storage the pipelines pad (NARROW:
    hidden 48, the trunk padded from 48 to 64 columns; hidden 96, the
    encoder's hp 48 too), for an attn and a deepsets net, on the
    trajectory's first step (32,768 rows) against their plain versions
    under the compare_policy tolerances. K4's logp_old is the net's own
    log-prob of the taken action plus noise, so ratios fall on both sides
    of the clip band. -> {kernel: {"hidden_<h>": {arch: {"ms", "plain_ms",
    "max_rel_err", "max_abs_err", "bound_ms"}}}}."""
    import torch

    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import ppo as P

    out = {k: {} for k in POLICY_REPLACES}
    tr = P.Rollout(*(x[:1] for x in traj))
    gen = torch.Generator(device="cuda").manual_seed(13)
    for hidden in NARROW:
        for arch in ("attn", "deepsets"):
            cfg = N.NetConfig(hidden=hidden, arch=arch)
            d = FZ.dims_for(lowered, cfg)
            params = N.init_params(torch.Generator().manual_seed(2), N.obs_dim(lowered),
                                   N.action_space(lowered), cfg, lowered, device="cuda")
            rows = tr.obs.reshape(-1, d.F).contiguous()
            name = f"{arch}_hidden{hidden}_seed2"
            fields, got = compare_k2_k3(d, rows, params, name)
            got["ppo_loss_grad"], k4 = compare_k4(d, tr, adv[:1], ret[:1], rows, params, name,
                                                  gen)
            emit({"phase": "compare_narrow", "arch": arch, "hidden": hidden, "hp": d.hp,
                  "rows": rows.shape[0], "plan": FZ.kernel_plan(d), **fields, **k4,
                  "bounds_ms": {**fields["bounds_ms"], "k4": got["ppo_loss_grad"]["bound"][0]}})
            for k, v in got.items():
                out[k].setdefault(f"hidden_{hidden}", {})[arch] = {
                    "ms": v["ms"], "plain_ms": v["plain_ms"], "max_rel_err": v["max_rel_err"],
                    "max_abs_err": v["max_abs_err"], "bound_ms": v["bound"][0]}
    return out


LARGE_SEATS = (40, 72)          # werewolf compiled for these seats, rooms full
LARGE_K1_TIMED = (4096, 1024)   # K1 timed through BatchedEngine.rollout: rooms, steps
LARGE_K1_CHECK_STEPS = 128      # K1 exact against plain from the timed start (also its ms, bound)
LARGE_S = (512, 37, 2, 40)      # S decide: decisions, seats a room, rollouts, horizon
LARGE_POLICY_ROWS = 32768       # K2-K4 rows: rooms of P seats, one step
LARGE_DEEP = (48, 33)           # the deep net: hidden, trunk layers (attn, werewolf at 8)
LARGE_TRAIN = (512, 8)          # make_train_step at 40 seats: rooms, horizon (1 epoch)


def large_game(seats: int):
    from game_engine_tpu_torch.gamespec.compile import GameConfig, compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower

    return lower(compile_game(load_builtin("werewolf"), GameConfig(max_players=seats)))


def large_k1(gpu: str, int32_rate: float) -> dict:
    """K1 past 32 seats (werewolf at 40 and 72, full rooms: the kernel's
    wide build, a room on 32 lanes) and past 63 phases (bench_games
    long_game: 78 phases, a 20-node branch condition). Each: K1 through
    BatchedEngine.rollout exact against plain for LARGE_K1_CHECK_STEPS from
    the timed path's own start (its rooms and seeds, so the check's launch
    has the timed launch's lanes a room; all fields, episodes), both timed
    there, and the bound on those rooms by the -DGE_COUNT host build; then
    the rollout at LARGE_K1_TIMED (a warm-up and 3 calls, the launches
    counted from zero), whose lanes a room must equal the check's.
    -> ({case: fields}, launches)."""
    import numpy as np

    from game_engine_tpu_torch.core.engine import BatchedEngine, make_rollout
    from game_engine_tpu_torch.core.rollout_kernel import (count_rollout, kernel_rollout,
                                                           launch_plan)
    from game_engine_tpu_torch.utils.bench_games import long_game

    cases = [(f"werewolf_{P}_seats", large_game(P), P) for P in LARGE_SEATS]
    cases.append(("long_game_78_phases", long_game(), 8))
    B, steps = LARGE_K1_TIMED
    check_steps = LARGE_K1_CHECK_STEPS
    out, launches = {}, 0
    for name, lw, n in cases:
        eng = BatchedEngine(lw, "cuda")
        start = eng.init(B, n, np.arange(B, dtype=np.uint32))
        eng.rollout(start, 1)  # the library and the game's tables, before timing
        (got, eps), ms = timed_ms(lambda: eng.rollout(start, check_steps))
        (ref, ref_eps), plain_ms = timed_ms(lambda: make_rollout(lw, check_steps)(start))
        err = max_abs_err(got, ref, eps, ref_eps)
        if err != 0:
            bad = [f for f, x, y in zip(got._fields, got, ref) if not torch_equal(x, y)]
            raise AssertionError(f"large_rooms {name}: K1 != plain in {bad}")
        plan = launch_plan(lw, B)
        counts = count_rollout(lw, type(start)(*(x.cpu() for x in start)), check_steps)
        by_ops = counts["int_ops"] / int32_rate * 1e3
        by_bytes = 2 * nbytes(*start) / PEAK_BYTES * 1e3
        k1_bound = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
        st = start
        zero_launches()
        st, total = eng.rollout(st, steps)  # warm-up call
        times = []
        for _ in range(3):
            (st, e), t = timed_ms(lambda: eng.rollout(st, steps))
            times.append(t)
            total = total + e
        if kernel_rollout.launches != 4:
            raise AssertionError(f"large_rooms {name}: {kernel_rollout.launches} K1 launches")
        launches += kernel_rollout.launches
        if int(total) <= 0 or int(eps) <= 0:
            raise AssertionError(f"large_rooms {name}: no episode completed")
        timed_plan = launch_plan(lw, st.phase.shape[0])
        if timed_plan["lanes_per_room"] != plan["lanes_per_room"]:
            raise AssertionError(f"large_rooms {name}: timed at {timed_plan['lanes_per_room']} "
                                 f"lanes a room, checked at {plan['lanes_per_room']}")
        timed = statistics.median(times)
        out[name] = {"P": lw.P, "NP": lw.NP, "seats": n, "check_rooms": B,
                     "check_steps": check_steps, "plan": plan,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": k1_bound[0],
                     "bound_by": k1_bound[1], "max_abs_err": err, "episodes": int(eps),
                     "timed_rooms": B, "timed_steps": steps, "timed_plan": timed_plan,
                     "timed_ms_per_call": times, "timed_ms": timed,
                     "env_steps_per_s": B * steps / (timed / 1e3)}
        emit({"phase": "large_rooms_k1", "case": name, **out[name], "gpu": gpu})
    return out, launches


def large_search(gpu: str, int32_rate: float) -> tuple:
    """S's decide entry at 40 seats (rooms of 37, the wide build): live
    rooms at four depths of a scripted rollout on the card, the first of
    them that hold LARGE_S's decisions; the bots' route (actions_for_slots,
    one decide launch, counted from zero) against the plain route's choices
    and totals and the port's C++ search's on the host, exact; the decide
    kernel's ms against the plain route's, the bound by operations (the
    -DGE_COUNT host build), and the kernel at the serving default (32
    rollouts x 200 steps) on the same decisions. -> (fields, launches)."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core import search_kernel as SK
    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.core.state import GameState, state_to_numpy
    from game_engine_tpu_torch.core.step import waiting_seats
    from game_engine_tpu_torch.policies.search import SearchBots

    want, n, R, H = LARGE_S
    lw = large_game(40)
    eng = BatchedEngine(lw, "cuda")
    parts = []
    for k, depth in enumerate((3, 7, 11, 15)):
        st = eng.init(256, n, np.arange(256, dtype=np.uint32) + 4096 * k)
        for _ in range(depth):
            st = eng.step(st, eng.bot_actions(st))
        parts.append(st)
    pool = GameState(*(torch.cat(f) for f in zip(*parts)))
    cum = np.cumsum(waiting_seats(lw, pool).sum(1).cpu().numpy())
    slots = list(range(int(np.searchsorted(cum, want)) + 1))
    sb = SearchBots(lw, R, H, device="cuda")
    zero_launches()
    got = sb.actions_for_slots(pool, slots).cpu().numpy()[slots]
    launches = SK.kernel_decide.launches
    if (launches, SK.kernel_search.launches) != (1, 0):
        raise AssertionError(f"large_rooms S: launches {launches}, {SK.kernel_search.launches}")
    decisions = sb.last_call["decisions"]
    t0 = time.perf_counter()
    plain_got = sb.request_actions(pool, slots, plain=True).cpu().numpy()[slots]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    src, table, plain = sb.last_launch()
    idx = torch.as_tensor(slots, dtype=torch.long, device="cuda")
    sub = GameState(*(f.index_select(0, idx) for f in pool))
    args = (R, H, sb.scoring)
    dec = SK.kernel_decide(lw, sub, *args, sb.salt)
    times = [timed_ms(lambda: SK.kernel_decide(lw, sub, *args, sb.salt))[1] for _ in range(3)]
    flat = decided_flat(dec, len(table))
    pool_np = state_to_numpy(pool)
    cpp = cpp_decisions(sb, [(read_of(pool_np, i), int(pool_np["seed"][i])) for i in slots], n)
    host = host_totals(sb, src, table)
    counts, steps = search_counts(lw, sb, src, table)
    serving = [timed_ms(lambda: SK.kernel_decide(lw, sub, SEARCH_R, SEARCH_H, sb.scoring,
                                                 sb.salt))[1] for _ in range(3)]
    line = {"P": lw.P, "seats": n, "rooms": len(slots), "decisions": decisions,
            "requests": len(table), "rollouts": R, "horizon": H,
            "max_candidates": int(dec.counts.max()),
            "choice_diffs_vs_plain": int((got != plain_got).sum()),
            "choice_diffs_vs_cpp": int((got != cpp).sum()),
            "total_diffs_vs_plain": int((flat != plain).sum()),
            "total_diffs_vs_cpp": int((flat != host).sum()),
            "max_abs_err": int(max(np.abs(flat - plain).max(initial=0),
                                   np.abs(flat - host).max(initial=0))),
            "ms": statistics.median(times), "ms_all": times, "plain_ms": plain_ms,
            "bound_ms": counts["int_ops"] / int32_rate * 1e3, "bound_by": "operations",
            "int_ops": counts["int_ops"], "steps": steps,
            "serving_rollouts": SEARCH_R, "serving_horizon": SEARCH_H,
            "serving_ms": statistics.median(serving), "serving_ms_all": serving,
            "plan": SK.search_plan(lw, len(table) * R)}
    emit({"phase": "large_rooms_search", **line, "gpu": gpu})
    if any(v for k, v in line.items() if "diffs" in k):
        raise AssertionError(f"large_rooms S: {line}")
    if decisions < want or line["max_candidates"] <= 32:
        raise AssertionError(f"large_rooms S: {decisions} decisions, "
                             f"{line['max_candidates']} candidates at most")
    return line, launches


def one_step(lw, cfg, rooms: int, seed: int):
    """A one-step Rollout of the plain-policy unroll from `rooms` full rooms
    after a few scripted steps, on the card, with GAE advantages and
    returns, and fresh params of cfg -> (params, Rollout, adv, ret)."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import ppo as P

    params = N.init_params(torch.Generator().manual_seed(seed), N.obs_dim(lw),
                           N.action_space(lw), cfg, lw, device="cuda")
    eng = BatchedEngine(lw, "cuda")
    state = eng.init(rooms, lw.P, np.arange(rooms, dtype=np.uint32) + seed)
    for _ in range(5):
        state = eng.step(state, eng.bot_actions(state))
    pcfg = P.PPOConfig(horizon=1, net=cfg)
    state, traj = P.make_unroll(lw, pcfg)(params, state,
                                          torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        _, last_v = N.apply_net(params, N.observe(lw, state), cfg, lw)
    adv, ret = P.gae(traj, last_v, pcfg)
    return params, traj, adv, ret


def large_policy(gpu: str, profiled: bool = False) -> dict:
    """K2, K3 and K4 past the bounds they had: the attn net at hidden 256 on
    werewolf rooms of 40 and of 72 seats (the attention's seats past the 32
    held in registers; at 72, 72 actions past the loss's 64), and an attn
    net of LARGE_DEEP's 33 trunk layers at 8 seats, each on
    LARGE_POLICY_ROWS rows of one step against its plain version under the
    compare_policy tolerances, with the chunk the scratch budget gives.
    With `profiled`, also each kernel's device time by stage
    (large_rooms_stages). -> {kernel: {case: fields}}."""
    import torch

    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import ppo as P

    out = {k: {} for k in POLICY_REPLACES}
    gen = torch.Generator(device="cuda").manual_seed(17)
    hidden, layers = LARGE_DEEP
    cases = [(f"attn_hidden256_{P}_seats", large_game(P), N.NetConfig(hidden=256, arch="attn"))
             for P in LARGE_SEATS]
    cases.append((f"attn_hidden{hidden}_{layers}_layers", large_game(8),
                  N.NetConfig(hidden=hidden, arch="attn", layers=layers)))
    for name, lw, cfg in cases:
        d = FZ.dims_for(lw, cfg)
        params, tr, adv, ret = one_step(lw, cfg, LARGE_POLICY_ROWS // lw.P, 23)
        rows = tr.obs.reshape(-1, d.F).contiguous()
        fields, got = compare_k2_k3(d, rows, params, name)
        got["ppo_loss_grad"], k4 = compare_k4(d, tr, adv, ret, rows, params, name, gen)
        emit({"phase": "large_rooms_policy", "case": name, "P": d.P, "A": d.A,
              "layers": d.layers, "hidden": d.hidden, "rows": rows.shape[0],
              "plan": FZ.kernel_plan(d), **fields, **k4,
              "bounds_ms": {**fields["bounds_ms"], "k4": got["ppo_loss_grad"]["bound"][0]},
              "gpu": gpu})
        if profiled:
            pcfg = P.PPOConfig()
            dl = torch.randn((rows.shape[0], d.A), generator=gen, device="cuda")
            dv = torch.randn((rows.shape[0],), generator=gen, device="cuda")
            rowin = FZ._loss_rows(d, tr.legal, tr.actions, tr.logp, adv, ret, tr.mask,
                                  pcfg.vf_coef)
            emit({"phase": "large_rooms_stages", "case": name, "rows": rows.shape[0],
                  "plan": FZ.kernel_plan(d), "gpu": gpu, "by_stage_ms": {
                      "k2": profile(lambda: FZ.kernel_forward(d, rows, params)),
                      "k3": profile(lambda: FZ.kernel_grads(d, rows, dl, dv, params)),
                      "k4": profile(lambda: FZ.kernel_loss_grads(d, rows, rowin, params,
                                                                 pcfg.clip, pcfg.ent_coef))}})
        for k, v in got.items():
            out[k][name] = {"P": d.P, "A": d.A, "layers": d.layers, "rows": rows.shape[0],
                            "ms": v["ms"], "plain_ms": v["plain_ms"],
                            "max_rel_err": v["max_rel_err"], "max_abs_err": v["max_abs_err"],
                            "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
        del params, tr, adv, ret, rows
        torch.cuda.empty_cache()
    return out


def large_train(gpu: str) -> dict:
    """One make_train_step update (LARGE_TRAIN's rooms and horizon, one
    epoch) of the attn net at hidden 256 on full 40-seat werewolf rooms,
    the kernels forced (PPOConfig(fused_net=True)): horizon + 1 K2 and one
    K4 launch (counted from zero), a finite loss, moved params. -> the
    launches."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import ppo as P

    rooms, horizon = LARGE_TRAIN
    lw = large_game(40)
    cfg = P.PPOConfig(horizon=horizon, epochs=1, fused_net=True,
                      net=N.NetConfig(hidden=256, arch="attn"))
    params, opt = P.init_training(lw, cfg, torch.Generator().manual_seed(29), device="cuda")
    before = clone(params)
    state = init_state(lw, rooms, lw.P, np.arange(rooms, dtype=np.uint32), device="cuda")
    step = P.make_train_step(lw, cfg)
    zero_launches()
    t0 = time.perf_counter()
    state, metrics = step(params, opt, state, torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = policy_launches()
    loss, moved = float(metrics["loss"]), max_change(params, before)
    emit({"phase": "large_rooms_train", "P": lw.P, "rooms": rooms, "horizon": horizon,
          "epochs": 1, "seconds": seconds, "unroll_ms": metrics["unroll_ms"],
          "update_ms": metrics["update_ms"], "loss": loss, "max_param_change": moved,
          "launches": launches, "gpu": gpu})
    want = {"policy_forward": horizon + 1, "policy_backward": 0, "ppo_loss_grad": 1}
    if launches != want:
        raise AssertionError(f"large_rooms train step launched {launches}, expected {want}")
    if not np.isfinite(loss) or not moved > 0:
        raise AssertionError(f"large_rooms train step: loss {loss}, params moved {moved}")
    return launches


def large_rooms_phase(gpu: str, int32_rate: float, profiled: bool = False) -> dict:
    """Rooms past a warp of seats, games past 63 phases, nets past 64
    actions and 32 trunk layers through K1, S and K2-K4 (large_k1,
    large_search, large_policy, large_train). -> {"rollout", "search_decide",
    policy kernels: {"cases", "launches"}}."""
    t0 = time.perf_counter()
    k1, k1_launches = large_k1(gpu, int32_rate)
    s, s_launches = large_search(gpu, int32_rate)
    policy = large_policy(gpu, profiled)
    train = large_train(gpu)
    emit({"phase": "large_rooms_done", "seconds": time.perf_counter() - t0, "gpu": gpu})
    return {"rollout": {"cases": k1, "launches": k1_launches},
            "search_decide": {"cases": {"werewolf_40_seats": s}, "launches": s_launches},
            **{k: {"cases": policy[k], "launches": train[k]} for k in POLICY_REPLACES}}


def packed_weights_check(lowered, traj, adv, ret, params, cfg) -> None:
    """The packed-weight cache across an optimizer step: K2 before and after
    one K4 update (Adam, in place) of a copy of `params`, each against the
    plain version on the parameters of that moment."""
    import torch

    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.train import ppo as P

    d = FZ.dims_for(lowered, cfg)
    rows = traj.obs[0].reshape(-1, d.F).contiguous()
    params = {k: v.detach().clone() for k, v in params.items()}
    pcfg = P.PPOConfig(fused_net=True, net=cfg)
    opt = P.make_optimizer(params, pcfg)
    tr = P.Rollout(*(x[:4] for x in traj))

    def k2_checked(tag):
        lk, vk = FZ.kernel_forward(d, rows, params)
        lp, vp = FZ.fused_forward_plain(d, rows, {k: v.detach() for k, v in params.items()})
        errs = (rel_err(lk, lp), rel_err(vk, vp))
        check(f"K2 {tag} the update, logits", errs[0], TOL_FWD)
        check(f"K2 {tag} the update, value", errs[1], TOL_FWD)
        return lk, vk, max(errs)

    packs = FZ._packed.packs
    l0, v0, e0 = k2_checked("before")
    FZ.kernel_forward(d, rows, params)
    packs_before = FZ._packed.packs - packs
    P.make_update(lowered, pcfg)(params, opt, tr, adv[:4], ret[:4])
    l1, v1, e1 = k2_checked("after")
    FZ.kernel_forward(d, rows, params)
    packs_all = FZ._packed.packs - packs
    moved = max(abs_err(l1, l0), abs_err(v1, v0))
    emit({"phase": "packed_weights", "rel_err_before": e0, "rel_err_after": e1,
          "output_moved_by": moved, "packs_before_update": packs_before,
          "packs_in_all": packs_all})
    if not moved > 0:
        raise AssertionError("K2 after an optimizer step returned the old parameters' output")
    # one packing before the step (two K2 calls and the update's K4), one after (two K2 calls)
    if (packs_before, packs_all) != (1, 2):
        raise AssertionError(f"expected 1 packing before the update and 2 in all, got "
                             f"{packs_before} and {packs_all}")


def policy_wrappers() -> dict:
    from game_engine_tpu_torch.policies import fused as FZ

    return {"policy_forward": FZ.kernel_forward, "policy_backward": FZ.kernel_grads,
            "ppo_loss_grad": FZ.kernel_loss_grads}


def policy_launches() -> dict:
    return {k: fn.launches for k, fn in policy_wrappers().items()}


def decode_programs() -> dict:
    """The chat decode's launches by program since the counts were zeroed."""
    from game_engine_tpu_torch.policies.chat_decode import kernel_decode

    return {"prefill": kernel_decode.prefill_launches, "decode": kernel_decode.decode_launches}


def zero_launches() -> None:
    from game_engine_tpu_torch.core.rollout_kernel import kernel_rollout
    from game_engine_tpu_torch.core.search_kernel import kernel_decide, kernel_search
    from game_engine_tpu_torch.policies.chat_decode import kernel_decode

    kernel_rollout.launches = 0
    kernel_search.launches = kernel_decide.launches = 0
    kernel_decode.launches = kernel_decode.prefill_launches = kernel_decode.decode_launches = 0
    for fn in policy_wrappers().values():
        fn.launches = 0


def train_phase(lowered, gpu: str) -> dict:
    """The learner's main path: run.main, then one update with
    fused_loss=False. Returns the kernel launches of each."""
    import contextlib
    import io

    import numpy as np
    import torch

    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import ppo as P
    from game_engine_tpu_torch.train import run as R

    argv = [os.path.join(HERE, CKPT) if a == CKPT else a for a in TRAIN_ARGV]
    start, _ = N.load_policy(os.path.join(HERE, CKPT), device="cuda")
    out = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        params = R.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = policy_launches()
    events = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    for ev in events:
        emit({"phase": "train_event", **ev})
    if not any(ev["event"] == "fused_net" and ev["mode"] == "auto" for ev in events):
        raise AssertionError("run.main did not turn the policy-net kernels on")
    train = [ev for ev in events if ev["event"] == "train"][-1]
    for k in ("loss", "pg_loss", "v_loss", "entropy", "ratio_mean"):
        if not np.isfinite(train[k]):
            raise AssertionError(f"train metric {k} is {train[k]}")
    moved = max(float((params[k].detach() - start[k]).abs().max()) for k in start)
    if not moved > 0:
        raise AssertionError("the params did not move")
    updates = int(dict(zip(argv[::2], argv[1::2]))["--updates"])
    want = {"policy_forward": K2_PER_UPDATE * updates, "policy_backward": 0,
            "ppo_loss_grad": 4 * updates}  # K2: 32 steps + the bootstrap; K4: one per epoch
    if launches != want:
        raise AssertionError(f"the train path launched {launches}, expected {want}")
    if not any(ev["event"] == "fused_net" and ev["forward"] == "tensor_core"
               and ev["loss"] == "k4" for ev in events):
        raise AssertionError("run.main did not announce the tensor-core forward and K4")
    emit({"phase": "train", "argv": argv, "seconds": seconds,
          "steps_per_sec": train["steps_per_sec"], "unroll_ms": train["unroll_ms"],
          "update_ms": train["update_ms"], "loss": train["loss"],
          "max_param_change": moved, "launches": launches, "gpu": gpu})

    # K3 on a train path: one train step with fused_loss=False
    cfg = P.PPOConfig(horizon=32, epochs=1, fused_net=True, fused_loss=False,
                      net=N.NetConfig(hidden=256, arch="attn"))
    opt = P.make_optimizer(params, cfg)
    state = init_state(lowered, ROOMS, 6, np.arange(ROOMS, dtype=np.uint32) + 5, device="cuda")
    before = {k: v.detach().clone() for k, v in params.items()}
    zero_launches()
    _, metrics = P.make_train_step(lowered, cfg)(
        params, opt, state, torch.Generator(device="cuda").manual_seed(3))
    k3 = policy_launches()
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError("fused_loss=False update: loss is not finite")
    # K2: the unroll, the bootstrap and ppo_loss's forward; K3: its backward
    want = {"policy_forward": K2_PER_UPDATE + 1, "policy_backward": 1, "ppo_loss_grad": 0}
    if k3 != want:
        raise AssertionError(f"the fused_loss=False update launched {k3}, expected {want}")
    moved = max(float((params[k].detach() - before[k]).abs().max()) for k in before)
    emit({"phase": "train_k3", "loss": float(metrics["loss"]),
          "unroll_ms": metrics["unroll_ms"], "update_ms": metrics["update_ms"],
          "max_param_change": moved, "launches": k3, "gpu": gpu})
    if not moved > 0:
        raise AssertionError("the fused_loss=False update did not move the params")

    # the same path on the plain net, for the end-to-end comparison
    flags = {**dict(zip(argv[::2], argv[1::2])), "--updates": "1", "--eval-batch": "0"}
    out = io.StringIO()
    zero_launches()
    with contextlib.redirect_stdout(out):
        R.main([x for kv in flags.items() for x in kv] + ["--no-fused"])
    if any(policy_launches().values()):
        raise AssertionError(f"--no-fused launched a kernel: {policy_launches()}")
    train = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{") and '"train"' in ln][-1]
    if not np.isfinite(train["loss"]):
        raise AssertionError("plain update: loss is not finite")
    emit({"phase": "train_plain", "steps_per_sec": train["steps_per_sec"],
          "unroll_ms": train["unroll_ms"], "update_ms": train["update_ms"],
          "loss": train["loss"], "gpu": gpu})
    return {"policy_forward": launches["policy_forward"] + k3["policy_forward"],
            "policy_backward": k3["policy_backward"],
            "ppo_loss_grad": launches["ppo_loss_grad"]}


def train_narrow_phase(gpu: str) -> dict:
    """One update of run.main --hidden 48 on the card (the attn net, the
    train path's rooms, seats, horizon and epochs): a width whose storage
    the pipelines pad. Its fused_net event must name K4, and the update must
    launch 33 K2 and 4 K4. Returns the launches."""
    import contextlib
    import io

    import numpy as np

    from game_engine_tpu_torch.train import run as R

    argv = ["--device", "cuda", "--arch", "attn", "--hidden", "48", "--batch", str(ROOMS),
            "--players", "6", "--horizon", str(HORIZON), "--epochs", "4", "--updates", "1",
            "--eval-batch", "0"]
    out = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        R.main(argv)
    seconds = time.perf_counter() - t0
    launches = policy_launches()
    events = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    fused = [ev for ev in events if ev["event"] == "fused_net"]
    train = [ev for ev in events if ev["event"] == "train"][-1]
    emit({"phase": "train_narrow", "argv": argv, "fused_net": fused, "seconds": seconds,
          "steps_per_sec": train["steps_per_sec"], "unroll_ms": train["unroll_ms"],
          "update_ms": train["update_ms"], "loss": train["loss"], "launches": launches,
          "gpu": gpu})
    if [(ev["mode"], ev["loss"]) for ev in fused] != [("auto", "k4")]:
        raise AssertionError(f"run.main --hidden 48 announced {fused}, expected K4 (auto)")
    want = {"policy_forward": K2_PER_UPDATE, "policy_backward": 0, "ppo_loss_grad": 4}
    if launches != want:
        raise AssertionError(f"run.main --hidden 48 launched {launches}, expected {want}")
    if not np.isfinite(train["loss"]):
        raise AssertionError("run.main --hidden 48: loss is not finite")
    return launches


BENCH_GAMES_SHAPE = (4096, 1024, 5)  # utils/bench_games.py's defaults: rooms, steps, iters
BENCH_GAMES_CHECK_STEPS = 128  # steps of the kernel-vs-plain check a game, at the timed rooms


def bench_games_phase(gpu: str) -> int:
    """utils/bench_games.py on the card: K1 held equal to the plain rollout
    on every DEFAULT_GAMES entry from the timed path's own start (its rooms,
    seats and seeds; BENCH_GAMES_CHECK_STEPS steps, all 15 GameState fields
    and the episode count, exact), so the check's launch has the timed
    launch's lanes a room; then each game timed at the module's defaults
    through bench_game, whose lanes a room must equal the check's. Returns
    K1's launches on the timed path."""
    import numpy as np

    from game_engine_tpu_torch.core.engine import BatchedEngine, make_rollout
    from game_engine_tpu_torch.core.rollout_kernel import kernel_rollout, launch_plan
    from game_engine_tpu_torch.utils import bench_games as BG

    batch, steps, iters = BENCH_GAMES_SHAPE
    checked = {}
    for game in BG.DEFAULT_GAMES:
        lowered, n_players, _ = BG.game_setup(game)
        eng = BatchedEngine(lowered, "cuda")
        start = eng.init(batch, n_players, np.arange(batch, dtype=np.uint32))
        got, eps = eng.rollout(start, BENCH_GAMES_CHECK_STEPS)
        ref, ref_eps = make_rollout(lowered, BENCH_GAMES_CHECK_STEPS)(start)
        err = max_abs_err(got, ref, eps, ref_eps)
        checked[game] = {"n_players": n_players,
                         "lanes_per_room": launch_plan(lowered, batch)["lanes_per_room"],
                         "episodes": int(eps), "plain_episodes": int(ref_eps),
                         "max_abs_err": err}
        if err != 0:
            bad = [f for f, x, y in zip(got._fields, got, ref) if not bool((x == y).all())]
            raise AssertionError(f"bench_games {game}: kernel != plain in {bad}")
    emit({"phase": "bench_games_check", "rooms": batch, "steps": BENCH_GAMES_CHECK_STEPS,
          "games": checked})

    zero_launches()
    rows = [BG.bench_game(g, batch, steps, iters, gpu) for g in BG.DEFAULT_GAMES]
    launches = kernel_rollout.launches
    anchor = rows[0]["msteps_per_s"]
    for row in rows:
        emit({"phase": "bench_games", **row, "rel_to_anchor": row["msteps_per_s"] / anchor})
        if not row["msteps_per_s"] > 0:
            raise AssertionError(f"bench_games {row['game']}: no rate")
        if row["lanes_per_room"] != checked[row["game"]]["lanes_per_room"]:
            raise AssertionError(f"bench_games {row['game']}: timed at {row['lanes_per_room']} "
                                 f"lanes a room, checked at "
                                 f"{checked[row['game']]['lanes_per_room']}")
    if launches != len(rows) * (iters + 1):
        raise AssertionError(f"bench_games launched K1 {launches} times, expected "
                             f"{len(rows) * (iters + 1)}")
    return launches


POLICY_BENCH_SHAPE = (16384, 128, 4)  # bench.py --policy's defaults: rooms, steps, iters


def policy_bench_phase(gpu: str) -> None:
    """bench.py --policy at its defaults: the learned-policy self-play loop
    (the mlp at hidden 256, eager torch a step; no kernel on this path)."""
    from game_engine_tpu_torch.bench import policy_rollout_bench
    from game_engine_tpu_torch.core.rollout_kernel import kernel_rollout

    zero_launches()
    t0 = time.perf_counter()
    line = policy_rollout_bench(*POLICY_BENCH_SHAPE)
    seconds = time.perf_counter() - t0
    launches = {**policy_launches(), "rollout": kernel_rollout.launches}
    emit({"phase": "policy_bench", **line, "seconds": seconds, "launches": launches})
    if not line["value"] > 0 or line["detail"]["episodes_completed"] <= 0:
        raise AssertionError(f"bench.py --policy: {line}")
    if any(launches.values()):
        raise AssertionError(f"bench.py --policy launched a kernel: {launches}")


WW_KEY = "werewolf-(mafia)#r1"  # the host's slots key of the catalog's werewolf


def quantile(xs, p):
    """The p-quantile of xs by rank (utils/load_test.py's, unrounded)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else None


CHAT_LINES = ("to Bot 2: hello there", "to Bot 2: who is still alive?",
              "to Bot 3: what's the score?")


def chat_poster(port: int, host, storage, stop, stats: dict, lock) -> None:
    """One more client that only chats, closed loop with no pause: a
    message of CHAT_LINES in turn to a started room in turn, its latency
    recorded under "chat". The host holds a room from the start of its
    /start call, the lobby marks it playing only after; until then the API
    rightly answers a chat 409 "room not started", so such a room is passed
    over and counted ("chat_unstarted_skips"), as a client that has not
    seen its start answered would not chat there. A room that has left the
    host (410) is skipped, any other failure is an error, with its status
    and body among the samples."""
    import urllib.error

    from game_engine_tpu_torch.utils.load_test import _req

    def failed(sample: str) -> None:
        with lock:
            stats["errors"] = stats.get("errors", 0) + 1
            stats.setdefault("error_samples", []).append(sample[:160])

    i = 0
    while not stop.is_set():
        with host._lock:
            rids = sorted(host._rooms)
        if not rids:
            time.sleep(0.05)
            continue
        rid = rids[i % len(rids)]
        room = storage.get_room(rid)
        if room is None or room.status == "waiting":
            with lock:
                stats["chat_unstarted_skips"] = stats.get("chat_unstarted_skips", 0) + 1
            i += 1
            continue
        try:
            _, ms = _req(port, "POST", f"/api/rooms/{rid}/chat",
                         {"playerId": 1, "message": CHAT_LINES[i % len(CHAT_LINES)]})
            with lock:
                stats.setdefault("chat", []).append(ms)
        except urllib.error.HTTPError as e:
            if e.code == 410:
                with lock:
                    stats["chat_gone"] = stats.get("chat_gone", 0) + 1
            else:
                failed(f"chat HTTP {e.code}: {e.read().decode(errors='replace')}")
        except Exception as e:  # count, as the load clients do
            failed(repr(e))
        i += 1


def serve_run(name: str, bots_per_room: int, bot_ckpts, storage: str, gpu: str,
              backend: str = "torch", bot_search=None, chat_lm=None):
    """One load_test drive of the port's server on the card, counts set to 0
    just before it and read just after. The clients first create and start
    their rooms (set-up, timed apart: the lobby store rewrites its whole
    file on every change); the SERVE_SECONDS window starts once every room
    is live. With `chat_lm`, one chat_poster more runs in the window (the
    load clients chat only every 23rd turn). Returns (the stopped server,
    its host intact; the line)."""
    import threading

    import torch

    from game_engine_tpu_torch.core import search_kernel as SK
    from game_engine_tpu_torch.policies import chat_decode as CD
    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import search as PS
    from game_engine_tpu_torch.server import manager as MG
    from game_engine_tpu_torch.server.api import make_server
    from game_engine_tpu_torch.utils.load_test import Client

    srv = make_server(0, storage, bot_ckpts=bot_ckpts, backend=backend, bot_search=bot_search,
                      chat_lm=chat_lm, device="cuda")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    steps = {"calls": 0, "seconds": 0.0, "slots": 0, "search_seconds": 0.0}
    native = backend == "native"
    # the engine step: a batched step of many rooms (torch) or one room (native)
    cls, meth = (MG._NativeRooms, "step_slot") if native else (MG._TorchSlots, "step_slots")
    step_fn = getattr(cls, meth)
    search_meth = "native_actions" if native else "actions_for_slots"
    search_fn = getattr(PS.SearchBots, search_meth)

    def counted(self, slots, *args, **kwargs):  # the host clock around each engine step
        t0 = time.perf_counter()
        step_fn(self, slots, *args, **kwargs)
        steps["seconds"] += time.perf_counter() - t0
        steps["calls"] += 1
        steps["slots"] += 1 if native else len(slots)

    def searched(self, *args, **kwargs):  # the host clock around each search decision call
        t0 = time.perf_counter()
        out = search_fn(self, *args, **kwargs)
        steps["search_seconds"] += time.perf_counter() - t0
        return out

    stop, stats, lock = threading.Event(), {}, threading.Lock()
    per = SERVE_ROOMS // SERVE_CLIENTS
    clients = [Client(srv.server_address[1], "werewolf", per, stop, stats, lock, c,
                      bots_per_room=bots_per_room) for c in range(SERVE_CLIENTS)]
    eps = ("create", "start", "continue", "action", "state", "chat")

    def snap():
        with lock:
            return ({ep: len(stats.get(ep, [])) for ep in eps}, stats.get("games_done", 0),
                    stats.get("errors", 0), dict(steps), time.time())

    setattr(cls, meth, counted)
    setattr(PS.SearchBots, search_meth, searched)
    zero_launches()
    t0 = time.time()
    try:
        for c in clients:
            c.start()
        while snap()[0]["start"] < per * SERVE_CLIENTS and snap()[2] == 0 \
                and time.time() - t0 < 600:
            time.sleep(0.2)
        begin = snap()
        if chat_lm:
            clients.append(threading.Thread(target=chat_poster, daemon=True, args=(
                srv.server_address[1], srv.ctx.host, srv.ctx.storage, stop, stats, lock)))
            clients[-1].start()
        time.sleep(SERVE_SECONDS)
        end = snap()
        stop.set()
        for c in clients:
            c.join(timeout=120)
        torch.cuda.synchronize()
    finally:
        setattr(cls, meth, step_fn)
        setattr(PS.SearchBots, search_meth, search_fn)
        srv.shutdown()
        srv.server_close()
    s_launches = {"search": SK.kernel_search.launches,
                  "search_decide": SK.kernel_decide.launches}
    d_launches = CD.kernel_decode.launches
    d_programs = decode_programs()
    launches = FZ.kernel_forward.launches
    host = srv.ctx.host
    gs = host._slots[WW_KEY]
    wall = end[4] - begin[4]
    lat = {ep: stats.get(ep, [])[begin[0][ep]:end[0][ep]] for ep in eps}
    n_req = sum(len(v) for v in lat.values())
    games = end[1] - begin[1]
    n_steps = end[3]["calls"] - begin[3]["calls"]
    first = next(iter(host._rooms.values()))[1]
    search_s = end[3]["search_seconds"] - begin[3]["search_seconds"]
    step_s = end[3]["seconds"] - begin[3]["seconds"]
    line = {
        "phase": name, "backend": backend, "rooms": per * SERVE_CLIENTS,
        "clients": SERVE_CLIENTS, "bots_per_room": bots_per_room,
        "seats_per_room": gs.n_players[first] if native else int(gs.host["present"][first].sum()),
        "bot_tier": "policy" if bot_ckpts else "search" if bot_search else "scripted",
        "setup_s": begin[4] - t0, "setup_start_ms_p50": quantile(
            stats.get("start", [])[:begin[0]["start"]], 0.5),
        "window_s": wall, "requests": n_req, "req_per_s": n_req / wall,
        "games_completed": games, "games_per_min": games / wall * 60,
        "errors": stats.get("errors", 0), "error_samples": stats.get("error_samples", []),
        "continue_ms": {f"p{int(q * 100)}": quantile(lat["continue"], q)
                        for q in (0.5, 0.9, 0.99)},
        "continue_ms_mean": statistics.mean(lat["continue"]) if lat["continue"] else None,
        **{f"{ep}_ms_p50": quantile(lat[ep], 0.5) for ep in
           ("create", "start", "action", "state", "chat")},
        "requests_by_endpoint": {ep: len(v) for ep, v in lat.items()},
        "engine_steps": n_steps,
        "engine_steps_per_continue": n_steps / max(1, len(lat["continue"])),
        "step_slots_host_ms_mean": (end[3]["seconds"] - begin[3]["seconds"])
        / max(1, n_steps) * 1e3,
        "step_slots_share_of_window": (end[3]["seconds"] - begin[3]["seconds"]) / wall,
        "rooms_per_engine_step": (end[3]["slots"] - begin[3]["slots"]) / max(1, n_steps),
        "slot_capacity": gs.capacity, "live_rooms": len(host._rooms),
        "chat_ms": {f"p{int(q * 100)}": quantile(lat["chat"], q) for q in (0.5, 0.99)},
        "chat_ms_mean": statistics.mean(lat["chat"]) if lat["chat"] else None,
        "chat_lm": chat_lm is not None, "chat_poster": bool(chat_lm),
        "chats_to_ended_rooms": stats.get("chat_gone", 0),
        "chat_unstarted_skips": stats.get("chat_unstarted_skips", 0), "decode_launches": d_launches,
        "decode_launches_by_program": d_programs,
        "k2_launches": launches, "search_launches": s_launches,
        "search_host_s_in_window": search_s,
        "search_share_of_step": search_s / step_s if step_s else None, "gpu": gpu}
    if bot_ckpts:
        line["policy_route"] = host._policies[WW_KEY].route
    emit(line)
    if line["errors"] != 0:
        raise AssertionError(f"{name}: {line['errors']} request errors: {line['error_samples']}")
    if not lat["continue"] or games <= 0:
        raise AssertionError(f"{name}: no /continue answered or no game completed in the window")
    if gs.capacity < SERVE_ROOMS:
        raise AssertionError(f"{name}: the slot pool stayed at {gs.capacity} slots "
                             f"for {SERVE_ROOMS} rooms")
    if bot_ckpts:
        if launches <= 0:
            raise AssertionError(f"{name}: K2 launched {launches} times, expected > 0")
    elif launches != 0:
        raise AssertionError(f"{name}: the scripted run launched K2 {launches} times")
    if bool(bot_search) != (sum(s_launches.values()) > 0):
        raise AssertionError(f"{name}: {s_launches} search launches with bot_search={bot_search}")
    if bool(chat_lm) != (d_launches > 0):
        raise AssertionError(f"{name}: {d_launches} chat decode launches with chat_lm={chat_lm}")
    return srv, line


def live_rooms(host, n: int) -> list:
    """The n werewolf rooms of a host that have taken the most steps."""
    gs = host._slots[WW_KEY]
    rooms = [(gs.version(s), rid) for rid, (k, s) in host._rooms.items() if k == WW_KEY]
    return [rid for _, rid in sorted(rooms, reverse=True)[:n]]


def restore_check(srv, rids: list, device: str, bot_ckpts, **host_kw) -> int:
    """Rooms restored from their journals into a fresh host on `device`
    (the live host's backend and bots, or `host_kw`'s) give the live host's
    snapshot_state bit for bit; returns the engine steps replayed."""
    from game_engine_tpu_torch.server.manager import GameHost

    live = srv.ctx.host
    with live._lock:
        want = {rid: live._slots[live._rooms[rid][0]].snapshot_state(live._rooms[rid][1])
                for rid in rids}
    fresh = GameHost(persist_dir=live._persist_dir, bot_ckpts=bot_ckpts, device=device,
                     **host_kw)
    for rid in rids:
        if not fresh.restore_room(rid):
            raise AssertionError(f"room {rid} did not restore on {device}")
        key, slot = fresh._rooms[rid]
        got = fresh._slots[key].snapshot_state(slot)
        if got != want[rid]:
            bad = [k for k in want[rid] if got[k] != want[rid][k]]
            raise AssertionError(f"room {rid} restored on {device} differs in {bad}")
    return sum(want[rid]["t"] for rid in rids)


def greedy_check(host) -> dict:
    """(a): K2's greedy actions against the plain version's on the live
    states of the last step, where the top two legal logits are more than
    1e-3 apart; logits within TOL_FWD."""
    import torch

    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.policies.serve import first_argmax

    gs, pb = host._slots[WW_KEY], host._policies[WW_KEY]
    lw, state = gs.lowered, gs.state
    d = FZ.dims_for(lw, pb.cfg)
    with torch.inference_mode():
        rows = FZ._as_rows(d, N.observe(lw, state))
        lk, vk = FZ.kernel_forward(d, rows, pb.params)
        lp, vp = FZ.fused_forward_plain(d, rows, pb.params)
        mask = N.legal_action_mask(lw, state).reshape(-1, d.A)
        mk = torch.where(mask, lk, -1e9)
        mp = torch.where(mask, lp, -1e9)
        top = mp.topk(2, dim=-1).values
        seat = mask.any(-1) & state.present.reshape(-1)
        clear = seat & (top[:, 0] - top[:, 1] > 1e-3)
        ak, ap = first_argmax(mk), first_argmax(mp)
        served = pb.greedy(state).reshape(-1)
    out = {"rows": rows.shape[0], "seats_with_a_choice": int(seat.sum()),
           "clear_margin_seats": int(clear.sum()),
           "disagree_on_clear": int(((ak != ap) & clear).sum()),
           "disagree_anywhere": int(((ak != ap) & seat).sum()),
           "served_equals_k2": bool(torch.equal(served[seat], (ak + 1).to(torch.int32)[seat])),
           "logits_rel_err": rel_err(lk, lp), "value_rel_err": rel_err(vk, vp)}
    check("serving K2 logits", out["logits_rel_err"], TOL_FWD)
    check("serving K2 value", out["value_rel_err"], TOL_FWD)
    if out["disagree_on_clear"] or not out["served_equals_k2"] or not out["clear_margin_seats"]:
        raise AssertionError(f"greedy actions: {out}")
    return out


def sync_ms(fn, reps: int = 10) -> float:
    """Mean host milliseconds of fn() with the card drained before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def device_ms(fn, reps: int = 3) -> tuple:
    """(device milliseconds of one fn() call's work with its kernels back to
    back (prefilled_ms, the median of `reps`), kernels a call: the launch
    calls in torch.profiler's trace, the ctypes entries' too)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    ms = statistics.median(prefilled_ms(fn, host) for _ in range(reps))
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launches = sum(1 for e in trace_events(prof) if e.get("ph") == "X"
                   and str(e.get("name", "")).startswith(LAUNCH_CALLS))
    return ms, launches / reps


def serve_breakdown(host) -> dict:
    """Where one engine step of the server goes, on a copy of the live slot
    batch (capacity x P rows): the engine step with its scripted bots (two
    ST launches), the policy bots (observe, K2, legal mask, argmax), the
    host read of the stepped rooms, and a whole step_slots of eight rooms;
    K2 alone at 64-2048 rows. Host milliseconds with the card drained
    (sync_ms), device milliseconds of the kernels back to back and the
    launches a call (device_ms), and K2's time on the card's clock (CUDA
    events) and host time to enqueue."""
    import copy

    import torch

    from game_engine_tpu_torch.core.state import GameState
    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import net as N

    gs, pb = host._slots[WW_KEY], host._policies[WW_KEY]
    lw = gs.lowered
    g2 = copy.copy(gs)
    g2.state = GameState(*(t.clone() for t in gs.state))
    g2.host = {k: v.copy() for k, v in gs.host.items()}
    eng, state = g2.engine, g2.state
    rids = live_rooms(host, SERVE_CHECK_ROOMS)
    slots = [host._rooms[r][1] for r in rids]
    humans = {host._rooms[r][1]: host._humans[r] for r in rids}
    pseats = {host._rooms[r][1]: host._policy_seats[r] for r in rids}

    def step():
        return eng.step(state, eng.bot_actions(state))

    out = {"capacity": g2.capacity, "rows": g2.capacity * lw.P}
    out["engine_step_ms"] = sync_ms(step)
    out["engine_step_device_ms"], out["engine_step_kernels"] = device_ms(step)
    with torch.inference_mode():
        out["policy_greedy_ms"] = sync_ms(lambda: pb.greedy(state))
        out["policy_greedy_device_ms"], out["policy_greedy_kernels"] = device_ms(
            lambda: pb.greedy(state))
        out["observe_ms"] = sync_ms(lambda: N.observe(lw, state))
    out["host_read_ms"] = sync_ms(lambda: g2._pull(slots))
    out["host_read_device_ms"], out["host_read_kernels"] = device_ms(lambda: g2._pull(slots))
    out["step_slots_ms"] = sync_ms(lambda: g2.step_slots(slots, {}, humans, policy=pb,
                                                         policy_seats=pseats), reps=5)
    d = FZ.dims_for(lw, pb.cfg)
    with torch.inference_mode():
        rows_all = FZ._as_rows(d, N.observe(lw, state))
    k2 = {}
    for n in K2_SERVE_ROWS:
        rows = rows_all[:n].contiguous()
        call = (lambda r=rows: FZ.kernel_forward(d, r, pb.params))
        _, ev_ms = mean_ms(call, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        dev_ms, kernels = device_ms(call)
        k2[n] = {"device_ms": dev_ms, "event_ms": ev_ms, "host_enqueue_ms": host_ms,
                 "kernels": kernels}
    out["k2_by_rows"] = k2
    return out


def serve_phase(gpu: str) -> dict:
    """The server's main path, twice (scripted, policy bots), then the
    checks (a)-(c) and the breakdown. Returns {"launches": K2 launches of
    the policy run, "k2": the small-row timings}."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    ckpts = [f"werewolf={os.path.join(HERE, CKPT)}"]
    try:
        scripted, s_line = serve_run("serve_scripted", 1, None, os.path.join(tmp, "s.json"),
                                     gpu)
        s_rooms = live_rooms(scripted.ctx.host, SERVE_CHECK_ROOMS)
        s_steps = restore_check(scripted, s_rooms, "cuda", None)
        s_cpu = restore_check(scripted, s_rooms, "cpu", None)
        del scripted
        policy, line = serve_run("serve_policy", 5, ckpts, os.path.join(tmp, "p.json"), gpu)
        launches = line["k2_launches"]
        greedy = greedy_check(policy.ctx.host)
        p_rooms = live_rooms(policy.ctx.host, SERVE_CHECK_ROOMS)
        p_steps = restore_check(policy, p_rooms, "cuda", ckpts)
        breakdown = serve_breakdown(policy.ctx.host)
        # the card's busy time in a window, from the device time of one step
        # (engine step and host read; policy bots where they ran) x the steps
        step_dev = {"serve_scripted": breakdown["engine_step_device_ms"]
                    + breakdown["host_read_device_ms"],
                    "serve_policy": breakdown["engine_step_device_ms"]
                    + breakdown["host_read_device_ms"] + breakdown["policy_greedy_device_ms"]}
        idle = {ln["phase"]: 1 - ln["engine_steps"] * step_dev[ln["phase"]] / 1e3
                / ln["window_s"] for ln in (s_line, line)}
        emit({"phase": "serve_checks", "greedy_k2_vs_plain": greedy,
              "device_idle_share_estimate": idle,
              "restored_on_card": {"scripted": {"rooms": s_rooms, "steps": s_steps},
                                   "policy": {"rooms": p_rooms, "steps": p_steps}},
              "restored_on_cpu": {"scripted": {"rooms": s_rooms, "steps": s_cpu}},
              "breakdown": breakdown, "gpu": gpu})
        del policy
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "k2": breakdown["k2_by_rows"]}


# -- the search kernel (S) ------------------------------------------------------

SEARCH_SOURCE = "game_engine_tpu_torch/csrc/search.cu"
# the kernels line's S rows: the decide entry (D = 0) and the request table (D > 0)
SEARCH_ENTRIES = {"search_decide": "ge_search_decide", "search": "ge_search"}
# the kernels' builds by the words of a seat set (template argument NW):
# 1 for rooms of up to 32 seats, 8 past them
SEARCH_KERNELS = {"search_decide": "ge_decide_kernelILi1E", "search": "ge_search_kernelILi1E"}
SEARCH_KERNELS_WIDE = {"search_decide": "ge_decide_kernelILi8E",
                       "search": "ge_search_kernelILi8E"}
K1_KERNELS = {"rollout_kernel": "ge_rollout_kernelILi1E",
              "rollout_kernel_wide": "ge_rollout_kernelILi8E"}
# the pipelines' products and the stages whose rooms or rows past the
# registers' bounds (32 seats, 64 actions) take stages of their own
LG_KERNELS = ("gemm_kernel", "wgrad_kernel", "lg7AttnMixE", "lg11AttnMixWideE", "lg8AttnBwd2E",
              "lg12AttnBwd2WideE", "lg4LossILb0E", "lg4LossILb1E")
# S is the counterpart of C++ host code, not of a pallas_call site
SEARCH_REPLACES = "game_engine_tpu/native/gamesim.cpp:707"
SEARCH_GAMES = ("werewolf", "cult-of-the-depths", "two-truths-and-a-lie")
SEARCH_ROOMS = 64                # live rooms a game in compare_search
SEARCH_R, SEARCH_H = 32, 200     # rollouts x horizon: the serving default
SEARCH_SIZES = ((0, (1, 8, 64, 512, 4096)), (8, (1, 8, 64)))  # decisions a launch by D
SEARCH_PROFILE_SIZES = (512, 4096)  # --profile: lanes a rollout and share busy at these
SEARCH_LANES = (8, 16, 32)
SEARCH_LINE_SIZE = 512           # the kernels line's S: werewolf, 512 decisions, D = 0
SEARCH_PLAIN_CHUNK = 8192        # requests a call of the plain version
EVAL_RUNS = (("werewolf", 200, 32, 200, 0), ("werewolf", 100, 32, 200, 8))
# the JAX package's script at the same arguments, on a host CPU
# (python -m game_engine_tpu.utils.eval_search werewolf 200 32 200 [, ... 100 32 200 8]):
# scripted, minority-searching and majority-searching minority win rates, decisions
EVAL_JAX = {EVAL_RUNS[0]: (0.25, 0.72, 0.0, 4417), EVAL_RUNS[1]: (0.26, 0.65, 0.19, 2643)}


def search_pool(lw, rooms: int, n: int, seed0: int):
    """`rooms` live rooms of `n` seats at several depths of a scripted
    rollout, on the port's native simulator: [(CppRoom.read(), room seed)]."""
    from game_engine_tpu_torch.native import CppGame

    game, out, k = CppGame(lw), [], 0
    while len(out) < rooms:
        seed, k = seed0 + k, k + 1
        room = game.room(n, seed)
        for _ in range((5 * k) % 31):
            if room.read()["done"]:
                break
            room.step(room.policy_actions())
        r = room.read()
        if not r["done"]:
            out.append((r, seed))
    return out


def reads_state(lw, reads, n: int, device: str):
    """The rooms of search_pool as one GameState on `device`."""
    import torch

    from game_engine_tpu_torch.core.state import GameState
    from game_engine_tpu_torch.policies.serve import state_from_read

    ones = [state_from_read(lw, r, n, seed, device) for r, seed in reads]
    return GameState(*(torch.cat(f) for f in zip(*ones)))


def read_of(st: dict, w: int) -> dict:
    """Room w of a state_to_numpy dict as a CppRoom.read() state."""
    return {"phase_index": int(st["phase"][w]), "done": bool(st["done"][w]),
            "winner": int(st["winner"][w]), "prev_index": int(st["prev_phase"][w]),
            "t": int(st["t"][w]),
            **{k: st[k][w].astype("int32") for k in ("bools", "nums", "strs", "pdict", "odict",
                                                      "acted", "choice", "choice_phase")}}


def cpp_decisions(sb, reads, n: int):
    """The decisions of the JAX package's search bots, on the port's C++
    simulator (gamesim.cpp gs_room_search / gs_room_search_scores) on the
    host: (rooms, P) choices, 0 where a seat has no decision."""
    import numpy as np

    from game_engine_tpu_torch.native import CppGame
    from game_engine_tpu_torch.policies.search import _mix

    sc = sb.scoring
    room = CppGame(sb.lowered).room(n, 0)
    out = np.zeros((len(reads), sb.lowered.P), np.int32)
    args = (sb.rollouts, sb.horizon, sc.mode, sc.team_slot, sc.team_codes)
    for i, (r, seed) in enumerate(reads):
        base = _mix(seed, sb.salt)
        for pid in range(1, n + 1):
            if sb.determinize == 0:
                room.write(r)
                out[i, pid - 1] = room.search(pid, *args, base)
                continue
            totals = {}
            for d in range(sb.determinize):  # policies/search.py _search_room_det
                st_d = sb._det.apply(r, pid - 1, n, _mix(base, (pid * 0x01000193 + d) & 0xFFFFFFFF))
                room.write(st_d)
                got = room.search_scores(pid, *args, _mix(base, (0xD0000001 + d) & 0xFFFFFFFF))
                if got is None:
                    break
                for c, v in got.items():
                    totals[c] = totals.get(c, 0) + v
            if totals:
                out[i, pid - 1] = sb._best(totals)
    return out


def host_totals(sb, source, table) -> "np.ndarray":
    """Each request's total by the port's CppRoom.search_scores on the host."""
    import numpy as np

    from game_engine_tpu_torch.core.state import state_to_numpy
    from game_engine_tpu_torch.native import CppGame

    sc = sb.scoring
    st = state_to_numpy(source)
    game, rooms, cache = CppGame(sb.lowered), {}, {}
    out = np.zeros(len(table), np.int64)
    for row, (w, p, c, salt) in enumerate(table.cpu().numpy().tolist()):
        key = (w, p, salt)
        if key not in cache:
            n = int(st["present"][w].sum())
            room = rooms.setdefault(n, game.room(n, 0))
            room.write(read_of(st, w))
            cache[key] = room.search_scores(p + 1, sb.rollouts, sb.horizon, sc.mode,
                                            sc.team_slot, sc.team_codes, salt & 0xFFFFFFFF)
        out[row] = cache[key][c]
    return out


def plain_totals(sb, source, table):
    """Each request's total by search_scores_plain on the card, in chunks."""
    import torch

    from game_engine_tpu_torch.core import search_kernel as SK

    return torch.cat([SK.search_scores_plain(sb.lowered, source, table[a:a + SEARCH_PLAIN_CHUNK],
                                             sb.rollouts, sb.horizon, sb.scoring)
                      for a in range(0, len(table), SEARCH_PLAIN_CHUNK)]).cpu().numpy()


def decided_flat(dec, table_len: int) -> "np.ndarray":
    """A Decided's totals in request-table order (decisions ascending, each
    one's candidates ascending), for the decisions that rolled out."""
    import numpy as np

    counts = dec.counts.reshape(-1).cpu().numpy()
    totals = dec.totals.cpu().numpy()
    flat = np.concatenate([totals[d, :c] for d, c in enumerate(counts) if c >= 2] or
                          [np.zeros(0, np.int64)])
    if len(flat) != table_len:
        raise AssertionError(f"the decide entry rolled out {len(flat)} candidates, "
                             f"the request table holds {table_len}")
    return flat


def compare_search(gpu: str) -> dict:
    """S against the plain version on the card and against the C++ search on
    the host, the three games. D = 0: the decide entry's choices (the bots'
    route) against the plain _decide's and the C++ search's, its totals and
    the request entry's on the same decisions against plain and C++. D = 8:
    the request entry's totals and choices. Returns the worst total
    difference and the decisions checked."""
    import numpy as np

    from game_engine_tpu_torch.core import search_kernel as SK
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.policies.search import SearchBots

    worst, checked, requests = 0, 0, 0
    for game in SEARCH_GAMES:
        lw = lower(compile_game(load_builtin(game)))
        n = min(6, lw.P)
        reads = search_pool(lw, SEARCH_ROOMS, n, 500)
        source = reads_state(lw, reads, n, "cuda")
        for det in (0, 8):
            t0 = time.perf_counter()
            sb = SearchBots(lw, SEARCH_R, SEARCH_H, determinize=det, device="cuda")
            before = (SK.kernel_search.launches, SK.kernel_decide.launches)
            got = sb.actions(source)  # the bots' route: decide entry at D = 0
            want_launches = (before[0], before[1] + 1) if det == 0 else (before[0] + 1, before[1])
            if (SK.kernel_search.launches, SK.kernel_decide.launches) != want_launches:
                raise AssertionError(f"{game} D={det}: launches {before} -> "
                                     f"{(SK.kernel_search.launches, SK.kernel_decide.launches)}")
            decisions = sb.last_call["decisions"]
            line = {"phase": "compare_search", "game": game, "det": det, "rooms": len(reads),
                    "seats": n, "rollouts": SEARCH_R, "horizon": SEARCH_H,
                    "decisions": decisions, "seats_checked": int(got.size)}
            want = cpp_decisions(sb, reads, n)
            if det == 0:
                dec = SK.kernel_decide(lw, source, SEARCH_R, SEARCH_H, sb.scoring, sb.salt)
                plain_got = sb.request_actions(source, plain=True).cpu().numpy()
                src, table, plain = sb.last_launch()
                req_got = sb.request_actions(source).cpu().numpy()
                _, table2, totals = sb.last_launch()
                if not torch_equal(table, table2):
                    raise AssertionError(f"{game}: the two request routes built other tables")
                host = host_totals(sb, src, table)
                flat = decided_flat(dec, len(table))
                line.update({
                    "requests": len(table), "worlds": 0,
                    "choice_diffs_decide_vs_plain_decide": int((got != plain_got).sum()),
                    "choice_diffs_decide_vs_cpp": int((got != want).sum()),
                    "choice_diffs_request_entry_vs_cpp": int((req_got != want).sum()),
                    "decide_total_diffs_vs_plain": int((flat != plain).sum()),
                    "decide_total_diffs_vs_cpp": int((flat != host).sum()),
                    "total_diffs_vs_plain": int((totals != plain).sum()),
                    "total_diffs_vs_cpp": int((totals != host).sum()),
                    "decide_stats": dict(zip(SK.STATS, dec.stats.tolist())),
                    "max_abs_err": int(max(np.abs(totals - plain).max(initial=0),
                                           np.abs(totals - host).max(initial=0),
                                           np.abs(flat - plain).max(initial=0)))})
            else:
                src, table, totals = sb.last_launch()
                plain = plain_totals(sb, src, table)
                host = host_totals(sb, src, table)
                line.update({
                    "requests": len(table), "worlds": sb.last_call["worlds"],
                    "total_diffs_vs_plain": int((totals != plain).sum()),
                    "total_diffs_vs_cpp": int((totals != host).sum()),
                    "choice_diffs_vs_cpp": int((got != want).sum()),
                    "max_abs_err": int(max(np.abs(totals - plain).max(initial=0),
                                           np.abs(totals - host).max(initial=0)))})
            line.update(seconds=time.perf_counter() - t0, gpu=gpu)
            emit(line)
            if any(v for k, v in line.items() if "diffs" in k):
                raise AssertionError(f"compare_search {game} D={det}: {line}")
            if not line["requests"]:
                raise AssertionError(f"compare_search {game} D={det}: nothing was searched")
            worst = max(worst, line["max_abs_err"])
            checked += decisions
            requests += line["requests"]
    emit({"phase": "compare_search_done", "decisions_checked": checked,
          "requests_checked": requests, "max_abs_err": worst})
    return {"max_abs_err": worst, "decisions": checked}


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


def step_counts(steps, rollouts_a_block: int, resident_groups: int) -> dict:
    """The rollouts' engine steps (request-table order) and the time in steps
    they predict on `resident_groups` groups: for a static grid of
    `rollouts_a_block` consecutive rollouts a block (the kernel before the
    persistent grid: a block holds its groups until its longest rollout ends,
    blocks start in order as slots free up) and for the pulled grid (each
    group takes the next rollout when it is free)."""
    import heapq

    import numpy as np

    def makespan(durations, slots: int) -> int:
        free = [0] * slots
        for d in durations.tolist():
            heapq.heapreplace(free, free[0] + d)
        return max(free)

    steps = np.asarray(steps, np.int64)
    pad = -len(steps) % rollouts_a_block
    longest = np.pad(steps, (0, pad)).reshape(-1, rollouts_a_block).max(1)
    static = makespan(longest, max(1, resident_groups // rollouts_a_block))
    pulled = makespan(steps, resident_groups)
    return {"rollouts": len(steps), "mean": float(steps.mean()), "max": int(steps.max()),
            "sum": int(steps.sum()), "static_block_longest_sum": int(longest.sum()),
            "rollouts_a_static_block": rollouts_a_block, "resident_groups": resident_groups,
            "static_makespan_steps": static, "pulled_makespan_steps": pulled,
            "predicted_static_over_pulled": static / pulled}


def search_timing(gpu: str, int32_rate: float, profiled: bool = False) -> dict:
    """S by decisions a launch on werewolf rooms on the card. D = 0: the host
    ms of actions_for_slots with its copies and selection (median of 5),
    launches a call (one decide launch), the decide kernel's ms (CUDA
    events, median of 5) and the request kernel's ms on the same decisions;
    D = 8: the request kernel's. Each with the bound by operations (the
    -DGE_COUNT host build over the call's requests), the rollouts' steps and
    the port's C++ search of the same decisions on one host core. With
    `profiled`, at SEARCH_PROFILE_SIZES also the decide kernel by lanes a
    rollout and its share of groups busy (the -DGE_PROFILE build). Returns
    the kernels line's fields of both entries (SEARCH_LINE_SIZE decisions
    at D = 0)."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core import search_kernel as SK
    from game_engine_tpu_torch.core.state import GameState, state_to_numpy
    from game_engine_tpu_torch.policies.search import SearchBots

    lw, pool, cum = search_timing_pool()
    pool_np = state_to_numpy(pool)
    out, line = {}, None
    for det, sizes in SEARCH_SIZES:
        sb = SearchBots(lw, SEARCH_R, SEARCH_H, determinize=det, device="cuda")
        args = (SEARCH_R, SEARCH_H, sb.scoring)
        for size in sizes:
            slots = list(range(int(np.searchsorted(cum, size)) + 1))
            host_ms = []
            before = (SK.kernel_search.launches, SK.kernel_decide.launches)
            for _ in range(5):
                t0 = time.perf_counter()
                sb.actions_for_slots(pool, slots)
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
            per_call = ((SK.kernel_search.launches - before[0]) / 5,
                        (SK.kernel_decide.launches - before[1]) / 5)
            decisions = sb.last_call["decisions"]
            idx = torch.as_tensor(slots, dtype=torch.long, device="cuda")
            sub = GameState(*(f.index_select(0, idx) for f in pool))
            if det == 0:
                sb.request_actions(pool, slots)  # the same decisions as a request table
            src, table, _ = sb.last_launch()
            req_times = [timed_ms(lambda: SK.kernel_search(lw, src, table, *args))[1]
                         for _ in range(5)]
            row = {"phase": "search_timing", "det": det, "decisions": decisions,
                   "rooms": len(slots), "requests": len(table),
                   "rollouts_a_launch": len(table) * SEARCH_R,
                   "plan": SK.search_plan(lw, len(table) * SEARCH_R),
                   "host_ms": statistics.median(host_ms), "host_ms_all": host_ms,
                   "launches_a_call": {"search": per_call[0], "search_decide": per_call[1]},
                   "request_kernel_ms": statistics.median(req_times),
                   "request_kernel_ms_all": req_times}
            if det == 0:
                times = [timed_ms(lambda: SK.kernel_decide(lw, sub, *args, sb.salt))[1]
                         for _ in range(5)]
                row.update(decide_kernel_ms=statistics.median(times), decide_kernel_ms_all=times)
            t0 = time.perf_counter()
            counts, row["steps"] = search_counts(lw, sb, src, table)
            row["count_seconds"] = time.perf_counter() - t0
            row.update(bound_ms=counts["int_ops"] / int32_rate * 1e3, bound_by="operations",
                       int_ops=counts["int_ops"])
            t0 = time.perf_counter()
            cpp_decisions(sb, [(read_of(pool_np, i), int(pool_np["seed"][i])) for i in slots], 6)
            row.update(cpp_one_core_ms=(time.perf_counter() - t0) * 1e3, gpu=gpu)
            if profiled and det == 0 and size in SEARCH_PROFILE_SIZES:
                want = SK.kernel_decide(lw, sub, *args, sb.salt).actions
                sweep = {}
                for lanes in SEARCH_LANES:
                    got, ms = None, []
                    for _ in range(3):
                        got, t = timed_ms(lambda: SK.kernel_decide(lw, sub, *args, sb.salt,
                                                                   lanes=lanes))
                        ms.append(t)
                    if not torch.equal(got.actions, want):
                        raise AssertionError(f"decide at {lanes} lanes: other choices")
                    sweep[lanes] = statistics.median(ms)
                row["decide_ms_by_lanes"] = sweep
                row["profile"] = SK.profile_decide(lw, sub, *args, sb.salt)
            emit(row)
            if per_call != ((0, 1) if det == 0 else (1, 0)):
                raise AssertionError(f"actions_for_slots launched {per_call} (search, "
                                     "search_decide) a call")
            out[(det, size)] = row
            if det == 0 and size == SEARCH_LINE_SIZE:
                _, plain_ms = timed_ms(lambda: SK.search_scores_plain(lw, src, table, *args))
                t0 = time.perf_counter()
                sb.request_actions(pool, slots, plain=True)
                torch.cuda.synchronize()
                decide_plain_ms = (time.perf_counter() - t0) * 1e3
                line = {"search": {"ms": row["request_kernel_ms"], "plain_ms": plain_ms},
                        "search_decide": {"ms": row["decide_kernel_ms"],
                                          "plain_ms": decide_plain_ms},
                        "bound": (row["bound_ms"], "operations"), "requests": len(table),
                        "decisions": decisions}
    cross = [f"{s}" for (d, s), r in sorted(out.items()) if d == 0
             and r["host_ms"] < r["cpp_one_core_ms"]]
    emit({"phase": "search_timing_done", "card_wins_from_decisions_d0": cross[:1] or None,
          "gpu": gpu})
    return line


def search_timing_pool():
    """search_timing's werewolf rooms: 8192 live rooms of 6 seats at four
    depths of a scripted rollout on the card -> (lowered, the rooms as one
    GameState, the running count of their waiting seats)."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core.engine import BatchedEngine
    from game_engine_tpu_torch.core.state import GameState
    from game_engine_tpu_torch.core.step import waiting_seats
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower

    lw = lower(compile_game(load_builtin("werewolf")))
    eng = BatchedEngine(lw, "cuda")
    parts = []
    for k, depth in enumerate((3, 7, 11, 15)):  # live rooms at four depths
        st = eng.init(2048, 6, np.arange(2048, dtype=np.uint32) + 4096 * k)
        for _ in range(depth):
            st = eng.step(st, eng.bot_actions(st))
        parts.append(st)
    pool = GameState(*(torch.cat(f) for f in zip(*parts)))
    return lw, pool, np.cumsum(waiting_seats(lw, pool).sum(1).cpu().numpy())


def search_counts(lw, sb, src, table) -> tuple:
    """The -DGE_COUNT host build over a request table: (its counts, the
    rollouts' steps by step_counts at the grid's plan)."""
    import torch

    from game_engine_tpu_torch.core import search_kernel as SK
    from game_engine_tpu_torch.core.state import GameState

    counts = SK.count_search(lw, GameState(*(f.cpu() for f in src)), table.cpu(), sb.rollouts,
                             sb.horizon, sb.scoring)
    n = len(table) * sb.rollouts
    plan = SK.search_plan(lw, n)
    warp_slots = torch.cuda.get_device_properties(0).multi_processor_count * plan["warps_per_sm"]
    old = widen_lanes(lw.P, n, warp_slots)  # the static grid's lanes
    return counts, step_counts(counts.pop("steps"), plan["threads_per_block"] // old,
                               warp_slots * 32 // old)


def search_steps(gpu: str) -> dict:
    """The steps of every rollout of search_timing's SEARCH_PROFILE_SIZES
    decision tables (D = 0, werewolf; the -DGE_COUNT host build), and what
    they predict for a static grid against the pulled one. No timing."""
    import numpy as np

    from game_engine_tpu_torch.policies.search import SearchBots

    lw, pool, cum = search_timing_pool()
    sb = SearchBots(lw, SEARCH_R, SEARCH_H, device="cuda")
    out = {}
    for size in SEARCH_PROFILE_SIZES:
        slots = list(range(int(np.searchsorted(cum, size)) + 1))
        sb.request_actions(pool, slots)
        src, table, _ = sb.last_launch()
        _, out[size] = search_counts(lw, sb, src, table)
        emit({"phase": "search_steps", "decisions": sb.last_call["decisions"],
              "requests": len(table), **out[size], "gpu": gpu})
    return out


def widen_lanes(P: int, n: int, warp_slots: int) -> int:
    """room_step.cuh widen_lanes: lanes a rollout's room."""
    G = 1
    while G < P and G < 32:
        G *= 2
    while G < 32 and n * 2 * G // 32 <= warp_slots:
        G *= 2
    return G


SEARCH_BUCKETS = ((0, 0), (1, 8), (9, 64), (65, 512), (513, None))  # decisions a launch


class SearchLaunchSizes:
    """While entered, counts each launch of S's entries made through
    SearchBots (actions_for_slots, native_actions) by the decisions it made
    (SEARCH_BUCKETS; the bots' last_call, read after the call, which waits
    for a decide launch's count): .counts = {entry: {bucket: launches}}."""

    def __init__(self):
        self.counts = {e: {self.name(b): 0 for b in SEARCH_BUCKETS} for e in SEARCH_ENTRIES}

    @staticmethod
    def name(bucket) -> str:
        lo, hi = bucket
        return str(lo) if lo == hi else f"{lo}-{hi}" if hi else f">{lo - 1}"

    def __enter__(self):
        from game_engine_tpu_torch.core import search_kernel as SK
        from game_engine_tpu_torch.policies import search as PS

        self.saved = {m: getattr(PS.SearchBots, m) for m in ("actions_for_slots", "native_actions")}

        def wrap(fn):
            def counted(bots, *args, **kwargs):
                before = (SK.kernel_decide.launches, SK.kernel_search.launches)
                out = fn(bots, *args, **kwargs)
                for entry, now, was in zip(("search_decide", "search"), (
                        SK.kernel_decide.launches, SK.kernel_search.launches), before):
                    if now > was:
                        n = bots.last_call["decisions"]
                        bucket = next(b for b in SEARCH_BUCKETS if b[1] is None or n <= b[1])
                        self.counts[entry][self.name(bucket)] += now - was
                return out
            return counted

        for m, fn in self.saved.items():
            setattr(PS.SearchBots, m, wrap(fn))
        return self

    def __exit__(self, *exc):
        from game_engine_tpu_torch.policies import search as PS

        for m, fn in self.saved.items():
            setattr(PS.SearchBots, m, fn)


def serve_search_phase(gpu: str) -> dict:
    """The search bots' serving path: `--bot-search all` on the torch backend
    (serve_search), then on the native backend (serve_native: the engine on
    the host, the search on the card), each at the serving shape, with
    SERVE_CHECK_ROOMS rooms restored from their journals bit for bit.
    Returns the search launches of each run."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_search_")
    out = {}
    try:
        for name, backend in (("serve_search", "torch"), ("serve_native", "native")):
            srv, line = serve_run(name, 1, None, os.path.join(tmp, f"{backend}.json"), gpu,
                                  backend=backend, bot_search=["all"])
            rids = live_rooms(srv.ctx.host, SERVE_CHECK_ROOMS)
            steps = restore_check(srv, rids, "cuda", None, backend=backend, bot_search=["all"])
            emit({"phase": f"{name}_restore", "rooms": rids, "steps": steps,
                  "equal_bit_for_bit": True, "gpu": gpu})
            out[name] = line["search_launches"]
            del srv
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def eval_phase(gpu: str) -> dict:
    """utils/eval_search on the card at EVAL_RUNS: win rates and
    s_per_decision; returns the launches of S's entries."""
    from game_engine_tpu_torch.core.search_kernel import kernel_decide, kernel_search
    from game_engine_tpu_torch.utils.eval_search import eval_game

    before = (kernel_search.launches, kernel_decide.launches)
    for game, rooms, rollouts, horizon, det in EVAL_RUNS:
        t0 = time.perf_counter()
        line = eval_game(game, rooms, rollouts, horizon, det, device="cuda")
        got = tuple(line[k] for k in ("scripted_minority_or_seat1_win", "minority_search_win",
                                      "majority_search_minority_win", "decisions"))
        want = EVAL_JAX[(game, rooms, rollouts, horizon, det)]
        emit({"phase": "eval_search", **line, "seconds": time.perf_counter() - t0,
              "equals_jax_script": got == want, "gpu": gpu})
        if got != want:
            raise AssertionError(f"eval_search {game} D={det}: {got}, the JAX script's {want}")
    return {"search": kernel_search.launches - before[0],
            "search_decide": kernel_decide.launches - before[1]}


# -- the league, the pipelined learner, the matchup evaluator, the arena ------

LEAGUE_START = "docs/checkpoints/attn_werewolf_league_anchor_u600.npz"
LEAGUE_OPP = "docs/checkpoints/attn_werewolf_league_noanchor_u300.npz"
MATCHUP_CKPTS = tuple(f"docs/checkpoints/attn_werewolf_{n}.npz" for n in (
    "u120", "league_anchor_u600", "league_noanchor_u300", "league_noanchor_u600_collapsed"))
# 64 steps, not 128: the loop is host-bound (a pair took 3.6 s at 128 steps on
# the card), so steps, not rooms, set its time
MATCHUP_ROOMS, MATCHUP_STEPS, MATCHUP_SEED = 1024, 64, 777
PIPE_ROUNDS = 3
ARENA_ROOMS, EXPLOIT_ROOMS = 16, 32


def learner_start(path: str):
    """(params, PPOConfig of the learner path at its full shape) for a
    shipped checkpoint, loaded as new tensors on the card."""
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import ppo as P

    params, net = N.load_policy(os.path.join(HERE, path), "cuda")
    return params, P.PPOConfig(horizon=HORIZON, epochs=4, fused_net=True, net=net)


def clone(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


def max_change(params: dict, before: dict) -> float:
    return max(float((params[k].detach() - before[k].detach()).abs().max()) for k in before)


def check_launches(what: str, want: dict) -> dict:
    """The policy kernels' launches since zero_launches against `want`."""
    got = policy_launches()
    if got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")
    return got


def check_packs(what: str, packs: int, states: int) -> int:
    """At most one packing of the weights per parameter state."""
    if packs != states:
        raise AssertionError(f"{what}: {packs} packs for {states} parameter states")
    return packs


def check_league_main(updates: int) -> tuple:
    """(launches, snapshot-arm updates) of run.main --league since
    zero_launches: per update 33 K2 (anchor arm) or 65 (snapshot arm) and 4
    K4."""
    got = policy_launches()
    k2_extra = got["policy_forward"] - updates * (HORIZON + 1)  # 32 more a snapshot arm
    if got["ppo_loss_grad"] != 4 * updates or got["policy_backward"] or k2_extra % HORIZON \
            or not 0 <= k2_extra <= updates * HORIZON:
        raise AssertionError(f"run.main --league launched {got}")
    return got, k2_extra // HORIZON


def league_phase(lowered, gpu: str) -> dict:
    """train/league.py at the learner's full shape from the shipped league
    checkpoint: one snapshot-arm update against another shipped checkpoint
    and one anchor-arm update, beside one sync train step from the same
    start; then run.main --league. Returns the policy kernels' launches."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.policies import fused as FZ
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import league as L
    from game_engine_tpu_torch.train import ppo as P
    from game_engine_tpu_torch.train import run as R

    params, cfg = learner_start(LEAGUE_START)
    opp, _ = learner_start(LEAGUE_OPP)
    state = start_state = init_state(lowered, ROOMS, 6, np.arange(ROOMS, dtype=np.uint32) + 41,
                                     device="cuda")
    sync = clone(params)
    opt = P.make_optimizer(params, cfg)
    gen = torch.Generator(device="cuda").manual_seed(21)
    total = dict.fromkeys(POLICY_REPLACES, 0)
    for arm, scripted in (("snapshot", False), ("anchor", True)):
        step = L.make_league_train_step(lowered, cfg, scripted_opponent=scripted)
        before = clone(params)
        zero_launches()
        packs = FZ._packed.packs
        t0 = time.perf_counter()
        state, m = step(params, params if scripted else opp, opt, state, gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # K2: the learner's 32 steps (and the opponent's), the bootstrap; K4: an epoch
        got = check_launches(f"the league's {arm} update", {
            "policy_forward": (1 if scripted else 2) * HORIZON + 1, "policy_backward": 0,
            "ppo_loss_grad": cfg.epochs})
        # theta_0 (and the opponent's), then theta_1 to theta_3 in the later epochs
        packs = check_packs(f"league {arm}", FZ._packed.packs - packs,
                            (1 if scripted else 2) + cfg.epochs - 1)
        loss, rate = float(m["loss"]), float(m["learner_win_rate"])
        moved = max_change(params, before)
        if not (np.isfinite(loss) and 0.0 <= rate <= 1.0 and moved > 0):
            raise AssertionError(f"league {arm}: loss {loss}, win rate {rate}, moved {moved}")
        emit({"phase": "league", "arm": arm, "rooms": ROOMS, "horizon": HORIZON,
              "epochs": cfg.epochs, "start": LEAGUE_START,
              "opponent": "scripted" if scripted else LEAGUE_OPP, "seconds": seconds,
              "unroll_ms": m["unroll_ms"], "update_ms": m["update_ms"],
              "step_ms": m["unroll_ms"] + m["update_ms"],
              "loss": loss, "v_loss": float(m["v_loss"]), "entropy": float(m["entropy"]),
              "episodes": int(m["episodes"]), "learner_win_rate": rate,
              "max_param_change": moved, "launches": got, "packs": packs, "gpu": gpu})
        for k in total:
            total[k] += got[k]
    # the sync train step from the same start, for the comparison
    _, sm = P.make_train_step(lowered, cfg)(sync, P.make_optimizer(sync, cfg), start_state,
                                           torch.Generator(device="cuda").manual_seed(21))
    emit({"phase": "league_sync_step", "unroll_ms": sm["unroll_ms"],
          "update_ms": sm["update_ms"], "step_ms": sm["unroll_ms"] + sm["update_ms"],
          "gpu": gpu})

    tmp = tempfile.mkdtemp(prefix="chip_smoke_league_")
    try:
        argv = ["--device", "cuda", "--arch", "attn", "--hidden", "256", "--batch", str(ROOMS),
                "--players", "6", "--horizon", str(HORIZON), "--epochs", "4", "--updates", "3",
                "--eval-batch", "0", "--resume", os.path.join(HERE, LEAGUE_START), "--league",
                "--league-snapshot-every", "1", "--league-dir", tmp]
        out = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            trained = R.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got, snapshot_arms = check_league_main(3)
        train = [json.loads(ln) for ln in out.getvalue().splitlines()
                 if ln.startswith("{") and '"train"' in ln][-1]
        snaps = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
        if snaps != [f"snap_u{u:05d}.npz" for u in (1, 2, 3)]:
            raise AssertionError(f"--league-dir holds {snaps}")
        back, back_cfg = N.load_policy(os.path.join(tmp, snaps[-1]), "cuda")
        if back_cfg != cfg.net or not all(torch.equal(back[k], trained[k].detach())
                                          for k in back):
            raise AssertionError("the last league snapshot does not reload as the trained params")
        if not np.isfinite(train["loss"]) or train["pool_size"] != 4:
            raise AssertionError(f"run.main --league train line {train}")
        emit({"phase": "league_run_main", "argv": [a if a != tmp else "<tmp>" for a in argv],
              "seconds": seconds, "train": train, "snapshots": snaps,
              "snapshot_reloads": True, "launches": got, "snapshot_arm_updates": snapshot_arms,
              "gpu": gpu})
        for k in total:
            total[k] += got[k]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def host_syncs(fn) -> tuple:
    """(how many times `fn` makes the host wait for the card, {file:line of
    the Python call that waited: times}) by torch's sync debug mode: each
    synchronizing call warns once, from the line that made it."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in seen
                                if "synchroniz" in str(w.message))
    return sum(where.values()), dict(where)


def pipeline_phase(lowered, gpu: str) -> dict:
    """train/pipeline.py at the learner's full shape: PIPE_ROUNDS rounds on
    two streams against the same rounds in serial order from the same
    start, in turns (serial, two streams, two streams, serial): params and
    engine state bit for bit equal. Returns the policy kernels' launches
    of one two-stream run."""
    import dataclasses

    import numpy as np
    import torch

    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.train import ppo as P
    from game_engine_tpu_torch.train.pipeline import make_pipeline, run_pipelined

    params0, cfg = learner_start(LEAGUE_START)
    pair = make_pipeline(lowered, cfg)
    start = init_state(lowered, ROOMS, 6, np.arange(ROOMS, dtype=np.uint32) + 61,
                       device="cuda")
    # each stage alone, in order, from the same start
    p = clone(params0)
    opt = P.make_optimizer(p, cfg)
    gen = torch.Generator(device="cuda").manual_seed(71)
    (_, traj, last_obs), collect_ms = timed_ms(lambda: pair[0](p, start, gen))
    _, update_ms = timed_ms(lambda: pair[1](p, opt, traj, last_obs))
    del traj, last_obs
    syncs, sync_sources = host_syncs(
        lambda: P.make_unroll(lowered, dataclasses.replace(cfg, horizon=1))(p, start, gen))
    st_waits = {k: v for k, v in sync_sources.items() if "step_kernel" in k}
    if st_waits:
        raise AssertionError(f"ST's wrappers made the host wait: {st_waits}")

    def run(overlap: bool):
        params = clone(params0)
        opt = P.make_optimizer(params, cfg)
        gen = torch.Generator(device="cuda").manual_seed(71)
        zero_launches()
        (state, m), ms = timed_ms(lambda: run_pipelined(
            lowered, cfg, params, opt, start, gen, PIPE_ROUNDS, pipeline=pair, device="cuda",
            overlap=overlap))
        got = check_launches("the pipeline", {
            "policy_forward": (PIPE_ROUNDS + 1) * HORIZON + PIPE_ROUNDS, "policy_backward": 0,
            "ppo_loss_grad": PIPE_ROUNDS * cfg.epochs})
        if not np.isfinite(float(m["loss"])):
            raise AssertionError("pipeline: loss is not finite")
        return {"params": params, "state": state, "ms": ms, "launches": got}

    runs = [("serial", run(False)), ("two_streams", run(True)), ("two_streams", run(True)),
            ("serial", run(False))]
    ref = runs[0][1]
    diffs = []
    for name, r in runs[1:]:
        same_params = all(torch.equal(r["params"][k], ref["params"][k]) for k in ref["params"])
        same_state = all(torch.equal(x, y) for x, y in zip(r["state"], ref["state"]))
        diffs.append({"order": name, "params_equal": same_params, "state_equal": same_state,
                      "max_param_diff": max_change(r["params"], ref["params"])})
    if not all(d["params_equal"] and d["state_equal"] for d in diffs):
        raise AssertionError(f"the pipeline's orders disagree: {diffs}")
    if max_change(ref["params"], params0) <= 0:
        raise AssertionError("the pipeline did not move the params")
    steps = PIPE_ROUNDS * ROOMS * HORIZON  # env-steps the updates consume
    by_order = {}
    for name, r in runs:
        by_order.setdefault(name, []).append(r["ms"])
    emit({"phase": "pipeline", "rooms": ROOMS, "horizon": HORIZON, "epochs": cfg.epochs,
          "rounds": PIPE_ROUNDS, "collect_ms": collect_ms, "update_ms": update_ms,
          "sum_ms": collect_ms + update_ms, "max_ms": max(collect_ms, update_ms),
          "call_ms": by_order, "round_ms": {
              k: [(ms - collect_ms) / PIPE_ROUNDS for ms in v] for k, v in by_order.items()},
          "train_env_steps_per_s": {k: [steps / (ms / 1e3) for ms in v]
                                    for k, v in by_order.items()},
          "bitwise_equal_to_serial": diffs, "launches": runs[1][1]["launches"],
          "actor_stream_priority": -1, "learner_stream_priority": 0,
          "host_syncs_per_unroll_step": syncs, "host_sync_sources": sync_sources,
          "gpu": gpu})
    return runs[1][1]["launches"]


def matchup_phase(lowered, gpu: str) -> dict:
    """evaluate.matchup_table over the four shipped attn werewolf
    checkpoints (16 ordered pairs): the K2 route twice (the same table),
    then the plain route from the same generator seeds, every entry within
    3 binomial standard errors of the K2 route's. Returns the policy
    kernels' launches of the first K2 run."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import evaluate as E
    from game_engine_tpu_torch.train import ppo as P

    paths = [os.path.join(HERE, c) for c in MATCHUP_CKPTS]
    net = N.load_policy(paths[0], "cpu")[1]
    pairs = len(paths) ** 2

    def table(fused: bool):
        counts = {}
        t0 = time.perf_counter()
        tab = E.matchup_table(lowered, P.PPOConfig(net=net, fused_net=fused), paths,
                              MATCHUP_ROOMS, MATCHUP_STEPS, 6, MATCHUP_SEED, device="cuda",
                              counts=counts)
        torch.cuda.synchronize()
        return tab, counts, (time.perf_counter() - t0) * 1e3 / pairs

    zero_launches()
    k2_tab, k2_counts, k2_ms = table(True)
    got = check_launches("the matchup", {"policy_forward": pairs * MATCHUP_STEPS * 2,
                                         "policy_backward": 0, "ppo_loss_grad": 0})
    again, again_counts, again_ms = table(True)
    if again_counts != k2_counts:
        raise AssertionError("the K2 matchup gave another table the second time")
    zero_launches()
    plain_tab, plain_counts, plain_ms = table(False)
    if any(policy_launches().values()):
        raise AssertionError(f"the plain matchup launched {policy_launches()}")
    worst = 0.0
    for key, (w1, n1) in k2_counts.items():
        w2, n2 = plain_counts[key]
        if min(n1, n2) == 0:
            raise AssertionError(f"matchup {key}: no episode ended")
        p = min(max((w1 + w2) / (n1 + n2), 0.5 / (n1 + n2)), 1 - 0.5 / (n1 + n2))
        se = (p * (1 - p) * (1 / n1 + 1 / n2)) ** 0.5
        worst = max(worst, abs(w1 / n1 - w2 / n2) / se)
    if not worst <= 3.0:
        raise AssertionError(f"a K2 matchup entry lies {worst} standard errors from plain")
    emit({"phase": "matchup", "checkpoints": list(MATCHUP_CKPTS), "rooms": MATCHUP_ROOMS,
          "steps": MATCHUP_STEPS, "pairs": pairs, "table": k2_tab, "elo": E.elo_fit(k2_tab),
          "plain_table": plain_tab, "plain_elo": E.elo_fit(plain_tab),
          "episodes": int(sum(n for _, n in k2_counts.values())),
          "worst_standard_errors_from_plain": worst, "k2_repeat_equal": True,
          "ms_per_pair": k2_ms, "ms_per_pair_repeat": again_ms, "plain_ms_per_pair": plain_ms,
          "launches": got, "gpu": gpu})
    return got


def kernel_counts() -> dict:
    """Every policy kernel's launches and S's entries' since zero_launches."""
    from game_engine_tpu_torch.core.search_kernel import kernel_decide, kernel_search

    return {**policy_launches(), "search": kernel_search.launches,
            "search_decide": kernel_decide.launches}


def arena_phase(gpu: str) -> dict:
    """utils/arena.py on the card: werewolf, ARENA_ROOMS rooms, tiers
    scripted, search-det8 and the attn checkpoint, twice (the same table);
    the search tiers launch S, the checkpoint tier K2 on the tensor cores.
    Then utils/eval_exploit.py at EXPLOIT_ROOMS rooms. Returns the
    launches of each."""
    import contextlib
    import io

    from game_engine_tpu_torch.utils import arena as AR
    from game_engine_tpu_torch.utils import eval_exploit as EX

    specs = ["scripted", "search-det8", os.path.join(HERE, CKPT)]
    runs = []
    for _ in range(2):
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            out = AR.run_arena("werewolf", ARENA_ROOMS, specs, device="cuda")
        runs.append((out, time.perf_counter() - t0, kernel_counts()))
    (out, seconds, got), (again, again_s, _) = runs
    if again != out:
        raise AssertionError("the arena gave another table the second time")
    if not got["policy_forward"] or not got["search"]:
        raise AssertionError(f"the arena launched {got}")
    emit({"phase": "arena", **out, "seconds": [seconds, again_s], "repeat_equal": True,
          "errors": 0, "launches": got, "gpu": gpu})

    zero_launches()
    t0 = time.perf_counter()
    ex = EX.run_exploit("werewolf", os.path.join(HERE, CKPT), EXPLOIT_ROOMS, 32, 200, 0,
                        device="cuda")
    seconds = time.perf_counter() - t0
    ex_got = kernel_counts()
    rates = [v for k, v in ex.items() if k.endswith(("_scripted", "_search", "_learned"))]
    if not ex_got["policy_forward"] or not ex_got["search_decide"] \
            or not all(0.0 <= r <= 1.0 for r in rates):
        raise AssertionError(f"eval_exploit: {ex}, launches {ex_got}")
    emit({"phase": "exploit", **{k: v for k, v in ex.items() if k != "ckpt"}, "ckpt": CKPT,
          "seconds": seconds, "launches": ex_got, "gpu": gpu})
    return {"arena": got, "exploit": ex_got}


# -- multi-device: the (data, model) mesh over ranks ----------------------------

MD_SEED0, MD_GEN = 81, 91     # the rooms' first seed and every rank's sampling seed
MD_DP = (2, 4)                # data ranks sharing the card over gloo
MD_ROUNDS = 2                 # the sharded pipeline's rounds
MD_CURVE = {"per_rank": 1024, "global_batch": ROOMS, "horizon": HORIZON, "epochs": 4,
            "roll_steps": STEPS, "net": {"hidden": 256, "arch": "attn"}, "seats": 6,
            "train_steps": 2}
MD_KERNELS = ("rollout", "policy_forward", "policy_backward", "ppo_loss_grad", "engine_step",
              "step", "reset_done", "bot_actions", "step_reset", "observe", "rewards", "sample")


def md_spec(cfg, **extra) -> dict:
    """parallel/parity.py's spec of the learner's full shape from CKPT."""
    import dataclasses

    return {"game": "werewolf", "seats": 6, "rooms": ROOMS, "start_seed": MD_SEED0,
            "gen_seed": MD_GEN, "ckpt": os.path.join(HERE, CKPT),
            "net": dataclasses.asdict(cfg.net),
            "ppo": {"horizon": cfg.horizon, "epochs": cfg.epochs, "fused_net": True},
            "device": "cuda", **extra}


def add_launches(total: dict, got: dict) -> None:
    for k in MD_KERNELS:
        total[k] += got.get(k, 0)


def md_nccl_world_of_one(lowered, params0, cfg, gpu: str) -> dict:
    """The mesh-wrapped train step on a world of one over NCCL against the
    mesh-less step, 2 updates each from the same start: params, rooms and
    metrics bit for bit, through K2 and K4. Returns the mesh run's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.parallel.mesh import make_mesh
    from game_engine_tpu_torch.train import ppo as P

    start = init_state(lowered, ROOMS, 6, np.arange(ROOMS, dtype=np.uint32) + MD_SEED0,
                       device="cuda")
    mesh = make_mesh(1, backend="nccl", device="cuda")
    runs = []
    try:
        for m in (None, mesh):
            params = clone(params0)
            opt = P.make_optimizer(params, cfg)
            gen = torch.Generator(device="cuda").manual_seed(MD_GEN)
            step = P.make_train_step(lowered, cfg, m)
            state, metrics = start, []
            zero_launches()
            t0 = time.perf_counter()
            for _ in range(2):
                state, met = step(params, opt, state, gen)
                metrics.append(met)
            torch.cuda.synchronize()
            got = check_launches("the mesh-wrapped train step" if m else "the train step", {
                "policy_forward": 2 * (HORIZON + 1), "policy_backward": 0,
                "ppo_loss_grad": 2 * cfg.epochs})
            runs.append({"params": params, "state": state, "metrics": metrics, "launches": got,
                         "seconds": time.perf_counter() - t0})
    finally:
        dist.destroy_process_group()
    ref, got = runs
    same = {"params": all(torch.equal(ref["params"][k], got["params"][k]) for k in ref["params"]),
            "state": all(torch.equal(x, y) for x, y in zip(ref["state"], got["state"])),
            "metrics": all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                           for a, b in zip(ref["metrics"], got["metrics"])
                           for k in a if not k.endswith("_ms"))}
    emit({"phase": "multidevice_nccl", "world": 1, "backend": "nccl", "mesh": mesh.shape,
          "rooms": ROOMS, "horizon": HORIZON, "epochs": cfg.epochs, "updates": 2,
          "bitwise_equal": same, "loss": [float(m["loss"]) for m in got["metrics"]],
          "step_ms": [m["unroll_ms"] + m["update_ms"] for m in got["metrics"]],
          "mesh_less_step_ms": [m["unroll_ms"] + m["update_ms"] for m in ref["metrics"]],
          "launches": got["launches"], "gpu": gpu})
    if not all(same.values()):
        raise AssertionError(f"the NCCL world of one differs from the mesh-less step: {same}")
    return got["launches"]


def card_of(device: str) -> int:
    """The card index of a rank's device string ("cuda:3" -> 3)."""
    return int(device.split(":")[1])


def check_own_card(what: str, rank: dict, want: dict) -> None:
    """A rank's K2 / K4 launches (`want`: kernel -> count), on its own card,
    the one it reports: the only card it held a tensor on (a wrapper
    launches on its tensors' card)."""
    card = card_of(rank["device"])
    got = {k: rank["launches"][k] for k in want}
    if got != want or rank["cards"] != [card]:
        raise AssertionError(f"{what} on {rank['device']} launched {got}, not {want}, "
                             f"holding tensors on cards {rank['cards']}")


def check_one_card_a_rank(what: str, devices: list) -> None:
    """NCCL's ranks: rank r on cuda:r, all different."""
    if devices != [f"cuda:{r}" for r in range(len(devices))]:
        raise AssertionError(f"{what}: the ranks ran on {devices}, not one card a rank")


def md_data_parallel(cfg, gpu: str, backend: str = "gloo") -> dict:
    """dp = 2 and dp = 4 against dp = 1 in one world of 4 ranks (over gloo
    sharing the card, or over NCCL one card a rank): the rooms and actions
    after the first unroll exact (a differing action is reported with its
    sampling margin), the first update's summed K4 gradients within
    compare_policy's tolerance, every rank's K2 and K4 launched on its own
    card. Returns the launches of every rank."""
    import numpy as np

    from game_engine_tpu_torch.core.state import GameState
    from game_engine_tpu_torch.parallel import parity
    from game_engine_tpu_torch.parallel.launch import run_ranks

    meshes = [(1, 1)] + [(n, 1) for n in MD_DP]
    t0 = time.perf_counter()
    out = run_ranks(parity.first_update, max(MD_DP),
                    md_spec(cfg, meshes=meshes, backend=backend), backend=backend,
                    device="cuda", timeout=600)
    seconds = time.perf_counter() - t0
    one = out[0]["1x1"]
    total = dict.fromkeys(MD_KERNELS, 0)
    results = {}
    for n in MD_DP:
        ranks = [r[f"{n}x1"] for r in out[:n]]
        for r in ranks:  # every rank: 32 K2 a step + the bootstrap, one K4
            check_own_card(f"dp={n}: a rank", r, {"policy_forward": HORIZON + 1,
                                                  "ppo_loss_grad": 1})
            add_launches(total, r["launches"])
        state_equal = {f: bool(np.array_equal(np.concatenate([r["state"][i] for r in ranks]),
                                              one["state"][i]))
                       for i, f in enumerate(GameState._fields)}
        actions = np.concatenate([r["actions"] for r in ranks], 1)
        differ = np.argwhere(actions != one["actions"])
        margins = [float(one["margins"][tuple(ix)]) for ix in differ[:16]]
        grad_err = max(float(np.abs(r["grads"][k] - g).max() / (np.abs(g).max() + 1e-6))
                       for r in ranks for k, g in one["grads"].items())
        loss_err = max(abs(float(r["loss"]) - float(one["loss"])) / abs(float(one["loss"]))
                       for r in ranks)
        results[n] = {"devices": [r["device"] for r in ranks],
                      "state_equal": all(state_equal.values()), "fields_differing":
                      [f for f, ok in state_equal.items() if not ok],
                      "actions_differing": int(len(differ)),
                      "differing_at": differ[:16].tolist(), "their_margins": margins,
                      "grad_max_rel_err": grad_err, "loss_rel_err": loss_err,
                      "launches_per_rank": ranks[0]["launches"],
                      "cards_held": [r["cards"] for r in ranks]}
    acted = np.isfinite(one["margins"])
    emit({"phase": "multidevice_dp", "backend": backend,
          "ranks_share_one_card": backend == "gloo", "rooms": ROOMS, "horizon": HORIZON,
          "tolerance_grad": TOL_GRAD, "dp1_device": one["device"],
          "dp1_min_sampling_margin": float(one["margins"][acted].min()), "by_dp": results,
          "seconds": seconds, "gpu": gpu})
    for n, r in results.items():
        if backend == "nccl":
            check_one_card_a_rank(f"dp={n}", r["devices"])
        if r["actions_differing"] or not r["state_equal"]:
            raise AssertionError(f"dp={n}: the first unroll differs from dp=1: {r}")
        check(f"dp={n}: the first update's summed K4 gradients", r["grad_max_rel_err"],
              TOL_GRAD)
    return total


MD_REPLICA_UPDATES = 2


def md_replicas(params0, cfg, gpu: str) -> dict:
    """MD_REPLICA_UPDATES full updates at dp = 4 over NCCL, one card a
    rank, from params0: rank 0's parameters moved, every rank's parameters
    and Adam state bit for bit equal to rank 0's (NCCL hands each rank the
    same reduced gradient bits), every rank's K2 and K4 on its own card.
    Returns the ranks' launches."""
    import numpy as np

    from game_engine_tpu_torch.parallel import parity
    from game_engine_tpu_torch.parallel.launch import run_ranks

    n = max(MD_DP)
    t0 = time.perf_counter()
    out = run_ranks(parity.dp_updates, n,
                    md_spec(cfg, n=n, updates=MD_REPLICA_UPDATES, backend="nccl"),
                    backend="nccl", device="cuda", timeout=600)
    seconds = time.perf_counter() - t0
    u = MD_REPLICA_UPDATES
    total = dict.fromkeys(MD_KERNELS, 0)
    for r in out:
        check_own_card("a replica", r, {"policy_forward": u * (HORIZON + 1),
                                        "ppo_loss_grad": u * cfg.epochs})
        add_launches(total, r["launches"])
    first = out[0]
    moved = max(float(np.abs(first["params"][k] - v.detach().cpu().numpy()).max())
                for k, v in params0.items())
    differ = {f"rank {i}": [k for k in first["params"]
                            if not np.array_equal(r["params"][k], first["params"][k])
                            or any(not np.array_equal(r["adam"][k][s], x)
                                   for s, x in first["adam"][k].items())]
              for i, r in enumerate(out[1:], 1)}
    emit({"phase": "multidevice_replicas", "backend": "nccl", "dp": n, "updates": u,
          "rooms": ROOMS, "devices": [r["device"] for r in out],
          "adam_state": sorted(first["adam"][next(iter(first["adam"]))]),
          "rank0_params_max_abs_update": moved,
          "params_or_adam_differing_from_rank_0": differ, "seconds": seconds,
          "launches_per_rank": first["launches"], "gpu": gpu})
    check_one_card_a_rank("the replicas", [r["device"] for r in out])
    if not moved > 0:
        raise AssertionError(f"rank 0's parameters did not move in {u} updates")
    if any(differ.values()):
        raise AssertionError(f"replicas differ from rank 0 after {u} updates: {differ}")
    return total


def md_pipeline(lowered, params0, cfg, gpu: str, backend: str = "gloo",
                learners=(1,)) -> dict:
    """run_pipelined_sharded with 1 actor + each count of learner ranks
    (over gloo sharing the card, or over NCCL one card a rank), MD_ROUNDS
    rounds, against run_pipelined in this process from the same start: at
    1 learner params, rooms and metrics bit for bit; at more, whose update
    sums its gradients over the learners, the updates (params - params0)
    within TOL_GRAD: max |update - run_pipelined's| / max |run_pipelined's|.
    Returns the ranks' launches."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.parallel import parity
    from game_engine_tpu_torch.parallel.launch import run_ranks
    from game_engine_tpu_torch.train import ppo as P
    from game_engine_tpu_torch.train.pipeline import run_pipelined

    params = clone(params0)
    opt = P.make_optimizer(params, cfg)
    start = parity.start_of(md_spec(cfg), "cuda")
    state, metrics = run_pipelined(lowered, cfg, params, opt, start,
                                   torch.Generator(device="cuda").manual_seed(MD_GEN),
                                   MD_ROUNDS, device="cuda")
    torch.cuda.synchronize()
    ref = {k: v.detach().cpu().numpy() for k, v in params.items()}
    p0 = {k: v.detach().cpu().numpy() for k, v in params0.items()}
    ref_update = max(float(np.abs(g - p0[k]).max()) for k, g in ref.items())
    total = dict.fromkeys(MD_KERNELS, 0)
    for n_learn in learners:
        spec = md_spec(cfg, actors=1, learners=n_learn, rounds=MD_ROUNDS, backend=backend)
        t0 = time.perf_counter()
        out = run_ranks(parity.pipeline, 1 + n_learn, spec, backend=backend, device="cuda",
                        timeout=600)
        seconds = time.perf_counter() - t0
        actor, learner = out[0], out[1]
        same = {"params": all(np.array_equal(r["params"][k], ref[k]) for r in out for k in ref),
                "state": all(np.array_equal(a, b.cpu().numpy())
                             for a, b in zip(actor["state"], state)),
                "metrics": all(np.array_equal(learner["metrics"][k], metrics[k].cpu().numpy())
                               for k in metrics)}
        update_err = max(float(np.abs(r["params"][k] - g).max())
                         for r in out for k, g in ref.items()) / ref_update
        want = {"actor": (HORIZON * (MD_ROUNDS + 1), 0),
                "learner": (MD_ROUNDS, MD_ROUNDS * cfg.epochs)}
        for r in out:
            got = (r["launches"]["policy_forward"], r["launches"]["ppo_loss_grad"])
            if got != want[r["role"]]:
                raise AssertionError(f"the sharded pipeline's {r['role']} launched "
                                     f"{r['launches']}")
            add_launches(total, r["launches"])
        emit({"phase": "multidevice_pipeline", "actors": 1, "learners": n_learn,
              "rounds": MD_ROUNDS, "backend": backend, "rooms": ROOMS,
              "devices": [r["device"] for r in out], "bitwise_equal_to_run_pipelined": same,
              "update_max_abs": ref_update, "update_max_rel_err": update_err,
              "tolerance_grad": TOL_GRAD,
              "loss": float(learner["metrics"]["loss"]), "seconds": seconds,
              "launches": [{r["role"]: r["launches"]} for r in out], "gpu": gpu})
        if backend == "nccl":
            check_one_card_a_rank(f"the pipeline 1 + {n_learn}", [r["device"] for r in out])
        if n_learn == 1 and not all(same.values()):
            raise AssertionError(f"the sharded pipeline differs from run_pipelined: {same}")
        check(f"the pipeline 1 + {n_learn}: updates against run_pipelined", update_err,
              TOL_GRAD)
    return total


def md_dryrun(gpu: str, backend: str = "gloo") -> dict:
    """graft_entry.dryrun_multichip(4) on the card, a (2, 2) mesh (over gloo
    sharing the card, or over NCCL one card a rank), with the scaling curve
    at 1, 2 and 4 ranks at the learner's shape: strong (ROOMS in all) and
    weak (1024 rooms a rank), the rollout through K1 and the train step
    through K2 + K4. Returns the curve's launches."""
    import contextlib
    import io

    from game_engine_tpu_torch.graft_entry import dryrun_multichip

    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        out = dryrun_multichip(4, device="cuda", backend=backend, scaling=MD_CURVE)
    seconds = time.perf_counter() - t0
    curve = out.pop("scaling")
    emit({"phase": "multidevice_dryrun", **out, "seconds": seconds, "gpu": gpu})
    if out["mesh"] != {"data": 2, "model": 2} or not out["episodes"] > 0:
        raise AssertionError(f"dryrun_multichip(4): {out}")
    if backend == "nccl":
        check_one_card_a_rank("dryrun_multichip(4)", out["devices"])
    if "error" in curve:
        raise AssertionError(f"the scaling curve failed: {curve['error']}")
    emit({"phase": "multidevice_scaling", **curve, "gpu": gpu})
    train = curve["launches"]["train"]
    if not (curve["launches"]["rollout"] > 0 and train["policy_forward"] > 0
            and train["ppo_loss_grad"] > 0):
        raise AssertionError(f"the curve did not run K1, K2 and K4: {curve['launches']}")
    total = dict.fromkeys(MD_KERNELS, 0)
    add_launches(total, {**train, "rollout": curve["launches"]["rollout"]})
    add_launches(total, out["launches"])
    return total


def multidevice_phase(lowered, gpu: str) -> dict:
    """The multi-device slice on one card: the NCCL world of one, and over
    gloo with the ranks sharing the card dp = 2 and 4, the sharded
    pipeline, dryrun_multichip(4) and the scaling curve. Returns the
    kernels' launches on this path, the ranks' included."""
    import torch

    from game_engine_tpu_torch.parallel.launch import stop_fork_server

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params0, cfg = learner_start(CKPT)
    total = dict.fromkeys(MD_KERNELS, 0)
    add_launches(total, md_nccl_world_of_one(lowered, params0, cfg, gpu))
    torch.cuda.empty_cache()
    add_launches(total, md_data_parallel(cfg, gpu))
    add_launches(total, md_pipeline(lowered, params0, cfg, gpu))
    torch.cuda.empty_cache()
    add_launches(total, md_dryrun(gpu))
    stop_fork_server()  # the ranks' fork server: no later phase starts ranks
    emit({"phase": "multidevice_done", "seconds": time.perf_counter() - t0,
          "launches": total, "gpu": gpu})
    return total


# -- --multichip: the multi-device slice on four cards, one a rank ---------------

MC_CARDS = 4


def nvidia_smi(*args) -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


LINK_BYTES = 1 << 29     # a copy between two cards that times their link


def card_links(n: int) -> dict:
    """How the cards are joined, by every means the machine allows:
    nvidia-smi topo -m's matrix, each card's NVLinks and their rate
    (nvidia-smi nvlink --status), and, measured, whether cuda:0 can reach
    each other card's memory directly (peer access) and the best of 3
    copies of LINK_BYTES from cuda:0 to it, in GB/s. "link" is NVLink or
    PCIe, from the first of the nvidia-smi queries that answered, else
    unknown."""
    import re
    import subprocess

    import torch

    def smi(*args):
        p = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60)
        return p.returncode, (p.stdout + p.stderr).strip()

    out = {}
    rc, text = smi("topo", "-m")
    rows = [line.split() for line in text.splitlines() if re.match(r"^\s*GPU\d+\s", line)]
    out["topo"] = text.splitlines() if rc == 0 else f"exit {rc}: {text}"
    topo = sorted({x for row in rows for x in row[1:1 + len(rows)] if x != "X"}) if rc == 0 else []
    out["nvlinks"] = []
    for i in range(n):
        rc, text = smi("nvlink", "--status", "-i", str(i))
        rates = [float(x) for x in re.findall(r"Link \d+: ([\d.]+) GB/s", text)] if rc == 0 else []
        out["nvlinks"].append({"card": i, "links": len(rates), "gbps_each": sorted(set(rates))})
    src = torch.empty(LINK_BYTES, dtype=torch.uint8, device="cuda:0")
    out["peer_access"], out["copy_gbps"] = [], []
    for j in range(1, n):
        dst = torch.empty(LINK_BYTES, dtype=torch.uint8, device=f"cuda:{j}")
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize(0)
            torch.cuda.synchronize(j)
            t0 = time.perf_counter()
            dst.copy_(src)
            torch.cuda.synchronize(j)
            torch.cuda.synchronize(0)
            best = min(best, time.perf_counter() - t0)
        out["peer_access"].append(torch.cuda.can_device_access_peer(0, j))
        out["copy_gbps"].append(LINK_BYTES / best / 1e9)
        del dst
    del src
    torch.cuda.empty_cache()
    if topo:
        nv, out["link_from"] = any(x.startswith("NV") for x in topo), "nvidia-smi topo -m"
    elif any(c["links"] for c in out["nvlinks"]):
        nv = all(c["links"] for c in out["nvlinks"])
        out["link_from"] = "nvidia-smi nvlink --status"
    else:
        out["link"], out["link_from"] = "unknown", None
        return out
    out["link"] = "NVLink" if nv else "PCIe"
    return out


def multichip_env(gpu: str) -> dict:
    """The run's cards (nvidia-smi's name and power limit of each), NCCL's
    version, the links between the cards (card_links), the host's CPUs and
    the shared memory NCCL's processes may map; then a world of MC_CARDS
    ranks over NCCL that binds rank r to cuda:r, sums the ranks on the
    cards and reports each rank's card and CPU affinity."""
    import shutil

    import torch

    from game_engine_tpu_torch.parallel import parity
    from game_engine_tpu_torch.parallel.launch import run_ranks

    env = {"phase": "multichip_env",
           "cards": nvidia_smi("--query-gpu=name,power.limit", "--format=csv,noheader")
           .splitlines(), "nccl": list(torch.cuda.nccl.version()),
           **card_links(MC_CARDS), "cpu_count": os.cpu_count(),
           "dev_shm_bytes": shutil.disk_usage("/dev/shm").total, "gpu": gpu}
    emit(env)
    t0 = time.perf_counter()
    ranks = run_ranks(parity.rank_env, MC_CARDS, {"device": "cuda", "backend": "nccl"},
                      backend="nccl", device="cuda", timeout=300)
    env["ranks"] = [{k: r[k] for k in ("device", "current_device", "cpus")} for r in ranks]
    emit({"phase": "multichip_ranks", "ranks": env["ranks"],
          "world_sums": [r["world_sum"] for r in ranks], "seconds": time.perf_counter() - t0,
          "gpu": gpu})
    check_one_card_a_rank("the NCCL world", [r["device"] for r in ranks])
    if [r["current_device"] for r in ranks] != list(range(MC_CARDS)):
        raise AssertionError(f"a rank's current card is not its own: {env['ranks']}")
    if any(r["world_sum"] != sum(range(MC_CARDS)) for r in ranks):
        raise AssertionError(f"the NCCL all_reduce of the ranks gave {ranks}")
    return env


def multichip_main(gpu: str) -> int:
    """The multi-device slice over NCCL, one card a rank, at the learner's
    full shape: dp = 2 and 4 against dp = 1 in one world of 4, the replicas
    after MD_REPLICA_UPDATES updates at dp = 4, the sharded pipeline 1 + 1
    and 1 + 2, dryrun_multichip(4) and the scaling curve at 1, 2 and 4
    ranks. Raises with fewer than MC_CARDS cards."""
    import torch

    from game_engine_tpu_torch import _build
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.parallel.launch import stop_fork_server

    cards = torch.cuda.device_count()
    if cards < MC_CARDS:
        raise RuntimeError(f"--multichip runs one rank a card on {MC_CARDS} cards; "
                           f"{cards} card(s) visible")
    t0 = time.perf_counter()
    _build.build_cuda()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    multichip_env(gpu)
    t0 = time.perf_counter()
    ww = lower(compile_game(load_builtin("werewolf")))
    params0, cfg = learner_start(CKPT)
    total = dict.fromkeys(MD_KERNELS, 0)
    add_launches(total, md_data_parallel(cfg, gpu, "nccl"))
    add_launches(total, md_replicas(params0, cfg, gpu))
    add_launches(total, md_pipeline(ww, params0, cfg, gpu, "nccl", learners=(1, 2)))
    add_launches(total, md_dryrun(gpu, "nccl"))
    stop_fork_server()
    emit({"phase": "multichip_done", "seconds": time.perf_counter() - t0,
          "launches_by_path": {k: {"multichip": n} for k, n in total.items()}, "gpu": gpu})
    for k in ("rollout", "policy_forward", "ppo_loss_grad", "engine_step", "observe", "rewards",
              "sample"):
        if total[k] <= 0:
            raise AssertionError(f"the four-card path did not launch {k}: {total}")
    print(nvidia_smi("--query-gpu=name,power.limit", "--format=csv,noheader"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# -- the chat LM's decode kernel (LM) -------------------------------------------

CHAT_SOURCE = "game_engine_tpu_torch/csrc/chat_decode.cu"
CHAT_KERNELS = ("cd_prefill_rows_kernel", "cd_prefill_attn_kernel", "cd_decode_kernel")
# LM is the counterpart of an XLA scan, not of a pallas_call site
CHAT_REPLACES = "game_engine_tpu/policies/chat_lm.py:439"
CHAT_CKPT = "docs/checkpoints/chat_lm.npz"
CHAT_SEED0 = 320             # unseen rooms, as the trainer's held-out evaluation
CHAT_GREEDY, CHAT_SAMPLED = 64, 32
CHAT_TEMP, CHAT_TOP_P, CHAT_SALTS = 0.8, 0.9, (0, 1, 2)
CHAT_MAX_NEW = 320           # greedy_reply's budget
# the head's logits, of max|ref|: a float32 sum taken in another order
# already moves them by ~4e-3 at the shipped width (compare_chat measures it,
# as plain_f64_max_abs_err; tests/test_torch_chat_lm.py pins it)
CHAT_TOL, CHAT_GAP = 1e-2, 1e-3
CHAT_DRAW_MARGIN = 1e-2      # a sampled draw this close to a boundary of the CDF may flip
# the JAX package's record of eval_chat_probes (docs/chat_probe_eval_r5.json):
# ok_rate, raw_lm_ok_rate, fell_back, lm_served
CHAT_PROBES_JAX = {"composer": (1.0, None, 0, 0), "student_fb": (1.0, 0.375, 16, 24),
                   "sampled_fb": (1.0, 0.375, 16, 24)}
CHAT_TRAIN_ARGV = ["--device", "cuda", "--d-model", "192", "--layers", "4", "--max-len", "832",
                   "--batch", "256", "--steps", "20", "--seeds", "8"]


def chat_contexts(cfg, n: int, seed0: int = CHAT_SEED0):
    """n contexts of the corpus from unseen rooms: (contexts, prompt buffers
    (n, max_len) int32 numpy, prompt lengths)."""
    import numpy as np

    from game_engine_tpu_torch.policies import chat_lm as LM

    ctxs = [c for c, _ in LM.build_corpus(seeds=range(seed0, seed0 + 40), max_pairs=n)]
    if len(ctxs) != n:
        raise AssertionError(f"the corpus gave {len(ctxs)} contexts, not {n}")
    bufs, n0 = zip(*(LM._prompt_buf(cfg, c) for c in ctxs))
    return ctxs, np.stack(bufs), list(n0)


def _nucleus_margin(lg, uv: float, inv_temp: float, top_p: float) -> float:
    """How far a sampled draw from the plain decode's logits `lg` (V,) lay
    from flipping: the least distance, in probability, between the draw's
    threshold u·ck[-1] and a cumulative boundary ck, or between top_p and a
    token's preceding mass (chat_decode._nucleus)."""
    import torch

    s = lg.double() * inv_temp
    order = torch.argsort(-s, stable=True)
    ps = torch.softmax(s, -1)[order]
    cps = torch.cumsum(ps, -1)
    kept = torch.where((cps - ps) < top_p, ps, torch.zeros_like(ps))
    ck = torch.cumsum(kept, -1)
    return float(min((ck - uv * ck[-1]).abs().min(), ((cps - ps) - top_p).abs().min()))


def compare_replies(got, ref, lg, lr, n0, us=None, inv_temp=1.0, top_p=1.0) -> dict:
    """Kernel tokens and logits `got`, `lg` against the plain decode's `ref`,
    `lr`, context by context. A context's tokens may differ only where the
    plain decode's choice was a near tie: its top two logits within
    CHAT_GAP (greedy), or the draw within CHAT_DRAW_MARGIN of a boundary
    (sampled). The logits are compared at the generated positions up to
    the first difference (after it the inputs differ)."""
    import torch

    differ, ties, worst, ref_max = 0, [], 0.0, 0.0
    for i in range(got.shape[0]):
        a, b = got[i, n0[i]:], ref[i, n0[i]:]
        diff = (a != b).nonzero()
        stop = int(diff[0]) if len(diff) else len(a)
        rows = slice(n0[i] - 1, n0[i] - 1 + min(stop + 1, len(a)))
        m = ~torch.isnan(lr[i, rows, 0])
        if bool(m.any()):
            x, y = lg[i, rows][m], lr[i, rows][m]
            if bool(torch.isnan(x).any()):
                raise AssertionError(f"context {i}: the kernel wrote no logits where plain did")
            worst = max(worst, float((x - y).abs().max()))
            ref_max = max(ref_max, float(y.abs().max()))
        if not len(diff):
            continue
        differ += 1
        pos = n0[i] - 1 + stop
        if bool(torch.isnan(lr[i, pos]).any()):
            raise AssertionError(f"chat decode: context {i} generates reply token {stop} "
                                 "where the plain decode had stopped")
        top = torch.topk(lr[i, pos], 2).values
        gap = float(top[0] - top[1])
        entry = {"context": i, "reply_token": stop, "top_two_gap": gap}
        if us is not None:
            entry["draw_margin"] = _nucleus_margin(lr[i, pos], float(us[i][pos]), inv_temp, top_p)
        explained = gap <= CHAT_GAP or entry.get("draw_margin", 1.0) <= CHAT_DRAW_MARGIN
        if not explained:
            raise AssertionError(f"chat decode: context {i} differs from plain at reply token "
                                 f"{stop} away from a tie: {entry}")
        ties.append(entry)
    return {"replies": int(got.shape[0]), "replies_differing": differ, "tie_divergences": ties,
            "max_abs_err": worst, "max_abs_ref": ref_max}


def compare_chat(gpu: str) -> dict:
    """The decode kernel against decode_plain on the card, at the shipped
    checkpoint's full width: CHAT_GREEDY corpus contexts greedy and
    CHAT_SAMPLED sampled with each salt of CHAT_SALTS, one launch a batch."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.policies import chat_decode as CD
    from game_engine_tpu_torch.policies import chat_lm as LM

    params, cfg = LM.load(os.path.join(HERE, CHAT_CKPT), "cuda")
    pk = CD.packed(params, cfg)
    ctxs, bufs, n0 = chat_contexts(cfg, CHAT_GREEDY)
    t0 = time.perf_counter()
    launches = CD.kernel_decode.launches
    (got, lg), ms = timed_ms(lambda: CD.kernel_decode(pk, bufs, n0, CHAT_MAX_NEW, logits=True))
    want = CD.launches_per_call(n0, cfg.max_len, cfg.n_layers)
    if CD.kernel_decode.launches != launches + want:
        raise AssertionError(f"kernel_decode made {CD.kernel_decode.launches - launches} "
                             f"launches, not {want}")
    ref, lr = CD.decode_plain(params, cfg, bufs, n0, CHAT_MAX_NEW, logits=True)
    _, l64 = CD.decode_plain(params, cfg, bufs, n0, CHAT_MAX_NEW, logits=True, f64_sums=True)
    greedy = compare_replies(got, ref, lg, lr, n0)
    m = ~torch.isnan(lr) & ~torch.isnan(l64)
    greedy["plain_f64_max_abs_err"] = float((l64[m] - lr[m]).abs().max())
    check("chat decode logits (greedy)", greedy["max_abs_err"], CHAT_TOL * greedy["max_abs_ref"])
    gen = [int(((got[i, k:] >= LM._NSPECIAL).cumprod(0)).sum()) for i, k in enumerate(n0)]
    sctx, sbufs, sn0 = ctxs[:CHAT_SAMPLED], bufs[:CHAT_SAMPLED], n0[:CHAT_SAMPLED]
    us = [LM._ctx_uniforms(c, cfg.max_len, salt) for salt in CHAT_SALTS for c in sctx]
    inv_temp = float(np.float32(1.0 / CHAT_TEMP))
    top_p = float(np.float32(CHAT_TOP_P))
    sb, sn = np.concatenate([sbufs] * len(CHAT_SALTS)), sn0 * len(CHAT_SALTS)
    kw = dict(u=np.stack(us), inv_temp=inv_temp, top_p=top_p, logits=True)
    launches = CD.kernel_decode.launches
    sgot, slg = CD.kernel_decode(pk, sb, sn, CHAT_MAX_NEW, **kw)
    if CD.kernel_decode.launches != launches + want:
        raise AssertionError("kernel_decode's sampled call made "
                             f"{CD.kernel_decode.launches - launches} launches, not {want}")
    sref, slr = CD.decode_plain(params, cfg, sb, sn, CHAT_MAX_NEW, **kw)
    sampled = compare_replies(sgot, sref, slg, slr, sn, us, inv_temp, top_p)
    check("chat decode logits (sampled)", sampled["max_abs_err"],
          CHAT_TOL * sampled["max_abs_ref"])
    line = {"phase": "compare_chat", "checkpoint": CHAT_CKPT,
            "d_model": cfg.d_model, "layers": cfg.n_layers, "heads": cfg.n_heads,
            "max_len": cfg.max_len, "seeds_from": CHAT_SEED0, "greedy": greedy,
            "sampled": {**sampled, "temperature": CHAT_TEMP, "top_p": CHAT_TOP_P,
                        "salts": list(CHAT_SALTS)},
            "ties": len(greedy["tie_divergences"]) + len(sampled["tie_divergences"]),
            "launches_per_call": want, "batch_kernel_ms": ms,
            "prompt_tokens_mean": float(np.mean(n0)),
            "reply_tokens_mean": float(np.mean(gen)), "tolerance_of_max_ref": CHAT_TOL,
            "tie_gap": CHAT_GAP, "seconds": time.perf_counter() - t0, "gpu": gpu}
    emit(line)
    return {"max_abs_err": max(greedy["max_abs_err"], sampled["max_abs_err"]),
            "ctx": ctxs[0], "bufs": bufs[:1], "n0": n0[:1], "params": params, "cfg": cfg,
            "batch": (bufs, n0)}


def chat_bound(cfg, n0: int, n_gen: int) -> tuple:
    """(least ms, "operations" or "bytes") of one reply: the bf16 products
    (4 layers' weights a position, the head at each generated position) at
    the tensor cores' bf16 rate plus the float32 attention at 67 TFLOP/s,
    against the weights read once and the caches and tokens written once at
    the memory rate."""
    Dm, H, nh, nl, V = cfg.d_model, 4 * cfg.d_model, cfg.n_heads, cfg.n_layers, 99
    npos = n0 - 1 + n_gen  # positions run: the prompt's, then one a generated token
    macs_w = npos * nl * (3 * Dm * Dm + Dm * Dm + 2 * Dm * H) + n_gen * Dm * V
    macs_att = sum(nl * 2 * Dm * (p + 1) for p in range(npos))
    t_ops = 2 * macs_w / PEAK_BF16 * 1e3 + 2 * macs_att / PEAK_F32 * 1e3
    weights = 2 * (2 * V * Dm + nl * (4 * Dm * Dm + 2 * Dm * H)) \
        + 4 * (cfg.max_len * Dm + cfg.max_len * Dm // nh + 2 * Dm + nl * (5 * Dm + H))
    moved = weights + 4 * npos * nl * 2 * Dm + 4 * (cfg.max_len + 1) * 2
    t_bytes = moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chat_timing(gpu: str, cmp: dict, profiled: bool = False) -> dict:
    """One reply of the first compared context: the prefill's and the
    decode's ms and their sum (CUDA events around each part, median of 5
    after a warm-up), us a generated position, launches a reply; the
    64-context batch's ms (median of 3); the plain decode's ms and kernel
    launches a reply (torch.profiler); reply tokens a second; the bound.
    With `profiled`, also the decode's clock cycles a generated position by
    stage (the -DCD_PROFILE build, rank 0 of the cluster)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from game_engine_tpu_torch.policies import chat_decode as CD

    params, cfg, bufs, n0 = cmp["params"], cmp["cfg"], cmp["bufs"], cmp["n0"]
    pk = CD.packed(params, cfg)
    out, _ = CD.kernel_decode(pk, bufs, n0, CHAT_MAX_NEW)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    pre, dec = [], []
    launches = CD.kernel_decode.launches
    for _ in range(5):
        out, _ = CD.kernel_decode(pk, bufs, n0, CHAT_MAX_NEW, events=ev)
        torch.cuda.synchronize()
        pre.append(ev[0].elapsed_time(ev[1]))
        dec.append(ev[1].elapsed_time(ev[2]))
    per_reply = (CD.kernel_decode.launches - launches) / 5
    # generated tokens: the reply's, and the stop token unless max_new ended it
    gen = min(int(((out[0, n0[0]:] >= 4).cumprod(0)).sum()) + 1, CHAT_MAX_NEW,
              cfg.max_len - n0[0])
    batch = []
    for _ in range(3):
        _, bms = timed_ms(lambda: CD.kernel_decode(pk, *cmp["batch"], CHAT_MAX_NEW))
        batch.append(bms)
    (pref, _), plain_ms = timed_ms(lambda: CD.decode_plain(params, cfg, bufs, n0, CHAT_MAX_NEW))
    if not torch.equal(pref, out):
        raise AssertionError("chat_timing: the kernels' reply differs from plain")
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        CD.decode_plain(params, cfg, bufs, n0, CHAT_MAX_NEW)
        torch.cuda.synchronize()
    plain_kernels = sum(ev.count for ev in prof.key_averages()
                        if (getattr(ev, "device_time_total", None)
                            or getattr(ev, "cuda_time_total", 0)) > 0)
    total = [a + b for a, b in zip(pre, dec)]
    ms = statistics.median(total)
    want = CD.launches_per_call(n0, cfg.max_len, cfg.n_layers)
    b = chat_bound(cfg, n0[0], gen)
    sz = CD.sizes(cfg, "cuda")
    line = {"phase": "chat_timing", "prompt_tokens": n0[0], "reply_tokens": gen,
            "prefill_ms": pre, "decode_ms": dec, "kernel_ms_per_reply": total,
            "prefill_ms_median": statistics.median(pre),
            "decode_ms_median": statistics.median(dec), "kernel_ms_median": ms,
            "us_per_generated_position": statistics.median(dec) * 1e3 / gen,
            "kernel_launches_per_reply": per_reply, "launches_expected": want,
            "batch_contexts": len(cmp["batch"][1]), "batch_ms": batch,
            "batch_ms_median": statistics.median(batch),
            "plain_ms_per_reply": plain_ms, "plain_kernel_launches_per_reply": plain_kernels,
            "reply_tokens_per_s": gen / (ms / 1e3), "bound_ms": b[0], "bound_by": b[1],
            "cluster": CD.cluster_plan(cfg),
            "shared_bytes_per_block": {k: sz[k] for k in sz if k.endswith("shared_bytes")},
            "gpu": gpu}
    if profiled:
        CD.profile_decode(pk, bufs, n0, CHAT_MAX_NEW)  # warm-up
        cycles = CD.profile_decode(pk, bufs, n0, CHAT_MAX_NEW)
        line["decode_cycles_per_position_by_stage"] = {k: v / gen for k, v in cycles.items()}
    emit(line)
    if per_reply != want:
        raise AssertionError(f"a reply took {per_reply} launches, not {want}")
    return {"ms": ms, "plain_ms": plain_ms, "bound": b, "prefill_ms": line["prefill_ms_median"],
            "decode_ms": line["decode_ms_median"], "launches_per_reply": want,
            "us_per_position": line["us_per_generated_position"],
            "batch_ms": line["batch_ms_median"]}


class PlainOnCard:
    """Counts decode_plain calls on CUDA parameters while entered: the
    server and the hook must never take the plain decode on the card."""

    def __enter__(self):
        from game_engine_tpu_torch.policies import chat_decode as CD

        self.calls, self.fn = 0, CD.decode_plain

        def counted(params, *args, **kwargs):
            self.calls += params["tok"].is_cuda
            return self.fn(params, *args, **kwargs)

        CD.decode_plain = counted
        return self

    def __exit__(self, *exc):
        from game_engine_tpu_torch.policies import chat_decode as CD

        CD.decode_plain = self.fn
        if exc[0] is None and self.calls:
            raise AssertionError(f"the plain decode ran {self.calls} times on the card")


def chat_probes_phase(gpu: str) -> int:
    """utils/eval_chat_probes on the card: every tier must reach ok_rate 1.0;
    its numbers beside the JAX record. Returns the decode launches."""
    import contextlib
    import io

    from game_engine_tpu_torch.policies import chat_decode as CD
    from game_engine_tpu_torch.utils import eval_chat_probes as ECP

    launches = CD.kernel_decode.launches
    t0 = time.perf_counter()
    with PlainOnCard(), contextlib.redirect_stdout(io.StringIO()):
        out = ECP.main(["--device", "cuda"])
    n = CD.kernel_decode.launches - launches
    keys = ("ok_rate", "raw_lm_ok_rate", "fell_back", "lm_served")
    tiers = {t: {k: r[k] for k in keys} for t, r in out["tiers"].items()}
    emit({"phase": "chat_probes", "tiers": tiers,
          "jax_record": {t: dict(zip(keys, v)) for t, v in CHAT_PROBES_JAX.items()},
          "failures": {t: r["failures"] for t, r in out["tiers"].items() if r["failures"]},
          "decode_launches": n, "seconds": time.perf_counter() - t0, "gpu": gpu})
    for t in CHAT_PROBES_JAX:
        if tiers.get(t, {}).get("ok_rate") != 1.0:
            raise AssertionError(f"chat_probes: tier {t} {tiers.get(t)}")
    if n <= 0:
        raise AssertionError("chat_probes launched no decode")
    return n


def serve_chat_phase(gpu: str) -> tuple:
    """The server with --chat-lm and the attn policy bots: load_test's shape
    for SERVE_SECONDS; decode launches > 0, 0 errors. Returns the
    decode launches, K2's and the decode's by program."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_chat_")
    try:
        with PlainOnCard():
            srv, line = serve_run("serve_chat", 5, [os.path.join(HERE, CKPT)],
                                  os.path.join(tmp, "rooms.json"), gpu,
                                  chat_lm=os.path.join(HERE, CHAT_CKPT))
        del srv
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if line["decode_launches"] <= 0 or not line["requests_by_endpoint"]["chat"]:
        raise AssertionError("serve_chat: no chat answered or no chat decode launched")
    return line["decode_launches"], line["k2_launches"], line["decode_launches_by_program"]


def train_chat_phase(gpu: str) -> int:
    """train/chat_lm.py --device cuda at the shipped checkpoint's width for
    20 steps on the corpus of 8 rooms a game; steps/s, a finite loss that
    falls; the held-out evaluation's decodes through the kernel. Returns the
    decode launches."""
    import contextlib
    import io
    import math
    import shutil
    import tempfile

    import torch

    from game_engine_tpu_torch.policies import chat_decode as CD
    from game_engine_tpu_torch.train import chat_lm as TR

    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    launches = CD.kernel_decode.launches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with PlainOnCard(), contextlib.redirect_stdout(io.StringIO()):
            res = TR.main(CHAT_TRAIN_ARGV + ["--out", os.path.join(tmp, "lm.npz")])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = CD.kernel_decode.launches - launches
    losses, step_s = res["losses"], res["step_s"]
    steady = step_s[1:]
    line = {"phase": "train_chat_lm", "argv": CHAT_TRAIN_ARGV, "corpus_pairs": res["corpus_pairs"],
            "corpus_s": res["corpus_s"], "losses": losses,
            "first_step_s": step_s[0], "steps_per_s": len(steady) / sum(steady),
            "step_ms_median": statistics.median(steady) * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "eval": {k: v for k, v in res["metrics"].items() if k != "by_kind_exact_match"},
            "decode_launches": n, "seconds": time.perf_counter() - t0, "gpu": gpu}
    emit(line)
    if not all(math.isfinite(x) for x in losses) or \
            not statistics.mean(losses[-5:]) < statistics.mean(losses[:5]):
        raise AssertionError(f"train_chat_lm: the loss did not fall: {losses}")
    if n <= 0:
        raise AssertionError("train_chat_lm: the evaluation launched no decode")
    return n


# -- the engine step entry (ST) --------------------------------------------------

ST_KERNELS = {"step_kernel": "ge_step_kernelILi1E", "step_kernel_wide": "ge_step_kernelILi8E"}
ST_REPLACES = "game_engine_tpu/core/step.py:826"
ST_CHECK = (1024, 16)      # rooms and steps of each case of engine_step's check
# werewolf rooms and steps checked at the paths' larger batches, 4096 (the
# learner), 16,384 (the policy loop) and 65,536, and at 8192, so that every
# lanes a room the plan gives 8 seats (32, 16, 8 as the rooms grow; ST_CHECK's
# 1024 rooms get 32) is held whatever the card's occupancy sets the steps at
ST_CHECK_SIZES = ((4096, 6), (8192, 4), (16384, 3), (65536, 3))
ST_SIZES = (4096, 65536)   # werewolf rooms of 8 where it is timed
ST_REPS = 5                # timed calls a size (CUDA events, the median)
# the paths that step rooms one at a time, each of which must launch ST
ST_PATHS = ("learner", "train_narrow", "train_curve", "large_rooms", "serving", "serve_search",
            "eval_search", "league", "pipeline", "matchup", "multidevice", "policy_bench",
            "serve_chat")
UNROLL_GROUPS = ("observe", "sample_actions", "actor_mask", "engine_step", "terminal_rewards",
                 "reset")
# the paths that unroll a learned policy: each step one ST step_reset launch
UNROLL_PATHS = ("learner", "train_narrow", "train_curve", "league", "matchup", "policy_bench",
                "pipeline", "multidevice")


def st_wrappers() -> dict:
    from game_engine_tpu_torch.core import step_kernel as SK

    return {"step": SK.kernel_step, "reset_done": SK.kernel_reset_done,
            "bot_actions": SK.kernel_bot_actions, "step_reset": SK.kernel_step_reset}


class STPaths:
    """ST's, OB's and SA's launches by path: `with paths.of(name):` zeroes
    path_wrappers' counts just before a path and adds them to `name` after.
    A context of its own, because the phases zero K1-K4's counts inside
    themselves (zero_launches) and return them, and ST, OB and SA run in
    phases that launch none of those; zero_launches leaves their counts
    alone so that a phase's own zeroing cannot drop their launches from its
    path."""

    def __init__(self):
        self.by_path = {}

    def of(self, name: str):
        import contextlib

        @contextlib.contextmanager
        def counting():
            wrappers = path_wrappers()
            for fn in wrappers.values():
                fn.launches = 0
            try:
                yield
            finally:
                got = self.by_path.setdefault(name, dict.fromkeys(wrappers, 0))
                for k, fn in wrappers.items():
                    got[k] += fn.launches

        return counting()

    def entries(self, wrappers: dict) -> dict:
        """{path: {entry: launches}} of `wrappers`' entries."""
        return {path: {k: got[k] for k in wrappers} for path, got in self.by_path.items()}


def st_differences(got, ref) -> tuple:
    """(elements that differ, largest |got - ref|) over pairs of tensors,
    as int64 tensors on the card (read by the caller), and whether every
    pair agrees in dtype and shape."""
    import torch

    diff = torch.zeros((), dtype=torch.int64, device="cuda")
    err = torch.zeros((), dtype=torch.int64, device="cuda")
    same_kind = True
    for x, y in zip(got, ref):
        same_kind &= x.dtype == y.dtype and x.shape == y.shape
        if x.numel():
            diff = diff + (x != y).sum()
            err = torch.maximum(err, (x.to(torch.int64) - y.to(torch.int64)).abs().max())
    return diff, err, same_kind


def st_check_case(name: str, lw, rooms: int, steps: int, seed: int, state=None) -> dict:
    """ST against the plain functions on the card, `steps` steps of `rooms`
    rooms (of mixed sizes from init_state, or from `state`): the bots
    against scripted_actions; the step on step_cases.odd_actions with a
    keep mask against make_step then torch.where(keep), every field and
    `ended`; the fused step_reset on the same actions (into the last
    step's spare state) against make_step, terminal_rewards_plain and
    reset_where_done: every field, ended, the winner and the rewards' bits;
    the reset against reset_where_done. The differences are counted on the
    card and read once; the launch's lanes a room are recorded."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core import step_kernel as SK
    from game_engine_tpu_torch.core.engine import (
        reset_where_done,
        scripted_actions,
        terminal_rewards_plain,
    )
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.core.step import make_step
    from game_engine_tpu_torch.utils.step_cases import odd_actions

    rng = np.random.default_rng(seed)
    if state is None:
        lo = min(lw.game.spec.declaration.min_players or 4, lw.P)
        n = torch.as_tensor(rng.integers(lo, lw.P + 1, rooms), dtype=torch.int32)
        state = init_state(lw, rooms, n, np.arange(rooms, dtype=np.uint32) * 7 + seed,
                           device="cuda")
    step = make_step(lw)
    diff = err = torch.zeros((), dtype=torch.int64, device="cuda")
    dtypes_ok, ended_n, done_n = True, 0, 0

    def count(got, ref):
        nonlocal diff, err, dtypes_ok
        d, e, same_kind = st_differences(got, ref)
        diff, err, dtypes_ok = diff + d, torch.maximum(err, e), dtypes_ok and same_kind

    spare = None
    for t in range(steps):
        bots = SK.kernel_bot_actions(lw, state)
        count([bots], [scripted_actions(lw, state)])
        actions = odd_actions(lw, bots, rng)
        keep = torch.as_tensor(rng.random(rooms) < 0.85, device="cuda")
        got, ended = SK.kernel_step(lw, state, actions, keep)
        ref = step(state, actions)
        whole = ref
        ref = [torch.where(keep.reshape((-1,) + (1,) * (o.dim() - 1)), x, o)
               for x, o in zip(ref, state)]
        count(list(got) + [ended], ref + [ref[11] & ~state.done])
        # the fused entry on the same actions, every room stepped, into a spare state
        fused = SK.kernel_step_reset(lw, state, actions, rewards=True, out=spare)
        whole_ended = whole.done & ~state.done
        count(list(fused[0]) + [fused[1], fused[2], fused[3].view(torch.int32)],
              list(reset_where_done(lw, whole)) + [
                  whole_ended, whole.winner,
                  terminal_rewards_plain(lw, whole, whole_ended).view(torch.int32)])
        spare = fused[0]
        ended_n = ended_n + ended.sum()
        done_n = done_n + got.done.sum()
        fresh = SK.kernel_reset_done(lw, got)
        count(fresh, reset_where_done(lw, got))
        state = fresh
    return {"case": name, "game": lw.game.spec.name, "P": lw.P, "NP": lw.NP, "rooms": rooms,
            "steps": steps, "lanes_per_room": SK.step_plan(lw, rooms, state.present.device)[0],
            "differences": int(diff), "max_abs_err": int(err), "dtypes_ok": dtypes_ok,
            "episodes_ended": int(ended_n), "done_rooms_stepped": int(done_n)}


def st_state(lw, rooms: int, steps: int = 200, seats: int = 8):
    """Werewolf rooms of `seats` players after `steps` steps of the scripted
    rollout with auto-reset (K1): rooms spread over the game's phases, as a
    long run leaves them (fresh rooms all wait in one phase)."""
    import numpy as np

    from game_engine_tpu_torch.core.engine import BatchedEngine

    eng = BatchedEngine(lw, "cuda")
    return eng.rollout(eng.init(rooms, seats, np.arange(rooms, dtype=np.uint32)), steps)[0]


def st_timing(lw, rooms: int, int32_rate: float) -> dict:
    """ST's entries and their plain versions at `rooms` werewolf rooms of 8
    spread over the game's phases: the step, the reset, the bots, the
    fused step_reset (with rewards) and, beside it, the step, OB's rewards
    and the reset as three launches. "ms" is an entry's device time
    (prefilled_ms: its launch queued behind a sleep kernel, CUDA events,
    median of ST_REPS) and "plain_ms" its plain version's, its kernels back
    to back, alike; "call_ms" and "plain_call_ms" a call's span on the
    card's clock from an idle queue, its host time included, as a caller
    waits for it (the eager step is host-bound). The timed calls' own
    outputs are held against the plain ones (the step's every field and
    `ended`, the reset, the bots, the fused entry's state, ended, winner and
    rewards, the three launches' too: "differences", "max_abs_err"). Also
    the host us a call (the wrappers' own cost, no sync) of the step, of
    the fused entry into a spare state (as the unrolls call it) and of the
    three launches, the launch's
    lanes a room and the step's bound: the larger of the interpreter's
    integer operations (the -DGE_COUNT host build over this step) over the
    card's int32 rate and the bytes it must move (the state in and out,
    the actions, `ended`, the game array) over the memory rate."""
    import torch

    from game_engine_tpu_torch.core import step_kernel as SK
    from game_engine_tpu_torch.core.engine import (
        reset_where_done,
        scripted_actions,
        terminal_rewards_plain,
    )
    from game_engine_tpu_torch.core.entry_args import new_state
    from game_engine_tpu_torch.core.rollout_kernel import _game_arrays
    from game_engine_tpu_torch.core.state import GameState
    from game_engine_tpu_torch.core.step import make_step
    from game_engine_tpu_torch.policies import obs_kernel as OK

    state = st_state(lw, rooms)
    actions = SK.kernel_bot_actions(lw, state)
    nxt, ended = SK.kernel_step(lw, state, actions)
    step = make_step(lw)

    def three():  # the unroll's step, rewards and reset as three launches
        n, e = SK.kernel_step(lw, state, actions)
        return SK.kernel_reset_done(lw, n), e, OK.kernel_rewards(lw, n, e)

    def plain_step_reset():
        n = step(state, actions)
        e = n.done & ~state.done
        return reset_where_done(lw, n), e, n.winner, terminal_rewards_plain(lw, n, e)

    calls = {"": lambda: SK.kernel_step(lw, state, actions),
             "reset_": lambda: SK.kernel_reset_done(lw, nxt),
             "bots_": lambda: SK.kernel_bot_actions(lw, state),
             "step_reset_": lambda: SK.kernel_step_reset(lw, state, actions, rewards=True),
             "three_": three,
             "plain_": lambda: step(state, actions),
             "plain_reset_": lambda: reset_where_done(lw, nxt),
             "plain_bots_": lambda: scripted_actions(lw, state),
             "plain_step_reset_": plain_step_reset}
    out = {"rooms": rooms, "seats": 8, "done_rooms": int(nxt.done.sum()),
           "phases_held": int(torch.unique(state.phase).numel()),
           "lanes_per_room": SK.step_plan(lw, rooms, state.present.device)[0]}
    got = {}
    for name, call in calls.items():
        call()  # warm-up
        spans = []
        for _ in range(ST_REPS):
            got[name], ms = timed_ms(call)
            spans.append(ms)
        span = statistics.median(spans)
        out[name + "call_ms"] = span
        out[name + "ms"] = statistics.median(prefilled_ms(call, span) for _ in range(ST_REPS))
    (st_next, st_ended), plain_next = got[""], got["plain_"]
    fused, plain_fused = got["step_reset_"], got["plain_step_reset_"]
    checks = [st_differences(list(st_next) + [st_ended],
                             list(plain_next) + [plain_next.done & ~state.done]),
              st_differences(got["reset_"], got["plain_reset_"]),
              st_differences([got["bots_"]], [got["plain_bots_"]]),
              st_differences(list(fused[0]) + [fused[1], fused[2], fused[3].view(torch.int32)],
                             list(plain_fused[0]) + [plain_fused[1], plain_fused[2],
                                                     plain_fused[3].view(torch.int32)]),
              st_differences(list(got["three_"][0]) + [got["three_"][1],
                                                       got["three_"][2].view(torch.int32)],
                             list(plain_fused[0]) + [plain_fused[1],
                                                     plain_fused[3].view(torch.int32)])]
    out["differences"] = int(sum(d for d, _, _ in checks))
    out["max_abs_err"] = int(max(e for _, e, _ in checks))
    out["dtypes_ok"] = all(k for _, _, k in checks)
    spare = new_state(lw, rooms, state.present.device)
    for name, call in (("", lambda: SK.kernel_step(lw, state, actions)),
                       ("step_reset_", lambda: SK.kernel_step_reset(lw, state, actions, True,
                                                                   out=spare)),
                       ("three_", three)):
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t0) * 1e6)
        out[name + "host_us_per_call"] = statistics.median(host)
    counts = SK.count_step(lw, GameState(*(t.cpu() for t in state)), actions.cpu())
    game, _ = _game_arrays(lw, state.present.device)
    moved = 2 * nbytes(*state) + nbytes(actions, ended, game)
    by_ops, by_bytes = counts["int_ops"] / int32_rate * 1e3, moved / PEAK_BYTES * 1e3
    fused_moved = moved + nbytes(*fused[2:])
    out.update(interpreter_counts=counts, bytes_moved=moved, bound_ms_by_bytes=by_bytes,
               bound_ms_by_operations=by_ops,
               bound=(by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes"),
               step_reset_bytes_moved=fused_moved,
               step_reset_bound_ms_by_bytes=fused_moved / PEAK_BYTES * 1e3)
    return out


def st_sync_check(lw) -> dict:
    """ST's four wrappers under torch's sync debug mode "error" on an
    unroll's shapes (4096 rooms, after a warm-up that caches the tables and
    the plan): any host wait for the card raises."""
    import torch

    from game_engine_tpu_torch.core import step_kernel as SK

    state = st_state(lw, ROOMS)
    SK.kernel_step_reset(lw, state, SK.kernel_bot_actions(lw, state), rewards=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        actions = SK.kernel_bot_actions(lw, state)
        nxt, ended = SK.kernel_step(lw, state, actions)
        SK.kernel_reset_done(lw, nxt)
        SK.kernel_step_reset(lw, state, actions, rewards=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return {"rooms": ROOMS, "sync_debug_mode": "error", "raised": False}


def wide_state(lw, rooms: int, steps: int = 40):
    """`rooms` full rooms of the game after `steps` steps of the scripted
    rollout with auto-reset (K1)."""
    import numpy as np

    from game_engine_tpu_torch.core.engine import BatchedEngine

    eng = BatchedEngine(lw, "cuda")
    return eng.rollout(eng.init(rooms, lw.P, np.arange(rooms, dtype=np.uint32)), steps)[0]


def st_plan_order_check() -> dict:
    """A kernel's shared-memory limit outlives the plan that raised it: ST
    planned for werewolf at 72 seats, then at 40 (a block of fewer bytes,
    still past 48 KB), then launched on the 72-seat plan, the fused entry
    held bit for bit against make_step, terminal_rewards_plain and
    reset_where_done."""
    import torch

    from game_engine_tpu_torch.core import step_kernel as SK
    from game_engine_tpu_torch.core.engine import reset_where_done, terminal_rewards_plain
    from game_engine_tpu_torch.core.step import make_step

    w72, w40 = large_game(72), large_game(40)
    state = wide_state(w72, ROOMS)
    smem = [SK.step_plan(lw, ROOMS, state.present.device)[2] for lw in (w72, w40)]
    if not 48 * 1024 < smem[1] < smem[0]:
        raise AssertionError(f"ST's plans at 72 and 40 seats ask {smem} shared bytes: the "
                             "order check needs two past 48 KB, the later one smaller")
    actions = SK.kernel_bot_actions(w72, state)
    got = SK.kernel_step_reset(w72, state, actions, rewards=True)
    whole = make_step(w72)(state, actions)
    ended = whole.done & ~state.done
    diff, err, same_kind = st_differences(
        list(got[0]) + [got[1], got[2], got[3].view(torch.int32)],
        list(reset_where_done(w72, whole)) + [
            ended, whole.winner, terminal_rewards_plain(w72, whole, ended).view(torch.int32)])
    out = {"rooms": ROOMS, "shared_bytes_72_then_40": smem, "differences": int(diff),
           "max_abs_err": int(err), "dtypes_ok": same_kind}
    if out["differences"] or out["max_abs_err"] or not same_kind:
        raise AssertionError(f"ST after a smaller plan differs from plain: {out}")
    return out


# planned in this order: at 72 seats a block of 16 rooms (146 KB) down to
# 4096 rooms, then fewer rooms a block as the batch falls below ~2000
OB_ORDER_BATCHES = (65536, 4096, 2048, 1792, 1536, 1280, 1152, 1024, 16)
OB_ORDER_HELD = 1024  # rooms of ob_plan_order_check's launch held against plain


def ob_plan_order_check() -> dict:
    """As st_plan_order_check for OB: werewolf at 72 (else 40) seats
    planned at each of OB_ORDER_BATCHES in turn (fewer rooms a block at
    fewer rooms, so fewer bytes), then launched on the smallest batch whose
    plan asked more bytes than a later plan past 48 KB, its first
    OB_ORDER_HELD rooms held bit for bit against the plain observation and
    masks (a room's rows depend on that room alone)."""
    import torch

    from game_engine_tpu_torch.core.state import GameState
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.policies import obs_kernel as OK
    from game_engine_tpu_torch.train import ppo as P

    for seats in LARGE_SEATS[::-1]:
        lw = large_game(seats)
        plans = [(n, *OK.observe_plan(lw, n, "cuda")) for n in OB_ORDER_BATCHES]
        first = [n for i, (n, _, smem) in enumerate(plans)
                 if any(48 * 1024 < later < smem for _, _, later in plans[i + 1:])]
        if first:
            break
    else:
        raise AssertionError(f"OB's plans ask no bytes past 48 KB below an earlier's: {plans}")
    state = wide_state(lw, first[-1])
    got = OK.kernel_observe(lw, state)
    head = GameState(*(t[:OB_ORDER_HELD] for t in state))
    diff, err, same_kind = ob_differences(
        [x[:OB_ORDER_HELD] for x in got],
        (N.observe_plain(lw, head, True), N.legal_action_mask_plain(lw, head),
         P.actor_mask_plain(lw, head)))
    out = {"seats": seats, "rooms": first[-1], "held_rooms": min(OB_ORDER_HELD, first[-1]),
           "rooms_a_block_and_shared_bytes_by_batch": {str(n): [r, b] for n, r, b in plans},
           "differences": int(diff), "max_abs_err": float(err), "dtypes_ok": same_kind}
    del got, state
    torch.cuda.empty_cache()
    if out["differences"] or out["max_abs_err"] or not same_kind:
        raise AssertionError(f"OB after a smaller plan differs from plain: {out}")
    return out


def state_check_us(lw, reps: int = 2000) -> dict:
    """Host us of a call of entry_args.checked_state and state_addresses on
    a ROOMS-room state, as every ST and OB call makes them: the state
    remembered from the call before (the unrolls' case), and forgotten
    before each call (the one-pass check over the fields alone)."""
    import numpy as np

    from game_engine_tpu_torch.core import entry_args as EA
    from game_engine_tpu_torch.core.state import init_state

    state = init_state(lw, ROOMS, 8, np.arange(ROOMS, dtype=np.uint32), device="cuda")

    def call():
        EA.checked_state(lw, state, "cuda", "x")
        EA.state_addresses(lw, state, "cuda")

    def forgotten():
        EA._KNOWN.clear()
        call()

    out = {}
    for name, fn in (("remembered_us", call), ("checked_us", forgotten)):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def engine_step_phase(gpu: str, int32_rate: float) -> dict:
    """ST against the plain functions on the card, bit for bit: every
    catalog game (ST_CHECK rooms x steps, rooms of mixed sizes, the bots,
    the step on legal and illegal actions with a keep mask, the reset),
    born-done rooms, werewolf at 40 and 72 seats (the wide build), the
    78-phase game, and werewolf at ST_CHECK_SIZES from rooms spread over
    its phases, so that each lanes a room the plan picks for 8 seats is
    held; then its time at ST_SIZES beside the plain versions and its
    bound, the timed calls' outputs held against the plain ones and their
    lanes a room against the checked launches', and the sync check.
    Returns the kernels line's numbers."""
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import games_dir, load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.utils.bench_games import long_game
    from game_engine_tpu_torch.utils.step_cases import born_done_game

    t0 = time.perf_counter()
    rooms, steps = ST_CHECK
    ww = lower(compile_game(load_builtin("werewolf")))
    names = sorted(fn[:-5] for fn in os.listdir(games_dir()) if fn.endswith(".yaml"))
    cases = [(name, lambda name=name: lower(compile_game(load_builtin(name))), rooms, steps,
              False) for name in names]
    cases += [("born_done", born_done_game, rooms, steps, False),
              ("werewolf_40_seats", lambda: large_game(40), rooms, steps, False),
              ("werewolf_72_seats", lambda: large_game(72), rooms, steps, False),
              ("long_game_78_phases", long_game, rooms, steps, False)]
    cases += [(f"werewolf_{n}_rooms", lambda: ww, n, k, True) for n, k in ST_CHECK_SIZES]
    results = []
    for k, (name, make, n, n_steps, spread) in enumerate(cases):
        lw = make()
        got = st_check_case(name, lw, n, n_steps, 1000 + k, st_state(lw, n) if spread else None)
        results.append(got)
        if got["differences"] or got["max_abs_err"] or not got["dtypes_ok"]:
            emit({"phase": "engine_step_case", **got, "gpu": gpu})
            raise AssertionError(f"ST differs from the plain functions on {name}: {got}")
    worst = max(results, key=lambda r: r["P"])
    ww_lanes = sorted({r["lanes_per_room"] for r in results
                       if r["game"] == ww.game.spec.name and r["P"] == ww.P})
    emit({"phase": "engine_step_check", "cases": len(results), "differences": 0,
          "werewolf_lanes_checked": ww_lanes, "per_case": results,
          "seconds": time.perf_counter() - t0, "gpu": gpu})
    if not any(r["episodes_ended"] for r in results) or worst["P"] != 72:
        raise AssertionError("the engine step check ended no episode or missed the wide rooms")
    if ww_lanes != [8, 16, 32]:
        raise AssertionError(f"engine step check ran werewolf at {ww_lanes} lanes a room, "
                             "not 8, 16 and 32")
    timing = {n: st_timing(ww, n, int32_rate) for n in ST_SIZES}
    for n, t in timing.items():
        if t["differences"] or t["max_abs_err"] or not t["dtypes_ok"]:
            raise AssertionError(f"ST's timed calls at {n} rooms differ from plain: {t}")
        if t["lanes_per_room"] not in ww_lanes:
            raise AssertionError(f"engine step timed at {t['lanes_per_room']} lanes a room "
                                 f"({n} rooms), checked at {ww_lanes}")
    sync = st_sync_check(ww)
    order = st_plan_order_check()
    emit({"phase": "engine_step", "timing": {str(k): {x: y for x, y in v.items() if x != "bound"}
                                             for k, v in timing.items()},
          "sync_check": sync, "plan_order_check": order, "state_check": state_check_us(ww),
          "seconds": time.perf_counter() - t0, "gpu": gpu})
    return {"timing": timing, "cases": len(results),
            "differences": sum(r["differences"] for r in results)
            + sum(t["differences"] for t in timing.values()),
            "max_abs_err": max([r["max_abs_err"] for r in results]
                               + [t["max_abs_err"] for t in timing.values()])}


# -- the observation and sampling entries (OB, SA) -------------------------------

OB_SOURCE = "game_engine_tpu_torch/csrc/observe.cu"
OB_REPLACES = "game_engine_tpu/policies/net.py:155"
SA_REPLACES = "game_engine_tpu/policies/net.py:440"
OB_KERNELS = {"observe": "ob_observe_kernel", "rewards": "ob_rewards_kernel",
              "sample": "ob_sample_kernel"}
OB_CHECK = (1024, 4)       # rooms and steps of each case of observe_step's check
# werewolf rooms and steps checked at the paths' larger batches, from rooms
# spread over the game's phases
OB_CHECK_SIZES = ((4096, 2), (16384, 1), (65536, 1))
OB_SIZES = (4096, 65536)   # werewolf rooms of 8 where OB and SA are timed
OB_REPS = 5
LOGP_TOL = 1e-6            # SA's logp against log_softmax's (float rounding of the sum)
OB_ENTRIES = ("observe", "rewards", "sample")  # ob_observe, ob_rewards, ob_sample
# SA's lane-group widths checked: choices a row on both sides of each group
# width (1-32 lanes of 8 choices) and of a warp's passes of 256, multiples
# of 4 (loads of 4, and unaligned) and not; rows no multiple of a warp's
# groups
SA_WIDTHS = (1, 2, 3, 4, 5, 6, 8, 9, 16, 17, 31, 32, 33, 64, 65, 72, 73, 100, 128, 129, 256,
             257, 300)
SA_SWEEP_ROWS = 1031
# werewolf (rooms, seats present) where SA is timed: 4 rooms (32 rows, one
# block) as the floor, the paths' 4096-65,536 rooms of 8, and the train
# unroll's 4096 rooms of 6
SA_SIZES = ((4, 8), (4096, 8), (16384, 8), (65536, 8), (4096, 6))
# SA's kernel by lanes a row and mode (0 uniform, 1 gumbel, 2 greedy): the
# mangled names' template arguments
SA_KERNELS = {f"G{g}_mode{m}": f"ob_sample_kernelILi{g}ELi{m}EE"
              for g in (1, 2, 4, 8, 16, 32) for m in range(3)}
# the paths that run a learned policy a turn at a time, each of which must
# launch OB and SA
OB_PATHS = ("learner", "train_narrow", "large_rooms", "serving", "league", "pipeline",
            "matchup", "multidevice", "policy_bench", "train_curve")


def ob_wrappers() -> dict:
    from game_engine_tpu_torch.policies import obs_kernel as OK

    return {"observe": OK.kernel_observe, "rewards": OK.kernel_rewards,
            "sample": OK.kernel_sample}


def path_wrappers() -> dict:
    """The wrappers STPaths counts by path: ST's, OB's and SA's."""
    return {**st_wrappers(), **ob_wrappers()}


def as_bits(t):
    """A float tensor as its bits (bf16 as int16, f32 as int32), so that
    equality is bit for bit."""
    import torch

    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(t.dtype)
    return t if bits is None else t.view(bits)


def ob_differences(got, ref) -> tuple:
    """(elements that differ bit for bit, largest |got - ref| with each
    value as float64, both on the card; every pair alike in dtype and
    shape)."""
    import torch

    diff, _, same_kind = st_differences([as_bits(x) for x in got], [as_bits(y) for y in ref])
    err = torch.zeros((), dtype=torch.float64, device="cuda")
    for x, y in zip(got, ref):
        if x.numel() and x.shape == y.shape:
            err = torch.maximum(err, (x.to(torch.float64) - y.to(torch.float64)).abs().max())
    return diff, err, same_kind


def sa_inputs(legal, seed: int):
    """f32 logits and torch.rand uniforms for SA over `legal`'s shape, from a
    seed on the card, with ties forced: every fifth room's logits all equal
    and its uniforms equal along each row."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(legal.shape, generator=gen, device="cuda")
    u = torch.rand(legal.shape, generator=gen, device="cuda")
    logits[::5] = 0.5
    u[::5] = u[::5, :, :1]
    return logits, u


def sa_plain(logits, legal, u, actor, present):
    """SA's plain version on the same inputs: net.draw_plain on gumbel_noise's
    transform of the uniforms, the actor-masked actions, and the greedy
    mode's PolicyBots.greedy body; last, that Gumbel noise, which SA's
    "gumbel" mode takes as it is."""
    import torch

    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.policies.serve import first_argmax

    noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    a, logp = N.draw_plain(logits, legal, noise)
    g = first_argmax(torch.where(legal, logits, -1e9)).to(torch.int32) + 1
    return a, torch.where(actor, a, 0), logp, torch.where(legal.any(-1) & present, g, 0), noise


def sa_sweep_inputs(A: int, seed: int) -> tuple:
    """(logits, legal, uniforms, actor) of SA_SWEEP_ROWS rows of A choices
    from a seed on the card, with the edges forced: row 0 has no legal
    choice and a zero uniform; rows 1 and 2 have every logit and uniform
    equal (all legal, then some); rows 3 to 5 hold the same largest value
    at two indices: lanes apart, in one lane's choices, and in two
    passes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (SA_SWEEP_ROWS, A)
    logits = torch.randn(shape, generator=gen, device="cuda")
    legal = torch.rand(shape, generator=gen, device="cuda") < 0.6
    u = torch.rand(shape, generator=gen, device="cuda")
    actor = torch.rand(shape[:1], generator=gen, device="cuda") < 0.5
    legal[0] = False
    u[0, A // 2] = 0.0
    legal[1] = True
    logits[1:3] = 0.25
    u[1:3] = u[1:3, :1]
    for row, (i, j) in zip((3, 4, 5), ((A // 3, A - 1), (1, 3), (5, 261))):
        if i < j < A:
            legal[row, [i, j]] = True
            logits[row, [i, j]] = 50.0
            u[row, [i, j]] = 0.75
    return logits, legal, u, actor


def unaligned(t):
    """A copy of `t` one element past an aligned start: SA reads it a choice
    at a time, not in 16-byte loads."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def sa_sweep_check() -> dict:
    """SA at every lane-group width (SA_WIDTHS choices a row) against its
    plain version on the same inputs (sa_sweep_inputs): the "uniform" and
    "gumbel" modes with the actor mask and without, against sa_plain; the
    greedy mode with and without, against the first argmax of the masked
    logits. Widths that are multiples of 4 run twice, the second time on
    unaligned copies of the inputs. Actions exact, logp within LOGP_TOL;
    counted on the card and read once."""
    import torch

    from game_engine_tpu_torch.policies import obs_kernel as OK
    from game_engine_tpu_torch.policies.serve import first_argmax

    diff = torch.zeros((), dtype=torch.int64, device="cuda")
    err = torch.zeros((), dtype=torch.float64, device="cuda")
    logp_err = torch.zeros((), dtype=torch.float32, device="cuda")
    dtypes_ok, nones, runs = True, 0, 0
    cases = [(A, False) for A in SA_WIDTHS] + [(A, True) for A in SA_WIDTHS if A % 4 == 0]
    for A, shift in cases:
        logits, legal, u, actor = sa_sweep_inputs(A, 3000 + A)
        ref_a, ref_acting, ref_logp, _, noise = sa_plain(logits, legal, u, actor, actor)
        if shift:
            logits, legal, u, noise = (unaligned(x) for x in (logits, legal, u, noise))
        runs += 1
        g = first_argmax(torch.where(legal, logits, -1e9)).to(torch.int32) + 1
        got, ref = [], []
        for mode, z in (("uniform", u), ("gumbel", noise)):
            a, acting, logp = OK.kernel_sample(logits, legal, z, actor, mode=mode)
            b, none, logp_b = OK.kernel_sample(logits, legal, z, mode=mode)
            nones += none is None
            got += [a, acting, b]
            ref += [ref_a, ref_acting, ref_a]
            for x in (logp, logp_b):
                logp_err = torch.maximum(logp_err, (x - ref_logp).abs().max())
        for who in (actor, None):
            a, greedy, none = OK.kernel_sample(logits, legal, actor=who, mode="greedy")
            keep = legal.any(-1) if who is None else legal.any(-1) & who
            nones += none is None
            got += [a, greedy]
            ref += [g, torch.where(keep, g, 0)]
        d, e, same_kind = ob_differences(got, ref)
        diff, err, dtypes_ok = diff + d, torch.maximum(err, e), dtypes_ok and same_kind
    return {"widths": list(SA_WIDTHS), "rows": SA_SWEEP_ROWS, "runs": runs,
            "unaligned": [A for A, shift in cases if shift],
            "differences": {"sample": int(diff)}, "max_abs_err": {"sample": float(err)},
            "logp_max_abs_err": float(logp_err), "dtypes_ok": dtypes_ok and nones == 4 * runs}


def entry_times(call) -> tuple:
    """(the last output, a call's span from an idle queue in ms, its device
    ms behind a sleep kernel, the wrapper's host us with no sync) of one
    entry: a warm-up, then the medians of OB_REPS spans, OB_REPS prefilled
    runs and 20 host times."""
    import torch

    call()  # warm-up
    spans = []
    for _ in range(OB_REPS):
        out, ms = timed_ms(call)
        spans.append(ms)
    span = statistics.median(spans)
    ms = statistics.median(prefilled_ms(call, span) for _ in range(OB_REPS))
    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e6)
    return out, span, ms, statistics.median(host)


def sa_timing(lw, rooms: int, seats: int) -> dict:
    """SA beside its plain version at `rooms` werewolf rooms of `seats`
    players spread over the game's phases (st_state), on OB's legal and
    actor masks and sa_inputs' logits and uniforms, timed as entry_times
    times them. The timed calls' outputs are held against the plain ones.
    The bound is the bytes SA must move (logits, legal, uniforms, actor
    read once, the three outputs written once) over the memory rate: its
    operations are a few a byte."""
    from game_engine_tpu_torch.policies import obs_kernel as OK

    state = st_state(lw, rooms, seats=seats)
    _, legal, actor = OK.kernel_observe(lw, state)
    logits, u = sa_inputs(legal, rooms + seats)
    out = {"rooms": rooms, "seats": seats, "rows": int(actor.numel()),
           "choices": int(legal.shape[-1]), "actors": int(actor.sum())}
    got = {}
    for name, call in (("", lambda: OK.kernel_sample(logits, legal, u, actor)),
                       ("plain_", lambda: sa_plain(logits, legal, u, actor, state.present)[:3])):
        got[name], out[name + "call_ms"], out[name + "ms"], out[name + "host_us"] = \
            entry_times(call)
    d, err, same_kind = ob_differences(got[""][:2], got["plain_"][:2])
    out.update(differences={"sample": int(d)}, max_abs_err={"sample": float(err)},
               dtypes_ok=same_kind,
               logp_max_abs_err=float((got[""][2] - got["plain_"][2]).abs().max()))
    out["bytes"] = nbytes(logits, legal, u, actor, *got[""])
    out["bound_ms"] = out["bytes"] / PEAK_BYTES * 1e3
    return out


def ob_check_case(name: str, lw, rooms: int, steps: int, seed: int, state=None) -> dict:
    """OB and SA against the plain functions on the card, `steps` steps of
    `rooms` rooms (of mixed sizes from init_state, or from `state`): OB's
    masked and full observations, legal and actor masks; SA's actions,
    actor-masked actions and logp (sa_inputs, ties forced), its "gumbel"
    mode on the plain version's noise and its greedy mode; then ST's step
    on odd_actions of the sampled actions, OB's rewards of the stepped
    state, and the reset. The differences and the largest absolute
    difference of each of OB_ENTRIES, and logp's, are counted on the card
    and read once."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core.engine import engine_step, reset_done
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.policies import obs_kernel as OK
    from game_engine_tpu_torch.train import ppo as P
    from game_engine_tpu_torch.utils.step_cases import odd_actions

    rng = np.random.default_rng(seed)
    if state is None:
        lo = min(lw.game.spec.declaration.min_players or 4, lw.P)
        n = torch.as_tensor(rng.integers(lo, lw.P + 1, rooms), dtype=torch.int32)
        state = init_state(lw, rooms, n, np.arange(rooms, dtype=np.uint32) * 7 + seed,
                           device="cuda")
    diff = {e: torch.zeros((), dtype=torch.int64, device="cuda") for e in OB_ENTRIES}
    err = {e: torch.zeros((), dtype=torch.float64, device="cuda") for e in OB_ENTRIES}
    logp_err = torch.zeros((), dtype=torch.float32, device="cuda")
    dtypes_ok, actors, ended_n = True, 0, 0

    def count(entry, got, ref):
        nonlocal dtypes_ok
        d, e, same_kind = ob_differences(got, ref)
        diff[entry], err[entry] = diff[entry] + d, torch.maximum(err[entry], e)
        dtypes_ok = dtypes_ok and same_kind

    for t in range(steps):
        for masked in (True, False):
            got = OK.kernel_observe(lw, state, masked)
            count("observe", got, [N.observe_plain(lw, state, masked),
                                   N.legal_action_mask_plain(lw, state),
                                   N.actor_mask_plain(lw, state)])
        _, legal, actor = got
        logits, u = sa_inputs(legal, seed * 100 + t)
        ref_a, ref_acting, ref_logp, ref_greedy, noise = sa_plain(logits, legal, u, actor,
                                                                  state.present)
        a, acting, logp = OK.kernel_sample(logits, legal, u, actor)
        ga, gacting, glogp = OK.kernel_sample(logits, legal, noise, actor, mode="gumbel")
        greedy = OK.kernel_sample(logits, legal, actor=state.present, mode="greedy")[1]
        count("sample", [a, acting, ga, gacting, greedy],
              [ref_a, ref_acting, ref_a, ref_acting, ref_greedy])
        logp_err = torch.maximum(logp_err, torch.maximum((logp - ref_logp).abs().max(),
                                                         (glogp - ref_logp).abs().max()))
        actors = actors + actor.sum()
        nxt, ended = engine_step(lw, state, odd_actions(lw, acting, rng))
        count("rewards", [OK.kernel_rewards(lw, nxt, ended)],
              [P.terminal_rewards_plain(lw, nxt, ended)])
        ended_n = ended_n + ended.sum()
        state = reset_done(lw, nxt)
    return {"case": name, "game": lw.game.spec.name, "P": lw.P, "NP": lw.NP, "rooms": rooms,
            "steps": steps, "differences": {e: int(d) for e, d in diff.items()},
            "max_abs_err": {e: float(x) for e, x in err.items()},
            "logp_max_abs_err": float(logp_err), "dtypes_ok": dtypes_ok,
            "actors": int(actors), "episodes_ended": int(ended_n)}


def ob_timing(lw, rooms: int) -> dict:
    """OB (the observation with both masks), OB's reward mode and SA beside
    their plain versions at `rooms` werewolf rooms of 8 spread over the
    game's phases, as st_timing times ST: "ms" a call's device time
    (prefilled_ms, median of OB_REPS), "call_ms" its span from an idle
    queue, "host_us" the wrapper's host time (no sync); the plain
    versions' alike. The timed calls' outputs are held against the plain
    ones. The bound is the bytes each must move (the GameState fields read
    and the outputs written once, or SA's logits, masks, uniforms and
    outputs) over the memory rate: their operations are a few a byte."""
    import torch

    from game_engine_tpu_torch.core import step_kernel as SK
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.policies import obs_kernel as OK
    from game_engine_tpu_torch.train import ppo as P

    state = st_state(lw, rooms)
    nxt, ended = SK.kernel_step(lw, state, SK.kernel_bot_actions(lw, state))
    _, legal, actor = OK.kernel_observe(lw, state)
    logits, u = sa_inputs(legal, rooms)
    calls = {"ob_": lambda: OK.kernel_observe(lw, state),
             "plain_ob_": lambda: (N.observe_plain(lw, state), N.legal_action_mask_plain(lw, state),
                                   N.actor_mask_plain(lw, state)),
             "rewards_": lambda: (OK.kernel_rewards(lw, nxt, ended),),
             "plain_rewards_": lambda: (P.terminal_rewards_plain(lw, nxt, ended),),
             "sa_": lambda: OK.kernel_sample(logits, legal, u, actor),
             "plain_sa_": lambda: sa_plain(logits, legal, u, actor, state.present)[:3]}
    out = {"rooms": rooms, "seats": 8, "phases_held": int(torch.unique(state.phase).numel()),
           "actors": int(actor.sum()), "episodes_ended": int(ended.sum()),
           "rooms_per_block": OK.observe_plan(lw, rooms, state.present.device)[0]}
    got = {}
    for name, call in calls.items():
        got[name], out[name + "call_ms"], out[name + "ms"], out[name + "host_us"] = \
            entry_times(call)
    checks = {"observe": ob_differences(got["ob_"], got["plain_ob_"]),
              "rewards": ob_differences(got["rewards_"], got["plain_rewards_"]),
              "sample": ob_differences(got["sa_"][:2], got["plain_sa_"][:2])}
    out["differences"] = {e: int(d) for e, (d, _, _) in checks.items()}
    out["max_abs_err"] = {e: float(x) for e, (_, x, _) in checks.items()}
    out["dtypes_ok"] = all(k for _, _, k in checks.values())
    out["logp_max_abs_err"] = float((got["sa_"][2] - got["plain_sa_"][2]).abs().max())
    read = nbytes(state.bools, state.nums, state.strs, state.present, state.phase, state.acted,
                  state.done)
    out["bytes"] = {"ob": read + nbytes(*got["ob_"]),
                    "rewards": nbytes(nxt.present, nxt.strs, nxt.winner, ended, *got["rewards_"]),
                    "sa": nbytes(logits, legal, u, actor, *got["sa_"])}
    out["bound_ms"] = {k: v / PEAK_BYTES * 1e3 for k, v in out["bytes"].items()}
    return out


def ob_sync_check(lw) -> dict:
    """OB, its reward mode and SA under torch's sync debug mode "error" at
    the unroll's shape (4096 rooms, after a warm-up that caches the table):
    any host wait for the card raises."""
    import torch

    from game_engine_tpu_torch.core import step_kernel as SK
    from game_engine_tpu_torch.policies import obs_kernel as OK

    state = st_state(lw, ROOMS)
    nxt, ended = SK.kernel_step(lw, state, SK.kernel_bot_actions(lw, state))
    _, legal, actor = OK.kernel_observe(lw, state)
    logits, u = sa_inputs(legal, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        OK.kernel_observe(lw, state)
        OK.kernel_rewards(lw, nxt, ended)
        OK.kernel_sample(logits, legal, u, actor)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return {"rooms": ROOMS, "sync_debug_mode": "error", "raised": False}


def entry_sections(gpu: str) -> dict:
    """ST's and OB's device time split by section of a block (the
    -DGE_PROFILE builds: a block's first thread reads clock64() after each
    barrier and adds the cycles since the last mark), at ST_SIZES werewolf
    rooms of 8 spread over the game's phases: ST's fused step_reset, its
    step and its reset (step_kernel.ST_SECTIONS) on the bots' actions, and
    the observation with both masks (obs_kernel.OB_SECTIONS). Each
    section's share of the cycles summed over the blocks, the sums, and
    the launches' lanes a room and rooms a block."""
    from game_engine_tpu_torch.core import step_kernel as SK
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.policies import obs_kernel as OK

    ww = lower(compile_game(load_builtin("werewolf")))
    out = {}
    for n in ST_SIZES:
        state = st_state(ww, n)
        actions = SK.kernel_bot_actions(ww, state)
        nxt, _ = SK.kernel_step(ww, state, actions)
        got = {}
        for name, run in (("st_step_reset", lambda: SK.profile_step(ww, state, actions)),
                          ("st_step", lambda: SK.profile_step(ww, state, actions, "step")),
                          ("st_reset", lambda: SK.profile_step(ww, nxt, actions, "reset")),
                          ("ob", lambda: OK.profile_observe(ww, state))):
            run()  # warm-up: the build, the plan, the tables
            cycles = run()
            total = sum(cycles.values())
            got[name] = {"cycles": cycles, "share": {k: v / total for k, v in cycles.items()}}
        got["lanes_per_room"] = SK.step_plan(ww, n, state.present.device)[0]
        got["ob_rooms_per_block"] = OK.observe_plan(ww, n, state.present.device)[0]
        out[str(n)] = got
    emit({"phase": "entry_sections", "by_rooms": out, "gpu": gpu})
    return out


def observe_step_phase(gpu: str) -> dict:
    """OB and SA against their plain versions on the card, bit for bit
    (logp within LOGP_TOL): every catalog game (OB_CHECK rooms x steps of
    mixed sizes), born-done rooms, werewolf at 40 and 72 seats, the
    78-phase game, and werewolf at OB_CHECK_SIZES from rooms spread over
    its phases; then their times at OB_SIZES beside the plain versions and
    their bounds, the timed calls' outputs held against the plain ones; SA
    at every lane-group width (sa_sweep_check) and its times at SA_SIZES
    (sa_timing, each beside the floor of one block), and the sync check.
    Returns the kernels line's numbers."""
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import games_dir, load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.utils.bench_games import long_game
    from game_engine_tpu_torch.utils.step_cases import born_done_game

    t0 = time.perf_counter()
    rooms, steps = OB_CHECK
    ww = lower(compile_game(load_builtin("werewolf")))
    names = sorted(fn[:-5] for fn in os.listdir(games_dir()) if fn.endswith(".yaml"))
    cases = [(name, lambda name=name: lower(compile_game(load_builtin(name))), rooms, steps,
              False) for name in names]
    cases += [("born_done", born_done_game, rooms, steps, False),
              ("werewolf_40_seats", lambda: large_game(40), rooms, steps, False),
              ("werewolf_72_seats", lambda: large_game(72), rooms // 4, steps, False),
              ("long_game_78_phases", long_game, rooms, steps, False)]
    cases += [(f"werewolf_{n}_rooms", lambda: ww, n, k, True) for n, k in OB_CHECK_SIZES]
    results = []
    for k, (name, make, n, n_steps, spread) in enumerate(cases):
        lw = make()
        got = ob_check_case(name, lw, n, n_steps, 2000 + k, st_state(lw, n) if spread else None)
        results.append(got)
        if not ob_agrees(got):
            emit({"phase": "observe_step_case", **got, "gpu": gpu})
            raise AssertionError(f"OB or SA differs from the plain functions on {name}: {got}")
    emit({"phase": "observe_step_check", "cases": len(results),
          "differences": dict.fromkeys(OB_ENTRIES, 0),
          "logp_max_abs_err": max(r["logp_max_abs_err"] for r in results), "per_case": results,
          "seconds": time.perf_counter() - t0, "gpu": gpu})
    if not any(r["episodes_ended"] for r in results) or max(r["P"] for r in results) != 72 \
            or not all(r["actors"] for r in results if r["game"] == ww.game.spec.name):
        raise AssertionError("the observe step check ended no episode, missed the wide rooms "
                             "or met no actor")
    timing = {n: ob_timing(ww, n) for n in OB_SIZES}
    for n, t in timing.items():
        if not ob_agrees(t):
            raise AssertionError(f"OB's or SA's timed calls at {n} rooms differ from plain: {t}")
    sweep = sa_sweep_check()
    if not ob_agrees(sweep):
        raise AssertionError(f"SA differs from plain across its lane-group widths: {sweep}")
    sa = {f"{n}x{p}": sa_timing(ww, n, p) for n, p in SA_SIZES}
    floor = sa[f"{SA_SIZES[0][0]}x{SA_SIZES[0][1]}"]["ms"]
    for key, t in sa.items():
        if not ob_agrees(t):
            raise AssertionError(f"SA's timed calls at {key} differ from plain: {t}")
        t["floor_ms"], t["ms_less_floor"] = floor, t["ms"] - floor
    emit({"phase": "sample_timing", "sweep": sweep, "by_rooms_and_seats": sa, "gpu": gpu})
    sync = ob_sync_check(ww)
    order = ob_plan_order_check()
    emit({"phase": "observe_step", "timing": {str(k): v for k, v in timing.items()},
          "sync_check": sync, "plan_order_check": order,
          "seconds": time.perf_counter() - t0, "gpu": gpu})
    checked = results + list(timing.values()) + [sweep] + list(sa.values())
    return {"timing": timing, "sa_timing": sa, "sa_sweep": sweep, "cases": len(results),
            "differences": {e: sum(r["differences"].get(e, 0) for r in checked)
                            for e in OB_ENTRIES},
            "max_abs_err": {e: max(r["max_abs_err"].get(e, 0.0) for r in checked)
                            for e in OB_ENTRIES},
            "logp_max_abs_err": max(r["logp_max_abs_err"] for r in checked)}


def ob_agrees(got: dict) -> bool:
    """Whether a check of ob_check_case or ob_timing found OB and SA equal
    to their plain versions: no difference, no dtype or shape apart, logp
    within LOGP_TOL."""
    return not any(got["differences"].values()) and not any(got["max_abs_err"].values()) \
        and got["dtypes_ok"] and got["logp_max_abs_err"] <= LOGP_TOL


TRAIN_CURVE_ARGV = ["--device", "cuda", "--arch", "attn", "--hidden", "256", "--batch", str(ROOMS),
                    "--players", "6", "--horizon", str(HORIZON), "--epochs", "4",
                    "--updates", "13", "--eval-every", "6", "--eval-batch", "1024"]


def train_curve_phase(gpu: str) -> dict:
    """run.main from fresh parameters for 13 updates with --eval-every 6
    (through OB, K2, SA and K4): the learned minority side's win rate
    against the scripted bots must rise from update 0 to 6 and to 12, the
    shape of the JAX package's run (0.3575, 0.6716, 0.6923 in
    docs/r5_tpu_runs/train_mono.log), not its values, since the random
    streams differ. Returns K2's and K4's launches."""
    import contextlib
    import io

    import torch

    from game_engine_tpu_torch.train import run as R

    out = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        R.main(TRAIN_CURVE_ARGV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = policy_launches()
    events = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    rates = {ev["update"]: ev["learned_as_minority"]["minority_win_rate"]
             for ev in events if ev["event"] == "eval"}
    majority = {ev["update"]: ev["learned_as_majority"]["minority_win_rate"]
                for ev in events if ev["event"] == "eval"}
    trains = [ev for ev in events if ev["event"] == "train"]
    emit({"phase": "train_curve", "argv": TRAIN_CURVE_ARGV, "seconds": seconds,
          "minority_win_rate_learned_as_minority": rates,
          "minority_win_rate_learned_as_majority": majority, "train": trains,
          "launches": launches, "gpu": gpu})
    if not (rates[6] > rates[0] and rates[12] > rates[0]):
        raise AssertionError(f"the learned minority's win rate did not rise from update 0 "
                             f"to 6 and 12: {rates}")
    want = {"policy_forward": K2_PER_UPDATE * 13, "policy_backward": 0, "ppo_loss_grad": 4 * 13}
    if launches != want:
        raise AssertionError(f"the 13-update run launched {launches}, expected {want}")
    return launches


SM_CYCLES_PER_MS = 1.98e6  # the H100's top SM clock: torch.cuda._sleep's cycles a ms
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")


def trace_events(prof) -> list:
    """The profiler's trace as Kineto exports it: every CUPTI record, the
    launches of the ctypes entries (ST, K2) included, which no torch op
    owns and so no FunctionEvent holds."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def prefilled_ms(fn, host_ms: float) -> float:
    """Device milliseconds of the work fn() enqueues, its kernels back to
    back: a sleep kernel holds the stream while the host enqueues them
    (longer than `host_ms`, the enqueue's time), and CUDA events bracket
    them. A host wait inside fn() drains the queue, so it then reads high."""
    import torch

    torch.cuda._sleep(int((3 * host_ms + 5) * SM_CYCLES_PER_MS))
    _, ms = timed_ms(fn)
    return ms


def unroll_split(lowered, gpu: str, route: str, steps: int = 3) -> dict:
    """One train-unroll step of the learner's shape (4096 werewolf rooms of
    6, the attn checkpoint through K2) split by op: observe, sample_actions
    (K2 inside), actor_mask, the engine step, terminal_rewards and the
    reset. For each, a step's launches (the trace's launch calls inside its
    record_function range, torch.profiler), host ms (the host clock around
    it, no profiler), device ms (prefilled_ms) and host waits (sync debug
    mode); the means of `steps` steps after a warm-up one, and a step's
    wall ms. route "plain": make_step and reset_where_done, the eager step
    every path ran before ST, with the plain observation, masks, draw and
    rewards; "st": engine.engine_step and reset_done (ST) with those plain
    ops, as every path ran before OB and SA; "ob": the unroll as it runs
    now, net.observe_all (OB: the observation and both masks, so the
    actor_mask group is empty), sample_actions with the actor mask (K2,
    torch.rand and SA) and ST's step_reset (the step, its rewards and the
    reset in one launch, so the terminal_rewards and reset groups are
    empty)."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.core import engine as E
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.core.step import make_step
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.train import ppo as P

    params, cfg = learner_start(CKPT)
    apply_fn = P.make_apply_fn(lowered, cfg)
    gen = torch.Generator(device="cuda").manual_seed(17)
    plain_step = make_step(lowered)

    def step(st, actions):
        if route != "plain":
            return E.engine_step(lowered, st, actions)
        nxt = plain_step(st, actions)
        return nxt, nxt.done & ~st.done

    def reset(st):
        return E.reset_done(lowered, st) if route != "plain" else E.reset_where_done(lowered, st)

    def ops(st) -> list:
        """The step as (group, call) pairs, each call taking and returning
        the carried values."""
        def observe(c):
            if route == "ob":
                c["obs"], c["legal"], c["mask"] = N.observe_all(lowered, c["st"])
            else:
                c["obs"] = N.observe_plain(lowered, c["st"])

        def sample(c):
            if route == "ob":
                c["actions"] = N.sample_actions(
                    lowered, params, c["st"], cfg.net, obs=c["obs"], apply_fn=apply_fn,
                    generator=gen, legal=c["legal"], actor=c["mask"])[0]
            else:
                c["a"] = N.sample_actions_plain(lowered, params, c["st"], cfg.net, obs=c["obs"],
                                                apply_fn=apply_fn, generator=gen)[0]

        def mask(c):
            if route != "ob":
                c["actions"] = torch.where(P.actor_mask_plain(lowered, c["st"]), c["a"], 0)

        def engine(c):
            if route == "ob":  # the step, its rewards and the reset: one step_reset
                res = E.step_and_reset(lowered, c["st"], c["actions"], rewards=True,
                                       out=c.get("spare"))
                c["spare"], c["st"] = c["st"], res.state
            else:
                c["nxt"], c["ended"] = step(c["st"], c["actions"])

        def rewards(c):
            if route != "ob":
                P.terminal_rewards_plain(lowered, c["nxt"], c["ended"])

        def reset_(c):
            if route != "ob":
                c["st"] = reset(c["nxt"])

        return list(zip(UNROLL_GROUPS, (observe, sample, mask, engine, rewards, reset_)))

    state = init_state(lowered, ROOMS, 6, np.arange(ROOMS, dtype=np.uint32) + 17, device="cuda")
    return {"route": route, "rooms": ROOMS, **split_step(ops, {"st": state}, steps), "gpu": gpu}


def split_step(ops, carry: dict, steps: int) -> dict:
    """A step of `ops(state)` -> [(group, call(carry))] measured by group
    after a warm-up step: host ms (the host clock around each call, no
    profiler), device ms (prefilled_ms), host waits (sync debug mode) and
    launches (the trace's launch calls inside the group's
    record_function range, torch.profiler), the means of `steps` steps,
    and each step's wall ms."""
    import collections
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    groups = {g: collections.defaultdict(float) for g, _ in ops(carry["st"])}
    with torch.no_grad():
        for _, call in ops(carry["st"]):  # warm-up: tables, plans, packed weights
            call(carry)
        torch.cuda.synchronize()
        wall = []
        for _ in range(steps):  # host ms and the step's wall ms, no profiler
            t0 = time.perf_counter()
            for g, call in ops(carry["st"]):
                t1 = time.perf_counter()
                call(carry)
                groups[g]["host_ms"] += (time.perf_counter() - t1) * 1e3 / steps
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        for _ in range(steps):  # device ms, each group on a prefilled queue
            for g, call in ops(carry["st"]):
                groups[g]["device_ms"] += prefilled_ms(
                    lambda: call(carry), groups[g]["host_ms"]) / steps
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:  # host waits
            warnings.simplefilter("always")
            for g, call in ops(carry["st"]):
                n = len(seen)
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    call(carry)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                groups[g]["host_waits"] = sum("synchroniz" in str(w.message)
                                              for w in seen[n:])
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                for g, call in ops(carry["st"]):
                    with record_function(g):
                        call(carry)
            torch.cuda.synchronize()
    trace = trace_events(prof)
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in trace
              if e.get("cat") == "user_annotation" and e.get("name") in groups]
    for e in trace:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(LAUNCH_CALLS):
            for t0, t1, g in ranges:
                if t0 <= e["ts"] <= t1:
                    groups[g]["launches"] += 1 / steps
    return {"steps": steps, "wall_ms_per_step": statistics.median(wall), "wall_ms_all": wall,
            "groups": {g: dict(v) for g, v in groups.items()},
            "host_ms_per_step": sum(v["host_ms"] for v in groups.values()),
            "device_ms_per_step": sum(v["device_ms"] for v in groups.values()),
            "launches_per_step": sum(v["launches"] for v in groups.values()),
            "host_waits_per_step": sum(v["host_waits"] for v in groups.values())}


def policy_split(gpu: str, steps: int = 8) -> dict:
    """A step of the policy loop (bench.py --policy's shape: 16,384 werewolf
    rooms of 8 after 128 steps, the mlp at hidden 256) split as
    split_step splits it: OB (observe_all), the mlp forward (apply_net,
    eager torch), the draw (torch.rand and SA), ST's step_reset (the step
    and the reset in one launch)."""
    import numpy as np
    import torch

    from game_engine_tpu_torch.bench import POLICY_SEED, policy_steps
    from game_engine_tpu_torch.core import engine as E
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.gamespec.compile import compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower
    from game_engine_tpu_torch.policies import net as N
    from game_engine_tpu_torch.policies import obs_kernel as OK

    rooms = POLICY_BENCH_SHAPE[0]
    lw = lower(compile_game(load_builtin("werewolf")))
    cfg = N.NetConfig(hidden=256, layers=2)
    params = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(lw),
                           N.action_space(lw), cfg, lw, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(POLICY_SEED)
    state = init_state(lw, rooms, 8, np.arange(rooms, dtype=np.uint32), device="cuda")
    state, _ = policy_steps(lw, params, cfg, state, POLICY_BENCH_SHAPE[1], gen)

    def ops(_):
        def observe(c):
            c["obs"], c["legal"], c["actor"] = N.observe_all(lw, c["st"])

        def forward(c):
            c["logits"] = N.apply_net(params, c["obs"], cfg, lw)[0]

        def draw(c):
            u = N.uniforms(c["logits"].shape, gen, c["logits"].device)
            c["actions"] = OK.kernel_sample(c["logits"], c["legal"], u, c["actor"])[1]

        def engine(c):
            res = E.step_and_reset(lw, c["st"], c["actions"], out=c.get("spare"))
            c["spare"], c["st"] = c["st"], res.state

        return [("observe", observe), ("forward", forward), ("draw", draw),
                ("engine_step", engine)]

    return {"rooms": rooms, **split_step(ops, {"st": state}, steps), "gpu": gpu}


def main(argv=()) -> int:
    argv = list(argv)
    profiled = argv == ["--profile"]
    multichip = argv == ["--multichip"]
    if argv and not (profiled or multichip):
        print(f"chip_smoke.py: unknown arguments {argv} (--profile or --multichip)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "game_engine_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(game_engine_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from game_engine_tpu_torch import _build
    from game_engine_tpu_torch.bench import gpu_line, int32_ops_per_s
    from game_engine_tpu_torch.core.engine import BatchedEngine, make_rollout
    from game_engine_tpu_torch.core.rollout_kernel import (
        count_rollout,
        kernel_rollout,
        launch_plan,
        profile_rollout,
    )
    from game_engine_tpu_torch.core.state import init_state
    from game_engine_tpu_torch.gamespec.compile import GameConfig, compile_game
    from game_engine_tpu_torch.gamespec.parser import load_builtin
    from game_engine_tpu_torch.gamespec.tables import lower

    gpu = gpu_line()
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "gpu": gpu,
          "device_count": torch.cuda.device_count()})
    if multichip:
        return multichip_main(gpu)

    t0 = time.perf_counter()
    _build.build_cuda()  # one nvcc per source, all at once
    lib = _build.cuda_lib()
    search_ptxas = ptxas_by_kernel(_build.search_lib(), SEARCH_KERNELS.values())
    if any(k["spill_store_bytes"] or k["spill_load_bytes"] for k in search_ptxas.values()):
        raise AssertionError(f"the search kernels spill: {search_ptxas}")
    wide_ptxas = ptxas_by_kernel(_build.search_lib(), SEARCH_KERNELS_WIDE.values())
    k1_ptxas = ptxas_by_kernel(lib, K1_KERNELS.values())
    st_ptxas = ptxas_by_kernel(lib, ST_KERNELS.values())
    ob_ptxas = ptxas_by_kernel(_build.observe_lib(), OB_KERNELS.values())
    sa_ptxas = ptxas_by_kernel(_build.observe_lib(), SA_KERNELS.values())
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas_report(lib),
          **{k: k1_ptxas[v] for k, v in K1_KERNELS.items()},
          **{k: st_ptxas[v] for k, v in ST_KERNELS.items()},
          "search_kernels_wide": wide_ptxas, "observe_kernels": ob_ptxas,
          "sample_kernels": {k: sa_ptxas[v] for k, v in SA_KERNELS.items()},
          "lossgrad_ptxas": ptxas_report(_build.lossgrad_lib()),
          "lossgrad_kernels": ptxas_by_kernel(_build.lossgrad_lib(), LG_KERNELS),
          "search_ptxas": ptxas_report(_build.search_lib()),
          "search_kernels": search_ptxas,
          "chat_decode_ptxas": ptxas_report(_build.chat_decode_lib()),
          "chat_decode_kernels": ptxas_by_kernel(_build.chat_decode_lib(), CHAT_KERNELS)})

    ww = lower(compile_game(load_builtin("werewolf")))
    tt = lower(compile_game(load_builtin("two-truths-and-a-lie"), GameConfig()))
    hl = lower(compile_game(load_builtin("harbor-lots")))  # 5 to 8 seats
    ww12 = lower(compile_game(load_builtin("werewolf"), GameConfig(max_players=12)))
    ww20 = lower(compile_game(load_builtin("werewolf"), GameConfig(max_players=20)))

    # -- kernel vs plain, bit-exact on the card ------------------------------
    worst = 0
    ww_threads = {}
    lanes_run = set()
    plain = {}  # one plain run a case, whatever the block size
    t0 = time.perf_counter()
    # load the library and the game's tables before anything is timed
    kernel_rollout(ww, init_state(ww, 8, 8, 0, device="cuda"), 1)
    for name, lw, B, n, steps, threads in (
            ("werewolf", ww, 4096, 8, 256, 128),
            ("two-truths-and-a-lie", tt, 1024, 4, 128, 128),
            ("harbor-lots", hl, 8192, 5, 128, 128),
            ("werewolf", ww, 4096, 8, 256, 64),
            ("werewolf", ww, 4096, 8, 256, 256),
            ("werewolf-12-seats", ww12, 4096, 12, 128, 128),
            ("werewolf-20-seats", ww20, 1024, 20, 128, 128)):
        start = init_state(lw, B, n, np.arange(B, dtype=np.uint32), device="cuda")
        launches = kernel_rollout.launches
        (got, eps), ms = timed_ms(
            lambda: kernel_rollout(lw, start, steps, threads_per_block=threads))
        if kernel_rollout.launches != launches + 1:
            raise AssertionError("kernel_rollout did not launch the kernel")
        if (name, B, n, steps) not in plain:
            plain[name, B, n, steps] = make_rollout(lw, steps)(start)
        ref, ref_eps = plain[name, B, n, steps]
        err = max_abs_err(got, ref, eps, ref_eps)
        plan = launch_plan(lw, B, threads)
        lanes_run.add(plan["lanes_per_room"])
        emit({"phase": "compare", "game": name, "rooms": B, "seats": n, "P": lw.P,
              "steps": steps, **plan, "kernel_ms": ms,
              "episodes": int(eps), "plain_episodes": int(ref_eps), "max_abs_err": err})
        if err != 0:
            bad = [f for f, x, y in zip(got._fields, got, ref) if not torch.equal(x, y)]
            raise AssertionError(f"{name}: kernel != plain in {bad}")
        if int(eps) <= 0:
            raise AssertionError(f"{name}: no episode completed in {steps} steps")
        if lw is ww:
            ww_threads[threads] = got
        worst = max(worst, err)
    if lanes_run != {8, 16, 32}:
        raise AssertionError(f"compare ran groups of {sorted(lanes_run)} lanes, not 8, 16 and 32")
    for threads in (64, 256):  # blocks of rooms are independent
        if not all(torch.equal(x, y) for x, y in zip(ww_threads[threads], ww_threads[128])):
            raise AssertionError(f"werewolf at {threads} threads/block differs from 128")
    del plain
    emit({"phase": "compare_done", "cases": 7, "seconds": time.perf_counter() - t0})

    # -- the main path ---------------------------------------------------------
    eng = BatchedEngine(ww, "cuda")
    starts = {B: eng.init(B, 8, np.arange(B, dtype=np.uint32)) for B in SIZES}
    firsts, times, episodes = {}, {}, {}
    kernel_rollout.launches = 0
    for B in SIZES:
        state, eps = eng.rollout(starts[B], STEPS)  # warm-up call
        firsts[B] = (state, eps)
        times[B], episodes[B] = [], int(eps)
        for _ in range(5):
            (state, eps), ms = timed_ms(lambda: eng.rollout(state, STEPS))
            times[B].append(ms)
            episodes[B] += int(eps)
    main_launches = kernel_rollout.launches
    if main_launches != 2 * 6:
        raise AssertionError(f"main path launched the kernel {main_launches} times, expected 12")

    kernel_ms, plain_ms = {}, {}
    for B in SIZES:
        state, eps = firsts[B]
        # right answer: the plain version from the same start, every room
        (ref, ref_eps), plain_ms[B] = timed_ms(lambda: make_rollout(ww, STEPS)(starts[B]))
        err = max_abs_err(state, ref, eps, ref_eps)
        if err != 0:
            raise AssertionError(f"main path at {B} rooms: kernel != plain")
        worst = max(worst, err)
        if bool(state.done.any()) or not torch.equal(state.present, starts[B].present):
            raise AssertionError("auto-reset left a room done or changed room sizes")
        if not (0 <= int(state.phase.min()) and int(state.phase.max()) < ww.NP):
            raise AssertionError("phase index out of range")
        if episodes[B] <= 0:
            raise AssertionError(f"no episode completed at {B} rooms")
        kernel_ms[B] = statistics.median(times[B])
        extra = {}
        if B == SIZES[0]:
            # the larger of the state's bytes, read and written once, over the
            # memory rate, and the integer operations the interpreter cannot
            # do without on these rooms over the card's int32 rate
            t0 = time.perf_counter()
            counts = count_rollout(ww, init_state(ww, B, 8, np.arange(B, dtype=np.uint32),
                                                  device="cpu"), STEPS)
            count_seconds = time.perf_counter() - t0
            int32_rate = int32_ops_per_s()
            by_bytes = 2 * nbytes(*starts[B]) / PEAK_BYTES * 1e3
            by_ops = counts["int_ops"] / int32_rate * 1e3
            k1_bound = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
            extra = {"interpreter_counts": counts, "count_seconds": count_seconds, "int32_ops_per_s": int32_rate,
                     "bound_ms_by_bytes": by_bytes, "bound_ms_by_operations": by_ops}
            if profiled:
                cycles = profile_rollout(ww, starts[B], STEPS)
                total = sum(cycles.values())
                extra["cycle_share_by_section"] = {
                    k: v / total for k, v in sorted(cycles.items(), key=lambda kv: -kv[1])}
                extra["cycles_per_room_step"] = total / (B * STEPS)
        emit({"phase": "main", "game": "werewolf", "rooms": B, "seats": 8, "steps": STEPS,
              **launch_plan(ww, B), **extra,
              "kernel_ms_per_call": times[B], "kernel_ms_median": kernel_ms[B],
              "env_steps_per_s": B * STEPS / (kernel_ms[B] / 1e3),
              "plain_ms": plain_ms[B],
              "plain_env_steps_per_s": B * STEPS / (plain_ms[B] / 1e3),
              "episodes_completed": episodes[B], "episodes_completed_ok": episodes[B] > 0,
              "first_call_max_abs_err_vs_plain": err, "gpu": gpu})

    bg_launches = bench_games_phase(gpu)
    st = engine_step_phase(gpu, int32_ops_per_s())
    ob = observe_step_phase(gpu)
    if profiled:  # ST's and OB's block time by section
        entry_sections(gpu)
    paths = STPaths()

    # -- the learner: K2-K4 vs plain at full width, then its main path -------
    from game_engine_tpu_torch.policies import net as N

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    attn, attn_cfg = N.load_policy(os.path.join(HERE, CKPT), device="cuda")
    ds_cfg = N.NetConfig(hidden=256, arch="deepsets")
    deepsets = N.init_params(torch.Generator().manual_seed(0), N.obs_dim(ww),
                             N.action_space(ww), ds_cfg, ww, device="cuda")
    traj, adv, ret = collect_trajectory(ww, attn, attn_cfg)
    policy = {}
    for name, params, cfg in (("attn_werewolf_u120", attn, attn_cfg),
                              ("deepsets_init_seed0", deepsets, ds_cfg)):
        for k, v in policy_compare(ww, traj, adv, ret, name, params, cfg, profiled).items():
            if name.startswith("attn"):
                policy[k] = v  # times at the shipped attn net
            else:  # the larger error of the two nets
                policy[k].update({e: max(policy[k][e], v[e]) for e in v if "err" in e})
    narrow = compare_narrow(ww, traj, adv, ret)
    packed_weights_check(ww, traj, adv, ret, attn, attn_cfg)
    del traj, adv, ret
    torch.cuda.empty_cache()
    with paths.of("large_rooms"):
        large = large_rooms_phase(gpu, int32_ops_per_s(), profiled)
    if profiled:  # the train unroll split by op: the eager step, ST, ST with OB and SA
        for route in ("plain", "st", "ob"):
            emit({"phase": "unroll_split", **unroll_split(ww, gpu, route, steps=8)})
    with paths.of("learner"):
        launches = train_phase(ww, gpu)
    with paths.of("train_narrow"):
        narrow_train = train_narrow_phase(gpu)
    with paths.of("train_curve"):
        curve = train_curve_phase(gpu)
    with paths.of("serving"):
        serving = serve_phase(gpu)
    s_compare = compare_search(gpu)
    s_line = search_timing(gpu, int32_ops_per_s(), profiled)
    with SearchLaunchSizes() as s_sizes:  # S's launches on its paths, by decisions
        with paths.of("serve_search"):
            s_serving = serve_search_phase(gpu)
        with paths.of("eval_search"):
            s_eval = eval_phase(gpu)
        with paths.of("league"):
            league = league_phase(ww, gpu)
        with paths.of("pipeline"):
            piped = pipeline_phase(ww, gpu)
        with paths.of("matchup"):
            matchup = matchup_phase(ww, gpu)
        judged = arena_phase(gpu)
    with paths.of("multidevice"):
        multi = multidevice_phase(ww, gpu)
    with paths.of("policy_bench"):
        policy_bench_phase(gpu)
    if profiled:  # the policy loop's step split by op
        emit({"phase": "policy_split", **policy_split(gpu)})
    c_compare = compare_chat(gpu)
    c_line = chat_timing(gpu, c_compare, profiled)
    zero_launches()
    c_by_path = {"chat_probes": chat_probes_phase(gpu)}
    c_by_program = decode_programs()
    with paths.of("serve_chat"):
        c_by_path["serving"], k2_serve_chat, served = serve_chat_phase(gpu)  # zeroes the counts
    zero_launches()
    c_by_path["train_chat_lm"] = train_chat_phase(gpu)
    c_by_program = {k: v + served[k] + decode_programs()[k] for k, v in c_by_program.items()}
    if sum(c_by_program.values()) != sum(c_by_path.values()):
        raise AssertionError(f"decode launches {c_by_path} and by program {c_by_program} differ")

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "game_engine_tpu"))
    if loaded:
        raise AssertionError(f"the port imported jax or the JAX package: {loaded[:10]}")
    by_path = {k: {"learner": launches[k], "train_narrow": narrow_train[k],
                   "train_curve": curve[k], "league": league[k], "pipeline": piped[k],
                   "matchup": matchup[k], "arena": judged["arena"][k],
                   "exploit": judged["exploit"][k], "multidevice": multi[k],
                   "large_rooms": large[k]["launches"]}
               for k in POLICY_REPLACES}
    by_path["policy_forward"]["serving"] = serving["launches"]
    by_path["policy_forward"]["serve_chat"] = k2_serve_chat
    launches = {k: sum(v.values()) for k, v in by_path.items()}
    s_paths = {**s_serving, "eval_search": s_eval, "arena": judged["arena"],
               "exploit": judged["exploit"],
               "large_rooms": {"search_decide": large["search_decide"]["launches"], "search": 0}}
    s_by_path = {e: {path: got[e] for path, got in s_paths.items()} for e in SEARCH_ENTRIES}
    st_by_entry = paths.entries(st_wrappers())
    for entry in st_wrappers():  # the ranks' own launches
        st_by_entry["multidevice"][entry] += multi[entry]
    st_by_path = {path: sum(got.values()) for path, got in st_by_entry.items()}
    idle = [path for path in ST_PATHS if not st_by_path.get(path)]
    if idle:
        raise AssertionError(f"ST was not launched on {idle}: {st_by_entry}")
    st_line = st["timing"][ST_SIZES[0]]
    ob_by_entry = paths.entries(ob_wrappers())
    for entry in ob_wrappers():  # the ranks' own launches
        ob_by_entry["multidevice"][entry] += multi[entry]
    ob_by_path = {name: {path: got["observe"] + got["rewards"] if name == "observe"
                         else got["sample"] for path, got in ob_by_entry.items()}
                  for name in ("observe", "sample")}
    idle = [(name, path) for name in ob_by_path for path in OB_PATHS
            if not ob_by_path[name].get(path)]
    if idle:
        raise AssertionError(f"OB or SA was not launched on {idle}: {ob_by_entry}")
    # an unroll step is one step_reset launch: no reset or rewards launch of its own
    apart = {path: (st_by_entry[path]["reset_done"], ob_by_entry[path]["rewards"])
             for path in UNROLL_PATHS}
    if any(apart[path] != (0, 0) or not st_by_entry[path]["step_reset"] for path in apart):
        raise AssertionError(f"an unroll path launched the reset or the rewards apart, or no "
                             f"step_reset: {apart}, {st_by_entry}")
    ob_line = ob["timing"][OB_SIZES[0]]
    sa_line = ob["sa_timing"][f"{ROOMS}x8"]
    ob_shape = {"game": "werewolf", "rooms": OB_SIZES[0], "seats": 8}
    emit({"kernels": [{
        "name": "rollout", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_launches + bg_launches + multi["rollout"] + large["rollout"]["launches"],
        "launches_by_path": {"engine": main_launches, "bench_games": bg_launches,
                             "multidevice": multi["rollout"],
                             "large_rooms": large["rollout"]["launches"]},
        "large_rooms": large["rollout"]["cases"], "ptxas": k1_ptxas,
        "max_abs_err": worst,
        "ms": kernel_ms[SIZES[0]], "plain_ms": plain_ms[SIZES[0]], "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1], "library_ms": None}, {
        "name": "engine_step", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": ST_REPLACES,
        "replaces_kind": "XLA's jitted step (jit_step), jitted bots and the unroll's reset, "
                         "no pallas_call site",
        "entries": ["ge_step", "ge_reset_done", "ge_bots", "ge_step_reset"],
        "launches": sum(st_by_path.values()), "launches_by_path": st_by_path,
        "launches_by_entry_and_path": st_by_entry,
        "max_abs_err": st["max_abs_err"], "differences": st["differences"],
        "cases_checked": st["cases"],
        "ms": st_line["ms"], "plain_ms": st_line["plain_ms"], "call_ms": st_line["call_ms"],
        "plain_call_ms": st_line["plain_call_ms"], "bound_ms": st_line["bound"][0],
        "bound_by": st_line["bound"][1], "library_ms": None,
        "host_us": st_line["host_us_per_call"],
        "step_reset_ms": st_line["step_reset_ms"],
        "step_reset_plain_ms": st_line["plain_step_reset_ms"],
        "step_reset_host_us": st_line["step_reset_host_us_per_call"],
        "step_reset_bound_ms": st_line["step_reset_bound_ms_by_bytes"],
        "three_launches_ms": st_line["three_ms"],
        "three_launches_host_us": st_line["three_host_us_per_call"],
        "library_ms_none_because": "no PyTorch call steps the game's interpreter",
        "by_rooms": {str(k): {x: y for x, y in v.items() if x not in (
            "bound", "interpreter_counts")} for k, v in st["timing"].items()},
        "ptxas": {k: st_ptxas[v] for k, v in ST_KERNELS.items()},
        "shape": {"game": "werewolf", "rooms": ST_SIZES[0], "seats": 8}}, {
        "name": "observe", "route": "cuda", "source": OB_SOURCE, "replaces": OB_REPLACES,
        "replaces_kind": "XLA's fusion of observe, legal_action_mask, actor_mask and "
                         "terminal_rewards in the jitted unroll body (train/ppo.py:138), no "
                         "pallas_call site",
        "entries": ["ob_observe", "ob_rewards"],
        "launches": sum(ob_by_path["observe"].values()),
        "launches_by_path": ob_by_path["observe"], "launches_by_entry_and_path": ob_by_entry,
        "max_abs_err": max(ob["max_abs_err"]["observe"], ob["max_abs_err"]["rewards"]),
        "max_abs_err_of": "obs as float, legal and actor masks, rewards",
        "max_abs_err_by_entry": {"ob_observe": ob["max_abs_err"]["observe"],
                                 "ob_rewards": ob["max_abs_err"]["rewards"]},
        "differences": ob["differences"]["observe"] + ob["differences"]["rewards"],
        "differences_by_entry": {"ob_observe": ob["differences"]["observe"],
                                 "ob_rewards": ob["differences"]["rewards"]},
        "cases_checked": ob["cases"],
        "ms": ob_line["ob_ms"], "plain_ms": ob_line["plain_ob_ms"],
        "call_ms": ob_line["ob_call_ms"], "plain_call_ms": ob_line["plain_ob_call_ms"],
        "host_us": ob_line["ob_host_us"], "plain_host_us": ob_line["plain_ob_host_us"],
        "rewards_ms": ob_line["rewards_ms"], "plain_rewards_ms": ob_line["plain_rewards_ms"],
        "rewards_bound_ms": ob_line["bound_ms"]["rewards"],
        "bound_ms": ob_line["bound_ms"]["ob"], "bound_by": "bytes", "library_ms": None,
        "library_ms_none_because": "no PyTorch call builds the observation or its masks",
        "by_rooms": {str(k): v for k, v in ob["timing"].items()},
        "ptxas": {k: ob_ptxas[v] for k, v in OB_KERNELS.items() if k != "sample"},
        "shape": ob_shape}, {
        "name": "sample", "route": "cuda", "source": OB_SOURCE, "replaces": SA_REPLACES,
        "replaces_kind": "XLA's fusion of sample_actions' draw and log-softmax and the "
                         "unroll's actor-masked actions, no pallas_call site",
        "entries": ["ob_sample"],
        "design": "a row a group of lanes of 8 contiguous choices each (one lane at 8 "
                  "choices, 16 at 72 seats), every load issued first, shuffle butterflies "
                  "and a ballot, one output buffer a call",
        "launches": sum(ob_by_path["sample"].values()),
        "launches_by_path": ob_by_path["sample"],
        "max_abs_err": ob["logp_max_abs_err"], "max_abs_err_of": "logp",
        "actions_max_abs_err": ob["max_abs_err"]["sample"],
        "differences": ob["differences"]["sample"], "cases_checked": ob["cases"],
        "widths_checked": ob["sa_sweep"]["widths"],
        "ms": sa_line["ms"], "plain_ms": sa_line["plain_ms"], "floor_ms": sa_line["floor_ms"],
        "ms_less_floor": sa_line["ms_less_floor"],
        "call_ms": sa_line["call_ms"], "plain_call_ms": sa_line["plain_call_ms"],
        "host_us": sa_line["host_us"], "plain_host_us": sa_line["plain_host_us"],
        "bound_ms": sa_line["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "library_ms_none_because": "no PyTorch call draws a masked Gumbel-max with its logp",
        "by_rooms_and_seats": ob["sa_timing"],
        "ptxas": {k: sa_ptxas[v] for k, v in SA_KERNELS.items()}, "shape": ob_shape}] + [{
        "name": k, "route": "cuda", "source": POLICY_SOURCE[k], "replaces": POLICY_REPLACES[k],
        "launches": launches[k], "launches_by_path": by_path[k],
        "ms": policy[k]["ms"], "plain_ms": policy[k]["plain_ms"],
        "bound_ms": policy[k]["bound"][0], "bound_by": policy[k]["bound"][1],
        "library_ms": None, "ran": "tensor_core",
        **{e: v for e, v in policy[k].items() if e not in ("ms", "plain_ms", "bound")},
        **({"serving_route": "tensor_core", "serving_ms_by_rows": serving["k2"]}
           if k == "policy_forward" else {}),
        "widths": {"ran": "tensor_core", **narrow[k]}, "large_rooms": large[k]["cases"]}
        for k in POLICY_REPLACES] + [{
        "name": e, "route": "cuda", "source": SEARCH_SOURCE, "replaces": SEARCH_REPLACES,
        "replaces_kind": "C++ host code (search_scores_core, gs_room_search), no pallas_call "
                         "site", "entry": SEARCH_ENTRIES[e],
        "launches": sum(s_by_path[e].values()), "launches_by_path": s_by_path[e],
        "launches_by_decisions": s_sizes.counts[e],  # also the journal replays' and the
        # arena's second run, which launches_by_path leaves out
        "max_abs_err": s_compare["max_abs_err"], "decisions_checked": s_compare["decisions"],
        "ms": s_line[e]["ms"], "plain_ms": s_line[e]["plain_ms"], "bound_ms": s_line["bound"][0],
        "bound_by": s_line["bound"][1], "library_ms": None,
        "ptxas": search_ptxas[SEARCH_KERNELS[e]],
        "ptxas_wide": wide_ptxas[SEARCH_KERNELS_WIDE[e]],
        **({"large_rooms": large["search_decide"]["cases"]} if e == "search_decide" else {}),
        "shape": {"game": "werewolf", "decisions": s_line["decisions"],
                  "requests": s_line["requests"], "rollouts": SEARCH_R, "horizon": SEARCH_H}}
        for e in SEARCH_ENTRIES] + [{
        "name": "chat_decode", "route": "cuda", "source": CHAT_SOURCE, "replaces": CHAT_REPLACES,
        "replaces_kind": "XLA lax.scan (_make_decoder), no pallas_call site",
        "launches": sum(c_by_path.values()), "launches_by_path": c_by_path,
        "launches_by_program": c_by_program,
        "max_abs_err": c_compare["max_abs_err"], "ms": c_line["ms"],
        "prefill_ms": c_line["prefill_ms"], "decode_ms": c_line["decode_ms"],
        "us_per_generated_position": c_line["us_per_position"],
        "batch64_ms": c_line["batch_ms"],
        "plain_ms": c_line["plain_ms"], "bound_ms": c_line["bound"][0],
        "bound_by": c_line["bound"][1], "library_ms": None,
        "library_ms_none_because": "no single PyTorch call decodes with a KV cache and a "
                                   "nucleus draw",
        "shape": {"checkpoint": CHAT_CKPT, "launches_per_reply": c_line["launches_per_reply"],
                  "cluster": 8, "max_new": CHAT_MAX_NEW}}]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
