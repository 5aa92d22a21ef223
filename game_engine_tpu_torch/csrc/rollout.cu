// rollout.cu — the batched engine rollout as one CUDA kernel (sm_90a).
//
// Replaces the TPU kernel game_engine_tpu/core/pallas_rollout.py
// ::make_pallas_rollout (K1): num_steps full engine steps (scripted bots,
// P1/P2 acceptance, record writes, P3 completion, P5 first-match branch,
// on-enter effect IR, fresh-completion count, auto-reset) with the room
// state held on chip for the whole call, one global-memory round trip per
// call. Bit-identical to the plain-torch rollout (core/engine.make_rollout).
//
// What bounds it on the H100: the serial latency of a room's step, not HBM
// and not integer throughput. A room's state is a few hundred int32 read
// once and written once per call, while every step walks a data-dependent
// interpreter (predicate DNF, branch first-match, an effect DAG) whose
// table reads and branches depend on one another. The TPU kernel lays rooms
// along lanes because its vector unit wants (8, 128) tiles; with one room a
// thread, a few thousand rooms fill a fraction of this card's warp slots,
// each warp runs the union of its 32 rooms' phases, and the room's arrays,
// indexed at run time, live in local memory.
//
// What the design does about it (csrc/room_step.cuh has the details): a room
// is run by a group of G lanes, one seat a lane, G a power of two >= P, so
// the per-seat loops of the engine run side by side, a warp holds 32 / G
// rooms to diverge, and the same rooms give G times the warps to hide
// latency; a call of so few rooms that the card has warp slots to spare
// widens the groups further (launch_plan.cuh). A room of more than 32 seats
// runs on a whole warp, a lane taking seats lane, lane + 32, ..., and its
// seat sets in MAX_SEAT_WORDS words: the kernel's second build
// (ge_rollout_kernel<MAX_SEAT_WORDS>), so the one-word build of the rooms
// of up to 32 seats stays as it was. The room's words (state, action,
// effect-IR node values, a branch condition's stack) live in dynamic shared
// memory as [slot][column], SW = ceil(P / 32) columns a lane, sized by the
// host to the game's own banks and largest effect block and condition,
// behind the game's tables (the pack.py blob, copied in once per block, so
// one build serves every game). Groups
// meet only at their own lanes' __syncwarp and ballots inside the step loop.
// The global state stays in the (bank, P, rooms) layout; the block copies
// its rooms in and out with one loop over (slot, seat, room), so neighbouring
// threads touch neighbouring rooms of one field.
//
// The same library holds ST, the engine step entry (ge_step_kernel; exported
// as ge_bots, ge_step, ge_reset_done and ge_step_reset): one step, the reset
// of done rooms, the scripted bots, or an unroll's step, terminal rewards
// and reset of every room in a launch, on GameState's own tensors, for the
// paths that step rooms a turn at a time (the unrolls, the policy loop, the
// server). It is the counterpart of the JAX package's jitted step and of the
// unroll body around it, not of a Pallas kernel, and shares the room code
// above; K1's kernel is untouched by it. What bounds ST is a room step's
// chain, as for K1, once a launch: the block sections measured on the card
// (chip_smoke.py entry_sections) put the step itself at about half a block
// and the copies of the state in and out at about a third, so a block copies
// its rooms' fields with cp.async, every load in flight together, and the
// unrolls take one launch where the step, OB's rewards and the reset took
// three.
//
// -DGE_PROFILE builds the variant that sums clock64() by section of the step
// (ge_rollout_profile) and by section of an ST block (ge_step_sections); the
// engine never loads it.

#include <cuda_runtime.h>

#include "launch_plan.cuh"
#include "room_step.cuh"

namespace {

// NW: words of a seat set, 1 for rooms of up to 32 seats
template <int NW>
__global__ void ge_rollout_kernel(const int32_t* __restrict__ game, int game_len,
                                  ge::MinorState ms, int32_t* __restrict__ eps,
                                  int64_t B, int num_steps, int auto_reset, int G,
                                  long long* __restrict__ prof) {
  extern __shared__ int32_t smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  for (int i = tid; i < game_len; i += T) smem[i] = game[i];
  __syncthreads();
  const ge::Game g = ge::game_view(smem);
  const int K = NW == 1 ? 1 : g.SW;  // columns a lane
  int32_t* words = smem + game_len;
  const int R = T / G;  // rooms a block
  const int64_t room0 = (int64_t)blockIdx.x * R;
  ge::rooms_copy(g, ms, words, T * K, G * K, R, room0, B, tid, T, false);
  __syncthreads();
  const int lane = tid & (G - 1), first = (tid & 31) & ~(G - 1);
  const int64_t room = room0 + tid / G;
  if (room < B) {  // whole groups take or leave this branch
    const uint32_t mask = (G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u) << first;
    ge::Room<NW> r =
        ge::room_open<NW>(g, ms, words + (tid - lane) * K, T * K, lane, mask, first, room, B);
    const int32_t episodes = ge::room_rollout(g, r, num_steps, auto_reset);
    if (lane == 0) {
      eps[room] = episodes;
      ge::room_close(r, ms, room, B);
#ifdef GE_PROFILE
      for (int k = 0; k < ge::N_PROF; ++k)
        if (r.prof[k]) atomicAdd((unsigned long long*)prof + k, (unsigned long long)r.prof[k]);
#endif
    }
  }
  __syncthreads();
  ge::rooms_copy(g, ms, words, T * K, G * K, R, room0, B, tid, T, true);
}

// the build of the kernel for the game's seats
const void* rollout_kernel_for(const ge::Game& g) {
  return g.P <= 32 ? (const void*)ge_rollout_kernel<1>
                   : (const void*)ge_rollout_kernel<ge::MAX_SEAT_WORDS>;
}

int launch(const int32_t* game, const int32_t* game_host, int game_len,
           const ge::MinorState& ms, int32_t* eps, int64_t B, int num_steps,
           int auto_reset, int threads, long long* prof, cudaStream_t stream) {
  const ge::Game g = ge::game_view(game_host);
  if (!ge::launchable(g, game_len, B, threads)) return (int)cudaErrorInvalidValue;
  const ge::Plan p = ge::plan(rollout_kernel_for(g), g, game_len, B, threads);
  if (p.err != cudaSuccess) return (int)p.err;
  const int R = p.threads / p.G;
  const int64_t blocks = (B + R - 1) / R;
  if (g.P <= 32)
    ge_rollout_kernel<1><<<(unsigned)blocks, p.threads, p.smem, stream>>>(
        game, game_len, ms, eps, B, num_steps, auto_reset, p.G, prof);
  else
    ge_rollout_kernel<ge::MAX_SEAT_WORDS><<<(unsigned)blocks, p.threads, p.smem, stream>>>(
        game, game_len, ms, eps, B, num_steps, auto_reset, p.G, prof);
  return (int)cudaGetLastError();
}

// ST, the engine step entry: one launch does one room_entry (the scripted
// bots, one engine step, the reset where done, or the unroll's step,
// rewards and reset in one) of every room, a room on a group of lanes as in
// ge_rollout_kernel, the game's tables and the rooms' words in shared memory
// as there. The state is read from GameState's own tensors and the result
// written to new ones, each field of a block's rooms one run of elements,
// all of a block's runs copied with their loads in flight together
// (room_step.cuh st_block), so nothing is converted on the host and the
// caller's state is left as it was.
// at most ST_THREADS lanes a block (the plan's ask, halved for a room that
// does not fit), registers for ST_MIN_BLOCKS such blocks an SM
constexpr int ST_THREADS = 128, ST_MIN_BLOCKS = 6;

template <int NW>
__global__ void __launch_bounds__(ST_THREADS, ST_MIN_BLOCKS)
    ge_step_kernel(ge::StArgs a, int G, long long* prof) {
  extern __shared__ int32_t smem[];
  const int R = blockDim.x / G;  // rooms a block
  ge::st_block<NW>(a, smem, (int64_t)blockIdx.x * R, blockDim.x, G, threadIdx.x, blockDim.x,
                   prof);
}

// -DGE_PROFILE: ST's launches add their block sections' cycles here
// (ge_step_sections); null otherwise
long long* st_prof = nullptr;

const void* step_kernel_for(const ge::Game& g) {
  return g.P <= 32 ? (const void*)ge_step_kernel<1>
                   : (const void*)ge_step_kernel<ge::MAX_SEAT_WORDS>;
}

// One ST launch, sized by the caller's cached ge_step_plan: G lanes a room,
// `threads` a block, `smem` bytes of shared memory a block. A plan that does
// not fit the game, or a reward rule that does not, is refused
// (cudaErrorInvalidValue) before the launch.
int launch_entry(const int32_t* game_host, const ge::StArgs& a, int G, int threads,
                 int64_t smem, cudaStream_t stream) {
  const ge::Game g = ge::game_view(game_host);
  if (!ge::launchable(g, a.game_len, a.B, threads) || threads > ST_THREADS ||
      G < ge::group_lanes(g.P) ||
      G > ge::MAX_GROUP || (G & (G - 1)) || threads % G ||
      smem != ge::st_shared_bytes(g, a.game_len, threads, G) || smem > ge::MAX_SHARED ||
      (a.mode == ge::ENTRY_STEP_RESET && a.reward && !ge::reward_rule_ok(g, a.rw)))
    return (int)cudaErrorInvalidValue;
  ge::StArgs la = a;
  ge::st_fill(la, g, threads, G);
  const int64_t blocks = (a.B + threads / G - 1) / (threads / G);
  if (g.P <= 32)
    ge_step_kernel<1><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(la, G, st_prof);
  else
    ge_step_kernel<ge::MAX_SEAT_WORDS><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
        la, G, st_prof);
  return (int)cudaGetLastError();
}

ge::StArgs st_args(const int32_t* game, int game_len, const int64_t* in, const int64_t* out,
                   int32_t* actions, int64_t B, int mode) {
  ge::StArgs a{};
  a.game = game;
  a.game_len = game_len;
  a.in = ge::batch_state(in);
  a.out = ge::batch_state(out ? out : in);
  a.actions = actions;
  a.B = B;
  a.mode = mode;
  return a;
}

}  // namespace

extern "C" {

const char* ge_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// room_step.cuh size_report: how a block of the game (a host array) is sized.
void ge_size(const int32_t* game_host, int game_len, int threads, int64_t* out) {
  ge::size_report(game_host, game_len, threads, out);
}

// How a launch over B rooms of the game (a host array) would be sized when
// `threads` lanes a block are asked for: out = {lanes a room, dynamic shared
// memory bytes a block, blocks one SM holds at a time, lanes a block}.
// Returns a CUDA error code (0 = ok).
int ge_plan(const int32_t* game_host, int game_len, int64_t B, int threads, int64_t* out) {
  const ge::Game g = ge::game_view(game_host);
  if (!ge::launchable(g, game_len, B, threads)) return (int)cudaErrorInvalidValue;
  const ge::Plan p = ge::plan(rollout_kernel_for(g), g, game_len, B, threads);
  out[0] = p.G; out[1] = (int64_t)p.smem; out[2] = p.held; out[3] = p.threads;
  return (int)p.err;
}

// How an ST launch (ge_bots, ge_step, ge_reset_done, ge_step_reset) over B
// rooms of the game is sized on the current card, as ge_plan sizes the
// rollout's (the same rule, for the step kernel's registers and its
// staging): the caller asks once per game, batch and card and passes
// {out[0], out[3], out[1]} to every launch.
int ge_step_plan(const int32_t* game_host, int game_len, int64_t B, int threads, int64_t* out) {
  const ge::Game g = ge::game_view(game_host);
  if (!ge::launchable(g, game_len, B, threads) || threads > ST_THREADS)
    return (int)cudaErrorInvalidValue;
  const ge::Plan p = ge::plan(step_kernel_for(g), g, game_len, B, threads, true);
  out[0] = p.G; out[1] = (int64_t)p.smem; out[2] = p.held; out[3] = p.threads;
  return (int)p.err;
}

// ST's entries on `stream`. `state` and `out` are the addresses of
// GameState's 15 tensors (BatchState order), `out` freshly allocated: the
// state after the step / after the reset; ge_bots writes the scripted bots'
// (B, P) int32 actions. G, threads and smem: ge_step_plan's. Each returns
// cudaGetLastError() after the launch (0 = launched).
int ge_bots(const int32_t* game, const int32_t* game_host, int game_len, const int64_t* state,
            int32_t* actions, int64_t B, int G, int threads, int64_t smem, void* stream) {
  const ge::StArgs a = st_args(game, game_len, state, nullptr, actions, B, ge::ENTRY_BOTS);
  return launch_entry(game_host, a, G, threads, smem, (cudaStream_t)stream);
}

// keep: (B,) bool, the rooms to step (null: every room); ended: (B,) bool.
int ge_step(const int32_t* game, const int32_t* game_host, int game_len, const int64_t* state,
            const int64_t* out, const int32_t* actions, const uint8_t* keep, uint8_t* ended,
            int64_t B, int G, int threads, int64_t smem, void* stream) {
  ge::StArgs a = st_args(game, game_len, state, out, const_cast<int32_t*>(actions), B,
                         ge::ENTRY_STEP);
  a.keep = keep;
  a.ended = ended;
  return launch_entry(game_host, a, G, threads, smem, (cudaStream_t)stream);
}

int ge_reset_done(const int32_t* game, const int32_t* game_host, int game_len,
                  const int64_t* state, const int64_t* out, int64_t B, int G, int threads,
                  int64_t smem, void* stream) {
  const ge::StArgs a = st_args(game, game_len, state, out, nullptr, B, ge::ENTRY_RESET);
  return launch_entry(game_host, a, G, threads, smem, (cudaStream_t)stream);
}

// The unroll's step, terminal rewards and reset in one launch: `out` the
// state after the step and the restart of the rooms it left done; ended
// (B,) bool; winner (B,) int32, the stepped rooms' winner; reward (B, P)
// f32 by the rule {rw_mode, rw_team_slot, codes (n_codes int32 on the
// device)}, or null for none.
int ge_step_reset(const int32_t* game, const int32_t* game_host, int game_len,
                  const int64_t* state, const int64_t* out, const int32_t* actions,
                  uint8_t* ended, int32_t* winner, float* reward, int rw_mode, int rw_team_slot,
                  const int32_t* codes, int n_codes, int64_t B, int G, int threads, int64_t smem,
                  void* stream) {
  ge::StArgs a = st_args(game, game_len, state, out, const_cast<int32_t*>(actions), B,
                         ge::ENTRY_STEP_RESET);
  a.ended = ended;
  a.winner = winner;
  a.reward = reward;
  a.rw = ge::RewardRule{rw_mode, rw_team_slot, n_codes, codes};
  return launch_entry(game_host, a, G, threads, smem, (cudaStream_t)stream);
}

#ifdef GE_PROFILE
// ST's launches from now on add their block sections' clock64() cycles to
// prof (ST_SECTIONS int64 on the device, zeroed by the caller); null stops.
void ge_step_sections(long long* prof) { st_prof = prof; }
#endif

#ifndef GE_PROFILE
// Launches the rollout on `stream` over B rooms, in place on the minor-layout
// buffers; eps receives each room's completed episodes. `game` is the game
// array on the device and `game_host` the same array on the host, from which
// the launch is sized. Returns cudaGetLastError() after the launch (0 =
// launched).
int ge_rollout(const int32_t* game, const int32_t* game_host, int game_len,
               int32_t* bools, int32_t* nums, int32_t* strs, int32_t* pdict,
               int32_t* odict, int32_t* present, int32_t* regs, int32_t* scal,
               int32_t* eps, int64_t B, int num_steps, int auto_reset, int threads,
               void* stream) {
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  return launch(game, game_host, game_len, ms, eps, B, num_steps, auto_reset, threads,
                nullptr, (cudaStream_t)stream);
}
#else
// The same launch with clock sums: prof receives N_PROF (32) int64 sums of
// clock64() over every room, by section (room_step.cuh PROF_*); the caller
// zeroes it.
int ge_rollout_profile(const int32_t* game, const int32_t* game_host, int game_len,
                       int32_t* bools, int32_t* nums, int32_t* strs, int32_t* pdict,
                       int32_t* odict, int32_t* present, int32_t* regs, int32_t* scal,
                       int32_t* eps, int64_t B, int num_steps, int auto_reset,
                       int threads, long long* prof, void* stream) {
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  return launch(game, game_host, game_len, ms, eps, B, num_steps, auto_reset, threads,
                prof, (cudaStream_t)stream);
}
#endif

}  // extern "C"
