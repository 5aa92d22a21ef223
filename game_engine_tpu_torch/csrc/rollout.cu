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
// -DGE_PROFILE builds the variant that sums clock64() by section of the step
// (ge_rollout_profile); the engine never loads it.

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
