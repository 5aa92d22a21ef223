// search.cu — the lookahead search bots' rollouts as one CUDA kernel (sm_90a).
//
// Counterpart of native/gamesim.cpp gs_room_search_scores (search_scores_core),
// the C++ host code behind the JAX package's search bots (policies/search.py):
// for each request {source room, seat p, candidate c, salt} the total over
// k < rollouts of one rollout's terminal score, where rollout k copies the
// source room, reseeds it from (salt, the room's step, k), forces seat p's
// first action to c and runs scripted bots and the engine step until the room
// is done or `horizon` steps have passed. The host (core/search_kernel.py,
// policies/search.py) enumerates the candidates and takes the argmax; the
// totals are exact, so the decisions equal the C++ search's bit for bit.
//
// What bounds it: as for the rollout kernel (csrc/rollout.cu), the serial
// latency of a room's step through the table interpreter. So it keeps that
// kernel's structure (room_step.cuh): a rollout is a room on a group of G
// lanes, a seat a lane, its words in dynamic shared memory sized to the game
// behind the game's tables, and the launch widens G while the card has warp
// slots to spare (launch_plan.cuh, the rollout kernel's plan). What differs: a rollout loads its words from its request's
// source room by index (rooms_load), so the N rollouts of a room cost no
// N-fold copy of it in global memory; the seed is computed here; the step
// loop ends when the group's room is done; nothing is written back but one
// 64-bit atomic add of the score into the request's total (integer addition:
// exact and independent of order).

#include <cuda_runtime.h>

#include "launch_plan.cuh"
#include "room_step.cuh"

namespace {

__global__ void ge_search_kernel(const int32_t* __restrict__ game, int game_len,
                                 ge::MinorState ms, int64_t B, const int32_t* __restrict__ req,
                                 int64_t n_req, ge::SearchSpec s,
                                 unsigned long long* __restrict__ totals, int G) {
  extern __shared__ int32_t smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  for (int i = tid; i < game_len; i += T) smem[i] = game[i];
  __syncthreads();
  const ge::Game g = ge::game_view(smem);
  int32_t* words = smem + game_len;
  const int R = T / G;  // rollouts a block
  const int64_t x0 = (int64_t)blockIdx.x * R;
  ge::rooms_load(g, ms, words, T, G, R, B, req, n_req, s.rollouts, x0, tid, T);
  __syncthreads();
  const int lane = tid & (G - 1), first = (tid & 31) & ~(G - 1);
  const int64_t x = x0 + tid / G;
  if (ge::search_source(g, req, n_req, s.rollouts, B, x) >= 0) {  // whole groups agree
    const uint32_t mask = (G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u) << first;
    const int32_t* q = req + (x / s.rollouts) * ge::REQ_INTS;
    ge::Room r = ge::room_open(g, ms, words + (tid - lane), T, lane, mask, first, q[0], B);
    r.seed = ge::search_seed((uint32_t)q[3], r.t, (int)(x % s.rollouts));
    const int32_t score = ge::room_search_rollout(g, r, q[1], q[2], s);
    if (lane == 0 && score != 0)
      atomicAdd(totals + x / s.rollouts, (unsigned long long)(long long)score);
  }
}

}  // namespace

extern "C" {

const char* ge_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// room_step.cuh size_report: how a block of the game (a host array) is sized.
void ge_size(const int32_t* game_host, int game_len, int threads, int64_t* out) {
  ge::size_report(game_host, game_len, threads, out);
}

// How a launch over n_rollouts rollouts of the game (a host array) would be
// sized when `threads` lanes a block are asked for: out = {lanes a rollout's
// room, dynamic shared memory bytes a block, blocks one SM holds at a time,
// lanes a block}. Returns a CUDA error code (0 = ok).
int ge_search_plan(const int32_t* game_host, int game_len, int64_t n_rollouts, int threads,
                   int64_t* out) {
  const ge::Game g = ge::game_view(game_host);
  if (!ge::launchable(g, game_len, n_rollouts, threads)) return (int)cudaErrorInvalidValue;
  const ge::Plan p = ge::plan((const void*)ge_search_kernel, g, game_len, n_rollouts, threads);
  out[0] = p.G; out[1] = (int64_t)p.smem; out[2] = p.held; out[3] = p.threads;
  return (int)p.err;
}

// Launches the search on `stream`: n_req requests (int32 rows of REQ_INTS on
// the device) over the B source rooms in the rollout kernel's minor layout;
// totals (n_req int64 on the device, zeroed by the caller) receive each
// request's sum of rollout scores. `game` is the game array on the device and
// `game_host` the same array on the host, from which the launch is sized;
// team_codes (n_codes int32) is on the device. Returns cudaGetLastError()
// after the launch (0 = launched).
int ge_search(const int32_t* game, const int32_t* game_host, int game_len,
              int32_t* bools, int32_t* nums, int32_t* strs, int32_t* pdict, int32_t* odict,
              int32_t* present, int32_t* regs, int32_t* scal, int64_t B, const int32_t* req,
              int64_t n_req, int rollouts, int horizon, int mode, int team_slot,
              const int32_t* team_codes, int n_codes, int64_t* totals, int threads,
              void* stream) {
  const ge::Game g = ge::game_view(game_host);
  const ge::SearchSpec s{rollouts, horizon, mode, team_slot, n_codes, team_codes};
  const int64_t N = n_req * (int64_t)rollouts;
  if (!ge::search_spec_ok(g, s) || B <= 0 || !ge::launchable(g, game_len, N, threads))
    return (int)cudaErrorInvalidValue;
  const ge::Plan p = ge::plan((const void*)ge_search_kernel, g, game_len, N, threads);
  if (p.err != cudaSuccess) return (int)p.err;
  const int R = p.threads / p.G;
  const int64_t blocks = (N + R - 1) / R;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  ge_search_kernel<<<(unsigned)blocks, p.threads, p.smem, (cudaStream_t)stream>>>(
      game, game_len, ms, B, req, n_req, s, (unsigned long long*)totals, p.G);
  return (int)cudaGetLastError();
}

}  // extern "C"
