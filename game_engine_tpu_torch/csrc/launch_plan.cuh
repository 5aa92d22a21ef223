// launch_plan.cuh — how a launch of a room kernel is sized: the rollout
// kernel (csrc/rollout.cu, K1: a room a group) and the search kernel
// (csrc/search.cu, S: a rollout a group, on a persistent grid). Host code
// only; the kernel to size is a parameter, so both share one block plan.
#pragma once

#include <cuda_runtime.h>

#include "room_step.cuh"

namespace ge {

// What a launch over n rooms is sized to when `threads` lanes a block are
// asked for.
struct Plan {
  int threads;  // lanes a block: the largest halving of the asked that fits
  int G;        // lanes a room
  size_t smem;  // dynamic shared memory a block
  int held;     // blocks one SM holds at a time
  cudaError_t err;
};

// A room gets at least a lane a seat, a warp past 32 seats. While every
// room would still hold a warp slot of the card at once, its group is
// doubled and the spare lanes idle: a warp of fewer rooms runs fewer phases one after another, and a
// call of few rooms is bound by that latency, not by lanes.
// `staged`: the block also stages its rooms (ST, st_shared_bytes), sized
// for the most rooms a block can have while the group is chosen, then for
// the group's. The kernel's shared-memory limit is raised to the most a
// block can have, not to this plan's bytes, so that a later plan (another
// batch or game) never lowers it under the blocks of one a caller cached.
inline Plan plan(const void* kernel, const Game& g, int game_len, int64_t n, int threads,
                 bool staged = false) {
  Plan p{fit_threads(g, game_len, threads, staged), group_lanes(g.P), 0, 0, cudaSuccess};
  if (p.threads == 0) {  // not even one warp's rooms fit
    p.err = cudaErrorInvalidValue;
    return p;
  }
  threads = p.threads;
  p.smem = (size_t)block_bytes(g, game_len, threads, staged);
  if (p.smem > 48 * 1024)
    p.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)MAX_SHARED);
  int dev = 0, sms = 0;
  if (p.err == cudaSuccess) p.err = cudaGetDevice(&dev);
  if (p.err == cudaSuccess)
    p.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (p.err == cudaSuccess)
    p.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.held, kernel, threads, p.smem);
  if (p.err != cudaSuccess) return p;
  const int64_t warp_slots = (int64_t)sms * p.held * (threads / 32);
  while (p.G < MAX_GROUP && n * (2 * p.G) / 32 <= warp_slots) p.G *= 2;
  if (staged && p.G > group_lanes(g.P)) {  // fewer rooms a block: less staging
    p.smem = (size_t)st_shared_bytes(g, game_len, threads, p.G);
    p.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.held, kernel, threads, p.smem);
  }
  return p;
}

// The search kernel's (csrc/search.cu, S) persistent grid over n rollouts:
// plan's block and lanes (`lanes` instead when asked), on as many blocks as
// the card holds at once, and no more than n rollouts need at those lanes.
struct Grid {
  Plan p;
  int64_t blocks;
};

inline Grid persistent_grid(const void* kernel, const Game& g, int game_len, int64_t n,
                            int threads, int lanes) {
  Grid out{plan(kernel, g, game_len, n, threads), 0};
  Plan& p = out.p;
  int dev = 0, sms = 0;
  if (p.err == cudaSuccess) p.err = cudaGetDevice(&dev);
  if (p.err == cudaSuccess)
    p.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (p.err != cudaSuccess) return out;
  if (p.held < 1) {
    p.err = cudaErrorInvalidConfiguration;
    return out;
  }
  if (lanes) p.G = lanes;
  const int64_t resident = (int64_t)sms * p.held, need = (n * p.G + p.threads - 1) / p.threads;
  out.blocks = need < resident ? need : resident;
  return out;
}

// Whether a launch over n rooms of lanes `threads` a block may be asked for.
inline bool launchable(const Game& g, int game_len, int64_t n, int threads) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0 && n > 0 && game_len > 0 &&
         g.P >= 1 && g.P <= MAX_SEATS;
}

}  // namespace ge
