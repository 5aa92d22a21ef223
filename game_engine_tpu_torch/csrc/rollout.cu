// rollout.cu — the batched engine rollout as one CUDA kernel (sm_90a).
//
// Replaces the TPU kernel game_engine_tpu/core/pallas_rollout.py
// ::make_pallas_rollout (K1): num_steps full engine steps (scripted bots,
// P1/P2 acceptance, record writes, P3 completion, P5 first-match branch,
// on-enter effect IR, fresh-completion count, auto-reset) with the room
// state held on chip for the whole call, one global-memory round trip per
// call. Bit-identical to the plain-torch rollout (core/engine.make_rollout).
//
// What bounds it on the H100: integer ALU and control flow, not HBM. A
// werewolf room is 191 int32 (about 764 B) read once and written once per
// call, while every step runs thousands of integer ops per room through a
// data-dependent interpreter (predicate DNF, branch first-match, an effect
// DAG). Rooms in different phases take different branches, so a warp
// diverges; the per-room arrays (Room, the IR node values) are indexed at
// run time and live in local memory, so they spill through L1/L2.
//
// What the design does about it: one thread per room, so divergence costs
// only when the rooms of a warp sit in different phases, and no
// synchronisation is needed between rooms; the ragged edge is masked, so
// any batch size works. The global state stays in the (bank, P, rooms)
// layout, so the load and the store of one field by 32 consecutive rooms is
// one coalesced 128-byte access. The game's tables (the pack.py blob, about
// 5.7 KB for werewolf) are copied into shared memory once per block: every
// table read in the interpreter is a shared-memory read, and one build
// serves every game. All num_steps steps run in a loop inside the kernel.

#include <cuda_runtime.h>

#include "room_step.cuh"

__global__ void ge_rollout_kernel(const int32_t* __restrict__ game, int game_len,
                                  ge::MinorState ms, int32_t* __restrict__ eps,
                                  int64_t B, int num_steps, int auto_reset) {
  extern __shared__ int32_t sgame[];
  for (int i = threadIdx.x; i < game_len; i += blockDim.x) sgame[i] = game[i];
  __syncthreads();
  const int64_t room = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (room >= B) return;
  const ge::Game g = ge::game_view(sgame);
  ge::Room r;
  ge::room_load(g, r, ms, room, B);
  eps[room] = ge::room_rollout(g, r, num_steps, auto_reset);
  ge::room_store(g, r, ms, room, B);
}

extern "C" {

void ge_limits(int32_t* out) { ge::limits(out); }

const char* ge_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the rollout on `stream` over B rooms, in place on the minor-layout
// buffers; eps receives each room's completed episodes. Returns
// cudaGetLastError() after the launch (0 = launched).
int ge_rollout(const int32_t* game, int game_len, int32_t* bools, int32_t* nums,
               int32_t* strs, int32_t* pdict, int32_t* odict, int32_t* present,
               int32_t* regs, int32_t* scal, int32_t* eps, int64_t B,
               int num_steps, int auto_reset, int threads, void* stream) {
  if (threads <= 0 || threads > 1024 || B <= 0 || game_len <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)game_len * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ge_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  const int64_t blocks = (B + threads - 1) / threads;
  ge_rollout_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      game, game_len, ms, eps, B, num_steps, auto_reset);
  return (int)cudaGetLastError();
}

}  // extern "C"
