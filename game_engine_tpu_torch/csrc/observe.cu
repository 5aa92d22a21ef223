// observe.cu — OB, the observation entry, and SA, the sampling entry (sm_90a).
//
// The port's counterparts of the eager remainder of the JAX package's jitted
// unroll body (game_engine_tpu/train/ppo.py make_unroll), which XLA fuses
// around the policy-forward pallas_call (K2): observe, legal_action_mask and
// actor_mask before K2, the categorical draw and log-softmax of
// sample_actions and the actor-masked actions after it, and
// terminal_rewards after the engine step. No pallas_call site of the JAX
// package computes them; on the card they were ~190 eager torch launches a
// step. csrc/observe.cuh holds the per-room bodies, which
// csrc/observe_host.cpp builds with g++ for the CPU tests.
//
// ob_observe: one launch writes the (B, P, F) bf16 observation (masked or
// full view), the (B, P, A) legal mask and the (B, P) actor mask of B rooms
// of GameState's own tensors; blocks of R rooms (ob_plan), 256 threads, the
// block body observe.cuh's ob_block.
// ob_rewards: the (B, P) f32 terminal rewards of the rooms a step ended, a
// seat a thread.
//
// ob_sample: SA, the Gumbel-max draw of sample_actions with its log-softmax
// and the actor-masked actions. It replaces no pallas_call: its counterpart
// is XLA's fusion of the draw in the JAX package's sample_actions
// (game_engine_tpu/policies/net.py:440). By its bytes (a row's logits,
// legal bytes and noise read once, three outputs written) it would be
// bound by bytes; what holds it is latency: a row's loads have to be in
// flight together, and its choices' logf chains (the Gumbel transform,
// the library's logf and not the fast intrinsic, so that the draw is
// torch's bit for bit) have to interleave. So a row is a group of G lanes, each holding 8 contiguous
// choices whose loads it issues before it uses any (two 16-byte loads of
// each f32 input where aligned) and whose steps are straight-line code; G
// covers the row (one lane at werewolf's 8 choices, 16 at 72 seats), and
// a group's max, sum and first argmax are warp-shuffle butterflies and a
// ballot. The mode is a template argument. A lane a choice (8 lanes a
// row, every step a 3-step butterfly) measured 2.1x the time of the
// earlier row-a-thread loop at 65,536 rooms, and 2 lanes of 4 choices
// 1.6x (NVIDIA H100 80GB HBM3, 700.00 W). It needs no shared memory (staging a block's rows there by
// cp.async was slower) and no tensor cores: no byte is read twice and
// nothing is a product.
//
// Every entry launches on the caller's stream and returns cudaGetLastError()
// after the launch; bad sizes are refused with cudaErrorInvalidValue before
// it. Nothing here waits for the card.

#include <cuda_runtime.h>

#include "observe.cuh"

namespace {

constexpr int OB_THREADS = 256;
constexpr int OB_MIN_BLOCKS = 4;  // registers for 4 blocks an SM: 32 warps
constexpr int SEAT_THREADS = 256;
constexpr int SA_THREADS = 256;

__global__ void __launch_bounds__(OB_THREADS, OB_MIN_BLOCKS)
    ob_observe_kernel(ob::ObLaunch l, const int32_t* __restrict__ game,
                      const int32_t* __restrict__ table, ge::BatchState s,
                      uint16_t* __restrict__ obs, uint8_t* __restrict__ legal,
                      uint8_t* __restrict__ actor, int64_t B, int masked, long long* prof) {
  extern __shared__ int4 smem[];
  ob::ob_block(l, game, table, s, obs, legal, actor, B, (int64_t)blockIdx.x * l.R, masked != 0,
               smem, threadIdx.x, blockDim.x, prof);
}

// -DGE_PROFILE: OB's launches add their block sections' cycles here
// (ob_observe_sections); null otherwise
long long* ob_prof = nullptr;

__global__ void ob_rewards_kernel(const int32_t* __restrict__ table, ge::BatchState s,
                                  const uint8_t* __restrict__ ended, float* __restrict__ reward,
                                  int64_t B) {
  const ob::Table x = ob::table_view(table);
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= B * x.P) return;
  const int64_t i = k / x.P;
  const int p = (int)(k % x.P);
  const int n = x.rw_mode == ge::RW_SCORE ? ob::count_present(x, s, i) : 0;
  reward[k] = ob::reward_of(x, s, ended, i, p, n);
}

// a group's butterfly over G lanes (`mask`): offsets G/2 ... 1, each lane
// op(its own, the other lane's)
template <int G, class Op>
__device__ __forceinline__ float group_fold(unsigned mask, float v, Op op) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(mask, v, o, G));
  return v;
}

// The group's draw: the max of the lanes' values, taken from the first lane
// that holds it (its choices come first; the group's first lane where none
// does, as with NaN), and whether any lane met a legal choice.
template <int G>
__device__ __forceinline__ ob::SaBest group_draw(unsigned mask, const ob::SaBest& b) {
  if (G == 1) return b;
  const float x = group_fold<G>(mask, b.x, ob::SaMax());
  const unsigned hit = __ballot_sync(mask, b.x == x) & mask;
  const int src = __ffs(hit ? hit : mask) - 1;
  return ob::SaBest{x, __shfl_sync(mask, b.m, src), __shfl_sync(mask, b.i, src),
                    (__ballot_sync(mask, b.any) & mask) != 0};
}

// SA: a row a group of G lanes in MODE (observe.cuh sa_widths); a group
// past the rows leaves whole, so every exchange's group is whole.
template <int G, int MODE>
__global__ void __launch_bounds__(SA_THREADS)
    ob_sample_kernel(const float* __restrict__ logits, const uint8_t* __restrict__ legal,
                     const float* __restrict__ noise, const uint8_t* __restrict__ actor,
                     int32_t* __restrict__ actions, int32_t* __restrict__ masked,
                     float* __restrict__ logp, int64_t rows, int A, bool vec) {
  const int64_t t = (int64_t)blockIdx.x * SA_THREADS + threadIdx.x;
  const int64_t row = t / G;
  if (row >= rows) return;
  const int lane = (int)(threadIdx.x % G);
  const unsigned mask = (0xffffffffu >> (32 - G)) << ((threadIdx.x % 32) & ~(unsigned)(G - 1));
  const int64_t at = row * A;
  const float* z = MODE == ob::SA_GREEDY ? nullptr : noise + at;
  const bool acting = actor == nullptr || actor[row] != 0;
  ob::SaBest best = ob::sa_none();
  float M = 0.0f, S = 0.0f;
  for (int c0 = 0; c0 < A; c0 += G * ob::SA_SPAN) {
    float m[ob::SA_SPAN], mx;
    const ob::SaBest b =
        ob::sa_load<MODE>(logits + at, legal + at, z, A, c0, lane, vec, m, mx);
    const float cm = group_fold<G>(mask, mx, ob::SaMax());
    const float cs = group_fold<G>(mask, ob::sa_exp_sum(m, cm), ob::SaAdd());
    ob::sa_fold(M, S, cm, cs, c0 == 0);
    best = ob::sa_pick(best, group_draw<G>(mask, b));
  }
  if (lane == 0) ob::sa_write<MODE>(best, M, S, acting, actions, masked, logp, row);
}

int64_t blocks_of(int64_t n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

extern "C" {

const char* ob_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// How an OB launch over B rooms of the game is sized on the current card
// (game and table on the host): R rooms a block, the fewest that let one
// wave of blocks hold the launch (every block resident at once, the SMs'
// warp slots filled as far as B allows) and at most MAX_ROOMS, so a large B
// runs in several waves of small blocks rather than in one and a tail.
// out = {R, shared bytes a block, blocks an SM holds, blocks}. The caller
// asks once per game, batch and card and passes {out[0], out[1]} to every
// launch. The kernel's shared-memory limit is raised to the most a block
// can have, not to this plan's bytes, so that a later plan (another batch
// or game) never lowers it under the blocks of one cached before. Returns a
// CUDA error code (0 = ok).
int ob_plan(const int32_t* game_host, const int32_t* table_host, int table_len, int64_t B,
            int64_t* out) {
  if (B <= 0 || !ob::table_ok(table_host, table_len, ge::game_view(game_host)))
    return (int)cudaErrorInvalidValue;
  auto bytes = [&](int R) {
    return (int64_t)ob::ob_launch(game_host, table_host, table_len, R).bytes;
  };
  auto held = [&](int R, int* n) {
    const int64_t smem = bytes(R);
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(ob_observe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ge::MAX_SHARED);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, ob_observe_kernel, OB_THREADS,
                                                        (size_t)smem);
    return e;
  };
  int R = ob::MAX_ROOMS;
  while (R > 1 && bytes(R) > ge::MAX_SHARED) --R;
  if (bytes(R) > ge::MAX_SHARED) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, n = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int pass = 0; pass < 2 && e == cudaSuccess; ++pass) {  // fewer rooms, more blocks held
    e = held(R, &n);
    if (e == cudaSuccess && n < 1) e = cudaErrorInvalidConfiguration;
    if (e != cudaSuccess) break;
    const int64_t slots = (int64_t)sms * n, want = (B + slots - 1) / slots;
    if (want >= R) break;
    R = (int)(want < 1 ? 1 : want);
  }
  if (e == cudaSuccess) e = held(R, &n);
  if (e != cudaSuccess) return (int)e;
  out[0] = R; out[1] = bytes(R); out[2] = n; out[3] = (B + R - 1) / R;
  return 0;
}

// OB over B rooms: `game` the game blob and `table` ob_table's ints on the
// card and on the host; `state` the addresses of GameState's 15 tensors;
// obs (B, P, F) bf16 (16-byte aligned), legal (B, P, A) and actor (B, P)
// bool, any of them null to skip it; masked: the game's information rules
// (1) or the full room (0); R rooms a block and smem bytes a block:
// ob_plan's, refused when they do not fit the table.
int ob_observe(const int32_t* game, const int32_t* game_host, const int32_t* table,
               const int32_t* table_host, int table_len, const int64_t* state, uint16_t* obs,
               uint8_t* legal, uint8_t* actor, int64_t B, int masked, int R, int64_t smem,
               void* stream) {
  if (B <= 0 || R < 1 || R > ob::MAX_ROOMS ||
      !ob::table_ok(table_host, table_len, ge::game_view(game_host)))
    return (int)cudaErrorInvalidValue;
  const ob::ObLaunch l = ob::ob_launch(game_host, table_host, table_len, R);
  if (smem != l.bytes || smem > ge::MAX_SHARED || ((uintptr_t)obs & 15))
    return (int)cudaErrorInvalidValue;
  ob_observe_kernel<<<(unsigned)blocks_of(B, R), OB_THREADS, (size_t)smem,
                      (cudaStream_t)stream>>>(l, game, table, ge::batch_state(state), obs, legal,
                                              actor, B, masked, ob_prof);
  return (int)cudaGetLastError();
}

#ifdef GE_PROFILE
// OB's launches from now on add their block sections' clock64() cycles to
// prof (OB_SECTIONS int64 on the device, zeroed by the caller); null stops.
void ob_observe_sections(long long* prof) { ob_prof = prof; }
#endif

// OB's second mode: reward (B, P) f32 of the rooms `ended` (B,) bool marks,
// from the state after the step (before the reset).
int ob_rewards(const int32_t* table, const int32_t* table_host, int table_len,
               const int64_t* state, const uint8_t* ended, float* reward, int64_t B,
               void* stream) {
  if (B <= 0 || table_len < ob::HDR || table_host[ob::T_LEN] != table_len)
    return (int)cudaErrorInvalidValue;
  const int P = table_host[ob::T_P];
  ob_rewards_kernel<<<(unsigned)blocks_of(B * P, SEAT_THREADS), SEAT_THREADS, 0,
                      (cudaStream_t)stream>>>(table, ge::batch_state(state), ended, reward, B);
  return (int)cudaGetLastError();
}

// SA over `rows` rows of A choices: logits f32, legal bool, noise f32 (mode
// SA_UNIFORM: uniforms; SA_GUMBEL: Gumbel noise; SA_GREEDY: null), actor
// bool or null; out: actions and masked int32, logp f32 (any may be null).
// One launch of ceil(rows * G / 256) blocks of 256 threads, G lanes a row
// (sa_widths).
int ob_sample(const float* logits, const uint8_t* legal, const float* noise,
              const uint8_t* actor, int32_t* actions, int32_t* masked, float* logp,
              int64_t rows, int A, int mode, void* stream) {
  if (rows <= 0 || A < 1 || mode < ob::SA_UNIFORM || mode > ob::SA_GREEDY ||
      (mode != ob::SA_GREEDY && noise == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = ob::sa_vec(A, logits, legal, noise);
  ob::sa_widths(A, mode, [&](auto g, auto m) {
    constexpr int G = decltype(g)::value, MODE = decltype(m)::value;
    ob_sample_kernel<G, MODE><<<(unsigned)blocks_of(rows * G, SA_THREADS), SA_THREADS, 0,
                                (cudaStream_t)stream>>>(logits, legal, noise, actor, actions,
                                                        masked, logp, rows, A, vec);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
