// search.cu — the lookahead search bots' rollouts and decisions as CUDA
// kernels (sm_90a).
//
// Counterpart of native/gamesim.cpp gs_room_search and gs_room_search_scores
// (search_scores_core), the C++ host code behind the JAX package's search
// bots (policies/search.py): for a deciding seat p of a room, every candidate
// c is scored by the total over k < rollouts of one rollout's terminal score,
// where rollout k copies the room, reseeds it from (salt, the room's step, k),
// forces p's first action to c and runs scripted bots and the engine step
// until the room is done or `horizon` steps have passed; the seat takes the
// first strictly greatest total in ascending candidate order. The totals are
// exact integer sums, so neither the order of the rollouts nor that of the
// atomics can change them, and the decisions equal the C++ search's bit for
// bit.
//
// Two entries run the same rollouts. ge_search_decide makes the
// full-information decisions (D = 0) of a batch of rooms in one cooperative
// launch: (1) a group of lanes a room finds each seat's candidates
// (room_step.cuh seat_candidates: the C++ rules of no decision, forced submit
// and one candidate) and claims a run of rollouts for each seat with a
// choice, (2) the grid runs them, (3) a thread a decision takes the argmax,
// with grid.sync() between the stages: the count of rollouts never leaves
// the card.
// ge_search scores a request table built on the host (the determinized tier,
// D > 0: its worlds are sampled there) into one total a request.
//
// What bounds it: as for the rollout kernel (csrc/rollout.cu), the serial
// latency of a room's step through the table interpreter. So a rollout is a
// room on a group of G lanes, a seat a lane (a warp, seats lane, lane + 32,
// ... past 32 seats, in the kernels' MAX_SEAT_WORDS build), its words in
// dynamic shared memory sized to the game behind the game's tables
// (room_step.cuh). A
// rollout's length varies from a few steps to the horizon, so the grid is
// persistent: as many blocks as the card holds at once, whose groups pull
// their next rollout from a device counter (one atomicAdd by the group's
// first lane, broadcast over the group), load its source room into their own
// words (room_fetch) and add its score into its total with one 64-bit
// atomic. A group that finishes early starts new work at once: no block holds
// its SM slot for its longest rollout, and the launch ends in no tail of
// waves. G widens while the rollouts would all still hold a warp slot at the
// wider groups (room_step.cuh widen_lanes, the rollout kernel's rule); the
// decide entry chooses it on the card once it knows the count. Measured on
// an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md): the groups are busy
// 93-99% of a launch of 512-4096 decisions, yet the launch is only 0-13%
// shorter than on a grid of fixed blocks, so what remains is the chain of a
// room's step itself.
//
// -DGE_PROFILE builds the variant whose groups also sum, by the card's global
// timer, the time they spend in rollouts and the span from their first pull
// to their exit (the share of lanes busy); the bots never load it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch_plan.cuh"
#include "room_step.cuh"

namespace cg = cooperative_groups;

namespace {

// The group of G lanes of this thread's warp.
struct Lanes {
  int lane, first;
  uint32_t mask;
};

__device__ inline Lanes lanes_of(int tid, int G) {
  const int first = (tid & 31) & ~(G - 1);
  return {tid & (G - 1), first, (G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u) << first};
}

#ifdef GE_PROFILE
__device__ inline unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// Runs flat rollouts [0, n) pulled one at a time from `counter` (zeroed
// before the launch) on the group's lanes until it passes n; run(x, &slot)
// runs rollout x and returns its score, whose total is totals[slot]. prof
// (the GE_PROFILE build): {ns in rollouts, first pull, last exit, groups,
// rollouts}, summed over the groups.
template <class Run>
__device__ void pull_rollouts(unsigned long long* counter, int64_t n, const Lanes& l,
                              int64_t* totals, long long* prof, Run run) {
#ifdef GE_PROFILE
  const unsigned long long t_in = global_ns();
  long long busy = 0, runs = 0;
#endif
  for (;;) {
    unsigned long long x = 0;
    if (l.lane == 0) x = atomicAdd(counter, 1ull);
    x = __shfl_sync(l.mask, x, l.first);
    if ((int64_t)x >= n) break;
#ifdef GE_PROFILE
    const unsigned long long t0 = global_ns();
#endif
    int64_t slot = -1;
    const int32_t score = run((int64_t)x, &slot);
    if (l.lane == 0 && score != 0)
      atomicAdd((unsigned long long*)totals + slot, (unsigned long long)(long long)score);
#ifdef GE_PROFILE
    busy += (long long)(global_ns() - t0);
    runs += 1;
#endif
  }
#ifdef GE_PROFILE
  if (l.lane == 0) {
    const unsigned long long t_out = global_ns();
    atomicAdd((unsigned long long*)prof, (unsigned long long)busy);
    atomicMin((unsigned long long*)prof + 1, t_in);
    atomicMax((unsigned long long*)prof + 2, t_out);
    atomicAdd((unsigned long long*)prof + 3, 1ull);
    atomicAdd((unsigned long long*)prof + 4, (unsigned long long)runs);
  }
#else
  (void)prof;
#endif
}

// The game's tables into the block's shared memory; returns the view.
__device__ inline ge::Game load_game(int32_t* smem, const int32_t* __restrict__ game,
                                     int game_len) {
  for (int i = threadIdx.x; i < game_len; i += blockDim.x) smem[i] = game[i];
  __syncthreads();
  return ge::game_view(smem);
}

// The request table's rollouts: rollout x is rollout x % rollouts of request
// x / rollouts; a request out of range scores 0. NW: words of a seat set.
template <int NW>
__global__ void ge_search_kernel(const int32_t* __restrict__ game, int game_len,
                                 ge::MinorState ms, int64_t B, const int32_t* __restrict__ req,
                                 int64_t n_req, ge::SearchSpec s, int64_t* __restrict__ totals,
                                 unsigned long long* counter, int G, long long* prof) {
  extern __shared__ int32_t smem[];
  const ge::Game g = load_game(smem, game, game_len);
  const int tid = threadIdx.x, T = blockDim.x, K = NW == 1 ? 1 : g.SW;
  const Lanes l = lanes_of(tid, G);
  int32_t* w = smem + game_len + (tid - l.lane) * K;
  pull_rollouts(counter, n_req * s.rollouts, l, totals, prof, [&](int64_t x, int64_t* slot) {
    const int32_t* q = req + (x / s.rollouts) * ge::REQ_INTS;
    if (!ge::search_request_ok(g, q, B)) return 0;  // the same in the whole group
    ge::Room<NW> r = ge::room_fetch<NW>(g, ms, w, T * K, l.lane, l.mask, l.first, q[0], B);
    r.seed = ge::search_seed((uint32_t)q[3], r.t, (int)(x % s.rollouts));
    *slot = x / s.rollouts;
    return (int)ge::room_search_rollout(g, r, q[1], q[2], s);
  });
}

// 1. A room a group of the fewest lanes, the rooms strided over the grid.
template <int NW>
__device__ void decide_rooms(const ge::Game& g, const ge::MinorState& ms, int64_t B,
                             const ge::DecideTable& tab, int rollouts, int32_t* actions,
                             int32_t* words) {
  const int tid = threadIdx.x, T = blockDim.x, G = ge::group_lanes(g.P);
  const int K = NW == 1 ? 1 : g.SW;
  const Lanes l = lanes_of(tid, G);
  const int64_t groups = (int64_t)gridDim.x * (T / G);
  for (int64_t i = (int64_t)blockIdx.x * (T / G) + tid / G; i < B; i += groups)
    ge::decide_room<NW>(g, ms, B, tab, rollouts, actions, words + (tid - l.lane) * K, T * K,
                        l.lane, l.mask, l.first, i);
}

// 2. The claimed rollouts, pulled by groups of G lanes (widen_lanes over the
// grid's warp slots unless `lanes` asks).
template <int NW>
__device__ void decide_rollouts(const ge::Game& g, const ge::MinorState& ms, int64_t B,
                                const ge::DecideTable& tab, const ge::SearchSpec& s,
                                uint32_t salt, int32_t* words, unsigned long long* counter,
                                int lanes, long long* prof) {
  const int tid = threadIdx.x, T = blockDim.x;
  const unsigned long long claim = *(volatile unsigned long long*)tab.claim;
  const int64_t n = (int64_t)(claim & ge::CLAIM_ROLLOUTS);
  const int64_t entries = (int64_t)(claim >> ge::CLAIM_SHIFT);
  if (blockIdx.x == 0 && tid == 0) tab.stats[2] = (unsigned long long)n;
  const int G = lanes ? lanes : ge::widen_lanes(g.P, n, (int64_t)gridDim.x * (T / 32));
  const int K = NW == 1 ? 1 : g.SW;
  const Lanes l = lanes_of(tid, G);
  int32_t* w = words + (tid - l.lane) * K;
  pull_rollouts(counter, n, l, tab.totals, prof, [&](int64_t x, int64_t* slot) {
    return ge::decide_rollout<NW>(g, ms, B, tab, entries, s, salt, x, w, T * K, l.lane, l.mask,
                                  l.first, slot);
  });
}

// 3. A decision a thread: the argmax.
template <int NW>
__device__ void decide_argmaxes(const ge::Game& g, const ge::MinorState& ms, int64_t B,
                                const ge::DecideTable& tab, int32_t* actions) {
  const int64_t n_dec = B * g.P, T = blockDim.x;
  for (int64_t d = blockIdx.x * T + threadIdx.x; d < n_dec; d += (int64_t)gridDim.x * T)
    ge::decide_argmax<NW>(g, ms, tab, actions, d);
}

// The full-information decisions of B rooms in one cooperative launch
// (stages in the file's head), grid.sync() between the stages. actions: (B,
// P) int32, 0 where a seat has no decision; tab's totals, claim and stats
// and the counter zeroed before the launch.
template <int NW>
__global__ void ge_decide_kernel(const int32_t* __restrict__ game, int game_len,
                                 ge::MinorState ms, int64_t B, ge::SearchSpec s, uint32_t salt,
                                 ge::DecideTable tab, int32_t* __restrict__ actions,
                                 unsigned long long* counter, int lanes, long long* prof) {
  extern __shared__ int32_t smem[];
  const ge::Game g = load_game(smem, game, game_len);
  cg::grid_group grid = cg::this_grid();
  int32_t* words = smem + game_len;
  decide_rooms<NW>(g, ms, B, tab, s.rollouts, actions, words);
  grid.sync();
  decide_rollouts<NW>(g, ms, B, tab, s, salt, words, counter, lanes, prof);
  grid.sync();
  decide_argmaxes<NW>(g, ms, B, tab, actions);
}

// the builds of the two kernels for the game's seats
const void* search_kernel_for(const ge::Game& g) {
  return g.P <= 32 ? (const void*)ge_search_kernel<1>
                   : (const void*)ge_search_kernel<ge::MAX_SEAT_WORDS>;
}
const void* decide_kernel_for(const ge::Game& g) {
  return g.P <= 32 ? (const void*)ge_decide_kernel<1>
                   : (const void*)ge_decide_kernel<ge::MAX_SEAT_WORDS>;
}

// int64 words of the decide entry's scratch: counter, stats[3], claim,
// totals[B * P * C], starts[B * P], decision[B * P], then int32 cnt[B * P]
// and alive[B * SW]; the first 5 + B * P * C are zeroed each call.
int64_t decide_scratch(int64_t B, int P, int C) {
  return 5 + B * P * (int64_t)C + 2 * B * P + (B * P + B * ge::seat_words(P) + 1) / 2;
}

bool lanes_ok(const ge::Game& g, int lanes) {
  return lanes == 0 ||
         (lanes >= ge::group_lanes(g.P) && lanes <= ge::MAX_GROUP && (lanes & (lanes - 1)) == 0);
}

}  // namespace

extern "C" {

const char* ge_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// room_step.cuh size_report: how a block of the game (a host array) is sized.
void ge_size(const int32_t* game_host, int game_len, int threads, int64_t* out) {
  ge::size_report(game_host, game_len, threads, out);
}

// int64 words of ge_search_decide's scratch for B rooms of P seats and C
// candidates a seat.
int64_t ge_decide_scratch(int64_t B, int P, int C) { return decide_scratch(B, P, C); }

// How ge_search's grid over n_rollouts rollouts of the game (a host array)
// would be sized when `threads` lanes a block are asked for: out = {lanes a
// rollout, dynamic shared memory bytes a block, blocks one SM holds at a
// time, lanes a block, blocks of the grid}. Returns a CUDA error code (0 =
// ok).
int ge_search_plan(const int32_t* game_host, int game_len, int64_t n_rollouts, int threads,
                   int64_t* out) {
  const ge::Game g = ge::game_view(game_host);
  if (!ge::launchable(g, game_len, n_rollouts, threads)) return (int)cudaErrorInvalidValue;
  const ge::Grid p =
      ge::persistent_grid(search_kernel_for(g), g, game_len, n_rollouts, threads, 0);
  out[0] = p.p.G; out[1] = (int64_t)p.p.smem; out[2] = p.p.held; out[3] = p.p.threads;
  out[4] = p.blocks;
  return (int)p.p.err;
}

// Launches the request table's rollouts on `stream`: n_req requests (int32
// rows of REQ_INTS on the device) over the B source rooms in the rollout
// kernel's minor layout; totals (n_req int64 on the device, zeroed by the
// caller) receive each request's sum of rollout scores. `game` is the game
// array on the device and `game_host` the same array on the host, from which
// the launch is sized; team_codes (n_codes int32) is on the device; counter
// is one int64 of device scratch, zeroed here on the stream; prof (the
// GE_PROFILE build) 5 int64 on the device, {0, max, 0, 0, 0} before. Returns
// the CUDA error of the launch (0 = launched).
int ge_search(const int32_t* game, const int32_t* game_host, int game_len, int32_t* bools,
              int32_t* nums, int32_t* strs, int32_t* pdict, int32_t* odict, int32_t* present,
              int32_t* regs, int32_t* scal, int64_t B, const int32_t* req, int64_t n_req,
              int rollouts, int horizon, int mode, int team_slot, const int32_t* team_codes,
              int n_codes, int64_t* totals, int64_t* counter, int threads, long long* prof,
              void* stream) {
  const ge::Game g = ge::game_view(game_host);
  const ge::SearchSpec s{rollouts, horizon, mode, team_slot, n_codes, team_codes};
  const int64_t N = n_req * (int64_t)rollouts;
  if (!ge::search_spec_ok(g, s) || B <= 0 || !ge::launchable(g, game_len, N, threads))
    return (int)cudaErrorInvalidValue;
  const ge::Grid p = ge::persistent_grid(search_kernel_for(g), g, game_len, N, threads, 0);
  if (p.p.err != cudaSuccess) return (int)p.p.err;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int64_t), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  const dim3 grid((unsigned)p.blocks);
  if (g.P <= 32)
    ge_search_kernel<1><<<grid, p.p.threads, p.p.smem, (cudaStream_t)stream>>>(
        game, game_len, ms, B, req, n_req, s, totals, (unsigned long long*)counter, p.p.G, prof);
  else
    ge_search_kernel<ge::MAX_SEAT_WORDS><<<grid, p.p.threads, p.p.smem, (cudaStream_t)stream>>>(
        game, game_len, ms, B, req, n_req, s, totals, (unsigned long long*)counter, p.p.G, prof);
  return (int)cudaGetLastError();
}

// Launches the full-information decisions of the B rooms (minor layout) on
// `stream`, one cooperative launch: actions (B * P int32 on the device)
// receive each seat's choice, 0 where it has none; scratch (ge_decide_scratch
// int64 on the device) receives the stats {waiting seats, candidates
// searched, rollouts} at [1, 4) and the totals at [5, 5 + B * P * C), C the
// most candidates a seat of the game can have; salt is the bots' (the base
// salt of room i is search_base(its seed, salt)). Sized and zeroed as
// ge_search; lanes: G for the rollouts, 0 = chosen on the card. Returns the
// CUDA error of the launch (0 = launched).
int ge_search_decide(const int32_t* game, const int32_t* game_host, int game_len,
                     int32_t* bools, int32_t* nums, int32_t* strs, int32_t* pdict,
                     int32_t* odict, int32_t* present, int32_t* regs, int32_t* scal, int64_t B,
                     int rollouts, int horizon, int mode, int team_slot,
                     const int32_t* team_codes, int n_codes, uint32_t salt, int C,
                     int32_t* actions, int64_t* scratch, int threads, int lanes,
                     long long* prof, void* stream) {
  const ge::Game g = ge::game_view(game_host);
  ge::SearchSpec s{rollouts, horizon, mode, team_slot, n_codes, team_codes};
  if (!ge::search_spec_ok(g, s) || B <= 0 || C < g.P || !lanes_ok(g, lanes) ||
      !ge::launchable(g, game_len, B * g.P, threads))
    return (int)cudaErrorInvalidValue;
  // at most as many blocks as the card holds, which a cooperative launch needs
  const int64_t most = B * g.P * (int64_t)C * rollouts;  // rollouts if every seat chose
  const ge::Grid p =
      ge::persistent_grid(decide_kernel_for(g), g, game_len, most, threads, lanes);
  if (p.p.err != cudaSuccess) return (int)p.p.err;
  const int64_t n_dec = B * g.P;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (5 + n_dec * C) * sizeof(int64_t),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  unsigned long long* counter = (unsigned long long*)scratch;
  int64_t* totals = scratch + 5;
  int32_t* ints = (int32_t*)(totals + n_dec * C + 2 * n_dec);
  ge::DecideTable tab{ints, ints + n_dec, totals, totals + n_dec * C, totals + n_dec * C + n_dec,
                      counter + 4, counter + 1, C};
  void* args[] = {&game, &game_len, &ms, &B, &s, &salt, &tab, &actions, &counter, &lanes,
                  &prof};
  err = cudaLaunchCooperativeKernel(decide_kernel_for(g), dim3((unsigned)p.blocks),
                                    dim3(p.p.threads), args, p.p.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
