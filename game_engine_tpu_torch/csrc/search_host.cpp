// search_host.cpp — the CUDA search kernel's per-rollout body (room_step.cuh
// room_search_rollout), compiled with g++ and looped over the requests and
// their rollouts on the host: each rollout's room in the kernel's
// [slot][lane] layout (a block of one room), its seats run in order. The same
// arguments as ge_search in search.cu, minus the launch's; the CPU tests use
// it to run the kernel's own logic without a GPU.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC search_host.cpp -o libsearch_host.so
// With -DGE_COUNT the run also counts the interpreter's operations
// (ge_counts_reset / ge_counts_read).

#include <stddef.h>

#include <vector>

#include "room_step.cuh"

extern "C" {

// room_step.cuh size_report: how a block of the game would be sized on the card.
void ge_size(const int32_t* game, int game_len, int threads, int64_t* out) {
  ge::size_report(game, game_len, threads, out);
}

// totals (n_req int64, zeroed by the caller) receive each request's sum of
// rollout scores. Returns 0, or 1 for a bad size, 2 for a game the kernel
// cannot hold, 3 for a bad rollout spec, 4 for a request out of range.
int ge_search_host(const int32_t* game, int game_len, int32_t* bools, int32_t* nums,
                   int32_t* strs, int32_t* pdict, int32_t* odict, int32_t* present,
                   int32_t* regs, int32_t* scal, int64_t B, const int32_t* req, int64_t n_req,
                   int rollouts, int horizon, int mode, int team_slot,
                   const int32_t* team_codes, int n_codes, int64_t* totals) {
  if (B <= 0 || game_len <= 0 || n_req < 0) return 1;
  const ge::Game g = ge::game_view(game);
  if (g.P < 1 || g.P > ge::MAX_GROUP) return 2;
  const ge::SearchSpec s{rollouts, horizon, mode, team_slot, n_codes, team_codes};
  if (!ge::search_spec_ok(g, s)) return 3;
  for (int64_t i = 0; i < n_req; ++i)
    if (!ge::search_request_ok(g, req + i * ge::REQ_INTS, B)) return 4;
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  const int G = ge::group_lanes(g.P);
  std::vector<int32_t> words((size_t)g.L.words * G);
  for (int64_t x = 0; x < n_req * rollouts; ++x) {
    const int32_t* q = req + (x / rollouts) * ge::REQ_INTS;
    ge::rooms_load(g, ms, words.data(), G, G, 1, B, req, n_req, rollouts, x, 0, 1);
    ge::Room r = ge::room_open(g, ms, words.data(), G, 0, 0, 0, q[0], B);
    r.seed = ge::search_seed((uint32_t)q[3], r.t, (int)(x % rollouts));
    totals[x / rollouts] += ge::room_search_rollout(g, r, q[1], q[2], s);
  }
  return 0;
}

#ifdef GE_COUNT
// the counts since the last reset: atoms evaluated, node-seat evaluations,
// state writes, splitmix32 hashes
void ge_counts_reset() { for (int k = 0; k < ge::N_COUNTS; ++k) ge::counts[k] = 0; }
void ge_counts_read(int64_t* out) { for (int k = 0; k < ge::N_COUNTS; ++k) out[k] = ge::counts[k]; }
#endif

}  // extern "C"
