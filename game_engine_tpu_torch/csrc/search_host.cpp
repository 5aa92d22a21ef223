// search_host.cpp — the CUDA search kernels' bodies (room_step.cuh
// room_search_rollout and the decision stages seat_candidates, decide_room,
// decide_rollout, decide_argmax), compiled with g++ and looped on the host:
// each rollout's room in the kernel's [slot][lane] layout (a block of one
// room), its seats run in order. The same arguments as ge_search and
// ge_search_decide in search.cu, minus the launch's; the CPU tests use it to
// run the kernels' own logic without a GPU. A room's seat sets take as many
// words as the kernels' build for its seats.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC search_host.cpp -o libsearch_host.so
// With -DGE_COUNT the run also counts the interpreter's operations
// (ge_counts_reset / ge_counts_read).

#include <stddef.h>

#include <algorithm>
#include <numeric>
#include <vector>

#include "room_step.cuh"

namespace {

// the columns of a room's block: G lanes of SW columns each
int room_cols(const ge::Game& g) { return ge::group_lanes(g.P) * g.SW; }

template <int NW>
void run_requests(const ge::Game& g, const ge::MinorState& ms, int64_t B, const int32_t* req,
                  int64_t n_req, int rollouts, const ge::SearchSpec& s, int64_t* totals,
                  int32_t* steps) {
  const int cols = room_cols(g);
  std::vector<int32_t> words((size_t)g.L.words * cols);
  for (int64_t x = 0; x < n_req * rollouts; ++x) {
    const int32_t* q = req + (x / rollouts) * ge::REQ_INTS;
    ge::Room<NW> r = ge::room_fetch<NW>(g, ms, words.data(), cols, 0, 0, 0, q[0], B);
    const int32_t t0 = r.t;
    r.seed = ge::search_seed((uint32_t)q[3], r.t, (int)(x % rollouts));
    totals[x / rollouts] += ge::room_search_rollout(g, r, q[1], q[2], s);
    if (steps) steps[x] = r.t - t0;
  }
}

// the order in which n flat rollouts are run: in order for shuffle = 0, else
// a permutation drawn from splitmix32 streams of `shuffle`
std::vector<int64_t> rollout_order(int64_t n, uint32_t shuffle) {
  std::vector<int64_t> order((size_t)n);
  std::iota(order.begin(), order.end(), (int64_t)0);
  for (int64_t i = n - 1; shuffle != 0 && i > 0; --i) {
    const uint32_t h = ge::splitmix32(shuffle ^ ((uint32_t)i * ge::GOLDEN));
    std::swap(order[(size_t)i], order[(size_t)(h % (uint32_t)(i + 1))]);
  }
  return order;
}

template <int NW>
int64_t run_decisions(const ge::Game& g, const ge::MinorState& ms, int64_t B,
                      const ge::DecideTable& tab, int rollouts, const ge::SearchSpec& s,
                      uint32_t salt, int32_t* actions, int64_t* totals, uint32_t shuffle) {
  const int cols = room_cols(g);
  std::vector<int32_t> words((size_t)g.L.words * cols);
  for (int64_t i = 0; i < B; ++i)
    ge::decide_room<NW>(g, ms, B, tab, rollouts, actions, words.data(), cols, 0, 0, 0, i);
  const unsigned long long claim = *tab.claim;
  const int64_t n = (int64_t)(claim & ge::CLAIM_ROLLOUTS);
  for (int64_t x : rollout_order(n, shuffle)) {
    int64_t slot = 0;
    const int32_t score = ge::decide_rollout<NW>(g, ms, B, tab, (int64_t)(claim >> ge::CLAIM_SHIFT),
                                                 s, salt, x, words.data(), cols, 0, 0, 0, &slot);
    totals[slot] += score;
  }
  for (int64_t d = 0; d < B * g.P; ++d) ge::decide_argmax<NW>(g, ms, tab, actions, d);
  return n;
}

}  // namespace

extern "C" {

// room_step.cuh size_report: how a block of the game would be sized on the card.
void ge_size(const int32_t* game, int game_len, int threads, int64_t* out) {
  ge::size_report(game, game_len, threads, out);
}

// totals (n_req int64, zeroed by the caller) receive each request's sum of
// rollout scores; steps (n_req * rollouts int32, or null) each rollout's
// engine steps. Returns 0, or 1 for a bad size, 2 for a game the kernel
// cannot hold, 3 for a bad rollout spec, 4 for a request out of range.
int ge_search_host(const int32_t* game, int game_len, int32_t* bools, int32_t* nums,
                   int32_t* strs, int32_t* pdict, int32_t* odict, int32_t* present,
                   int32_t* regs, int32_t* scal, int64_t B, const int32_t* req, int64_t n_req,
                   int rollouts, int horizon, int mode, int team_slot,
                   const int32_t* team_codes, int n_codes, int64_t* totals, int32_t* steps) {
  if (B <= 0 || game_len <= 0 || n_req < 0) return 1;
  const ge::Game g = ge::game_view(game);
  if (g.P < 1 || g.P > ge::MAX_SEATS) return 2;
  const ge::SearchSpec s{rollouts, horizon, mode, team_slot, n_codes, team_codes};
  if (!ge::search_spec_ok(g, s)) return 3;
  for (int64_t i = 0; i < n_req; ++i)
    if (!ge::search_request_ok(g, req + i * ge::REQ_INTS, B)) return 4;
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  if (g.P <= 32) run_requests<1>(g, ms, B, req, n_req, rollouts, s, totals, steps);
  else run_requests<ge::MAX_SEAT_WORDS>(g, ms, B, req, n_req, rollouts, s, totals, steps);
  return 0;
}

// The full-information decisions of the B rooms, as ge_search_decide makes
// them: actions (B * P int32) receive each seat's choice, 0 where it has
// none; totals (B * P * C int64, zeroed by the caller) each candidate's
// total; stats (3 int64) {waiting seats, candidates searched, rollouts};
// counts (B * P int32) each seat's candidates, -1 where it does not wait.
// The rollouts run in order, or in a shuffled order for shuffle != 0.
// Returns 0, or as ge_search_host (5: C too small).
int ge_search_decide_host(const int32_t* game, int game_len, int32_t* bools, int32_t* nums,
                          int32_t* strs, int32_t* pdict, int32_t* odict, int32_t* present,
                          int32_t* regs, int32_t* scal, int64_t B, int rollouts, int horizon,
                          int mode, int team_slot, const int32_t* team_codes, int n_codes,
                          uint32_t salt, int C, int32_t* actions, int64_t* totals,
                          int64_t* stats, int32_t* counts, uint32_t shuffle) {
  if (B <= 0 || game_len <= 0) return 1;
  const ge::Game g = ge::game_view(game);
  if (g.P < 1 || g.P > ge::MAX_SEATS) return 2;
  const ge::SearchSpec s{rollouts, horizon, mode, team_slot, n_codes, team_codes};
  if (!ge::search_spec_ok(g, s)) return 3;
  if (C < g.P) return 5;
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  const int64_t n_dec = B * g.P;
  std::vector<int32_t> alive((size_t)(B * g.SW));
  std::vector<int64_t> starts((size_t)n_dec), decision((size_t)n_dec);
  unsigned long long claim = 0, sums[3] = {0, 0, 0};
  const ge::DecideTable tab{counts, alive.data(), totals, starts.data(), decision.data(),
                            &claim, sums, C};
  const int64_t n =
      g.P <= 32 ? run_decisions<1>(g, ms, B, tab, rollouts, s, salt, actions, totals, shuffle)
                : run_decisions<ge::MAX_SEAT_WORDS>(g, ms, B, tab, rollouts, s, salt, actions,
                                                    totals, shuffle);
  stats[0] = (int64_t)sums[0];
  stats[1] = (int64_t)sums[1];
  stats[2] = n;
  return 0;
}

#ifdef GE_COUNT
// the counts since the last reset: atoms evaluated, node-seat evaluations,
// state writes, splitmix32 hashes
void ge_counts_reset() { for (int k = 0; k < ge::N_COUNTS; ++k) ge::counts[k] = 0; }
void ge_counts_read(int64_t* out) { for (int k = 0; k < ge::N_COUNTS; ++k) out[k] = ge::counts[k]; }
#endif

}  // extern "C"
