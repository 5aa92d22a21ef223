// rollout_host.cpp — the CUDA rollout kernel's per-room body (room_step.cuh),
// compiled with g++ and looped over rooms on the host: each room's words in
// the kernel's [slot][column] layout (a block of one room), its seats run in
// order, its seat sets as many words as the kernel's build for its seats. The same signature as ge_rollout in rollout.cu, minus the launch
// arguments; the CPU tests use it to run the kernel's own logic without a GPU.
// ST's entries (ge_bots_host, ge_step_host, ge_reset_done_host,
// ge_step_reset_host) run the kernel's block body, blocks of R rooms one
// after another, on GameState's own tensors.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC rollout_host.cpp -o librollout_host.so
// With -DGE_COUNT the run also counts the interpreter's operations
// (ge_counts_reset / ge_counts_read).

#include <stddef.h>

#include <vector>

#include "room_step.cuh"

namespace {

// the rooms one after another, each in a block of its own G * SW columns
template <int NW>
void run_rooms(const ge::Game& g, const ge::MinorState& ms, int32_t* eps, int64_t B,
               int num_steps, int auto_reset) {
  const int cols = ge::group_lanes(g.P) * g.SW;
  std::vector<int32_t> words((size_t)g.L.words * cols);
  for (int64_t room = 0; room < B; ++room) {
    ge::rooms_copy(g, ms, words.data(), cols, cols, 1, room, B, 0, 1, false);
    ge::Room<NW> r = ge::room_open<NW>(g, ms, words.data(), cols, 0, 0, 0, room, B);
    eps[room] = ge::room_rollout(g, r, num_steps, auto_reset);
    ge::room_close(r, ms, room, B);
    ge::rooms_copy(g, ms, words.data(), cols, cols, 1, room, B, 0, 1, true);
  }
}

// ST's entries (rollout.cu ge_bots, ge_step, ge_reset_done, ge_step_reset)
// the same way: blocks of R rooms one after another through st_block, the
// kernel's block body, its buffer laid out as the kernel's shared memory
// (a room on group_lanes(P) lanes) and its rooms run in order
template <int NW>
void entry_rooms(const ge::Game& g, const ge::StArgs& a, int R) {
  const int G = ge::group_lanes(g.P), lanes = R * G;
  std::vector<int64_t> smem((size_t)(ge::st_shared_bytes(g, a.game_len, lanes, G) + 7) / 8);
  ge::StArgs la = a;
  ge::st_fill(la, g, lanes, G);
  for (int64_t room0 = 0; room0 < a.B; room0 += R)
    ge::st_block<NW>(la, smem.data(), room0, lanes, G, 0, 1, nullptr);
}

ge::StArgs host_args(const int32_t* game, int game_len, const int64_t* in, const int64_t* out,
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

int entry_host(const ge::StArgs& a, int R) {
  if (a.B <= 0 || a.game_len <= 0 || R < 1) return 1;
  const ge::Game g = ge::game_view(a.game);
  if (g.P < 1 || g.P > ge::MAX_SEATS) return 2;
  if (a.mode == ge::ENTRY_STEP_RESET && a.reward && !ge::reward_rule_ok(g, a.rw)) return 3;
  if (g.P <= 32) entry_rooms<1>(g, a, R);
  else entry_rooms<ge::MAX_SEAT_WORDS>(g, a, R);
  return 0;
}

}  // namespace

extern "C" {

// room_step.cuh size_report: how a block of the game would be sized on the card.
void ge_size(const int32_t* game, int game_len, int threads, int64_t* out) {
  ge::size_report(game, game_len, threads, out);
}

int ge_rollout_host(const int32_t* game, int game_len, int32_t* bools,
                    int32_t* nums, int32_t* strs, int32_t* pdict, int32_t* odict,
                    int32_t* present, int32_t* regs, int32_t* scal, int32_t* eps,
                    int64_t B, int num_steps, int auto_reset) {
  if (B <= 0 || game_len <= 0) return 1;
  const ge::Game g = ge::game_view(game);
  if (g.P < 1 || g.P > ge::MAX_SEATS) return 2;
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  if (g.P <= 32) run_rooms<1>(g, ms, eps, B, num_steps, auto_reset);
  else run_rooms<ge::MAX_SEAT_WORDS>(g, ms, eps, B, num_steps, auto_reset);
  return 0;
}

// rollout.cu's ST entries on host arrays, minus the launch arguments and
// plus R, the rooms a block
int ge_bots_host(const int32_t* game, int game_len, const int64_t* state, int32_t* actions,
                 int64_t B, int R) {
  return entry_host(host_args(game, game_len, state, nullptr, actions, B, ge::ENTRY_BOTS), R);
}

int ge_step_host(const int32_t* game, int game_len, const int64_t* state, const int64_t* out,
                 const int32_t* actions, const uint8_t* keep, uint8_t* ended, int64_t B, int R) {
  ge::StArgs a = host_args(game, game_len, state, out, const_cast<int32_t*>(actions), B,
                           ge::ENTRY_STEP);
  a.keep = keep;
  a.ended = ended;
  return entry_host(a, R);
}

int ge_reset_done_host(const int32_t* game, int game_len, const int64_t* state,
                       const int64_t* out, int64_t B, int R) {
  return entry_host(host_args(game, game_len, state, out, nullptr, B, ge::ENTRY_RESET), R);
}

int ge_step_reset_host(const int32_t* game, int game_len, const int64_t* state,
                       const int64_t* out, const int32_t* actions, uint8_t* ended,
                       int32_t* winner, float* reward, int rw_mode, int rw_team_slot,
                       const int32_t* codes, int n_codes, int64_t B, int R) {
  ge::StArgs a = host_args(game, game_len, state, out, const_cast<int32_t*>(actions), B,
                           ge::ENTRY_STEP_RESET);
  a.ended = ended;
  a.winner = winner;
  a.reward = reward;
  a.rw = ge::RewardRule{rw_mode, rw_team_slot, n_codes, codes};
  return entry_host(a, R);
}

#ifdef GE_COUNT
// the counts since the last reset: atoms evaluated, node-seat evaluations,
// state writes, splitmix32 hashes
void ge_counts_reset() { for (int k = 0; k < ge::N_COUNTS; ++k) ge::counts[k] = 0; }
void ge_counts_read(int64_t* out) { for (int k = 0; k < ge::N_COUNTS; ++k) out[k] = ge::counts[k]; }
#endif

}  // extern "C"
