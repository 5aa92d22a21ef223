// observe_host.cpp — OB's and SA's bodies (observe.cuh) compiled with g++ and
// run on the host: ob_observe's blocks of R rooms one after another through
// the kernel's block body (ob_block), each stage done by one worker over the
// whole block (the device's barriers fall between the stages as they do
// there), and SA's rows in order. The same
// signatures as observe.cu's entries, minus the launch arguments; the CPU
// tests use them to run the kernels' own logic without a GPU.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC observe_host.cpp -o libobserve_host.so

#include <vector>

#include "observe.cuh"

extern "C" {

// R: rooms a block (the card's: ob_plan's)
int ob_observe_host(const int32_t* game, const int32_t* table, int table_len,
                    const int64_t* state, uint16_t* obs, uint8_t* legal, uint8_t* actor,
                    int64_t B, int masked, int R) {
  if (B <= 0 || R < 1 || R > ob::MAX_ROOMS || !ob::table_ok(table, table_len, ge::game_view(game)))
    return 1;
  const ge::BatchState s = ge::batch_state(state);
  const ob::ObLaunch l = ob::ob_launch(game, table, table_len, R);
  std::vector<int64_t> smem((size_t)(l.bytes + 7) / 8);
  for (int64_t room0 = 0; room0 < B; room0 += R)
    ob::ob_block(l, game, table, s, obs, legal, actor, B, room0, masked != 0, smem.data(), 0, 1,
                 nullptr);
  return 0;
}

int ob_rewards_host(const int32_t* table, int table_len, const int64_t* state,
                    const uint8_t* ended, float* reward, int64_t B) {
  if (B <= 0 || table_len < ob::HDR || table[ob::T_LEN] != table_len) return 1;
  const ob::Table x = ob::table_view(table);
  const ge::BatchState s = ge::batch_state(state);
  for (int64_t i = 0; i < B; ++i) {
    const int n = x.rw_mode == ge::RW_SCORE ? ob::count_present(x, s, i) : 0;
    for (int p = 0; p < x.P; ++p) reward[i * x.P + p] = ob::reward_of(x, s, ended, i, p, n);
  }
  return 0;
}

int ob_sample_host(const float* logits, const uint8_t* legal, const float* noise,
                   const uint8_t* actor, int32_t* actions, int32_t* masked, float* logp,
                   int64_t rows, int A, int mode) {
  if (rows <= 0 || A < 1 || mode < ob::SA_UNIFORM || mode > ob::SA_GREEDY ||
      (mode != ob::SA_GREEDY && noise == nullptr))
    return 1;
  for (int64_t row = 0; row < rows; ++row)
    ob::sample_row(logits, legal, noise, actor, actions, masked, logp, row, A, mode);
  return 0;
}

}  // extern "C"
