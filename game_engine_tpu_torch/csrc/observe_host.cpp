// observe_host.cpp — OB's and SA's bodies (observe.cuh) compiled with g++ and
// run on the host: ob_observe's blocks of R rooms one after another through
// the kernel's block body (ob_block), each stage done by one worker over the
// whole block (the device's barriers fall between the stages as they do
// there), and SA's rows in order, a row's group of lanes in a loop at each
// of the kernel's steps (sample_rows). The same
// signatures as observe.cu's entries, minus the launch arguments; the CPU
// tests use them to run the kernels' own logic without a GPU.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC observe_host.cpp -o libobserve_host.so

#include <vector>

#include "observe.cuh"

namespace {

// observe.cu's group_fold on a group's G lanes held in an array: offsets
// G/2 ... 1, each lane op(its own, the other's), all lanes of a step from
// the values before it, as the shuffles exchange them.
template <int G, class Op>
void group_fold(float (&v)[G], Op op) {
  for (int o = G / 2; o > 0; o >>= 1) {
    float next[G];
    for (int lane = 0; lane < G; ++lane) next[lane] = op(v[lane], v[lane ^ o]);
    for (int lane = 0; lane < G; ++lane) v[lane] = next[lane];
  }
}

// observe.cu's group_draw: the max of the lanes' values by the butterfly,
// from the first lane that holds it (lane 0 where none does), and whether
// any lane met a legal choice
template <int G>
ob::SaBest group_draw(const ob::SaBest (&b)[G]) {
  float x[G];
  for (int lane = 0; lane < G; ++lane) x[lane] = b[lane].x;
  group_fold<G>(x, ob::SaMax());
  int src = 0;
  while (src < G && b[src].x != x[src]) ++src;
  if (src == G) src = 0;
  int any = 0;
  for (int lane = 0; lane < G; ++lane) any |= b[lane].any;
  return ob::SaBest{x[0], b[src].m, b[src].i, any};
}

// observe.cu's ob_sample_kernel<G, MODE>, a row's G lanes in a loop at each
// step
template <int G, int MODE>
void sample_rows(const float* logits, const uint8_t* legal, const float* noise,
                 const uint8_t* actor, int32_t* actions, int32_t* masked, float* logp,
                 int64_t rows, int A, bool vec) {
  for (int64_t row = 0; row < rows; ++row) {
    const int64_t at = row * A;
    const float* z = MODE == ob::SA_GREEDY ? nullptr : noise + at;
    ob::SaBest best = ob::sa_none();
    float M[G] = {}, S[G] = {};
    for (int c0 = 0; c0 < A; c0 += G * ob::SA_SPAN) {
      float m[G][ob::SA_SPAN], cm[G], cs[G];
      ob::SaBest b[G];
      for (int lane = 0; lane < G; ++lane)
        b[lane] = ob::sa_load<MODE>(logits + at, legal + at, z, A, c0, lane, vec, m[lane],
                                    cm[lane]);
      group_fold<G>(cm, ob::SaMax());
      for (int lane = 0; lane < G; ++lane) cs[lane] = ob::sa_exp_sum(m[lane], cm[lane]);
      group_fold<G>(cs, ob::SaAdd());
      for (int lane = 0; lane < G; ++lane)
        ob::sa_fold(M[lane], S[lane], cm[lane], cs[lane], c0 == 0);
      best = ob::sa_pick(best, group_draw<G>(b));
    }
    ob::sa_write<MODE>(best, M[0], S[0], actor == nullptr || actor[row] != 0, actions, masked,
                       logp, row);
  }
}

}  // namespace

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
  const bool vec = ob::sa_vec(A, logits, legal, noise);
  ob::sa_widths(A, mode, [&](auto g, auto m) {
    sample_rows<decltype(g)::value, decltype(m)::value>(logits, legal, noise, actor, actions,
                                                        masked, logp, rows, A, vec);
  });
  return 0;
}

}  // extern "C"
