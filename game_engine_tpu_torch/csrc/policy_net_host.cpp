// policy_net_host.cpp — the policy-net kernels' tile code (policy_net.cuh),
// compiled with g++ and looped over tiles and blocks on the host, with one
// "thread" per block. The same signatures as pn_forward / pn_grad in
// policy_net.cu, plus the rows per tile; the CPU tests use it to run the
// kernels' own arithmetic, tile edges and slab reduction without a GPU.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC policy_net_host.cpp -o libpolicy_net_host.so

#include <vector>

#include "policy_net.cuh"

extern "C" {

int pn_meta_ints() { return pn::META_INTS; }

int pn_forward_host(const int32_t* meta, const uint16_t* obs, int64_t nrows,
                    const float* prm, const float* prmB, float* logits, float* value,
                    int R) {
  const pn::Net n = pn::net_from_meta(meta);
  if (R < 1 || n.L < 1 || n.L > pn::MAX_LAYERS) return 1;
  const pn::Lay l = pn::layout(n, R, false);
  std::vector<float> sm(l.total);
  const pn::Ctx c{0, 1, sm.data()};
  for (int64_t row0 = 0; row0 < nrows; row0 += R) {
    const int nr = (int)(nrows - row0 < R ? nrows - row0 : R);
    pn::fwd_tile(n, l, c, obs, row0, nr, prm, prmB);
    for (int it = 0; it < nr * n.A; ++it) logits[row0 * n.A + it] = sm[l.logits + it];
    for (int r = 0; r < nr; ++r) value[row0 + r] = sm[l.value + r];
  }
  return 0;
}

int pn_grad_host(const int32_t* meta, const uint16_t* obs, int64_t nrows,
                 const float* rowin, const float* prm, const float* prmB, const float* prmT,
                 float* slabs, int max_blocks, float* out, int R) {
  const pn::Net n = pn::net_from_meta(meta);
  if (R < 1 || max_blocks < 1 || n.L < 1 || n.L > pn::MAX_LAYERS) return 1;
  const pn::Lay l = pn::layout(n, R, true);
  std::vector<float> sm(l.total);
  const pn::Ctx c{0, 1, sm.data()};
  const int ng = n.n_params;
  const int64_t ntiles = (nrows + R - 1) / R;
  const int grid = (int)(ntiles < max_blocks ? ntiles : max_blocks);
  for (int b = 0; b < grid; ++b) {
    float* slab = slabs + (int64_t)b * ng;
    for (int j = 0; j < ng; ++j) slab[j] = 0.0f;
    for (int64_t tile = b; tile < ntiles; tile += grid) {
      const int64_t row0 = tile * R;
      const int nr = (int)(nrows - row0 < R ? nrows - row0 : R);
      pn::grad_rows(n, l, c, obs, row0, nr, rowin, prm, prmB, prmT, slab);
    }
  }
  for (int j = 0; j < ng; ++j) {
    float s = 0.0f;
    for (int b = 0; b < grid; ++b) s += slabs[(int64_t)b * ng + j];
    out[j] = s;
  }
  return 0;
}

}  // extern "C"
