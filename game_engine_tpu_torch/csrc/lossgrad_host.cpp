// lossgrad_host.cpp — the pipelines of K2, K3 and K4 (lossgrad.cuh) on the
// host, built with g++: the same stages, buffer layouts, chunking and slab
// order as the CUDA kernels in lossgrad.cu, with each tensor-core product
// replaced by a plain loop over the same bf16 operands (f32 sums). The CPU
// tests hold them against the plain PyTorch versions (policies/fused.py
// fused_forward_plain, autograd through it, loss_vg_plain).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC lossgrad_host.cpp -o liblossgrad_host.so

#include <vector>

#include "lossgrad.cuh"

namespace {

float f(uint16_t b) { return lg::bf16_bits_to_float(b); }

struct HostBE {
  template <class F>
  int each(const F& fn, int64_t count) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return 0;
  }

  int memset(void* p, int64_t bytes) {
    ::memset(p, 0, (size_t)bytes);
    return 0;
  }

  int gemm(const lg::Gemm& a) {
    for (int64_t r = 0; r < a.M; ++r)
      for (int c0 = 0; c0 < a.N; c0 += 8) {
        float acc[8];
        for (int c = c0; c < c0 + 8; ++c) {
          float s = 0.0f;
          for (int p = 0; p < a.npair; ++p)
            for (int k = 0; k < a.K; ++k)
              s += f(a.A[p][r * a.lda + k]) * f(a.B[(int64_t)k * a.ldb + c]);
          acc[c - c0] = s;
        }
        lg::epi_apply8(a.epi, r, c0, acc);
      }
    return 0;
  }

  int wgrad(const lg::Wgrad& a) {
    for (int s = 0; s < a.nsplit; ++s) {
      int64_t r0, r1;
      lg::split_rows(a.M, a.nsplit, s, &r0, &r1);
      float* slab = a.slabs + (int64_t)s * a.ng;
      for (int c = 0; c < a.N; ++c) {
        for (int k = 0; k < a.K; ++k) {
          const int at = lg::target_index(a.t, k, c);
          if (at < 0) continue;
          float acc = 0.0f;
          for (int64_t r = r0; r < r1; ++r) {
            const float x = f(a.X[r * a.ldx + k]);
            acc += x * f(a.Y[0][r * a.ldy + c]) + x * f(a.Y[1][r * a.ldy + c]);
          }
          slab[at] += acc;
        }
        const int bi = lg::target_bias(a.t, c);
        if (bi < 0) continue;
        float sum = 0.0f;
        for (int64_t r = r0; r < r1; ++r)
          sum += f(a.Y[0][r * a.ldy + c]) + f(a.Y[1][r * a.ldy + c]);
        slab[bi] += sum;
      }
    }
    return 0;
  }

  int colsum(const lg::Colsum& a) {
    for (int s = 0; s < a.nsplit; ++s) {
      int64_t r0, r1;
      lg::split_rows(a.M, a.nsplit, s, &r0, &r1);
      float* slab = a.slabs + (int64_t)s * a.ng;
      for (int c = 0; c < a.N; ++c) {
        float uv = 0.0f, u = 0.0f;
        for (int64_t r = r0; r < r1; ++r) {
          const float x = a.U[r * a.ld + c];
          u += x;
          if (a.V) uv += x * a.V[r * a.ld + c];
        }
        if (a.uv_off >= 0) slab[a.uv_off + c] += uv;
        if (a.u_off >= 0) slab[a.u_off + c] += u;
      }
    }
    return 0;
  }

  int reduce(const float* slabs, int nsplit, int ng, float* out) {
    for (int j = 0; j < ng; ++j) {
      float s = 0.0f;
      for (int b = 0; b < nsplit; ++b) s += slabs[(int64_t)b * ng + j];
      out[j] = s;
    }
    return 0;
  }
};

}  // namespace

extern "C" {

int lg_meta_ints() { return lg::META_INTS; }

// the sizes and the entries of lossgrad.cu, on host memory (the same
// layouts); each entry returns 0, or 1 for a net or chunking it refuses
int64_t lg_weights_bytes(const int32_t* meta) {
  return lg::layout(lg::net_from_meta(meta), 1, 1, true).w_end;
}

int64_t lg_scratch_bytes(const int32_t* meta, int64_t chunk, int nsplit, int fwd_only) {
  return lg::layout(lg::net_from_meta(meta), chunk, nsplit, fwd_only != 0).total;
}

int lg_pack_host(const int32_t* meta, const float* prm, void* weights) {
  const lg::Net n = lg::net_from_meta(meta);
  if (!lg::supported(n)) return 1;
  HostBE be;
  return lg::pack_weights(be, n, lg::layout(n, 1, 1, true), prm, (char*)weights);
}

int lg_forward_host(const int32_t* meta, const uint16_t* obs, int64_t nrows, const float* prm,
                    const void* weights, void* scratch, int64_t chunk, float* logits,
                    float* value) {
  const lg::Net n = lg::net_from_meta(meta);
  if (!lg::supported(n) || chunk < 1) return 1;
  HostBE be;
  return lg::run_forward(be, n, lg::layout(n, chunk, 1, true), (const char*)weights,
                         (char*)scratch, obs, nrows, prm, logits, value);
}

int lg_grad_host(const int32_t* meta, const uint16_t* obs, int64_t nrows, const float* rowin,
                 const float* prm, const void* weights, void* scratch, int64_t chunk,
                 int nsplit, float* out) {
  const lg::Net n = lg::net_from_meta(meta);
  if (!lg::supported(n) || chunk < 1 || nsplit < 1) return 1;
  HostBE be;
  return lg::run_grad(be, n, lg::layout(n, chunk, nsplit, false), (const char*)weights,
                      (char*)scratch, obs, nrows, rowin, false, 0.0f, 0.0f, prm, out);
}

int lg_lossgrad_host(const int32_t* meta, const uint16_t* obs, int64_t nrows, const float* rowin,
                     float clip_eps, float ent_coef, const float* prm, const void* weights,
                     void* scratch, int64_t chunk, int nsplit, float* out) {
  const lg::Net n = lg::net_from_meta(meta);
  if (!lg::supported(n) || chunk < 1 || nsplit < 1) return 1;
  HostBE be;
  return lg::run_grad(be, n, lg::layout(n, chunk, nsplit, false), (const char*)weights,
                      (char*)scratch, obs, nrows, rowin, true, clip_eps, ent_coef, prm, out);
}

}  // extern "C"
