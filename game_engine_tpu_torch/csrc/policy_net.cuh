// policy_net.cuh — one tile of rows of the deepsets/attn policy net: the
// forward and the parameter gradient of given cotangents, written for one
// CUDA block (or, in the host harness, one loop iteration): the CUDA-core
// route, for the widths the tensor-core pipelines do not cover. Those
// pipelines (K2, K3 and K4, the PPO loss-grad) are lossgrad.cuh; they share
// Net, the rounding and gelu here.
//
// Counterpart of game_engine_tpu/policies/fused.py: _fwd_body (:154) and
// _grad_body (:329). The cast
// points are _fwd_body's: every product takes bf16-rounded operands and
// accumulates in f32; e is rounded to bf16 before the LayerNorm (eps 1e-5);
// the attention weights are rounded before mixing; the residual phi is
// rounded; each pointer product phi_i * g is rounded before its f32 sum;
// gelu is the tanh form. The gradient products are f32, as in _grad_body.
//
// Work layout. A tile is R rows = S = R * P seat-rows. Every intermediate
// of the tile lives in shared memory (Lay below). Each step is a loop of
// independent work items over the threads of the block, followed by a
// barrier; a product Y = X W gives each item one output column and up to RC
// seat-rows, so a weight is read from global memory (L2) once per RC rows.
// On the host the same loops run with one "thread" and no barrier.
//
// Parameter gradients: each block owns a private f32 slab of the whole
// gradient and adds each tile's contribution into it;
// an item owns a fixed set of slab elements, so there are no atomics and no
// races. A second kernel sums the slabs in block order: the result is
// deterministic for a given grid.
//
// PN_HD marks functions compiled for both the device (nvcc) and the host
// harness (g++, csrc/policy_net_host.cpp).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define PN_HD __host__ __device__ inline
#else
#define PN_HD inline
#endif

#ifdef __CUDA_ARCH__
#define PN_SYNC() __syncthreads()
#else
#define PN_SYNC() ((void)0)
#endif

namespace pn {

constexpr int MAX_LAYERS = 8;
constexpr int RC = 8;       // seat-rows per work item of a product
constexpr int N_STATS = 4;  // K4's sums: pg*w, 0.5 (v-ret)^2 vrow, ent*w, ratio*w

// parameter slots; the trunk's layer i is W_TRUNK + 2i (weight), + 1 (bias)
enum { W_PHI0, B_PHI0, W_PHI1, B_PHI1, LN_S, LN_B, W_QKV, W_AO, W_PTR,
       W_PI, B_PI, W_V, B_V, W_TRUNK };
constexpr int N_SLOTS = W_TRUNK + 2 * MAX_LAYERS;
constexpr int META_INTS = 10 + N_SLOTS;

// the net's dims and the float offset of each parameter in the flat
// parameter buffers (and in the gradient slab, which has the same layout)
struct Net {
  int P, F0, NP, hp, H, L, n_opt, A, attn, n_params;
  int off[N_SLOTS];
  PN_HD int G() const { return P + NP + 1; }
  PN_HD int F() const { return P * F0 + G(); }
  PN_HD int T() const { return 2 * hp + NP + 1; }   // trunk input width
  PN_HD int XW() const { return T() + L * H; }      // trunk activations per row
  PN_HD int in_col(int i) const { return i == 0 ? 0 : T() + (i - 1) * H; }
  PN_HD int in_w(int i) const { return i == 0 ? T() : H; }
};

// meta = [P, F0, NP, hp, H, L, n_opt, A, attn, n_params, off[0..N_SLOTS)]
PN_HD Net net_from_meta(const int32_t* m) {
  Net n;
  n.P = m[0]; n.F0 = m[1]; n.NP = m[2]; n.hp = m[3]; n.H = m[4]; n.L = m[5];
  n.n_opt = m[6]; n.A = m[7]; n.attn = m[8]; n.n_params = m[9];
  for (int i = 0; i < N_SLOTS; ++i) n.off[i] = m[10 + i];
  return n;
}

// float offsets of the tile's buffers in shared memory
struct Lay {
  int R;
  // seat-level (S rows)
  int xin, z0, p0, z1, e, hn, inv, hb, qkv, att, o, phi;
  // row-level (R rows)
  int rest, xs, zs, gb, logits, value;
  // backward
  int dl, dv, dphi, dx, dz, dg, t1, dA, dqkv, m12;
  int total;
};

PN_HD int take(int& at, int n) {
  const int o = at;
  at += (n + 3) & ~3;  // 16-byte aligned buffers
  return o;
}

PN_HD Lay layout(const Net& n, int R, bool bwd) {
  Lay l;
  const int S = R * n.P, hp = n.hp;
  const int a = n.attn ? 1 : 0;
  int at = 0;
  l.R = R;
  l.xin = take(at, S * n.F0);
  l.z0 = take(at, S * hp);
  l.p0 = take(at, S * hp);
  l.z1 = take(at, S * hp);
  l.e = take(at, S * hp);
  l.hn = take(at, a * S * hp);
  l.inv = take(at, a * S);
  l.hb = take(at, a * S * hp);
  l.qkv = take(at, a * S * 3 * hp);
  l.att = take(at, a * S * n.P);
  l.o = take(at, a * S * hp);
  l.phi = take(at, S * hp);
  l.rest = take(at, R * n.G());
  l.xs = take(at, R * n.XW());
  l.zs = take(at, R * n.L * n.H);
  l.gb = take(at, R * hp);
  l.logits = take(at, R * n.A);
  l.value = take(at, R);
  const int b = bwd ? 1 : 0;
  l.dl = take(at, b * R * n.A);
  l.dv = take(at, b * R);
  l.dphi = take(at, b * S * hp);
  l.dx = take(at, b * R * (n.T() > n.H ? n.T() : n.H));
  l.dz = take(at, b * R * n.H);
  l.dg = take(at, b * R * hp);
  l.t1 = take(at, b * S * hp);
  l.dA = take(at, a * b * S * n.P);
  l.dqkv = take(at, a * b * S * 3 * hp);
  l.m12 = take(at, a * b * S * 2);
  l.total = at;
  return l;
}

struct Ctx {
  int tid, nthr;
  float* sm;
};

PN_HD int imin(int a, int b) { return a < b ? a : b; }

// round to the nearest bf16 (ties to even), returned as f32
PN_HD float bfr(float x) {
  uint32_t u;
#ifdef __CUDA_ARCH__
  u = __float_as_uint(x);
#else
  memcpy(&u, &x, 4);
#endif
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    u |= 0x00400000u;  // NaN stays a (quiet) NaN
  } else {
    u += 0x7fffu + ((u >> 16) & 1u);
  }
  u &= 0xffff0000u;
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float y;
  memcpy(&y, &u, 4);
  return y;
#endif
}

PN_HD float bf16_bits_to_float(uint16_t b) {
  const uint32_t u = (uint32_t)b << 16;
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float y;
  memcpy(&y, &u, 4);
  return y;
#endif
}

// tanh gelu and its derivative, fused.py:53-63
constexpr float SQRT2OPI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;

PN_HD float gelu(float x) {
  const float u = SQRT2OPI * (x + GELU_C * x * x * x);
  return 0.5f * x * (1.0f + tanhf(u));
}

PN_HD float dgelu(float x) {
  const float u = SQRT2OPI * (x + GELU_C * x * x * x);
  const float t = tanhf(u);
  const float du = SQRT2OPI * (1.0f + 3.0f * GELU_C * x * x);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
}

// Y[s][c] (=|+=) sum_k X[s][k] W[k][c] (+ bias[c]) for s < S, c < N.
// X in shared memory (rounded to bf16 on read when RX), W in global memory
// with row stride ldw. One item = one column and up to RC seat-rows.
template <bool RX, bool ACC>
PN_HD void mm(const Ctx& c, const float* X, int ldx, int S, int K,
              const float* __restrict__ W, int ldw, int N, float* Y, int ldy,
              const float* __restrict__ bias) {
  const int nch = (S + RC - 1) / RC;
  for (int it = c.tid; it < N * nch; it += c.nthr) {
    const int col = it % N, s0 = (it / N) * RC;
    const int ns = imin(RC, S - s0);
    float acc[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) acc[r] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float w = W[(int64_t)k * ldw + col];
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r < ns) {
          float x = X[(s0 + r) * ldx + k];
          if (RX) x = bfr(x);
          acc[r] += x * w;
        }
      }
    }
    const float b = bias ? bias[col] : 0.0f;
#pragma unroll
    for (int r = 0; r < RC; ++r) {  // constant indices keep acc in registers
      if (r < ns) {
        float* y = &Y[(s0 + r) * ldy + col];
        *y = ACC ? *y + acc[r] + b : acc[r] + b;
      }
    }
  }
}

// Gs[k][c] += sum_s X[s][k] D[s][c]: a weight gradient into the slab
PN_HD void acc_outer(const Ctx& c, const float* X, int ldx, int S, int K,
                     const float* D, int ldd, int N, float* Gs) {
  for (int it = c.tid; it < K * N; it += c.nthr) {
    const int k = it / N, col = it % N;
    float s = 0.0f;
    for (int r = 0; r < S; ++r) s += X[r * ldx + k] * D[r * ldd + col];
    Gs[it] += s;
  }
}

// Gs[c] += sum_s D[s][c]: a bias gradient into the slab
PN_HD void acc_bias(const Ctx& c, const float* D, int ldd, int S, int N, float* Gs) {
  for (int col = c.tid; col < N; col += c.nthr) {
    float s = 0.0f;
    for (int r = 0; r < S; ++r) s += D[r * ldd + col];
    Gs[col] += s;
  }
}

// ---------------------------------------------------------------------------
// forward (_fwd_body) for rows [row0, row0 + nr) of obs (rows, F) bf16.
// prm: f32 params; prmB: the same with every value rounded to bf16.
// ---------------------------------------------------------------------------
PN_HD void fwd_tile(const Net& n, const Lay& l, const Ctx& c,
                    const uint16_t* __restrict__ obs, int64_t row0, int nr,
                    const float* __restrict__ prm, const float* __restrict__ prmB) {
  float* sm = c.sm;
  const int P = n.P, F0 = n.F0, hp = n.hp, Fw = n.F(), G = n.G();
  const int S = nr * P;
  float *xin = sm + l.xin, *z0 = sm + l.z0, *p0 = sm + l.p0, *z1 = sm + l.z1,
        *e = sm + l.e, *phi = sm + l.phi, *rest = sm + l.rest, *xs = sm + l.xs,
        *zs = sm + l.zs, *gb = sm + l.gb, *logits = sm + l.logits,
        *value = sm + l.value;

  // rows in: the (P, F0) room view per seat-row, and the rest of the row
  for (int it = c.tid; it < nr * Fw; it += c.nthr) {
    const int r = it / Fw, f = it % Fw;
    const float v = bf16_bits_to_float(obs[(row0 + r) * Fw + f]);
    if (f < P * F0) {
      xin[(r * P + f / F0) * F0 + f % F0] = v;
    } else {
      rest[r * G + f - P * F0] = v;
    }
  }
  PN_SYNC();
  // seat encoder: z0 = x W0 + b0, p0 = gelu(z0), z1 = p0 W1 + b1, e = gelu(z1)
  mm<false, false>(c, xin, F0, S, F0, prmB + n.off[W_PHI0], hp, hp, z0, hp,
                   prm + n.off[B_PHI0]);
  PN_SYNC();
  for (int it = c.tid; it < S * hp; it += c.nthr) p0[it] = gelu(z0[it]);
  PN_SYNC();
  mm<true, false>(c, p0, hp, S, hp, prmB + n.off[W_PHI1], hp, hp, z1, hp,
                  prm + n.off[B_PHI1]);
  PN_SYNC();
  for (int it = c.tid; it < S * hp; it += c.nthr) e[it] = gelu(z1[it]);
  PN_SYNC();

  if (n.attn) {
    float *hn = sm + l.hn, *inv = sm + l.inv, *hb = sm + l.hb, *qkv = sm + l.qkv,
          *att = sm + l.att, *o = sm + l.o;
    const float* ln_s = prm + n.off[LN_S];
    const float* ln_b = prm + n.off[LN_B];
    // LayerNorm of bf16(e), one item per seat-row
    for (int s = c.tid; s < S; s += c.nthr) {
      const float* es = e + s * hp;
      float mu = 0.0f;
      for (int k = 0; k < hp; ++k) mu += bfr(es[k]);
      mu /= hp;
      float var = 0.0f;
      for (int k = 0; k < hp; ++k) {
        const float d = bfr(es[k]) - mu;
        var += d * d;
      }
      var /= hp;
      const float iv = 1.0f / sqrtf(var + 1e-5f);
      inv[s] = iv;
      for (int k = 0; k < hp; ++k) {
        const float h = (bfr(es[k]) - mu) * iv;
        hn[s * hp + k] = h;
        hb[s * hp + k] = bfr(h * ln_s[k] + ln_b[k]);
      }
    }
    PN_SYNC();
    // one-head q | k | w projections (no bias)
    mm<false, false>(c, hb, hp, S, hp, prmB + n.off[W_QKV], 3 * hp, 3 * hp, qkv,
                     3 * hp, nullptr);
    PN_SYNC();
    const float scale = 1.0f / sqrtf((float)hp);
    for (int it = c.tid; it < S * P; it += c.nthr) {  // scores (s = query, j = key)
      const int s = it / P, j = it % P, r = s / P;
      const float* q = qkv + s * 3 * hp;
      const float* kk = qkv + (r * P + j) * 3 * hp + hp;
      float d = 0.0f;
      for (int k = 0; k < hp; ++k) d += q[k] * kk[k];
      att[it] = d * scale;
    }
    PN_SYNC();
    for (int s = c.tid; s < S; s += c.nthr) {  // softmax over keys
      float* a = att + s * P;
      float m = a[0];
      for (int j = 1; j < P; ++j) m = a[j] > m ? a[j] : m;
      float den = 0.0f;
      for (int j = 0; j < P; ++j) {
        a[j] = expf(a[j] - m);
        den += a[j];
      }
      for (int j = 0; j < P; ++j) a[j] = a[j] / den;
    }
    PN_SYNC();
    for (int it = c.tid; it < S * hp; it += c.nthr) {  // o = bf16(att) . w
      const int s = it / hp, k = it % hp, r = s / P;
      float acc = 0.0f;
      for (int j = 0; j < P; ++j)
        acc += bfr(att[s * P + j]) * qkv[(r * P + j) * 3 * hp + 2 * hp + k];
      o[it] = acc;
    }
    PN_SYNC();
    // residual: phi = bf16(e + bf16(o) W_ao)
    mm<true, false>(c, o, hp, S, hp, prmB + n.off[W_AO], hp, hp, phi, hp, nullptr);
    PN_SYNC();
    for (int it = c.tid; it < S * hp; it += c.nthr) phi[it] = bfr(e[it] + phi[it]);
  } else {
    for (int it = c.tid; it < S * hp; it += c.nthr) phi[it] = bfr(e[it]);
  }
  PN_SYNC();

  // trunk input: [mean pool | viewer's own embedding | phase one-hot, alive]
  const int T = n.T(), XW = n.XW();
  for (int it = c.tid; it < nr * T; it += c.nthr) {
    const int r = it / T, col = it % T;
    float v;
    if (col < hp) {
      v = 0.0f;
      for (int i = 0; i < P; ++i) v += phi[(r * P + i) * hp + col];
      v = v * (1.0f / P);
    } else if (col < 2 * hp) {
      v = 0.0f;
      for (int i = 0; i < P; ++i) v += rest[r * G + i] * phi[(r * P + i) * hp + col - hp];
    } else {
      v = rest[r * G + P + col - 2 * hp];
    }
    xs[r * XW + col] = v;
  }
  PN_SYNC();
  const int LH = n.L * n.H;
  for (int i = 0; i < n.L; ++i) {
    mm<true, false>(c, xs + n.in_col(i), XW, nr, n.in_w(i),
                    prmB + n.off[W_TRUNK + 2 * i], n.H, n.H, zs + i * n.H, LH,
                    prm + n.off[W_TRUNK + 2 * i + 1]);
    PN_SYNC();
    for (int it = c.tid; it < nr * n.H; it += c.nthr) {
      const int r = it / n.H, col = it % n.H;
      xs[r * XW + T + i * n.H + col] = gelu(zs[r * LH + i * n.H + col]);
    }
    PN_SYNC();
  }
  // heads on the last trunk activation
  const float* xl = xs + T + (n.L - 1) * n.H;
  for (int it = c.tid; it < nr * n.A; it += c.nthr) logits[it] = 0.0f;
  PN_SYNC();
  mm<true, false>(c, xl, XW, nr, n.H, prmB + n.off[W_PI], n.n_opt, n.n_opt,
                  logits, n.A, prm + n.off[B_PI]);
  mm<true, false>(c, xl, XW, nr, n.H, prmB + n.off[W_PTR], hp, hp, gb, hp, nullptr);
  mm<true, false>(c, xl, XW, nr, n.H, prmB + n.off[W_V], 1, 1, value, 1,
                  prm + n.off[B_V]);
  PN_SYNC();
  for (int it = c.tid; it < nr * hp; it += c.nthr) gb[it] = bfr(gb[it]);
  PN_SYNC();
  // pointer scores: logits[r][i] += sum_k bf16(phi_i[k] * g[k])
  for (int it = c.tid; it < nr * P; it += c.nthr) {
    const int r = it / P, i = it % P;
    float d = 0.0f;
    for (int k = 0; k < hp; ++k) d += bfr(phi[(r * P + i) * hp + k] * gb[r * hp + k]);
    logits[r * n.A + i] += d;
  }
  PN_SYNC();
}

// ---------------------------------------------------------------------------
// parameter gradient (_grad_body) of the tile from dl (R, A), dv (R) in
// shared memory, added into slab. prmT holds every weight transposed (the
// same offsets), so a product with W^T reads rows of it.
// ---------------------------------------------------------------------------
PN_HD void grad_tile(const Net& n, const Lay& l, const Ctx& c, int nr,
                     const float* __restrict__ prm, const float* __restrict__ prmT,
                     float* slab) {
  float* sm = c.sm;
  const int P = n.P, hp = n.hp, A = n.A, H = n.H, G = n.G();
  const int S = nr * P, T = n.T(), XW = n.XW(), LH = n.L * H;
  const int DXW = T > H ? T : H;
  float *dl = sm + l.dl, *dv = sm + l.dv, *phi = sm + l.phi, *gb = sm + l.gb,
        *xs = sm + l.xs, *zs = sm + l.zs, *dphi = sm + l.dphi, *dx = sm + l.dx,
        *dz = sm + l.dz, *dg = sm + l.dg, *t1 = sm + l.t1, *rest = sm + l.rest;
  const float* xl = xs + T + (n.L - 1) * H;

  // heads: scores_i = phi_i . g, the option and value linears
  for (int it = c.tid; it < nr * hp; it += c.nthr) {
    const int r = it / hp, k = it % hp;
    float s = 0.0f;
    for (int i = 0; i < P; ++i) s += dl[r * A + i] * phi[(r * P + i) * hp + k];
    dg[it] = s;
  }
  for (int it = c.tid; it < S * hp; it += c.nthr) {
    const int s = it / hp, k = it % hp, r = s / P, i = s % P;
    dphi[it] = dl[r * A + i] * gb[r * hp + k];
  }
  PN_SYNC();
  acc_outer(c, xl, XW, nr, H, dg, hp, hp, slab + n.off[W_PTR]);
  acc_outer(c, xl, XW, nr, H, dl, A, n.n_opt, slab + n.off[W_PI]);
  acc_bias(c, dl, A, nr, n.n_opt, slab + n.off[B_PI]);
  acc_outer(c, xl, XW, nr, H, dv, 1, 1, slab + n.off[W_V]);
  acc_bias(c, dv, 1, nr, 1, slab + n.off[B_V]);
  // dx = dg W_ptr^T + d_opt W_pi^T + dv W_v^T
  mm<false, false>(c, dg, hp, nr, hp, prmT + n.off[W_PTR], H, H, dx, DXW, nullptr);
  PN_SYNC();
  mm<false, true>(c, dl, A, nr, n.n_opt, prmT + n.off[W_PI], H, H, dx, DXW, nullptr);
  PN_SYNC();
  mm<false, true>(c, dv, 1, nr, 1, prmT + n.off[W_V], H, H, dx, DXW, nullptr);
  PN_SYNC();

  // trunk, last layer first
  for (int i = n.L - 1; i >= 0; --i) {
    for (int it = c.tid; it < nr * H; it += c.nthr) {
      const int r = it / H, col = it % H;
      dz[it] = dx[r * DXW + col] * dgelu(zs[r * LH + i * H + col]);
    }
    PN_SYNC();
    const int iw = n.in_w(i);
    acc_outer(c, xs + n.in_col(i), XW, nr, iw, dz, H, H, slab + n.off[W_TRUNK + 2 * i]);
    acc_bias(c, dz, H, nr, H, slab + n.off[W_TRUNK + 2 * i + 1]);
    mm<false, false>(c, dz, H, nr, H, prmT + n.off[W_TRUNK + 2 * i], iw, iw, dx, DXW,
                     nullptr);
    PN_SYNC();
  }
  // pool and self embedding back to the seats
  for (int it = c.tid; it < S * hp; it += c.nthr) {
    const int s = it / hp, k = it % hp, r = s / P, i = s % P;
    dphi[it] += dx[r * DXW + k] * (1.0f / P) + rest[r * G + i] * dx[r * DXW + hp + k];
  }
  PN_SYNC();

  if (n.attn) {
    float *o = sm + l.o, *qkv = sm + l.qkv, *att = sm + l.att, *hb = sm + l.hb,
          *hn = sm + l.hn, *inv = sm + l.inv, *dA = sm + l.dA, *dqkv = sm + l.dqkv,
          *m12 = sm + l.m12;
    float* d_o = t1;
    // residual: phi = e + o W_ao
    acc_outer(c, o, hp, S, hp, dphi, hp, hp, slab + n.off[W_AO]);
    mm<false, false>(c, dphi, hp, S, hp, prmT + n.off[W_AO], hp, hp, d_o, hp, nullptr);
    PN_SYNC();
    const float scale = 1.0f / sqrtf((float)hp);
    for (int it = c.tid; it < S * P; it += c.nthr) {  // d_a[s][j] = d_o_s . w_j
      const int s = it / P, j = it % P, r = s / P;
      const float* w = qkv + (r * P + j) * 3 * hp + 2 * hp;
      float d = 0.0f;
      for (int k = 0; k < hp; ++k) d += d_o[s * hp + k] * w[k];
      dA[it] = d;
    }
    PN_SYNC();
    for (int s = c.tid; s < S; s += c.nthr) {  // softmax backward, in place
      float inner = 0.0f;
      for (int j = 0; j < P; ++j) inner += att[s * P + j] * dA[s * P + j];
      for (int j = 0; j < P; ++j) dA[s * P + j] = att[s * P + j] * (dA[s * P + j] - inner);
    }
    PN_SYNC();
    for (int it = c.tid; it < S * hp; it += c.nthr) {
      const int s = it / hp, k = it % hp, r = s / P, j = s % P;
      // dq of query s; dk and dw of key s (= seat j of row r)
      float dq = 0.0f, dk = 0.0f, dw = 0.0f;
      for (int m = 0; m < P; ++m) {
        const int sm_ = r * P + m;
        dq += dA[s * P + m] * qkv[sm_ * 3 * hp + hp + k];
        dk += dA[sm_ * P + j] * qkv[sm_ * 3 * hp + k];
        dw += bfr(att[sm_ * P + j]) * d_o[sm_ * hp + k];
      }
      dqkv[s * 3 * hp + k] = dq * scale;
      dqkv[s * 3 * hp + hp + k] = dk * scale;
      dqkv[s * 3 * hp + 2 * hp + k] = dw;
    }
    PN_SYNC();
    acc_outer(c, hb, hp, S, hp, dqkv, 3 * hp, 3 * hp, slab + n.off[W_QKV]);
    float* dh = d_o;  // d_o is dead from here
    mm<false, false>(c, dqkv, 3 * hp, S, 3 * hp, prmT + n.off[W_QKV], hp, hp, dh, hp,
                     nullptr);
    PN_SYNC();
    const float* ln_s = prm + n.off[LN_S];
    for (int k = c.tid; k < hp; k += c.nthr) {
      float gs = 0.0f, gbias = 0.0f;
      for (int s = 0; s < S; ++s) {
        gs += dh[s * hp + k] * hn[s * hp + k];
        gbias += dh[s * hp + k];
      }
      slab[n.off[LN_S] + k] += gs;
      slab[n.off[LN_B] + k] += gbias;
    }
    for (int s = c.tid; s < S; s += c.nthr) {
      float m1 = 0.0f, m2 = 0.0f;
      for (int k = 0; k < hp; ++k) {
        const float dhn = dh[s * hp + k] * ln_s[k];
        m1 += dhn;
        m2 += dhn * hn[s * hp + k];
      }
      m12[2 * s] = m1 / hp;
      m12[2 * s + 1] = m2 / hp;
    }
    PN_SYNC();
    for (int it = c.tid; it < S * hp; it += c.nthr) {  // d_e = dphi + LayerNorm path
      const int s = it / hp, k = it % hp;
      const float dhn = dh[it] * ln_s[k];
      dphi[it] += inv[s] * (dhn - m12[2 * s] - hn[it] * m12[2 * s + 1]);
    }
    PN_SYNC();
  }

  // seat encoder: dz1 = d_e gelu'(z1) (in place), then w_phi1, then dz0
  float *z0 = sm + l.z0, *p0 = sm + l.p0, *z1 = sm + l.z1, *xin = sm + l.xin;
  for (int it = c.tid; it < S * hp; it += c.nthr) dphi[it] *= dgelu(z1[it]);
  PN_SYNC();
  acc_outer(c, p0, hp, S, hp, dphi, hp, hp, slab + n.off[W_PHI1]);
  acc_bias(c, dphi, hp, S, hp, slab + n.off[B_PHI1]);
  mm<false, false>(c, dphi, hp, S, hp, prmT + n.off[W_PHI1], hp, hp, t1, hp, nullptr);
  PN_SYNC();
  for (int it = c.tid; it < S * hp; it += c.nthr) t1[it] *= dgelu(z0[it]);
  PN_SYNC();
  acc_outer(c, xin, n.F0, S, n.F0, t1, hp, hp, slab + n.off[W_PHI0]);
  acc_bias(c, t1, hp, S, hp, slab + n.off[B_PHI0]);
  PN_SYNC();
}

// ---------------------------------------------------------------------------
// one tile of K3: the forward, the given cotangents rowin (rows, A + 1) =
// dl | dv, then the gradient into slab
// ---------------------------------------------------------------------------
PN_HD void grad_rows(const Net& n, const Lay& l, const Ctx& c,
                     const uint16_t* __restrict__ obs, int64_t row0, int nr,
                     const float* __restrict__ rowin, const float* __restrict__ prm,
                     const float* __restrict__ prmB, const float* __restrict__ prmT,
                     float* slab) {
  fwd_tile(n, l, c, obs, row0, nr, prm, prmB);
  const int A = n.A;
  for (int it = c.tid; it < nr * (A + 1); it += c.nthr) {
    const int r = it / (A + 1), a = it % (A + 1);
    const float v = rowin[(row0 + r) * (A + 1) + a];
    if (a < A) {
      c.sm[l.dl + r * A + a] = v;
    } else {
      c.sm[l.dv + r] = v;
    }
  }
  PN_SYNC();
  grad_tile(n, l, c, nr, prm, prmT, slab);
}

}  // namespace pn
