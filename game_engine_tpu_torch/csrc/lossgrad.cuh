// lossgrad.cuh — the deepsets/attn policy net as a pipeline of stages over a
// chunk of rows: the forward (K2), the parameter gradient of given
// cotangents (K3) and the one-pass PPO loss-grad (K4). Shared by the CUDA
// kernels (lossgrad.cu, tensor-core products) and the g++ host harness
// (lossgrad_host.cpp, plain loops), which run the same stages in the same
// order on the same buffer layout; only the products and the column sums
// add in another order.
//
// Counterparts in game_engine_tpu/policies/fused.py: _run_fwd :299
// (run_forward here), _run_bwd :468 (run_grad with the caller's dl | dv) and
// _run_lossgrad :600 (run_grad with the PPO rows); bodies _fwd_body :154,
// _grad_body :329, _lossgrad_kernel :508. For every row: the forward with
// _fwd_body's cast points; for K4 the legal-masked log-softmax, the
// clipped-PPO + value + entropy cotangents with lax.min's tie rule and the
// four loss sums; for K3 and K4 the parameter gradient summed over all rows.
// All three run the same forward stages (forward_chunk), so they cannot
// drift apart.
//
// Design (what bounds the work: the products, ~5.1 MFLOP a row at the attn
// net's width, against ~0.4 KB of input a row):
// - Every matrix product runs on the tensor cores (bf16 mma.sync with f32
//   accumulation, lossgrad.cu). A row chunk's seat-rows (or rows) are the
//   M dimension, so the weights are read once per 128 seat-rows.
// - Forward products take operands that _fwd_body has already rounded to
//   bf16, so one bf16 product is exact up to summation order.
// - Backward products have one f32 cotangent operand and one operand that
//   is exactly bf16 (a bf16-rounded weight or activation). The cotangent is
//   split as hi = bf16(x), lo = bf16(x - hi) and both halves are multiplied:
//   two products give x to about 2^-16 of |x|. (The third product of a
//   split-bf16 scheme, lo * lo, is zero when the other operand is exact.)
// - Weight gradients dW = X^T dY contract over the chunk's rows, split into
//   nsplit row ranges; each range adds into its own f32 slab of the whole
//   gradient, and a last pass sums the slabs in split order. No atomics:
//   the same (chunk, nsplit) gives the same bits.
// - The intermediates a backward stage needs are written to a scratch
//   buffer in device memory (f32 where _fwd_body keeps f32, bf16 where it
//   rounds); about 79 KB a row at the attn net's width, so the wrapper
//   sizes the chunk to the scratch it can spare. The forward alone keeps
//   only what its own later stages read: about 28 KB a row.
// - The weights are packed to bf16 (forward and transposed) into a buffer
//   of their own by pack_weights; the caller keeps it while the parameters
//   are unchanged, so the 33 forwards of a train step pack once.
// - The small per-room products of the attention (8 x 8 scores, the mixing
//   and their backward) have no bf16-rounded operand and stay in f32 on the
//   CUDA cores, one thread per seat-row.
// - Any width. The products, the packed weights and the scratch hold the
//   encoder and trunk widths padded to multiples of 32 (Net::hpp, Hp): a
//   padded weight row or column, bias and LayerNorm affine is zero, so a
//   padded activation is zero too. The true widths hp and H stay where
//   they enter the arithmetic (the LayerNorm's sums and divisors, forward
//   and backward, and the attention scale 1/sqrt(hp), as in _fwd_body and
//   _grad_body), bound every read of the flat parameters, and shape every
//   gradient (Target, Colsum).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

// LG_HD marks functions compiled for both the device (nvcc) and the host
// harness (g++, csrc/lossgrad_host.cpp).
#ifdef __CUDACC__
#define LG_HD __host__ __device__ inline
#else
#define LG_HD inline
#endif

namespace lg {

constexpr int N_STATS = 4;  // K4's sums: pg*w, 0.5 (v-ret)^2 vrow, ent*w, ratio*w

// parameter slots; W_TRUNK is the trunk's first weight (Net::tw, tb give
// every layer's weight and bias)
enum { W_PHI0, B_PHI0, W_PHI1, B_PHI1, LN_S, LN_B, W_QKV, W_AO, W_PTR,
       W_PI, B_PI, W_V, B_V, W_TRUNK };
constexpr int N_SLOTS = W_TRUNK + 1;
constexpr int META_INTS = 10 + N_SLOTS;

LG_HD int rup(int x, int m) { return (x + m - 1) / m * m; }

// The net's true dims, its storage widths and the float offset of each
// parameter in the flat parameter buffer (and in the gradient slab, which
// has the same layout). hp and H are the widths of the arithmetic (the
// LayerNorm's divisor, the attention scale); every product, packed weight
// and scratch buffer holds the encoder and trunk columns padded with zeros
// to hpp = rup(hp, 32) and Hp = rup(H, 32). The trunk's layers follow one
// another in the flat buffer (w0 T x H, b0, then H x H and H a layer), so a
// layer's offsets come from the first one's: any depth, no table.
struct Net {
  int P, F0, NP, hp, H, L, n_opt, A, attn, n_params;
  int hpp, Hp;
  int off[N_SLOTS];
  LG_HD int G() const { return P + NP + 1; }
  LG_HD int F() const { return P * F0 + G(); }
  LG_HD int T() const { return 2 * hp + NP + 1; }   // trunk input width
  // the float offsets of trunk layer i's weight and bias
  LG_HD int tw(int i) const {
    return i == 0 ? off[W_TRUNK] : off[W_TRUNK] + (T() + 1) * H + (i - 1) * (H + 1) * H;
  }
  LG_HD int tb(int i) const { return tw(i) + (i ? H : T()) * H; }
};

// meta = [P, F0, NP, hp, H, L, n_opt, A, attn, n_params, off[0..N_SLOTS)]
LG_HD Net net_from_meta(const int32_t* m) {
  Net n;
  n.P = m[0]; n.F0 = m[1]; n.NP = m[2]; n.hp = m[3]; n.H = m[4]; n.L = m[5];
  n.n_opt = m[6]; n.A = m[7]; n.attn = m[8]; n.n_params = m[9];
  n.hpp = rup(n.hp, 32);
  n.Hp = rup(n.H, 32);
  for (int i = 0; i < N_SLOTS; ++i) n.off[i] = m[10 + i];
  return n;
}

// round to the nearest bf16 (ties to even), returned as f32
LG_HD float bfr(float x) {
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

LG_HD float bf16_bits_to_float(uint16_t b) {
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

LG_HD float gelu(float x) {
  const float u = SQRT2OPI * (x + GELU_C * x * x * x);
  return 0.5f * x * (1.0f + tanhf(u));
}

LG_HD float dgelu(float x) {
  const float u = SQRT2OPI * (x + GELU_C * x * x * x);
  const float t = tanhf(u);
  const float du = SQRT2OPI * (1.0f + 3.0f * GELU_C * x * x);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
}

constexpr int MAX_A = 64;   // actions Loss holds in registers (more: Loss<true>, in dl)
constexpr int MAX_P = 32;   // seats AttnMix, AttnBwd2 hold in registers (more: the Wide stages)
constexpr int BK = 32;      // K of every product is padded to this multiple

LG_HD uint16_t bf16_bits(float x) {
  const float y = bfr(x);
  uint32_t u;
#ifdef __CUDA_ARCH__
  u = __float_as_uint(y);
#else
  memcpy(&u, &y, 4);
#endif
  return (uint16_t)(u >> 16);
}

// v = p[0..4): one 16-byte load on the device (p 16-byte aligned, as every
// row of the scratch buffers is), four loads on the host
LG_HD void ld4(const float* p, float v[4]) {
#ifdef __CUDA_ARCH__
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
#else
  for (int j = 0; j < 4; ++j) v[j] = p[j];
#endif
}

// sum_k a[k] b[k] over k < n (n a multiple of 4), added in k order
LG_HD float dot4(const float* a, const float* b, int n) {
  float d = 0.0f;
  for (int k = 0; k < n; k += 4) {
    float x[4], y[4];
    ld4(a + k, x);
    ld4(b + k, y);
    for (int j = 0; j < 4; ++j) d += x[j] * y[j];
  }
  return d;
}

// x as hi + lo, two bf16 values (hi = bf16(x), lo = bf16(x - hi))
LG_HD void split_store(float x, uint16_t* hi, uint16_t* lo, int64_t i) {
  const uint16_t h = bf16_bits(x);
  hi[i] = h;
  lo[i] = bf16_bits(x - bf16_bits_to_float(h));
}

// ---------------------------------------------------------------------------
// layout: the packed bf16 weights (byte offsets from the weight buffer's
// base), and the scratch: the gradient slabs, then the buffers of one chunk
// of rows (byte offsets from the scratch base). A forward-only layout gives
// no room to what only a backward reads or writes: those offsets are then
// not to be used.
// ---------------------------------------------------------------------------
struct Lay {
  int64_t chunk;          // rows per chunk
  int nsplit;             // row ranges of a weight-gradient product
  int F0p, Tp, Nh, ng;    // padded widths; gradient floats (params + stats)
  // packed weights: forward (K x N) and transposed (N x K), bf16
  int64_t w0, w1, w1t, wqkv, wqkvt, wao, waot, wh, wht;
  int64_t wt0, wtt0;      // the trunk's first layer (Tp x Hp)
  int64_t wr, wstep;      // layer i >= 1 (Hp x Hp): at wr + (i - 1) wstep, then its transpose
  int64_t w_end;          // bytes of the weight buffer
  LG_HD int64_t wt(int i) const { return i ? wr + (i - 1) * wstep : wt0; }
  LG_HD int64_t wtt(int i) const { return i ? wr + (i - 1) * wstep + wstep / 2 : wtt0; }
  int64_t slabs;          // nsplit x ng f32
  // chunk buffers
  int64_t x0, z0, p0, z1, e, hn, mu, inv, m12, dl, hb, qkv, att, dS, ob, phib, tb, zt, xb, heads,
      dHh, dHl, stats, dphi, dphh, dphl, dzh[2], dzl[2], dt, d_o, dqh, dql, dh, dz1h,
      dz1l, dz0h, dz0l;
  int64_t total;          // bytes of the scratch
};

LG_HD int64_t take(int64_t& at, int64_t bytes) {
  const int64_t o = at;
  at += (bytes + 255) / 256 * 256;
  return o;
}

LG_HD Lay layout(const Net& n, int64_t chunk, int nsplit, bool fwd_only) {
  Lay g;
  const int hp = n.hpp, H = n.Hp, P = n.P;  // storage widths
  const int64_t R = chunk, S = (int64_t)P * chunk;
  const int64_t a = n.attn ? 1 : 0;
  const int64_t b = fwd_only ? 0 : 1;  // buffers of the backward
  const int64_t B2 = 2, F4 = 4;  // bytes of bf16, f32
  g.chunk = chunk;
  g.nsplit = nsplit;
  g.F0p = rup(n.F0, BK);
  g.Tp = rup(n.T(), BK);
  g.Nh = rup(hp + n.n_opt + 1, BK);
  g.ng = n.n_params + N_STATS;
  int64_t at = 0;
  g.w0 = take(at, B2 * g.F0p * hp);
  g.w1 = take(at, B2 * hp * hp);
  g.w1t = take(at, B2 * hp * hp);
  g.wqkv = take(at, a * B2 * hp * 3 * hp);
  g.wqkvt = take(at, a * B2 * hp * 3 * hp);
  g.wao = take(at, a * B2 * hp * hp);
  g.waot = take(at, a * B2 * hp * hp);
  g.wh = take(at, B2 * H * g.Nh);
  g.wht = take(at, B2 * H * g.Nh);
  g.wt0 = take(at, B2 * g.Tp * H);
  g.wtt0 = take(at, B2 * g.Tp * H);
  g.wstep = 2 * ((B2 * H * H + 255) / 256 * 256);
  g.wr = at;
  at += (int64_t)(n.L - 1) * g.wstep;
  g.w_end = at;
  at = 0;
  g.slabs = take(at, b * F4 * nsplit * g.ng);
  g.x0 = take(at, B2 * S * g.F0p);
  g.z0 = take(at, b * F4 * S * hp);
  g.p0 = take(at, B2 * S * hp);
  g.z1 = take(at, b * F4 * S * hp);
  g.e = take(at, a * F4 * S * hp);
  g.hn = take(at, b * a * F4 * S * hp);
  g.mu = take(at, a * F4 * S);
  g.inv = take(at, a * F4 * S);
  g.m12 = take(at, b * a * F4 * S * 2);
  g.dl = take(at, b * F4 * R * n.A);
  g.hb = take(at, a * B2 * S * hp);
  g.qkv = take(at, a * F4 * S * 3 * hp);
  g.att = take(at, a * F4 * S * P);
  g.dS = take(at, b * a * F4 * S * P);
  g.ob = take(at, a * B2 * S * hp);
  g.phib = take(at, B2 * S * hp);
  g.tb = take(at, B2 * R * g.Tp);
  g.zt = take(at, b * F4 * n.L * R * H);
  g.xb = take(at, B2 * n.L * R * H);
  g.heads = take(at, F4 * R * g.Nh);
  g.dHh = take(at, b * B2 * R * g.Nh);
  g.dHl = take(at, b * B2 * R * g.Nh);
  g.stats = take(at, b * F4 * R * N_STATS);
  g.dphi = take(at, b * F4 * S * hp);
  g.dphh = take(at, b * a * B2 * S * hp);
  g.dphl = take(at, b * a * B2 * S * hp);
  for (int i = 0; i < 2; ++i) {
    g.dzh[i] = take(at, b * B2 * R * H);
    g.dzl[i] = take(at, b * B2 * R * H);
  }
  g.dt = take(at, b * F4 * R * g.Tp);
  g.d_o = take(at, b * a * F4 * S * hp);
  g.dqh = take(at, b * a * B2 * S * 3 * hp);
  g.dql = take(at, b * a * B2 * S * 3 * hp);
  g.dh = g.qkv;  // qkv is dead once the attention backward has run
  g.dz1h = take(at, b * B2 * S * hp);
  g.dz1l = take(at, b * B2 * S * hp);
  g.dz0h = take(at, b * B2 * S * hp);
  g.dz0l = take(at, b * B2 * S * hp);
  g.total = at;
  return g;
}

// the chunk's buffers as typed pointers
struct Bufs {
  uint16_t *x0, *p0, *hb, *ob, *phib, *tb, *xb, *dHh, *dHl, *dphh, *dphl, *dzh[2], *dzl[2],
      *dqh, *dql, *dz1h, *dz1l, *dz0h, *dz0l;
  float *z0, *z1, *e, *hn, *mu, *inv, *m12, *dl, *qkv, *att, *dS, *zt, *heads, *stats, *dphi, *dt, *d_o, *dh;
};

inline Bufs bufs(const Lay& g, char* base) {
  Bufs b;
  auto h = [&](int64_t o) { return (uint16_t*)(base + o); };
  auto f = [&](int64_t o) { return (float*)(base + o); };
  b.x0 = h(g.x0); b.p0 = h(g.p0); b.hb = h(g.hb); b.ob = h(g.ob); b.phib = h(g.phib);
  b.tb = h(g.tb); b.xb = h(g.xb); b.dHh = h(g.dHh); b.dHl = h(g.dHl);
  b.dphh = h(g.dphh); b.dphl = h(g.dphl);
  for (int i = 0; i < 2; ++i) { b.dzh[i] = h(g.dzh[i]); b.dzl[i] = h(g.dzl[i]); }
  b.dqh = h(g.dqh); b.dql = h(g.dql); b.dz1h = h(g.dz1h); b.dz1l = h(g.dz1l);
  b.dz0h = h(g.dz0h); b.dz0l = h(g.dz0l);
  b.z0 = f(g.z0); b.z1 = f(g.z1); b.e = f(g.e); b.hn = f(g.hn); b.mu = f(g.mu); b.inv = f(g.inv);
  b.m12 = f(g.m12); b.dl = f(g.dl);
  b.qkv = f(g.qkv); b.att = f(g.att); b.dS = f(g.dS); b.zt = f(g.zt);
  b.heads = f(g.heads); b.stats = f(g.stats); b.dphi = f(g.dphi); b.dt = f(g.dt);
  b.d_o = f(g.d_o); b.dh = f(g.dh);
  return b;
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------

// What a product's epilogue does with C[row][col] = v (at row * ld + col).
enum EpiMode {
  E_ACT,    // z = v + bias: zf = z, actf = gelu(z), actb = bf16(gelu(z)) (each if set)
  E_F32,    // zf = v
  E_PHI,    // actb = bf16(aux + v): the attention residual
  E_DGELU,  // hi, lo = split(v * gelu'(aux)): a cotangent through a gelu
};

struct Epi {
  int mode, ld;
  const float* bias;  // nb floats: the product's true columns
  int nb;
  const float* aux;
  float* zf;
  float* actf;
  uint16_t* actb;
  uint16_t* hi;
  uint16_t* lo;
};

// 8 consecutive floats at p (16-byte aligned): two 16-byte accesses on the
// device, eight on the host
LG_HD void ld8(const float* p, float v[8]) {
  ld4(p, v);
  ld4(p + 4, v + 4);
}

LG_HD void st8(float* p, const float v[8]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
#else
  for (int j = 0; j < 8; ++j) p[j] = v[j];
#endif
}

LG_HD void st8_bf16(uint16_t* p, const uint16_t h[8]) {
#ifdef __CUDA_ARCH__
  uint4 u;
  u.x = h[0] | ((unsigned)h[1] << 16);
  u.y = h[2] | ((unsigned)h[3] << 16);
  u.z = h[4] | ((unsigned)h[5] << 16);
  u.w = h[6] | ((unsigned)h[7] << 16);
  *reinterpret_cast<uint4*>(p) = u;
#else
  for (int j = 0; j < 8; ++j) p[j] = h[j];
#endif
}

// the epilogue of C[row][col + j] = v[j], j < 8 (N and every leading
// dimension are multiples of 8, so the 8 columns are in or out together)
LG_HD void epi_apply8(const Epi& e, int64_t row, int col, float v[8]) {
  const int64_t i = row * e.ld + col;
  uint16_t h[8], l[8];
  if (e.mode == E_ACT) {
    for (int j = 0; j < 8; ++j) v[j] += e.bias && col + j < e.nb ? e.bias[col + j] : 0.0f;
    if (e.zf) st8(e.zf + i, v);
    float a[8];
    for (int j = 0; j < 8; ++j) a[j] = gelu(v[j]);
    if (e.actf) st8(e.actf + i, a);
    if (e.actb) {
      for (int j = 0; j < 8; ++j) h[j] = bf16_bits(a[j]);
      st8_bf16(e.actb + i, h);
    }
  } else if (e.mode == E_F32) {
    st8(e.zf + i, v);
  } else if (e.mode == E_PHI) {
    float x[8];
    ld8(e.aux + i, x);
    for (int j = 0; j < 8; ++j) h[j] = bf16_bits(x[j] + v[j]);
    st8_bf16(e.actb + i, h);
  } else {
    float z[8];
    ld8(e.aux + i, z);
    for (int j = 0; j < 8; ++j) {
      const float x = v[j] * dgelu(z[j]);
      h[j] = bf16_bits(x);
      l[j] = bf16_bits(x - bf16_bits_to_float(h[j]));
    }
    st8_bf16(e.hi + i, h);
    st8_bf16(e.lo + i, l);
  }
}

// C (M x N) = sum_p A_p (M x K) B (K x N), all bf16, row-major; K is a
// multiple of BK and the columns of A past the real width are zero.
struct Gemm {
  const uint16_t* A[2];
  int npair;  // 1, or 2 for a split cotangent (hi, lo)
  int lda;
  const uint16_t* B;
  int ldb;
  int64_t M;
  int N, K;
  Epi epi;
};

// Where a weight gradient lands in the slab: product column c of segment
// s (c0[s] <= c < c1[s]) is parameter column c - c0[s] of the matrix at
// w_off[s] (row stride w_ld[s]) and of the bias at b_off[s] (-1: none).
// Product rows k >= Kr are padding.
struct Target {
  int Kr, nseg;
  int c0[3], c1[3], w_off[3], w_ld[3], b_off[3];
};

// slab[split] += X^T (Y_hi + Y_lo) over split's share of the M rows, and
// the column sums of Y_hi + Y_lo into the biases: dW = X^T dY, db = sum dY.
struct Wgrad {
  const uint16_t* X;
  int ldx, K;
  const uint16_t* Y[2];
  int ldy, N;
  int64_t M;
  Target t;
  float* slabs;
  int ng, nsplit;
};

// rows [r0, r1) of split s of M rows: whole multiples of BK per split
LG_HD void split_rows(int64_t M, int nsplit, int s, int64_t* r0, int64_t* r1) {
  int64_t per = (M + nsplit - 1) / nsplit;
  per = (per + BK - 1) / BK * BK;
  *r0 = s * per < M ? s * per : M;
  *r1 = (s + 1) * per < M ? (s + 1) * per : M;
}

// the slab index of product element (k, c), or -1
LG_HD int target_index(const Target& t, int k, int c) {
  if (k >= t.Kr) return -1;
  for (int s = 0; s < t.nseg; ++s)
    if (c >= t.c0[s] && c < t.c1[s]) return t.w_off[s] + k * t.w_ld[s] + (c - t.c0[s]);
  return -1;
}

LG_HD int target_bias(const Target& t, int c) {
  for (int s = 0; s < t.nseg; ++s)
    if (c >= t.c0[s] && c < t.c1[s]) return t.b_off[s] < 0 ? -1 : t.b_off[s] + (c - t.c0[s]);
  return -1;
}

// slab[split][uv_off + c] += sum_rows U * V, slab[split][u_off + c] +=
// sum_rows U over split's share of the M rows (either offset -1: skip)
struct Colsum {
  const float* U;
  const float* V;
  int ld, N;
  int64_t M;
  int uv_off, u_off;
  float* slabs;
  int ng, nsplit;
};

// ---------------------------------------------------------------------------
// per-item stages (one call per row r or seat-row s of the chunk)
// ---------------------------------------------------------------------------

// a weight matrix (K x N f32 at prm + src, row stride lds) into its bf16
// forward (dst, row stride ldd, from column col0) and transposed (dstT, row
// stride ldt, from row col0) packings; item = one element
struct PackW {
  const float* prm;
  int src, lds, K, N, col0, ldd, ldt;
  uint16_t* dst;
  uint16_t* dstT;
  LG_HD void operator()(int64_t i) const {
    const int k = (int)(i / N), c = (int)(i % N);
    const uint16_t v = bf16_bits(prm[src + (int64_t)k * lds + c]);
    dst[(int64_t)k * ldd + col0 + c] = v;
    if (dstT) dstT[(int64_t)(col0 + c) * ldt + k] = v;
  }
};

// the (P, F0) room view of each seat-row, padded with zeros to F0p
struct Prep {
  Net n;
  const uint16_t* obs;
  uint16_t* x0;
  int F0p;
  LG_HD void operator()(int64_t s) const {
    const int64_t r = s / n.P;
    const int i = (int)(s % n.P);
    const uint16_t* src = obs + r * n.F() + i * n.F0;
    for (int f = 0; f < F0p; ++f) x0[s * F0p + f] = f < n.F0 ? src[f] : (uint16_t)0;
  }
};

// LayerNorm of bf16(e) (eps 1e-5), first half: the mean and 1/sigma of
// seat-row s
struct LnStats {
  Net n;
  const float* e;
  float* mu;
  float* inv;
  LG_HD void operator()(int64_t s) const {
    const int hp = n.hp;  // the true width: a padded column would add m^2 to var
    const float* es = e + s * n.hpp;
    float m = 0.0f;
    int k = 0;
    for (; k + 4 <= hp; k += 4) {
      float x[4];
      ld4(es + k, x);
      for (int j = 0; j < 4; ++j) m += bfr(x[j]);
    }
    for (; k < hp; ++k) m += bfr(es[k]);
    m /= hp;
    float var = 0.0f;
    for (k = 0; k + 4 <= hp; k += 4) {
      float x[4];
      ld4(es + k, x);
      for (int j = 0; j < 4; ++j) {
        const float d = bfr(x[j]) - m;
        var += d * d;
      }
    }
    for (; k < hp; ++k) {
      const float d = bfr(es[k]) - m;
      var += d * d;
    }
    var /= hp;
    mu[s] = m;
    inv[s] = 1.0f / sqrtf(var + 1e-5f);
  }
};

// second half, item = one element (s, k) of the padded width: hn (if set:
// only the backward reads it) and hb = bf16(hn ln_s + ln_b), zero past hp
struct LnApply {
  Net n;
  const float* prm;
  const float* e;
  const float* mu;
  const float* inv;
  float* hn;
  uint16_t* hb;
  LG_HD void operator()(int64_t i) const {
    const int64_t s = i / n.hpp;
    const int k = (int)(i % n.hpp);
    const bool in = k < n.hp;
    const float h = in ? (bfr(e[i]) - mu[s]) * inv[s] : 0.0f;
    if (hn) hn[i] = h;
    hb[i] = in ? bf16_bits(h * prm[n.off[LN_S] + k] + prm[n.off[LN_B] + k]) : (uint16_t)0;
  }
};

// one-head attention: the scaled score q_s . k_j of query s and key j of
// its room, item = (s, j)
struct AttnScore {
  Net n;
  const float* qkv;
  float* att;
  LG_HD void operator()(int64_t it) const {
    const int P = n.P, hp = n.hpp, W = 3 * hp;  // padded columns are zero
    const int64_t s = it / P, j = s / P * P + it % P;
    att[it] = dot4(qkv + s * W, qkv + j * W + hp, hp) * (1.0f / sqrtf((float)n.hp));
  }
};

// the softmax over keys of query s's scores, in place
struct AttnSoftmax {
  Net n;
  float* att;
  LG_HD void operator()(int64_t s) const {
    float* a = att + s * n.P;
    float m = a[0];
    for (int j = 1; j < n.P; ++j) m = a[j] > m ? a[j] : m;
    float den = 0.0f;
    for (int j = 0; j < n.P; ++j) {
      a[j] = expf(a[j] - m);
      den += a[j];
    }
    for (int j = 0; j < n.P; ++j) a[j] = a[j] / den;
  }
};

// the mixing, item = (room r, k): ob[s][k] = bf16(sum_j bf16(att[s][j])
// w_j[k]) for the room's P <= MAX_P queries s, each w_j[k] loaded once
struct AttnMix {
  Net n;
  const float* qkv;
  const float* att;
  uint16_t* ob;
  LG_HD void operator()(int64_t it) const {
    const int P = n.P, hp = n.hpp, W = 3 * hp;
    const int64_t r0 = it / hp * P;
    const int k = (int)(it % hp);
    float w[MAX_P];
    for (int j = 0; j < P; ++j) w[j] = qkv[(r0 + j) * W + 2 * hp + k];
    for (int64_t s = r0; s < r0 + P; ++s) {
      float acc = 0.0f;
      for (int j = 0; j < P; ++j) acc += bfr(att[s * P + j]) * w[j];
      ob[s * hp + k] = bf16_bits(acc);
    }
  }
};

// AttnMix past MAX_P seats, item = (seat-row s, k): each w_j[k] loaded
// where it is used, a thread a query, the same sums in the same order
struct AttnMixWide {
  Net n;
  const float* qkv;
  const float* att;
  uint16_t* ob;
  LG_HD void operator()(int64_t it) const {
    const int P = n.P, hp = n.hpp, W = 3 * hp;
    const int64_t s = it / hp, r0 = s / P * P;
    const int k = (int)(it % hp);
    const float* wk = qkv + r0 * W + 2 * hp + k;
    float acc = 0.0f;
    for (int j = 0; j < P; ++j) acc += bfr(att[s * P + j]) * wk[(int64_t)j * W];
    ob[s * hp + k] = bf16_bits(acc);
  }
};

LG_HD float obs_at(const uint16_t* obs, const Net& n, int64_t r, int f) {
  return bf16_bits_to_float(obs[r * n.F() + f]);
}

// trunk input, bf16: [mean pool | viewer's own embedding | phase one-hot,
// alive | zeros to Tp]; item = (r, col)
struct Pool {
  Net n;
  const uint16_t* obs;
  const uint16_t* phib;
  uint16_t* tb;
  int Tp;
  LG_HD void operator()(int64_t it) const {
    const int P = n.P, hp = n.hp, ld = n.hpp, T = n.T(), base = P * n.F0;
    const int64_t r = it / Tp;
    const int col = (int)(it % Tp);
    const uint16_t* ph = phib + r * P * ld;
    float v = 0.0f;
    if (col < hp) {
      for (int i = 0; i < P; ++i) v += bf16_bits_to_float(ph[i * ld + col]);
      v = v * (1.0f / P);
    } else if (col < 2 * hp) {
      for (int i = 0; i < P; ++i)
        v += obs_at(obs, n, r, base + i) * bf16_bits_to_float(ph[i * ld + col - hp]);
    } else if (col < T) {
      v = obs_at(obs, n, r, base + P + col - 2 * hp);
    }
    tb[it] = bf16_bits(v);
  }
};

// The outputs of a row from its head products hd = [xb W_ptr | xb W_pi |
// xb W_v] (biases not yet added; W_ptr's hpp columns, zero past hp) and its
// seats' phi (P x hpp, bf16):
// logit a = opt_a + b_pi[a] (a < n_opt) + the pointer score of seat a
// (a < P), sum_k bf16(phi_a[k] g[k]) with g = bf16(xb W_ptr), added in k
// order; value = v + b_v. K2's output stage and K4's loss both call these.
LG_HD float head_logit(const Net& n, const float* prm, const float* hd, const uint16_t* ph,
                       int a) {
  const int hp = n.hpp;
  float v = a < n.n_opt ? hd[hp + a] + prm[n.off[B_PI] + a] : 0.0f;
  if (a < n.P) {
    float d = 0.0f;
    for (int k = 0; k < hp; k += 4) {
      float g[4];
      ld4(hd + k, g);
      for (int j = 0; j < 4; ++j)
        d += bfr(bf16_bits_to_float(ph[a * hp + k + j]) * bfr(g[j]));
    }
    v += d;
  }
  return v;
}

LG_HD float head_value(const Net& n, const float* prm, const float* hd) {
  return hd[n.hpp + n.n_opt] + prm[n.off[B_V]];
}

// the head cotangent dH = [dg | d_opt | dv | 0] of row r past the pointer
// head, as hi/lo: d_opt = the logits' cotangent dl, dv the value's.
// LossHead does the pointer head's columns.
LG_HD void head_cot(const Net& n, int Nh, const float* dl, float dv, uint16_t* dHh,
                    uint16_t* dHl, int64_t r) {
  const int hp = n.hpp, no = n.n_opt;
  const int64_t h0 = r * Nh;
  for (int a = 0; a < no; ++a) split_store(dl[a], dHh, dHl, h0 + hp + a);
  split_store(dv, dHh, dHl, h0 + hp + no);
  for (int c = hp + no + 1; c < Nh; ++c) {
    dHh[h0 + c] = 0;
    dHl[h0 + c] = 0;
  }
}

// K2's last stage, item = (r, a): logits (rows, A) and value (rows,) of
// the chunk, unmasked, into the caller's tensors
struct HeadOut {
  Net n;
  const float* prm;
  const float* heads;
  const uint16_t* phib;
  int Nh;
  float* logits;  // the chunk's first row
  float* value;
  LG_HD void operator()(int64_t it) const {
    const int64_t r = it / n.A;
    const int a = (int)(it % n.A);
    const float* hd = heads + r * Nh;
    logits[it] = head_logit(n, prm, hd, phib + r * n.P * n.hpp, a);
    if (a == 0) value[r] = head_value(n, prm, hd);
  }
};

// K3's cotangents of row r from the caller's rowin (rows, A + 1) = dl | dv:
// dl into the chunk's buffer and dH past the pointer head
struct GradIn {
  Net n;
  const float* rowin;  // the chunk's first row
  int Nh;
  float* dlo;  // (rows, A)
  uint16_t* dHh;
  uint16_t* dHl;
  LG_HD void operator()(int64_t r) const {
    const int A = n.A;
    const float* in = rowin + r * (A + 1);
    float* dl = dlo + r * A;
    for (int a = 0; a < A; ++a) dl[a] = in[a];
    head_cot(n, Nh, dl, in[A], dHh, dHl, r);
  }
};

// The PPO loss of row r (_lossgrad_kernel :521-550) from the head
// products (head_logit, head_value). Writes the row's four stats, the
// logits' cotangent dl and the head cotangent past the pointer head
// (head_cot). rowin (rows, 2A + 5) = legal | one-hot action | logp_old,
// advn, ret, wrow, vrow. The row's logits are held in registers (A <=
// MAX_A), or for Wide in the row's dl, which the last pass overwrites
// element by element after reading it.
template <bool Wide>
struct Loss {
  Net n;
  const float* prm;
  const float* heads;
  const uint16_t* phib;
  const float* rowin;  // the chunk's first row
  float clip_eps, ent_coef;
  int Nh;
  float* stats;
  float* dlo;  // (rows, A)
  uint16_t* dHh;
  uint16_t* dHl;
  LG_HD void operator()(int64_t r) const {
    const int A = n.A, RD = 2 * A + 5;
    const float* hd = heads + r * Nh;
    const uint16_t* ph = phib + r * n.P * n.hpp;
    const float* in = rowin + r * RD;
    const float* legal = in;
    const float* aoh = in + A;
    const float logp_old = in[2 * A], adv = in[2 * A + 1], ret = in[2 * A + 2];
    const float wrow = in[2 * A + 3], vrow = in[2 * A + 4];
    float lgr[Wide ? 1 : MAX_A];
    float* lg = Wide ? dlo + r * A : lgr;
    for (int a = 0; a < A; ++a) lg[a] = head_logit(n, prm, hd, ph, a);
    const float value = head_value(n, prm, hd);
    float mx = -INFINITY;
    for (int a = 0; a < A; ++a) {
      lg[a] = legal[a] > 0.0f ? lg[a] : -1e9f;
      mx = lg[a] > mx ? lg[a] : mx;
    }
    float sumex = 0.0f;
    for (int a = 0; a < A; ++a) sumex += expf(lg[a] - mx);
    const float lse = mx + logf(sumex);
    float logp = 0.0f, ent = 0.0f;
    for (int a = 0; a < A; ++a) {
      const float lp = lg[a] - lse;
      const float p = expf(lg[a] - mx) / sumex;
      logp += lp * aoh[a];
      ent -= p * lp;
    }
    const float ratio = expf(logp - logp_old);
    const float u1 = ratio * adv;
    const float lo = 1.0f - clip_eps, hi = 1.0f + clip_eps;
    const float u2 = (ratio < lo ? lo : (ratio > hi ? hi : ratio)) * adv;
    const float pg = -(u1 < u2 ? u1 : u2);
    // d pg / d logp with lax.min's tie rule (fused.py:535-540)
    const bool inband = ratio >= lo && ratio <= hi;
    const bool flows = (u1 <= u2) || inband;
    const float dpg = -adv * ratio * (flows ? 1.0f : 0.0f);
    float* dl = dlo + r * A;
    for (int a = 0; a < A; ++a) {
      const float lp = lg[a] - lse;
      const float p = expf(lg[a] - mx) / sumex;
      dl[a] = wrow * (dpg * (aoh[a] - p) + ent_coef * p * (lp + ent)) * legal[a];
    }
    const float dvv = value - ret;
    float* st = stats + r * N_STATS;
    st[0] = pg * wrow;
    st[1] = 0.5f * dvv * dvv * vrow;
    st[2] = ent * wrow;
    st[3] = ratio * wrow;
    head_cot(n, Nh, dl, vrow * dvv, dHh, dHl, r);
  }
};

// the pointer head's cotangents (scores_i = phi_i . g), item = (r, k):
// dg[k] = sum_i dl_i phi_i[k] into dH, dphi[i][k] = dl_i g[k]
struct LossHead {
  Net n;
  const float* heads;
  const uint16_t* phib;
  const float* dl;
  int Nh;
  uint16_t* dHh;
  uint16_t* dHl;
  float* dphi;
  LG_HD void operator()(int64_t it) const {
    const int P = n.P, hp = n.hpp;
    const int64_t r = it / hp;
    const int k = (int)(it % hp);
    const float g = bfr(heads[r * Nh + k]);
    float dg = 0.0f;
    for (int i = 0; i < P; ++i) {
      const float d = dl[r * n.A + i];
      dg += d * bf16_bits_to_float(phib[(r * P + i) * hp + k]);
      dphi[(r * P + i) * hp + k] = d * g;
    }
    split_store(dg, dHh, dHl, r * Nh + k);
  }
};

// the trunk input's cotangent dt back to the seats: dphi += dt_pool / P +
// viewer_i dt_self. With attention, dphi goes on (f32 and hi/lo) to the
// residual; without, phi = bf16(e) and dz1 = dphi gelu'(z1) (hi/lo).
// item = (s, k)
struct PoolBwd {
  Net n;
  const uint16_t* obs;
  const float* dt;
  int Tp;
  float* dphi;
  uint16_t* hi;
  uint16_t* lo;
  const float* z1;  // deepsets only
  LG_HD void operator()(int64_t at) const {
    const int P = n.P, hp = n.hpp;
    const int64_t s = at / hp, r = s / P;
    const int i = (int)(s % P), k = (int)(at % hp);
    const float view = obs_at(obs, n, r, P * n.F0 + i);
    const float* d = dt + r * Tp;
    // past the true width dt holds the next segment: the padded columns stay 0
    const float v = k < n.hp ? dphi[at] + d[k] * (1.0f / P) + view * d[n.hp + k] : 0.0f;
    if (n.attn) {
      dphi[at] = v;
      split_store(v, hi, lo, at);
    } else {
      split_store(v * dgelu(z1[at]), hi, lo, at);
    }
  }
};

// attention backward: d_a[s][m] = d_o_s . w_m, item = (s, m)
struct AttnDA {
  Net n;
  const float* qkv;
  const float* d_o;
  float* dS;
  LG_HD void operator()(int64_t it) const {
    const int P = n.P, hp = n.hpp;
    const int64_t s = it / P, m = s / P * P + it % P;
    dS[it] = dot4(d_o + s * hp, qkv + m * 3 * hp + 2 * hp, hp);
  }
};

// the softmax backward of query s, in place: dS = att (d_a - sum att d_a)
struct AttnSoftmaxBwd {
  Net n;
  const float* att;
  float* dS;
  LG_HD void operator()(int64_t s) const {
    const float* a = att + s * n.P;
    float* d = dS + s * n.P;
    float inner = 0.0f;
    for (int m = 0; m < n.P; ++m) inner += a[m] * d[m];
    for (int m = 0; m < n.P; ++m) d[m] = a[m] * (d[m] - inner);
  }
};

// dq, dk and dw as hi/lo (S, 3 hp), item = (room r, k): for seat j of the
// room, dq of query j, dk and dw of key j, from q, k and d_o at column k
// of the room's P <= MAX_P seat-rows, each loaded once
struct AttnBwd2 {
  Net n;
  const float* qkv;
  const float* att;
  const float* d_o;
  const float* dS;
  uint16_t* hi;
  uint16_t* lo;
  LG_HD void operator()(int64_t it) const {
    const int P = n.P, hp = n.hpp, W = 3 * hp;
    const int64_t r0 = it / hp * P;
    const int k = (int)(it % hp);
    const float scale = 1.0f / sqrtf((float)n.hp);
    float q[MAX_P], kk[MAX_P], dd[MAX_P];
    for (int m = 0; m < P; ++m) {
      q[m] = qkv[(r0 + m) * W + k];
      kk[m] = qkv[(r0 + m) * W + hp + k];
      dd[m] = d_o[(r0 + m) * hp + k];
    }
    for (int j = 0; j < P; ++j) {
      const int64_t s = r0 + j;
      float dq = 0.0f, dk = 0.0f, dw = 0.0f;
      for (int m = 0; m < P; ++m) {
        const int64_t sm = r0 + m;
        dq += dS[s * P + m] * kk[m];
        dk += dS[sm * P + j] * q[m];
        dw += bfr(att[sm * P + j]) * dd[m];
      }
      split_store(dq * scale, hi, lo, s * W + k);
      split_store(dk * scale, hi, lo, s * W + hp + k);
      split_store(dw, hi, lo, s * W + 2 * hp + k);
    }
  }
};

// AttnBwd2 past MAX_P seats, item = (seat-row s, k): seat j = s of its
// room, q, k and d_o loaded where they are used, a thread a seat, the same
// sums in the same order
struct AttnBwd2Wide {
  Net n;
  const float* qkv;
  const float* att;
  const float* d_o;
  const float* dS;
  uint16_t* hi;
  uint16_t* lo;
  LG_HD void operator()(int64_t it) const {
    const int P = n.P, hp = n.hpp, W = 3 * hp;
    const int64_t s = it / hp, r0 = s / P * P;
    const int j = (int)(s - r0), k = (int)(it % hp);
    const float scale = 1.0f / sqrtf((float)n.hp);
    float dq = 0.0f, dk = 0.0f, dw = 0.0f;
    for (int m = 0; m < P; ++m) {
      const int64_t sm = r0 + m;
      dq += dS[s * P + m] * qkv[sm * W + hp + k];
      dk += dS[sm * P + j] * qkv[sm * W + k];
      dw += bfr(att[sm * P + j]) * d_o[sm * hp + k];
    }
    split_store(dq * scale, hi, lo, s * W + k);
    split_store(dk * scale, hi, lo, s * W + hp + k);
    split_store(dw, hi, lo, s * W + 2 * hp + k);
  }
};

// LayerNorm backward from dh (the cotangent of the LayerNorm's output),
// first half: m12 = mean(dhn), mean(dhn hn) of seat-row s, dhn = dh ln_s
struct LnBwdStats {
  Net n;
  const float* prm;
  const float* dh;
  const float* hn;
  float* m12;
  LG_HD void operator()(int64_t s) const {
    const int hp = n.hp;  // the true width, as in LnStats
    const float* ln_s = prm + n.off[LN_S];
    const float* ds = dh + s * n.hpp;
    const float* hs = hn + s * n.hpp;
    float m1 = 0.0f, m2 = 0.0f;
    int k = 0;
    for (; k + 4 <= hp; k += 4) {
      float x[4], h[4];
      ld4(ds + k, x);
      ld4(hs + k, h);
      for (int j = 0; j < 4; ++j) {
        const float dhn = x[j] * ln_s[k + j];
        m1 += dhn;
        m2 += dhn * h[j];
      }
    }
    for (; k < hp; ++k) {
      const float dhn = ds[k] * ln_s[k];
      m1 += dhn;
      m2 += dhn * hs[k];
    }
    m12[2 * s] = m1 / hp;
    m12[2 * s + 1] = m2 / hp;
  }
};

// second half, item = (s, k): d_e = dphi + inv (dhn - m1 - hn m2), then
// dz1 = d_e gelu'(z1) as hi/lo
struct LnBwdApply {
  Net n;
  const float* prm;
  const float* dh;
  const float* hn;
  const float* inv;
  const float* m12;
  const float* dphi;
  const float* z1;
  uint16_t* hi;
  uint16_t* lo;
  LG_HD void operator()(int64_t at) const {
    const int64_t s = at / n.hpp;
    const int k = (int)(at % n.hpp);
    if (k >= n.hp) {  // a padded column: its cotangent is 0, not -inv m1
      split_store(0.0f, hi, lo, at);
      return;
    }
    const float dhn = dh[at] * prm[n.off[LN_S] + k];
    const float de = dphi[at] + inv[s] * (dhn - m12[2 * s] - hn[at] * m12[2 * s + 1]);
    split_store(de * dgelu(z1[at]), hi, lo, at);
  }
};

// ---------------------------------------------------------------------------
// the pipelines, for a backend BE that runs each stage: BE::each(f, count)
// calls f(i) for i < count, BE::gemm / wgrad / colsum run a product or a
// column sum, BE::memset(ptr, bytes) zeroes, BE::reduce(slabs, nsplit, ng,
// out) sums the slabs in split order. Each returns 0 or an error code.
// ---------------------------------------------------------------------------

inline Epi epi_act(int ld, const float* bias, int nb, float* zf, float* actf, uint16_t* actb) {
  return Epi{E_ACT, ld, bias, nb, nullptr, zf, actf, actb, nullptr, nullptr};
}
inline Epi epi_f32(int ld, float* out) {
  return Epi{E_F32, ld, nullptr, 0, nullptr, out, nullptr, nullptr, nullptr, nullptr};
}
inline Epi epi_phi(int ld, const float* e, uint16_t* phib) {
  return Epi{E_PHI, ld, nullptr, 0, e, nullptr, nullptr, phib, nullptr, nullptr};
}
inline Epi epi_dgelu(int ld, const float* z, uint16_t* hi, uint16_t* lo) {
  return Epi{E_DGELU, ld, nullptr, 0, z, nullptr, nullptr, nullptr, hi, lo};
}

// a forward product (one bf16 A) and a backward one (A = hi, lo)
inline Gemm fwd_gemm(const uint16_t* A, int lda, const uint16_t* B, int ldb, int64_t M, int N,
                     int K, Epi epi) {
  return Gemm{{A, nullptr}, 1, lda, B, ldb, M, N, K, epi};
}
inline Gemm bwd_gemm(const uint16_t* hi, const uint16_t* lo, int lda, const uint16_t* B,
                     int ldb, int64_t M, int N, int K, Epi epi) {
  return Gemm{{hi, lo}, 2, lda, B, ldb, M, N, K, epi};
}

// one weight matrix (and its bias, -1: none) as a whole product
inline Target whole(int Kr, int N, int w_off, int b_off) {
  Target t{};
  t.Kr = Kr;
  t.nseg = 1;
  t.c0[0] = 0;
  t.c1[0] = N;
  t.w_off[0] = w_off;
  t.w_ld[0] = N;
  t.b_off[0] = b_off;
  return t;
}

#define LG_TRY(x)             \
  do {                        \
    const int e_ = (x);       \
    if (e_ != 0) return e_;   \
  } while (0)

// the packed weights: bf16, forward and transposed, into the weight buffer
// at wbase (g.w_end bytes), every row and column past the true widths zero
// (W_qkv's q, k and w blocks each padded to hpp columns). Valid until a
// parameter changes.
template <class BE>
int pack_weights(BE& be, const Net& n, const Lay& g, const float* prm, char* wbase) {
  const int hp = n.hp, H = n.H, T = n.T(), no = n.n_opt, Nh = g.Nh;  // true widths
  const int hq = n.hpp, Hq = n.Hp;  // storage widths
  const int* off = n.off;
  auto W = [&](int64_t o) { return (uint16_t*)(wbase + o); };
  LG_TRY(be.memset(wbase, g.w_end));
  // the K x N block at off[slot] + src0 (source row stride lds)
  auto pack = [&](int slot, int src0, int lds, int K, int N, int col0, uint16_t* dst, int ldd,
                  uint16_t* dstT, int ldt) {
    return be.each(PackW{prm, off[slot] + src0, lds, K, N, col0, ldd, ldt, dst, dstT},
                   (int64_t)K * N);
  };
  LG_TRY(pack(W_PHI0, 0, hp, n.F0, hp, 0, W(g.w0), hq, nullptr, 0));
  LG_TRY(pack(W_PHI1, 0, hp, hp, hp, 0, W(g.w1), hq, W(g.w1t), hq));
  if (n.attn) {
    for (int j = 0; j < 3; ++j)
      LG_TRY(pack(W_QKV, j * hp, 3 * hp, hp, hp, j * hq, W(g.wqkv), 3 * hq, W(g.wqkvt), hq));
    LG_TRY(pack(W_AO, 0, hp, hp, hp, 0, W(g.wao), hq, W(g.waot), hq));
  }
  for (int i = 0; i < n.L; ++i)
    LG_TRY(be.each(PackW{prm, n.tw(i), H, i ? H : T, H, 0, Hq, i ? Hq : g.Tp, W(g.wt(i)),
                         W(g.wtt(i))}, (int64_t)(i ? H : T) * H));
  LG_TRY(pack(W_PTR, 0, hp, H, hp, 0, W(g.wh), Nh, W(g.wht), Hq));
  LG_TRY(pack(W_PI, 0, no, H, no, hq, W(g.wh), Nh, W(g.wht), Hq));
  return pack(W_V, 0, 1, H, 1, hq + no, W(g.wh), Nh, W(g.wht), Hq);
}

// the forward of R rows (obs oc) into the chunk's buffers: seat encoder,
// attention, pool, trunk, heads. keep: also what only the backward reads
// (the pre-activations z0, z1, zt and the LayerNorm's hn). Every product
// runs at the storage widths; a padded column has zero weights and bias,
// so it stays 0 through gelu (gelu(0) = 0) and adds nothing downstream.
template <class BE>
int forward_chunk(BE& be, const Net& n, const Lay& g, const Bufs& b, const char* wbase,
                  const uint16_t* oc, int64_t R, const float* prm, bool keep) {
  const int P = n.P, hp = n.hpp, H = n.Hp, L = n.L, Tp = g.Tp, Nh = g.Nh;  // storage widths
  const int* off = n.off;
  const int64_t S = R * P;
  auto W = [&](int64_t o) { return (const uint16_t*)(wbase + o); };
  auto xb = [&](int i) { return b.xb + (int64_t)i * g.chunk * H; };
  LG_TRY(be.each(Prep{n, oc, b.x0, g.F0p}, S));
  LG_TRY(be.gemm(fwd_gemm(b.x0, g.F0p, W(g.w0), hp, S, hp, g.F0p,
                          epi_act(hp, prm + off[B_PHI0], n.hp, keep ? b.z0 : nullptr, nullptr,
                                  b.p0))));
  LG_TRY(be.gemm(fwd_gemm(b.p0, hp, W(g.w1), hp, S, hp, hp,
                          epi_act(hp, prm + off[B_PHI1], n.hp, keep ? b.z1 : nullptr,
                                  n.attn ? b.e : nullptr, n.attn ? nullptr : b.phib))));
  if (n.attn) {
    LG_TRY(be.each(LnStats{n, b.e, b.mu, b.inv}, S));
    LG_TRY(be.each(LnApply{n, prm, b.e, b.mu, b.inv, keep ? b.hn : nullptr, b.hb}, S * hp));
    LG_TRY(be.gemm(fwd_gemm(b.hb, hp, W(g.wqkv), 3 * hp, S, 3 * hp, hp,
                            epi_f32(3 * hp, b.qkv))));
    LG_TRY(be.each(AttnScore{n, b.qkv, b.att}, S * P));
    LG_TRY(be.each(AttnSoftmax{n, b.att}, S));
    LG_TRY(P > MAX_P ? be.each(AttnMixWide{n, b.qkv, b.att, b.ob}, S * hp)
                     : be.each(AttnMix{n, b.qkv, b.att, b.ob}, R * hp));
    LG_TRY(be.gemm(fwd_gemm(b.ob, hp, W(g.wao), hp, S, hp, hp, epi_phi(hp, b.e, b.phib))));
  }
  LG_TRY(be.each(Pool{n, oc, b.phib, b.tb, Tp}, R * Tp));
  for (int i = 0; i < L; ++i) {
    const int kin = i ? H : Tp;
    float* zt = keep ? b.zt + (int64_t)i * g.chunk * H : nullptr;
    LG_TRY(be.gemm(fwd_gemm(i ? xb(i - 1) : b.tb, kin, W(g.wt(i)), H, R, H, kin,
                            epi_act(H, prm + n.tb(i), n.H, zt, nullptr, xb(i)))));
  }
  return be.gemm(fwd_gemm(xb(L - 1), H, W(g.wh), Nh, R, Nh, H, epi_f32(Nh, b.heads)));
}

// K2: logits (nrows, A) and value (nrows,) of obs (nrows, F), chunk by
// chunk through a forward-only layout g at scratch `base`
template <class BE>
int run_forward(BE& be, const Net& n, const Lay& g, const char* wbase, char* base,
                const uint16_t* obs, int64_t nrows, const float* prm, float* logits,
                float* value) {
  const Bufs b = bufs(g, base);
  for (int64_t r0 = 0; r0 < nrows; r0 += g.chunk) {
    const int64_t R = nrows - r0 < g.chunk ? nrows - r0 : g.chunk;
    LG_TRY(forward_chunk(be, n, g, b, wbase, obs + r0 * n.F(), R, prm, false));
    LG_TRY(be.each(HeadOut{n, prm, b.heads, b.phib, g.Nh, logits + r0 * n.A, value + r0},
                   R * n.A));
  }
  return 0;
}

// K3 and K4: out (n_params + 4) = the parameter gradient summed over all
// rows, then the four loss sums. ppo: rowin (nrows, 2A + 5) holds the PPO
// rows and the cotangents come from the loss (K4); else rowin (nrows,
// A + 1) = dl | dv holds the caller's cotangents and the sums are zero (K3).
template <class BE>
int run_grad(BE& be, const Net& n, const Lay& g, const char* wbase, char* base,
             const uint16_t* obs, int64_t nrows, const float* rowin, bool ppo, float clip_eps,
             float ent_coef, const float* prm, float* out) {
  // storage widths; the gradients land in the true shapes (the Targets)
  const int P = n.P, hp = n.hpp, H = n.Hp, L = n.L, T = n.T(), no = n.n_opt;
  const int Tp = g.Tp, Nh = g.Nh, RD = ppo ? 2 * n.A + 5 : n.A + 1;
  const int* off = n.off;
  auto W = [&](int64_t o) { return (const uint16_t*)(wbase + o); };
  float* slabs = (float*)(base + g.slabs);
  LG_TRY(be.memset(slabs, (int64_t)sizeof(float) * g.nsplit * g.ng));

  // the head product's columns [W_ptr (hp of hpp) | W_pi | W_v]
  Target head{};
  head.Kr = n.H;
  head.nseg = 3;
  const int hc0[3] = {0, hp, hp + no}, hc1[3] = {n.hp, hp + no, hp + no + 1};
  const int hw[3] = {off[W_PTR], off[W_PI], off[W_V]};
  const int hl[3] = {n.hp, no, 1};
  const int hb_[3] = {-1, off[B_PI], off[B_V]};
  // W_qkv's q, k and w blocks, each hp of hpp columns
  Target qkv{};
  qkv.Kr = n.hp;
  qkv.nseg = 3;
  for (int s = 0; s < 3; ++s) {
    head.c0[s] = hc0[s];
    head.c1[s] = hc1[s];
    head.w_off[s] = hw[s];
    head.w_ld[s] = hl[s];
    head.b_off[s] = hb_[s];
    qkv.c0[s] = s * hp;
    qkv.c1[s] = s * hp + n.hp;
    qkv.w_off[s] = off[W_QKV] + s * n.hp;
    qkv.w_ld[s] = 3 * n.hp;
    qkv.b_off[s] = -1;
  }

  const Bufs b = bufs(g, base);
  auto zt = [&](int i) { return b.zt + (int64_t)i * g.chunk * H; };
  auto xb = [&](int i) { return b.xb + (int64_t)i * g.chunk * H; };
  auto wgrad = [&](const uint16_t* X, int K, const uint16_t* hi, const uint16_t* lo, int N,
                   int64_t M, const Target& t) {
    return be.wgrad(Wgrad{X, K, K, {hi, lo}, N, N, M, t, slabs, g.ng, g.nsplit});
  };
  for (int64_t r0 = 0; r0 < nrows; r0 += g.chunk) {
    const int64_t R = nrows - r0 < g.chunk ? nrows - r0 : g.chunk, S = R * P;
    const uint16_t* oc = obs + r0 * n.F();
    const float* rc = rowin + r0 * RD;

    LG_TRY(forward_chunk(be, n, g, b, wbase, oc, R, prm, true));

    // the cotangents of the logits and the value: from the loss (with its
    // four sums) or from the caller
    if (ppo) {
      LG_TRY(n.A > MAX_A ? be.each(Loss<true>{n, prm, b.heads, b.phib, rc, clip_eps, ent_coef,
                                              Nh, b.stats, b.dl, b.dHh, b.dHl}, R)
                         : be.each(Loss<false>{n, prm, b.heads, b.phib, rc, clip_eps, ent_coef,
                                               Nh, b.stats, b.dl, b.dHh, b.dHl}, R));
      LG_TRY(be.colsum(Colsum{b.stats, nullptr, N_STATS, N_STATS, R, -1, n.n_params,
                              slabs, g.ng, g.nsplit}));
    } else {
      LG_TRY(be.each(GradIn{n, rc, Nh, b.dl, b.dHh, b.dHl}, R));
    }
    LG_TRY(be.each(LossHead{n, b.heads, b.phib, b.dl, Nh, b.dHh, b.dHl, b.dphi}, R * hp));

    // backward: heads, trunk (last layer first)
    LG_TRY(wgrad(xb(L - 1), H, b.dHh, b.dHl, Nh, R, head));
    int cur = 0;
    LG_TRY(be.gemm(bwd_gemm(b.dHh, b.dHl, Nh, W(g.wht), H, R, H, Nh,
                            epi_dgelu(H, zt(L - 1), b.dzh[cur], b.dzl[cur]))));
    for (int i = L - 1; i >= 0; --i) {
      const int kin = i ? H : Tp;
      LG_TRY(wgrad(i ? xb(i - 1) : b.tb, kin, b.dzh[cur], b.dzl[cur], H, R,
                   whole(i ? n.H : T, n.H, n.tw(i), n.tb(i))));
      if (i > 0) {
        LG_TRY(be.gemm(bwd_gemm(b.dzh[cur], b.dzl[cur], H, W(g.wtt(i)), H, R, H, H,
                                epi_dgelu(H, zt(i - 1), b.dzh[1 - cur], b.dzl[1 - cur]))));
        cur = 1 - cur;
      } else {
        LG_TRY(be.gemm(bwd_gemm(b.dzh[cur], b.dzl[cur], H, W(g.wtt(0)), Tp, R, Tp, H,
                                epi_f32(Tp, b.dt))));
      }
    }
    uint16_t* enc_h = n.attn ? b.dphh : b.dz1h;
    uint16_t* enc_l = n.attn ? b.dphl : b.dz1l;
    LG_TRY(be.each(PoolBwd{n, oc, b.dt, Tp, b.dphi, enc_h, enc_l, b.z1}, S * hp));

    // attention backward
    if (n.attn) {
      LG_TRY(wgrad(b.ob, hp, b.dphh, b.dphl, hp, S, whole(n.hp, n.hp, off[W_AO], -1)));
      LG_TRY(be.gemm(bwd_gemm(b.dphh, b.dphl, hp, W(g.waot), hp, S, hp, hp,
                              epi_f32(hp, b.d_o))));
      LG_TRY(be.each(AttnDA{n, b.qkv, b.d_o, b.dS}, S * P));
      LG_TRY(be.each(AttnSoftmaxBwd{n, b.att, b.dS}, S));
      LG_TRY(P > MAX_P ? be.each(AttnBwd2Wide{n, b.qkv, b.att, b.d_o, b.dS, b.dqh, b.dql}, S * hp)
                       : be.each(AttnBwd2{n, b.qkv, b.att, b.d_o, b.dS, b.dqh, b.dql}, R * hp));
      LG_TRY(wgrad(b.hb, hp, b.dqh, b.dql, 3 * hp, S, qkv));
      LG_TRY(be.gemm(bwd_gemm(b.dqh, b.dql, 3 * hp, W(g.wqkvt), hp, S, hp, 3 * hp,
                              epi_f32(hp, b.dh))));
      LG_TRY(be.colsum(Colsum{b.dh, b.hn, hp, n.hp, S, off[LN_S], off[LN_B], slabs,
                              g.ng, g.nsplit}));
      LG_TRY(be.each(LnBwdStats{n, prm, b.dh, b.hn, b.m12}, S));
      LG_TRY(be.each(LnBwdApply{n, prm, b.dh, b.hn, b.inv, b.m12, b.dphi, b.z1, b.dz1h,
                                b.dz1l}, S * hp));
    }

    // seat encoder
    LG_TRY(wgrad(b.p0, hp, b.dz1h, b.dz1l, hp, S, whole(n.hp, n.hp, off[W_PHI1],
                                                          off[B_PHI1])));
    LG_TRY(be.gemm(bwd_gemm(b.dz1h, b.dz1l, hp, W(g.w1t), hp, S, hp, hp,
                            epi_dgelu(hp, b.z0, b.dz0h, b.dz0l))));
    LG_TRY(wgrad(b.x0, g.F0p, b.dz0h, b.dz0l, hp, S, whole(n.F0, n.hp, off[W_PHI0],
                                                             off[B_PHI0])));
  }
  return be.reduce(slabs, g.nsplit, g.ng, out);
}

// what the pipeline supports (the wrapper checks the same before a launch):
// any width, seats, actions and depth of one or more trunk layers
LG_HD bool supported(const Net& n) {
  return n.P > 0 && n.A >= n.P && n.A >= n.n_opt && n.n_opt >= 1 && n.F0 > 0 && n.hp > 0 &&
         n.H > 0 && n.L >= 1;
}

}  // namespace lg
