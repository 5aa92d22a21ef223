// chat_decode.cuh — the chat LM's decode (policies/chat_lm.py): what the
// device programs of csrc/chat_decode.cu and their g++ twin
// csrc/chat_decode_host.cpp share: the packed weights' layout, the shared
// memory plans, and every piece of arithmetic whose order the two keep alike.
//
// A reply runs in two parts.
//
// The prefill takes the prompt's teacher-forced positions 0 .. n0-2 of every
// context in a batch, stacked as rows (a row is a (context, position) pair),
// through the layers a layer at a time: per layer one launch of the rows
// program (PF_ROWS rows a block: the previous layer's wo, LayerNorm, w1 and
// w2 products, then this layer's LayerNorm, qkv product, rope and K/V cache
// writes; bf16 mma.sync products) and, but after the last layer, one of the
// attention program (a warp a row and head, over the row's own context's
// keys 0..p). The last layer's attention and MLP feed nothing the decode
// reads, so they are not run. The products follow the cast points of
// decode_plain: the activation operand rounded to bf16, the weights bf16,
// float32 sums. Every mma starts from zero and its 16-deep partial is added
// to the float32 sum with a rounded add (mma_partials below).
//
// The decode takes the generated positions n0-1, n0, ... of a context on a
// cluster of CLUSTER blocks. Every block holds the full activation vectors;
// block r computes its slice of every product's outputs (slice_lo, slice_n:
// a width of a multiple of 8, the last ranks may own fewer or none) and pushes them
// into every block's exchange buffer through distributed shared memory, and
// a cluster barrier ends the exchange. LayerNorm is recomputed by every block
// on its full copy. Attention is cut into units (a head, and a contiguous
// part of its keys 0..p when the cluster has more blocks than heads): a unit
// gives its part's maximum m, its sum s of exp(score - m) and its unnormalised
// mix o; every block merges a head's parts as
//   M = max m_s,  o = (sum_s o_s e^(m_s - M)) / (sum_s s_s e^(m_s - M)),
// in the order of the parts. Rank 0 takes the argmax or the nucleus draw and
// the stop rule, and pushes the token and the stop flag to every block.
//
// The host twin runs the same stages with the lanes, warps and cluster ranks
// as loops in order, so the sums are taken in the same order; only fma
// contraction, the device's expf / tanhf and the tensor core's inner sum of
// 16 products differ.
//
// What a position computes is the JAX decoder's scan body
// (game_engine_tpu/policies/chat_lm.py _make_decoder): the token's row of the
// bf16-rounded embedding plus the float32 position row; per layer LayerNorm,
// the qkv product, rope, the K/V cache write, softmax attention over keys
// 0..pos, the mix, wo plus the residual, LayerNorm, w1 plus the tanh gelu, w2
// plus the residual and b2; then, at a generated position, the final
// LayerNorm, the tied head and the token. The decode stops at the first
// generated token below NSPECIAL or after max_new generated tokens: all that
// _finish_reply reads of the JAX decoder's full-length buffer.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define CD_HD __host__ __device__
#else
#define CD_HD
#endif
// unrolls a loop of independent loads on the card, so that several are in
// flight before the first is used; the sums keep their order
#ifdef __CUDA_ARCH__
#define CD_UNROLL(n) _Pragma(#n)
#else
#define CD_UNROLL(n)
#endif

namespace cd {

constexpr int NSPECIAL = 4;      // PAD, BOS, SEP, EOS: a generated one ends the reply
constexpr int CLUSTER = 8;       // blocks a context's decode: the portable cluster size
constexpr int LANES = 8;         // lanes that share one output of a decode product
constexpr int DEC_THREADS = 256; // a decode block
constexpr int WARPS = DEC_THREADS / 32;
constexpr int GROUPS = DEC_THREADS / LANES;  // outputs a decode block computes at once
constexpr int PF_ROWS = 32;      // prefill rows a block of the rows program
constexpr int PF_THREADS = 256;  // a prefill block: 8 warps
constexpr int PF_NC = 64;        // output columns of a product chunk
constexpr int PF_KC = 192;       // reduction depth of a product chunk
constexpr int PF_KCP = PF_KC + 8;  // its row stride in shared memory (no bank conflicts)
static_assert(CLUSTER == LANES, "lane l of an output's group pushes it to rank l");

struct Dims {
  int D, H, L, V, nl, nh;
};

CD_HD inline Dims dims_of(const int32_t* a) { return Dims{a[0], a[1], a[2], a[3], a[4], a[5]}; }

CD_HD inline int imax(int a, int b) { return a > b ? a : b; }
CD_HD inline int imin(int a, int b) { return a < b ? a : b; }
CD_HD inline int cdiv(int a, int b) { return (a + b - 1) / b; }
CD_HD inline int round8(int a) { return cdiv(a, 8) * 8; }

// D a multiple of 16 (the mma depth, and 16-byte rows of every weight), a
// head width a multiple of 4 (the mix's float4 columns) of at most a decode
// block
CD_HD inline bool dims_ok(const Dims& d) {
  return d.D > 0 && d.D % 16 == 0 && d.H == 4 * d.D && d.L >= 2 && d.V > 0 && d.V <= 4096 &&
         d.nl > 0 && d.nh > 0 && d.D % d.nh == 0 && (d.D / d.nh) % 4 == 0 &&
         d.D / d.nh <= DEC_THREADS;
}

// -- the packed weights ---------------------------------------------------------
// bf16 blob (uint16 elements): tok (V, D), the embedding and the tied head's
// rows; then a layer at a time wqkv^T (3D, D), wo^T (D, D), w1^T (H, D),
// w2^T (D, H): each product's weight transposed, an output's K weights in a
// row. f32 blob: pos (L, D), cos (L, half), sin (L, half), lnf_s, lnf_b (D
// each), then a layer at a time ln1_s, ln1_b, ln2_s, ln2_b (D each), b1 (H),
// b2 (D).

CD_HD inline int64_t wb_layer(const Dims& d) { return 4LL * d.D * d.D + 2LL * d.D * d.H; }
CD_HD inline int64_t wb_total(const Dims& d) { return (int64_t)d.V * d.D + d.nl * wb_layer(d); }
CD_HD inline int half_of(const Dims& d) { return d.D / d.nh / 2; }
CD_HD inline int64_t wf_layer(const Dims& d) { return 5LL * d.D + d.H; }
CD_HD inline int64_t wf_total(const Dims& d) {
  return (int64_t)d.L * d.D + 2LL * d.L * half_of(d) + 2LL * d.D + d.nl * wf_layer(d);
}
// each context's K/V caches: a layer at a time K (D, L), then V (L, D)
CD_HD inline int64_t kv_floats(const Dims& d) { return 2LL * d.nl * d.L * d.D; }

// The LayerNorm parameters and the biases: the f32 blob from lnf_s on, one
// contiguous run of norms_floats (the decode keeps a copy in shared memory).
CD_HD inline int64_t norms_floats(const Dims& d) { return 2LL * d.D + d.nl * wf_layer(d); }

struct Norms {
  const float* p;
  Dims d;
  CD_HD const float* lnf_s() const { return p; }
  CD_HD const float* lnf_b() const { return p + d.D; }
  CD_HD const float* lf(int i) const { return p + 2 * d.D + i * wf_layer(d); }
  CD_HD const float* ln1_s(int i) const { return lf(i); }
  CD_HD const float* ln1_b(int i) const { return lf(i) + d.D; }
  CD_HD const float* ln2_s(int i) const { return lf(i) + 2 * d.D; }
  CD_HD const float* ln2_b(int i) const { return lf(i) + 3 * d.D; }
  CD_HD const float* b1(int i) const { return lf(i) + 4 * d.D; }
  CD_HD const float* b2(int i) const { return lf(i) + 4 * d.D + d.H; }
};

struct Net {
  const uint16_t* wb;
  const float* wf;
  Dims d;
  CD_HD const uint16_t* tok() const { return wb; }
  CD_HD const uint16_t* wqkv(int i) const { return wb + (int64_t)d.V * d.D + i * wb_layer(d); }
  CD_HD const uint16_t* wo(int i) const { return wqkv(i) + 3LL * d.D * d.D; }
  CD_HD const uint16_t* w1(int i) const { return wo(i) + (int64_t)d.D * d.D; }
  CD_HD const uint16_t* w2(int i) const { return w1(i) + (int64_t)d.D * d.H; }
  CD_HD const float* pos() const { return wf; }
  CD_HD const float* cos_() const { return wf + (int64_t)d.L * d.D; }
  CD_HD const float* sin_() const { return cos_() + (int64_t)d.L * half_of(d); }
  CD_HD Norms norms() const { return Norms{sin_() + (int64_t)d.L * half_of(d), d}; }
};

// -- the prefill's scratch, rows and shared memory --------------------------------
// Scratch of R rows: X (R, D) float32, the residual between launches; Q (R,
// D) float32, the roped queries; O (R, D) bf16, the attention's output.

CD_HD inline int64_t scratch_bytes_per_row(const Dims& d) { return 10LL * d.D; }

struct Rows {
  float* X;
  float* Q;
  uint16_t* O;
  const int32_t* cp;  // (R, 2): each row's context and position
  int R;
};

CD_HD inline Rows rows_of(void* scratch, const int32_t* cp, int R, const Dims& d) {
  float* X = (float*)scratch;
  float* Q = X + (int64_t)R * d.D;
  return Rows{X, Q, (uint16_t*)(Q + (int64_t)R * d.D), cp, R};
}

// the rows program's block: the residual rows (float32), the A operand of
// wo / w1 / qkv (bf16, D + 8 a row), then either w2's A operand (bf16, H + 8
// a row) or the qkv output (float32), then two stages of B chunks
struct PfPlan {
  int64_t xs, ah, af, bs, bytes;
};

CD_HD inline PfPlan pf_plan(const Dims& d) {
  PfPlan p;
  p.xs = 0;
  p.ah = p.xs + 4LL * PF_ROWS * d.D;
  p.af = p.ah + 2LL * PF_ROWS * (d.D + 8);
  const int64_t af = imax(2 * PF_ROWS * (d.H + 8), 4 * PF_ROWS * 3 * d.D);
  p.bs = p.af + (af + 15) / 16 * 16;
  p.bytes = p.bs + 2LL * 2 * PF_NC * PF_KCP;
  return p;
}

// the prefill attention's block: a warp's scores over its row's keys and
// its query
CD_HD inline int64_t pf_attn_bytes(const Dims& d) {
  return 4LL * (PF_THREADS / 32) * (d.L + d.D / d.nh);
}

// -- the decode's cluster, slices, units and shared memory --------------------------

// the outputs of an N-wide product a block owns: [r * w, min(N, (r + 1) * w))
CD_HD inline int slice_w(int N) { return round8(cdiv(N, CLUSTER)); }
CD_HD inline int slice_lo(int N, int r) { return imin(N, r * slice_w(N)); }
CD_HD inline int slice_n(int N, int r) { return imin(N, (r + 1) * slice_w(N)) - slice_lo(N, r); }

// attention units: a head and one of S contiguous parts of its keys; unit u
// on rank u % CLUSTER
CD_HD inline int splits_of(const Dims& d) { return imax(1, CLUSTER / d.nh); }
CD_HD inline int units_of(const Dims& d) { return d.nh * splits_of(d); }
CD_HD inline int unit_floats(const Dims& d) { return d.D / d.nh + 2; }  // m, s, o[hd]
// the keys of part s of nk keys: [s * per, min(nk, (s + 1) * per))
CD_HD inline int part_per(int nk, int S) { return cdiv(nk, S); }
// a unit's mix: the keys cut into MP contiguous pieces, a thread four
// columns of a piece
CD_HD inline int mix_parts(const Dims& d) { return imax(1, DEC_THREADS / (d.D / d.nh / 4)); }

CD_HD inline int xchg_w(const Dims& d) {
  return (imax(imax(3 * d.D, d.H), units_of(d) * unit_floats(d)) + 3) / 4 * 4;
}

// a block's resident weight slices of one layer, and the head's, in elements
CD_HD inline int64_t res_layer(const Dims& d) {
  return (int64_t)(slice_w(3 * d.D) + slice_w(d.D) + slice_w(d.H)) * d.D +
         (int64_t)slice_w(d.D) * d.H;
}
CD_HD inline int64_t res_head(const Dims& d) { return (int64_t)slice_w(d.V) * d.D; }

// A decode block's shared memory: the work area (float offsets), then the
// resident weights (bf16): the head's slice, then the slices of layers
// 0 .. nres-1. Later layers are read from global memory (through L2).
struct DecPlan {
  int x, h, o, xb, uq, uk, sc, part, red, lg, ps, ck, ord, tok, nf;
  int work_floats;
  int64_t res;  // byte offset of the resident weights
  int nres;
  int64_t bytes;
};

CD_HD inline DecPlan dec_plan(const Dims& d, int nres) {
  DecPlan p;
  const int hd = d.D / d.nh, vp = round8(d.V);
  p.x = 0;
  p.h = p.x + d.D;
  p.o = p.h + d.D;
  p.xb = p.o + d.D;
  p.uq = p.xb + 2 * xchg_w(d);
  p.uk = p.uq + hd;
  p.sc = p.uk + hd;
  p.part = p.sc + (d.L + 3) / 4 * 4;
  p.red = p.part + mix_parts(d) * hd;
  p.lg = p.red + 2 * WARPS;
  p.ps = p.lg + vp;
  p.ck = p.ps + vp;
  p.ord = p.ck + vp;
  p.tok = p.ord + vp;
  p.nf = p.tok + 4;
  p.work_floats = (int)((p.nf + norms_floats(d) + 3) / 4 * 4);
  p.res = 4LL * p.work_floats;
  p.nres = nres;
  p.bytes = p.res + 2 * (res_head(d) + nres * res_layer(d));
  return p;
}

// the layers whose slices fit beside the work area in `limit` bytes
CD_HD inline int dec_nres(const Dims& d, int64_t limit) {
  int k = 0;
  while (k < d.nl && dec_plan(d, k + 1).bytes <= limit) ++k;
  return k;
}

// out = {bf16 weight elements, f32 weight elements, K/V cache floats a
// context, the rows program's shared bytes, the prefill attention's, the
// decode block's, resident layers, cluster size, scratch bytes a prefill
// row} for dims {D, H, L, V, layers, heads}, with `limit` bytes of shared
// memory a block; 1 for dims the kernels do not take, else 0
inline int sizes(const int32_t* dims, int64_t limit, int64_t* out) {
  const Dims d = dims_of(dims);
  if (!dims_ok(d)) return 1;
  const DecPlan dp = dec_plan(d, dec_nres(d, limit));
  out[0] = wb_total(d);
  out[1] = wf_total(d);
  out[2] = kv_floats(d);
  out[3] = pf_plan(d).bytes;
  out[4] = pf_attn_bytes(d);
  out[5] = dp.bytes;
  out[6] = dp.nres;
  out[7] = CLUSTER;
  out[8] = scratch_bytes_per_row(d);
  return 0;
}

// -- arithmetic -------------------------------------------------------------------

CD_HD inline float u2f(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

CD_HD inline uint32_t f2u(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

CD_HD inline float bf2f(uint16_t b) { return u2f((uint32_t)b << 16); }

// x rounded to bf16 (to nearest, ties to even; torch's rounding), as float
CD_HD inline float round_bf(float x) {
  uint32_t u = f2u(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return x;  // NaN stays NaN
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return u2f(u);
}

// the bf16 bits of a value that is already bf16-rounded
CD_HD inline uint16_t bf_bits(float x) { return (uint16_t)(f2u(x) >> 16); }

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))
CD_HD inline float gelu(float x) {
  const float c = 0.7978845608028654f;
  return x * (0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

enum Epi { E_STORE, E_RESID, E_GELU, E_RESID_BIAS };

// a product's output from its sum: qkv and the head store it; wo adds the
// residual; w1 adds b1 and takes the gelu, rounded as w2's operand; w2 adds
// the residual, then b2
CD_HD inline float epilogue(int epi, float acc, float x, float b) {
  switch (epi) {
    case E_STORE: return acc;
    case E_RESID: return x + acc;
    case E_GELU: return round_bf(gelu(acc + b));
    default: return (x + acc) + b;
  }
}

// The sum of a prefill product's output: 16-deep partials (one mma each,
// here in order) added to a float32 sum that starts at zero.
CD_HD inline float mma_partials(const uint16_t* a, const uint16_t* w, int K) {
  float acc = 0.f;
  for (int k = 0; k < K; k += 16) {
    float part = 0.f;
    for (int e = 0; e < 16; ++e) part += bf2f(a[k + e]) * bf2f(w[k + e]);
    acc += part;
  }
  return acc;
}

// A decode product's lane partial: lane l of an output's LANES takes the
// 8-element chunks l, l + LANES, ... of its K weights, in order.
CD_HD inline float lane_dot(const float* a, const uint16_t* w, int K, int l) {
  float acc = 0.f;
  for (int c = l * 8; c < K; c += LANES * 8)
    for (int e = 0; e < 8; ++e) acc += a[c + e] * bf2f(w[c + e]);
  return acc;
}

// the shuffle butterfly (xor n/2, ..., 1) over n lane values, as the host
// runs it: every lane ends with the same sum (additions commute)
CD_HD inline float butterfly(float* v, int n) {
  float t[32];
  for (int off = n / 2; off >= 1; off /= 2) {
    for (int l = 0; l < n; ++l) t[l] = v[l] + v[l ^ off];
    for (int l = 0; l < n; ++l) v[l] = t[l];
  }
  return v[0];
}

// LayerNorm's lane partials over a D-vector (a warp's 32 lanes, lane l the
// elements l, l + 32, ...), and the normalised, bf16-rounded element
CD_HD inline float ln_lane_sum(const float* x, int D, int l) {
  float a = 0.f;
  for (int k = l; k < D; k += 32) a += x[k];
  return a;
}
CD_HD inline float ln_lane_var(const float* x, int D, int l, float m) {
  float a = 0.f;
  for (int k = l; k < D; k += 32) {
    const float c = x[k] - m;
    a += c * c;
  }
  return a;
}
CD_HD inline float ln_out(float x, float m, float v, float s, float b) {
  return round_bf((x - m) * (1.0f / sqrtf(v + 1e-5f)) * s + b);
}

// rope of a head's pair (a0 = c, a1 = c + half) at a position's cos, sin
CD_HD inline void rope(float x1, float x2, float cs, float sn, float* y1, float* y2) {
  *y1 = x1 * cs - x2 * sn;
  *y2 = x1 * sn + x2 * cs;
}

// the head's score of key k: q . K[:, k] / sqrt(hd) over the head's rows of
// the (D, L) K cache
CD_HD inline float score(const float* q, const float* Kh, int L, int k, int hd, float sqrt_hd) {
  float a = 0.f;
  CD_UNROLL(unroll 16)
  for (int c = 0; c < hd; ++c) a += q[c] * Kh[(int64_t)c * L + k];
  return a / sqrt_hd;
}

// The nucleus draw of the JAX decoder from the scaled logits ps (V), given
// exp(ps - max) in ck and each token's place in the stable descending order
// in ord: the tokens whose preceding mass is below top_p, inverse CDF at u.
// Overwrites ps with the kept cumulative mass.
CD_HD inline int nucleus(float* ps, const float* ck, const int* ord, int V, float top_p,
                         float u) {
  float s = ck[0];
  for (int i = 1; i < V; ++i) s += ck[i];
  float cps = 0.f, acc = 0.f;
  for (int r = 0; r < V; ++r) {
    const float pv = ck[ord[r]] / s;
    cps += pv;
    acc += (cps - pv) < top_p ? pv : 0.f;
    ps[r] = acc;
  }
  const float thr = u * acc;
  int idx = 0;
  for (int r = 0; r < V; ++r) idx += ps[r] < thr;
  return ord[imin(idx, V - 1)];
}

// token v's place in the stable descending order of ps
CD_HD inline int desc_rank(const float* ps, int V, int v) {
  const float lv = ps[v];
  int rank = 0;
  for (int x = 0; x < V; ++x) rank += (ps[x] > lv) || (ps[x] == lv && x < v);
  return rank;
}

CD_HD inline int first_max(const float* lg, int V) {
  int best = 0;
  for (int v = 1; v < V; ++v)
    if (lg[v] > lg[best]) best = v;
  return best;
}

}  // namespace cd
