// chat_decode.cuh — one context's decode of the chat LM (policies/chat_lm.py),
// position after position, as __host__ __device__ code.
//
// The same source runs in two places. In csrc/chat_decode.cu every thread of
// a CUDA block calls decode_context for the block's context; in
// csrc/chat_decode_host.cpp the host calls it once and each stage loops over
// the block's thread ids in order. A stage (CD_STAGE) is a body run by every
// thread id followed by a block barrier: within a stage a thread writes only
// locations no other thread of the stage reads, so the two runs do the same
// arithmetic in the same order (only fma contraction and the device's expf /
// tanhf differ).
//
// What a position computes is the JAX decoder's scan body
// (game_engine_tpu/policies/chat_lm.py _make_decoder): the token's row of the
// bf16-rounded embedding plus the float32 position row; per layer LayerNorm,
// the qkv product, rope, the K/V cache write, softmax attention over keys
// 0..pos, the mix, wo plus the residual, LayerNorm, w1 plus the tanh gelu, w2
// plus the residual; then, where pos + 1 >= n0, the final LayerNorm, the tied
// head, and the argmax (the first maximum) or the nucleus draw from the
// caller's uniform. Every product rounds its activation operand to bf16 and
// accumulates in float32 over bf16 weights; the attention is float32. The
// decode stops at the first generated token below NSPECIAL or after max_new
// generated tokens: all that _finish_reply reads of the JAX decoder's
// full-length buffer.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define CD_HD __host__ __device__
#else
#define CD_HD
#endif

#ifdef __CUDA_ARCH__
#define CD_STAGE(...)                  \
  do {                                 \
    {                                  \
      const int tid = threadIdx.x;     \
      __VA_ARGS__                      \
    }                                  \
    __syncthreads();                   \
  } while (0)
#else
#define CD_STAGE(...)                      \
  do {                                     \
    for (int tid = 0; tid < T; ++tid) {    \
      __VA_ARGS__                          \
    }                                      \
  } while (0)
#endif

namespace cd {

constexpr int NSPECIAL = 4;   // PAD, BOS, SEP, EOS: a generated one ends the reply
constexpr int LN_PARTS = 32;  // LayerNorm sums: partial sums a row
constexpr int SM_PARTS = 32;  // softmax: partial max and sum a head
constexpr int MAX_THREADS = 768;  // the launch bound: 85 registers a thread

struct Dims {
  int D, H, L, V, nl, nh;
};

CD_HD inline Dims dims_of(const int32_t* a) { return Dims{a[0], a[1], a[2], a[3], a[4], a[5]}; }

CD_HD inline bool dims_ok(const Dims& d) {
  return d.D > 0 && d.H > 0 && d.L >= 2 && d.V > 0 && d.V <= 4096 && d.nl > 0 && d.nh > 0 &&
         d.D % d.nh == 0 && (d.D / d.nh) % 2 == 0;
}

CD_HD inline bool threads_ok(int T) { return T >= 32 && T <= MAX_THREADS && T % 32 == 0; }

// -- the packed weights ---------------------------------------------------------
// bf16 blob (uint16 elements): tok (V, D), tok^T (D, V), then a layer at a
// time wqkv (D, 3D), wo (D, D), w1 (D, H), w2 (H, D), each row-major.
// f32 blob: pos (L, D), cos (L, half), sin (L, half), lnf_s, lnf_b (D each),
// then a layer at a time ln1_s, ln1_b, ln2_s, ln2_b (D each), b1 (H), b2 (D).

CD_HD inline int64_t wb_layer(const Dims& d) {
  return 4LL * d.D * d.D + 2LL * d.D * d.H;
}
CD_HD inline int64_t wb_total(const Dims& d) { return 2LL * d.V * d.D + d.nl * wb_layer(d); }
CD_HD inline int half_of(const Dims& d) { return d.D / d.nh / 2; }
CD_HD inline int64_t wf_layer(const Dims& d) { return 5LL * d.D + d.H; }
CD_HD inline int64_t wf_total(const Dims& d) {
  return (int64_t)d.L * d.D + 2LL * d.L * half_of(d) + 2LL * d.D + d.nl * wf_layer(d);
}
// each context's K/V caches: a layer at a time K (D, L), then V (L, D)
CD_HD inline int64_t kv_floats(const Dims& d) { return 2LL * d.nl * d.L * d.D; }

struct Net {
  const uint16_t* wb;
  const float* wf;
  Dims d;
  CD_HD const uint16_t* tok() const { return wb; }
  CD_HD const uint16_t* tokT() const { return wb + (int64_t)d.V * d.D; }
  CD_HD const uint16_t* wqkv(int i) const { return wb + 2LL * d.V * d.D + i * wb_layer(d); }
  CD_HD const uint16_t* wo(int i) const { return wqkv(i) + 3LL * d.D * d.D; }
  CD_HD const uint16_t* w1(int i) const { return wo(i) + (int64_t)d.D * d.D; }
  CD_HD const uint16_t* w2(int i) const { return w1(i) + (int64_t)d.D * d.H; }
  CD_HD const float* pos() const { return wf; }
  CD_HD const float* cos_() const { return wf + (int64_t)d.L * d.D; }
  CD_HD const float* sin_() const { return cos_() + (int64_t)d.L * half_of(d); }
  CD_HD const float* lnf_s() const { return sin_() + (int64_t)d.L * half_of(d); }
  CD_HD const float* lnf_b() const { return lnf_s() + d.D; }
  CD_HD const float* lf(int i) const { return lnf_b() + d.D + i * wf_layer(d); }
  CD_HD const float* ln1_s(int i) const { return lf(i); }
  CD_HD const float* ln1_b(int i) const { return lf(i) + d.D; }
  CD_HD const float* ln2_s(int i) const { return lf(i) + 2 * d.D; }
  CD_HD const float* ln2_b(int i) const { return lf(i) + 3 * d.D; }
  CD_HD const float* b1(int i) const { return lf(i) + 4 * d.D; }
  CD_HD const float* b2(int i) const { return lf(i) + 4 * d.D + d.H; }
};

// -- a block's working rows (shared memory on the card) ------------------------

struct Work {
  float *x, *h, *qkv, *o, *f, *part, *sc, *red, *lnr, *lg, *ps, *ck;
  int *ord, *flag;
};

CD_HD inline int imax(int a, int b) { return a > b ? a : b; }
CD_HD inline int imin(int a, int b) { return a < b ? a : b; }

// matrix-vector partial sums: at most max(T, N) of them for an N-wide output
CD_HD inline int64_t part_floats(const Dims& d, int T) {
  return imax(T, imax(3 * d.D, imax(d.H, d.V)));
}

CD_HD inline int64_t work_floats(const Dims& d, int T) {
  return 6LL * d.D + d.H + part_floats(d, T) + (int64_t)d.nh * d.L + 2LL * d.nh * SM_PARTS +
         2 * LN_PARTS + 4LL * d.V + 4;
}

// out = {bf16 weight elements, f32 weight elements, shared bytes a block,
// K/V cache floats a context} for dims {D, H, L, V, layers, heads}
inline void sizes(const int32_t* dims, int threads, int64_t* out) {
  const Dims d = dims_of(dims);
  out[0] = wb_total(d);
  out[1] = wf_total(d);
  out[2] = work_floats(d, threads) * 4;
  out[3] = kv_floats(d);
}

CD_HD inline Work carve(float* s, const Dims& d, int T) {
  Work w;
  w.x = s;
  w.h = w.x + d.D;
  w.qkv = w.h + d.D;
  w.o = w.qkv + 3 * d.D;
  w.f = w.o + d.D;
  w.part = w.f + d.H;
  w.sc = w.part + part_floats(d, T);
  w.red = w.sc + (int64_t)d.nh * d.L;
  w.lnr = w.red + 2 * d.nh * SM_PARTS;
  w.lg = w.lnr + 2 * LN_PARTS;
  w.ps = w.lg + d.V;
  w.ck = w.ps + d.V;
  w.ord = (int*)(w.ck + d.V);
  w.flag = w.ord + d.V;
  return w;
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

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + 0.044715 x^3))))
CD_HD inline float gelu(float x) {
  const float c = 0.7978845608028654f;
  return x * (0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

// sum_k a[k] * W[k][j] over k in [k0, k1), in order
CD_HD inline float mv_part(const float* a, const uint16_t* W, int N, int j, int k0, int k1) {
  float acc = 0.f;
  for (int k = k0; k < k1; ++k) acc += a[k] * bf2f(W[(int64_t)k * N + j]);
  return acc;
}

enum Epi { E_STORE, E_RESID, E_GELU, E_RESID_BIAS };

CD_HD inline void epilogue(int epi, float* out, const float* b, int j, float acc) {
  switch (epi) {
    case E_STORE: out[j] = acc; break;
    case E_RESID: out[j] = out[j] + acc; break;                 // x + (o @ wo)
    case E_GELU: out[j] = round_bf(gelu(acc + b[j])); break;    // w2's operand
    default: out[j] = (out[j] + acc) + b[j]; break;             // (x + h @ w2) + b2
  }
}

// out[j] <- epi(sum_k a[k] * W[k][j]) for j < N. With N < T the K axis is
// cut into P = T / N parts, summed in order in a second stage.
CD_HD inline void matvec(const Work& w, const float* a, const uint16_t* W, int K, int N, int epi,
                         const float* b, float* out, int T) {
  const int P = N >= T ? 1 : T / N;
  if (P == 1) {
    CD_STAGE({
      for (int j = tid; j < N; j += T) epilogue(epi, out, b, j, mv_part(a, W, N, j, 0, K));
    });
    return;
  }
  const int C = (K + P - 1) / P;
  CD_STAGE({
    for (int i = tid; i < P * N; i += T) {
      const int p = i / N, j = i % N, k0 = p * C;
      w.part[i] = mv_part(a, W, N, j, k0, imin(K, k0 + C));
    }
  });
  CD_STAGE({
    for (int j = tid; j < N; j += T) {
      float acc = w.part[j];
      for (int p = 1; p < P; ++p) acc += w.part[p * N + j];
      epilogue(epi, out, b, j, acc);
    }
  });
}

CD_HD inline float sum_parts(const float* r, int n) {
  float a = r[0];
  for (int i = 1; i < n; ++i) a += r[i];
  return a;
}

// out <- bf16((x - mean) * rsqrt(var + 1e-5) * s + b), the biased variance
CD_HD inline void layer_norm(const Work& w, const float* x, const float* s, const float* b,
                             float* out, int D, int T) {
  float* r = w.lnr;
  CD_STAGE({
    if (tid < LN_PARTS) {
      float a = 0.f;
      for (int k = tid; k < D; k += LN_PARTS) a += x[k];
      r[tid] = a;
    }
  });
  CD_STAGE({
    if (tid < LN_PARTS) {
      const float m = sum_parts(r, LN_PARTS) / (float)D;
      float a = 0.f;
      for (int k = tid; k < D; k += LN_PARTS) {
        const float c = x[k] - m;
        a += c * c;
      }
      r[LN_PARTS + tid] = a;
    }
  });
  CD_STAGE({
    for (int j = tid; j < D; j += T) {
      const float m = sum_parts(r, LN_PARTS) / (float)D;
      const float v = sum_parts(r + LN_PARTS, LN_PARTS) / (float)D;
      out[j] = round_bf((x[j] - m) * (1.0f / sqrtf(v + 1e-5f)) * s[j] + b[j]);
    }
  });
}

// -- one context ------------------------------------------------------------------

// Decodes one context in place: toks (L) holds the prompt in [0, n0) and
// receives the generated tokens from n0 on; kv is the context's K/V caches
// (kv_floats); u (L) the uniforms of a sampled decode, or null for greedy;
// logits (L, V), when not null, receives the head's row at each position
// whose next token was generated. Every thread of the block calls it.
CD_HD inline void decode_context(const Net& n, const Work& w, int T, int32_t* toks, int n0,
                                 float* kv, const float* u, float inv_temp, float top_p,
                                 int max_new, float* logits) {
  const Dims& d = n.d;
  const int D = d.D, L = d.L, V = d.V, nh = d.nh, hd = D / nh, half = hd / 2;
  const float sqrt_hd = (float)sqrt((double)hd);
  const float neg_inf = -INFINITY;
  CD_STAGE({
    if (tid == 0) {
      w.flag[0] = 0;  // stop
      w.flag[1] = 0;  // tokens generated
    }
  });
  for (int p = 0; p < L - 1; ++p) {
    const int t = toks[p];
    CD_STAGE({
      for (int j = tid; j < D; j += T)
        w.x[j] = bf2f(n.tok()[(int64_t)t * D + j]) + n.pos()[(int64_t)p * D + j];
    });
    const int nk = p + 1;
    for (int i = 0; i < d.nl; ++i) {
      float* Kc = kv + (int64_t)(2 * i) * L * D;      // (D, L)
      float* Vc = kv + (int64_t)(2 * i + 1) * L * D;  // (L, D)
      layer_norm(w, w.x, n.ln1_s(i), n.ln1_b(i), w.h, D, T);
      matvec(w, w.h, n.wqkv(i), D, 3 * D, E_STORE, nullptr, w.qkv, T);
      // rope on q (in place) and k, then the cache writes
      CD_STAGE({
        const float* cs = n.cos_() + (int64_t)p * half;
        const float* sn = n.sin_() + (int64_t)p * half;
        for (int e = tid; e < nh * half; e += T) {
          const int a0 = (e / half) * hd + e % half, a1 = a0 + half, c = e % half;
          const float q1 = w.qkv[a0], q2 = w.qkv[a1];
          w.qkv[a0] = q1 * cs[c] - q2 * sn[c];
          w.qkv[a1] = q1 * sn[c] + q2 * cs[c];
          const float k1 = w.qkv[D + a0], k2 = w.qkv[D + a1];
          Kc[(int64_t)a0 * L + p] = k1 * cs[c] - k2 * sn[c];
          Kc[(int64_t)a1 * L + p] = k1 * sn[c] + k2 * cs[c];
        }
        for (int j = tid; j < D; j += T) Vc[(int64_t)p * D + j] = w.qkv[2 * D + j];
      });
      // scores q . k / sqrt(hd) over keys 0..p
      CD_STAGE({
        for (int e = tid; e < nh * nk; e += T) {
          const int hh = e / nk, k = e % nk;
          const float* q = w.qkv + hh * hd;
          const float* kc = Kc + (int64_t)hh * hd * L + k;
          float a = 0.f;
          for (int c = 0; c < hd; ++c) a += q[c] * kc[(int64_t)c * L];
          w.sc[hh * L + k] = a / sqrt_hd;
        }
      });
      // softmax: partial maxima, then exp and partial sums
      CD_STAGE({
        for (int e = tid; e < nh * SM_PARTS; e += T) {
          const int hh = e / SM_PARTS;
          float m = neg_inf;
          for (int k = e % SM_PARTS; k < nk; k += SM_PARTS) m = fmaxf(m, w.sc[hh * L + k]);
          w.red[e] = m;
        }
      });
      CD_STAGE({
        for (int e = tid; e < nh * SM_PARTS; e += T) {
          const int hh = e / SM_PARTS;
          float m = w.red[hh * SM_PARTS];
          for (int r = 1; r < SM_PARTS; ++r) m = fmaxf(m, w.red[hh * SM_PARTS + r]);
          float s = 0.f;
          for (int k = e % SM_PARTS; k < nk; k += SM_PARTS) {
            const float x = expf(w.sc[hh * L + k] - m);
            w.sc[hh * L + k] = x;
            s += x;
          }
          w.red[nh * SM_PARTS + e] = s;
        }
      });
      // the mix: o[j] = sum_k (e_k / s) v_k[j], the keys cut into P parts
      const int P = imax(1, T / D), C = (nk + P - 1) / P;
      CD_STAGE({
        for (int e = tid; e < P * D; e += T) {
          const int q = e / D, j = e % D, hh = j / hd, k0 = q * C, k1 = imin(nk, k0 + C);
          const float s = sum_parts(w.red + nh * SM_PARTS + hh * SM_PARTS, SM_PARTS);
          float a = 0.f;
          for (int k = k0; k < k1; ++k) a += (w.sc[hh * L + k] / s) * Vc[(int64_t)k * D + j];
          w.part[e] = a;
        }
      });
      CD_STAGE({
        for (int j = tid; j < D; j += T) {
          float a = w.part[j];
          for (int q = 1; q < P; ++q) a += w.part[q * D + j];
          w.o[j] = round_bf(a);
        }
      });
      matvec(w, w.o, n.wo(i), D, D, E_RESID, nullptr, w.x, T);
      layer_norm(w, w.x, n.ln2_s(i), n.ln2_b(i), w.h, D, T);
      matvec(w, w.h, n.w1(i), D, d.H, E_GELU, n.b1(i), w.f, T);
      matvec(w, w.f, n.w2(i), d.H, D, E_RESID_BIAS, n.b2(i), w.x, T);
    }
    if (p + 1 < n0) continue;  // inside the prompt: teacher-forced
    layer_norm(w, w.x, n.lnf_s(), n.lnf_b(), w.h, D, T);
    matvec(w, w.h, n.tokT(), D, V, E_STORE, nullptr, w.lg, T);
    if (u == nullptr) {
      CD_STAGE({
        if (tid == 0) {  // the first maximum
          int best = 0;
          for (int v = 1; v < V; ++v)
            if (w.lg[v] > w.lg[best]) best = v;
          w.flag[2] = best;
        }
        if (logits != nullptr)
          for (int v = tid; v < V; v += T) logits[(int64_t)p * V + v] = w.lg[v];
      });
    } else {
      CD_STAGE({
        for (int v = tid; v < V; v += T) w.ps[v] = w.lg[v] * inv_temp;
        if (logits != nullptr)
          for (int v = tid; v < V; v += T) logits[(int64_t)p * V + v] = w.lg[v];
      });
      // exp(lg - max), and each token's place in the stable descending order
      CD_STAGE({
        for (int v = tid; v < V; v += T) {
          float m = w.ps[0];
          for (int x = 1; x < V; ++x) m = fmaxf(m, w.ps[x]);
          const float lv = w.ps[v];
          int rank = 0;
          for (int x = 0; x < V; ++x) rank += (w.ps[x] > lv) || (w.ps[x] == lv && x < v);
          w.ord[rank] = v;
          w.ck[v] = expf(lv - m);
        }
      });
      CD_STAGE({
        if (tid == 0) {
          const float s = sum_parts(w.ck, V);
          float cps = 0.f, acc = 0.f;
          for (int r = 0; r < V; ++r) {  // the nucleus: preceding mass < top_p
            const float pv = w.ck[w.ord[r]] / s;
            cps += pv;
            acc += (cps - pv) < top_p ? pv : 0.f;
            w.ps[r] = acc;
          }
          const float thr = u[p] * acc;
          int idx = 0;
          for (int r = 0; r < V; ++r) idx += w.ps[r] < thr;
          w.flag[2] = w.ord[imin(idx, V - 1)];
        }
      });
    }
    CD_STAGE({
      if (tid == 0) {
        const int nxt = w.flag[2];
        toks[p + 1] = nxt;
        w.flag[1] += 1;
        w.flag[0] = nxt < NSPECIAL || w.flag[1] >= max_new;
      }
    });
    if (w.flag[0]) break;
  }
}

}  // namespace cd
