// chat_decode.cu — the chat LM's decode on Hopper (sm_90a): a tensor-core
// prefill of the prompts, then the generated tokens on a cluster of SMs a
// context.
//
// Counterpart of the JAX decoder game_engine_tpu/policies/chat_lm.py
// _make_decoder (:439): a jitted lax.scan over every position of a reply in
// one device dispatch. It has no pallas_call; XLA compiles the scan. The
// eager torch version of the same loop (policies/chat_decode.py decode_plain)
// launches some 130 kernels a position, tens of thousands a reply.
//
// Three programs (chat_decode.cuh says what each computes and in which order):
//
// - cd_prefill_rows_kernel: PF_ROWS prompt rows a block, stacked across the
//   batch's contexts; per layer the products as bf16 mma.sync m16n8k16 tiles
//   (B chunks of 64 outputs x 192 deep streamed through shared memory by
//   cp.async, two stages), LayerNorm a warp a row, rope and the K/V cache
//   writes. What bounds it: each block streams a layer's 0.9 MB of weights
//   from L2 for its 32 rows, so a prompt of a few hundred rows runs on a few
//   SMs; a batch fills the card.
// - cd_prefill_attn_kernel: a warp a (row, head), causal softmax over the
//   row's own context's keys in float32.
// - cd_decode_kernel: a cluster of CLUSTER blocks a context for the
//   generated positions. Block r owns a 1/CLUSTER slice of every product's
//   outputs (its weights' rows of K, contiguous in the transposed blob):
//   the first layers' slices and the head's stay in its shared memory, the
//   rest stream from L2 in 16-byte loads, twelve in flight a lane. Eight
//   lanes share an output and the butterfly's lane l pushes the sum into
//   rank l's exchange buffer (distributed shared memory); one cluster
//   barrier ends each exchange, five a layer and two for the token. What
//   bounds it: the chain of ~22 cluster barriers and dependent L2 round
//   trips a position, not bytes or operations (a position reads ~0.45 MB of
//   weights a block).
//
// The launches: 2 * layers - 1 prefill launches when any context has a
// prompt row, then one cluster launch; all on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chat_decode.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace cd;

constexpr int CD_ERR_CLUSTER = 100001;  // the cluster cannot be placed on this card

// -DCD_PROFILE: rank 0's thread 0 of every cluster adds the clock cycles of
// each stage of a generated position (CD_STAGES, in the order of
// chat_decode.PROFILE_STAGES) into cd_prof. A measuring build.
constexpr int CD_STAGES = 18;
#ifdef CD_PROFILE
__device__ unsigned long long cd_prof[CD_STAGES];
#define CD_MARK(k)                         \
  do {                                     \
    if (prof_on) {                         \
      const long long t_ = clock64();      \
      prof[k] += t_ - prof_t;              \
      prof_t = t_;                         \
    }                                      \
  } while (0)
#else
#define CD_MARK(k) \
  do {             \
  } while (0)
#endif

// -- warp helpers ------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off >= 1; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off >= 1; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// first_max by one warp: each lane's first maximum of its logits, then the
// butterfly keeping the larger value, and of equal ones the lower index
__device__ __forceinline__ int warp_first_max(const float* lg, int V) {
  const int l = threadIdx.x & 31;
  int bi = l < V ? l : 0;
  float bv = lg[bi];
  for (int v = l + 32; v < V; v += 32)
    if (lg[v] > bv) bv = lg[v], bi = v;
  for (int off = 16; off >= 1; off /= 2) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) bv = ov, bi = oi;
  }
  return bi;
}

__device__ __forceinline__ float lo_bf(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// LayerNorm of a D-vector by one warp (lane = threadIdx.x & 31), as
// ln_lane_sum / ln_lane_var / ln_out; out(k, value) takes each element
template <class Out>
__device__ __forceinline__ void warp_layer_norm(const float* x, const float* s, const float* b,
                                                int D, Out out) {
  const int l = threadIdx.x & 31;
  const float m = warp_sum(ln_lane_sum(x, D, l)) / (float)D;
  const float v = warp_sum(ln_lane_var(x, D, l, m)) / (float)D;
  for (int k = l; k < D; k += 32) out(k, ln_out(x[k], m, v, s[k], b[k]));
}

// LayerNorm of a D-vector by a whole block: every warp takes the same
// statistics (warp_layer_norm's sums), each thread writes its elements
template <class Out>
__device__ __forceinline__ void block_layer_norm(const float* x, const float* s, const float* b,
                                                 int D, Out out) {
  const int l = threadIdx.x & 31;
  const float m = warp_sum(ln_lane_sum(x, D, l)) / (float)D;
  const float v = warp_sum(ln_lane_var(x, D, l, m)) / (float)D;
  for (int k = threadIdx.x; k < D; k += blockDim.x) out(k, ln_out(x[k], m, v, s[k], b[k]));
}

// -- the prefill -------------------------------------------------------------------

struct PfArgs {
  Net n;
  const int32_t* io;
  float* kv;
  Rows rows;
  int layer;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) { return *(const uint32_t*)p; }

// d = a (16x16 bf16, row) * b (16x8 bf16, col), from a zero accumulator
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// out[m][j] = epi(m, j, sum_k A[m][k] W^T[j][k]) for the block's PF_ROWS rows
// and j < N: A bf16 in shared memory (lda a row), W^T (N, K) bf16 in global
// memory. Warp w computes rows 16 (w & 1) .. +16 and columns 16 (w >> 1) ..
// +16 of each 64-wide chunk of outputs; the chunks of W^T (64 x up to
// PF_KC) pass through two shared stages by cp.async. Each mma starts from
// zero; its partial is added to the float32 sum (mma_partials' order).
template <class Epi>
__device__ void pf_product(const uint16_t* As, int lda, const uint16_t* WT, int K, int N,
                           uint16_t* Bs, Epi epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int kchunks = cdiv(K, PF_KC), total = cdiv(N, PF_NC) * kchunks;
  auto load = [&](int ci) {
    const int n0 = (ci / kchunks) * PF_NC, k0 = (ci % kchunks) * PF_KC;
    const int per_row = imin(PF_KC, K - k0) / 8;
    uint16_t* dst = Bs + (ci & 1) * PF_NC * PF_KCP;
    for (int v = tid; v < PF_NC * per_row; v += PF_THREADS) {
      const int rr = v / per_row, cc = (v % per_row) * 8;
      const bool ok = n0 + rr < N;
      cp_async16(dst + rr * PF_KCP + cc, WT + (int64_t)(ok ? n0 + rr : 0) * K + k0 + cc, ok);
    }
    cp_async_commit();
  };
  float acc[2][4];
  load(0);
  for (int ci = 0; ci < total; ++ci) {
    if (ci + 1 < total) {
      load(ci + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kc = ci % kchunks, k0 = kc * PF_KC, kw = imin(PF_KC, K - k0);
    if (kc == 0)
      for (int f = 0; f < 2; ++f)
        for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
    const uint16_t* B = Bs + (ci & 1) * PF_NC * PF_KCP;
    const uint16_t* a0 = As + (wm * 16 + g) * lda + k0 + 2 * t4;
    const uint16_t* a1 = a0 + 8 * lda;
    for (int kk = 0; kk < kw; kk += 16) {
      const uint32_t a[4] = {ld32(a0 + kk), ld32(a1 + kk), ld32(a0 + kk + 8), ld32(a1 + kk + 8)};
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const uint16_t* br = B + (wn * 16 + f * 8 + g) * PF_KCP + kk + 2 * t4;
        const uint32_t b[2] = {ld32(br), ld32(br + 8)};
        float d[4];
        mma_bf16(d, a, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][e] += d[e];
      }
    }
    if (kc == kchunks - 1) {
      const int nc = ci / kchunks;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int col = nc * PF_NC + wn * 16 + f * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = col + (e & 1);
          if (j < N) epi(wm * 16 + g + 8 * (e >> 1), j, acc[f][e]);
        }
      }
    }
    __syncthreads();
  }
}

// LayerNorm of the block's rows, a warp a row, into bf16 A-operand rows
__device__ void rows_layer_norm(const float* xs, int D, const float* s, const float* b,
                                uint16_t* out, int lda) {
  const int warp = threadIdx.x >> 5;
  for (int m = warp; m < PF_ROWS; m += PF_THREADS / 32)
    warp_layer_norm(xs + m * D, s, b, D,
                    [&](int k, float v) { out[m * lda + k] = bf_bits(v); });
}

// One layer of the rows: for layer > 0 first the previous layer's wo (on
// the attention output O), LayerNorm, w1 + gelu and w2 on the residual X;
// for layer 0 the embedding. Then LayerNorm, qkv, rope: Q and the layer's
// K/V cache rows. X is written back for the next launch.
__global__ void __launch_bounds__(PF_THREADS) cd_prefill_rows_kernel(PfArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rc[PF_ROWS], rp[PF_ROWS];
  const Net& n = A.n;
  const Norms nm = n.norms();
  const Dims& d = n.d;
  const int D = d.D, H = d.H, L = d.L, hd = D / d.nh, half = hd / 2, tid = threadIdx.x;
  const PfPlan P = pf_plan(d);
  float* xs = (float*)(smem + P.xs);
  uint16_t* ah = (uint16_t*)(smem + P.ah);
  uint16_t* af = (uint16_t*)(smem + P.af);
  float* qs = (float*)(smem + P.af);  // the qkv output, after w2 has read af
  uint16_t* Bs = (uint16_t*)(smem + P.bs);
  const int lda = D + 8, ldf = H + 8, layer = A.layer;
  const int r0 = blockIdx.x * PF_ROWS, nrows = imin(PF_ROWS, A.rows.R - r0);
  if (tid < PF_ROWS) {
    rc[tid] = tid < nrows ? A.rows.cp[2 * (r0 + tid)] : 0;
    rp[tid] = tid < nrows ? A.rows.cp[2 * (r0 + tid) + 1] : 0;
  }
  __syncthreads();
  if (layer == 0) {
    for (int e = tid; e < PF_ROWS * D; e += PF_THREADS) {
      const int m = e / D, j = e % D;
      float v = 0.f;
      if (m < nrows) {
        const int t = A.io[(int64_t)rc[m] * (L + 1) + 1 + rp[m]];
        v = bf2f(n.tok()[(int64_t)t * D + j]) + n.pos()[(int64_t)rp[m] * D + j];
      }
      xs[e] = v;
    }
    __syncthreads();
  } else {
    const int i = layer - 1;
    for (int e = tid; e < PF_ROWS * D; e += PF_THREADS) {
      const int m = e / D, j = e % D;
      const bool in = m < nrows;
      xs[e] = in ? A.rows.X[(int64_t)(r0 + m) * D + j] : 0.f;
      ah[m * lda + j] = in ? A.rows.O[(int64_t)(r0 + m) * D + j] : 0;
    }
    __syncthreads();
    pf_product(ah, lda, n.wo(i), D, D, Bs, [&](int m, int j, float v) {
      xs[m * D + j] = epilogue(E_RESID, v, xs[m * D + j], 0.f);
    });
    rows_layer_norm(xs, D, nm.ln2_s(i), nm.ln2_b(i), ah, lda);
    __syncthreads();
    const float* b1 = nm.b1(i);
    pf_product(ah, lda, n.w1(i), D, H, Bs, [&](int m, int j, float v) {
      af[m * ldf + j] = bf_bits(epilogue(E_GELU, v, 0.f, b1[j]));
    });
    const float* b2 = nm.b2(i);
    pf_product(af, ldf, n.w2(i), H, D, Bs, [&](int m, int j, float v) {
      xs[m * D + j] = epilogue(E_RESID_BIAS, v, xs[m * D + j], b2[j]);
    });
  }
  rows_layer_norm(xs, D, nm.ln1_s(layer), nm.ln1_b(layer), ah, lda);
  __syncthreads();
  pf_product(ah, lda, n.wqkv(layer), D, 3 * D, Bs,
             [&](int m, int j, float v) { qs[m * 3 * D + j] = v; });
  const int64_t kvf = kv_floats(d);
  for (int e = tid; e < nrows * d.nh * half; e += PF_THREADS) {
    const int m = e / (d.nh * half), c = e % half, a0 = ((e / half) % d.nh) * hd + c,
              a1 = a0 + half, p = rp[m];
    const float cs = n.cos_()[(int64_t)p * half + c], sn = n.sin_()[(int64_t)p * half + c];
    const float* q = qs + m * 3 * D;
    float y1, y2;
    rope(q[a0], q[a1], cs, sn, &y1, &y2);
    A.rows.Q[(int64_t)(r0 + m) * D + a0] = y1;
    A.rows.Q[(int64_t)(r0 + m) * D + a1] = y2;
    rope(q[D + a0], q[D + a1], cs, sn, &y1, &y2);
    float* Kc = A.kv + rc[m] * kvf + (int64_t)(2 * layer) * L * D;
    Kc[(int64_t)a0 * L + p] = y1;
    Kc[(int64_t)a1 * L + p] = y2;
  }
  for (int e = tid; e < nrows * D; e += PF_THREADS) {
    const int m = e / D, j = e % D;
    float* Vc = A.kv + rc[m] * kvf + (int64_t)(2 * layer + 1) * L * D;
    Vc[(int64_t)rp[m] * D + j] = qs[m * 3 * D + 2 * D + j];
  }
  if (layer + 1 < d.nl)
    for (int e = tid; e < nrows * D; e += PF_THREADS)
      A.rows.X[(int64_t)r0 * D + e] = xs[e];
}

// Causal attention of the rows at a layer: warp w of block (x, y) takes row
// 8x + w and head y over its context's keys 0..p: scores, their maximum,
// exp and sum (lane partials, then the butterfly), the mix a lane a column
// over the keys in order; the output rounded to bf16 into O.
__global__ void __launch_bounds__(PF_THREADS) cd_prefill_attn_kernel(PfArgs A) {
  extern __shared__ __align__(16) float sm[];
  const Dims& d = A.n.d;
  const int D = d.D, L = d.L, hd = D / d.nh, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (PF_THREADS / 32) + warp, hh = blockIdx.y;
  if (r >= A.rows.R) return;
  float* sc = sm + warp * (L + hd);
  float* q = sc + L;
  const int c = A.rows.cp[2 * r], p = A.rows.cp[2 * r + 1], nk = p + 1;
  const float sqrt_hd = (float)sqrt((double)hd);
  const float* Kh = A.kv + c * kv_floats(d) + (int64_t)(2 * A.layer) * L * D + (int64_t)hh * hd * L;
  const float* Vh = A.kv + c * kv_floats(d) + (int64_t)(2 * A.layer + 1) * L * D + hh * hd;
  for (int k = lane; k < hd; k += 32) q[k] = A.rows.Q[(int64_t)r * D + hh * hd + k];
  __syncwarp();
  float tm = -INFINITY;
  for (int k = lane; k < nk; k += 32) {
    const float a = score(q, Kh, L, k, hd, sqrt_hd);
    sc[k] = a;
    tm = fmaxf(tm, a);
  }
  const float M = warp_max(tm);
  float ts = 0.f;
  for (int k = lane; k < nk; k += 32) {
    const float e = expf(sc[k] - M);
    sc[k] = e;
    ts += e;
  }
  const float S = warp_sum(ts);
  __syncwarp();
  for (int j = lane; j < hd; j += 32) {
    float a = 0.f;
#pragma unroll 8
    for (int k = 0; k < nk; ++k) a += (sc[k] / S) * Vh[(int64_t)k * D + j];
    A.rows.O[(int64_t)r * D + hh * hd + j] = bf_bits(round_bf(a));
  }
}

// -- the decode on a cluster ----------------------------------------------------

struct DecArgs {
  Net n;
  int32_t* io;
  float* kv;
  const float* u;
  float inv_temp, top_p;
  int max_new;
  float* logits;
  int nres;
};

// acc plus the 8 products of a chunk, one at a time (lane_dot's order)
__device__ __forceinline__ float dot8(float acc, const float* a, uint4 w) {
  const float4 x0 = *(const float4*)a, x1 = *(const float4*)(a + 4);
  acc += x0.x * lo_bf(w.x);
  acc += x0.y * hi_bf(w.x);
  acc += x0.z * lo_bf(w.y);
  acc += x0.w * hi_bf(w.y);
  acc += x1.x * lo_bf(w.z);
  acc += x1.y * hi_bf(w.z);
  acc += x1.z * lo_bf(w.w);
  acc += x1.w * hi_bf(w.w);
  return acc;
}

// This block's cnt outputs of a product, rows of Wr (K weights each; shared
// or global memory): group g of LANES lanes takes outputs g, g + GROUPS, ...
// and lane l sums its chunks of each in lane_dot's order, then the
// butterfly; lane l hands epi's value to push(o, l, value). A lane issues
// the 16-byte loads of R outputs' NCH chunks each before it uses any:
// <3, 4> for K <= 192 (qkv and w1 at d_model 192: all nine loads at once),
// <12, 1> for deeper products (w2: twelve), in blocks of NCH chunks beyond.
template <int NCH, int R, class Epi, class Push>
__device__ __forceinline__ void dec_product_t(const float* a, const uint16_t* Wr, int K, int cnt,
                                              Epi epi, Push push) {
  const int g = threadIdx.x / LANES, l = threadIdx.x % LANES;
  const int rounds = cdiv(cnt, GROUPS);
  for (int it0 = 0; it0 < rounds; it0 += R) {
    float v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = 0.f;
    for (int c0 = l * 8; c0 < K; c0 += NCH * LANES * 8) {
      uint4 wv[R][NCH];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int o = (it0 + q) * GROUPS + g;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int c = c0 + i * LANES * 8;
          wv[q][i] = o < cnt && c < K ? *(const uint4*)(Wr + (int64_t)o * K + c)
                                      : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int c = c0 + i * LANES * 8;
          if (c < K) v[q] = dot8(v[q], a + c, wv[q][i]);
        }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (it0 + q < rounds) {  // uniform over the block
        float t = v[q];
        t += __shfl_xor_sync(0xffffffffu, t, 4);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        const int o = (it0 + q) * GROUPS + g;
        if (o < cnt) push(o, l, epi(o, t));
      }
    }
  }
}

template <class Epi, class Push>
__device__ __forceinline__ void dec_product(const float* a, const uint16_t* Wr, int K, int cnt,
                                            Epi epi, Push push) {
  if (K <= 3 * LANES * 8)
    dec_product_t<3, 4>(a, Wr, K, cnt, epi, push);
  else
    dec_product_t<12, 1>(a, Wr, K, cnt, epi, push);
}

__device__ __forceinline__ void copy_rows(uint16_t* dst, const uint16_t* src, int64_t elems) {
  for (int64_t i = threadIdx.x; i < elems / 8; i += DEC_THREADS)
    ((uint4*)dst)[i] = ((const uint4*)src)[i];
}

__global__ void __launch_bounds__(DEC_THREADS, 1) cd_decode_kernel(DecArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const Net& n = A.n;
  const Dims& d = n.d;
  const int D = d.D, H = d.H, L = d.L, V = d.V, nh = d.nh, hd = D / nh, half = hd / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, l8 = tid % LANES;
  const int r = (int)cl.block_rank();
  const int64_t c = blockIdx.x / CLUSTER;
  int32_t* row = A.io + c * (L + 1);
  const int n0 = row[0];
  if (n0 >= L) return;  // the whole cluster: nothing to generate
  int32_t* toks = row + 1;

  const DecPlan P = dec_plan(d, A.nres);
  float* W = (float*)smem;
  float *x = W + P.x, *h = W + P.h, *o = W + P.o, *xb = W + P.xb, *uq = W + P.uq,
        *uk = W + P.uk, *sc = W + P.sc, *part = W + P.part, *red = W + P.red, *lg = W + P.lg,
        *ps = W + P.ps, *ck = W + P.ck;
  int* ord = (int*)(W + P.ord);
  int* tokw = (int*)(W + P.tok);
  const Norms nm{W + P.nf, d};  // LayerNorm parameters and biases, copied below
  const int XW = xchg_w(d), S = splits_of(d), U = units_of(d), UF = unit_floats(d);
  const int MP = mix_parts(d);

  // this block's slices: first output and count of each product
  const int lq = slice_lo(3 * D, r), nq = slice_n(3 * D, r);
  const int ld = slice_lo(D, r), nd = slice_n(D, r);
  const int lh = slice_lo(H, r), nhh = slice_n(H, r);
  const int lv = slice_lo(V, r), nv = slice_n(V, r);
  for (int64_t k = tid; k < norms_floats(d); k += DEC_THREADS) W[P.nf + k] = n.norms().p[k];
  uint16_t* res = (uint16_t*)(smem + P.res);
  const uint16_t* Wv = res;
  copy_rows(res, n.tok() + (int64_t)lv * D, (int64_t)nv * D);
  auto res_of = [&](int i) { return res + res_head(d) + i * res_layer(d); };
  for (int i = 0; i < A.nres; ++i) {
    uint16_t* q = res_of(i);
    copy_rows(q, n.wqkv(i) + (int64_t)lq * D, (int64_t)nq * D);
    q += (int64_t)slice_w(3 * D) * D;
    copy_rows(q, n.wo(i) + (int64_t)ld * D, (int64_t)nd * D);
    q += (int64_t)slice_w(D) * D;
    copy_rows(q, n.w1(i) + (int64_t)lh * D, (int64_t)nhh * D);
    q += (int64_t)slice_w(H) * D;
    copy_rows(q, n.w2(i) + (int64_t)ld * H, (int64_t)nd * H);
  }
  __syncthreads();
  cl.sync();  // every block of the cluster runs before any writes another's memory

  float* xb_to = cl.map_shared_rank(xb, l8);  // lane l8 of a group pushes to rank l8
  float* lg_0 = cl.map_shared_rank(lg, 0);
  const float sqrt_hd = (float)sqrt((double)hd);
  const int64_t kvf = kv_floats(d);
  int t = toks[n0 - 1], count = 0, ex = 0;  // ex: exchanges so far, xb's parity
#ifdef CD_PROFILE
  const bool prof_on = r == 0 && tid == 0;
  long long prof[CD_STAGES] = {}, prof_t = clock64();
#endif

  for (int p = n0 - 1; p < L - 1; ++p) {
    for (int j = tid; j < D; j += DEC_THREADS)
      x[j] = bf2f(n.tok()[(int64_t)t * D + j]) + n.pos()[(int64_t)p * D + j];
    __syncthreads();
    CD_MARK(0);
    const float* cs = n.cos_() + (int64_t)p * half;
    const float* sn = n.sin_() + (int64_t)p * half;
    const int nk = p + 1, per = part_per(nk, S);
    for (int i = 0; i < d.nl; ++i) {
      float* Kc = A.kv + c * kvf + (int64_t)(2 * i) * L * D;
      float* Vc = Kc + (int64_t)L * D;
      const bool resident = i < A.nres;
      const uint16_t* Wq = resident ? res_of(i) : n.wqkv(i) + (int64_t)lq * D;
      const uint16_t* Wo = resident ? Wq + (int64_t)slice_w(3 * D) * D : n.wo(i) + (int64_t)ld * D;
      const uint16_t* W1 = resident ? Wo + (int64_t)slice_w(D) * D : n.w1(i) + (int64_t)lh * D;
      const uint16_t* W2 = resident ? W1 + (int64_t)slice_w(H) * D : n.w2(i) + (int64_t)ld * H;

      block_layer_norm(x, nm.ln1_s(i), nm.ln1_b(i), D, [&](int k, float v) { h[k] = v; });
      __syncthreads();
      CD_MARK(1);
      // (1) qkv: this block's columns to every block
      {
        float* to = xb_to + (ex & 1) * XW;
        dec_product(h, Wq, D, nq, [](int, float v) { return v; },
                    [&](int oi, int, float v) { to[lq + oi] = v; });
      }
      CD_MARK(2);
      cl.sync();
      CD_MARK(3);
      const float* qkv = xb + (ex & 1) * XW;
      ++ex;
      // (2) attention units: (m, s, o) of each to every block
      for (int un = r; un < U; un += CLUSTER) {
        const int hh = un / S, s = un % S;
        const int k0 = imin(nk, s * per), k1 = imin(nk, k0 + per);
        const float *q = qkv + hh * hd, *kk = qkv + D + hh * hd, *vv = qkv + 2 * D + hh * hd;
        const float* Kh = Kc + (int64_t)hh * hd * L;
        float* Vh = Vc + hh * hd;
        for (int e = tid; e < half; e += DEC_THREADS) {
          rope(q[e], q[e + half], cs[e], sn[e], &uq[e], &uq[e + half]);
          rope(kk[e], kk[e + half], cs[e], sn[e], &uk[e], &uk[e + half]);
        }
        __syncthreads();
        if (k0 <= p && p < k1)  // this part holds the current key: write its cache row
          for (int e = tid; e < hd; e += DEC_THREADS) {
            Kc[(int64_t)(hh * hd + e) * L + p] = uk[e];
            Vh[(int64_t)p * D + e] = vv[e];
          }
        float tm = -INFINITY;
        for (int k = k0 + tid; k < k1; k += DEC_THREADS) {
          float a = 0.f;
          if (k == p) {
            for (int e = 0; e < hd; ++e) a += uq[e] * uk[e];
          } else {
#pragma unroll 48
            for (int e = 0; e < hd; ++e) a += uq[e] * __ldcg(Kh + (int64_t)e * L + k);
          }
          a = a / sqrt_hd;
          sc[k - k0] = a;
          tm = fmaxf(tm, a);
        }
        tm = warp_max(tm);
        if (lane == 0) red[warp] = tm;
        __syncthreads();
        float M = red[0];
        for (int w = 1; w < WARPS; ++w) M = fmaxf(M, red[w]);
        float ts = 0.f;
        for (int k = k0 + tid; k < k1; k += DEC_THREADS) {
          const float e = expf(sc[k - k0] - M);
          sc[k - k0] = e;
          ts += e;
        }
        ts = warp_sum(ts);
        if (lane == 0) red[WARPS + warp] = ts;
        __syncthreads();
        const int C2 = cdiv(k1 - k0, MP), h4 = hd / 4;
        if (tid < MP * h4) {  // piece qq of the keys, columns 4 j4 .. 4 j4 + 3
          const int qq = tid / h4, j4 = tid % h4, a0 = k0 + qq * C2, a1 = imin(k1, a0 + C2);
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
          for (int k = a0; k < a1; ++k) {
            const float4 v4 = k == p ? *(const float4*)(vv + 4 * j4)
                                     : __ldcg((const float4*)(Vh + (int64_t)k * D) + j4);
            const float e = sc[k - k0];
            a.x += e * v4.x;
            a.y += e * v4.y;
            a.z += e * v4.z;
            a.w += e * v4.w;
          }
          *(float4*)(part + qq * hd + 4 * j4) = a;
        }
        __syncthreads();
        const int at = (ex & 1) * XW + un * UF;
        if (tid < hd) {
          float a = part[tid];
          for (int qq = 1; qq < MP; ++qq) a += part[qq * hd + tid];
          for (int q2 = 0; q2 < CLUSTER; ++q2) cl.map_shared_rank(xb, q2)[at + 2 + tid] = a;
        }
        if (tid == 0) {
          float s2 = red[WARPS];
          for (int w = 1; w < WARPS; ++w) s2 += red[WARPS + w];
          for (int q2 = 0; q2 < CLUSTER; ++q2) {
            float* dst = cl.map_shared_rank(xb, q2);
            dst[at] = M;
            dst[at + 1] = s2;
          }
        }
        __syncthreads();
      }
      CD_MARK(4);
      cl.sync();
      CD_MARK(5);
      const float* parts = xb + (ex & 1) * XW;
      ++ex;
      // merge each head's parts: o rounded to bf16
      for (int j = tid; j < D; j += DEC_THREADS) {
        const float* pu = parts + (j / hd) * S * UF;
        float M = pu[0];
        for (int s = 1; s < S; ++s) M = fmaxf(M, pu[s * UF]);
        float den = 0.f, num = 0.f;
        for (int s = 0; s < S; ++s) {
          const float w = expf(pu[s * UF] - M);
          den += pu[s * UF + 1] * w;
          num += pu[s * UF + 2 + j % hd] * w;
        }
        o[j] = round_bf(num / den);
      }
      __syncthreads();
      CD_MARK(6);
      // (3) wo plus the residual
      {
        float* to = xb_to + (ex & 1) * XW;
        dec_product(o, Wo, D, nd,
                    [&](int oi, float v) { return epilogue(E_RESID, v, x[ld + oi], 0.f); },
                    [&](int oi, int, float v) { to[ld + oi] = v; });
      }
      CD_MARK(7);
      cl.sync();
      for (int j = tid; j < D; j += DEC_THREADS) x[j] = xb[(ex & 1) * XW + j];
      ++ex;
      __syncthreads();
      CD_MARK(8);
      block_layer_norm(x, nm.ln2_s(i), nm.ln2_b(i), D, [&](int k, float v) { h[k] = v; });
      __syncthreads();
      CD_MARK(9);
      // (4) w1 plus b1, gelu, rounded: w2's operand
      {
        float* to = xb_to + (ex & 1) * XW;
        const float* b1 = nm.b1(i);
        dec_product(h, W1, D, nhh,
                    [&](int oi, float v) { return epilogue(E_GELU, v, 0.f, b1[lh + oi]); },
                    [&](int oi, int, float v) { to[lh + oi] = v; });
      }
      CD_MARK(10);
      cl.sync();
      CD_MARK(11);
      const float* f = xb + (ex & 1) * XW;
      ++ex;
      // (5) w2 plus the residual, then b2
      {
        float* to = xb_to + (ex & 1) * XW;
        const float* b2 = nm.b2(i);
        dec_product(f, W2, H, nd,
                    [&](int oi, float v) {
                      return epilogue(E_RESID_BIAS, v, x[ld + oi], b2[ld + oi]);
                    },
                    [&](int oi, int, float v) { to[ld + oi] = v; });
      }
      CD_MARK(12);
      cl.sync();
      for (int j = tid; j < D; j += DEC_THREADS) x[j] = xb[(ex & 1) * XW + j];
      ++ex;
      __syncthreads();
      CD_MARK(13);
    }
    // the head: this block's logits to rank 0
    block_layer_norm(x, nm.lnf_s(), nm.lnf_b(), D, [&](int k, float v) { h[k] = v; });
    __syncthreads();
    dec_product(h, Wv, D, nv, [](int, float v) { return v; }, [&](int oi, int l, float v) {
      if (l == 0) lg_0[lv + oi] = v;
    });
    CD_MARK(14);
    cl.sync();
    CD_MARK(15);
    if (r == 0) {  // the token, the stop rule; both to every block
      if (A.logits != nullptr)
        for (int v = tid; v < V; v += DEC_THREADS) A.logits[(c * L + p) * V + v] = lg[v];
      int nxt = 0;
      if (A.u == nullptr) {
        if (warp == 0) nxt = warp_first_max(lg, V);
      } else {
        for (int v = tid; v < V; v += DEC_THREADS) ps[v] = lg[v] * A.inv_temp;
        __syncthreads();
        for (int v = tid; v < V; v += DEC_THREADS) {
          float m = ps[0];
          for (int y = 1; y < V; ++y) m = fmaxf(m, ps[y]);
          ord[desc_rank(ps, V, v)] = v;
          ck[v] = expf(ps[v] - m);
        }
        __syncthreads();
        if (tid == 0) nxt = nucleus(ps, ck, ord, V, A.top_p, A.u[c * L + p]);
      }
      if (tid == 0) {
        toks[p + 1] = nxt;
        ++count;
        const int stop = nxt < NSPECIAL || count >= A.max_new;
        for (int q2 = 0; q2 < CLUSTER; ++q2) {
          int* dst = cl.map_shared_rank(tokw, q2);
          dst[0] = nxt;
          dst[1] = stop;
        }
      }
    }
    CD_MARK(16);
    cl.sync();
    CD_MARK(17);
    t = tokw[0];
    if (tokw[1]) break;
  }
#ifdef CD_PROFILE
  if (prof_on)
    for (int k = 0; k < CD_STAGES; ++k) atomicAdd(&cd_prof[k], (unsigned long long)prof[k]);
#endif
}

// The decode's launch configuration for dims on the current device: the
// cluster attribute, the resident layers and the shared bytes a block.
cudaError_t decode_config(const cd::Dims& d, cudaLaunchConfig_t* cfg,
                                 cudaLaunchAttribute* at, int* nres) {
  using namespace cd;
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *nres = dec_nres(d, limit);
  const int64_t bytes = dec_plan(d, *nres).bytes;
  if (bytes > limit) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(cd_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CLUSTER);
  cfg->blockDim = dim3(DEC_THREADS);
  cfg->dynamicSmemBytes = (size_t)bytes;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg->attrs = at;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* cd_error_string(int code) {
  if (code == CD_ERR_CLUSTER)
    return "the decode's cluster of 8 blocks cannot be placed on this card "
           "(cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString((cudaError_t)code);
}

// chat_decode.cuh sizes, with `limit` bytes of shared memory a block.
int cd_sizes(const int32_t* dims, int64_t limit, int64_t* out) {
  return cd::sizes(dims, limit, out);
}

// The prefill on `stream`: io is (n_ctx, L + 1) int32, column 0 the prompt
// length n0, then the tokens; kv is n_ctx times kv_floats; rows (n_rows, 2)
// the prompt rows (context, position), scratch n_rows *
// scratch_bytes_per_row. Writes every row's K/V cache entries. *launches
// receives its launches. Returns a CUDA error code (0 = ok).
int cd_prefill(const uint16_t* wb, const float* wf, const int32_t* dims, const int32_t* io,
               float* kv, const int32_t* rows, int n_rows, void* scratch, int32_t* launches,
               void* stream) {
  using namespace cd;
  const Dims d = dims_of(dims);
  *launches = 0;
  if (!dims_ok(d) || n_rows < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  PfArgs A{Net{wb, wf, d}, io, kv, rows_of(scratch, rows, n_rows, d), 0};
  const int smr = (int)pf_plan(d).bytes, sma = (int)pf_attn_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(cd_prefill_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smr);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(cd_prefill_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sma);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < d.nl; ++i) {
    A.layer = i;
    cd_prefill_rows_kernel<<<cdiv(n_rows, PF_ROWS), PF_THREADS, smr, s>>>(A);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    ++*launches;
    if (i + 1 < d.nl) {
      cd_prefill_attn_kernel<<<dim3(cdiv(n_rows, PF_THREADS / 32), d.nh), PF_THREADS, sma, s>>>(
          A);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      ++*launches;
    }
  }
  return 0;
}

// The decode of n_ctx contexts on `stream`, one cluster of CLUSTER blocks a
// context, after the prefill has written the prompt rows' caches: the
// generated tokens written from n0 on; u (n_ctx, L) the uniforms of a
// sampled decode or null; logits (n_ctx, L, V) or null. Refuses (CD_ERR_CLUSTER)
// a card on which cudaOccupancyMaxActiveClusters is 0. *launches receives
// its launches. Returns a CUDA error code (0 = ok).
int cd_decode(const uint16_t* wb, const float* wf, const int32_t* dims, int32_t* io, float* kv,
              const float* u, float inv_temp, float top_p, int max_new, float* logits,
              int n_ctx, int32_t* launches, void* stream) {
  using namespace cd;
  const Dims d = dims_of(dims);
  *launches = 0;
  if (!dims_ok(d) || n_ctx < 1 || max_new < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[1];
  int nres = 0;
  cudaError_t e = decode_config(d, &cfg, at, &nres);
  if (e != cudaSuccess) return (int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (void*)cd_decode_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return CD_ERR_CLUSTER;
  cfg.gridDim = dim3((unsigned)n_ctx * CLUSTER);
  cfg.stream = (cudaStream_t)stream;
  DecArgs A{Net{wb, wf, d}, io, kv, u, inv_temp, top_p, max_new, logits, nres};
  e = cudaLaunchKernelEx(&cfg, cd_decode_kernel, A);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++*launches;
  return 0;
}

#ifdef CD_PROFILE
// The profile build's stage cycles summed over every cluster since the last
// reset (out: CD_STAGES uint64); resets them when `reset`.
int cd_profile_read(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, cd_prof, sizeof(unsigned long long) * CD_STAGES);
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[CD_STAGES] = {};
    e = cudaMemcpyToSymbol(cd_prof, zero, sizeof(zero));
  }
  return (int)e;
}
#endif

// The decode's clusters the card holds at once (cudaOccupancyMaxActiveClusters),
// its resident layers and shared bytes a block, for dims; a CUDA error code, or 0.
int cd_cluster_plan(const int32_t* dims, int32_t* out) {
  using namespace cd;
  const Dims d = dims_of(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  int nres = 0, clusters = 0;
  cudaError_t e = decode_config(d, &cfg, at, &nres);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, (void*)cd_decode_kernel, &cfg);
  out[0] = clusters;
  out[1] = nres;
  out[2] = (int)cfg.dynamicSmemBytes;
  return (int)e;
}

}  // extern "C"
