// lossgrad.cu — the deepsets/attn policy net on Hopper's tensor cores: the
// forward (K2, lg_forward, replacing game_engine_tpu/policies/fused.py:299
// _run_fwd), the parameter gradient of given cotangents (K3, lg_grad, :468
// _run_bwd) and the one-pass PPO loss-grad (K4, lg_lossgrad, :600
// _run_lossgrad). Built by nvcc for sm_90a into a plain-C shared library
// (game_engine_tpu_torch/_build.py), bound with ctypes (policies/fused.py
// kernel_forward, kernel_grads, kernel_loss_grads).
//
// The stages and their order are lossgrad.cuh's (lg::run_forward,
// lg::run_grad); this file is the device backend that runs them:
//   gemm_kernel   C = sum_p A_p B with a fused epilogue (bias + gelu, the
//                 attention residual, gelu' of a cotangent split into
//                 hi/lo): bf16 mma.sync.m16n8k16, f32 accumulation, 128 x 64
//                 output tiles, A and B staged into shared memory by
//                 cp.async in two stages and read with ldmatrix; the tile
//                 goes out through shared memory, 16 bytes a store.
//   wgrad_kernel  a weight gradient X^T (dY_hi + dY_lo) over the chunk's
//                 rows: 64 x 64 output tiles x nsplit row ranges, each
//                 adding into its own gradient slab; the tiles of the first
//                 row of tiles also sum dY's columns into the bias.
//   colsum_kernel column sums (LayerNorm affine gradients, loss stats).
//   each_kernel   one thread per row or seat-row for the elementwise and
//                 per-room stages (lossgrad.cuh).
//   reduce_kernel the slabs summed in split order.
// No atomics anywhere: the result is deterministic for a given chunk and
// nsplit. Bound: operations (about 1.7 MFLOP a row forward and 5.1 with
// the backward at the attn net's width, two bf16 products for each
// backward product); the scratch traffic between stages (~28 KB a row
// forward, ~79 KB with the backward, written and read back) is the next
// limit. wgmma/TMA and fusing stages to cut that traffic are later work.

#include <cuda_runtime.h>

#include "lossgrad.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GBM = 128, GBN = 64, GBK = lg::BK;
constexpr int GWM = GBM / 32;  // warps along M (each 32 x 32 of C)
constexpr int AST = GBK + 8;  // shared row strides (bf16), padded against bank conflicts
constexpr int BST = GBN + 8;
constexpr int WBK = 64, WBN = 64, WBM = 32;  // weight gradient: K x N tile, rows per step
constexpr int XST = WBK + 8, YST = WBN + 8;
constexpr int ERR_UNSUPPORTED = -1;

constexpr int CST = GBN + 4;  // f32 row stride of the output tile staged for the epilogue

struct GemmSmem {
  union {
    struct {
      uint16_t a[2][2][GBM * AST];  // [stage][pair]
      uint16_t b[2][GBK * BST];
    } in;
    float c[GBM * CST];
  };
};

struct WgradSmem {
  uint16_t x[2][WBM * XST];
  uint16_t y[2][2][WBM * YST];  // [stage][hi, lo]
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or zeros when !pred
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// s += x, compensated (Kahan): c carries what the last add lost. The
// gradient sums run over up to a million rows whose terms nearly cancel at
// a trained optimum, where plain f32 chains lose several percent.
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, f32 out. The tensor
// core sums the 16 products from a zero accumulator and the partial is
// added to d with an ordinary f32 add (round to nearest): its own f32
// accumulation truncates the low bits of terms added to a larger sum, and
// over a long K that bias flips the later bf16 roundings one way (4e-4 on
// the trained value head, 9% on its gradient).
__device__ __forceinline__ void mma(float d[4], const unsigned a[4], unsigned b0, unsigned b1) {
  float t0, t1, t2, t3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(t0), "=f"(t1), "=f"(t2), "=f"(t3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
  d[0] += t0;
  d[1] += t1;
  d[2] += t2;
  d[3] += t3;
}

// ---------------------------------------------------------------------------
// C (M x N) = sum_p A_p (M x K) B (K x N), then the epilogue.
// Block: 128 x 64 of C, 8 warps of 32 x 32 (2 x 4 mma tiles each).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) gemm_kernel(lg::Gemm g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GemmSmem& sm = *reinterpret_cast<GemmSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % GWM, wn = warp / GWM;
  const int64_t m0 = (int64_t)blockIdx.y * GBM;
  const int n0 = blockIdx.x * GBN;
  const int nk = g.K / GBK;

  auto load = [&](int st, int k0) {
    for (int p = 0; p < g.npair; ++p) {
      for (int c = tid; c < GBM * GBK / 8; c += THREADS) {
        const int row = c / (GBK / 8), kc = (c % (GBK / 8)) * 8;
        const bool ok = m0 + row < g.M;
        const uint16_t* src = g.A[p] + (ok ? (m0 + row) * g.lda + k0 + kc : 0);
        cp16(&sm.in.a[st][p][row * AST + kc], src, ok);
      }
    }
    for (int c = tid; c < GBK * GBN / 8; c += THREADS) {
      const int row = c / (GBN / 8), nc = (c % (GBN / 8)) * 8;
      const bool ok = n0 + nc < g.N;
      const uint16_t* src = g.B + (ok ? (int64_t)(k0 + row) * g.ldb + n0 + nc : 0);
      cp16(&sm.in.b[st][row * BST + nc], src, ok);
    }
    cp_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, (kt + 1) * GBK);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int ks = 0; ks < GBK; ks += 16) {
      unsigned b[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];
        const int k = ks + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int n = wn * 32 + nj * 16 + 8 * (lane >> 4);
        ldsm_x4_t(r, &sm.in.b[st][k * BST + n]);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
      for (int p = 0; p < g.npair; ++p) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          unsigned a[4];
          const int row = wm * 32 + mi * 16 + (lane & 15);
          ldsm_x4(a, &sm.in.a[st][p][row * AST + ks + 8 * (lane >> 4)]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], a, b[ni][0], b[ni][1]);
        }
      }
    }
    __syncthreads();
  }

  // the tile through shared memory (the input stages are dead), so that the
  // epilogue's reads and writes run along rows
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm * 32 + mi * 16 + gq + 8 * (q >> 1);
        sm.c[r * CST + wn * 32 + ni * 8 + 2 * cq + (q & 1)] = acc[mi][ni][q];
      }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < GBM * GBN / 8 / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / (GBN / 8), c = (i % (GBN / 8)) * 8;
    const int64_t row = m0 + r;
    const int col = n0 + c;
    if (row < g.M && col < g.N) {
      float v[8];
      for (int j = 0; j < 8; ++j) v[j] = sm.c[r * CST + c + j];
      lg::epi_apply8(g.epi, row, col, v);
    }
  }
}

// ---------------------------------------------------------------------------
// slab[split] += X^T (Y_hi + Y_lo) over split's rows, K x N tiles of 64 x 64,
// 8 warps of 16 x 32 (1 x 4 mma tiles, each twice: hi and lo). Each step of
// WBM rows is summed by the tensor cores into a fresh accumulator, and the
// steps' partial sums are added with compensation.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) wgrad_kernel(lg::Wgrad w) {
  __shared__ __align__(16) WgradSmem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp & 3, wn = warp >> 2;
  const int n0 = blockIdx.x * WBN, k0 = blockIdx.y * WBK, split = blockIdx.z;
  int64_t r0, r1;
  lg::split_rows(w.M, w.nsplit, split, &r0, &r1);
  const int nsteps = (int)((r1 - r0 + WBM - 1) / WBM);
  const bool bias = blockIdx.y == 0;

  auto load = [&](int st, int64_t m0) {
    const int row = tid / 8, c8 = (tid % 8) * 8;
    const bool rok = m0 + row < r1;
    const bool xok = rok && k0 + c8 < w.K;
    cp16(&sm.x[st][row * XST + c8], w.X + (xok ? (m0 + row) * w.ldx + k0 + c8 : 0), xok);
    const bool yok = rok && n0 + c8 < w.N;
    for (int h = 0; h < 2; ++h)
      cp16(&sm.y[st][h][row * YST + c8], w.Y[h] + (yok ? (m0 + row) * w.ldy + n0 + c8 : 0),
           yok);
    cp_commit();
  };

  float tot[4][4], comp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) tot[j][q] = comp[j][q] = 0.0f;
  float bsum = 0.0f, bcomp = 0.0f;  // column tid of the tile (bias blocks, tid < WBN)

  if (nsteps > 0) load(0, r0);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      load((s + 1) & 1, r0 + (int64_t)(s + 1) * WBM);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int st = s & 1;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
#pragma unroll
    for (int ms = 0; ms < WBM; ms += 16) {
      unsigned a[4];
      {
        const int m = ms + (lane & 7) + 8 * (lane >> 4);
        const int k = wk * 16 + 8 * ((lane >> 3) & 1);
        ldsm_x4_t(a, &sm.x[st][m * XST + k]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          unsigned r[4];
          const int m = ms + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int n = wn * 32 + nj * 16 + 8 * (lane >> 4);
          ldsm_x4_t(r, &sm.y[st][h][m * YST + n]);
          mma(acc[2 * nj], a, r[0], r[1]);
          mma(acc[2 * nj + 1], a, r[2], r[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) kahan_add(tot[j][q], comp[j][q], acc[j][q]);
    if (bias && tid < WBN) {
      float part = 0.0f;
      for (int m = 0; m < WBM; ++m)
        part += lg::bf16_bits_to_float(sm.y[st][0][m * YST + tid]) +
                lg::bf16_bits_to_float(sm.y[st][1][m * YST + tid]);
      kahan_add(bsum, bcomp, part);
    }
    __syncthreads();
  }

  float* slab = w.slabs + (int64_t)split * w.ng;
  const int gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + wk * 16 + gq + 8 * (q >> 1);
      const int col = n0 + wn * 32 + ni * 8 + 2 * cq + (q & 1);
      if (k < w.K && col < w.N) {
        const int at = lg::target_index(w.t, k, col);
        if (at >= 0) slab[at] += tot[ni][q];
      }
    }
  if (bias && tid < WBN && n0 + tid < w.N) {
    const int at = lg::target_bias(w.t, n0 + tid);
    if (at >= 0) slab[at] += bsum;
  }
}

// column sums of split blockIdx.y, 32 columns a block: thread (x, y) adds
// rows y, y + CS_ROWS, ... of column x (compensated), then the CS_ROWS
// partial sums are added in y order
constexpr int CS_COLS = 32, CS_ROWS = 8;

__global__ void __launch_bounds__(CS_COLS * CS_ROWS) colsum_kernel(lg::Colsum c) {
  __shared__ float part[2][CS_ROWS][CS_COLS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * CS_COLS + tx;
  int64_t r0, r1;
  lg::split_rows(c.M, c.nsplit, blockIdx.y, &r0, &r1);
  float uv = 0.0f, u = 0.0f, uvc = 0.0f, uc = 0.0f;
  if (col < c.N) {
    for (int64_t r = r0 + ty; r < r1; r += CS_ROWS) {
      const float x = c.U[r * c.ld + col];
      kahan_add(u, uc, x);
      if (c.V) kahan_add(uv, uvc, x * c.V[r * c.ld + col]);
    }
  }
  part[0][ty][tx] = uv;
  part[1][ty][tx] = u;
  __syncthreads();
  if (ty != 0 || col >= c.N) return;
  uv = 0.0f;
  u = 0.0f;
  for (int y = 0; y < CS_ROWS; ++y) {
    uv += part[0][y][tx];
    u += part[1][y][tx];
  }
  float* slab = c.slabs + (int64_t)blockIdx.y * c.ng;
  if (c.uv_off >= 0) slab[c.uv_off + col] += uv;
  if (c.u_off >= 0) slab[c.u_off + col] += u;
}

template <class F>
__global__ void each_kernel(F f, int64_t count) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) f(i);
}

__global__ void reduce_kernel(const float* __restrict__ slabs, int nsplit, int ng,
                              float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ng) return;
  float s = 0.0f;
  for (int b = 0; b < nsplit; ++b) s += slabs[(int64_t)b * ng + j];
  out[j] = s;
}

struct DevBE {
  cudaStream_t st;

  template <class F>
  int each(const F& f, int64_t count) {
    if (count <= 0) return 0;
    const int threads = 128;
    each_kernel<F><<<(unsigned)((count + threads - 1) / threads), threads, 0, st>>>(f, count);
    return (int)cudaGetLastError();
  }

  int memset(void* p, int64_t bytes) {
    return (int)cudaMemsetAsync(p, 0, (size_t)bytes, st);
  }

  int gemm(const lg::Gemm& g) {
    if (g.M <= 0) return 0;
    const dim3 grid((g.N + GBN - 1) / GBN, (unsigned)((g.M + GBM - 1) / GBM));
    gemm_kernel<<<grid, THREADS, sizeof(GemmSmem), st>>>(g);
    return (int)cudaGetLastError();
  }

  int wgrad(const lg::Wgrad& w) {
    if (w.M <= 0) return 0;
    const dim3 grid((w.N + WBN - 1) / WBN, (w.K + WBK - 1) / WBK, w.nsplit);
    wgrad_kernel<<<grid, THREADS, 0, st>>>(w);
    return (int)cudaGetLastError();
  }

  int colsum(const lg::Colsum& c) {
    if (c.M <= 0) return 0;
    const dim3 grid((c.N + CS_COLS - 1) / CS_COLS, c.nsplit);
    colsum_kernel<<<grid, dim3(CS_COLS, CS_ROWS), 0, st>>>(c);
    return (int)cudaGetLastError();
  }

  int reduce(const float* slabs, int nsplit, int ng, float* out) {
    reduce_kernel<<<(ng + THREADS - 1) / THREADS, THREADS, 0, st>>>(slabs, nsplit, ng, out);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

int lg_meta_ints() { return lg::META_INTS; }

// bytes of the packed-weight buffer of lg_pack
int64_t lg_weights_bytes(const int32_t* meta) {
  return lg::layout(lg::net_from_meta(meta), 1, 1, true).w_end;
}

// bytes of the scratch of a call with `chunk` rows per chunk: of lg_forward
// (fwd_only, nsplit ignored) or of lg_grad / lg_lossgrad
int64_t lg_scratch_bytes(const int32_t* meta, int64_t chunk, int nsplit, int fwd_only) {
  return lg::layout(lg::net_from_meta(meta), chunk, nsplit, fwd_only != 0).total;
}

const char* lg_error_string(int code) {
  if (code == ERR_UNSUPPORTED) return "unsupported net dims or chunking";
  return cudaGetErrorString((cudaError_t)code);
}

static int prepare(const lg::Net& n, int64_t chunk, int nsplit) {
  if (!lg::supported(n) || chunk < 1 || nsplit < 1) return ERR_UNSUPPORTED;
  return (int)cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)sizeof(GemmSmem));
}

// The weights of prm (n_params f32) as bf16, forward and transposed, into
// `weights` (lg_weights_bytes(meta) bytes): what the three entries below
// read, valid while the parameters are unchanged. Each entry returns 0 once
// every stage is launched on `stream`, else the first error.
int lg_pack(const int32_t* meta, const float* prm, void* weights, void* stream) {
  const lg::Net n = lg::net_from_meta(meta);
  if (!lg::supported(n)) return ERR_UNSUPPORTED;
  DevBE be{(cudaStream_t)stream};
  return lg::pack_weights(be, n, lg::layout(n, 1, 1, true), prm, (char*)weights);
}

// K2: logits (nrows, A) and value (nrows,) f32 of obs (nrows, F) bf16.
// scratch holds lg_scratch_bytes(meta, chunk, 1, 1) bytes.
int lg_forward(const int32_t* meta, const uint16_t* obs, int64_t nrows, const float* prm,
               const void* weights, void* scratch, int64_t chunk, float* logits, float* value,
               void* stream) {
  const lg::Net n = lg::net_from_meta(meta);
  LG_TRY(prepare(n, chunk, 1));
  DevBE be{(cudaStream_t)stream};
  return lg::run_forward(be, n, lg::layout(n, chunk, 1, true), (const char*)weights,
                         (char*)scratch, obs, nrows, prm, logits, value);
}

// K3: out (n_params + 4) = the parameter gradient of sum(dl * logits) +
// sum(dv * value) over obs (nrows, F) bf16, rowin (nrows, A + 1) = dl | dv,
// then four zeros. scratch holds lg_scratch_bytes(meta, chunk, nsplit, 0).
int lg_grad(const int32_t* meta, const uint16_t* obs, int64_t nrows, const float* rowin,
            const float* prm, const void* weights, void* scratch, int64_t chunk, int nsplit,
            float* out, void* stream) {
  const lg::Net n = lg::net_from_meta(meta);
  LG_TRY(prepare(n, chunk, nsplit));
  DevBE be{(cudaStream_t)stream};
  return lg::run_grad(be, n, lg::layout(n, chunk, nsplit, false), (const char*)weights,
                      (char*)scratch, obs, nrows, rowin, false, 0.0f, 0.0f, prm, out);
}

// K4: out (n_params + 4) = the gradient of the PPO loss over obs (nrows, F)
// bf16 and rowin (nrows, 2A + 5) f32, summed over all rows, then the four
// loss sums. scratch holds lg_scratch_bytes(meta, chunk, nsplit, 0) bytes.
int lg_lossgrad(const int32_t* meta, const uint16_t* obs, int64_t nrows, const float* rowin,
                float clip_eps, float ent_coef, const float* prm, const void* weights,
                void* scratch, int64_t chunk, int nsplit, float* out, void* stream) {
  const lg::Net n = lg::net_from_meta(meta);
  LG_TRY(prepare(n, chunk, nsplit));
  DevBE be{(cudaStream_t)stream};
  return lg::run_grad(be, n, lg::layout(n, chunk, nsplit, false), (const char*)weights,
                      (char*)scratch, obs, nrows, rowin, true, clip_eps, ent_coef, prm, out);
}

}  // extern "C"
