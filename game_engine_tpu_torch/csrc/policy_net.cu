// policy_net.cu — the deepsets/attn policy net on Hopper's CUDA cores: the
// forward and backward kernels K2 and K3 for the widths the tensor-core
// pipelines of lossgrad.cu do not cover (encoder or trunk width not a
// multiple of 32; policies/fused.py route_of), and their launchers, built
// by nvcc for sm_90a into a plain-C shared library
// (game_engine_tpu_torch/_build.py) and bound with ctypes
// (game_engine_tpu_torch/policies/fused.py).
//
//   pn_forward_kernel  replaces K2, game_engine_tpu/policies/fused.py:299
//                      (_run_fwd / _fwd_kernel): logits and value of every
//                      row, one tile of R rows per block.
//   pn_grad_kernel     replaces K3, fused.py:468 (_run_bwd / _bwd_kernel):
//                      recompute the forward, back-propagate the given dl, dv
//                      into every parameter gradient.
//   pn_reduce_kernel   the second pass of K3: sums the blocks' gradient slabs
//                      in block order.
// K4, the PPO loss-grad (fused.py:600), and K2 and K3 at the covered
// widths (every shipped net) are lossgrad.cu.
//
// The TPU kernels accumulate the gradient across grid steps in VMEM
// (fused.py:432-441), which works because the TPU grid runs in order.
// Hopper's blocks run in parallel, so K3 runs a persistent grid of at most
// one block per SM; each block walks its row tiles (tile = blockIdx.x,
// + gridDim.x, ...) and adds into its own f32 slab of the gradient in global
// memory (the wrapper allocates grid x params floats), and
// pn_reduce_kernel adds the slabs in a fixed order. No atomics: the result
// is deterministic.
//
// What bounds them: every product runs on the CUDA cores in f32 on
// bf16-rounded operands, reading weights from L2 once per 8 seat-rows
// (policy_net.cuh mm), and each tile of K3 reads and writes its block's
// whole ~1 MB slab once. A tile's intermediates stay in shared memory; rows
// per tile R are the most that fit (up to 16). wgmma/TMA tiling is later work.

#include <cuda_runtime.h>

#include "policy_net.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_R = 16;
constexpr int ERR_NO_FIT = -1;   // a one-row tile exceeds shared memory
constexpr int ERR_BAD_META = -2;

__global__ void __launch_bounds__(THREADS)
pn_forward_kernel(pn::Net n, int R, const uint16_t* __restrict__ obs, int64_t nrows,
                  const float* __restrict__ prm, const float* __restrict__ prmB,
                  float* __restrict__ logits, float* __restrict__ value) {
  extern __shared__ __align__(16) float sm[];
  const pn::Lay l = pn::layout(n, R, false);
  const pn::Ctx c{(int)threadIdx.x, (int)blockDim.x, sm};
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int nr = (int)(nrows - row0 < R ? nrows - row0 : R);
  pn::fwd_tile(n, l, c, obs, row0, nr, prm, prmB);
  for (int it = threadIdx.x; it < nr * n.A; it += blockDim.x)
    logits[row0 * n.A + it] = sm[l.logits + it];
  for (int r = threadIdx.x; r < nr; r += blockDim.x) value[row0 + r] = sm[l.value + r];
}

__global__ void __launch_bounds__(THREADS)
pn_grad_kernel(pn::Net n, int R, const uint16_t* __restrict__ obs, int64_t nrows,
               const float* __restrict__ rowin, const float* __restrict__ prm,
               const float* __restrict__ prmB, const float* __restrict__ prmT,
               float* __restrict__ slabs, int ng) {
  extern __shared__ __align__(16) float sm[];
  const pn::Lay l = pn::layout(n, R, true);
  const pn::Ctx c{(int)threadIdx.x, (int)blockDim.x, sm};
  float* slab = slabs + (int64_t)blockIdx.x * ng;
  for (int j = threadIdx.x; j < ng; j += blockDim.x) slab[j] = 0.0f;
  __syncthreads();
  const int64_t ntiles = (nrows + R - 1) / R;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t row0 = tile * R;
    const int nr = (int)(nrows - row0 < R ? nrows - row0 : R);
    pn::grad_rows(n, l, c, obs, row0, nr, rowin, prm, prmB, prmT, slab);
  }
}

__global__ void pn_reduce_kernel(const float* __restrict__ slabs, int nblocks, int ng,
                                 float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ng) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += slabs[(int64_t)b * ng + j];
  out[j] = s;
}

bool meta_ok(const pn::Net& n) {
  return n.P > 0 && n.F0 > 0 && n.hp > 0 && n.H > 0 && n.L >= 1 &&
         n.L <= pn::MAX_LAYERS && n.n_opt >= 1 && n.A >= n.P && n.A >= n.n_opt;
}

// rows per tile: the most (<= MAX_R) whose buffers fit in the opt-in
// shared memory of the current device
int plan(const pn::Net& n, bool bwd, int* R, size_t* smem) {
  if (!meta_ok(n)) return ERR_BAD_META;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  for (int r = MAX_R; r >= 1; --r) {
    const size_t bytes = (size_t)pn::layout(n, r, bwd).total * sizeof(float);
    if (bytes <= (size_t)max_smem) {
      *R = r;
      *smem = bytes;
      return 0;
    }
  }
  return ERR_NO_FIT;
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

int pn_meta_ints() { return pn::META_INTS; }

const char* pn_error_string(int code) {
  if (code == ERR_NO_FIT) return "a one-row tile does not fit in shared memory";
  if (code == ERR_BAD_META) return "unsupported net dims";
  return cudaGetErrorString((cudaError_t)code);
}

// out = [rows per tile, shared bytes, registers per thread] of the forward
// (bwd = 0) or gradient (bwd = 1) kernel on the current device
int pn_plan(const int32_t* meta, int bwd, int32_t* out) {
  const pn::Net n = pn::net_from_meta(meta);
  int R = 0;
  size_t smem = 0;
  if (int e = plan(n, bwd != 0, &R, &smem)) return e;
  cudaFuncAttributes attr;
  cudaError_t e = bwd ? cudaFuncGetAttributes(&attr, pn_grad_kernel)
                      : cudaFuncGetAttributes(&attr, pn_forward_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = R;
  out[1] = (int32_t)smem;
  out[2] = attr.numRegs;
  return 0;
}

// K2: logits (nrows, A) and value (nrows) of obs (nrows, F) bf16.
// Returns cudaGetLastError() after the launch (0 = launched).
int pn_forward(const int32_t* meta, const uint16_t* obs, int64_t nrows,
               const float* prm, const float* prmB, float* logits, float* value,
               void* stream) {
  const pn::Net n = pn::net_from_meta(meta);
  int R = 0;
  size_t smem = 0;
  if (int e = plan(n, false, &R, &smem)) return e;
  if (int e = allow_smem(pn_forward_kernel, smem)) return e;
  if (nrows <= 0) return 0;
  const int64_t grid = (nrows + R - 1) / R;
  pn_forward_kernel<<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(
      n, R, obs, nrows, prm, prmB, logits, value);
  return (int)cudaGetLastError();
}

// K3: out (n_params) = the parameter gradient of sum(dl * logits) +
// sum(dv * value) over all rows, rowin = dl | dv (nrows, A + 1). slabs holds
// max_blocks x n_params floats.
int pn_grad(const int32_t* meta, const uint16_t* obs, int64_t nrows, const float* rowin,
            const float* prm, const float* prmB, const float* prmT, float* slabs,
            int max_blocks, float* out, void* stream) {
  const pn::Net n = pn::net_from_meta(meta);
  int R = 0;
  size_t smem = 0;
  if (int e = plan(n, true, &R, &smem)) return e;
  if (int e = allow_smem(pn_grad_kernel, smem)) return e;
  const int ng = n.n_params;
  const int64_t ntiles = (nrows + R - 1) / R;
  const int grid = (int)(ntiles < max_blocks ? ntiles : max_blocks);
  cudaStream_t st = (cudaStream_t)stream;
  if (grid > 0) {
    pn_grad_kernel<<<grid, THREADS, smem, st>>>(n, R, obs, nrows, rowin, prm, prmB, prmT,
                                                slabs, ng);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  pn_reduce_kernel<<<(ng + THREADS - 1) / THREADS, THREADS, 0, st>>>(slabs, grid, ng, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
