// chat_decode.cu — the chat LM's decode as one CUDA kernel launch (sm_90a).
//
// Counterpart of the JAX decoder game_engine_tpu/policies/chat_lm.py
// _make_decoder (:439): a jitted lax.scan over every position of a reply in
// one device dispatch. It has no pallas_call; XLA compiles the scan. The
// eager torch version of the same loop (policies/chat_decode.py decode_plain)
// launches some 130 kernels a position, tens of thousands a reply; this
// kernel decodes a whole reply, prompt and generated tokens, in one launch.
//
// Layout: a block a context (the grid covers a batch of contexts). The packed
// weights (bf16, the rounding every product of the model does; LayerNorm,
// biases, pos and the rope tables in float32) stay in global memory and are
// read through L2 at every position; the activations, scores and partial
// sums live in the block's shared memory (chat_decode.cuh carve); each
// context's K/V caches are float32 in global memory. Every product is the
// block's own loop: bf16 x bf16 products accumulated in float32.
//
// What bounds it: one block reads the 3.5 MB of bf16 weights of the four
// layers, and the caches up to the position, at every position, from L2,
// with a block barrier between dependent stages. It runs far below the card's
// memory rate; spreading a context's products over a cluster of SMs is the
// next step (ROADMAP queue 2 F).

#include <cuda_runtime.h>

#include "chat_decode.cuh"

namespace {

__global__ void __launch_bounds__(cd::MAX_THREADS)
    cd_decode_kernel(cd::Net n, int32_t* io, float* kv, const float* u, float inv_temp,
                     float top_p, int max_new, float* logits) {
  extern __shared__ float smem[];
  const cd::Dims& d = n.d;
  const int64_t c = blockIdx.x;
  const cd::Work w = cd::carve(smem, d, blockDim.x);
  int32_t* row = io + c * (d.L + 1);
  cd::decode_context(n, w, blockDim.x, row + 1, row[0], kv + c * cd::kv_floats(d),
                     u != nullptr ? u + c * d.L : nullptr, inv_temp, top_p, max_new,
                     logits != nullptr ? logits + c * d.L * d.V : nullptr);
}

}  // namespace

extern "C" {

const char* cd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// chat_decode.cuh sizes: the blobs', a block's and a context's sizes.
void cd_sizes(const int32_t* dims, int threads, int64_t* out) { cd::sizes(dims, threads, out); }

// Decodes n_ctx contexts in one launch on `stream`. io is (n_ctx, L + 1)
// int32: column 0 the prompt length n0, then the tokens, the prompt in
// [0, n0), the generated tokens written from n0 on. kv is n_ctx times
// kv_floats of scratch; u (n_ctx, L) the uniforms of a sampled decode or
// null; logits (n_ctx, L, V) or null. Returns a CUDA error code (0 = ok).
int cd_decode(const uint16_t* wb, const float* wf, const int32_t* dims, int32_t* io, float* kv,
              const float* u, float inv_temp, float top_p, int max_new, float* logits,
              int n_ctx, int threads, void* stream) {
  const cd::Dims d = cd::dims_of(dims);
  if (!cd::dims_ok(d) || !cd::threads_ok(threads) || n_ctx < 1 || max_new < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cd::work_floats(d, threads) * 4;
  cudaError_t e = cudaFuncSetAttribute(cd_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cd_decode_kernel<<<n_ctx, threads, smem, (cudaStream_t)stream>>>(
      cd::Net{wb, wf, d}, io, kv, u, inv_temp, top_p, max_new, logits);
  return (int)cudaGetLastError();
}

}  // extern "C"
