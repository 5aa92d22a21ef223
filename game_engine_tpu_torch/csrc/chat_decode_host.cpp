// chat_decode_host.cpp — the chat decode kernel's body (chat_decode.cuh
// decode_context) compiled with g++ and run on the host: each stage loops
// over the block's thread ids in order, a context after another. The same
// arguments as cd_decode in chat_decode.cu, minus the stream; the CPU tests
// use it to run the kernel's own logic without a GPU.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC chat_decode_host.cpp -o libchat_decode_host.so

#include <vector>

#include "chat_decode.cuh"

extern "C" {

// chat_decode.cuh sizes: the blobs', a block's and a context's sizes.
void cd_sizes(const int32_t* dims, int threads, int64_t* out) { cd::sizes(dims, threads, out); }

// Returns 0, or 1 for bad dims, threads or counts.
int cd_decode_host(const uint16_t* wb, const float* wf, const int32_t* dims, int32_t* io,
                   float* kv, const float* u, float inv_temp, float top_p, int max_new,
                   float* logits, int n_ctx, int threads) {
  const cd::Dims d = cd::dims_of(dims);
  if (!cd::dims_ok(d) || !cd::threads_ok(threads) || n_ctx < 1 || max_new < 1) return 1;
  std::vector<float> smem((size_t)cd::work_floats(d, threads));
  const cd::Work w = cd::carve(smem.data(), d, threads);
  const cd::Net n{wb, wf, d};
  for (int64_t c = 0; c < n_ctx; ++c) {
    int32_t* row = io + c * (d.L + 1);
    cd::decode_context(n, w, threads, row + 1, row[0], kv + c * cd::kv_floats(d),
                       u != nullptr ? u + c * d.L : nullptr, inv_temp, top_p, max_new,
                       logits != nullptr ? logits + c * d.L * d.V : nullptr);
  }
  return 0;
}

}  // extern "C"
