// chat_decode_host.cpp — the chat decode's device programs (csrc/chat_decode.cu)
// compiled with g++ and run on the host, in their order: the prefill's rows
// and attention stages a layer at a time over every prompt row, each product
// output a sum of 16-deep partials (mma_partials); then each context's
// decode with the cluster's ranks as an outer loop inside each stage, the
// lanes of an output and the warps of a block as loops (lane_dot and the
// butterfly), the attention units' parts and their merge as on the card.
// The same arguments as cd_decode, minus the stream and the launch counts;
// the CPU tests use it to run the kernels' logic without a GPU.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC chat_decode_host.cpp -o libchat_decode_host.so

#include <vector>

#include "chat_decode.cuh"

namespace {

using namespace cd;

// the sum of a decode product's output: LANES lane partials, the butterfly
float out_sum(const float* a, const uint16_t* w, int K) {
  float v[LANES];
  for (int l = 0; l < LANES; ++l) v[l] = lane_dot(a, w, K, l);
  return butterfly(v, LANES);
}

// LayerNorm of a D-vector as one warp takes it
template <class Out>
void layer_norm(const float* x, const float* s, const float* b, int D, Out out) {
  float v[32];
  for (int l = 0; l < 32; ++l) v[l] = ln_lane_sum(x, D, l);
  const float m = butterfly(v, 32) / (float)D;
  for (int l = 0; l < 32; ++l) v[l] = ln_lane_var(x, D, l, m);
  const float var = butterfly(v, 32) / (float)D;
  for (int k = 0; k < D; ++k) out(k, ln_out(x[k], m, var, s[k], b[k]));
}

// cd_prefill_rows_kernel for every row
void prefill_rows(const Net& n, const int32_t* io, float* kv, const Rows& rw, int layer) {
  const Dims& d = n.d;
  const int D = d.D, H = d.H, L = d.L, hd = D / d.nh, half = hd / 2;
  std::vector<float> x(D), qkv(3 * D);
  std::vector<uint16_t> a(D), f(H);
  for (int r = 0; r < rw.R; ++r) {
    const int c = rw.cp[2 * r], p = rw.cp[2 * r + 1];
    if (layer == 0) {
      const int t = io[(int64_t)c * (L + 1) + 1 + p];
      for (int j = 0; j < D; ++j)
        x[j] = bf2f(n.tok()[(int64_t)t * D + j]) + n.pos()[(int64_t)p * D + j];
    } else {
      const int i = layer - 1;
      for (int j = 0; j < D; ++j) {
        x[j] = rw.X[(int64_t)r * D + j];
        a[j] = rw.O[(int64_t)r * D + j];
      }
      for (int j = 0; j < D; ++j)
        x[j] = epilogue(E_RESID, mma_partials(a.data(), n.wo(i) + (int64_t)j * D, D), x[j], 0.f);
      layer_norm(x.data(), n.norms().ln2_s(i), n.norms().ln2_b(i), D, [&](int k, float v) { a[k] = bf_bits(v); });
      for (int j = 0; j < H; ++j)
        f[j] = bf_bits(epilogue(E_GELU, mma_partials(a.data(), n.w1(i) + (int64_t)j * D, D), 0.f,
                                n.norms().b1(i)[j]));
      for (int j = 0; j < D; ++j)
        x[j] = epilogue(E_RESID_BIAS, mma_partials(f.data(), n.w2(i) + (int64_t)j * H, H), x[j],
                        n.norms().b2(i)[j]);
    }
    layer_norm(x.data(), n.norms().ln1_s(layer), n.norms().ln1_b(layer), D,
               [&](int k, float v) { a[k] = bf_bits(v); });
    for (int j = 0; j < 3 * D; ++j)
      qkv[j] = mma_partials(a.data(), n.wqkv(layer) + (int64_t)j * D, D);
    float* Kc = kv + c * kv_floats(d) + (int64_t)(2 * layer) * L * D;
    float* Vc = Kc + (int64_t)L * D;
    for (int hh = 0; hh < d.nh; ++hh)
      for (int e = 0; e < half; ++e) {
        const int a0 = hh * hd + e, a1 = a0 + half;
        const float cs = n.cos_()[(int64_t)p * half + e], sn = n.sin_()[(int64_t)p * half + e];
        float y1, y2;
        rope(qkv[a0], qkv[a1], cs, sn, &y1, &y2);
        rw.Q[(int64_t)r * D + a0] = y1;
        rw.Q[(int64_t)r * D + a1] = y2;
        rope(qkv[D + a0], qkv[D + a1], cs, sn, &y1, &y2);
        Kc[(int64_t)a0 * L + p] = y1;
        Kc[(int64_t)a1 * L + p] = y2;
      }
    for (int j = 0; j < D; ++j) Vc[(int64_t)p * D + j] = qkv[2 * D + j];
    if (layer + 1 < d.nl)
      for (int j = 0; j < D; ++j) rw.X[(int64_t)r * D + j] = x[j];
  }
}

// cd_prefill_attn_kernel for every row and head: a warp's lanes as loops
void prefill_attn(const Net& n, float* kv, const Rows& rw, int layer) {
  const Dims& d = n.d;
  const int D = d.D, L = d.L, hd = D / d.nh;
  const float sqrt_hd = (float)sqrt((double)hd);
  std::vector<float> sc(L);
  for (int r = 0; r < rw.R; ++r)
    for (int hh = 0; hh < d.nh; ++hh) {
      const int c = rw.cp[2 * r], p = rw.cp[2 * r + 1], nk = p + 1;
      const float* Kh = kv + c * kv_floats(d) + (int64_t)(2 * layer) * L * D + (int64_t)hh * hd * L;
      const float* Vh = kv + c * kv_floats(d) + (int64_t)(2 * layer + 1) * L * D + hh * hd;
      const float* q = rw.Q + (int64_t)r * D + hh * hd;
      float M = -INFINITY;
      for (int k = 0; k < nk; ++k) {
        sc[k] = score(q, Kh, L, k, hd, sqrt_hd);
        M = fmaxf(M, sc[k]);
      }
      float lanes[32];
      for (int l = 0; l < 32; ++l) {
        lanes[l] = 0.f;
        for (int k = l; k < nk; k += 32) {
          sc[k] = expf(sc[k] - M);
          lanes[l] += sc[k];
        }
      }
      const float S = butterfly(lanes, 32);
      for (int j = 0; j < hd; ++j) {
        float a = 0.f;
        for (int k = 0; k < nk; ++k) a += (sc[k] / S) * Vh[(int64_t)k * D + j];
        rw.O[(int64_t)r * D + hh * hd + j] = bf_bits(round_bf(a));
      }
    }
}

// An attention unit of the decode at position p: head hh, part s of the
// keys; writes the cache row p where the part holds it. Out: m, s, o[hd].
void decode_unit(const Dims& d, float* Kc, float* Vc, const float* qkv, const float* cs,
                 const float* sn, int p, int un, float* out, std::vector<float>& sc) {
  const int D = d.D, L = d.L, hd = D / d.nh, half = hd / 2, S = splits_of(d), MP = mix_parts(d);
  const int hh = un / S, s = un % S, nk = p + 1, per = part_per(nk, S);
  const int k0 = imin(nk, s * per), k1 = imin(nk, k0 + per);
  const float sqrt_hd = (float)sqrt((double)hd);
  const float *q = qkv + hh * hd, *kk = qkv + D + hh * hd, *vv = qkv + 2 * D + hh * hd;
  float* Kh = Kc + (int64_t)hh * hd * L;
  float* Vh = Vc + hh * hd;
  std::vector<float> uq(hd), uk(hd);
  for (int e = 0; e < half; ++e) {
    rope(q[e], q[e + half], cs[e], sn[e], &uq[e], &uq[e + half]);
    rope(kk[e], kk[e + half], cs[e], sn[e], &uk[e], &uk[e + half]);
  }
  if (k0 <= p && p < k1)
    for (int e = 0; e < hd; ++e) {
      Kh[(int64_t)e * L + p] = uk[e];
      Vh[(int64_t)p * D + e] = vv[e];
    }
  float M = -INFINITY;
  for (int k = k0; k < k1; ++k) {
    sc[k - k0] = score(uq.data(), Kh, L, k, hd, sqrt_hd);
    M = fmaxf(M, sc[k - k0]);
  }
  // a thread's keys k0 + tid, k0 + tid + T, ...; a warp's butterfly; the warps in order
  float ssum = 0.f;
  for (int w = 0; w < WARPS; ++w) {
    float lanes[32];
    for (int l = 0; l < 32; ++l) {
      lanes[l] = 0.f;
      for (int k = k0 + w * 32 + l; k < k1; k += DEC_THREADS) {
        sc[k - k0] = expf(sc[k - k0] - M);
        lanes[l] += sc[k - k0];
      }
    }
    const float ws = butterfly(lanes, 32);
    ssum = w == 0 ? ws : ssum + ws;
  }
  const int C2 = cdiv(k1 - k0, MP);
  for (int j = 0; j < hd; ++j) {
    float a = 0.f;
    for (int qq = 0; qq < MP; ++qq) {
      const int a0 = k0 + qq * C2, a1 = imin(k1, a0 + C2);
      float pa = 0.f;
      for (int k = a0; k < a1; ++k) pa += sc[k - k0] * Vh[(int64_t)k * D + j];
      a = qq == 0 ? pa : a + pa;
    }
    out[2 + j] = a;
  }
  out[0] = M;
  out[1] = ssum;
}

// cd_decode_kernel for one context
void decode_context(const Net& n, int32_t* toks, int n0, float* kv, const float* u,
                    float inv_temp, float top_p, int max_new, float* logits) {
  const Dims& d = n.d;
  const int D = d.D, H = d.H, L = d.L, V = d.V, hd = D / d.nh, half = hd / 2;
  if (n0 >= L) return;
  const int S = splits_of(d), U = units_of(d), UF = unit_floats(d);
  std::vector<float> x(D), h(D), o(D), qkv(3 * D), f(H), parts(U * UF), lg(V), ps(V), ck(V),
      sc(L);
  std::vector<int> ord(V);
  int t = toks[n0 - 1], count = 0;
  for (int p = n0 - 1; p < L - 1; ++p) {
    for (int j = 0; j < D; ++j)
      x[j] = bf2f(n.tok()[(int64_t)t * D + j]) + n.pos()[(int64_t)p * D + j];
    const float* cs = n.cos_() + (int64_t)p * half;
    const float* sn = n.sin_() + (int64_t)p * half;
    for (int i = 0; i < d.nl; ++i) {
      float* Kc = kv + (int64_t)(2 * i) * L * D;
      float* Vc = Kc + (int64_t)L * D;
      layer_norm(x.data(), n.norms().ln1_s(i), n.norms().ln1_b(i), D, [&](int k, float v) { h[k] = v; });
      for (int r = 0; r < CLUSTER; ++r)
        for (int j = slice_lo(3 * D, r); j < slice_lo(3 * D, r) + slice_n(3 * D, r); ++j)
          qkv[j] = out_sum(h.data(), n.wqkv(i) + (int64_t)j * D, D);
      for (int r = 0; r < CLUSTER; ++r)
        for (int un = r; un < U; un += CLUSTER)
          decode_unit(d, Kc, Vc, qkv.data(), cs, sn, p, un, parts.data() + un * UF, sc);
      for (int j = 0; j < D; ++j) {
        const float* pu = parts.data() + (j / hd) * S * UF;
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
      for (int r = 0; r < CLUSTER; ++r)
        for (int j = slice_lo(D, r); j < slice_lo(D, r) + slice_n(D, r); ++j)
          x[j] = epilogue(E_RESID, out_sum(o.data(), n.wo(i) + (int64_t)j * D, D), x[j], 0.f);
      layer_norm(x.data(), n.norms().ln2_s(i), n.norms().ln2_b(i), D, [&](int k, float v) { h[k] = v; });
      for (int r = 0; r < CLUSTER; ++r)
        for (int j = slice_lo(H, r); j < slice_lo(H, r) + slice_n(H, r); ++j)
          f[j] = epilogue(E_GELU, out_sum(h.data(), n.w1(i) + (int64_t)j * D, D), 0.f,
                          n.norms().b1(i)[j]);
      for (int r = 0; r < CLUSTER; ++r)
        for (int j = slice_lo(D, r); j < slice_lo(D, r) + slice_n(D, r); ++j)
          x[j] = epilogue(E_RESID_BIAS, out_sum(f.data(), n.w2(i) + (int64_t)j * H, H), x[j],
                          n.norms().b2(i)[j]);
    }
    layer_norm(x.data(), n.norms().lnf_s(), n.norms().lnf_b(), D, [&](int k, float v) { h[k] = v; });
    for (int r = 0; r < CLUSTER; ++r)
      for (int v = slice_lo(V, r); v < slice_lo(V, r) + slice_n(V, r); ++v)
        lg[v] = out_sum(h.data(), n.tok() + (int64_t)v * D, D);
    if (logits != nullptr)
      for (int v = 0; v < V; ++v) logits[(int64_t)p * V + v] = lg[v];
    int nxt;
    if (u == nullptr) {
      nxt = first_max(lg.data(), V);
    } else {
      for (int v = 0; v < V; ++v) ps[v] = lg[v] * inv_temp;
      for (int v = 0; v < V; ++v) {
        float m = ps[0];
        for (int y = 1; y < V; ++y) m = fmaxf(m, ps[y]);
        ord[desc_rank(ps.data(), V, v)] = v;
        ck[v] = expf(ps[v] - m);
      }
      nxt = nucleus(ps.data(), ck.data(), ord.data(), V, top_p, u[p]);
    }
    toks[p + 1] = nxt;
    ++count;
    if (nxt < NSPECIAL || count >= max_new) break;
    t = nxt;
  }
}

}  // namespace

extern "C" {

// chat_decode.cuh sizes, with `limit` bytes of shared memory a block.
int cd_sizes(const int32_t* dims, int64_t limit, int64_t* out) {
  return cd::sizes(dims, limit, out);
}

// Returns 0, or 1 for bad dims or counts.
int cd_decode_host(const uint16_t* wb, const float* wf, const int32_t* dims, int32_t* io,
                   float* kv, const float* u, float inv_temp, float top_p, int max_new,
                   float* logits, int n_ctx, const int32_t* rows, int n_rows, void* scratch) {
  const cd::Dims d = cd::dims_of(dims);
  if (!cd::dims_ok(d) || n_ctx < 1 || max_new < 1 || n_rows < 0) return 1;
  const cd::Net n{wb, wf, d};
  if (n_rows > 0) {
    const cd::Rows rw = cd::rows_of(scratch, rows, n_rows, d);
    for (int i = 0; i < d.nl; ++i) {
      prefill_rows(n, io, kv, rw, i);
      if (i + 1 < d.nl) prefill_attn(n, kv, rw, i);
    }
  }
  for (int64_t c = 0; c < n_ctx; ++c) {
    int32_t* row = io + c * (d.L + 1);
    decode_context(n, row + 1, row[0], kv + c * cd::kv_floats(d),
                   u != nullptr ? u + c * d.L : nullptr, inv_temp, top_p, max_new,
                   logits != nullptr ? logits + c * (int64_t)d.L * d.V : nullptr);
  }
  return 0;
}

}  // extern "C"
