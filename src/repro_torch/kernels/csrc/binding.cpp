// Python binding of the port's CUDA kernels: the one file that includes
// PyTorch's headers. The kernel sources expose plain C launchers; the
// wrappers in repro_torch/kernels/*.py validate the tensors and pass their
// device addresses and sizes here as integers.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>

extern "C" int hc_restore_kv_grouped(
    const void* hidden, const void* wk, const void* wv, const void* bk,
    const void* bv, const void* rows, const void* cos_t, const void* sin_t,
    void* k_out, void* v_out, int G, int S, int D, int KV, int head_dim,
    int use_rope, int dtype, void* stream);

extern "C" int hc_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, int BKv, int G, int hd, int n_kv_heads, int smax, long long sb,
    long long ss, long long sh, long long vsb, long long vss, long long vsh,
    float scale, float softcap, int window, int dtype, void* stream);

namespace {

void* ptr(int64_t p) { return reinterpret_cast<void*>(p); }

void check(int rc, const char* name) {
  TORCH_CHECK(rc >= 0, name, ": unsupported shape or dtype");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  TORCH_CHECK(rc == 0, name, ": launch failed with CUDA error ", rc);
}

void restore_kv_grouped(int64_t hidden, int64_t wk, int64_t wv, int64_t bk,
                        int64_t bv, int64_t rows, int64_t cos_t,
                        int64_t sin_t, int64_t k_out, int64_t v_out, int G,
                        int S, int D, int KV, int head_dim, int use_rope,
                        int dtype, int64_t stream) {
  check(hc_restore_kv_grouped(ptr(hidden), ptr(wk), ptr(wv), ptr(bk),
                              ptr(bv), ptr(rows), ptr(cos_t), ptr(sin_t),
                              ptr(k_out), ptr(v_out), G, S, D, KV, head_dim,
                              use_rope, dtype, ptr(stream)),
        "restore_kv_grouped");
}

void decode_attention(int64_t q, int64_t k, int64_t v, int64_t kv_len,
                      int64_t out, int BKv, int G, int hd, int n_kv_heads,
                      int smax, int64_t sb, int64_t ss, int64_t sh,
                      int64_t vsb, int64_t vss, int64_t vsh, double scale,
                      double softcap, int window, int dtype,
                      int64_t stream) {
  check(hc_decode_attention(ptr(q), ptr(k), ptr(v), ptr(kv_len), ptr(out),
                            BKv, G, hd, n_kv_heads, smax, sb, ss, sh, vsb,
                            vss, vsh, static_cast<float>(scale),
                            static_cast<float>(softcap), window, dtype,
                            ptr(stream)),
        "decode_attention");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("restore_kv_grouped", &restore_kv_grouped);
  m.def("decode_attention", &decode_attention);
}
