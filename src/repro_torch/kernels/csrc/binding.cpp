// Python binding of the port's CUDA kernels: the one file that includes
// PyTorch's headers. The kernel sources expose plain C launchers; the
// wrappers in repro_torch/kernels/*.py validate the tensors and pass their
// device addresses and sizes here as integers.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>

extern "C" int hc_restore_kv_grouped(
    const void* hidden, const void* wk, const void* wv, const void* bk,
    const void* bv, const void* rows, const void* cos_t, const void* sin_t,
    void* k_out, void* v_out, int G, int S, int D, int KV, int A,
    int head_dim, int use_rope, int dtype, int plan_wg, int plan_pairs,
    int plan_both, int plan_stages, void* stream);

extern "C" int hc_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* ws_acc, void* ws_ml, void* tickets, int BKv, int G,
    int hd, int n_kv_heads, int smax, long long sb, long long ss,
    long long sh, long long vsb, long long vss, long long vsh, float scale,
    float softcap, int window, int dtype, int splits, int split_keys,
    void* stream);

extern "C" int hc_decode_attention_paged(
    const void* q, const void* k_pool, const void* v_pool,
    const void* table, const void* kv_len, void* out, void* ws_acc,
    void* ws_ml, void* tickets, int BKv, int G, int hd, int n_kv_heads,
    int nb, int bs, int mb, long long kblk, long long koff, long long kh,
    long long vblk, long long voff, long long vh, float scale, float softcap,
    int window, int dtype, int splits, int split_keys, void* stream);

extern "C" int hc_flash_attention(
    const void* q, const void* k, const void* v, const void* q_offset,
    const void* kv_len, void* out, void* part_o, void* part_ml, int B,
    int Sq, int Skv, int H, int Kv, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale, float softcap,
    int causal, int window, int dtype, int plan_hdp, int plan_bn,
    int plan_stages, int plan_hpb, int plan_q_tiles, int plan_head_blocks,
    int plan_splits, int plan_split_keys, void* stream);

extern "C" int hc_ssm_update(const void* h, void* h_out, const void* dt,
                             const void* x, const void* A, const void* Bm,
                             const void* Cm, const void* D, void* y, int Bt,
                             int I, int N, int S, long long dt_sb,
                             long long dt_ss, long long x_sb, long long x_ss,
                             long long b_sb, long long b_ss, long long c_sb,
                             long long c_ss, long long y_sb, long long y_ss,
                             int dtype, int tokens, int stages, void* stream);

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
                        int S, int D, int KV, int A, int head_dim,
                        int use_rope, int dtype, int plan_wg, int plan_pairs,
                        int plan_both, int plan_stages, int64_t stream) {
  check(hc_restore_kv_grouped(ptr(hidden), ptr(wk), ptr(wv), ptr(bk),
                              ptr(bv), ptr(rows), ptr(cos_t), ptr(sin_t),
                              ptr(k_out), ptr(v_out), G, S, D, KV, A,
                              head_dim, use_rope, dtype, plan_wg, plan_pairs,
                              plan_both, plan_stages, ptr(stream)),
        "restore_kv_grouped");
}

void decode_attention(int64_t q, int64_t k, int64_t v, int64_t kv_len,
                      int64_t out, int64_t ws_acc, int64_t ws_ml,
                      int64_t tickets, int BKv, int G, int hd,
                      int n_kv_heads, int smax, int64_t sb, int64_t ss,
                      int64_t sh, int64_t vsb, int64_t vss, int64_t vsh,
                      double scale, double softcap, int window, int dtype,
                      int splits, int split_keys, int64_t stream) {
  check(hc_decode_attention(ptr(q), ptr(k), ptr(v), ptr(kv_len), ptr(out),
                            ptr(ws_acc), ptr(ws_ml), ptr(tickets), BKv, G,
                            hd, n_kv_heads, smax, sb, ss, sh, vsb, vss, vsh,
                            static_cast<float>(scale),
                            static_cast<float>(softcap), window, dtype,
                            splits, split_keys, ptr(stream)),
        "decode_attention");
}

void decode_attention_paged(int64_t q, int64_t k_pool, int64_t v_pool,
                            int64_t table, int64_t kv_len, int64_t out,
                            int64_t ws_acc, int64_t ws_ml, int64_t tickets,
                            int BKv, int G, int hd, int n_kv_heads, int nb,
                            int bs, int mb, int64_t kblk, int64_t koff,
                            int64_t kh, int64_t vblk, int64_t voff,
                            int64_t vh, double scale, double softcap,
                            int window, int dtype, int splits,
                            int split_keys, int64_t stream) {
  check(hc_decode_attention_paged(
            ptr(q), ptr(k_pool), ptr(v_pool), ptr(table), ptr(kv_len),
            ptr(out), ptr(ws_acc), ptr(ws_ml), ptr(tickets), BKv, G, hd,
            n_kv_heads, nb, bs, mb, kblk, koff, kh, vblk, voff, vh,
            static_cast<float>(scale), static_cast<float>(softcap), window,
            dtype, splits, split_keys, ptr(stream)),
        "decode_attention_paged");
}

void flash_attention(int64_t q, int64_t k, int64_t v, int64_t q_offset,
                     int64_t kv_len, int64_t out, int64_t part_o,
                     int64_t part_ml, int B, int Sq, int Skv, int H, int Kv,
                     int hd, int64_t qsb, int64_t qss, int64_t qsh,
                     int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                     int64_t vss, int64_t vsh, double scale, double softcap,
                     int causal, int window, int dtype, int plan_hdp,
                     int plan_bn, int plan_stages, int plan_hpb,
                     int plan_q_tiles, int plan_head_blocks, int plan_splits,
                     int plan_split_keys, int64_t stream) {
  check(hc_flash_attention(ptr(q), ptr(k), ptr(v), ptr(q_offset),
                           ptr(kv_len), ptr(out), ptr(part_o), ptr(part_ml),
                           B, Sq, Skv, H, Kv, hd, qsb, qss, qsh, ksb, kss,
                           ksh, vsb, vss, vsh, static_cast<float>(scale),
                           static_cast<float>(softcap), causal, window,
                           dtype, plan_hdp, plan_bn, plan_stages, plan_hpb,
                           plan_q_tiles, plan_head_blocks, plan_splits,
                           plan_split_keys, ptr(stream)),
        "flash_attention");
}

void ssm_update(int64_t h, int64_t h_out, int64_t dt, int64_t x, int64_t A,
                int64_t Bm, int64_t Cm, int64_t D, int64_t y, int Bt, int I,
                int N, int S, int64_t dt_sb, int64_t dt_ss, int64_t x_sb,
                int64_t x_ss, int64_t b_sb, int64_t b_ss, int64_t c_sb,
                int64_t c_ss, int64_t y_sb, int64_t y_ss, int dtype,
                int tokens, int stages, int64_t stream) {
  check(hc_ssm_update(ptr(h), ptr(h_out), ptr(dt), ptr(x), ptr(A), ptr(Bm),
                      ptr(Cm), ptr(D), ptr(y), Bt, I, N, S, dt_sb, dt_ss,
                      x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss, dtype,
                      tokens, stages, ptr(stream)),
        "ssm_update");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("restore_kv_grouped", &restore_kv_grouped);
  m.def("decode_attention", &decode_attention);
  m.def("decode_attention_paged", &decode_attention_paged);
  m.def("flash_attention", &flash_attention);
  m.def("ssm_update", &ssm_update);
}
