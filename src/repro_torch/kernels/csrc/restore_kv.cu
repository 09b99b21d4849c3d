// Grouped HCache restoration projection: K = RoPE(H @ Wk[row] + bk[row]),
// V = H @ Wv[row] + bv[row] for G layers in one launch.
//
// Replaces the TPU kernel repro/kernels/restore_kv.py ::
// restore_kv_grouped_pallas (and restore_kv_pallas, which is this kernel at
// G = 1 with rows = [0]).
//
// What bounds it on an H100: operations. One 8-layer group at S = 1024,
// D = 4096, KV = 4096 does 2 * 8 * 1024 * 4096 * 8192 ~ 550 GFLOP against
// ~0.7 GB of operands, far above the ~295 FLOP/byte ridge of bf16.
//
// What the design does about it: a block owns 64 tokens x one whole head
// (BN = HD) of both K and V, so one hidden tile staged in shared memory
// feeds both products and the rotate-half partner of every column is in
// the block. The weights are addressed as stack[rows[g]] inside the
// kernel, so no G x D x KV gather is materialised before the launch. bf16
// runs on the tensor cores through WMMA (16x16x16 bf16 products with fp32
// accumulators; 8 warps, each owning one 16-row slice and every other
// 16-column slice of K and of V); fp32 keeps exact fp32 products on the
// SIMT pipes (a 4 x HD/16 register tile per thread). After the D loop the
// accumulators are parked in shared memory and the epilogue adds the bias
// and applies RoPE from the fp32 cos/sin tables before writing in the
// hidden dtype. wgmma, TMA and a multi-stage pipeline are later work.
// Each output element is a sum over D in a fixed order that does not
// depend on where its row lands in a tile, so prefill, decode and
// restoration, which all call this kernel, give bitwise-equal K/V for
// equal inputs (chip_smoke.py checks this on the card).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;       // rows (tokens) per block
constexpr int BK = 32;       // D chunk staged per iteration
constexpr int TX = 16;       // thread columns
constexpr int TY = 16;       // thread rows
constexpr int TM = BM / TY;  // rows per thread

// ------------------------------------------------------ fp32: SIMT FMA
template <int HD>
__global__ void __launch_bounds__(TX * TY)
restore_kv_grouped_simt(const float* __restrict__ hidden,   // (G, S, D)
                        const float* __restrict__ wk,       // (A, D, KV)
                        const float* __restrict__ wv,       // (A, D, KV)
                        const float* __restrict__ bk,       // (A, KV) or null
                        const float* __restrict__ bv,       // (A, KV) or null
                        const int32_t* __restrict__ rows,   // (G,)
                        const float* __restrict__ cos_t,    // (S, HD/2)
                        const float* __restrict__ sin_t,    // (S, HD/2)
                        float* __restrict__ k_out,          // (G, S, KV)
                        float* __restrict__ v_out,          // (G, S, KV)
                        int S, int D, int KV, int use_rope) {
  constexpr int TN = HD / TX;   // columns per thread
  constexpr int HALF = HD / 2;
  __shared__ float smem[BM * BK + 2 * BK * HD];
  float* hs = smem;                 // (BM, BK)
  float* wks = smem + BM * BK;      // (BK, HD)
  float* wvs = wks + BK * HD;       // (BK, HD)

  const int g = blockIdx.z;
  const int n0 = blockIdx.y * HD;   // first column of this head
  const int s0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t row = rows[g];

  const float* hg = hidden + (int64_t)g * S * D;
  const float* wkr = wk + row * (int64_t)D * KV;
  const float* wvr = wv + row * (int64_t)D * KV;

  float acc_k[TM][TN];
  float acc_v[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int e = tid; e < BM * BK; e += TX * TY) {
      const int r = e / BK, c = e % BK;
      const int s = s0 + r, d = k0 + c;
      hs[e] = (s < S && d < D) ? hg[(int64_t)s * D + d] : 0.f;
    }
    for (int e = tid; e < BK * HD; e += TX * TY) {
      const int r = e / HD, c = e % HD;
      const int d = k0 + r;
      const int64_t off = (int64_t)d * KV + n0 + c;
      wks[e] = d < D ? wkr[off] : 0.f;
      wvs[e] = d < D ? wvr[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b_k[TN], b_v[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = hs[(ty + TY * i) * BK + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b_k[j] = wks[kk * HD + tx + TX * j];
        b_v[j] = wvs[kk * HD + tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_k[i][j] = fmaf(a[i], b_k[j], acc_k[i][j]);
          acc_v[i][j] = fmaf(a[i], b_v[j], acc_v[i][j]);
        }
    }
    __syncthreads();
  }

  // epilogue: bias, then park K in shared memory so each thread can read
  // the rotate-half partner of its columns
  float* ks = smem;                 // (BM, HD), reuses the staging buffer
  float* kg = k_out + (int64_t)g * S * KV;
  float* vg = v_out + (int64_t)g * S * KV;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = tx + TX * j;
    const float bkc = bk ? bk[row * KV + n0 + c] : 0.f;
    const float bvc = bv ? bv[row * KV + n0 + c] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + TY * i;
      ks[r * HD + c] = acc_k[i][j] + bkc;
      const int s = s0 + r;
      if (s < S) vg[(int64_t)s * KV + n0 + c] = acc_v[i][j] + bvc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = tx + TX * j;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + TY * i;
      const int s = s0 + r;
      if (s >= S) continue;
      float out = ks[r * HD + c];
      if (use_rope) {
        const int f = c < HALF ? c : c - HALF;
        const float cs = cos_t[(int64_t)s * HALF + f];
        const float sn = sin_t[(int64_t)s * HALF + f];
        const float x1 = ks[r * HD + f];
        const float x2 = ks[r * HD + f + HALF];
        out = c < HALF ? x1 * cs - x2 * sn : x1 * sn + x2 * cs;
      }
      kg[(int64_t)s * KV + n0 + c] = out;
    }
  }
}

// ---------------------------------------------------- bf16: tensor cores
constexpr int WBK = 32;            // D chunk per iteration
constexpr int WARPS = 8;
constexpr int HPAD = 8;            // shared-memory row padding (bf16)

__device__ __forceinline__ float bias_at(const __nv_bfloat16* b, int64_t i) {
  return b ? __bfloat162float(b[i]) : 0.f;
}

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
restore_kv_grouped_wmma(const __nv_bfloat16* __restrict__ hidden,
                        const __nv_bfloat16* __restrict__ wk,
                        const __nv_bfloat16* __restrict__ wv,
                        const __nv_bfloat16* __restrict__ bk,
                        const __nv_bfloat16* __restrict__ bv,
                        const int32_t* __restrict__ rows,
                        const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t,
                        __nv_bfloat16* __restrict__ k_out,
                        __nv_bfloat16* __restrict__ v_out,
                        int S, int D, int KV, int use_rope) {
  using namespace nvcuda;
  constexpr int CT = HD / 16;                 // 16-column slices per head
  constexpr int NF = (CT + 1) / 2;            // slices per warp
  constexpr int HLD = WBK + HPAD;             // hs row stride
  constexpr int WLD = HD + HPAD;              // ws row stride
  constexpr int CLD = HD + 4;                 // cs row stride (fp32)
  constexpr int STAGE = (BM * HLD + 2 * WBK * WLD) * 2;   // bytes
  constexpr int EPI = BM * CLD * 4;
  __shared__ __align__(32) unsigned char smem[STAGE > EPI ? STAGE : EPI];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wks = hs + BM * HLD;
  __nv_bfloat16* wvs = wks + WBK * WLD;
  float* cs = reinterpret_cast<float*>(smem);

  const int g = blockIdx.z;
  const int n0 = blockIdx.y * HD;
  const int s0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int rt = warp % 4;                    // this warp's 16-row slice
  const int64_t row = rows[g];
  const __nv_bfloat16* hg = hidden + (int64_t)g * S * D;
  const __nv_bfloat16* wkr = wk + row * (int64_t)D * KV;
  const __nv_bfloat16* wvr = wv + row * (int64_t)D * KV;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> ck[NF], cv[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::fill_fragment(ck[f], 0.f);
    wmma::fill_fragment(cv[f], 0.f);
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < D; k0 += WBK) {
    // 16-byte vectors: hidden tile BM x WBK, weight tiles WBK x HD
    for (int e = tid; e < BM * WBK / 8; e += WARPS * 32) {
      const int r = e / (WBK / 8), c = (e % (WBK / 8)) * 8;
      const int s = s0 + r, d = k0 + c;
      *reinterpret_cast<uint4*>(hs + r * HLD + c) =
          (s < S && d < D)
              ? *reinterpret_cast<const uint4*>(hg + (int64_t)s * D + d)
              : zero;
    }
    for (int e = tid; e < WBK * HD / 8; e += WARPS * 32) {
      const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
      const int d = k0 + r;
      const int64_t off = (int64_t)d * KV + n0 + c;
      *reinterpret_cast<uint4*>(wks + r * WLD + c) =
          d < D ? *reinterpret_cast<const uint4*>(wkr + off) : zero;
      *reinterpret_cast<uint4*>(wvs + r * WLD + c) =
          d < D ? *reinterpret_cast<const uint4*>(wvr + off) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, hs + rt * 16 * HLD + kk, HLD);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int ct = warp / 4 + 2 * f;
        if (ct >= CT) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bfrag;
        wmma::load_matrix_sync(bfrag, wks + kk * WLD + ct * 16, WLD);
        wmma::mma_sync(ck[f], a, bfrag, ck[f]);
        wmma::load_matrix_sync(bfrag, wvs + kk * WLD + ct * 16, WLD);
        wmma::mma_sync(cv[f], a, bfrag, cv[f]);
      }
    }
    __syncthreads();
  }

  constexpr int HALF = HD / 2;
  __nv_bfloat16* kg = k_out + (int64_t)g * S * KV;
  __nv_bfloat16* vg = v_out + (int64_t)g * S * KV;
  const __nv_bfloat16* bkr = bk ? bk + row * KV + n0 : nullptr;
  const __nv_bfloat16* bvr = bv ? bv + row * KV + n0 : nullptr;
  // K: park, then bias + RoPE
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int ct = warp / 4 + 2 * f;
    if (ct < CT)
      wmma::store_matrix_sync(cs + rt * 16 * CLD + ct * 16, ck[f], CLD,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < BM * HD; e += WARPS * 32) {
    const int r = e / HD, c = e % HD;
    const int s = s0 + r;
    if (s >= S) continue;
    float out = cs[r * CLD + c] + bias_at(bkr, c);
    if (use_rope) {
      const int f = c < HALF ? c : c - HALF;
      const float cs_ = cos_t[(int64_t)s * HALF + f];
      const float sn = sin_t[(int64_t)s * HALF + f];
      const float x1 = cs[r * CLD + f] + bias_at(bkr, f);
      const float x2 = cs[r * CLD + f + HALF] + bias_at(bkr, f + HALF);
      out = c < HALF ? x1 * cs_ - x2 * sn : x1 * sn + x2 * cs_;
    }
    kg[(int64_t)s * KV + n0 + c] = __float2bfloat16(out);
  }
  __syncthreads();
  // V: park, then bias
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int ct = warp / 4 + 2 * f;
    if (ct < CT)
      wmma::store_matrix_sync(cs + rt * 16 * CLD + ct * 16, cv[f], CLD,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < BM * HD; e += WARPS * 32) {
    const int r = e / HD, c = e % HD;
    const int s = s0 + r;
    if (s < S)
      vg[(int64_t)s * KV + n0 + c] =
          __float2bfloat16(cs[r * CLD + c] + bias_at(bvr, c));
  }
}

template <typename T, int HD>
void launch(const void* hidden, const void* wk, const void* wv,
            const void* bk, const void* bv, const int32_t* rows,
            const float* cos_t, const float* sin_t, void* k_out,
            void* v_out, int G, int S, int D, int KV, int use_rope,
            cudaStream_t stream) {
  dim3 grid((S + BM - 1) / BM, KV / HD, G);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    restore_kv_grouped_wmma<HD><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(hidden), static_cast<const T*>(wk),
        static_cast<const T*>(wv), static_cast<const T*>(bk),
        static_cast<const T*>(bv), rows, cos_t, sin_t,
        static_cast<T*>(k_out), static_cast<T*>(v_out), S, D, KV, use_rope);
  } else {
    restore_kv_grouped_simt<HD><<<grid, TX * TY, 0, stream>>>(
        static_cast<const T*>(hidden), static_cast<const T*>(wk),
        static_cast<const T*>(wv), static_cast<const T*>(bk),
        static_cast<const T*>(bv), rows, cos_t, sin_t,
        static_cast<T*>(k_out), static_cast<T*>(v_out), S, D, KV, use_rope);
  }
}

template <typename T>
int dispatch_hd(int hd, const void* hidden, const void* wk, const void* wv,
                const void* bk, const void* bv, const int32_t* rows,
                const float* cos_t, const float* sin_t, void* k_out,
                void* v_out, int G, int S, int D, int KV, int use_rope,
                cudaStream_t stream) {
  switch (hd) {
#define HC_CASE(N)                                                        \
  case N:                                                                 \
    launch<T, N>(hidden, wk, wv, bk, bv, rows, cos_t, sin_t, k_out, v_out, \
                 G, S, D, KV, use_rope, stream);                          \
    return 0;
    HC_CASE(64)
    HC_CASE(80)
    HC_CASE(96)
    HC_CASE(128)
#undef HC_CASE
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (bf16 needs D and KV multiples of 8 and
// 16-byte aligned tensors). Returns -1 for an unsupported head_dim or
// dtype, else the CUDA error of the launch (0 on success).
extern "C" int hc_restore_kv_grouped(
    const void* hidden, const void* wk, const void* wv, const void* bk,
    const void* bv, const void* rows, const void* cos_t, const void* sin_t,
    void* k_out, void* v_out, int G, int S, int D, int KV, int head_dim,
    int use_rope, int dtype, void* stream) {
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = dispatch_hd<float>(head_dim, hidden, wk, wv, bk, bv, r, c, s, k_out,
                            v_out, G, S, D, KV, use_rope, st);
  else if (dtype == 1)
    rc = dispatch_hd<__nv_bfloat16>(head_dim, hidden, wk, wv, bk, bv, r, c,
                                    s, k_out, v_out, G, S, D, KV, use_rope,
                                    st);
  else
    rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
