// Prefill (flash) attention: a block of queries against a key range, with
// GQA, causal and sliding-window masks, a logit softcap, a per-batch query
// offset and a per-batch live key count. Reads q (B, Sq, H, hd) and k/v
// (B, Skv, Kv, hd) in place through their strides; head h reads kv head
// h / (H / Kv). Writes out (B, Sq, H, hd), contiguous.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention_pallas, and computes what the JAX model's prefill path
// (repro/models/layers/attention.py::flash_attention_jnp) computes there:
// query row i of batch b sits at position q_offset[b] + i (the restored
// history's length in a prefill over history), and key j is visible to it
// iff j < kv_len[b], and j <= q_offset[b] + i when causal, and
// j > q_offset[b] + i - window with a window.
//
// What bounds it on an H100: operations, for the prompt lengths of the
// main path (a 1024-token self-prefill does ~4.3 GFLOP per layer in its
// causal band against ~25 MB of q, k, v and out); a short chunk over a
// long history sits near the ridge.
//
// What the design does about it: one block of 4 warps per (batch·head,
// 64-query tile). It loops over 64-key tiles from the first tile the
// window reaches to the last one below the causal frontier and kv_len, so
// a key tile that no query of the block can see is never read. Each tile
// of K and V is staged in shared memory (rows padded against bank
// conflicts); bf16 runs QK^T and PV on the tensor cores through WMMA
// (16x16x16, fp32 accumulators), fp32 on the SIMT pipes. Warp w owns
// query rows 16w..16w+15 from the scores to the output: it computes their
// score tile, takes their online softmax (running max, sum and rescale in
// fp32, a lane per column pair and warp shuffles for the row reductions)
// and accumulates their P V, so only staging K and V needs the whole
// block. P is rounded to the input dtype before P V, as the plain version
// does. Every sum runs in a fixed order and there are no atomics, so
// equal inputs give equal bits (the recompute replay relies on this).
// wgmma, TMA, pipelined staging and sharing a K/V tile between the heads
// of one GQA group are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;          // query rows per block
constexpr int BKN = 64;         // keys per tile
constexpr int WARPS = 4;        // warp w owns query rows 16w..16w+15
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;
constexpr int PAD = 8;          // elements of padding per smem row
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_offset;     // (B,)
  const int32_t* kv_len;       // (B,)
  void* out;                   // (B, Sq, H, hd)
  int Sq, Skv, H, group;       // group = H / Kv
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;   // elements
  float scale, softcap;        // softcap <= 0: none
  int causal, window;          // window <= 0: none
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared-memory row strides (elements)
template <int HD> struct Ld {
  static constexpr int T_ROW = HD + PAD;      // Q, K, V tiles
  static constexpr int S_ROW = BKN + PAD;     // scores (fp32)
  static constexpr int P_ROW = BKN + PAD;     // P (input dtype)
  static constexpr int O_ROW = HD + PAD;      // output accumulators (fp32)
};

// Stage `rows` rows of HD elements (row r at src + r * stride) into dst
// (row-major, Ld::T_ROW apart) with 16-byte copies; rows at or past `live`
// are zero-filled, so no value past kv_len (or past Sq) enters a product.
template <typename T, int HD>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride,
                                     int rows, int live) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < live)
      val = *reinterpret_cast<const uint4*>(src + (long long)r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Ld<HD>::T_ROW + c) = val;
  }
}

// This warp's scores: S[r0..r0+16) (x BKN, fp32) = Q K^T.
template <typename T, int HD>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* Ss,
                                       int r0) {
  using L = Ld<HD>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int j = 0; j < BKN / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + r0 * L::T_ROW + kk * 16, L::T_ROW);
        wmma::load_matrix_sync(b, Ks + (j * 16) * L::T_ROW + kk * 16,
                               L::T_ROW);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * L::S_ROW + j * 16, acc, L::S_ROW,
                              wmma::mem_row_major);
    }
  } else {
    // lane c computes columns c and c + 32 of every row of the warp
    const int lane = threadIdx.x % 32;
    for (int r = r0; r < r0 + ROWS; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d)
          s = fmaf(to_f(Qs[r * L::T_ROW + d]), to_f(Ks[c * L::T_ROW + d]), s);
        Ss[r * L::S_ROW + c] = s;
      }
    }
  }
}

// This warp's output rows: O[r0..r0+16) (x HD, fp32) += P V.
template <typename T, int HD>
__device__ __forceinline__ void accumulate_pv(const T* Ps, const T* Vs,
                                              float* Os, int r0) {
  using L = Ld<HD>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + r0 * L::O_ROW + j * 16, L::O_ROW,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + r0 * L::P_ROW + kk * 16, L::P_ROW);
        wmma::load_matrix_sync(b, Vs + (kk * 16) * L::T_ROW + j * 16,
                               L::T_ROW);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Os + r0 * L::O_ROW + j * 16, acc, L::O_ROW,
                              wmma::mem_row_major);
    }
  } else {
    // lane owns head-dim columns lane, lane + 32, ...
    const int lane = threadIdx.x % 32;
    for (int r = r0; r < r0 + ROWS; ++r) {
      for (int d = lane; d < HD; d += 32) {
        float o = Os[r * L::O_ROW + d];
        for (int c = 0; c < BKN; ++c)
          o = fmaf(to_f(Ps[r * L::P_ROW + c]), to_f(Vs[c * L::T_ROW + d]),
                   o);
        Os[r * L::O_ROW + d] = o;
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  // butterfly: every lane adds the same pairs, so all end with equal bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  using L = Ld<HD>;
  return sizeof(T) * ((BQ + 2 * BKN) * L::T_ROW + BQ * L::P_ROW)
         + sizeof(float) * (BQ * L::S_ROW + BQ * L::O_ROW);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(Params p) {
  using L = Ld<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);                // (BQ, T_ROW)
  T* Ks = Qs + BQ * L::T_ROW;                            // (BKN, T_ROW)
  T* Vs = Ks + BKN * L::T_ROW;                           // (BKN, T_ROW)
  T* Ps = Vs + BKN * L::T_ROW;                           // (BQ, P_ROW)
  float* Ss = reinterpret_cast<float*>(Ps + BQ * L::P_ROW);  // (BQ, S_ROW)
  float* Os = Ss + BQ * L::S_ROW;                        // (BQ, O_ROW)

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const int nq = min(BQ, p.Sq - q0);
  const int qoff = p.q_offset[b];
  const int klen = min(p.kv_len[b], p.Skv);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * ROWS;       // this warp's first query row

  // the key range any query of this block can see
  const int qlo = qoff + q0;
  const int qhi = qoff + q0 + nq - 1;
  int kend = klen;
  if (p.causal) kend = min(kend, qhi + 1);
  int kbeg = 0;
  if (p.window > 0) kbeg = max(0, qlo - p.window + 1);

  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh
                + (long long)q0 * p.qss;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;
  stage<T, HD>(Qs, qb, p.qss, BQ, nq);
  for (int r = r0; r < r0 + ROWS; ++r)
    for (int d = lane; d < HD; d += 32) Os[r * L::O_ROW + d] = 0.f;
  // running max and sum of row r0 + i live in lane i (i < ROWS)
  float m_run = NEG_INF, l_run = 0.f;

  for (int t0 = (kbeg / BKN) * BKN; t0 < kend; t0 += BKN) {
    __syncthreads();                      // every warp is done with K, V
    stage<T, HD>(Ks, kb + (long long)t0 * p.kss, p.kss, BKN, klen - t0);
    stage<T, HD>(Vs, vb + (long long)t0 * p.vss, p.vss, BKN, klen - t0);
    __syncthreads();
    scores<T, HD>(Qs, Ks, Ss, r0);
    __syncwarp();

    for (int i = 0; i < ROWS; ++i) {
      const int r = r0 + i;
      const int qp = qoff + q0 + r;
      float s2[2];
      bool ok2[2];
      float mx = NEG_INF;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = lane + 32 * hh;
        const int kp = t0 + c;
        float s = Ss[r * L::S_ROW + c] * p.scale;
        if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
        bool ok = r < nq && kp < klen;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        s2[hh] = s;
        ok2[hh] = ok;
        if (ok) mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = __shfl_sync(0xffffffffu, m_run, i);
      const float l_old = __shfl_sync(0xffffffffu, l_run, i);
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float pc = ok2[hh] ? expf(s2[hh] - m_new) : 0.f;
        sum += pc;
        Ps[r * L::P_ROW + lane + 32 * hh] = from_f<T>(pc);
      }
      sum = warp_sum(sum);
      const float corr = expf(m_old - m_new);
      if (lane == i) {
        m_run = m_new;
        l_run = l_old * corr + sum;
      }
      for (int d = lane; d < HD; d += 32) Os[r * L::O_ROW + d] *= corr;
    }
    __syncwarp();
    accumulate_pv<T, HD>(Ps, Vs, Os, r0);
  }
  __syncwarp();

  T* ob = static_cast<T*>(p.out);
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    const float l = __shfl_sync(0xffffffffu, l_run, i);
    if (r >= nq) continue;
    const long long o = (((long long)b * p.Sq + q0 + r) * p.H + h) * HD;
    for (int d = lane; d < HD; d += 32)
      ob[o + d] = from_f<T>(Os[r * L::O_ROW + d] / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q element (b, i, h, d) at q + b*qsb + i*qss + h*qsh + d; k/v likewise
// with their own strides (elements; every stride a multiple of 16 bytes'
// worth of elements, base pointers 16-byte aligned). hd in {64, 128},
// H a multiple of Kv. softcap <= 0 and window <= 0 mean "none". dtype:
// 0 = float32, 1 = bfloat16. Returns -1 for unsupported sizes, else the
// launch's CUDA error (0 on success).
extern "C" int hc_flash_attention(
    const void* q, const void* k, const void* v, const void* q_offset,
    const void* kv_len, void* out, int B, int Sq, int Skv, int H, int Kv,
    int hd, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, float softcap, int causal, int window,
    int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || Kv < 1 || H % Kv
      || (hd != 64 && hd != 128))
    return -1;
  Params p{q, k, v, static_cast<const int32_t*>(q_offset),
           static_cast<const int32_t*>(kv_len), out, Sq, Skv, H, H / Kv,
           qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scale, softcap,
           causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hd == 64 ? launch<float, 64>(p, B, st)
                    : launch<float, 128>(p, B, st);
  if (dtype == 1)
    return hd == 64 ? launch<__nv_bfloat16, 64>(p, B, st)
                    : launch<__nv_bfloat16, 128>(p, B, st);
  return -1;
}
