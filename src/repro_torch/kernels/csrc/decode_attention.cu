// Single-token decode attention over a contiguous KV cache, read in place
// through its strides.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py ::
// decode_attention_pallas (the same function as the jnp decode path that
// repro/models/transformer.py::block_decode runs).
//
// What bounds it on an H100: bytes. Each (batch, kv head) reads its live
// K and V once, 2 * kv_len * hd * 2 bytes in bf16, and does ~4 FLOP per
// element read per query row, far below the ~295 FLOP/byte ridge.
//
// What the design does about it: one block per (batch, kv head), so the
// cache is read once for the G query rows that share the kv head. The
// block's 8 warps split the live positions: warp w walks key tiles w,
// w + 8, ... of 32 keys, one key per lane, and keeps its own online
// softmax (running max and sum) and output rows in fp32 registers. A lane
// reads its key's row with 16-byte loads; for the weighted sum each lane
// owns 4 contiguous head-dim columns, so a warp reads a V row in one
// coalesced access. Tiles past kv_len and before the window are never
// read. The cache is addressed through its (batch, seq, head) strides, so
// the (B, Smax, Kv, hd) cache is never transposed or copied. At the end
// the warps' partial results are merged in a fixed order (no atomics), so
// equal inputs give bitwise-equal outputs. Split-K across blocks
// (flash-decoding) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;       // keys per tile == warp width
constexpr int WARPS = 8;
constexpr int MAX_G = 16;      // query rows per kv head
constexpr int MAX_HD = 128;
constexpr int DPL = 4;         // head-dim columns per lane in P @ V
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const T* __restrict__ q,     // (BKv, G, hd)
                        const T* __restrict__ k,     // strided cache
                        const T* __restrict__ v,
                        const int32_t* __restrict__ kv_len,  // (BKv,)
                        T* __restrict__ out,         // (BKv, G, hd)
                        int G, int hd, int n_kv_heads, int smax,
                        int64_t sb, int64_t ss, int64_t sh,  // k strides
                        int64_t vsb, int64_t vss, int64_t vsh,
                        float scale, float softcap, int window) {
  __shared__ float qs[MAX_G][MAX_HD];
  __shared__ float acc_s[MAX_G][MAX_HD];
  __shared__ float m_s[WARPS][MAX_G];
  __shared__ float l_s[WARPS][MAX_G];

  const int bkv = blockIdx.x;
  const int b = bkv / n_kv_heads;
  const int h = bkv % n_kv_heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = min(kv_len[bkv], smax);

  const T* qb = q + (int64_t)bkv * G * hd;
  for (int e = tid; e < G * hd; e += WARPS * 32) {
    qs[e / hd][e % hd] = to_f(qb[e]) * scale;
    acc_s[e / hd][e % hd] = 0.f;
  }
  __syncthreads();
  const T* kb = k + b * sb + h * sh;
  const T* vb = v + b * vsb + h * vsh;
  const int d0 = lane * DPL;          // this lane's P @ V columns

  float m[MAX_G], l[MAX_G], acc[MAX_G][DPL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  // live tiles: [first, last); a window keeps kpos > len - 1 - window
  int first = 0;
  if (window > 0 && len - window > 0) first = (len - window) / TILE;
  const int last = (len + TILE - 1) / TILE;
  for (int t = first + warp; t < last; t += WARPS) {
    const int kpos = t * TILE + lane;
    bool live = kpos < len;
    if (window > 0) live = live && kpos > len - 1 - window;
    float s[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) s[g] = 0.f;
    if (live) {
      const T* kr = kb + (int64_t)kpos * ss;
      for (int d = 0; d < hd; d += 8) {
        float kv8[8];
        load8(kr + d, kv8);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int i = 0; i < 8; ++i) s[g] = fmaf(qs[g][d + i], kv8[i], s[g]);
        }
      }
    }
    float p[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      float sg = s[g];
      if (softcap > 0.f) sg = tanhf(sg / softcap) * softcap;
      sg = live ? sg : NEG_INF;
      float mx = sg;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      p[g] = expf(sg - m_new);
      const float corr = expf(m[g] - m_new);
      float ps = p[g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[g] = l[g] * corr + ps;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= corr;
    }
    const int n_keys = min(TILE, len - t * TILE);
    for (int j = 0; j < n_keys; ++j) {
      float vv[DPL] = {0.f, 0.f, 0.f, 0.f};
      if (d0 < hd) load4(vb + (int64_t)(t * TILE + j) * vss + d0, vv);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pj, vv[i], acc[g][i]);
      }
    }
  }

  // merge the warps' partial softmax states in a fixed order
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();
  float factor[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= G) break;
    float mg = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mg = fmaxf(mg, m_s[w][g]);
    factor[g] = expf(m[g] - mg);
  }
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w && d0 < hd) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc_s[g][d0 + i] += acc[g][i] * factor[g];
      }
    }
    __syncthreads();
  }
  T* ob = out + (int64_t)bkv * G * hd;
  for (int e = tid; e < G * hd; e += WARPS * 32) {
    const int g = e / hd;
    float mg = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mg = fmaxf(mg, m_s[w][g]);
    float lg = 0.f;
    for (int w = 0; w < WARPS; ++w) lg += l_s[w][g] * expf(m_s[w][g] - mg);
    ob[e] = from_f<T>(acc_s[g][e % hd] / fmaxf(lg, 1e-30f));
  }
}

}  // namespace

// k/v element (bkv, s, d) lives at base + b*sb + s*ss + h*sh + d with
// b = bkv / n_kv_heads, h = bkv % n_kv_heads (strides in elements; hd and
// every stride a multiple of 8, base pointers 16-byte aligned).
// softcap <= 0 and window <= 0 mean "none". dtype: 0 = float32,
// 1 = bfloat16. Returns -1 for unsupported sizes, else the launch's CUDA
// error (0 on success).
extern "C" int hc_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, int BKv, int G, int hd, int n_kv_heads, int smax, long long sb,
    long long ss, long long sh, long long vsb, long long vss, long long vsh,
    float scale, float softcap, int window, int dtype, void* stream) {
  if (G < 1 || G > MAX_G || hd < 8 || hd > MAX_HD || hd % 8 || smax < 1)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* lens = static_cast<const int32_t*>(kv_len);
  if (dtype == 0)
    decode_attention_kernel<float><<<BKv, WARPS * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lens, static_cast<float*>(out), G, hd,
        n_kv_heads, smax, sb, ss, sh, vsb, vss, vsh, scale, softcap, window);
  else if (dtype == 1)
    decode_attention_kernel<__nv_bfloat16><<<BKv, WARPS * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lens,
        static_cast<__nv_bfloat16*>(out), G, hd, n_kv_heads, smax, sb, ss,
        sh, vsb, vss, vsh, scale, softcap, window);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
