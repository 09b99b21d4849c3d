// Single-token decode attention over a contiguous KV cache or a paged
// one, read in place through strides.
//
// Replaces the TPU kernels repro/kernels/decode_attention.py ::
// decode_attention_pallas (contiguous cache; the same function as the jnp
// decode path that repro/models/transformer.py::block_decode runs) and
// decode_attention_paged_pallas (a physical page pool addressed through a
// block table; repro/models/transformer.py::block_decode_paged).
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
//
// Head sizes: any multiple of 8 up to 256. The body is a template over
// DPL, the head-dim columns a lane owns in P @ V: 4 for hd <= 128, 8 for
// hd <= 256. The shared q and output rows are 32 * DPL wide. A row's
// walk, softmax and merge order depend on hd alone, so paged still gives
// contiguous's bits and a row's bits do not depend on the other rows.
//
// Paged: the kernel body is the same template, instantiated with another
// address policy. Only where a key's row is read changes: the lane at
// logical position p reads page table[b, p / bs] at offset p % bs (per
// lane, since with bs = 16 one 32-key tile spans two pages), and the V
// loop takes each key's row address from the lane that computed it. The
// walk, the online softmax and the merge order are untouched, so paged
// decode gives the same bits as contiguous decode over the same logical
// cache. Table entries >= num_blocks are unallocated sentinels: the
// kernel reads only positions below kv_len, and clamps an entry to the
// pool in any case, so a sentinel is never dereferenced.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;       // keys per tile == warp width
constexpr int WARPS = 8;
constexpr int MAX_G = 16;      // query rows per kv head
constexpr int MAX_HD = 256;
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
// A lane's DPL columns of a V row.
template <int DPL, typename T>
__device__ __forceinline__ void load_cols(const T* p, float* o) {
  if constexpr (DPL == 4) load4(p, o);
  else load8(p, o);
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

// Where the row of (batch b, kv head h, position pos) lives.
template <typename T>
struct ContiguousAddr {           // (B, Smax, Kv, hd) or (BKv, Smax, hd)
  const T* k;
  const T* v;
  int64_t sb, ss, sh, vsb, vss, vsh;
  __device__ __forceinline__ const T* krow(int b, int h, int pos) const {
    return k + b * sb + h * sh + (int64_t)pos * ss;
  }
  __device__ __forceinline__ const T* vrow(int b, int h, int pos) const {
    return v + b * vsb + h * vsh + (int64_t)pos * vss;
  }
};

template <typename T>
struct PagedAddr {                // pools (NB, bs, Kv, hd) or (NB, bs, hd)
  const T* k;
  const T* v;
  const int32_t* table;           // (rows, mb)
  int nb, bs, mb;
  int64_t kblk, koff, kh, vblk, voff, vh;
  __device__ __forceinline__ int64_t page(int b, int pos) const {
    return min(table[(int64_t)b * mb + pos / bs], nb - 1);
  }
  __device__ __forceinline__ const T* krow(int b, int h, int pos) const {
    return k + page(b, pos) * kblk + (pos % bs) * koff + h * kh;
  }
  __device__ __forceinline__ const T* vrow(int b, int h, int pos) const {
    return v + page(b, pos) * vblk + (pos % bs) * voff + h * vh;
  }
};

template <typename T, typename Addr, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const T* __restrict__ q,     // (BKv, G, hd)
                        const Addr addr,             // the K/V rows
                        const int32_t* __restrict__ kv_len,  // (BKv,)
                        T* __restrict__ out,         // (BKv, G, hd)
                        int G, int hd, int n_kv_heads, int smax,
                        float scale, float softcap, int window) {
  constexpr int HD_CAP = 32 * DPL;
  __shared__ float qs[MAX_G][HD_CAP];
  __shared__ float acc_s[MAX_G][HD_CAP];
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
    // this lane's V row, handed to the other lanes in the weighted sum
    // (every key below len is read there, as keys before the window carry
    // p = 0)
    const T* vr = kpos < len ? addr.vrow(b, h, kpos) : nullptr;
    if (live) {
      const T* kr = addr.krow(b, h, kpos);
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
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vv[i] = 0.f;
      const T* vj = reinterpret_cast<const T*>(__shfl_sync(
          0xffffffffu, reinterpret_cast<unsigned long long>(vr), j));
      if (d0 < hd) load_cols<DPL>(vj + d0, vv);
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

template <typename T, typename Addr>
void launch(const void* q, const Addr& addr, const int32_t* lens, void* out,
            int BKv, int G, int hd, int n_kv_heads, int smax, float scale,
            float softcap, int window, cudaStream_t st) {
  auto kernel = hd <= 128 ? decode_attention_kernel<T, Addr, 4>
                          : decode_attention_kernel<T, Addr, 8>;
  kernel<<<BKv, WARPS * 32, 0, st>>>(
      static_cast<const T*>(q), addr, lens, static_cast<T*>(out), G, hd,
      n_kv_heads, smax, scale, softcap, window);
}

bool bad_sizes(int G, int hd) {
  return G < 1 || G > MAX_G || hd < 8 || hd > MAX_HD || hd % 8;
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
  if (bad_sizes(G, hd) || smax < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* lens = static_cast<const int32_t*>(kv_len);
  if (dtype == 0) {
    const ContiguousAddr<float> a{static_cast<const float*>(k),
                                  static_cast<const float*>(v), sb, ss, sh,
                                  vsb, vss, vsh};
    launch<float>(q, a, lens, out, BKv, G, hd, n_kv_heads, smax, scale,
                  softcap, window, st);
  } else if (dtype == 1) {
    const ContiguousAddr<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), sb, ss, sh, vsb, vss, vsh};
    launch<__nv_bfloat16>(q, a, lens, out, BKv, G, hd, n_kv_heads, smax,
                          scale, softcap, window, st);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// Paged: row bkv reads table row b = bkv / n_kv_heads and kv head
// h = bkv % n_kv_heads. k/v element (page, off, h, d) lives at base +
// page*kblk + off*koff + h*kh + d (elements; hd and every stride a
// multiple of 8, base pointers 16-byte aligned); table (rows, mb) int32,
// entries >= nb are sentinels. Same return codes as above.
extern "C" int hc_decode_attention_paged(
    const void* q, const void* k_pool, const void* v_pool,
    const void* table, const void* kv_len, void* out, int BKv, int G,
    int hd, int n_kv_heads, int nb, int bs, int mb, long long kblk,
    long long koff, long long kh, long long vblk, long long voff,
    long long vh, float scale, float softcap, int window, int dtype,
    void* stream) {
  if (bad_sizes(G, hd) || nb < 1 || bs < 1 || mb < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* lens = static_cast<const int32_t*>(kv_len);
  const int32_t* tbl = static_cast<const int32_t*>(table);
  if (dtype == 0) {
    const PagedAddr<float> a{static_cast<const float*>(k_pool),
                             static_cast<const float*>(v_pool), tbl, nb, bs,
                             mb, kblk, koff, kh, vblk, voff, vh};
    launch<float>(q, a, lens, out, BKv, G, hd, n_kv_heads, mb * bs, scale,
                  softcap, window, st);
  } else if (dtype == 1) {
    const PagedAddr<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), tbl, nb, bs, mb, kblk,
        koff, kh, vblk, voff, vh};
    launch<__nv_bfloat16>(q, a, lens, out, BKv, G, hd, n_kv_heads,
                          mb * bs, scale, softcap, window, st);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
