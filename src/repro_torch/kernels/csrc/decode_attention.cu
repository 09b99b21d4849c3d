// Single-token decode attention over a contiguous KV cache or a paged
// one, read in place, as one split-K (flash-decoding) kernel body.
//
// Replaces the TPU kernels repro/kernels/decode_attention.py ::
// decode_attention_pallas (contiguous cache; the function that
// repro/models/transformer.py::block_decode runs) and
// decode_attention_paged_pallas (a physical page pool addressed through a
// block table; repro/models/transformer.py::block_decode_paged).
//
// What bounds it on an H100: bytes. A (batch, kv head) row reads its live
// K and V once, 2 * kv_len * hd * 2 bytes in bf16, and does ~4 FLOP per
// element read per query row, far below the ~295 FLOP/byte ridge. Reaching
// the 3.35 TB/s takes tens of KB in flight on each of the 132 SMs, so the
// work is cut across many blocks, several resident on each SM, each with
// three tiles of K or V in flight.
//
// The split rule. Each row's live range [window start, kv_len) is cut at
// fixed key boundaries, multiples of split_keys (128, the same for every
// head size and launch: kernels/decode_attention.py::decode_plan), and
// each (row, split) is one block. The rule ignores the batch, the other
// rows' lengths, the cache's capacity and the SM count, as flash-decoding
// plans usually do not: the engine's recompute replay rebuilds a paused
// session's K/V by decoding it again through the contiguous cache, in
// another batch at another capacity, where the original step may have
// been paged, and must get the same bits. So every choice that could
// change a row's bits (which keys share a split, a tile, a lane; the
// order of every sum) is a function of the row's own length, window, G,
// hd, dtype and data. The grid has ceil(capacity / split_keys) splits
// per row; a block whose split holds no live key exits at once.
//
// A block (4 warps) issues its first K tiles before it loads q, then
// streams the split's K tiles and then its V tiles through a 4-stage ring
// of 32-key tiles in shared memory, by cp.async 16-byte copies (rows
// outside the live range are zero-filled, not read). The address of each
// copy comes from the address policy: strides for the contiguous cache;
// for the pool, the page of each of the split's positions is looked up in
// the block table once, at the block's start, into shared memory as the
// row's K and V offsets. One body therefore serves both policies, and
// paged decode gives the bits of contiguous decode over the same logical
// cache. K pass: four lanes per key read its row from shared memory (rows
// padded so the reads are bank-conflict free) and dot it with the G query
// rows, held in shared memory in fp32 and pre-scaled; the fp32 scores of
// the whole split stay in shared memory. Then the split's max,
// P = exp(s - max) in fp32 and its sum. V pass: each warp takes a quarter
// of each tile's keys, each lane 8 head-dim columns, and sums P V in
// fp32; P is never rounded. The warps' sums are added in warp order.
//
// The merge. A row with one live split writes its output directly.
// Otherwise each split writes (max, sum, acc) in fp32 to a workspace the
// wrapper allocates, and takes a ticket (an atomic counter per row, the
// only atomic, which never touches a sum); the block that takes the last
// ticket merges the row's splits in split order, so the bits do not
// depend on which block finished last, and resets the ticket to zero for
// the next launch. A row with no live key (kv_len <= 0) gets zeros, as
// the Pallas kernels give.
//
// Head sizes: any multiple of 8 up to 256; G 1-16 (the body is a template
// over G rounded up to a power of two); bf16 and fp32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;
constexpr int TK = 32;                 // keys per staged tile
constexpr int KL = THREADS / TK;       // lanes per key in the K pass
constexpr int MAX_G = 16;
constexpr int MAX_HD = 256;
constexpr int MAX_SPLIT_KEYS = 512;
constexpr int MAX_SMEM = 232448;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 consecutive elements from shared memory, as fp32
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

// Address policies: row(b, h, ...) gives the (batch b, kv head h) row's
// K and V rows by absolute position.
template <typename T>
struct ContiguousAddr {           // (B, Smax, Kv, hd) or (BKv, Smax, hd)
  const T* k;
  const T* v;
  int64_t sb, ss, sh, vsb, vss, vsh;
  struct Row {
    const T* k;
    const T* v;
    int64_t ss, vss;
    __device__ __forceinline__ const T* krow(int pos) const {
      return k + (int64_t)pos * ss;
    }
    __device__ __forceinline__ const T* vrow(int pos) const {
      return v + (int64_t)pos * vss;
    }
  };
  static constexpr bool kShared = false;
  __device__ __forceinline__ Row row(int b, int h, int, int, int64_t*,
                                     int) const {
    return {k + b * sb + h * sh, v + b * vsb + h * vsh, ss, vss};
  }
};

template <typename T>
struct PagedAddr {                // pools (NB, bs, Kv, hd) or (NB, bs, hd)
  const T* k;
  const T* v;
  const int32_t* table;           // (rows, mb)
  int nb, bs, mb;
  int64_t kblk, koff, kh, vblk, voff, vh;
  struct Row {
    const T* k;
    const T* v;
    const int64_t* offs;          // shared: (K, V) offsets of [lo, hi)
    int lo;
    __device__ __forceinline__ const T* krow(int pos) const {
      return k + offs[2 * (pos - lo)];
    }
    __device__ __forceinline__ const T* vrow(int pos) const {
      return v + offs[2 * (pos - lo) + 1];
    }
  };
  static constexpr bool kShared = true;
  // Looks up the page of each position of [lo, hi) once, into shared
  // memory as the row's K and V offsets (the caller synchronises before
  // use). Entries >= nb are unallocated sentinels; only positions below
  // kv_len are read, and an entry is clamped to the pool in any case.
  __device__ __forceinline__ Row row(int b, int h, int lo, int hi,
                                     int64_t* offs, int tid) const {
    const int32_t* tb = table + (int64_t)b * mb;
    for (int i = tid; i < hi - lo; i += THREADS) {
      const int p = (lo + i) / bs;
      const int64_t page = min(tb[p], nb - 1);
      const int64_t off = lo + i - p * bs;
      offs[2 * i] = page * kblk + off * koff + h * kh;
      offs[2 * i + 1] = page * vblk + off * voff + h * vh;
    }
    return {k, v, offs, lo};
  }
};

struct Params {
  const void* q;                  // (BKv, G, hd)
  void* out;                      // (BKv, G, hd)
  const int32_t* kv_len;          // (BKv,)
  float* ws_acc;                  // (BKv, splits, G, hd) when splits > 1
  float* ws_ml;                   // (BKv, splits, G, 2): max, sum
  int* tickets;                   // (BKv,), zero between launches
  int G, hd, n_kv_heads, smax;
  int splits, split_keys;
  float scale, softcap;
  int window;
  int stride;                     // bytes per staged row
  int ring;                       // bytes of the ring (and the warps' sums)
};

template <typename T, typename Addr, int GB>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const Params p, const Addr addr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = p.G, hd = p.hd;
  const int S = p.split_keys;

  // the row's live keys [lo, hi), and its live splits [first, last]
  const int len = min(p.kv_len[row], p.smax);
  const int lo = p.window > 0 ? max(len - p.window, 0) : 0;
  const int hi = len;
  T* out = static_cast<T*>(p.out) + (int64_t)row * G * hd;
  if (hi <= lo) {                 // no live key: zeros, from split 0
    if (split == 0)
      for (int e = tid; e < G * hd; e += THREADS) out[e] = from_f<T>(0.f);
    return;
  }
  const int first = lo / S;
  const int last = (hi - 1) / S;
  if (split < first || split > last) return;
  const int n_live = last - first + 1;
  const int s0 = split * S;
  const int klo = max(lo, s0) - s0;          // live keys of this split,
  const int khi = min(hi, s0 + S) - s0;      // in split coordinates
  const int t0 = klo / TK;
  const int nt = (khi + TK - 1) / TK - t0;   // tiles of the split

  const int stride = p.stride;
  unsigned char* ring = smem;
  int64_t* offs = reinterpret_cast<int64_t*>(smem + p.ring);  // (S, 2)
  float* sc = reinterpret_cast<float*>(offs + (Addr::kShared ? 2 * S : 0));
  float* qs = sc + G * S;                    // (G, hd), pre-scaled
  float* red = qs + G * hd;                  // (WARPS, MAX_G)
  float* ml = red + WARPS * MAX_G;           // max (MAX_G), sum (MAX_G)
  int* flag = reinterpret_cast<int*>(ml + 2 * MAX_G);

  const int b = row / p.n_kv_heads, h = row % p.n_kv_heads;
  const typename Addr::Row R =
      addr.row(b, h, s0 + klo, s0 + khi, offs, tid);
  if (Addr::kShared) __syncthreads();
  const T* qb = static_cast<const T*>(p.q) + (int64_t)row * G * hd;

  // tile i < nt is K tile t0 + i, tile i >= nt V tile t0 + i - nt. This
  // thread copies 16-byte chunks (j, part) of a tile's rows, stepping by
  // the block's width without dividing in the loop.
  const int cpr = hd * (int)sizeof(T) / 16;  // 16-byte chunks per row
  const int j0 = tid / cpr, part0 = tid % cpr;
  const int jstep = THREADS / cpr, pstep = THREADS % cpr;
  auto issue = [&](int i) {
    if (i < 2 * nt) {
      const bool is_v = i >= nt;
      const int tk = (t0 + (is_v ? i - nt : i)) * TK;
      unsigned char* buf = ring + (i % STAGES) * TK * stride;
      for (int j = j0, part = part0; j < TK;) {
        const int kk = tk + j;
        const bool live = kk >= klo && kk < khi;
        const T* src = live ? (is_v ? R.vrow(s0 + kk) : R.krow(s0 + kk))
                            : static_cast<const T*>(qb);
        cp_async16(buf + j * stride + part * 16,
                   reinterpret_cast<const unsigned char*>(src) + part * 16,
                   live ? 16 : 0);
        j += jstep;
        part += pstep;
        if (part >= cpr) {
          part -= cpr;
          ++j;
        }
      }
    }
    cp_async_commit();
  };
  // K/V copies first, then q while they fly
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int e = tid; e < G * hd; e += THREADS) qs[e] = to_f(qb[e]) * p.scale;

  const int units = hd / 8;                  // 8-column units of a row
  // V pass: LK lanes per key (one unit each), KPW keys per warp step
  int LK = 1;
  while (LK < units) LK *= 2;
  const int KPW = 32 / LK;
  const int kg = lane / LK, u_v = lane % LK;
  const int keys_per_warp = TK / WARPS;

  float acc[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;

  for (int i = 0; i < 2 * nt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // tile i landed; tile i - 1's buffer is free
    issue(i + STAGES - 1);
    const unsigned char* buf = ring + (i % STAGES) * TK * stride;
    if (i < nt) {
      // scores of K tile t0 + i
      const int j = tid / KL, sub = tid % KL;
      const int kk = (t0 + i) * TK + j;
      const T* kr = reinterpret_cast<const T*>(buf + j * stride);
      float s[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) s[g] = 0.f;
      for (int u = sub; u < units; u += KL) {
        float kv[8];
        load8(kr + u * 8, kv);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
            float qv[8];
            load8(qs + g * hd + u * 8, qv);
#pragma unroll
            for (int e = 0; e < 8; ++e) s[g] = fmaf(qv[e], kv[e], s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int o = 1; o < KL; o <<= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      if (sub == 0 && kk >= klo && kk < khi) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
            float sg = s[g];
            if (p.softcap > 0.f) sg = tanhf(sg / p.softcap) * p.softcap;
            sc[g * S + kk] = sg;
          }
        }
      }
      continue;
    }
    if (i == nt) {
      // the split's softmax: max, P = exp(s - max) in place, sum
      float mx[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) mx[g] = NEG_INF;
      for (int kk = klo + tid; kk < khi; kk += THREADS)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          if (g < G) mx[g] = fmaxf(mx[g], sc[g * S + kk]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        for (int o = 16; o > 0; o >>= 1)
          mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
        if (lane == 0) red[warp * MAX_G + g] = mx[g];
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        mx[g] = red[g];
        for (int w = 1; w < WARPS; ++w)
          mx[g] = fmaxf(mx[g], red[w * MAX_G + g]);
      }
      __syncthreads();        // red is written again below
      float sm[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) sm[g] = 0.f;
      for (int kk = klo + tid; kk < khi; kk += THREADS)
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
            const float pg = expf(sc[g * S + kk] - mx[g]);
            sc[g * S + kk] = pg;
            sm[g] += pg;
          }
        }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        for (int o = 16; o > 0; o >>= 1)
          sm[g] += __shfl_xor_sync(0xffffffffu, sm[g], o);
        if (lane == 0) red[warp * MAX_G + g] = sm[g];
      }
      __syncthreads();        // P and the warps' sums are visible
      if (tid < G) {
        float l = 0.f;
        for (int w = 0; w < WARPS; ++w) l += red[w * MAX_G + tid];
        ml[MAX_G + tid] = l;
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g < G && tid == g) ml[g] = mx[g];
    }
    // P V over V tile t0 + i - nt: this warp's keys, LK lanes per key
    const int tk = (t0 + i - nt) * TK;
    if (u_v < units) {
      for (int j = warp * keys_per_warp + kg;
           j < (warp + 1) * keys_per_warp; j += KPW) {
        const int kk = tk + j;
        if (kk < klo || kk >= khi) continue;
        float vv[8];
        load8(reinterpret_cast<const T*>(buf + j * stride) + u_v * 8, vv);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
            const float pg = sc[g * S + kk];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pg, vv[e], acc[g][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  // the key groups of a warp, then the warps in order
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      for (int o = LK; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  __syncthreads();            // every warp is done with the ring
  float* wp = reinterpret_cast<float*>(ring);   // (WARPS, G, hd)
  if (kg == 0 && u_v < units) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wp[(warp * G + g) * hd + u_v * 8 + e] = acc[g][e];
  }
  __syncthreads();
  if (n_live == 1) {
    for (int e = tid; e < G * hd; e += THREADS) {
      float a = wp[e];
      for (int w = 1; w < WARPS; ++w) a += wp[w * G * hd + e];
      out[e] = from_f<T>(a / fmaxf(ml[MAX_G + e / hd], 1e-30f));
    }
    return;
  }
  const int64_t part = (int64_t)row * p.splits + split;
  for (int e = tid; e < G * hd; e += THREADS) {
    float a = wp[e];
    for (int w = 1; w < WARPS; ++w) a += wp[w * G * hd + e];
    p.ws_acc[part * G * hd + e] = a;
  }
  if (tid < G) {
    p.ws_ml[(part * G + tid) * 2] = ml[tid];
    p.ws_ml[(part * G + tid) * 2 + 1] = ml[MAX_G + tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(p.tickets + row, 1) == n_live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // the last block merges the row's splits, in split order
  const int64_t first_part = (int64_t)row * p.splits;
  for (int e = tid; e < G * hd; e += THREADS) {
    const int g = e / hd;
    float mg = NEG_INF;
#pragma unroll 8
    for (int sp = first; sp <= last; ++sp)
      mg = fmaxf(mg, __ldcg(p.ws_ml + ((first_part + sp) * G + g) * 2));
    float l = 0.f, a = 0.f;
#pragma unroll 8
    for (int sp = first; sp <= last; ++sp) {
      const float* m_l = p.ws_ml + ((first_part + sp) * G + g) * 2;
      const float w = expf(__ldcg(m_l) - mg);
      l += __ldcg(m_l + 1) * w;
      a += __ldcg(p.ws_acc + (first_part + sp) * G * hd + e) * w;
    }
    out[e] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
  if (tid == 0) p.tickets[row] = 0;
}

template <typename T, typename Addr, int GB>
int launch_g(const Params& p, const Addr& a, int BKv, int smem,
             cudaStream_t st) {
  auto kernel = decode_split_kernel<T, Addr, GB>;
  const cudaError_t attr =
      max_dynamic_smem(reinterpret_cast<const void*>(kernel), MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(BKv, p.splits), THREADS, smem, st>>>(p, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Addr>
int launch(Params p, const Addr& a, int BKv, bool paged, cudaStream_t st) {
  const int row_bytes = p.hd * (int)sizeof(T);
  // rows padded so that the lanes of a quarter warp hit distinct banks
  p.stride = (row_bytes + 127) / 128 * 128 + 16 * KL;
  // the ring also holds the warps' (G, hd) sums at the end, and the
  // splits' (max, sum) in the merge
  p.ring = max(STAGES * TK * p.stride, WARPS * p.G * p.hd * 4);
  const int smem = p.ring + (paged ? 16 * p.split_keys : 0)
      + 4 * (p.G * p.split_keys + p.G * p.hd + WARPS * MAX_G + 2 * MAX_G
             + 4);
  if (smem > MAX_SMEM) return -1;
  const int G = p.G;
  if (G <= 1) return launch_g<T, Addr, 1>(p, a, BKv, smem, st);
  if (G <= 2) return launch_g<T, Addr, 2>(p, a, BKv, smem, st);
  if (G <= 4) return launch_g<T, Addr, 4>(p, a, BKv, smem, st);
  if (G <= 8) return launch_g<T, Addr, 8>(p, a, BKv, smem, st);
  return launch_g<T, Addr, 16>(p, a, BKv, smem, st);
}

bool bad_plan(int BKv, int G, int hd, int smax, int splits,
              int split_keys) {
  return BKv < 1 || G < 1 || G > MAX_G || hd < 8 || hd > MAX_HD || hd % 8
      || smax < 1 || split_keys < TK || split_keys > MAX_SPLIT_KEYS
      || split_keys % TK || splits < 1 || splits > 65535
      || (long long)splits * split_keys < smax;
}

Params make_params(const void* q, void* out, const void* kv_len,
                   void* ws_acc, void* ws_ml, void* tickets, int G, int hd,
                   int n_kv_heads, int smax, int splits, int split_keys,
                   float scale, float softcap, int window) {
  Params p{};
  p.q = q;
  p.out = out;
  p.kv_len = static_cast<const int32_t*>(kv_len);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.tickets = static_cast<int*>(tickets);
  p.G = G;
  p.hd = hd;
  p.n_kv_heads = n_kv_heads;
  p.smax = smax;
  p.splits = splits;
  p.split_keys = split_keys;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  return p;
}

}  // namespace

// k/v element (bkv, s, d) lives at base + b*sb + s*ss + h*sh + d with
// b = bkv / n_kv_heads, h = bkv % n_kv_heads (strides in elements; hd and
// every stride a multiple of 8, base pointers 16-byte aligned).
// softcap <= 0 and window <= 0 mean "none". dtype: 0 = float32,
// 1 = bfloat16. The plan (decode_plan): splits per row in the grid and
// split_keys, a multiple of the 32-key tile. When splits > 1, ws_acc
// (BKv, splits, G, hd) and ws_ml (BKv, splits, G, 2) are fp32 scratch and
// tickets (BKv,) int32 holds zeros, which the kernel leaves as zeros. Returns -1 for
// unsupported sizes or plans, else the launch's CUDA error (0 on success).
extern "C" int hc_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* ws_acc, void* ws_ml, void* tickets, int BKv, int G,
    int hd, int n_kv_heads, int smax, long long sb, long long ss,
    long long sh, long long vsb, long long vss, long long vsh, float scale,
    float softcap, int window, int dtype, int splits, int split_keys,
    void* stream) {
  if (bad_plan(BKv, G, hd, smax, splits, split_keys)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = make_params(q, out, kv_len, ws_acc, ws_ml, tickets, G,
                               hd, n_kv_heads, smax, splits, split_keys,
                               scale, softcap, window);
  if (dtype == 0) {
    const ContiguousAddr<float> a{static_cast<const float*>(k),
                                  static_cast<const float*>(v), sb, ss, sh,
                                  vsb, vss, vsh};
    return launch<float>(p, a, BKv, false, st);
  }
  if (dtype == 1) {
    const ContiguousAddr<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), sb, ss, sh, vsb, vss, vsh};
    return launch<__nv_bfloat16>(p, a, BKv, false, st);
  }
  return -1;
}

// Paged: row bkv reads table row b = bkv / n_kv_heads and kv head
// h = bkv % n_kv_heads. k/v element (page, off, h, d) lives at base +
// page*kblk + off*koff + h*kh + d (elements; hd and every stride a
// multiple of 8, base pointers 16-byte aligned); table (rows, mb) int32,
// entries >= nb are sentinels. The plan and scratch as above, with
// capacity mb * bs. Same return codes as above.
extern "C" int hc_decode_attention_paged(
    const void* q, const void* k_pool, const void* v_pool,
    const void* table, const void* kv_len, void* out, void* ws_acc,
    void* ws_ml, void* tickets, int BKv, int G, int hd, int n_kv_heads,
    int nb, int bs, int mb, long long kblk, long long koff, long long kh,
    long long vblk, long long voff, long long vh, float scale, float softcap,
    int window, int dtype, int splits, int split_keys, void* stream) {
  if (nb < 1 || bs < 1 || mb < 1 ||
      bad_plan(BKv, G, hd, mb * bs, splits, split_keys))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = make_params(q, out, kv_len, ws_acc, ws_ml, tickets, G,
                               hd, n_kv_heads, mb * bs, splits, split_keys,
                               scale, softcap, window);
  const int32_t* tbl = static_cast<const int32_t*>(table);
  if (dtype == 0) {
    const PagedAddr<float> a{static_cast<const float*>(k_pool),
                             static_cast<const float*>(v_pool), tbl, nb, bs,
                             mb, kblk, koff, kh, vblk, voff, vh};
    return launch<float>(p, a, BKv, true, st);
  }
  if (dtype == 1) {
    const PagedAddr<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), tbl, nb, bs, mb, kblk,
        koff, kh, vblk, voff, vh};
    return launch<__nv_bfloat16>(p, a, BKv, true, st);
  }
  return -1;
}
