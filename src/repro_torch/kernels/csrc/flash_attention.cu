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
// What bounds it on an H100 (llama2-7b, hd 128, bf16): a 1024-token
// self-prefill does 8.6 GFLOP in its causal band against 34 MB of q, k, v
// and out, about the ridge (0.0087 ms of operations, 0.0100 ms of bytes);
// a short chunk over a long history (128 queries over 1900 keys) is
// bytes-bound: its 33 MB of K and V take 0.0099 ms, its operations 0.001.
//
// What the design does about it (bf16; sm_90a):
//   - Loads: one producer thread keeps a ring of K and V tiles in shared
//     memory full with TMA (cp.async.bulk.tensor, 4-D maps over the
//     strided tensors, 128-byte swizzle), each tile in boxes of 64
//     head-dim columns; "K full", "V full", "K empty" and "V empty"
//     mbarriers let the loads run ahead of the tensor cores, and a K slot
//     is refilled as soon as its Q K^T is done. The block's Q tiles arrive
//     once, the same way. Rows past Skv or Sq and columns past hd are
//     zero-filled by the TMA unit, so hd 16, 80 and 96 run as 64, 128 and
//     128 (the zero columns add nothing to a dot product).
//   - Products: two consumer warpgroups, each owning 64 query rows, issue
//     wgmma m64n64k16 (bf16 in, fp32 accumulate): S = Q K^T with Q and K
//     both K-major in shared memory, then O += P V with P in registers
//     (the S accumulator layout is the A-operand fragment layout, so P is
//     rounded to bf16 and packed in place) and V read N-major.
//   - Online softmax in registers: each thread holds two rows' running max
//     and sum (fp32, log2 domain), reduces a row over the 4 lanes that
//     share it with shuffles, and rescales its output accumulators there.
//     Nothing round-trips through shared memory.
//   - Overlap: step j issues Q K^T of key tile j and P V of tile j - 1
//     together and runs tile j's softmax while that P V is in flight (P of
//     tile j - 1 waits in 32 packed registers, so no second score tile is
//     held); the two warpgroups take turns to issue (named barriers), so
//     one's softmax runs under the other's products. The steady loop has
//     no branch around a product or a wait, which lets ptxas keep the
//     products asynchronous.
//   - The plan (kernels/flash_attention.py::flash_plan), from host shapes
//     only: 128-row blocks (two 64-row tiles of one head; with GQA, one
//     64-row tile of two heads of a kv group, so both read each K/V tile
//     once), heaviest causal tiles first; a short chunk over a long history
//     splits its key range across blocks to fill the 132 SMs, each split
//     writing an fp32 partial (unnormalised output, running max and sum)
//     that a second kernel merges in split order. Key tile: 128 keys (64
//     at hd 256, where the output accumulators take the registers); split
//     boundaries fall on key tiles.
//   - A key tile no query of the block can see (past the causal frontier
//     or kv_len, before the window) is never loaded.
// P is rounded to the input dtype before P V against the running max of
// its key tile, as the plain version does over the same tiles. Every sum
// runs in a fixed order and there are no atomics, so equal inputs give
// equal bits (the recompute replay and the paged engine rely on this);
// the plan depends on shapes, never on q_offset or kv_len values.
//
// fp32 runs a SIMT kernel (one block of 4 warps per batch·head and 64
// query rows, K/V tiles staged in shared memory); only checks use it.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "launch.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------- fp32: SIMT
constexpr int BQ = 64;          // query rows per block
constexpr int WARPS = 4;        // warp w owns query rows 16w..16w+15
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;
constexpr int PAD = 4;          // floats of padding per smem row

struct SimtParams {
  const float* q;
  const float* k;
  const float* v;
  const int32_t* q_offset;     // (B,)
  const int32_t* kv_len;       // (B,)
  float* out;                  // (B, Sq, H, hd)
  int Sq, Skv, H, group;       // group = H / Kv
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;   // elements
  float scale, softcap;        // softcap <= 0: none
  int causal, window;          // window <= 0: none
};

// keys per tile: 64, or 32 at hd 256 so that the block fits in 227 KB
template <int HD> constexpr int simt_keys() { return HD > 128 ? 32 : 64; }

template <int HD> struct SimtLd {
  static constexpr int BKN = simt_keys<HD>();
  static constexpr int T_ROW = HD + PAD;      // Q, K, V tiles
  static constexpr int S_ROW = BKN + PAD;     // scores and P
  static constexpr int O_ROW = HD + PAD;      // output accumulators
  static constexpr size_t SMEM =
      sizeof(float) * ((BQ + 2 * BKN) * T_ROW + 2 * BQ * S_ROW
                       + BQ * O_ROW);
};

// Stage `rows` rows of HD floats (row r at src + r * stride) into dst
// with 16-byte copies; rows at or past `live` are zero-filled, so no
// value past kv_len (or past Sq) enters a product.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                     long long stride, int rows, int live) {
  constexpr int PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < live)
      val = *reinterpret_cast<const float4*>(src + (long long)r * stride + c);
    *reinterpret_cast<float4*>(dst + r * SimtLd<HD>::T_ROW + c) = val;
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_simt(SimtParams p) {
  using L = SimtLd<HD>;
  constexpr int BKN = L::BKN;
  constexpr int CPL = BKN / 32;           // score columns per lane
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;                      // (BQ, T_ROW)
  float* Ks = Qs + BQ * L::T_ROW;          // (BKN, T_ROW)
  float* Vs = Ks + BKN * L::T_ROW;         // (BKN, T_ROW)
  float* Ps = Vs + BKN * L::T_ROW;         // (BQ, S_ROW)
  float* Ss = Ps + BQ * L::S_ROW;          // (BQ, S_ROW)
  float* Os = Ss + BQ * L::S_ROW;          // (BQ, O_ROW)

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const int nq = min(BQ, p.Sq - q0);
  const int qoff = p.q_offset[b];
  const int klen = min(p.kv_len[b], p.Skv);
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * ROWS;   // this warp's first row

  // the key range any query of this block can see
  const int qlo = qoff + q0;
  const int qhi = qoff + q0 + nq - 1;
  int kend = klen;
  if (p.causal) kend = min(kend, qhi + 1);
  int kbeg = 0;
  if (p.window > 0) kbeg = max(0, qlo - p.window + 1);

  const float* kb = p.k + b * p.ksb + kvh * p.ksh;
  const float* vb = p.v + b * p.vsb + kvh * p.vsh;
  stage<HD>(Qs, p.q + b * p.qsb + h * p.qsh + (long long)q0 * p.qss, p.qss,
            BQ, nq);
  for (int r = r0; r < r0 + ROWS; ++r)
    for (int d = lane; d < HD; d += 32) Os[r * L::O_ROW + d] = 0.f;
  // running max and sum of row r0 + i live in lane i (i < ROWS)
  float m_run = NEG_INF, l_run = 0.f;

  for (int t0 = (kbeg / BKN) * BKN; t0 < kend; t0 += BKN) {
    __syncthreads();                      // every warp is done with K, V
    stage<HD>(Ks, kb + (long long)t0 * p.kss, p.kss, BKN, klen - t0);
    stage<HD>(Vs, vb + (long long)t0 * p.vss, p.vss, BKN, klen - t0);
    __syncthreads();
    // this warp's scores: lane c computes columns c, c + 32, ...
    for (int r = r0; r < r0 + ROWS; ++r) {
#pragma unroll
      for (int hh = 0; hh < CPL; ++hh) {
        const int c = lane + 32 * hh;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d)
          s = fmaf(Qs[r * L::T_ROW + d], Ks[c * L::T_ROW + d], s);
        Ss[r * L::S_ROW + c] = s;
      }
    }
    __syncwarp();

    for (int i = 0; i < ROWS; ++i) {
      const int r = r0 + i;
      const int qp = qoff + q0 + r;
      float sv[CPL];
      bool okv[CPL];
      float mx = NEG_INF;
#pragma unroll
      for (int hh = 0; hh < CPL; ++hh) {
        const int c = lane + 32 * hh;
        const int kp = t0 + c;
        float s = Ss[r * L::S_ROW + c] * p.scale;
        if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
        bool ok = r < nq && kp < klen;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        sv[hh] = s;
        okv[hh] = ok;
        if (ok) mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = __shfl_sync(0xffffffffu, m_run, i);
      const float l_old = __shfl_sync(0xffffffffu, l_run, i);
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int hh = 0; hh < CPL; ++hh) {
        const float pc = okv[hh] ? expf(sv[hh] - m_new) : 0.f;
        sum += pc;
        Ps[r * L::S_ROW + lane + 32 * hh] = pc;
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
    // this warp's output rows += P V; lane owns columns lane, lane + 32, ..
    for (int r = r0; r < r0 + ROWS; ++r) {
      for (int d = lane; d < HD; d += 32) {
        float o = Os[r * L::O_ROW + d];
        for (int c = 0; c < BKN; ++c)
          o = fmaf(Ps[r * L::S_ROW + c], Vs[c * L::T_ROW + d], o);
        Os[r * L::O_ROW + d] = o;
      }
    }
  }
  __syncwarp();

  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    const float l = __shfl_sync(0xffffffffu, l_run, i);
    if (r >= nq) continue;
    const long long o = (((long long)b * p.Sq + q0 + r) * p.H + h) * HD;
    for (int d = lane; d < HD; d += 32)
      p.out[o + d] = Os[r * L::O_ROW + d] / fmaxf(l, 1e-30f);
  }
}

template <int HD>
int launch_simt(const SimtParams& p, int B, cudaStream_t st) {
  const cudaError_t attr = max_dynamic_smem(
      reinterpret_cast<const void*>(flash_attention_simt<HD>),
      (int)SimtLd<HD>::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  flash_attention_simt<HD><<<grid, THREADS, SimtLd<HD>::SMEM, st>>>(p);
  return 0;
}

int dispatch_simt(int hd, const SimtParams& p, int B, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_simt<16>(p, B, st);
    case 64: return launch_simt<64>(p, B, st);
    case 80: return launch_simt<80>(p, B, st);
    case 96: return launch_simt<96>(p, B, st);
    case 128: return launch_simt<128>(p, B, st);
    case 256: return launch_simt<256>(p, B, st);
    default: return -1;
  }
}

// ---------------------------------------- bf16: TMA ring + wgmma (sm_90a)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NWG = 2;                 // consumer warpgroups, 64 rows each
constexpr int Q_BOX = 64 * 128;        // 64 rows x 64 bf16 columns

struct Params {
  const int32_t* q_offset;     // (B,)
  const int32_t* kv_len;       // (B,)
  __nv_bfloat16* out;          // (B, Sq, H, hd)
  float* part_o;               // (splits, B, Sq, H, hd) when splits > 1
  float* part_ml;              // (splits, B, Sq, H, 2): max (log2), sum
  int B, Sq, Skv, H, group, hd;
  int heads_per_block;         // 1: two 64-row tiles of one head;
                               // 2: one 64-row tile of two heads
  int q_tiles, head_blocks, splits, split_keys;
  float scale, softcap;        // softcap <= 0: none
  int causal, window;          // window <= 0: none
};

template <int HDP, int BN, int STAGES>
struct Layout {
  static constexpr int NC = HDP / 64;             // 64-column boxes
  static constexpr int Q_BYTES = NWG * NC * Q_BOX;
  static constexpr int KV_BOX = BN * 128;         // BN rows x 64 columns
  static constexpr int TILE = NC * KV_BOX;        // one K or V tile
  static constexpr int STAGE = 2 * TILE;          // K then V
  static constexpr int BARS = Q_BYTES + STAGES * STAGE;
  static constexpr int SMEM = BARS + 8 * (1 + 4 * STAGES) + 1024;
};

// 2^x on the special-function unit (inputs -inf..0 here; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One 32-bit word of two bf16 values, low half first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// What the softmax of a key tile needs about the warpgroup's rows.
struct RowMask {
  int klen, causal, window;
  int qpa;            // position of the thread's first row (ra)
  int qlo, qhi;       // positions of the warpgroup's first and last row
  int col0;           // the thread's first column of each 8-column block
  bool softcap;
  float scale_log2, inv_cap, cap_log2;
};

// S = Q K^T of one key tile, asynchronous: Q and K K-major, 128-byte
// rows, 8-row atoms 1024 B apart; 16 columns = 32 B.
template <int HDP, int BN>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t qs,
                                         uint32_t ks) {
#pragma unroll
  for (int j = 0; j < BN / 64; ++j)
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_m64n64k16_ss<0>(
          sc + 32 * j,
          smem_desc(qs + (kk / 4) * Q_BOX + (kk % 4) * 32, 16, 1024, 1),
          smem_desc(ks + (kk / 4) * BN * 128 + j * 64 * 128 + (kk % 4) * 32,
                    16, 1024, 1),
          kk > 0);
  wgmma_commit();
}

// O += P V of one key tile, asynchronous: P from registers, V N-major,
// 64-column boxes BN * 128 B apart (leading byte offset), 8-row groups
// 1024 B apart; 16 rows = 2 KB.
template <int HDP, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[HDP / 2],
                                         const uint32_t (&pa)[BN / 4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int c = 0; c < HDP / 64; ++c)
      wgmma_m64n64k16_rs(o + 32 * c, pa + 4 * kk,
                         smem_desc(vs + c * BN * 128 + kk * 2048, BN * 128,
                                   1024, 1));
  wgmma_commit();
}

// Online softmax of the key tile at t0, in registers: logits to the log2
// domain, the mask where a key of the tile may be invisible (uniform
// branches), the rows' running max and sum, P = 2^(s - max) in place,
// and corr, the rescale the output takes before this tile's P V.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&corr)[2],
                                             const RowMask& a, int t0) {
  constexpr int N = BN / 2;
  if (a.softcap) {
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] = tanhf(sc[i] * a.inv_cap) * a.cap_log2;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] *= a.scale_log2;
  }
  if (t0 + BN > a.klen || (a.causal && t0 + BN - 1 > a.qlo) ||
      (a.window > 0 && t0 <= a.qhi - a.window)) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int kp = t0 + 64 * (i / 32) + 8 * ((i % 32) / 4) + a.col0 + i % 2;
      const int qp = a.qpa + 8 * ((i / 2) % 2);   // row ra or ra + 8
      bool ok = kp < a.klen;
      if (a.causal) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && kp > qp - a.window;
      if (!ok) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
    corr[r] = ex2(m_run[r] - mu[r]);
    m_run[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sc[i] = ex2(sc[i] - mu[(i / 2) % 2]);
    sum[(i / 2) % 2] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l_run[r] = l_run[r] * corr[r] + sum[r];
  }
}

// P as bf16 A fragments: 16-key step kk takes 8-column blocks 2kk and
// 2kk + 1 of the score accumulator.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2],
                                       uint32_t (&pa)[BN / 4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const float* b0 = sc + 32 * (kk / 4) + 8 * (kk % 4);
    pa[4 * kk + 0] = pack_bf16(b0[0], b0[1]);     // row ra, cols c, c+1
    pa[4 * kk + 1] = pack_bf16(b0[2], b0[3]);     // row ra + 8
    pa[4 * kk + 2] = pack_bf16(b0[4], b0[5]);     // row ra, cols c+8, c+9
    pa[4 * kk + 3] = pack_bf16(b0[6], b0[7]);     // row ra + 8
  }
}

// Rows [kv_len, Skv) of the V tile at t0 hold whatever the buffer holds;
// zero them so that a non-finite value there cannot reach P V (p = 0
// there). Both warpgroups write the same zeros.
template <int NC, int BN>
__device__ __forceinline__ void zero_dead_rows(uint32_t vs, int t0, int klen,
                                               int Skv, int tid, int wg) {
  const int zr0 = max(klen - t0, 0), zr1 = min(BN, Skv - t0);
  if (zr0 >= zr1) return;
  for (int i = tid; i < NC * (zr1 - zr0) * 8; i += 128) {
    const int c = i / ((zr1 - zr0) * 8);
    const int rr = zr0 + (i / 8) % (zr1 - zr0);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(vs + c * BN * 128 + rr * 128 + (i % 8) * 16),
                    "r"(0u), "r"(0u), "r"(0u), "r"(0u) : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// The two consumer warpgroups take turns to issue products: warpgroup w
// waits on named barrier 3 + w, then passes the turn on 4 - w.
__device__ __forceinline__ void wait_turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");
}

template <int HDP, int BN, int STAGES>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_attention_tma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const Params p) {
  using L = Layout<HDP, BN, STAGES>;
  constexpr int NC = L::NC;
  constexpr int NS = BN / 64;            // 64-key groups of a score tile
  constexpr int KK = BN / 16;            // 16-key steps of P V
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle atoms
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BARS;
  auto full_k = [&](int s) { return q_full + 8u * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto empty_k = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return q_full + 8u * (1 + 3 * STAGES + s); };
  auto kst = [&](int s) { return base + L::Q_BYTES + s * L::STAGE; };

  // which block this is: (b, kv head) on x; (query tile, head block,
  // split) on y, so that blocks start in order of query tile from the
  // last, the longest causal rows, across all heads
  const int kvh = blockIdx.x % (p.H / p.group);
  const int b = blockIdx.x / (p.H / p.group);
  int y = blockIdx.y;
  const int split = y % p.splits;
  y /= p.splits;
  const int hb = y % p.head_blocks;
  const int qt = p.q_tiles - 1 - y / p.head_blocks;
  const int hpb = p.heads_per_block;
  const int rows_blk = 128 / hpb;
  const int q0 = qt * rows_blk;
  const int nq = min(rows_blk, p.Sq - q0);
  const int qoff = p.q_offset[b];
  const int klen = min(p.kv_len[b], p.Skv);

  // the keys any query of the block can see, within this split
  int kend = klen;
  if (p.causal) kend = min(kend, qoff + q0 + nq);
  int kbeg = 0;
  if (p.window > 0) kbeg = max(0, qoff + q0 - p.window + 1);
  kbeg = max(kbeg, split * p.split_keys);
  kend = min(kend, (split + 1) * p.split_keys);
  const int t_first = (kbeg / BN) * BN;
  const int ntiles = kend > kbeg ? (kend - t_first + BN - 1) / BN : 0;

  // warpgroup w's query rows: head (clamped into the group; `valid` says
  // whether it is a head of its own) and first row
  auto wg_head = [&](int w, bool& valid) {
    const int j = hb * hpb + (hpb == 2 ? w : 0);
    valid = j < p.group;
    return kvh * p.group + min(j, p.group - 1);
  };
  auto wg_row0 = [&](int w) { return q0 + (hpb == 2 ? 0 : 64 * w); };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), NWG);
      mbar_init(empty_v(s), NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int w = 0; w < NWG; ++w) {
        bool valid;
        const int h = wg_head(w, valid);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(base + (w * NC + c) * Q_BOX, &qmap, q_full, 64 * c, h,
                      wg_row0(w), b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = ((it / STAGES) & 1) ^ 1;
        const int t0 = t_first + it * BN;
        if (it >= STAGES) mbar_wait(empty_k(s), ph);
        mbar_expect_tx(full_k(s), L::TILE);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(kst(s) + c * L::KV_BOX, &kmap, full_k(s), 64 * c, kvh,
                      t0, b);
        if (it >= STAGES) mbar_wait(empty_v(s), ph);
        mbar_expect_tx(full_v(s), L::TILE);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(kst(s) + L::TILE + c * L::KV_BOX, &vmap, full_v(s),
                      64 * c, kvh, t0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns 64 query rows of one head
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  bool valid;
  const int head = wg_head(wg, valid);
  const int row0 = wg_row0(wg);
  // this thread's rows (the wgmma accumulator layout): ra and ra + 8
  const int ra = row0 + (tid / 32) * 16 + lane / 4;
  const bool softcap = p.softcap > 0.f;
  const RowMask rm{klen, p.causal, p.window, qoff + ra, qoff + row0,
                   qoff + row0 + 63, 2 * (lane % 4), softcap,
                   p.scale * LOG2E, softcap ? p.scale / p.softcap : 0.f,
                   p.softcap * LOG2E};

  float o[NC * 32];
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) o[i] = 0.f;
  float sc[NS * 32];                      // scores, then P, of one tile
#pragma unroll
  for (int i = 0; i < NS * 32; ++i) sc[i] = 0.f;
  uint32_t pa[KK * 4];                    // P of the tile before, bf16
  float m_run[2] = {-INFINITY, -INFINITY};   // log2 domain
  float l_run[2] = {0.f, 0.f};
  float corr[2] = {1.f, 1.f};             // O's rescale before its next P V
  const uint32_t qs = base + wg * NC * Q_BOX;
  auto vst = [&](int s) { return kst(s) + L::TILE; };
  mbar_wait(q_full, 0);

  // Step it issues S = Q K^T of tile it and O += P V of tile it - 1, then
  // runs tile it's softmax while that P V is in flight; the two
  // warpgroups take turns to issue, so one's softmax overlaps the other's
  // products. Warpgroup 0 goes first.
  if (wg == 1) pass_turn(wg);
  if (ntiles > 0) {
    mbar_wait(full_k(0), 0);
    wait_turn(wg);
    wgmma_fence();
    issue_qk<HDP, BN>(sc, qs, kst(0));
    pass_turn(wg);
    wgmma_wait<0>();
    fence_acc(sc);
    if (tid == 0) mbar_arrive(empty_k(0));
    softmax_tile<BN>(sc, m_run, l_run, corr, rm, t_first);
    pack_p<BN>(sc, pa);
    for (int it = 1; it < ntiles; ++it) {
      const int s = it % STAGES, sp = (it - 1) % STAGES;
      const int t0 = t_first + it * BN;
      mbar_wait(full_k(s), (it / STAGES) & 1);
      mbar_wait(full_v(sp), ((it - 1) / STAGES) & 1);
      zero_dead_rows<NC, BN>(vst(sp), t0 - BN, klen, p.Skv, tid, wg);
      wait_turn(wg);
#pragma unroll
      for (int i = 0; i < NC * 32; ++i) o[i] *= corr[(i / 2) % 2];
      wgmma_fence();
      issue_qk<HDP, BN>(sc, qs, kst(s));
      issue_pv<HDP, BN>(o, pa, vst(sp));
      pass_turn(wg);
      wgmma_wait<1>();
      fence_acc(sc);
      if (tid == 0) mbar_arrive(empty_k(s));
      softmax_tile<BN>(sc, m_run, l_run, corr, rm, t0);
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(pa);
      if (tid == 0) mbar_arrive(empty_v(sp));
      pack_p<BN>(sc, pa);
    }
    const int sp = (ntiles - 1) % STAGES;
    mbar_wait(full_v(sp), ((ntiles - 1) / STAGES) & 1);
    zero_dead_rows<NC, BN>(vst(sp), t_first + (ntiles - 1) * BN, klen,
                           p.Skv, tid, wg);
    wait_turn(wg);
#pragma unroll
    for (int i = 0; i < NC * 32; ++i) o[i] *= corr[(i / 2) % 2];
    wgmma_fence();
    issue_pv<HDP, BN>(o, pa, vst(sp));
    pass_turn(wg);
    wgmma_wait<0>();
    fence_acc(o);
    if (tid == 0) mbar_arrive(empty_v(sp));
  }
  if (wg == 0) wait_turn(0);              // warpgroup 1's last pass

  // ---- epilogue: this thread's two rows, 2 columns of each 8-block
  if (!valid) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= p.Sq) continue;
    const long long rid = ((long long)b * p.Sq + row) * p.H + head;
    if (p.splits == 1) {
      const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
      __nv_bfloat16* dst = p.out + rid * p.hd;
#pragma unroll
      for (int i = 0; i < NC * 32; i += 4) {
        const int col = 64 * (i / 32) + 8 * ((i % 32) / 4) + rm.col0;
        if (col < p.hd)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(o[i + 2 * r] * inv,
                                    o[i + 2 * r + 1] * inv);
      }
    } else {
      const long long pid =
          (long long)split * p.B * p.Sq * p.H + rid;   // (split, b, row, h)
      float* dst = p.part_o + pid * p.hd;
#pragma unroll
      for (int i = 0; i < NC * 32; i += 4) {
        const int col = 64 * (i / 32) + 8 * ((i % 32) / 4) + rm.col0;
        if (col < p.hd)
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[i + 2 * r], o[i + 2 * r + 1]);
      }
      if (lane % 4 == 0)
        *reinterpret_cast<float2*>(p.part_ml + 2 * pid) =
            make_float2(m_run[r], l_run[r]);
    }
  }
}

// Merge the splits' partials of each (b, row, head): one warp per row,
// splits in order 0, 1, ...
constexpr int MAX_SPLITS = 16;

__global__ void __launch_bounds__(128)
flash_merge(const float* __restrict__ part_o,
            const float* __restrict__ part_ml, __nv_bfloat16* __restrict__ out,
            int rows, int hd, int splits) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s)
    m = fmaxf(m, part_ml[2 * ((long long)s * rows + row)]);
  const float mu = m == -INFINITY ? 0.f : m;
  float w[MAX_SPLITS];
  float l = 0.f;
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s) {
    if (s >= splits) break;
    const long long at = 2 * ((long long)s * rows + row);
    w[s] = exp2f(part_ml[at] - mu);
    l += part_ml[at + 1] * w[s];
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s >= splits) break;
      acc += part_o[((long long)s * rows + row) * hd + d] * w[s];
    }
    out[(long long)row * hd + d] = __float2bfloat16(acc * inv);
  }
}

// A 4-D map over (hd, heads, seq, batch) of a strided bf16 tensor, in
// boxes of 64 columns x `rows` positions of one head. A size-1 dimension
// gets a packed stride (its stride is never used).
bool map_4d(CUtensorMap* map, const void* ptr, int hd, int heads, int seq,
            int batch, long long sh, long long ss, long long sb, int rows) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)heads, (uint64_t)seq,
                            (uint64_t)batch};
  uint64_t st[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2, (uint64_t)sb * 2};
  uint64_t packed = (uint64_t)hd * 2;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) st[i] = (packed + 15) & ~15ull;
    packed = st[i] * dims[i + 1];
  }
  const MapKey key{ptr, 4, {dims[0], dims[1], dims[2], dims[3]},
                   {st[0], st[1], st[2]}, {64, 1, (uint32_t)rows, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B};
  return cached_map(map, key);
}

template <int HDP, int BN, int STAGES>
int launch_tma(const void* q, const void* k, const void* v, const Params& p,
               const long long* qs, const long long* ks, const long long* vs,
               cudaStream_t st) {
  using L = Layout<HDP, BN, STAGES>;
  auto kernel = flash_attention_tma<HDP, BN, STAGES>;
  const cudaError_t attr =
      max_dynamic_smem(reinterpret_cast<const void*>(kernel), L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int Kv = p.H / p.group;
  CUtensorMap qmap, kmap, vmap;
  if (!map_4d(&qmap, q, p.hd, p.H, p.Sq, p.B, qs[2], qs[1], qs[0], 64) ||
      !map_4d(&kmap, k, p.hd, Kv, p.Skv, p.B, ks[2], ks[1], ks[0], BN) ||
      !map_4d(&vmap, v, p.hd, Kv, p.Skv, p.B, vs[2], vs[1], vs[0], BN))
    return -2;
  const dim3 grid(p.B * Kv, p.q_tiles * p.head_blocks * p.splits);
  kernel<<<grid, (NWG + 1) * 128, L::SMEM, st>>>(qmap, kmap, vmap, p);
  if (p.splits > 1) {
    const int rows = p.B * p.Sq * p.H;
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_merge<<<(rows + 3) / 4, 128, 0, st>>>(p.part_o, p.part_ml, p.out,
                                                rows, p.hd, p.splits);
  }
  return 0;
}

}  // namespace

// q element (b, i, h, d) at q + b*qsb + i*qss + h*qsh + d; k/v likewise
// with their own strides (elements; every stride a multiple of 16 bytes'
// worth of elements, base pointers 16-byte aligned). hd in {16, 64, 80,
// 96, 128, 256}, H a multiple of Kv. softcap <= 0 and window <= 0 mean
// "none". dtype: 0 = float32 (SIMT kernel; plan and workspace ignored),
// 1 = bfloat16 (TMA + wgmma kernel under the plan of
// kernels/flash_attention.py::flash_plan: plan_hdp columns per row as
// loaded (hd rounded up to 64), plan_bn keys per tile, plan_stages ring
// stages, plan_hpb heads per block, plan_q_tiles x plan_head_blocks x
// plan_splits blocks per (batch, kv head), plan_split_keys keys per
// split; with more than one split, part_o (splits, B, Sq, H, hd) and
// part_ml (splits, B, Sq, H, 2) fp32 workspaces). Returns -1 for
// unsupported sizes or plans, -2 if a TMA descriptor cannot be encoded,
// else the CUDA error of the launches (0 on success).
extern "C" int hc_flash_attention(
    const void* q, const void* k, const void* v, const void* q_offset,
    const void* kv_len, void* out, void* part_o, void* part_ml, int B,
    int Sq, int Skv, int H, int Kv, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale, float softcap,
    int causal, int window, int dtype, int plan_hdp, int plan_bn,
    int plan_stages, int plan_hpb, int plan_q_tiles, int plan_head_blocks,
    int plan_splits, int plan_split_keys, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || Kv < 1 || H % Kv)
    return -1;
  const int32_t* qo = static_cast<const int32_t*>(q_offset);
  const int32_t* kl = static_cast<const int32_t*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    const SimtParams p{static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v), qo, kl,
                       static_cast<float*>(out), Sq, Skv, H, H / Kv,
                       qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, scale,
                       softcap, causal, window};
    rc = dispatch_simt(hd, p, B, st);
  } else if (dtype == 1) {
    const int group = H / Kv;
    const int rows_blk = plan_hpb == 2 ? 64 : 128;
    if ((hd != 16 && hd != 64 && hd != 80 && hd != 96 && hd != 128 &&
         hd != 256) || hd > plan_hdp || (plan_hpb != 1 && plan_hpb != 2) ||
        plan_q_tiles != (Sq + rows_blk - 1) / rows_blk ||
        plan_head_blocks != (group + plan_hpb - 1) / plan_hpb ||
        plan_splits < 1 || plan_splits > MAX_SPLITS ||
        plan_split_keys < 1 || plan_split_keys % plan_bn ||
        (long long)plan_splits * plan_split_keys < Skv ||
        (plan_splits > 1 && (!part_o || !part_ml)))
      return -1;
    const Params p{qo, kl, static_cast<__nv_bfloat16*>(out),
                   static_cast<float*>(part_o), static_cast<float*>(part_ml),
                   B, Sq, Skv, H, group, hd, plan_hpb, plan_q_tiles,
                   plan_head_blocks, plan_splits, plan_split_keys, scale,
                   softcap, causal, window};
    const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                    vs[3] = {vsb, vss, vsh};
#define HC_PLAN(HDP, BN, ST)                                              \
  if (plan_hdp == HDP && plan_bn == BN && plan_stages == ST)             \
    rc = launch_tma<HDP, BN, ST>(q, k, v, p, qs, ks, vs, st);            \
  else
    HC_PLAN(64, 128, 4)
    HC_PLAN(128, 128, 2)
    HC_PLAN(256, 64, 2)
#undef HC_PLAN
      rc = -1;
  } else {
    rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
