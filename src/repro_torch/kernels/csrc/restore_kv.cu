// Grouped HCache restoration projection: K = RoPE(H @ Wk[row] + bk[row]),
// V = H @ Wv[row] + bv[row] for G layers in one launch.
//
// Replaces the TPU kernels src/repro/kernels/restore_kv.py:138
// (restore_kv_grouped_pallas) and src/repro/kernels/restore_kv.py:86
// (restore_kv_pallas, which is this kernel at G = 1 with rows = [0]).
//
// The one kernel computes every K/V projection of the port: restoration
// (G = 8 layers, S = the token bucket), prefill (G = 1, S = the chunk,
// batch folded into S) and decode (G = 1, S = the batch). For llama2-7b
// (D = KV = 4096, bf16) one layer's Wk|Wv is 67 MB, so what bounds it
// depends on S:
//   - S below ~590 (decode, prefill chunks, small restores): bytes. The
//     kernel is a weight stream: at S = 1..128 the 67 MB take ~0.020 ms at
//     3.35 TB/s, and every SM has to pull weights to get there.
//   - S above it (long prefills, restores at S = 1024-2048): operations.
//     G = 8, S = 1024 is 550 GFLOP, 0.556 ms at 989 TFLOP/s.
//
// What the design does about it (bf16):
//   - Loads: one producer thread keeps a ring of STAGES shared-memory
//     stages full with TMA (cp.async.bulk.tensor), each stage one
//     64-deep slice of D: the hidden tile (64 or 128 rows, 128-byte
//     swizzle) and, per column pair, two 32-column boxes of Wk or Wv
//     (64-byte swizzle). The weight descriptors are 3-D over the whole
//     (A, D, KV) stacks and the block uses rows[g] as the third
//     coordinate, so no G x D x KV gather exists. Rows past S and columns
//     past KV are zero-filled by the TMA unit. mbarriers carry "stage
//     full" (transaction bytes) and "stage empty" (one arrival per
//     consumer warpgroup), so loads run ahead of the tensor cores.
//   - Products: consumer warpgroups issue wgmma.mma_async m64n64k16 (bf16
//     in, fp32 accumulate), A and B read from shared memory; B is N-major
//     (the weights' KV axis is contiguous) and read transposed, its two
//     boxes 4 KB apart (the descriptor's leading byte offset). One stage
//     of products stays in flight while the next stage is waited for.
//   - Epilogue in registers: a K column pair holds columns f0..f0+31 and
//     f0+hd/2..f0+hd/2+31 of one head, so the rotate-half partner of every
//     accumulator sits in the same thread, 16 registers on. Bias and RoPE
//     (fp32 cos/sin tables) are applied there and bf16 pairs are stored
//     straight to global memory; nothing is parked in shared memory.
//   - Enough blocks for every S: the tile plan comes from Python
//     (kernels/restore_kv.py::tile_plan). Bytes-bound shapes get 64-row
//     blocks that own one 64-column pair of K or of V (128 blocks per
//     layer for KV = 4096, so every SM streams weights; a 12-stage ring
//     when they fit in one wave, else 6 stages and two blocks per SM);
//     operations-bound shapes get 128-row blocks owning one head of K and
//     one of V (a 128 x 256 tile, 4 stages). Block index x runs over the
//     token tiles, so the blocks in flight share weight columns in L2.
//
// Why the bits do not depend on S, G or the plan: every output element
// is one 64-row wgmma lane's accumulator, fed by the same instruction
// (m64n64k16, k-depth 16) over D from 0 upward in the same 16-deep steps,
// with no split of D. A row's products never mix with other rows', and
// the epilogue is the same code with rounding fixed by __fmul_rn /
// __fadd_rn (no contraction choices per instantiation). So prefill,
// decode and restoration give bitwise-equal K/V for equal inputs;
// chip_smoke.py checks this across plans on the card.
//
// Head sizes: hd in {16, 64, 80, 96, 128, 256}. A head holds
// ceil(hd/4 / 16) column pairs (hd 256: 4; hd 16: one pair whose two
// 32-column boxes carry 8 live columns each, the rest belonging to the
// next head or lying past KV, where the TMA unit fills zeros: at KV = 16,
// one kv head, the boxes run past the tensor). The epilogue stores only
// a pair's live columns, so every hd runs the same instruction stream.
//
// fp32 runs a plain SIMT kernel (exact fp32 products, one thread per
// 4 x HD/16 register tile); only small parity shapes use it.
//
// The TMA descriptors are encoded on the host with cuTensorMapEncodeTiled
// (hopper.cuh), fetched through cudaGetDriverEntryPoint so the build needs
// no -lcuda; descriptors are cached by (pointer, shape, box).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "launch.cuh"

namespace {

bool supported_hd(int hd) {
  return hd == 16 || hd == 64 || hd == 80 || hd == 96 || hd == 128 ||
         hd == 256;
}

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
  extern __shared__ float smem[];  // simt_smem<HD>() bytes
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

template <int HD>
constexpr int simt_smem() {
  return (BM * BK + 2 * BK * HD) * sizeof(float);
}

template <int HD>
int launch_simt(const void* hidden, const void* wk, const void* wv,
                 const void* bk, const void* bv, const int32_t* rows,
                 const float* cos_t, const float* sin_t, void* k_out,
                 void* v_out, int G, int S, int D, int KV, int use_rope,
                 cudaStream_t stream) {
  const cudaError_t attr = max_dynamic_smem(
      reinterpret_cast<const void*>(restore_kv_grouped_simt<HD>),
      simt_smem<HD>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + BM - 1) / BM, KV / HD, G);
  restore_kv_grouped_simt<HD><<<grid, TX * TY, simt_smem<HD>(), stream>>>(
      static_cast<const float*>(hidden), static_cast<const float*>(wk),
      static_cast<const float*>(wv), static_cast<const float*>(bk),
      static_cast<const float*>(bv), rows, cos_t, sin_t,
      static_cast<float*>(k_out), static_cast<float*>(v_out), S, D, KV,
      use_rope);
  return 0;
}

int dispatch_hd(int hd, const void* hidden, const void* wk, const void* wv,
                const void* bk, const void* bv, const int32_t* rows,
                const float* cos_t, const float* sin_t, void* k_out,
                void* v_out, int G, int S, int D, int KV, int use_rope,
                cudaStream_t stream) {
  switch (hd) {
#define HC_CASE(N)                                                       \
  case N:                                                                \
    return launch_simt<N>(hidden, wk, wv, bk, bv, rows, cos_t, sin_t,    \
                          k_out, v_out, G, S, D, KV, use_rope, stream);
    HC_CASE(16)
    HC_CASE(64)
    HC_CASE(80)
    HC_CASE(96)
    HC_CASE(128)
    HC_CASE(256)
#undef HC_CASE
    default:
      return -1;
  }
}

// ---------------------------------------- bf16: TMA ring + wgmma (sm_90a)
constexpr int STAGE_D = 64;                  // D per ring stage
constexpr int PIECE = 32;                    // columns per wgmma / TMA box
constexpr int A_TILE = 64 * STAGE_D * 2;     // one warpgroup's hidden rows
constexpr int B_TILE = STAGE_D * PIECE * 2;  // one weight piece

struct Params {
  const __nv_bfloat16* bk;   // (A, KV) or null
  const __nv_bfloat16* bv;
  const int32_t* rows;       // (G,)
  const float* cos_t;        // (S, HD/2)
  const float* sin_t;
  __nv_bfloat16* k_out;      // (G, S, KV)
  __nv_bfloat16* v_out;
  int S, D, KV, hd, use_rope;
  int n_pairs;               // column pairs per matrix
  int pairs_per_head;        // ceil(hd/2 / PIECE)
};

// Pair slot q of block column y -> (matrix 0 = K / 1 = V, pair index).
template <int NPB, bool BOTH>
__device__ __forceinline__ void slot_of(int q, int y, int n_pairs, int& mat,
                                        int& pair) {
  if (BOTH) {
    mat = q / NPB;
    pair = y * NPB + q % NPB;
  } else {
    const int idx = y * NPB + q;
    mat = idx >= n_pairs;
    pair = idx - mat * n_pairs;
  }
}

// Columns of a pair: first piece at `first`, second at first + hd/2; the
// first `width` columns of each are this pair's.
__device__ __forceinline__ void pair_cols(const Params& p, int pair,
                                          int& first, int& width) {
  const int half = p.hd / 2;
  const int head = pair / p.pairs_per_head;
  const int a = (pair % p.pairs_per_head) * PIECE;
  first = head * p.hd + a;
  width = min(PIECE, half - a);
}

// MW consumer warpgroups (64 rows each) and one producer warpgroup; NPB
// column pairs per matrix per block, of K and V both (BOTH) or of one.
// Shared-memory box k of a stage holds half k % 2 of pair slot k / 2, so a
// slot's two halves are adjacent and one m64n64k16 reads them both.
template <int MW, int NPB, bool BOTH, int STAGES>
__global__ void __launch_bounds__((MW + 1) * 128, 1)
restore_kv_grouped_tma(const __grid_constant__ CUtensorMap hmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const Params p) {
  constexpr int NSLOT = BOTH ? 2 * NPB : NPB;
  constexpr int NPIECE = 2 * NSLOT;
  constexpr int STAGE_BYTES = MW * A_TILE + NPIECE * B_TILE;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle atoms
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;  // full[], empty[]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int wg = threadIdx.x / 128;
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * 64 * MW;
  const int y = blockIdx.y;
  const int row = p.rows[g];
  const int kt = (p.D + STAGE_D - 1) / STAGE_D;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), MW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == MW) {
    // ---- producer: one thread issues every TMA load
    if constexpr (MW > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == MW * 128) {
      int col[NPIECE];
      bool is_v[NPIECE];
#pragma unroll
      for (int k = 0; k < NPIECE; ++k) {
        int mat, pair, first, width;
        slot_of<NPB, BOTH>(k / 2, y, p.n_pairs, mat, pair);
        pair_cols(p, pair, first, width);
        col[k] = first + (k % 2) * (p.hd / 2);
        is_v[k] = mat == 1;
      }
      for (int it = 0; it < kt; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const uint32_t st = base + s * STAGE_BYTES;
        mbar_expect_tx(full(s), STAGE_BYTES);
        tma_load_3d(st, &hmap, full(s), it * STAGE_D, m0, g);
#pragma unroll
        for (int k = 0; k < NPIECE; ++k)
          tma_load_3d(st + MW * A_TILE + k * B_TILE,
                      is_v[k] ? &vmap : &kmap, full(s), col[k],
                      it * STAGE_D, row);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  if constexpr (MW > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // slot q's accumulators: acc[32 q .. + 15] its first half's columns,
  // acc[32 q + 16 .. + 31] its second half's, each in the m64n32 layout
  float acc[NPIECE * 16];
#pragma unroll
  for (int i = 0; i < NPIECE * 16; ++i) acc[i] = 0.f;

  for (int it = 0; it < kt; ++it) {
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    const uint32_t st = base + s * STAGE_BYTES;
    const uint32_t a0 = st + wg * A_TILE;
    const uint32_t b0 = st + MW * A_TILE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STAGE_D / 16; ++kk) {
      // A: 128-byte rows, 8-row atoms 1024 B apart; 16 columns = 32 B.
      // B: 64-byte rows of 32-column boxes 4 KB apart (leading byte
      // offset), 8-row groups 512 B apart; 16 rows = 1024 B.
      const uint64_t da = smem_desc(a0 + kk * 32, 16, 1024, 1);
#pragma unroll
      for (int q = 0; q < NSLOT; ++q)
        wgmma_m64n64k16_ss<1>(
            acc + 32 * q, da,
            smem_desc(b0 + 2 * q * B_TILE + kk * 1024, B_TILE, 512, 2), 1);
    }
    wgmma_commit();
    fence_acc(acc);
    // one stage of products stays in flight; the one before it is done,
    // so its buffers go back to the producer
    wgmma_wait<1>();
    if (it > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(empty((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // ---- epilogue: bias, RoPE on the in-thread (c, c + hd/2) pairs, store
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int half = p.hd / 2;
#pragma unroll
  for (int q = 0; q < NSLOT; ++q) {
    int mat, pair, first, width;
    slot_of<NPB, BOTH>(q, y, p.n_pairs, mat, pair);
    pair_cols(p, pair, first, width);
    const float* acc1 = acc + 32 * q;
    const float* acc2 = acc1 + 16;
    const int a = first % p.hd;           // frequency of column 0
    const __nv_bfloat16* bias = mat ? p.bv : p.bk;
    __nv_bfloat16* out = (mat ? p.v_out : p.k_out) + (int64_t)g * p.S * p.KV;
    const bool rope = mat == 0 && p.use_rope;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 8 * j + 2 * (lane % 4);
      if (i >= width) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= p.S) continue;
        float x1[2], x2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x1[e] = acc1[4 * j + 2 * h + e];
          x2[e] = acc2[4 * j + 2 * h + e];
          if (bias) {
            const int64_t b = (int64_t)row * p.KV + first + i + e;
            x1[e] = __fadd_rn(x1[e], __bfloat162float(bias[b]));
            x2[e] = __fadd_rn(x2[e], __bfloat162float(bias[b + half]));
          }
          if (rope) {
            const int64_t t = (int64_t)r * half + a + i + e;
            const float c = p.cos_t[t], sn = p.sin_t[t];
            const float y1 = __fsub_rn(__fmul_rn(x1[e], c),
                                       __fmul_rn(x2[e], sn));
            const float y2 = __fadd_rn(__fmul_rn(x1[e], sn),
                                       __fmul_rn(x2[e], c));
            x1[e] = y1;
            x2[e] = y2;
          }
        }
        __nv_bfloat16* o = out + (int64_t)r * p.KV + first + i;
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(x1[0], x1[1]);
        *reinterpret_cast<__nv_bfloat162*>(o + half) =
            __floats2bfloat162_rn(x2[0], x2[1]);
      }
    }
  }
}

// A contiguous 3-D bf16 map over (d0 innermost, d1, d2), cached.
bool map_3d(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
            uint64_t d2, uint32_t b0, uint32_t b1,
            CUtensorMapSwizzle swizzle) {
  const MapKey key{ptr, 3, {d0, d1, d2, 0}, {d0 * 2, d0 * d1 * 2, 0},
                   {b0, b1, 1, 1}, swizzle};
  return cached_map(map, key);
}

template <int MW, int NPB, bool BOTH, int STAGES>
int launch_tma(const void* hidden, const void* wk, const void* wv, Params p,
               int G, int A, cudaStream_t stream) {
  constexpr int NPIECE = 2 * (BOTH ? 2 * NPB : NPB);
  constexpr int SMEM =
      STAGES * (MW * A_TILE + NPIECE * B_TILE) + 16 * STAGES + 1024;
  auto kernel = restore_kv_grouped_tma<MW, NPB, BOTH, STAGES>;
  const cudaError_t attr =
      max_dynamic_smem(reinterpret_cast<const void*>(kernel), SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap hmap, kmap, vmap;
  // hidden (G, S, D) in 64 x 64 MW boxes; weights (A, D, KV) in 32 x 64
  if (!map_3d(&hmap, hidden, p.D, p.S, G, STAGE_D, 64 * MW,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !map_3d(&kmap, wk, p.KV, p.D, A, PIECE, STAGE_D,
              CU_TENSOR_MAP_SWIZZLE_64B) ||
      !map_3d(&vmap, wv, p.KV, p.D, A, PIECE, STAGE_D,
              CU_TENSOR_MAP_SWIZZLE_64B))
    return -2;
  const int col_blocks = (BOTH ? p.n_pairs : 2 * p.n_pairs) / NPB;
  dim3 grid((p.S + 64 * MW - 1) / (64 * MW), col_blocks, G);
  kernel<<<grid, (MW + 1) * 128, SMEM, stream>>>(hmap, kmap, vmap, p);
  return 0;
}

}  // namespace

// dtype: 0 = float32 (SIMT kernel; the plan arguments are ignored),
// 1 = bfloat16 (TMA + wgmma kernel under the tile plan of
// kernels/restore_kv.py::tile_plan: plan_wg consumer warpgroups,
// plan_pairs column pairs per matrix per block, plan_both = K and V in one
// block, plan_stages ring stages; bf16 needs D and KV multiples of 8 and
// 16-byte aligned hidden, wk and wv). Returns -1 for an unsupported head_dim,
// dtype or plan, -2 if a TMA descriptor cannot be encoded, else the CUDA
// error of the launch (0 on success).
extern "C" int hc_restore_kv_grouped(
    const void* hidden, const void* wk, const void* wv, const void* bk,
    const void* bv, const void* rows, const void* cos_t, const void* sin_t,
    void* k_out, void* v_out, int G, int S, int D, int KV, int A,
    int head_dim, int use_rope, int dtype, int plan_wg, int plan_pairs,
    int plan_both, int plan_stages, void* stream) {
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch_hd(head_dim, hidden, wk, wv, bk, bv, r, c, s, k_out, v_out,
                     G, S, D, KV, use_rope, st);
  } else if (dtype == 1) {
    if (!supported_hd(head_dim)) return -1;
    const int pph = (head_dim / 2 + PIECE - 1) / PIECE;
    Params p{static_cast<const __nv_bfloat16*>(bk),
             static_cast<const __nv_bfloat16*>(bv), r, c, s,
             static_cast<__nv_bfloat16*>(k_out),
             static_cast<__nv_bfloat16*>(v_out), S, D, KV, head_dim,
             use_rope, (KV / head_dim) * pph, pph};
#define HC_PLAN(WG, NPB, BOTH, ST)                                         \
  if (plan_wg == WG && plan_pairs == NPB && plan_both == BOTH &&          \
      plan_stages == ST && p.n_pairs % NPB == 0)                          \
    rc = launch_tma<WG, NPB, BOTH, ST>(hidden, wk, wv, p, G, A, st);      \
  else
    HC_PLAN(1, 1, false, 6)
    HC_PLAN(1, 1, false, 12)
    HC_PLAN(2, 2, true, 4)
#undef HC_PLAN
      rc = -1;
  } else {
    rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
