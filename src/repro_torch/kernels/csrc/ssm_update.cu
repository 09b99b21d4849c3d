// Mamba1 selective scan, the ssm family's recurrence, token after token:
//
//     h_s = exp(dt_s * A) * h_{s-1} + (dt_s * x_s) (outer) B_s
//     y_s = h_s . C_s + D * x_s
//
// h (Bt, I, N) fp32, dt (Bt, S, I) fp32, x (Bt, S, I), A (I, N) fp32,
// B and C (Bt, S, N), D (I,); writes h_S (fp32) and y (Bt, S, I) in x's
// type. One launch walks all S tokens of a layer call: prefill runs it at
// S = the prompt (or chunk) length, decode at S = 1.
//
// Replaces the TPU kernel repro/kernels/ssm_update.py ::
// ssm_update_pallas, which computes one token; this kernel computes what
// S calls of it compute, carrying the state between them.
//
// What bounds it on an H100. Decode (Bt = 4, S = 1, I = 8192, N = 16):
// bytes, ~5 MB (the state read and written once, A, and the token's
// dt/x/y/B/C), ~1.5 us at 3.35 TB/s. Prefill (Bt = 1, S = 2000): bytes
// and the exp unit. The state and A make 1.5 MB; each token adds dt, x, y
// (65.5 KB at bf16) and B, C, so ~131 MB, ~40 us. Every (b, s, i, n)
// takes one exponential: 262 M of them, and the SFU issues 16 per SM per
// clock, ~60 us over 132 SMs, above the byte bound.
//
// What the design does about it:
// - One launch per layer call instead of one per token, and the state
//   held in registers from the first token to the last: h is read once
//   and h_S written once (h_out may alias h).
// - Parallelism at Bt = 1: a row's N states are split over N / 4 lanes
//   (four states each, read and written as float4), so Bt * I * N / 4
//   compute threads: 32768 at Bt = 1, N = 16, 128 to a block.
// - y needs a sum over the row's lanes. A reduce-scatter over G = N / 4
//   tokens by __shfl_xor_sync (masks G/2 .. 1) leaves token q + k's sum
//   in lane k: G - 1 shuffles for G tokens instead of G log2 G. Each
//   lane first sums its four products in n order, then the tree adds
//   lane partials in a fixed order ((p0 + p2) + (p1 + p3) at G = 4); a
//   token's bits never depend on S, its position, the chunking or Bt.
// - Prefill: a producer warp beside the four compute warps stages the
//   per-token inputs dt, x, B and C a chunk of tokens at a time in a ring
//   of shared-memory slots by cp.async and widens bf16 x, B and C to fp32
//   once per chunk; named barriers hand a slot over (FULL) and back
//   (EMPTY). Issuing the copies stalls on the L2 -> SM fill rate, and
//   that stall now falls on the producer, not on the recurrence. The
//   compute warps load the next four tokens' inputs into registers
//   before this batch's arithmetic (two register sets in turn). Each
//   stream is addressed through a batch-row and a token stride (B and C
//   are column views of the x_proj output, no copy); its copies are 16,
//   8 or 4 bytes wide as its alignment allows (2-byte elements
//   otherwise, copied synchronously).
// - Decode (S <= 4): the same arithmetic as a second instantiation
//   without ring or producer, each thread reading its tokens' inputs
//   straight from device memory, so a one-token launch is a few
//   dependent loads deep and lean in registers.
// - The arithmetic is pinned (__fmul_rn / __fmaf_rn / __fadd_rn, one
//   ex2.approx per state on dt * (A log2 e)), so the compiler cannot
//   contract differently in an unrolled token loop: a launch over S
//   tokens is bitwise equal to S launches at S = 1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int SPL = 4;          // states per lane
constexpr int BATCH = 4;        // tokens whose inputs a thread holds, at least
constexpr int THREADS = 128;    // compute threads of a block
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 4;
constexpr int MAX_TOKENS = 256;
constexpr int MAX_SMEM = 232448;     // 227 KB, a block's share of an SM
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive fp32 values by one 16-byte access
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One stream of per-token inputs: the element (b = 0, s = 0, column 0),
// batch-row and token strides in bytes, and the width of its copies.
struct Stream {
  const char* base;
  long long sb, ss;
  int vec;
};

// one piece global -> shared: 16, 8 or 4 bytes by cp.async; 2 bytes (one
// bf16 element whose address allows nothing wider) by a plain copy
template <int V>
__device__ __forceinline__ void copy_piece(char* dst, const char* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else if constexpr (V == 8 || V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(V) : "memory");
  } else {
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  }
}

// bf16 pieces of V bytes in shared memory -> fp32 (2V bytes)
template <int V>
__device__ __forceinline__ void widen_piece(float* dst, const char* src) {
  if constexpr (V == 2) {
    dst[0] = __uint_as_float(
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(src))
        << 16);
  } else {
    uint32_t w[V / 4];
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      w[j] = reinterpret_cast<const uint32_t*>(src)[j];
    }
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      dst[2 * j] = __uint_as_float(w[j] << 16);
      dst[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// The producer warp's copies of one stream: a token's row of `row` bytes
// is cut into 2^lp pieces of V bytes, and lane l takes pieces l, l + 32,
// ... of the chunk (token p >> lp, byte (p mod 2^lp) V): no division.
template <int V>
__device__ __forceinline__ void copy_rows(char* dst, const char* src,
                                          long long ss, int row, int valid,
                                          int nt, int lane) {
  const int lp = __ffs(row) - __ffs(V);
  for (int p = lane; p < (nt << lp); p += 32) {
    const int t = p >> lp;
    const int off = (p & ((1 << lp) - 1)) * V;
    if (off < valid) copy_piece<V>(dst + t * row + off, src + t * ss + off);
  }
}

// Copy tokens [t0, t0 + nt) of one stream: per token the `valid` bytes
// that start `col0` bytes into its row, into rows of `row` bytes of dst.
__device__ __forceinline__ void copy_stream(char* dst, const Stream s,
                                            int b, int t0, int nt, int col0,
                                            int row, int valid, int lane) {
  const char* src = s.base + b * s.sb + t0 * s.ss + col0;
  switch (s.vec) {
    case 16: copy_rows<16>(dst, src, s.ss, row, valid, nt, lane); break;
    case 8: copy_rows<8>(dst, src, s.ss, row, valid, nt, lane); break;
    case 4: copy_rows<4>(dst, src, s.ss, row, valid, nt, lane); break;
    default: copy_rows<2>(dst, src, s.ss, row, valid, nt, lane);
  }
}

// The same lane's pieces of one bf16 stream, landed, to fp32 (so its own
// cp.async completion suffices).
template <int V>
__device__ __forceinline__ void widen_rows(float* dst, const char* src,
                                           int row, int valid, int nt,
                                           int lane) {
  const int lp = __ffs(row) - __ffs(V);
  for (int p = lane; p < (nt << lp); p += 32) {
    const int t = p >> lp;
    const int off = (p & ((1 << lp) - 1)) * V;
    if (off < valid) {
      widen_piece<V>(dst + (t * row + off) / 2, src + t * row + off);
    }
  }
}

__device__ __forceinline__ void widen_stream(float* dst, const char* src,
                                             int vec, int row, int valid,
                                             int nt, int lane) {
  switch (vec) {
    case 16: widen_rows<16>(dst, src, row, valid, nt, lane); break;
    case 8: widen_rows<8>(dst, src, row, valid, nt, lane); break;
    case 4: widen_rows<4>(dst, src, row, valid, nt, lane); break;
    default: widen_rows<2>(dst, src, row, valid, nt, lane);
  }
}

// Named barriers between the producer warp and the compute warps: FULL(s)
// (slot s holds its chunk) and EMPTY(s) (slot s may be refilled); id 0 is
// __syncthreads'.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` committed groups are in flight
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

// Reduce-scatter of G tokens' partials over the G lanes of a row: lane k
// (k = lane index within the row) returns token k's sum. At mask m the
// lane whose bit m is set keeps the upper half of its tokens and sends
// the lower half; float addition is commutative, so both lanes of a pair
// form the same sum.
template <int G>
__device__ __forceinline__ float reduce_scatter(float* p, int k) {
  if constexpr (G == 1) {
    return p[0];
  } else {
    constexpr int H = G / 2;
    const bool upper = (k & H) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = upper ? p[j] : p[j + H];
      const float keep = upper ? p[j + H] : p[j];
      p[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, H));
    }
    return reduce_scatter<H>(p, k);
  }
}

// One token's inputs for one lane, read from the staged chunk.
struct TokenIn {
  float d, x, b[SPL], c[SPL];
};

// One token of one lane: its four states advanced, and its part of y
// (the four products h * C summed in n order).
__device__ __forceinline__ float token_step(float* hs, const float* a2,
                                            const TokenIn& in) {
  const float dx = __fmul_rn(in.d, in.x);
#pragma unroll
  for (int q = 0; q < SPL; ++q) {
    const float dA = ex2(__fmul_rn(in.d, a2[q]));
    hs[q] = __fmaf_rn(dA, hs[q], __fmul_rn(dx, in.b[q]));
  }
  float acc = __fmul_rn(hs[0], in.c[0]);
#pragma unroll
  for (int q = 1; q < SPL; ++q) acc = __fmaf_rn(hs[q], in.c[q], acc);
  return acc;
}

// Byte sizes of a block's shared memory: a ring of `stages` slots, each
// [dt (tokens, R) fp32 | x (tokens, R) | B (tokens, N) | C (tokens, N)]
// as copied from device memory and, for bf16, [x | B | C] widened to
// fp32; then room for the loads that run up to BATCH - 1 tokens past a
// chunk.
template <typename T, int N>
struct Layout {
  static constexpr int G = N / SPL;
  static constexpr int R = THREADS / G;
  static constexpr int ES = static_cast<int>(sizeof(T));
  static constexpr bool WIDEN = ES == 2;
  static_assert(BATCH % G == 0, "a batch is whole reduce-scatter groups");
  __host__ __device__ static int raw(int tokens) {
    return tokens * (R * 4 + R * ES + 2 * N * ES);
  }
  __host__ __device__ static int slot(int tokens) {
    return raw(tokens) + (WIDEN ? tokens * (R + 2 * N) * 4 : 0);
  }
  __host__ __device__ static int total(int tokens, int stages) {
    return stages * slot(tokens) + BATCH * R * 4;
  }
};

// The producer warp: fills the ring, one chunk per slot, `stages` - 1
// chunks ahead, and hands each chunk over (widened to fp32 for bf16) as
// soon as it has landed.
template <typename T, int N>
__device__ __forceinline__ void produce(char* smem, const Stream sdt,
                                        const Stream sx, const Stream sb,
                                        const Stream sc, int b, int i0,
                                        int rows, int S, int tokens,
                                        int stages, int chunks) {
  using L = Layout<T, N>;
  constexpr int R = L::R;
  constexpr int ES = L::ES;
  const int lane = threadIdx.x & 31;
  const int slot_bytes = L::slot(tokens);
  auto issue = [&](int c) {
    if (c < chunks) {
      if (c >= stages) bar_sync(1 + MAX_STAGES + c % stages, THREADS + 32);
      char* st = smem + (c % stages) * slot_bytes;
      const int t0 = c * tokens;
      const int nt = min(tokens, S - t0);
      copy_stream(st, sdt, b, t0, nt, i0 * 4, R * 4, rows * 4, lane);
      st += tokens * R * 4;
      copy_stream(st, sx, b, t0, nt, i0 * ES, R * ES, rows * ES, lane);
      st += tokens * R * ES;
      copy_stream(st, sb, b, t0, nt, 0, N * ES, N * ES, lane);
      st += tokens * N * ES;
      copy_stream(st, sc, b, t0, nt, 0, N * ES, N * ES, lane);
    }
    commit();
  };
  for (int c = 0; c < stages - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    wait_pending(stages - 2);                 // chunk c, this lane's part
    if constexpr (L::WIDEN) {
      const char* raw = smem + (c % stages) * slot_bytes + tokens * R * 4;
      float* f = reinterpret_cast<float*>(smem + (c % stages) * slot_bytes
                                          + L::raw(tokens));
      const int nt = min(tokens, S - c * tokens);
      widen_stream(f, raw, sx.vec, R * ES, rows * ES, nt, lane);
      widen_stream(f + tokens * R, raw + tokens * R * ES, sb.vec, N * ES,
                   N * ES, nt, lane);
      widen_stream(f + tokens * (R + N), raw + tokens * (R + N) * ES,
                   sc.vec, N * ES, N * ES, nt, lane);
    }
    bar_arrive(1 + c % stages, THREADS + 32);
    issue(c + stages - 1);                    // once chunk c - 1 is done
  }
  wait_pending(0);
}

// The tokens [0, n) of a batch whose inputs are in `in`: the lane's
// states advanced token by token, and y of token q + k (its sum over the
// row's lanes by reduce_scatter) stored by lane k at yb[q * y_ss].
template <typename T, int G, int BT>
__device__ __forceinline__ void run_batch(float* hs, const float* a2,
                                          const TokenIn (&in)[BT], int n,
                                          int k, bool live, float dsk,
                                          T* yb, long long y_ss) {
#pragma unroll
  for (int q = 0; q < BT; q += G) {
    if (q < n) {
      float p[G];
      float xk = in[q].x;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        p[j] = q + j < n ? token_step(hs, a2, in[q + j]) : 0.f;
        if (j == k) xk = in[q + j].x;
      }
      const float sum = reduce_scatter<G>(p, k);
      if (live && q + k < n) {
        yb[q * y_ss] = from_f<T>(__fmaf_rn(dsk, xk, sum));
      }
    }
  }
}

// RING: grid (ceil(I / R), Bt), THREADS + 32 threads: THREADS compute
// threads, thread = (row r, lane k) with R = THREADS / G rows per block
// and G = N / SPL lanes per row, lane k holding states SPL k .. SPL k +
// SPL - 1; then one producer warp (shared memory as in Layout). !RING (S
// <= BATCH, decode): the compute threads alone, each reading its tokens'
// inputs straight from device memory. h and h_out may alias, so neither
// is __restrict__.
template <typename T, int N, bool RING>
__global__ void __launch_bounds__(RING ? THREADS + 32 : THREADS)
ssm_scan_kernel(const float* h, float* h_out, const Stream sdt,
                const Stream sx, const float* __restrict__ A,
                const Stream sb, const Stream sc, const T* __restrict__ D,
                T* __restrict__ y, long long y_sb, long long y_ss, int I,
                int S, int tokens, int stages) {
  using L = Layout<T, N>;
  constexpr int G = L::G;
  constexpr int R = L::R;
  constexpr int BT = BATCH;
  constexpr int ES = L::ES;
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * R;
  const int rows = min(R, I - i0);
  const int chunks = (S + tokens - 1) / tokens;
  if constexpr (RING) {
    if (threadIdx.x >= THREADS) {
      produce<T, N>(smem, sdt, sx, sb, sc, b, i0, rows, S, tokens, stages,
                    chunks);
      return;
    }
  }
  const int r = threadIdx.x / G;
  const int k = threadIdx.x % G;
  const int i = i0 + r;
  const bool live = r < rows;

  // the row's states and decay rates (as log2-domain rates), read once
  float hs[SPL] = {};
  float a2[SPL] = {};
  static_assert(SPL == 4, "a lane's states are one float4");
  const long long hrow = (static_cast<long long>(b) * I + i) * N + SPL * k;
  float dsk = 0.f;
  if (live) {
    load4(h + hrow, hs);
    load4(A + static_cast<long long>(i) * N + SPL * k, a2);
#pragma unroll
    for (int q = 0; q < SPL; ++q) a2[q] = __fmul_rn(a2[q], LOG2E);
    dsk = to_f(D[i]);
  }
  // y of the lane's tokens: token t of a batch goes to yb[t * y_ss]
  T* yb = y + b * y_sb + (live ? i : i0) + k * y_ss;

  if constexpr (!RING) {
    TokenIn in[BT];
#pragma unroll
    for (int t = 0; t < BT; ++t) {
      in[t] = TokenIn{};
      if (t < S && live) {
        const long long bt = static_cast<long long>(b);
        in[t].d = *reinterpret_cast<const float*>(sdt.base + bt * sdt.sb
                                                  + t * sdt.ss + i * 4);
        in[t].x = to_f(*reinterpret_cast<const T*>(sx.base + bt * sx.sb
                                                   + t * sx.ss + i * ES));
        const T* bp = reinterpret_cast<const T*>(sb.base + bt * sb.sb
                                                 + t * sb.ss) + SPL * k;
        const T* cp = reinterpret_cast<const T*>(sc.base + bt * sc.sb
                                                 + t * sc.ss) + SPL * k;
#pragma unroll
        for (int q = 0; q < SPL; ++q) {
          in[t].b[q] = to_f(bp[q]);
          in[t].c[q] = to_f(cp[q]);
        }
      }
    }
    run_batch<T, G, BT>(hs, a2, in, S, k, live, dsk, yb, y_ss);
  } else {
    const int slot_bytes = L::slot(tokens);
    for (int c = 0; c < chunks; ++c) {
      bar_sync(1 + c % stages, THREADS + 32);   // the chunk is in its slot
      const char* st = smem + (c % stages) * slot_bytes;
      const float* pdt = reinterpret_cast<const float*>(st) + r;
      const float* px = reinterpret_cast<const float*>(
          st + (L::WIDEN ? L::raw(tokens) : tokens * R * 4)) + r;
      const float* pB = px - r + tokens * R + SPL * k;
      const float* pC = pB + tokens * N;
      const int nt = min(tokens, S - c * tokens);
      // token g + j's inputs; they may run up to BT - 1 past the chunk,
      // inside the block's shared memory (stale values, never used)
      auto load = [&](TokenIn (&in)[BT], int g) {
#pragma unroll
        for (int j = 0; j < BT; ++j) {
          const int t = g + j;
          in[j].d = pdt[t * R];
          in[j].x = px[t * R];
          load4(pB + t * N, in[j].b);
          load4(pC + t * N, in[j].c);
        }
      };
      // whole batches in turn from two register sets, the next batch's
      // inputs loaded before this batch's arithmetic
      TokenIn in0[BT], in1[BT];
      load(in0, 0);
      const long long step = BT * y_ss;
      int g = 0;
      for (; g + 2 * BT <= nt; g += 2 * BT) {
        load(in1, g + BT);
        run_batch<T, G, BT>(hs, a2, in0, BT, k, live, dsk, yb, y_ss);
        load(in0, g + 2 * BT);
        run_batch<T, G, BT>(hs, a2, in1, BT, k, live, dsk, yb + step, y_ss);
        yb += 2 * step;
      }
      if (g < nt) {
        load(in1, g + BT);
        run_batch<T, G, BT>(hs, a2, in0, min(BT, nt - g), k, live, dsk, yb,
                            y_ss);
        if (g + BT < nt) {
          run_batch<T, G, BT>(hs, a2, in1, nt - g - BT, k, live, dsk,
                              yb + step, y_ss);
        }
        yb += static_cast<long long>(nt - g) * y_ss;
      }
      if (c + stages < chunks) {
        bar_arrive(1 + MAX_STAGES + c % stages, THREADS + 32);
      }
    }
  }
  if (live) store4(h_out + hrow, hs);
}

// the widest copy (16, 8, 4, else 2 bytes) that the start, both strides
// and the bytes a row copies allow
int vec_bytes(const void* base, long long sb, long long ss, long long row) {
  const unsigned long long a = reinterpret_cast<uintptr_t>(base) |
                               static_cast<unsigned long long>(sb) |
                               static_cast<unsigned long long>(ss) |
                               static_cast<unsigned long long>(row);
  for (int v = 16; v >= 4; v /= 2) {
    if (a % v == 0) return v;
  }
  return 2;
}

Stream make_stream(const void* base, long long sb, long long ss, int es,
                   long long row) {
  Stream s;
  s.base = static_cast<const char*>(base);
  s.sb = sb * es;
  s.ss = ss * es;
  s.vec = vec_bytes(base, s.sb, s.ss, row * es);
  return s;
}

template <typename T, int N>
int launch(const void* h, void* h_out, const void* dt, const void* x,
           const void* A, const void* Bm, const void* Cm, const void* D,
           void* y, int Bt, int I, int S, const long long* st, int tokens,
           int stages, cudaStream_t stream) {
  using L = Layout<T, N>;
  const dim3 grid((I + L::R - 1) / L::R, Bt);
  const Stream sdt = make_stream(dt, st[0], st[1], 4, I);
  const Stream sx = make_stream(x, st[2], st[3], L::ES, I);
  const Stream sb = make_stream(Bm, st[4], st[5], L::ES, N);
  const Stream sc = make_stream(Cm, st[6], st[7], L::ES, N);
  if (stages == 0) {                       // decode: S <= BATCH, no ring
    if (S > BATCH) return -1;
    ssm_scan_kernel<T, N, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(h), static_cast<float*>(h_out), sdt, sx,
        static_cast<const float*>(A), sb, sc, static_cast<const T*>(D),
        static_cast<T*>(y), st[8], st[9], I, S, tokens, stages);
    return 0;
  }
  if (stages < MIN_STAGES || stages > MAX_STAGES) return -1;
  const int smem = L::total(tokens, stages);
  if (smem > MAX_SMEM) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_kernel<T, N, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssm_scan_kernel<T, N, true><<<grid, THREADS + 32, smem, stream>>>(
      static_cast<const float*>(h), static_cast<float*>(h_out), sdt, sx,
      static_cast<const float*>(A), sb, sc, static_cast<const T*>(D),
      static_cast<T*>(y), st[8], st[9], I, S, tokens, stages);
  return 0;
}

template <typename T>
int dispatch_n(int N, const void* h, void* h_out, const void* dt,
               const void* x, const void* A, const void* Bm, const void* Cm,
               const void* D, void* y, int Bt, int I, int S,
               const long long* st, int tokens, int stages,
               cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch<T, 4>(h, h_out, dt, x, A, Bm, Cm, D, y, Bt, I, S, st,
                          tokens, stages, stream);
    case 8:
      return launch<T, 8>(h, h_out, dt, x, A, Bm, Cm, D, y, Bt, I, S, st,
                          tokens, stages, stream);
    case 16:
      return launch<T, 16>(h, h_out, dt, x, A, Bm, Cm, D, y, Bt, I, S, st,
                           tokens, stages, stream);
    default:
      return -1;
  }
}

}  // namespace

// h, h_out (Bt, I, N) and A (I, N) contiguous fp32 with 16-byte aligned
// starts (h_out may equal h); dt (Bt, S, I) fp32, x and y (Bt, S, I), B
// and C (Bt, S, N), D (I,), each with a contiguous last dimension; *_sb
// and *_ss are the batch-row and token strides in elements. N in {4, 8,
// 16}; dtype (of x, B, C, D and y): 0 = float32, 1 = bfloat16; tokens
// (a multiple of 4, at most 256) and stages (2-4) from the host's
// ssm_scan_plan. Returns -1 for unsupported sizes, else the launch's CUDA
// error (0 on success).
extern "C" int hc_ssm_update(const void* h, void* h_out, const void* dt,
                             const void* x, const void* A, const void* Bm,
                             const void* Cm, const void* D, void* y, int Bt,
                             int I, int N, int S, long long dt_sb,
                             long long dt_ss, long long x_sb, long long x_ss,
                             long long b_sb, long long b_ss, long long c_sb,
                             long long c_ss, long long y_sb, long long y_ss,
                             int dtype, int tokens, int stages,
                             void* stream) {
  if (Bt < 1 || Bt > 65535 || I < 1 || S < 1 || tokens < 4 ||
      tokens > MAX_TOKENS || tokens % 4) {
    return -1;
  }
  const long long st[10] = {dt_sb, dt_ss, x_sb, x_ss, b_sb,
                            b_ss,  c_sb,  c_ss, y_sb, y_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch_n<float>(N, h, h_out, dt, x, A, Bm, Cm, D, y, Bt, I, S, st,
                           tokens, stages, s);
  } else if (dtype == 1) {
    rc = dispatch_n<__nv_bfloat16>(N, h, h_out, dt, x, A, Bm, Cm, D, y, Bt,
                                   I, S, st, tokens, stages, s);
  } else {
    rc = -1;
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
