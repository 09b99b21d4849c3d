// Mamba1 single-token state update, the decode hot loop of the ssm family:
//
//     h' = exp(dt * A) * h + (dt * x) (outer) B
//     y  = h' . C + D * x
//
// h (Bt, I, N) fp32, dt (Bt, I) fp32, x (Bt, I), A (I, N) fp32,
// B and C (Bt, N), D (I,); returns h' (fp32) and y (x's type).
//
// Replaces the TPU kernel repro/kernels/ssm_update.py ::
// ssm_update_pallas. The JAX model's own decode runs the same arithmetic
// as a jnp scan at S = 1 (repro/models/layers/mamba.py::apply_mamba1);
// the port runs this kernel there, and once per token in prefill.
//
// What bounds it on an H100: bytes. Each (b, i) row reads its N fp32
// states and N fp32 decay rates and writes N new states; the arithmetic
// is ~6 operations and one exp per state. At the engine's Bt = 4, I =
// 8192, N = 16 the launch moves ~4.7 MB, ~1.4 us at 3.35 TB/s, so a
// single launch is dominated by its latency.
//
// What the design does about it: one thread per (b, i) row keeps the
// row's N states in registers, read and written with 16-byte vector
// loads and stores (h and A rows are contiguous), so the state makes
// one pass through memory (the jnp path materialises dA and dBx
// separately). y is summed inside the thread over n in order, so there
// is no cross-thread reduction and equal inputs give equal bits. The
// block's threads share one batch row, whose B and C (2N values) are read
// once per block into shared memory. dt, x, B, C and y are addressed
// through a batch-row stride, so the prefill loop passes per-token column
// views of (Bt, S, .) tensors without a copy. h' may be written over h.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

// grid (ceil(I / THREADS), Bt); h and h_out may alias, so neither is
// __restrict__.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssm_update_kernel(
    const float* h, float* h_out, const float* __restrict__ dt,
    const T* __restrict__ x, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const T* __restrict__ D, T* __restrict__ y, int I, long long dt_sb,
    long long x_sb, long long b_sb, long long c_sb, long long y_sb) {
  __shared__ float sB[N];
  __shared__ float sC[N];
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  if (t < N) {
    sB[t] = to_f(Bm[b * b_sb + t]);
  } else if (t < 2 * N) {
    sC[t - N] = to_f(Cm[b * c_sb + t - N]);
  }
  __syncthreads();
  const int i = blockIdx.x * THREADS + t;
  if (i >= I) return;
  const float d = dt[b * dt_sb + i];
  const float xv = to_f(x[b * x_sb + i]);
  const float dx = d * xv;
  const long long row = (static_cast<long long>(b) * I + i) * N;
  const float4* hrow = reinterpret_cast<const float4*>(h + row);
  const float4* arow =
      reinterpret_cast<const float4*>(A + static_cast<long long>(i) * N);
  float4* orow = reinterpret_cast<float4*>(h_out + row);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 hv = hrow[q];
    const float4 av = arow[q];
    const int n = 4 * q;
    float4 o;
    o.x = expf(d * av.x) * hv.x + dx * sB[n];
    o.y = expf(d * av.y) * hv.y + dx * sB[n + 1];
    o.z = expf(d * av.z) * hv.z + dx * sB[n + 2];
    o.w = expf(d * av.w) * hv.w + dx * sB[n + 3];
    acc += o.x * sC[n];
    acc += o.y * sC[n + 1];
    acc += o.z * sC[n + 2];
    acc += o.w * sC[n + 3];
    orow[q] = o;
  }
  y[b * y_sb + i] = from_f<T>(acc + to_f(D[i]) * xv);
}

template <typename T, int N>
void launch(const void* h, void* h_out, const void* dt, const void* x,
            const void* A, const void* Bm, const void* Cm, const void* D,
            void* y, int Bt, int I, long long dt_sb, long long x_sb,
            long long b_sb, long long c_sb, long long y_sb,
            cudaStream_t st) {
  const dim3 grid((I + THREADS - 1) / THREADS, Bt);
  ssm_update_kernel<T, N><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(h), static_cast<float*>(h_out),
      static_cast<const float*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(D),
      static_cast<T*>(y), I, dt_sb, x_sb, b_sb, c_sb, y_sb);
}

template <typename T>
int dispatch_n(int N, const void* h, void* h_out, const void* dt,
               const void* x, const void* A, const void* Bm, const void* Cm,
               const void* D, void* y, int Bt, int I, long long dt_sb,
               long long x_sb, long long b_sb, long long c_sb,
               long long y_sb, cudaStream_t st) {
  switch (N) {
    case 4:
      launch<T, 4>(h, h_out, dt, x, A, Bm, Cm, D, y, Bt, I, dt_sb, x_sb,
                   b_sb, c_sb, y_sb, st);
      return 0;
    case 8:
      launch<T, 8>(h, h_out, dt, x, A, Bm, Cm, D, y, Bt, I, dt_sb, x_sb,
                   b_sb, c_sb, y_sb, st);
      return 0;
    case 16:
      launch<T, 16>(h, h_out, dt, x, A, Bm, Cm, D, y, Bt, I, dt_sb, x_sb,
                    b_sb, c_sb, y_sb, st);
      return 0;
    default:
      return -1;
  }
}

}  // namespace

// h, h_out (Bt, I, N) and A (I, N) contiguous fp32 with 16-byte aligned
// starts (h_out may equal h); dt (Bt, I) fp32, x and y (Bt, I), B and C
// (Bt, N), D (I,), each with a contiguous last dimension; *_sb is the
// batch-row stride in elements. N in {4, 8, 16}. dtype (of x, B, C, D
// and y): 0 = float32, 1 = bfloat16. Returns -1 for unsupported sizes,
// else the launch's CUDA error (0 on success).
extern "C" int hc_ssm_update(const void* h, void* h_out, const void* dt,
                             const void* x, const void* A, const void* Bm,
                             const void* Cm, const void* D, void* y, int Bt,
                             int I, int N, long long dt_sb, long long x_sb,
                             long long b_sb, long long c_sb, long long y_sb,
                             int dtype, void* stream) {
  if (Bt < 1 || Bt > 65535 || I < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch_n<float>(N, h, h_out, dt, x, A, Bm, Cm, D, y, Bt, I, dt_sb,
                           x_sb, b_sb, c_sb, y_sb, st);
  } else if (dtype == 1) {
    rc = dispatch_n<__nv_bfloat16>(N, h, h_out, dt, x, A, Bm, Cm, D, y, Bt,
                                   I, dt_sb, x_sb, b_sb, c_sb, y_sb, st);
  } else {
    rc = -1;
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
