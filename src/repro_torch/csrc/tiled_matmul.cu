// Tiled matmul for Hopper (sm_90a): y (M,N) = x (M,K) @ w (K,N), f32
// accumulation, output in x's type. x and w are read through row and column
// strides, so the gradient products dX = dY @ W^T and dW = X^T @ dY read the
// saved tensors in place, as transposed views.
//
// Replaces the Pallas TPU kernel repro/kernels/tiled_matmul.py
// (tiled_matmul / _mm_kernel), which streams W through VMEM in (bk, bn)
// tiles with an f32 scratch accumulator over a sequential k grid axis.
//
// Design. One thread block per BM x BN output tile; a loop over K in BKK
// slices stages the x and w tiles in shared memory as f32 (zero-filled past
// the ragged M, N and K edges, where the TPU kernel zero-pads), and each of
// the 256 threads accumulates a TM x TN patch in registers. A thread's rows
// and columns are strided by 16, so the 16 column threads of a warp read
// neighbouring shared-memory words and write neighbouring output elements.
//
// Bound on this card: the MLP's prefill products ((2048,576)@(576,1536) and
// (2048,1536)@(1536,576) in bf16) do ~350 flop per byte moved, above the
// H100's ~295 flop/byte bf16 ridge, so the least time is set by tensor-core
// operations (~3.7 us); the decode product (4,576)@(576,1536) is set by
// reading W (~0.5 us). This first version uses CUDA-core f32 FMAs, so it is
// bound by them at prefill and by too few blocks at decode; wgmma/TMA and a
// split-K decode path are the later, faster version.
//
// C interface (ctypes): pointers and the stream are void*, strides are in
// elements (any, a transpose included), y is row-major contiguous. Returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BKK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int TX = BN / TN;  // 16 column threads
constexpr int TY = BM / TM;  // 16 row threads
constexpr int THREADS = TX * TY;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tiled_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int M, int N, int K, int64_t sxm,
                    int64_t sxk, int64_t swk, int64_t swn) {
  __shared__ float xs[BKK][BM + 1];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BKK][BN + 1];
  const bool x_rows = sxk == 1;  // walk x along k (row-major) or along m
  const bool w_rows = swn == 1;  // walk w along n (row-major) or along k

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKK) {
    for (int idx = threadIdx.x; idx < BM * BKK; idx += THREADS) {
      const int r = x_rows ? idx / BKK : idx % BM;
      const int c = x_rows ? idx % BKK : idx / BM;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < M && gc < K) ? to_f(x[gr * sxm + gc * sxk]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BKK * BN; idx += THREADS) {
      const int r = w_rows ? idx / BN : idx % BKK;
      const int c = w_rows ? idx % BN : idx / BKK;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < K && gc < N) ? to_f(w[gr * swk + gc * swn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + TY * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + TX * j;
      if (c < N) y[(int64_t)r * N + c] = from_f<T>(acc[i][j]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int tiled_matmul(const void* x, const void* w, void* y, int M,
                            int N, int K, int64_t sxm, int64_t sxk,
                            int64_t swk, int64_t swn, int dtype, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    tiled_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), M, N, K, sxm, sxk, swk, swn);
  else if (dtype == 1)
    tiled_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), M, N, K, sxm, sxk, swk, swn);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
