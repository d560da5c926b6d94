// Quantized matmul for Hopper (sm_90a): y = x @ dequant(q, s) with the
// weight in the q8 wire layout -- int8 quants q (K,N) and fp16 absmax/127
// scales s (K,N/32), one scale per 32 consecutive elements of a row -- and
// with `trans` the dX product y = x @ dequant(q, s)^T. f32 math, output in
// x's type. The weight's f32 values exist only in shared memory.
//
// Replaces the Pallas TPU kernel repro/kernels/tiled_matmul.py
// (quantized_matmul / _qmm_kernel), which dequantizes each (bk, bn) weight
// tile in VMEM right before the MXU dot with an f32 scratch accumulator over
// a sequential k grid axis. The TPU kernel has no transposed orientation
// (nothing in the reference differentiates through it); the training path
// here does, so `trans` is its dX.
//
// Design: the structure of tiled_matmul.cu. One thread block per BM x BN
// output tile; a loop over the contraction in BKK slices stages the x tile
// (bf16 or f32, converted to f32) and the weight tile in shared memory. The
// weight tile is loaded as int8 with its fp16 scales and dequantized to f32
// (one f32 product q * s per element, as the plain version computes it)
// right before the FMAs. Ragged M, N and K edges are zero-filled in the
// tile; N must be a multiple of 32 (checked by the wrapper). Each of the
// 256 threads accumulates a TM x TN patch in registers. Forward, the
// contraction runs along q's rows and the output along its columns; with
// `trans` the contraction runs along q's columns (N) and the output along
// its rows (K), and the scale of element (k, n) is still s[k, n/32]. Both
// orientations load the weight tile walking q along its rows' unit stride.
//
// Bound on this card: at the training shapes ((4096,576)@q(576,1536) and
// (4096,1536)@q(1536,576)) the product does ~400 flop per byte moved
// (x, q, s and y once each), above the ~295 flop/byte bf16 ridge, so the
// least time is set by tensor-core operations (~7.3 us at 989 TFLOP/s).
// This first version dequantizes into f32 and uses CUDA-core FMAs, so it is
// bound by those; int8/bf16 tensor-core products (wgmma) with TMA-fed tiles
// are the later, faster version.
//
// C interface (ctypes): pointers and the stream are void*, x's strides and
// q's and s's row strides are in elements (q and s have unit column
// stride), y is row-major contiguous. Returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 32;
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

// y (M, Nout) = x (M, Kc) @ W (Kc, Nout), W from the q8 operands:
//   TRANS false: W[k][n] = q[k*ldq + n] * s[k*lds + n/32]  (Kc = K, Nout = N)
//   TRANS true:  W[n][k] = q[k*ldq + n] * s[k*lds + n/32]  (Kc = N, Nout = K)
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
quantized_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                        const __half* __restrict__ s, T* __restrict__ y, int M,
                        int Nout, int Kc, int64_t sxm, int64_t sxk, int64_t ldq,
                        int64_t lds) {
  __shared__ float xs[BKK][BM + 1];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BKK][BN + 1];  // dequantized weight tile: ws[k][n]
  const bool x_rows = sxk == 1;  // walk x along k (row-major) or along m

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kc; k0 += BKK) {
    for (int idx = threadIdx.x; idx < BM * BKK; idx += THREADS) {
      const int r = x_rows ? idx / BKK : idx % BM;
      const int c = x_rows ? idx % BKK : idx / BM;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < M && gc < Kc) ? to_f(x[gr * sxm + gc * sxk]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BKK * BN; idx += THREADS) {
      // neighbouring threads take neighbouring elements of a row of q
      const int r = TRANS ? idx % BKK : idx / BN;  // contraction index
      const int c = TRANS ? idx / BKK : idx % BN;  // output column
      const int gk = k0 + r, gc = col0 + c;
      float wv = 0.f;
      if (gk < Kc && gc < Nout) {
        const int64_t qr = TRANS ? gc : gk;  // row of q
        const int64_t qc = TRANS ? gk : gc;  // column of q, along the block
        wv = static_cast<float>(q[qr * ldq + qc]) *
             __half2float(s[qr * lds + qc / QBLOCK]);
      }
      ws[r][c] = wv;
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
      if (c < Nout) y[(int64_t)r * Nout + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* q, const void* s, void* y, int M,
            int Nout, int Kc, int64_t sxm, int64_t sxk, int64_t ldq,
            int64_t lds, int trans, cudaStream_t stream) {
  dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const __half* sp = static_cast<const __half*>(s);
  T* yp = static_cast<T*>(y);
  if (trans)
    quantized_matmul_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        xp, qp, sp, yp, M, Nout, Kc, sxm, sxk, ldq, lds);
  else
    quantized_matmul_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        xp, qp, sp, yp, M, Nout, Kc, sxm, sxk, ldq, lds);
}

}  // namespace

// y (M, Nout) = x (M, Kc) @ W. Forward (trans 0): q, s are (Kc, Nout),
// (Kc, Nout/32). dX (trans 1): q, s are (Nout, Kc), (Nout, Kc/32).
// dtype: 0 = float32, 1 = bfloat16 (x and y).
extern "C" int quantized_matmul(const void* x, const void* q, const void* s,
                                void* y, int M, int Nout, int Kc, int64_t sxm,
                                int64_t sxk, int64_t ldq, int64_t lds,
                                int trans, int dtype, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const int n_blocked = trans ? Kc : Nout;  // q's columns, along the blocks
  if (M <= 0 || Nout <= 0 || Kc <= 0 || n_blocked % QBLOCK != 0 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, q, s, y, M, Nout, Kc, sxm, sxk, ldq, lds, trans, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, q, s, y, M, Nout, Kc, sxm, sxk, ldq, lds, trans, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
