// Tiled matmul for Hopper (sm_90a): y (M,N) = x (M,K) @ w (K,N), f32
// accumulation, output in x's type. x and w are read through their strides,
// so the gradient products dX = dY @ W^T and dW = X^T @ dY read the saved
// tensors in place, as transposed views.
//
// Replaces the Pallas TPU kernel repro/kernels/tiled_matmul.py
// (tiled_matmul / _mm_kernel), which streams W through VMEM in (bk, bn)
// tiles with an f32 scratch accumulator over a sequential k grid axis.
//
// Two routes, chosen per call by kernels/tiled_matmul.py:route():
//   wgmma -- bf16 operands that TMA can describe (one unit stride, the other
//            stride a multiple of 8 elements, base aligned to 16 bytes):
//            tensor cores fed by a TMA/mbarrier ring. Every bf16 product of
//            the serving and training paths takes it.
//   simt  -- everything else: f32 operands (wgmma has only TF32 for f32,
//            which would break the f32 tolerance) and bf16 views TMA cannot
//            describe. CUDA-core f32 FMAs, the first design, kept as it was.
//
// Bound on this card (989 TFLOP/s bf16, 3.35 TB/s; each operand read once,
// y written once):
//   training (4096,576)@(576,1536), (4096,1536)@(1536,576), dX and
//     dW (576,4096)@(4096,1536), (1536,4096)@(4096,576): 7.25 GFLOP, 19.1 MB
//     -> 7.33 us by operations (5.69 us by bytes);
//   prefill (2048,576)@(576,1536), (2048,1536)@(1536,576): 3.62 GFLOP,
//     10.4 MB -> 3.66 us by operations;
//   decode (4,576)@(576,1536): 1.79 MB, almost all of it w -> 0.53 us by bytes.
//
// wgmma design. A block computes a 128 x BN tile of y (BN = 128, or 64
// for products too small to fill the card; kernels/tiled_matmul.py:plan
// states the rule), with 288 threads: warpgroups 0 and 1 consume, each
// owning 64 rows of the tile with a wgmma m64nBNk16 accumulator in
// registers (BN/2 f32 per thread); warp 8 produces. K runs in slices of
// BK = 64 bf16 (128 bytes, the span of TMA's 128-byte swizzle) through a
// ring of 4 shared-memory stages (32 KB each at BN = 128, 128 KB in all,
// one block per SM; 24 KB at BN = 64, two blocks per SM), each with a full
// and an empty mbarrier: one thread of the producer issues the TMA loads of
// stage s + 4 while the consumers multiply stage s, and each consumer keeps
// one wgmma group in flight while it waits for the next stage. Each operand
// lands in its native layout, so no copy or transpose is made anywhere:
//   x K-major (row-major x, the forward and dX) : one box {64 k, 128 m};
//   x M-major (X^T view, dW)                    : two boxes {64 m, 64 k};
//   w K-major (W^T view, dX)                    : one box {64 k, BN n};
//   w N-major (row-major w, forward and dW)     : BN/64 boxes {64 n, 64 k};
// and the wgmma descriptors say which (the instruction's transpose bits):
// K-major tiles step 32 bytes per k16 with 1024 bytes between 8-row groups;
// M/N-major tiles step 2048 bytes (16 rows of 128 bytes) per k16, with 1024
// bytes between 8-row groups of k and 8192 bytes between 64-wide chunks of
// m or n. TMA zero-fills whatever lies past M, N or K, so the main loop
// has no masks; the epilogue writes the row-major y from registers, masked
// at the M and N edges. Products whose 128 x 128 tiles would leave SMs idle
// and whose K is long (the weight gradients, K = 4096) split K over
// gridDim.z: each part writes its f32 partial sums to a workspace slab and
// a second kernel adds the slabs in order and rounds to bf16
// (deterministic, no atomics). Descriptors are encoded on the host per call
// (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so the
// library needs no -lcuda) and passed as __grid_constant__ parameters.
//
// What this does about the bound: the tensor cores do all the multiply-adds
// (the f32 FMA rate, 67 TFLOP/s, put ~0.11 ms under each training product),
// loads never stall the multiply while the ring is full, and shared memory
// is read by the tensor cores alone. Left for later: a persistent,
// tile-scheduled kernel whose epilogue overlaps the next tile's loads, TMA
// stores, cached descriptors, and a small-M path for decode (a 128-row tile
// at M = 4 computes 32x the rows it keeps).
//
// Registers and spills (nvcc -Xptxas -v, CUDA 12.8, sm_90a): wgmma kernel
// 90 registers at BN = 128 and 58 at BN = 64 (each of the four transpose
// combinations), 0 bytes of spills and stack; split-K sum 32 registers;
// simt kernel 64 registers, 8320 bytes of static shared memory, no spills.
//
// C interface (ctypes): pointers and the stream are void*, strides are in
// elements, y is row-major contiguous. Every entry returns
// cudaGetLastError() (or cudaErrorInvalidValue for what it cannot take).

#include <cuda.h>  // CUtensorMap and the driver's enums; no driver call is linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace simt {

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

}  // namespace simt


namespace wg {

constexpr int BM = 128;                  // rows of y per block: two m64 consumers
constexpr int BK = 64;                   // bf16 per k slice: 128 bytes, the swizzle span
constexpr int STAGES = 4;                // ring depth
template <int BN> constexpr int PER_SM = BN == 64 ? 2 : 1;  // resident blocks per SM
constexpr int THREADS = 2 * 128 + 32;    // two consumer warpgroups, one producer warp
constexpr int A_BYTES = BM * BK * 2;     // 16 KB per stage
constexpr int CHUNK = 64 * 64 * 2;       // one {64, 64} box: 8 KB

template <int BN> constexpr int B_BYTES = BK * BN * 2;
template <int BN>  // + slack to align the ring to 1024 bytes
constexpr int SMEM_BYTES = STAGES * (A_BYTES + B_BYTES<BN>) + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t addr = smem_u32(b);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 2-D TMA box at coordinates (c0 innermost, c1) into shared memory,
// completing on the barrier's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// TA / TB: the instruction's transpose bits -- 0 for a K-major operand,
// 1 for an M-major A or an N-major B.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}


template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_n128<TA, TB>(d, da, db, 1);
  else wgmma_n64<TA, TB>(d, da, db, 1);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's wait.
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN, int TA, int TB>
__global__ void __launch_bounds__(THREADS, PER_SM<BN>)
wgmma_kernel(const __grid_constant__ CUtensorMap tma_x, const __grid_constant__ CUtensorMap tma_w,
             __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int M, int N, int K,
             int kt_split) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles must start on 1024-byte boundaries
  uint8_t* sa = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sb = sa + STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_BYTES<BN>);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * kt_split;  // this split's first k slice
  const int nk = min(kt_split, (K + BK - 1) / BK - kt0);  // >= 1 by the host's split

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; TMA completes the bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp: one thread issues every load
    if (threadIdx.x == 256) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], A_BYTES + B_BYTES<BN>);
        const int k = (kt0 + i) * BK;
        uint8_t* a = sa + s * A_BYTES;
        uint8_t* b = sb + s * B_BYTES<BN>;
        if (TA) {
          tma_load(a, &tma_x, &full[s], m0, k);
          tma_load(a + CHUNK, &tma_x, &full[s], m0 + 64, k);
        } else {
          tma_load(a, &tma_x, &full[s], k, m0);
        }
        if (TB) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) tma_load(b + c * CHUNK, &tma_w, &full[s], n0 + 64 * c, k);
        } else {
          tma_load(b, &tma_w, &full[s], k, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows [64 g, 64 g + 64) of the tile, which
  // start CHUNK bytes into the A stage in either layout
  const int g = threadIdx.x / 128;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  fence_regs(d);
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* a = sa + s * A_BYTES + g * CHUNK;
    const uint8_t* b = sb + s * B_BYTES<BN>;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = TA ? gmma_desc(a + kk * 2048, CHUNK, 1024) : gmma_desc(a + kk * 32, 16, 1024);
      const uint64_t db = TB ? gmma_desc(b + kk * 2048, CHUNK, 1024) : gmma_desc(b + kk * 32, 16, 1024);
      mma<BN, TA, TB>(d, da, db);
    }
    wgmma_commit();
    // keep this slice's group in flight; the previous slice's is done, so
    // its stage goes back to the producer
    wgmma_wait<1>();
    if (i > 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(d);

  // epilogue: d[4i + 2j + c] is row 16 warp + lane/4 + 8j, column
  // 8i + 2 (lane % 4) + c of this warpgroup's 64 x BN block
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int rbase = m0 + g * 64 + warp * 16 + lane / 4;
  const bool pairs = (N % 2) == 0;  // a column pair is then aligned and in or out together
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = n0 + 8 * i + 2 * (lane % 4);
    if (c >= N) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = rbase + 8 * j;
      if (r >= M) continue;
      const float v0 = d[4 * i + 2 * j], v1 = d[4 * i + 2 * j + 1];
      if (ws != nullptr) {
        float* o = ws + (static_cast<int64_t>(blockIdx.z) * M + r) * N + c;
        if (pairs) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        else { o[0] = v0; if (c + 1 < N) o[1] = v1; }
      } else {
        __nv_bfloat16* o = y + static_cast<int64_t>(r) * N + c;
        if (pairs) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        else { o[0] = __float2bfloat16(v0); if (c + 1 < N) o[1] = __float2bfloat16(v1); }
      }
    }
  }
}

// y = bf16(sum over the split slabs of ws), the slabs added in order.
__global__ void splitk_sum(const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
                           int64_t mn, int split) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < split; ++z) acc += ws[z * mn + i];
    y[i] = __float2bfloat16(acc);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (rows, cols) operand whose cols run along the unit stride and whose
// rows lie `ld` elements apart, cut into boxes of {box0 cols, box1 rows}.
bool encode(CUtensorMap* map, const void* base, int64_t cols, int64_t rows, int64_t ld,
            uint32_t box0, uint32_t box1) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {box0, box1};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int BN, int TA, int TB>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mw, __nv_bfloat16* y, float* ws,
                   int M, int N, int K, int split, int kt_split, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(wgmma_kernel<BN, TA, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES<BN>);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  wgmma_kernel<BN, TA, TB><<<grid, THREADS, (SMEM_BYTES<BN>), s>>>(mx, mw, y, ws, M, N, K,
                                                                    kt_split);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(bool ta, bool tb, const CUtensorMap& mx, const CUtensorMap& mw,
                      __nv_bfloat16* y, float* ws, int M, int N, int K, int split, int kt_split,
                      cudaStream_t s) {
  if (!ta && tb) return launch<BN, 0, 1>(mx, mw, y, ws, M, N, K, split, kt_split, s);
  if (!ta && !tb) return launch<BN, 0, 0>(mx, mw, y, ws, M, N, K, split, kt_split, s);
  if (ta && tb) return launch<BN, 1, 1>(mx, mw, y, ws, M, N, K, split, kt_split, s);
  return launch<BN, 1, 0>(mx, mw, y, ws, M, N, K, split, kt_split, s);
}

}  // namespace wg

// The simt route. dtype: 0 = float32, 1 = bfloat16.
extern "C" int tiled_matmul(const void* x, const void* w, void* y, int M,
                            int N, int K, int64_t sxm, int64_t sxk,
                            int64_t swk, int64_t swn, int dtype, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (M <= 0 || N <= 0 || K <= 0 || (M + simt::BM - 1) / simt::BM > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + simt::BN - 1) / simt::BN, (M + simt::BM - 1) / simt::BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    simt::tiled_matmul_kernel<float><<<grid, simt::THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), M, N, K, sxm, sxk, swk, swn);
  else if (dtype == 1)
    simt::tiled_matmul_kernel<__nv_bfloat16><<<grid, simt::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), M, N, K, sxm, sxk, swk, swn);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The wgmma route, bf16 only. x_kmajor: x's k runs along its unit stride
// (else its m does), and its other stride is x_ld; likewise w_kmajor, w_ld.
// bn is 128 or 64; split > 1 splits K, writing f32 partial sums to ws
// (split x M x N, allocated by the caller) before they are added into y.
extern "C" int tiled_matmul_wgmma(const void* x, const void* w, void* y, void* ws, int M, int N,
                                  int K, int x_kmajor, int64_t x_ld, int w_kmajor,
                                  int64_t w_ld, int bn, int split, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const int kt = (K + wg::BK - 1) / wg::BK;
  if (M <= 0 || N <= 0 || K <= 0 || (M + wg::BM - 1) / wg::BM > 65535 || (bn != 128 && bn != 64) ||
      split < 1 || split > kt || (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int kt_split = (kt + split - 1) / split;
  split = (kt + kt_split - 1) / kt_split;  // no empty split
  // The encoder is a driver call: it needs the device's context current on
  // this thread, which a runtime call has not always made so (autograd's
  // backward runs on a thread of its own). cudaSetDevice binds it.
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mx, mw;
  const bool ok =
      (x_kmajor ? wg::encode(&mx, x, K, M, x_ld, wg::BK, wg::BM)
                : wg::encode(&mx, x, M, K, x_ld, 64, wg::BK)) &&
      (w_kmajor ? wg::encode(&mw, w, K, N, w_ld, wg::BK, bn)
                : wg::encode(&mw, w, N, K, w_ld, 64, wg::BK));
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  float* wsf = split > 1 ? static_cast<float*>(ws) : nullptr;
  e = bn == 128
      ? wg::launch_bn<128>(!x_kmajor, !w_kmajor, mx, mw, yb, wsf, M, N, K, split, kt_split, s)
      : wg::launch_bn<64>(!x_kmajor, !w_kmajor, mx, mw, yb, wsf, M, N, K, split, kt_split, s);
  if (e != cudaSuccess || split == 1) return (int)e;
  const int64_t mn = static_cast<int64_t>(M) * N;
  const int blocks = static_cast<int>(std::min<int64_t>((mn + 255) / 256, 132 * 8));
  wg::splitk_sum<<<blocks, 256, 0, s>>>(wsf, yb, mn, split);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
