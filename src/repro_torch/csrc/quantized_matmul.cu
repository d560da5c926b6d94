// Quantized matmul for Hopper (sm_90a): y = x @ dequant(q, s) with the
// weight in the q8 wire layout -- int8 quants q (K,N) and fp16 absmax/127
// scales s (K,N/32), one scale per 32 consecutive elements of a row -- and
// with `trans` the dX product y = x @ dequant(q, s)^T. f32 accumulation,
// output in x's type. The weight's full-precision values exist only in
// shared memory: what crosses HBM is the int8 tile and its scales.
//
// Replaces the Pallas TPU kernel repro/kernels/tiled_matmul.py
// (quantized_matmul / _qmm_kernel), which dequantizes each (bk, bn) weight
// tile in VMEM right before the MXU dot with an f32 scratch accumulator over
// a sequential k grid axis. The TPU kernel has no transposed orientation
// (nothing in the reference differentiates through it); the training path
// here does, so `trans` is its dX.
//
// Two routes, chosen per call by kernels/quantized_matmul.py:route():
//   wgmma -- bf16 x that TMA can describe K-major (unit column stride, row
//            stride a multiple of 8 elements, base on 16 bytes) and q whose
//            row stride is a multiple of 16 bytes with its base on 16 bytes:
//            tensor cores fed by a TMA/mbarrier ring. Every quantized call of
//            the q8 training path takes it, forward and dX.
//   simt  -- everything else: f32 x (wgmma's only f32 input is TF32, which
//            would break the f32 tolerance) and views TMA cannot describe.
//            The first design's CUDA-core f32 FMAs, kept as it was.
//
// Bound on this card: at the training shapes ((4096,576)@q(576,1536) and
// (4096,1536)@q(1536,576), and the dX of each) the product does ~400 flop
// per byte moved (x, q, s and y once each), above the ~295 flop/byte bf16
// ridge, so the least time is set by the 2 M N K operations (7.33 us at
// 989 TFLOP/s); the CUDA-core route is bound by its f32 FMAs instead
// (67 TFLOP/s: 0.11 ms at best), which is what the tensor cores remove.
//
// wgmma design: the tiled matmul's mainloop (tiled_matmul.cu, namespace
// wg) with a dequant stage between the ring and the tensor cores. A block
// computes a 128 x BN tile of y (BN = 128, or 64 where 128 x 128 tiles
// would leave the last wave mostly idle; kernels/quantized_matmul.py:plan
// states the rule) with 384
// threads: warpgroups 0 and 1 consume, each owning 64 rows with a wgmma
// m64nBNk16 accumulator in registers; warps 8-11 produce. The contraction
// runs in slices of BK = 64 through a ring of 4 stages, each with a full and
// an empty mbarrier and a producer warp of its own. Per slice that warp's
// lane 0 issues two TMA loads -- the x tile (one box {64 k, 128 m}, 128-byte
// swizzle, as the tiled matmul loads it) and the int8 q tile (one box:
// {BN n, 64 k} of row-major q forward, {64 n, BN k} of q read as W^T for
// dX; no swizzle) -- and its 32 lanes store the slice's fp16 scales, loaded
// with plain loads while the warp waited for its stage, as f32 slots. TMA
// cannot carry the scales: a row of s is N/32 fp16 values (36 bytes at
// N = 576, not a multiple of 16) and a column tile's slice of s starts
// 2 lo/32 bytes in. The loads are guarded at the K and N edges (TMA's zero
// fill covers q there); each lane's arrive on the full barrier publishes
// its stores (33 arrivals a phase: lane 0's expect_tx and one per lane).
// One producer warp for the whole ring put a global load's round trip on
// every slice's critical path (PERF.md): four keep four in flight.
// The consumers dequantize. Each thread takes groups of 8 consecutive
// elements of a q row (8 bytes, one scale), turns each quant into its
// exact float by a byte permute (no conversion unit), forms
// w = float(q) * float(s) once in f32 -- exact: a 7-bit integer times an
// 11-bit significand, the plain version's value -- and splits it into
// hi = bf16(w) and lo = bf16(w - hi), both rounded to nearest even,
// written as two swizzled bf16 B tiles in the layouts the tiled matmul's
// TMA lands: N-major {64 n, 64 k} chunks forward, where q is row-major
// (K, N); K-major BN x 64 rows for dX, where q read as W^T is K-major. Then
// fence.proxy.async, a barrier over the 256 consumer threads, and per k16
// step two SS wgmmas on the same A descriptor: d += x hi, then d += x lo.
// One bf16 rounding of w does not fit chip_smoke.py's unchanged quantized
// tolerance (tests/test_torch_tolerance.py emulates it at 1.06-2.06 of it
// at the four training shapes, the pair at 0.72-0.81), so the pair doubles
// the tensor work against the bound's one product. The B tiles rotate
// through 3 buffers: while slice i's wgmmas run, the consumers dequantize
// slice i + 1 into the next buffer; one wgmma group stays in flight across
// the barrier, and a buffer is rewritten only after the group that read it
// has completed in both warpgroups. The epilogue writes the row-major y
// from registers, masked at the M and N edges, as the tiled matmul's does.
//
// Why consumers that dequantize, in the SS form, and not CUTLASS's Hopper
// mixed-input mainloop (convert the narrow operand in registers and feed it
// as the RS form's A, computing y^T = W^T x^T): the SS form keeps x as the A
// operand in its native layout, the output row-major and the tiled
// matmul's descriptors and epilogue unchanged, and one dequant per slice
// serves both consumer warpgroups. Probes on the card (PERF.md) found a
// dedicated dequant warpgroup (one or two) no faster, nor a split by
// truncation instead of the conversion unit's rounding, while removing the
// dequant's work cut the time markedly: the evidence points at shared
// memory, which the pair's B tiles cross three times (written by the
// dequant, read by each warpgroup's wgmma) beside the tensor cores' own
// operand reads. The mixed-input form keeps hi and lo in registers and is
// the next design. Descriptors are encoded on the host per call
// (cudaGetDriverEntryPoint, no -lcuda) and passed as __grid_constant__
// parameters. Left for later besides: persistent scheduling, cached
// descriptors.
//
// Registers and spills (nvcc -Xptxas -v, CUDA 12.8, sm_90a): wgmma kernel
// 128 registers at BN = 128 and 80 at BN = 64 (both orientations), 197 KB
// and 131 KB of dynamic shared memory, 0 bytes of spills and stack; simt
// kernel 63-64 registers, 8320 bytes of static shared memory, no spills.
//
// C interface (ctypes): pointers and the stream are void*, x's strides and
// q's and s's row strides are in elements (q and s have unit column
// stride), y is row-major contiguous. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for what an entry cannot take).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int QBLOCK = 32;

}  // namespace

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

// y (M, Nout) = x (M, Kc) @ W (Kc, Nout), W from the q8 operands:
//   TRANS false: W[k][n] = q[k*ldq + n] * s[k*lds + n/32]  (Kc = K, Nout = N)
//   TRANS true:  W[n][k] = q[k*ldq + n] * s[k*lds + n/32]  (Kc = N, Nout = K)
// One thread block per BM x BN output tile; a loop over the contraction in
// BKK slices stages the x tile (converted to f32) and the weight tile,
// dequantized to f32 by the plain version's single product, in shared
// memory; each of the 256 threads accumulates a TM x TN patch in registers.
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

}  // namespace simt


namespace wg {

using namespace sm90;

constexpr int BM = 128;                // rows of y per block: two m64 consumers
constexpr int BK = 64;                 // contraction per stage: 128 bytes of bf16
constexpr int STAGES = 4;              // ring depth (x, q and scales)
constexpr int BUFS = 3;                // bf16 hi + lo B tile buffers
constexpr int CONSUMERS = 256;         // two consumer warpgroups
constexpr int PRODUCERS = STAGES;      // producer warps, one per ring stage
constexpr int THREADS = CONSUMERS + 32 * PRODUCERS;
constexpr int A_BYTES = BM * BK * 2;   // 16 KB x tile per stage
constexpr int CHUNK = 64 * 64 * 2;     // one {64, 64} bf16 box: 8 KB
constexpr int SYNC_ID = 1;             // the consumers' named barrier

template <int BN> constexpr int B_BYTES = BK * BN * 2;      // one bf16 B tile
template <int BN> constexpr int Q_BYTES = BK * BN;          // the int8 tile
template <int BN> constexpr int SCALES = BK * BN / QBLOCK;  // f32 scale slots a stage
template <int BN> constexpr int SCALES_PER_LANE = SCALES<BN> / 32;
template <int BN> constexpr int GROUPS_PER_THREAD = BK * BN / 8 / CONSUMERS;
template <int BN>  // + slack to align the swizzled tiles to 1024 bytes
constexpr int SMEM_BYTES = STAGES * (A_BYTES + Q_BYTES<BN> + 4 * SCALES<BN>) +
                           BUFS * 2 * B_BYTES<BN> + 2 * STAGES * 8 + 1024;

template <int BN, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_n128<0, TB>(d, da, db, 1);
  else wgmma_n64<0, TB>(d, da, db, 1);
}

// The scale slots of one stage: rows x cols f32, row-major. Forward: the
// stage's 64 k rows x BN/32 blocks of q's row; dX: BN q rows x 2 blocks.
template <int BN, bool TRANS> constexpr int SCALE_COLS = TRANS ? BK / QBLOCK : BN / QBLOCK;

// Lane `lane`'s share of stage `kt`'s scales, 0 past the K and N edges.
template <int BN, bool TRANS>
__device__ __forceinline__ void load_scales(float (&v)[SCALES_PER_LANE<BN>],
                                            const __half* __restrict__ s, int64_t lds,
                                            int lane, int kt, int n0, int Nout, int Kc) {
  constexpr int C = SCALE_COLS<BN, TRANS>;
  const int k0 = kt * BK;
  const int rbase = TRANS ? n0 : k0, cbase = (TRANS ? k0 : n0) / QBLOCK;
  const int rlim = TRANS ? Nout : Kc, clim = TRANS ? Kc : Nout;
#pragma unroll
  for (int t = 0; t < SCALES_PER_LANE<BN>; ++t) {
    const int e = lane + 32 * t;
    const int gr = rbase + e / C, gc = cbase + e % C;
    v[t] = (gr < rlim && gc * QBLOCK < clim)
               ? __half2float(s[static_cast<int64_t>(gr) * lds + gc])
               : 0.f;
  }
}

// Eight int8 quants (two little-endian words) times their scale, as the
// bf16 hi and lo halves of the pair, packed two to a register. A quant
// becomes its exact float without the conversion unit (a quarter of the
// ALU's rate): offset by 128 into an unsigned byte, placed by a byte
// permute as the low mantissa bits of 2^23, and 2^23 + 128 subtracted.
__device__ __forceinline__ float quant_f32(uint32_t biased, int byte) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + byte)) - 8388736.f;
}

__device__ __forceinline__ void dequant8(uint2 raw, float sc, uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t biased = (p < 2 ? raw.x : raw.y) ^ 0x80808080u;
    const int b = (p & 1) * 2;  // the pair's first byte in its word
    const float w0 = quant_f32(biased, b) * sc;
    const float w1 = quant_f32(biased, b + 1) * sc;
    const __nv_bfloat162 hv = __floats2bfloat162_rn(w0, w1);
    const __nv_bfloat162 lv = __floats2bfloat162_rn(w0 - __low2float(hv), w1 - __high2float(hv));
    h[p] = *reinterpret_cast<const uint32_t*>(&hv);
    l[p] = *reinterpret_cast<const uint32_t*>(&lv);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// Consumer thread `ct` (0-255) turns its groups of the stage's int8 tile
// `sq` and scales `ss` into the swizzled bf16 tiles `bh` (hi) and `bl` (lo).
template <int BN, bool TRANS>
__device__ __forceinline__ void dequant_stage(const uint8_t* sq, const float* ss, uint8_t* bh,
                                              uint8_t* bl, int ct) {
  constexpr int C = SCALE_COLS<BN, TRANS>;
#pragma unroll
  for (int t = 0; t < GROUPS_PER_THREAD<BN>; ++t) {
    const int e = ct + CONSUMERS * t;
    int src, dst, sc;
    if (TRANS) {  // q tile: BN rows (outputs) x 64 bytes (contraction)
      const int r = e / 8, c8 = e % 8;
      src = r * BK + c8 * 8;
      sc = r * C + c8 / 4;
      dst = r * 128 + ((c8 ^ (r & 7)) << 4);  // K-major: a 128-byte row per output
    } else {      // q tile: 64 rows (contraction) x BN bytes (outputs)
      const int k = e / (BN / 8), n8 = e % (BN / 8);
      src = k * BN + n8 * 8;
      sc = k * C + n8 / 4;
      // N-major: {64 n, 64 k} chunks, a 128-byte row per k
      dst = (n8 / 8) * CHUNK + k * 128 + (((n8 % 8) ^ (k & 7)) << 4);
    }
    uint4 hi, lo;
    dequant8(*reinterpret_cast<const uint2*>(sq + src), ss[sc], hi, lo);
    *reinterpret_cast<uint4*>(bh + dst) = hi;
    *reinterpret_cast<uint4*>(bl + dst) = lo;
  }
}

template <int BN, bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_x, const __grid_constant__ CUtensorMap tma_q,
                 const __half* __restrict__ s, int64_t lds, __nv_bfloat16* __restrict__ y,
                 int M, int Nout, int Kc) {
  constexpr int TB = TRANS ? 0 : 1;  // B K-major for dX, N-major forward
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles start on 1024-byte boundaries; every region's
  // size is a multiple of 1024 up to the scales
  uint8_t* sa = align1024(smem_raw);
  uint8_t* sb = sa + STAGES * A_BYTES;
  uint8_t* sq = sb + BUFS * 2 * B_BYTES<BN>;
  float* ss = reinterpret_cast<float*>(sq + STAGES * Q_BYTES<BN>);
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + STAGES * SCALES<BN>);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (Kc + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1 + 32);  // lane 0's expect_tx, then each lane's scales
      mbar_init(&empty[i], 8);      // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warp `st` fills ring stage st: slices st, st + STAGES, ...;
    // each slice's scales are loaded while the warp waits for its stage
    const int st = (threadIdx.x - CONSUMERS) / 32, lane = threadIdx.x % 32;
    float* slot = ss + st * SCALES<BN>;
    float sv[SCALES_PER_LANE<BN>];
    if (st < nk) load_scales<BN, TRANS>(sv, s, lds, lane, st, n0, Nout, Kc);
    for (int i = st; i < nk; i += STAGES) {
      if (i >= STAGES) mbar_wait(&empty[st], ((i / STAGES) - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[st], A_BYTES + Q_BYTES<BN>);
        const int k = i * BK;
        tma_load_2d(sa + st * A_BYTES, &tma_x, &full[st], k, m0);
        if (TRANS) tma_load_2d(sq + st * Q_BYTES<BN>, &tma_q, &full[st], k, n0);
        else tma_load_2d(sq + st * Q_BYTES<BN>, &tma_q, &full[st], n0, k);
      }
#pragma unroll
      for (int t = 0; t < SCALES_PER_LANE<BN>; ++t) slot[lane + 32 * t] = sv[t];
      mbar_arrive(&full[st]);  // release: the stores above are seen by the waiters
      if (i + STAGES < nk) load_scales<BN, TRANS>(sv, s, lds, lane, i + STAGES, n0, Nout, Kc);
    }
    return;
  }

  // consumers: warpgroup g owns rows [64 g, 64 g + 64) of the tile, which
  // start CHUNK bytes into the x stage
  const int ct = threadIdx.x;
  const int g = ct / 128;
  auto hi_tile = [&](int buf) { return sb + buf * 2 * B_BYTES<BN>; };
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  fence_regs(d);

  mbar_wait(&full[0], 0);
  dequant_stage<BN, TRANS>(sq, ss, hi_tile(0), hi_tile(0) + B_BYTES<BN>, ct);
  fence_proxy_async();
  named_barrier(SYNC_ID, CONSUMERS);

  for (int i = 0; i < nk; ++i) {
    const int st = i % STAGES;
    const uint8_t* a = sa + st * A_BYTES + g * CHUNK;
    const uint8_t* bh = hi_tile(i % BUFS);
    const uint8_t* bl = bh + B_BYTES<BN>;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = gmma_desc(a + kk * 32, 16, 1024);
      const uint64_t dh = TRANS ? gmma_desc(bh + kk * 32, 16, 1024)
                                : gmma_desc(bh + kk * 2048, CHUNK, 1024);
      const uint64_t dl = TRANS ? gmma_desc(bl + kk * 32, 16, 1024)
                                : gmma_desc(bl + kk * 2048, CHUNK, 1024);
      mma<BN, TB>(d, da, dh);
      mma<BN, TB>(d, da, dl);
    }
    wgmma_commit();
    // while this slice's products run, dequantize the next slice into the
    // next buffer, last read by slice i - 2 (completed before the barrier
    // that ended iteration i - 1)
    if (i + 1 < nk) {
      const int nst = (i + 1) % STAGES;
      mbar_wait(&full[nst], ((i + 1) / STAGES) & 1);
      uint8_t* nb = hi_tile((i + 1) % BUFS);
      dequant_stage<BN, TRANS>(sq + nst * Q_BYTES<BN>, ss + nst * SCALES<BN>, nb,
                               nb + B_BYTES<BN>, ct);
      fence_proxy_async();
    }
    // keep this slice's group in flight; the previous slice's is done, so
    // its stage goes back to its producer
    wgmma_wait<1>();
    if (i > 0 && ct % 32 == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    named_barrier(SYNC_ID, CONSUMERS);
  }
  wgmma_wait<0>();
  fence_regs(d);

  // epilogue: d[4i + 2j + c] is row 16 warp + lane/4 + 8j, column
  // 8i + 2 (lane % 4) + c of this warpgroup's 64 x BN block
  const int warp = (ct % 128) / 32, lane = ct % 32;
  const int rbase = m0 + g * 64 + warp * 16 + lane / 4;
  const bool pairs = (Nout % 2) == 0;  // a column pair is then aligned and in or out together
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int c = n0 + 8 * i + 2 * (lane % 4);
    if (c >= Nout) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = rbase + 8 * j;
      if (r >= M) continue;
      const float v0 = d[4 * i + 2 * j], v1 = d[4 * i + 2 * j + 1];
      __nv_bfloat16* o = y + static_cast<int64_t>(r) * Nout + c;
      if (pairs) *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      else { o[0] = __float2bfloat16(v0); if (c + 1 < Nout) o[1] = __float2bfloat16(v1); }
    }
  }
}

// A (rows, cols) operand of `type` whose cols run along the unit stride and
// whose rows lie `ld_bytes` apart, cut into boxes of {box0 cols, box1 rows}.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, int64_t cols,
            int64_t rows, int64_t ld_bytes, uint32_t box0, uint32_t box1,
            CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld_bytes)};
  const cuuint32_t box[2] = {box0, box1};
  return sm90::encode(map, type, 2, base, dims, strides, box, swizzle);
}

template <int BN, bool TRANS>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mq, const __half* s, int64_t lds,
                   __nv_bfloat16* y, int M, int Nout, int Kc, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(qmm_wgmma_kernel<BN, TRANS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES<BN>);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_wgmma_kernel<BN, TRANS><<<grid, THREADS, (SMEM_BYTES<BN>), st>>>(mx, mq, s, lds, y, M,
                                                                       Nout, Kc);
  return cudaGetLastError();
}

}  // namespace wg

// The simt route. y (M, Nout) = x (M, Kc) @ W. Forward (trans 0): q, s are
// (Kc, Nout), (Kc, Nout/32). dX (trans 1): q, s are (Nout, Kc), (Nout, Kc/32).
// dtype: 0 = float32, 1 = bfloat16 (x and y).
extern "C" int quantized_matmul(const void* x, const void* q, const void* s,
                                void* y, int M, int Nout, int Kc, int64_t sxm,
                                int64_t sxk, int64_t ldq, int64_t lds,
                                int trans, int dtype, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const int n_blocked = trans ? Kc : Nout;  // q's columns, along the blocks
  if (M <= 0 || Nout <= 0 || Kc <= 0 || n_blocked % QBLOCK != 0 ||
      (M + simt::BM - 1) / simt::BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    simt::launch<float>(x, q, s, y, M, Nout, Kc, sxm, sxk, ldq, lds, trans, st);
  else if (dtype == 1)
    simt::launch<__nv_bfloat16>(x, q, s, y, M, Nout, Kc, sxm, sxk, ldq, lds, trans, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The wgmma route, bf16 x only, read K-major with rows x_ld elements apart;
// q's rows lie ldq bytes apart (a multiple of 16), s's lds elements apart.
// Shapes as the simt entry's; bn is 128 or 64.
extern "C" int quantized_matmul_wgmma(const void* x, const void* q, const void* s, void* y,
                                      int M, int Nout, int Kc, int64_t x_ld, int64_t ldq,
                                      int64_t lds, int trans, int bn, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  const int n_blocked = trans ? Kc : Nout;
  if (M <= 0 || Nout <= 0 || Kc <= 0 || n_blocked % QBLOCK != 0 ||
      (M + wg::BM - 1) / wg::BM > 65535 || (bn != 128 && bn != 64) || ldq % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = sm90::bind_context();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mx, mq;
  // q's (rows, cols): (Kc, Nout) forward, (Nout, Kc) for dX; its box covers
  // one stage's 64 contraction elements by bn outputs
  const int64_t q_cols = trans ? Kc : Nout, q_rows = trans ? Nout : Kc;
  const bool ok =
      wg::encode(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, Kc, M, x_ld * 2, wg::BK, wg::BM,
                 CU_TENSOR_MAP_SWIZZLE_128B) &&
      wg::encode(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, q_cols, q_rows, ldq,
                 trans ? wg::BK : bn, trans ? bn : wg::BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __half* sp = static_cast<const __half*>(s);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  if (bn == 128)
    e = trans ? wg::launch<128, true>(mx, mq, sp, lds, yb, M, Nout, Kc, st)
              : wg::launch<128, false>(mx, mq, sp, lds, yb, M, Nout, Kc, st);
  else
    e = trans ? wg::launch<64, true>(mx, mq, sp, lds, yb, M, Nout, Kc, st)
              : wg::launch<64, false>(mx, mq, sp, lds, yb, M, Nout, Kc, st);
  return (int)e;
}

extern "C" const char* error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
