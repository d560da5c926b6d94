// Causal GQA flash attention for Hopper (sm_90a): the forward, and the
// backward that the TPU kernel does not have, with an optional local window.
//
// Forward. Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel). Same function: online softmax with
// m, l and the accumulator in f32, scale D^-0.5, query head h reads KV head
// h / (H / KV), keys past Sk and (when causal) keys j > i + (Sk - Sq) score
// -1e30, and p is rounded to the input type before the P@V product. When
// asked, it also writes each row's f32 log-sum-exp m + log(l), which the
// backward reads instead of recomputing the softmax's normalizer.
//
// Window (window > 0; 0 is global): query i sees key j only if
// j > i + (Sk - Sq) - window, causal or not -- recurrentgemma's local
// attention (repro/models/common.py:164-167, end-aligned). Every kernel
// walks only the tiles a block's rows' windows reach: the K/V tiles from
// the first key past its first row's window (kv_range, a [first, last)
// range with the causal frontier), and in dK/dV the query tiles below the
// last row whose window reaches its last key. So work scales with the
// window, not with Sk. A tile partly inside is masked per element, next
// to the causal test (TMA's zero fill is no mask). A row's leading tiles
// may lie wholly outside its window: their scores are all -1e30, the
// online softmax takes p = 1 there, and the first tile with a visible key
// rescales that away (alpha = exp(-1e30 - m) = 0), as in the reference's
// chunked scan. The heavy-first launch order stays; under a window the
// work is flat past the first `window` rows, so it is correct, not optimal.
//
// Backward (no TPU counterpart: the reference differentiates its jnp
// chunked attention), as kernels/ref.py:attention_bwd_ref states it, split
// into kernels with no atomics, so the GQA sums come in a fixed order and a
// run repeats to the bit: delta_i = sum_d dO_id O_id; dK/dV per key tile,
// looping over the group's H/KV query heads and the query tiles at or past
// the causal frontier; dQ per query tile.
//
// Two routes, chosen per call by kernels/flash_attention.py:route():
//   wgmma -- bf16, D in {64, 128, 192, 256}, every operand one TMA can
//            describe (unit last stride, the others multiples of 8
//            elements, base aligned to 16 bytes): tensor cores fed by TMA
//            under mbarriers. Every bf16 attention call of the serving and
//            training paths takes it.
//   simt  -- everything else: f32 (wgmma's only f32 input is TF32, which
//            would break the f32 tolerance), D = 32, views TMA cannot
//            describe; at any D on request (the timed baseline). The
//            first design's CUDA-core f32 FMAs: LANES
//            threads per query (or key) row, 32 rows a block, K/V (or q/dO)
//            tiles staged as f32 in static shared memory -- 4 lanes and
//            32-row tiles up to D = 128, as it was; above it 8 lanes and
//            16-row tiles, so a tile pair stays within the 48 KB of static
//            shared memory (32 KB at D = 256) and a dK/dV thread's four
//            row arrays within its registers (D / 8 values each).
//
// Bound on this card (989 TFLOP/s bf16, 3.35 TB/s; each input read once,
// each output written once). At the training shape (B 8, H 9, KV 3,
// Sq = Sk = 512, D 64, causal; 9,455,616 causal (query, key) pairs) the
// forward does 4 D flops per pair, 2.42 GFLOP, against 12.6 MB: 3.76 us by
// bytes (2.45 us by operations). The backward reads q, k, v, o, dO, lse
// and writes dq, dk, dv, 20.6 MB, for 10 D flops per pair, 6.05 GFLOP:
// 6.15 us by bytes (6.12 us by operations). The forward sits below the
// card's ~295 flop/byte ridge and the backward on it, so bytes bound both;
// the CUDA-core route is bound by its operations instead (67 TFLOP/s f32:
// 36 and 90 us at best), which is what the tensor cores remove.
//
// wgmma design. Every product is one of two wgmma forms (csrc/sm90.cuh):
// SS, both operands K-major in shared memory, for S = Q K^T and dP = dO V^T
// (and, with keys as rows, S^T = K Q^T and dP^T = V dO^T); RS, A in
// registers -- the previous product's f32 accumulator packed pairwise into
// bf16, which is exactly its A fragment -- and B N-major in shared memory,
// for O += P V, dQ += dS K, dV += P^T dO and dK += dS^T Q. A (rows x D)
// tile lands from one 4-D TMA map per tensor ({D, S, H, B}, the model's
// (B,S,H,D) storage read through its (B,H,S,D) view, no copy) as D/64
// chunks of rows x 128 bytes under the 128-byte swizzle, so the same tile
// serves as a K-major operand (contracting over D) and as an N-major B
// (contracting over its rows). TMA zero-fills rows past S, which is not a
// mask here (a zero key scores 0, a zero query row with lse 0 gives p = 1),
// so every kernel masks keys past Sk and query rows past Sq itself.
//   forward (fwd_kernel): one block per (128 query rows, head, batch), the
//     last query tiles launched first (under causal they see the most keys:
//     no tail of heavy blocks). Two consumer warpgroups own 64 rows each;
//     one producer thread loads the Q tile once, then K/V tiles of 64 keys
//     through a 2-stage ring under full/empty mbarriers, up to the causal
//     frontier of the block's last row (a warpgroup skips the tiles past
//     its own). Per tile: S (SS), mask, the online softmax on the
//     accumulator registers (a row's max and sum reduce over the 4 threads
//     that hold it; l sums f32 p), P rounded to bf16 in registers, O += P V
//     (RS). The epilogue writes O in q's strides and the lse.
//   dQ (dq_kernel): the forward's grid and ring; Q and dO tiles load once;
//     per K/V tile S and dP (SS), dS = P (dP - delta) in registers, then
//     dQ += dS K as two RS products on dS's bf16 hi + lo pair.
//   dK/dV (dkdv_kernel): one block per (64 keys, KV head, batch), one
//     consumer warpgroup (the keys are the rows of every product), key tile
//     0 first. 128-key blocks would give 4 x 3 x 8 = 96 blocks at the
//     training shape, fewer than the 132 SMs; 64-key blocks give 192. K and
//     V load once; the ring carries the q tile, the dO tile (64 rows each)
//     and their 64 lse and delta values (1-D TMA maps; a box starts on 16
//     bytes, so 68 values from the boundary at or before them) for each
//     query head of the group and each query tile at or past the causal
//     frontier. Per stage: S^T and dP^T (SS), P^T = exp(S^T scale - lse)
//     and dS^T with lse and delta read per column from shared memory,
//     dV += bf16(P^T) dO and dK += dS^T Q on dS's hi + lo pair (RS).
//   delta stays the CUDA-core row reduction on both routes.
// Above D = 128 (gemma-7b's and recurrentgemma-9b's 256, nemotron's 192)
// the same products would not fit a thread's registers or a block's shared
// memory as they stand, so three things change, and only there:
//   forward: the same grid and tiles (Q 64 KB + a 2 x 64 KB K/V ring at
//     D = 256), but a 64 x D f32 accumulator (128 registers at D = 256)
//     does not fit the 168 registers that 288 threads leave a thread (9
//     warps put 3 on one of the SM's four schedulers): it spilled and
//     serialized its wgmmas. The producer becomes a whole warpgroup that
//     drops to 40 registers with setmaxnreg and each consumer rises to 232
//     (FlashAttention-3's recipe, arXiv:2407.08608); O += P V runs as n128
//     pieces and an n64 piece over the 64-column chunks (piece p on
//     accumulator registers 64 p on: one m64nD product's layout).
//   dQ: 128 query rows would need Q + dO + the ring = 256 KB at D = 256,
//     so a block holds 64 rows and one consumer warpgroup (160 threads,
//     up to 255 registers; 192 KB).
//   dK/dV: dK and dV at D = 256 would take 256 accumulator registers a
//     thread. Each block accumulates one slab of D instead -- 128 columns
//     at D = 256, 64 at D = 192, so slabs start on the swizzled tiles'
//     64-column chunks -- from full-width K, V, q and dO tiles: S^T and
//     dP^T over all of D, dV += P^T dO and dK += dS^T Q on its slab (the
//     N-major descriptor starts at the slab's chunk). Accumulators stay at
//     64 + 64 registers, S^T and dP^T are formed once per slab (4 D of
//     about 12 D flops a pair again), and the grid grows by the slabs: 128
//     blocks at recurrentgemma's MQA shape (64 key tiles on one KV head)
//     where 64 would leave half of the 132 SMs idle.
// dS goes to the tensor cores as hi = bf16(dS) and lo = bf16(dS - hi), two
// RS products where one would do, because dS rounded once to bf16 does not
// fit chip_smoke.py's unchanged backward tolerance: emulated on the CPU
// (tests/test_torch_tolerance.py) it takes an element of dK past it at two
// batches of the training cell's heads, where the pair stays under 0.6 of
// it. The CUDA-core kernels multiply dS in f32. P for dV is rounded to
// bf16, as in P@V.
// Descriptors are encoded on the host per call through
// cudaGetDriverEntryPoint (no -lcuda) and passed as __grid_constant__
// parameters. Left for later: a second consumer stage overlapping softmax
// with the next tile's products, persistent scheduling, cached descriptors,
// TMA stores of the outputs, softcap.
//
// Registers and spills (nvcc -Xptxas -v, CUDA 12.8, sm_90a), each wgmma
// kernel without / with the window (built apart, so a global call pays
// nothing for it): forward 96 / 96 at D = 64 (two blocks per SM: 8 / 68
// bytes of spill, and ptxas serializes its wgmmas for want of registers --
// still faster at the training shape than one block per SM without either,
// slower at the serve shape; PERF.md), 151 / 167 at D = 128; dQ 137 / 139
// and 162 / 159; dK/dV 199 / 188 and 255 / 250; none of these spill.
// Above D = 128, dynamic shared memory per block and registers:
//   kernel          D = 192                 D = 256
//   forward         145 KB, 168 at launch,  193 KB, 168 at launch,
//                   232 after setmaxnreg    232 after setmaxnreg
//   dQ (64 rows)    145 KB, 194 / 191       193 KB, 224 / 222
//   dK/dV (slab)    147 KB, 198 / 186       195 KB, 255 / 252
// with no spill and no serialized wgmma; before setmaxnreg the D = 256
// forward spilled 264 bytes at 168 registers and serialized its wgmmas
// (D = 192: 16 bytes). The
// simt kernels up to D = 128 are as they were: forward up to 128
// registers, dQ up to 166, dK/dV up to 216, delta 27-32, no spills; at
// D = 192 / 256 (f32 and bf16): forward 111-116 / 128, dQ 128 / 164-166,
// dK/dV 167 / 215-216, delta 31-32, 24-33 KB of static shared memory,
// 0 bytes of spills.
//
// C interface (ctypes): pointers and the stream are void*, strides are in
// elements and the last dim is contiguous; lse and delta are contiguous
// (B, H, Sq) f32. The wgmma entries take the same arguments as the simt
// ones. Each entry returns cudaGetLastError() (or cudaErrorInvalidValue for
// what it cannot take).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace simt {

constexpr int ROWS = 32;  // query (forward, delta, dQ) or key (dK/dV) rows per block
// Threads per row and rows per staged tile, by head_dim. Each thread holds
// D / LANES values of each row array in registers, and a step stages TILE
// K/V (or q/dO) rows as f32 in static shared memory (48 KB at most): above
// D = 128, eight threads a row and 16-row tiles keep both in bounds.
template <int D> constexpr int LANES_OF = D > 128 ? 8 : 4;
template <int D> constexpr int TILE_OF = D > 128 ? 16 : 32;
template <int D> constexpr int THREADS_OF = ROWS * LANES_OF<D>;
constexpr float NEG_INF = -1e30f;

// The sum over the L neighbouring threads that hold one row.
template <int L> __device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  if (L > 4) x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  int64_t b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS_OF<D>)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_rep, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 int window, float scale) {
  constexpr int LANES = LANES_OF<D>, THREADS = THREADS_OF<D>;
  constexpr int BQ = ROWS, BK = TILE_OF<D>;  // query rows a block, keys a tile
  constexpr int DP = D / LANES;
  __shared__ float k_tile[BK][D];
  __shared__ float v_tile[BK][D];

  const int q_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / n_rep;
  const int row = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int qi = q_tile * BQ + row;
  const bool row_valid = qi < Sq;
  const int q_offset = Sk - Sq;

  const T* qp = q + b * qs.b + h * qs.h + (int64_t)qi * qs.s;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;

  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row_valid ? to_f(qp[lane + LANES * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q_tile * BQ + BQ, Sq) - 1;
    const int last_key = last_row + q_offset;  // >= 0: the wrapper needs Sq <= Sk
    n_tiles = min(n_tiles, last_key / BK + 1);
  }
  // under a window, from the first key past the first row's window
  const int t_first = window > 0 ? max(0, q_tile * BQ + q_offset - window + 1) / BK : 0;

  for (int t = t_first; t < n_tiles; ++t) {
    __syncthreads();  // the previous tile has been read
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const int j = idx / D;
      const int d = idx % D;
      const int kj = t * BK + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        kv = to_f(kp[(int64_t)kj * ks.s + d]);
        vv = to_f(vp[(int64_t)kj * vs.s + d]);
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    __syncthreads();

    float s[BK];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part += qr[i] * k_tile[j][lane + LANES * i];
      part = row_sum<LANES>(part);
      const int kj = t * BK + j;
      const bool valid = kj < Sk && (!causal || kj <= qi + q_offset) &&
                         (window <= 0 || kj > qi + q_offset - window);
      const float sc = valid ? part * scale : NEG_INF;
      s[j] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      s[j] = to_f(from_f<T>(p));  // p in the input type for P@V
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] += s[j] * v_tile[j][lane + LANES * i];
    }
    m = m_new;
  }

  if (row_valid) {
    T* op = o + b * os.b + h * os.h + (int64_t)qi * os.s;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DP; ++i) op[lane + LANES * i] = from_f<T>(acc[i] * inv);
    if (lse != nullptr && lane == 0)
      lse[((int64_t)b * gridDim.y + h) * Sq + qi] = m + logf(l);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS_OF<D>)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                       float* __restrict__ delta, int Sq, Strides os,
                       Strides dos) {
  constexpr int LANES = LANES_OF<D>, BQ = ROWS;
  constexpr int DP = D / LANES;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int qi = blockIdx.x * BQ + row;
  float part = 0.f;
  if (qi < Sq) {
    const T* op = o + b * os.b + h * os.h + (int64_t)qi * os.s;
    const T* dp = dO + b * dos.b + h * dos.h + (int64_t)qi * dos.s;
#pragma unroll
    for (int i = 0; i < DP; ++i)
      part += to_f(op[lane + LANES * i]) * to_f(dp[lane + LANES * i]);
  }
  part = row_sum<LANES>(part);
  if (qi < Sq && lane == 0) delta[((int64_t)b * gridDim.y + h) * Sq + qi] = part;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS_OF<D>)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int n_rep, int Sq, int Sk,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dks, Strides dvs, int causal, int window,
                      float scale) {
  constexpr int LANES = LANES_OF<D>, THREADS = THREADS_OF<D>;
  constexpr int BK = ROWS, BQ = TILE_OF<D>;  // key rows a block, queries a tile
  constexpr int DP = D / LANES;
  __shared__ float q_tile[BQ][D];
  __shared__ float do_tile[BQ][D];
  __shared__ float lse_tile[BQ];
  __shared__ float delta_tile[BQ];

  const int k_tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int row = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int kj = k_tile * BK + row;
  const bool key_valid = kj < Sk;
  const int q_offset = Sk - Sq;

  float kr[DP], vr[DP], dk_acc[DP], dv_acc[DP];
  {
    const T* kp = k + b * ks.b + kvh * ks.h + (int64_t)kj * ks.s;
    const T* vp = v + b * vs.b + kvh * vs.h + (int64_t)kj * vs.s;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      kr[i] = key_valid ? to_f(kp[lane + LANES * i]) : 0.f;
      vr[i] = key_valid ? to_f(vp[lane + LANES * i]) : 0.f;
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
  }

  // the first query row that sees this tile's first key: i >= j0 - (Sk - Sq)
  int t0 = 0;
  if (causal) {
    const int first_q = k_tile * BK - q_offset;
    t0 = first_q > 0 ? first_q / BQ : 0;
  }
  int n_qt = (Sq + BQ - 1) / BQ;
  if (window > 0) {  // the rows below last key - (Sk - Sq) + window see it
    const int end = min(Sq, max(0, min(k_tile * BK + BK, Sk) - 1 - q_offset + window));
    n_qt = min(n_qt, (end + BQ - 1) / BQ);
  }

  for (int hh = 0; hh < n_rep; ++hh) {
    const int h = kvh * n_rep + hh;
    const T* qh = q + b * qs.b + h * qs.h;
    const T* doh = dO + b * dos.b + h * dos.h;
    const float* lseh = lse + ((int64_t)b * H + h) * Sq;
    const float* deltah = delta + ((int64_t)b * H + h) * Sq;
    for (int t = t0; t < n_qt; ++t) {
      __syncthreads();  // the previous tile has been read
      for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
        const int r = idx / D;
        const int d = idx % D;
        const int qi = t * BQ + r;
        float qv = 0.f, dov = 0.f;
        if (qi < Sq) {
          qv = to_f(qh[(int64_t)qi * qs.s + d]);
          dov = to_f(doh[(int64_t)qi * dos.s + d]);
        }
        q_tile[r][d] = qv;
        do_tile[r][d] = dov;
      }
      if (threadIdx.x < BQ) {
        const int qi = t * BQ + threadIdx.x;
        lse_tile[threadIdx.x] = qi < Sq ? lseh[qi] : 0.f;
        delta_tile[threadIdx.x] = qi < Sq ? deltah[qi] : 0.f;
      }
      __syncthreads();

      const int rows = min(BQ, Sq - t * BQ);
      for (int r = 0; r < rows; ++r) {
        const int qi = t * BQ + r;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          s += q_tile[r][lane + LANES * i] * kr[i];
          dp += do_tile[r][lane + LANES * i] * vr[i];
        }
        s = row_sum<LANES>(s);
        dp = row_sum<LANES>(dp);
        const bool valid = key_valid && (!causal || kj <= qi + q_offset) &&
                           (window <= 0 || kj > qi + q_offset - window);
        const float p = valid ? expf(s * scale - lse_tile[r]) : 0.f;
        const float ds = p * (dp - delta_tile[r]);
        const float pr = to_f(from_f<T>(p));  // p in the input type, as in P@V
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          dv_acc[i] += pr * do_tile[r][lane + LANES * i];
          dk_acc[i] += ds * q_tile[r][lane + LANES * i];
        }
      }
    }
  }

  if (key_valid) {
    T* dkp = dk + b * dks.b + kvh * dks.h + (int64_t)kj * dks.s;
    T* dvp = dv + b * dvs.b + kvh * dvs.h + (int64_t)kj * dvs.s;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      dkp[lane + LANES * i] = from_f<T>(dk_acc[i] * scale);
      dvp[lane + LANES * i] = from_f<T>(dv_acc[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS_OF<D>)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n_rep, int Sq, int Sk, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dqs, int causal,
                    int window, float scale) {
  constexpr int LANES = LANES_OF<D>, THREADS = THREADS_OF<D>;
  constexpr int BQ = ROWS, BK = TILE_OF<D>;  // query rows a block, keys a tile
  constexpr int DP = D / LANES;
  __shared__ float k_tile[BK][D];
  __shared__ float v_tile[BK][D];

  const int q_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / n_rep;
  const int row = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const int qi = q_tile * BQ + row;
  const bool row_valid = qi < Sq;
  const int q_offset = Sk - Sq;

  const T* qp = q + b * qs.b + h * qs.h + (int64_t)qi * qs.s;
  const T* dop = dO + b * dos.b + h * dos.h + (int64_t)qi * dos.s;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;
  const int64_t row_idx = ((int64_t)b * gridDim.y + h) * Sq + qi;
  const float lse_i = row_valid ? lse[row_idx] : 0.f;
  const float delta_i = row_valid ? delta[row_idx] : 0.f;

  float qr[DP], dor[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row_valid ? to_f(qp[lane + LANES * i]) : 0.f;
    dor[i] = row_valid ? to_f(dop[lane + LANES * i]) : 0.f;
    acc[i] = 0.f;
  }

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q_tile * BQ + BQ, Sq) - 1;
    n_tiles = min(n_tiles, (last_row + q_offset) / BK + 1);
  }
  const int t_first = window > 0 ? max(0, q_tile * BQ + q_offset - window + 1) / BK : 0;

  for (int t = t_first; t < n_tiles; ++t) {
    __syncthreads();  // the previous tile has been read
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const int j = idx / D;
      const int d = idx % D;
      const int kj = t * BK + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        kv = to_f(kp[(int64_t)kj * ks.s + d]);
        vv = to_f(vp[(int64_t)kj * vs.s + d]);
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s += qr[i] * k_tile[j][lane + LANES * i];
        dp += dor[i] * v_tile[j][lane + LANES * i];
      }
      s = row_sum<LANES>(s);
      dp = row_sum<LANES>(dp);
      const int kj = t * BK + j;
      const bool valid = row_valid && kj < Sk && (!causal || kj <= qi + q_offset) &&
                         (window <= 0 || kj > qi + q_offset - window);
      const float p = valid ? expf(s * scale - lse_i) : 0.f;
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] += ds * k_tile[j][lane + LANES * i];
    }
  }

  if (row_valid) {
    T* dqp = dq + b * dqs.b + h * dqs.h + (int64_t)qi * dqs.s;
#pragma unroll
    for (int i = 0; i < DP; ++i) dqp[lane + LANES * i] = from_f<T>(acc[i] * scale);
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void *o;
  float* lse;
  int B, H, KV, Sq, Sk;
  Strides qs, ks, vs, os;
  int causal, window;
  float scale;
};

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  int B, H, KV, Sq, Sk;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale;
};

template <typename T, int D>
void launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.Sq + ROWS - 1) / ROWS, a.H, a.B);
  flash_fwd_kernel<T, D><<<grid, THREADS_OF<D>, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.H / a.KV,
      a.Sq, a.Sk, a.qs, a.ks, a.vs, a.os, a.causal, a.window, a.scale);
}

template <typename T, int D>
void launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dO = static_cast<const T*>(a.dO);
  dim3 qgrid((a.Sq + ROWS - 1) / ROWS, a.H, a.B);
  flash_bwd_delta_kernel<T, D><<<qgrid, THREADS_OF<D>, 0, stream>>>(
      static_cast<const T*>(a.o), dO, a.delta, a.Sq, a.os, a.dos);
  dim3 kgrid((a.Sk + ROWS - 1) / ROWS, a.KV, a.B);
  flash_bwd_dkdv_kernel<T, D><<<kgrid, THREADS_OF<D>, 0, stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.H, a.H / a.KV, a.Sq, a.Sk, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs,
      a.causal, a.window, a.scale);
  flash_bwd_dq_kernel<T, D><<<qgrid, THREADS_OF<D>, 0, stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dq), a.H / a.KV, a.Sq,
      a.Sk, a.qs, a.ks, a.vs, a.dos, a.dqs, a.causal, a.window, a.scale);
}

// dtype x head_dim dispatch: 0 = float32, 1 = bfloat16; D in {32, 64, 128, 192, 256}
template <typename T, int D> struct Fwd { static void run(const FwdArgs& a, cudaStream_t s) { launch_fwd<T, D>(a, s); } };
template <typename T, int D> struct Bwd { static void run(const BwdArgs& a, cudaStream_t s) { launch_bwd<T, D>(a, s); } };

template <template <typename, int> class L, typename T, typename Args>
int dispatch_d(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 32: L<T, 32>::run(a, s); break;
    case 64: L<T, 64>::run(a, s); break;
    case 128: L<T, 128>::run(a, s); break;
    case 192: L<T, 192>::run(a, s); break;
    case 256: L<T, 256>::run(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <template <typename, int> class L, typename Args>
int dispatch_t(const Args& a, int D, int dtype, cudaStream_t s) {
  if (dtype == 0) return dispatch_d<L, float>(a, D, s);
  if (dtype == 1) return dispatch_d<L, __nv_bfloat16>(a, D, s);
  return (int)cudaErrorInvalidValue;
}

bool bad_dims(int B, int H, int KV, int Sq, int Sk, int causal, int window) {
  return B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
         (causal && Sq > Sk) || window < 0 || B > 65535 || H > 65535;
}

}  // namespace simt

// ---------------------------------------------------------------------------
// The wgmma route: bf16, D in {64, 128, 192, 256}, operands TMA can describe.
// ---------------------------------------------------------------------------

namespace wg {

using namespace sm90;
using simt::BwdArgs;
using simt::FwdArgs;
using simt::NEG_INF;
using simt::Strides;

constexpr int BQ = 128;   // query rows per forward block (and dQ's up to D = 128): two m64 warpgroups
constexpr int BKV = 64;   // keys per K/V tile, and per dK/dV block (one warpgroup)
constexpr int BQB = 64;   // query rows per tile of the dK/dV block's loop
// lse / delta values per dK/dV stage: a TMA box must start on 16 bytes, so
// a tile's BQB values are loaded from the 4-value boundary at or before them
constexpr int ROW_BOX = BQB + 4;
constexpr int STAGES = 2;  // ring depth
constexpr int THREADS = 2 * 128 + 32;     // forward / dQ: two consumer warpgroups + a producer warp
constexpr int THREADS_KV = 128 + 32;      // dK/dV: one consumer warpgroup + a producer warp
// Above D = 128 a dQ block has one consumer warpgroup of 64 query rows (its
// q and dO tiles and the K/V ring would pass 227 KB at 128 rows), and a
// dK/dV block accumulates one slab of D: 128 columns at D = 256, 64 at
// D = 192 (a slab starts on a 64-column chunk of the swizzled tiles), so
// its two accumulators stay at 64 + 64 registers a thread at most.
template <int D> constexpr int DQ_WG = D > 128 ? 1 : 2;
template <int D> constexpr int DQ_ROWS = 64 * DQ_WG<D>;
template <int D> constexpr int DQ_THREADS = 128 * DQ_WG<D> + 32;
template <int D> constexpr int SLAB = D == 256 ? 128 : D == 192 ? 64 : D;
// Above D = 128 the forward's producer is a whole warpgroup, so that
// setmaxnreg can move registers to the consumers: 384 threads cap a thread
// at 168 registers at launch (3 warps on each of the SM's four schedulers),
// the producer drops to PRODUCER_REGS and each consumer rises to
// CONSUMER_REGS (4 x 32 x 40 + 8 x 32 x 232 <= 65,536).
template <int D> constexpr int FWD_THREADS = D > 128 ? 3 * 128 : THREADS;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D> constexpr int tile_bytes(int rows) { return rows * D * 2; }

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The [first, last) K/V tiles that query rows first_row ... last_row see:
// all of them, or under causal those up to the frontier key
// last_row + (Sk - Sq); with a window from the first key past
// first_row + (Sk - Sq) - window.
struct TileRange {
  int first, last;
};
__host__ __device__ inline TileRange kv_range(int first_row, int last_row, int Sq, int Sk,
                                              int causal, int window) {
  const int n = cdiv(Sk, BKV);
  const int frontier = (last_row + Sk - Sq) / BKV + 1;
  const int last = causal && frontier < n ? frontier : n;
  const int first = window > 0 ? max(0, first_row + Sk - Sq - window + 1) / BKV : 0;
  return {first, max(first, last)};
}

// Is key `key` visible to query row `row`: inside Sk, at or before the
// causal frontier, past the window.
__device__ __forceinline__ bool visible(int key, int row, int Sq, int Sk, int causal,
                                        int window) {
  const int diag = row + Sk - Sq;
  return key < Sk && (!causal || key <= diag) && (window <= 0 || key > diag - window);
}

// A (rows x D) bf16 tile lies in shared memory as D/64 chunks of rows x 128
// bytes (TMA boxes {64, rows}, 128-byte swizzle), so one tile serves both
// wgmma orientations:
//   kdesc: K-major operand, contracting over D -- rows r0 ... r0+63 (A) or
//          all rows (B), k16 slice kk of D;
//   ndesc: N-major B, contracting over the rows (N = D) -- k16 slice kk of
//          the rows; 64-wide chunks of D lie rows x 128 bytes apart.
template <int ROWS>
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int r0, int kk) {
  return gmma_desc(tile + (kk >> 2) * (ROWS * 128) + r0 * 128 + (kk & 3) * 32, 16, 1024);
}
template <int ROWS>
__device__ __forceinline__ uint64_t ndesc(const uint8_t* tile, int kk) {
  return gmma_desc(tile + kk * 2048, ROWS * 128, 1024);
}

template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int s0, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_4d(dst + c * ROWS * 128, map, bar, 64 * c, s0, h, b);
}

// s (64 x 64) = A (rows r0 ... r0+63 of an AROWS-row tile) @ B^T (a 64-row
// tile), contracting over D: SS, both K-major.
template <int D, int AROWS>
__device__ __forceinline__ void mma_abt(float (&s)[32], const uint8_t* a, int r0,
                                        const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_n64<0, 0>(s, kdesc<AROWS>(a, r0, kk), kdesc<64>(b, 0, kk), kk > 0);
}

// The N-wide piece of an accumulator from register `off` on (an m64nN
// accumulator's piece over columns 2 off ... 2 off + N - 1).
template <int N, int R>
__device__ __forceinline__ auto piece(float (&acc)[R], int off) -> float (&)[N / 2] {
  return *reinterpret_cast<float(*)[N / 2]>(acc + off);
}

// acc (64 x D) += P (64 x 64, the A fragments pa) @ V (a 64-row tile): RS,
// B N-major, N = D as n128 pieces and, for D % 128, an n64 one: piece p
// on accumulator registers 64 p on and on the 64-column chunks 2 p on
// (the fragment layout of one m64nD product).
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 2], const uint32_t (&pa)[4][4],
                                       const uint8_t* v) {
  constexpr int CHUNK = 64 * 128;  // one 64-column chunk of a 64-row tile
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int p = 0; p < D / 128; ++p)
      wgmma_rs_n128<1>(piece<128>(acc, 64 * p), pa[c], ndesc<64>(v + 2 * p * CHUNK, c), 1);
    if constexpr (D % 128)
      wgmma_rs_n64<1>(piece<64>(acc, 64 * (D / 128)), pa[c],
                      ndesc<64>(v + 2 * (D / 128) * CHUNK, c), 1);
  }
}

template <int R>
__device__ __forceinline__ void pack_all(uint32_t (&a)[4][4], const float (&d)[R]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) pack_a(a[c], d, c);
}

template <int R>
__device__ __forceinline__ void pack_all_hilo(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                              const float (&d)[R]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) pack_a_hilo(hi[c], lo[c], d, c);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Writes one thread's two rows (r, r + 8) of an m64 x D accumulator times
// mul, in bf16, at rows below `rows` of the strided output.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float mul0, float mul1,
                                           __nv_bfloat16* base, int64_t ss, int r, int rows,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (r + 8 * j >= rows) continue;
    const float mul = j ? mul1 : mul0;
    __nv_bfloat16* p = base + (int64_t)(r + 8 * j) * ss + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * j] * mul, acc[4 * i + 2 * j + 1] * mul);
  }
}

template <int D> struct Fwd {
  static constexpr int Q_BYTES = tile_bytes<D>(BQ);
  static constexpr int KV_BYTES = tile_bytes<D>(BKV);
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 2 * STAGES) * 8 + 1024;
};

// Forward. One block per (query tile of BQ rows, head, batch), the last
// query tiles first (under causal they see the most keys).
template <int D, bool WIN>
__global__ void __launch_bounds__(FWD_THREADS<D>, D == 64 ? 2 : 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
           float* __restrict__ lse, int B, int H, int n_rep, int Sq, int Sk, Strides os,
           int causal, int window, float sl2) {
  if constexpr (!WIN) window = 0;  // folds the window's terms away
  using C = Fwd<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sk = sq + C::Q_BYTES;
  uint8_t* sv = sk + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int q_tile = cdiv(Sq, BQ) - 1 - blockIdx.x / (H * B);
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int q0 = q_tile * BQ;
  const TileRange rng = kv_range(q0, min(q0 + BQ, Sq) - 1, Sq, Sk, causal, window);
  const int n_tiles = rng.last - rng.first;  // ring step i carries K/V tile rng.first + i

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; TMA completes the bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp (warpgroup): one thread issues every load
    if constexpr (D > 128) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      load_tile<D, BQ>(sq, &tq, q_full, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, t = rng.first + i;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        load_tile<D, BKV>(sk + s * C::KV_BYTES, &tk, &full[s], t * BKV, h / n_rep, b);
        load_tile<D, BKV>(sv + s * C::KV_BYTES, &tv, &full[s], t * BKV, h / n_rep, b);
      }
    }
    return;
  }

  // consumers: warpgroup g owns query rows q0 + 64 g ... + 63; this thread
  // rows r and r + 8 of them
  if constexpr (D > 128) setmaxnreg_inc<CONSUMER_REGS>();
  const int g = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r = q0 + g * 64 + warp * 16 + lane / 4;
  const TileRange my = q0 + g * 64 < Sq
      ? kv_range(q0 + g * 64, min(q0 + g * 64 + 63, Sq - 1), Sq, Sk, causal, window)
      : TileRange{0, 0};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, t = rng.first + it;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (t >= my.first && t < my.last) {  // warpgroup-uniform
      float sc[32];
      wgmma_fence();
      mma_abt<D, BQ>(sc, sq, g * 64, sk + s * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      // scores in log2 units, masked: keys past Sk, under causal keys
      // past i + (Sk - Sq), under a window keys at or before
      // i + (Sk - Sq) - window; then the online softmax, rows reduced over
      // the quad of threads that holds them
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = t * BKV + 8 * i + 2 * (lane % 4) + c;
            const bool ok = visible(key, r + 8 * j, Sq, Sk, causal, window);
            const float v = ok ? sc[4 * i + 2 * j + c] * sl2 : NEG_INF;
            sc[4 * i + 2 * j + c] = v;
            mx[j] = fmaxf(mx[j], v);
          }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = quad_max(mx[j]);
        alpha[j] = exp2f(m[j] - mx[j]);
        m[j] = mx[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(sc[4 * i + 2 * j + c] - m[j]);
            sc[4 * i + 2 * j + c] = p;
            rs[j] += p;  // the f32 p into l; P@V takes p rounded to bf16
          }
#pragma unroll
      for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[4 * i + 2 * j] *= alpha[j];
          acc[4 * i + 2 * j + 1] *= alpha[j];
        }
      uint32_t pa[4][4];
      pack_all(pa, sc);
      wgmma_fence();
      mma_pv<D>(acc, pa, sv + s * C::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] = quad_sum(l[j]);
    inv[j] = 1.f / fmaxf(l[j], 1e-30f);
  }
  store_rows<D>(acc, inv[0], inv[1], o + b * os.b + h * os.h, os.s, r, Sq, lane);
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (r + 8 * j < Sq)
        lse[((int64_t)b * H + h) * Sq + r + 8 * j] = (m[j] + log2f(l[j])) * LN2;
  }
}

template <int D> struct Dq {
  static constexpr int Q_BYTES = tile_bytes<D>(DQ_ROWS<D>);
  static constexpr int KV_BYTES = tile_bytes<D>(BKV);
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 2 * STAGES) * 8 + 1024;
};

// dQ. The forward's grid (DQ_ROWS query rows a block: BQ up to D = 128, 64
// above); q and dO tiles load once, K/V tiles through the ring.
template <int D, bool WIN>
__global__ void __launch_bounds__(DQ_THREADS<D>, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int B, int H, int n_rep, int Sq, int Sk, Strides dqs,
          int causal, int window, float sl2, float scale) {
  if constexpr (!WIN) window = 0;
  using C = Dq<D>;
  constexpr int NC = DQ_WG<D>, QR = DQ_ROWS<D>;  // consumer warpgroups, query rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + C::Q_BYTES;
  uint8_t* sk = sdo + C::Q_BYTES;
  uint8_t* sv = sk + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int q_tile = cdiv(Sq, QR) - 1 - blockIdx.x / (H * B);
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int q0 = q_tile * QR;
  const TileRange rng = kv_range(q0, min(q0 + QR, Sq) - 1, Sq, Sk, causal, window);
  const int n_tiles = rng.last - rng.first;  // ring step i carries K/V tile rng.first + i

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {
    if (threadIdx.x == 128 * NC) {
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
      load_tile<D, QR>(sq, &tq, q_full, q0, h, b);
      load_tile<D, QR>(sdo, &tdo, q_full, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, t = rng.first + i;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        load_tile<D, BKV>(sk + s * C::KV_BYTES, &tk, &full[s], t * BKV, h / n_rep, b);
        load_tile<D, BKV>(sv + s * C::KV_BYTES, &tv, &full[s], t * BKV, h / n_rep, b);
      }
    }
    return;
  }

  const int g = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r = q0 + g * 64 + warp * 16 + lane / 4;
  const TileRange my = q0 + g * 64 < Sq
      ? kv_range(q0 + g * 64, min(q0 + g * 64 + 63, Sq - 1), Sq, Sk, causal, window)
      : TileRange{0, 0};
  float lse2[2], dl[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t row = ((int64_t)b * H + h) * Sq + r + 8 * j;
    lse2[j] = r + 8 * j < Sq ? lse[row] * LOG2E : 0.f;
    dl[j] = r + 8 * j < Sq ? delta[row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, t = rng.first + it;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (t >= my.first && t < my.last) {
      const uint8_t* ks = sk + s * C::KV_BYTES;
      float sc[32], dp[32];
      wgmma_fence();
      mma_abt<D, QR>(sc, sq, g * 64, ks);                    // S = Q K^T
      mma_abt<D, QR>(dp, sdo, g * 64, sv + s * C::KV_BYTES);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // dS = P * (dP - delta), P = exp(S scale - lse), 0 where masked
      // (rows past Sq too)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * i + 2 * j + c;
            const int key = t * BKV + 8 * i + 2 * (lane % 4) + c;
            const int row = r + 8 * j;
            const bool ok = row < Sq && visible(key, row, Sq, Sk, causal, window);
            const float p = ok ? exp2f(fmaf(sc[e], sl2, -lse2[j])) : 0.f;
            sc[e] = p * (dp[e] - dl[j]);
          }
      uint32_t dh[4][4], dlo[4][4];
      pack_all_hilo(dh, dlo, sc);  // dS as a bf16 hi + lo pair
      wgmma_fence();
      mma_pv<D>(acc, dh, ks);  // dQ += dS K
      mma_pv<D>(acc, dlo, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<D>(acc, scale, scale, dq + b * dqs.b + h * dqs.h, dqs.s, r, Sq, lane);
}

template <int D> struct Dkv {
  static constexpr int KV_BYTES = tile_bytes<D>(BKV);
  static constexpr int QT_BYTES = tile_bytes<D>(BQB);
  // a stage: the q tile, the dO tile, then ROW_BOX lse and, 512 bytes on,
  // ROW_BOX delta (f32), padded so that every stage's tiles start on 1024
  // bytes
  static constexpr int STAGE = 2 * QT_BYTES + 1024;
  static constexpr int SMEM = 2 * KV_BYTES + STAGES * STAGE + (1 + 2 * STAGES) * 8 + 1024;
};

// dK/dV. One block per (key tile of BKV keys, slab of SLAB columns of D,
// KV head, batch), key tile 0 first (under causal it sees the most
// queries); keys are the rows of every product. The producer walks the
// group's n_rep query heads in order and, for each, the query tiles at or
// past the causal frontier, so the GQA sum comes in a fixed order with no
// atomics. Every block stages full-width tiles and forms S^T and dP^T over
// all of D; it accumulates dV and dK on its slab only (below D = 192 the
// slab is all of D).
template <int D, bool WIN>
__global__ void __launch_bounds__(THREADS_KV, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tlse, const __grid_constant__ CUtensorMap tdelta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int H, int KV,
            int Sq, int Sk, Strides dks, Strides dvs, int causal, int window, float sl2,
            float scale) {
  if constexpr (!WIN) window = 0;
  using C = Dkv<D>;
  constexpr int SW = SLAB<D>, NS = D / SW;  // slab columns, slabs
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + C::KV_BYTES;
  uint8_t* ring = sv + C::KV_BYTES;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int n_rep = H / KV;
  const int k0 = (blockIdx.x / (KV * B * NS)) * BKV;
  const int slab = (blockIdx.x / (KV * B)) % NS;
  const int kvh = blockIdx.x % KV;
  const int b = (blockIdx.x / KV) % B;
  // the first query tile that sees key k0: rows i >= k0 - (Sk - Sq); under
  // a window the last is below the rows i < k_last - (Sk - Sq) + window
  const int t0 = causal ? max(0, k0 - (Sk - Sq)) / BQB : 0;
  int t_end = cdiv(Sq, BQB);
  if (window > 0)
    t_end = min(t_end, cdiv(min(Sq, max(0, min(k0 + BKV, Sk) - 1 - (Sk - Sq) + window)), BQB));
  const int per_head = max(0, t_end - t0);  // 0: no row's window reaches the tile
  const int n_it = n_rep * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      load_tile<D, BKV>(sk, &tk, kv_full, k0, kvh, b);
      load_tile<D, BKV>(sv, &tv, kv_full, k0, kvh, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int h = kvh * n_rep + it / per_head;
        const int q0 = (t0 + it % per_head) * BQB;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::QT_BYTES + 2 * ROW_BOX * 4);
        uint8_t* st = ring + s * C::STAGE;
        load_tile<D, BQB>(st, &tq, &full[s], q0, h, b);
        load_tile<D, BQB>(st + C::QT_BYTES, &tdo, &full[s], q0, h, b);
        // lse and delta rows of (b, h) from q0 on, from the 16-byte boundary
        // at or before them; rows past Sq are the next head's (or zeros at
        // the end) and are masked below
        const int row = ((b * H + h) * Sq + q0) & ~3;
        tma_load_1d(st + 2 * C::QT_BYTES, &tlse, &full[s], row);
        tma_load_1d(st + 2 * C::QT_BYTES + 512, &tdelta, &full[s], row);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = k0 + warp * 16 + lane / 4;  // this thread's keys: key, key + 8
  float dka[SW / 2], dva[SW / 2];
#pragma unroll
  for (int i = 0; i < SW / 2; ++i) dka[i] = dva[i] = 0.f;
  // the slab's first 64-column chunk in a staged q or dO tile
  const int slab_off = slab * (SW / 64) * (BQB * 128);
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    const int q0 = (t0 + it % per_head) * BQB;
    const uint8_t* st = ring + s * C::STAGE;
    const int skew = ((b * H + kvh * n_rep + it / per_head) * Sq + q0) & 3;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * C::QT_BYTES) + skew;
    const float* delta_s = reinterpret_cast<const float*>(st + 2 * C::QT_BYTES + 512) + skew;
    mbar_wait(&full[s], (it / STAGES) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    mma_abt<D, BKV>(sc, sk, 0, st);                // S^T = K Q^T
    mma_abt<D, BKV>(dp, sv, 0, st + C::QT_BYTES);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    // P^T = exp(S^T scale - lse) and dS^T = P^T * (dP^T - delta), lse and
    // delta per column (query row); 0 where masked: keys past Sk, query
    // rows past Sq, and under causal keys past i + (Sk - Sq)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * i + 2 * (lane % 4) + c;
        const int qi = q0 + col;
        const float l2 = lse_s[col] * LOG2E, dl = delta_s[col];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * i + 2 * j + c;
          const int kj = key + 8 * j;
          const bool ok = qi < Sq && visible(kj, qi, Sq, Sk, causal, window);
          const float p = ok ? exp2f(fmaf(sc[e], sl2, -l2)) : 0.f;
          sc[e] = p;
          dp[e] = p * (dp[e] - dl);
        }
      }
    uint32_t pa[4][4], dh[4][4], dlo[4][4];
    pack_all(pa, sc);             // P^T in bf16, as the forward rounds P before P@V
    pack_all_hilo(dh, dlo, dp);   // dS^T as a bf16 hi + lo pair
    wgmma_fence();
    mma_pv<SW>(dva, pa, st + C::QT_BYTES + slab_off);  // dV += P^T dO, on the slab
    mma_pv<SW>(dka, dh, st + slab_off);  // dK += dS^T Q
    mma_pv<SW>(dka, dlo, st + slab_off);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<SW>(dka, scale, scale, dk + b * dks.b + kvh * dks.h + slab * SW, dks.s, key, Sk,
                 lane);
  store_rows<SW>(dva, 1.f, 1.f, dv + b * dvs.b + kvh * dvs.h + slab * SW, dvs.s, key, Sk, lane);
}

// A (B, H, S, D) bf16 view as a 4-D tensor map {D, S, H, B}, its strides
// in elements multiples of 8 (a dimension of size 1 may carry any: the
// wrapper passes one that is), cut into boxes {64, rows, 1, 1}.
bool encode_bhsd(CUtensorMap* map, const void* base, int B, int H, int S, int D, Strides t,
                 int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t st[3] = {(cuuint64_t)t.s * 2, (cuuint64_t)t.h * 2, (cuuint64_t)t.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, st, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// n contiguous f32 values as a 1-D tensor map, boxes of ROW_BOX.
bool encode_f32(CUtensorMap* map, const void* base, int64_t n) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t unused[1] = {(cuuint64_t)n * 4};  // a rank-1 map has no strides
  const cuuint32_t box[1] = {ROW_BOX};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims, unused, box,
                CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = e == cudaSuccess;
  return e;
}

// Each wgmma kernel is built twice, with and without the window: the
// window's per-element test and tile range cost the global kernels
// registers (and the D = 64 forward spills) that they need not pay.
template <int D, bool WIN>
cudaError_t launch_fwd_win(const FwdArgs& a, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t e = allow_smem(fwd_kernel<D, WIN>, Fwd<D>::SMEM, configured);
  if (e != cudaSuccess) return e;
  CUtensorMap mq, mk, mv;
  if (!encode_bhsd(&mq, a.q, a.B, a.H, a.Sq, D, a.qs, BQ) ||
      !encode_bhsd(&mk, a.k, a.B, a.KV, a.Sk, D, a.ks, BKV) ||
      !encode_bhsd(&mv, a.v, a.B, a.KV, a.Sk, D, a.vs, BKV))
    return cudaErrorInvalidValue;
  const int blocks = cdiv(a.Sq, BQ) * a.H * a.B;
  fwd_kernel<D, WIN><<<blocks, FWD_THREADS<D>, Fwd<D>::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.o), a.lse, a.B, a.H, a.H / a.KV, a.Sq, a.Sk,
      a.os, a.causal, a.window, a.scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  return a.window > 0 ? launch_fwd_win<D, true>(a, stream) : launch_fwd_win<D, false>(a, stream);
}

template <int D, bool WIN>
cudaError_t launch_bwd_win(const BwdArgs& a, cudaStream_t stream) {
  static bool conf_dq = false, conf_kv = false;
  cudaError_t e = allow_smem(dq_kernel<D, WIN>, Dq<D>::SMEM, conf_dq);
  if (e == cudaSuccess) e = allow_smem(dkdv_kernel<D, WIN>, Dkv<D>::SMEM, conf_kv);
  if (e != cudaSuccess) return e;
  // q, k, v, dO as the wgmma kernels read them: q and dO in DQ_ROWS-row
  // boxes (dQ) and BQB-row boxes (dK/dV), k and v in BKV-row boxes
  CUtensorMap mq, mq_b, mk, mv, mdo, mdo_b, mlse, mdelta;
  const int64_t n_rows = (int64_t)a.B * a.H * a.Sq;
  if (!encode_bhsd(&mq, a.q, a.B, a.H, a.Sq, D, a.qs, DQ_ROWS<D>) ||
      !encode_bhsd(&mq_b, a.q, a.B, a.H, a.Sq, D, a.qs, BQB) ||
      !encode_bhsd(&mk, a.k, a.B, a.KV, a.Sk, D, a.ks, BKV) ||
      !encode_bhsd(&mv, a.v, a.B, a.KV, a.Sk, D, a.vs, BKV) ||
      !encode_bhsd(&mdo, a.dO, a.B, a.H, a.Sq, D, a.dos, DQ_ROWS<D>) ||
      !encode_bhsd(&mdo_b, a.dO, a.B, a.H, a.Sq, D, a.dos, BQB) ||
      !encode_f32(&mlse, a.lse, n_rows) || !encode_f32(&mdelta, a.delta, n_rows))
    return cudaErrorInvalidValue;
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(a.o);
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(a.dO);
  dim3 dgrid((a.Sq + simt::ROWS - 1) / simt::ROWS, a.H, a.B);
  simt::flash_bwd_delta_kernel<__nv_bfloat16, D><<<dgrid, simt::THREADS_OF<D>, 0, stream>>>(
      o, dO, a.delta, a.Sq, a.os, a.dos);
  const float sl2 = a.scale * LOG2E;
  const int slabs = D / SLAB<D>;
  dkdv_kernel<D, WIN><<<cdiv(a.Sk, BKV) * slabs * a.KV * a.B, THREADS_KV, Dkv<D>::SMEM,
                        stream>>>(
      mq_b, mk, mv, mdo_b, mlse, mdelta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.B, a.H, a.KV, a.Sq, a.Sk, a.dks, a.dvs, a.causal,
      a.window, sl2, a.scale);
  dq_kernel<D, WIN><<<cdiv(a.Sq, DQ_ROWS<D>) * a.H * a.B, DQ_THREADS<D>, Dq<D>::SMEM,
                      stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq), a.B, a.H, a.H / a.KV,
      a.Sq, a.Sk, a.dqs, a.causal, a.window, sl2, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  return a.window > 0 ? launch_bwd_win<D, true>(a, stream) : launch_bwd_win<D, false>(a, stream);
}

}  // namespace wg


namespace {

// The wgmma route at head_dim D (bf16 only): launch<64>, <128>, <192> or
// <256>, or cudaErrorInvalidValue.
template <typename Args, template <int> class L>
cudaError_t wgmma_route(const Args& a, int D, int dtype, cudaStream_t s) {
  if (dtype != 1 || (D != 64 && D != 128 && D != 192 && D != 256)) return cudaErrorInvalidValue;
  cudaError_t e = sm90::bind_context();
  if (e != cudaSuccess) return e;
  switch (D) {
    case 64: return L<64>::run(a, s);
    case 128: return L<128>::run(a, s);
    case 192: return L<192>::run(a, s);
    default: return L<256>::run(a, s);
  }
}

template <int D> struct WgFwd {
  static cudaError_t run(const simt::FwdArgs& a, cudaStream_t s) { return wg::launch_fwd<D>(a, s); }
};
template <int D> struct WgBwd {
  static cudaError_t run(const simt::BwdArgs& a, cudaStream_t s) { return wg::launch_bwd<D>(a, s); }
};

}  // namespace

// lse may be null (no log-sum-exp written). window 0 is global. route:
// 0 = simt, 1 = wgmma.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Sq, int Sk, int D, int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int causal, int window, int dtype, float scale, int route, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (simt::bad_dims(B, H, KV, Sq, Sk, causal, window)) return (int)cudaErrorInvalidValue;
  simt::FwdArgs a{q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Sk,
            {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
            {o_sb, o_sh, o_ss}, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) return (int)wgmma_route<simt::FwdArgs, WgFwd>(a, D, dtype, st);
  const int rc = simt::dispatch_t<simt::Fwd>(a, D, dtype, st);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// strides: 3 per tensor (batch, head, seq) for q, k, v, o, dO, dq, dk, dv in
// that order; delta is (B, H, Sq) f32 scratch. route: 0 = simt, 1 = wgmma.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int H, int KV, int Sq, int Sk, int D,
    const int64_t* strides, int causal, int window, int dtype, float scale, int route,
    void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (simt::bad_dims(B, H, KV, Sq, Sk, causal, window)) return (int)cudaErrorInvalidValue;
  const int64_t* s = strides;
  simt::BwdArgs a{q, k, v, o, dO, static_cast<const float*>(lse), dq, dk, dv,
            static_cast<float*>(delta), B, H, KV, Sq, Sk,
            {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
            {s[9], s[10], s[11]}, {s[12], s[13], s[14]},
            {s[15], s[16], s[17]}, {s[18], s[19], s[20]},
            {s[21], s[22], s[23]}, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) return (int)wgmma_route<simt::BwdArgs, WgBwd>(a, D, dtype, st);
  const int rc = simt::dispatch_t<simt::Bwd>(a, D, dtype, st);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
