// Causal GQA flash attention for Hopper (sm_90a): the forward, and the
// backward that the TPU kernel does not have.
//
// Forward. Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel). Same function: online softmax with
// m, l and the accumulator in f32, scale D^-0.5, query head h reads KV head
// h / (H / KV), keys past Sk and (when causal) keys j > i + (Sk - Sq) score
// -1e30, and p is rounded to the input type before the P@V product. When
// asked, it also writes each row's f32 log-sum-exp m + log(l), which the
// backward reads instead of recomputing the softmax's normalizer.
//
// Design. One thread block per (q tile of BQ rows, head, batch); a loop over
// K/V tiles of BK keys staged in shared memory as f32 takes the place of the
// TPU's sequential grid axis. LANES threads share one query row: each keeps
// D/LANES of the row's q and accumulator in registers (dims d = lane +
// LANES*i, so the lanes of a row read neighbouring shared-memory words), and
// a score is the sum of the lanes' partial dot products through two warp
// shuffles. The K/V tiles past the causal frontier of the block's last row
// are skipped: their scores would be -1e30 and contribute exactly 0.
//
// Backward (no TPU counterpart: the reference differentiates its jnp
// chunked attention). The classic split into kernels with no atomics, so
// the GQA sums come in a fixed order and repeat to the bit:
//   delta: delta_i = sum_d dO_id O_id in f32, one row per LANES threads;
//   dK/dV: one block per (K/V tile of BK keys, KV head, batch), LANES
//          threads per key holding k_j, v_j and the f32 dk_j, dv_j in
//          registers; it loops over the group's H/KV query heads and the
//          query tiles at or past the causal frontier (q, dO, lse, delta
//          staged in shared memory), recomputes p = exp(s - lse), adds
//          p_r * dO to dv (p_r = p rounded to the input type, as the forward
//          rounds it before P@V) and ds * q to dk, ds = p * (dP - delta);
//   dQ:    one block per (q tile, head, batch) like the forward, looping
//          over K/V tiles up to the frontier and adding ds * k to dq.
//
// Bound on this card: at the train shapes (B=8, H=9, KV=3, Sq=Sk=512, D=64,
// bf16) the forward's causal work is ~2.4 GFLOP against ~12.6 MB, ~190
// flop/byte, under the H100's ~295 flop/byte bf16 ridge: bytes bound it
// (~3.8 us). The backward reads q, k, v, o, dO, lse and writes dq, dk, dv
// for 10*D flops per causal pair, ~6 GFLOP against ~20 MB: ~300 flop/byte,
// at the ridge. These first versions compute with CUDA-core FMAs in f32
// (67 TF/s peak), not the tensor cores, so in practice those operations
// bound them; wgmma/TMA are the later, faster version.
//
// C interface (ctypes): pointers and the stream are void*, strides are in
// elements and the last dim is contiguous; lse and delta are contiguous
// (B, H, Sq) f32. Each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int LANES = 4;
constexpr int THREADS = BQ * LANES;
constexpr float NEG_INF = -1e30f;

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
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_rep, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 float scale) {
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

  for (int t = 0; t < n_tiles; ++t) {
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
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = t * BK + j;
      const bool valid = kj < Sk && (!causal || kj <= qi + q_offset);
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
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                       float* __restrict__ delta, int Sq, Strides os,
                       Strides dos) {
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
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  if (qi < Sq && lane == 0) delta[((int64_t)b * gridDim.y + h) * Sq + qi] = part;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int n_rep, int Sq, int Sk,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dks, Strides dvs, int causal, float scale) {
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
  const int n_qt = (Sq + BQ - 1) / BQ;

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
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 2);
        const bool valid = key_valid && (!causal || kj <= qi + q_offset);
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
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n_rep, int Sq, int Sk, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dqs, int causal,
                    float scale) {
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

  for (int t = 0; t < n_tiles; ++t) {
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
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const int kj = t * BK + j;
      const bool valid = row_valid && kj < Sk && (!causal || kj <= qi + q_offset);
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
  int causal;
  float scale;
};

struct BwdArgs {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  int B, H, KV, Sq, Sk;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal;
  float scale;
};

template <typename T, int D>
void launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.H / a.KV,
      a.Sq, a.Sk, a.qs, a.ks, a.vs, a.os, a.causal, a.scale);
}

template <typename T, int D>
void launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dO = static_cast<const T*>(a.dO);
  dim3 qgrid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_delta_kernel<T, D><<<qgrid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.o), dO, a.delta, a.Sq, a.os, a.dos);
  dim3 kgrid((a.Sk + BK - 1) / BK, a.KV, a.B);
  flash_bwd_dkdv_kernel<T, D><<<kgrid, THREADS, 0, stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.H, a.H / a.KV, a.Sq, a.Sk, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs,
      a.causal, a.scale);
  flash_bwd_dq_kernel<T, D><<<qgrid, THREADS, 0, stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dq), a.H / a.KV, a.Sq,
      a.Sk, a.qs, a.ks, a.vs, a.dos, a.dqs, a.causal, a.scale);
}

// dtype x head_dim dispatch: 0 = float32, 1 = bfloat16; D in {32, 64, 128}
template <typename T, int D> struct Fwd { static void run(const FwdArgs& a, cudaStream_t s) { launch_fwd<T, D>(a, s); } };
template <typename T, int D> struct Bwd { static void run(const BwdArgs& a, cudaStream_t s) { launch_bwd<T, D>(a, s); } };

template <template <typename, int> class L, typename T, typename Args>
int dispatch_d(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 32: L<T, 32>::run(a, s); break;
    case 64: L<T, 64>::run(a, s); break;
    case 128: L<T, 128>::run(a, s); break;
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

bool bad_dims(int B, int H, int KV, int Sq, int Sk, int causal) {
  return B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
         (causal && Sq > Sk) || B > 65535 || H > 65535;
}

}  // namespace

// lse may be null (no log-sum-exp written).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Sq, int Sk, int D, int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int causal, int dtype, float scale, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (bad_dims(B, H, KV, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  FwdArgs a{q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Sk,
            {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
            {o_sb, o_sh, o_ss}, causal, scale};
  const int rc = dispatch_t<Fwd>(a, D, dtype, static_cast<cudaStream_t>(stream));
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// strides: 3 per tensor (batch, head, seq) for q, k, v, o, dO, dq, dk, dv in
// that order; delta is (B, H, Sq) f32 scratch.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int H, int KV, int Sq, int Sk, int D,
    const int64_t* strides, int causal, int dtype, float scale, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (bad_dims(B, H, KV, Sq, Sk, causal)) return (int)cudaErrorInvalidValue;
  const int64_t* s = strides;
  BwdArgs a{q, k, v, o, dO, static_cast<const float*>(lse), dq, dk, dv,
            static_cast<float*>(delta), B, H, KV, Sq, Sk,
            {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
            {s[9], s[10], s[11]}, {s[12], s[13], s[14]},
            {s[15], s[16], s[17]}, {s[18], s[19], s[20]},
            {s[21], s[22], s[23]}, causal, scale};
  const int rc = dispatch_t<Bwd>(a, D, dtype, static_cast<cudaStream_t>(stream));
  if (rc) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
