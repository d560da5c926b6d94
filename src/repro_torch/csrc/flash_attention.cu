// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel). Same function: online softmax with
// m, l and the accumulator in f32, scale D^-0.5, query head h reads KV head
// h / (H / KV), keys past Sk and (when causal) keys j > i + (Sk - Sq) score
// -1e30, and p is rounded to the input type before the P@V product.
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
// Bound on this card: at the serve shapes (B=4, H=9, KV=3, Sq=Sk=512, D=64,
// bf16) the causal work is ~1.2 GFLOP against ~6.3 MB of q, k, v and o:
// ~190 flop/byte, under the H100's ~295 flop/byte bf16 ridge, so the least
// time is set by bytes (~1.9 us). This first version computes with CUDA-core
// FMAs in f32 (67 TF/s peak), not the tensor cores, so in practice it is
// bound by those operations; wgmma/TMA are the later, faster version.
//
// C interface (ctypes): pointers and the stream are void*, strides are in
// elements and the last dim is contiguous. Returns cudaGetLastError().

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
                 int n_rep, int Sq, int Sk, Strides qs, Strides ks,
                 Strides vs, Strides os, int causal, float scale) {
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
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B, int H,
            int KV, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
            Strides os, int causal, float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / KV, Sq, Sk, qs, ks, vs,
      os, causal, scale);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int Sq, int Sk, int D, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 32: launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, stream); break;
    case 64: launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, stream); break;
    case 128: launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os, causal, scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
    int Sq, int Sk, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, int causal,
    int dtype, float scale, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 ||
      (causal && Sq > Sk) || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = dispatch_d<float>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, scale, s);
  else if (dtype == 1)
    rc = dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D, qs, ks, vs, os, causal, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
