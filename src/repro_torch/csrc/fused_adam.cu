// Fused AdamW update for Hopper (sm_90a): one pass over (p32, g, m, v) that
// writes p32, m and v back IN PLACE and a bf16 copy of p.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_adam.py
// (fused_adam_flat / _adam_kernel). Same function: AdamW with the decay
// inside lr, scalars [lr, b1, b2, eps, wd, c1, c2] read from a (7,) f32
// array in device memory (the Pallas SMEM operand), so lr and the bias
// corrections stay on the card and no launch waits on the host.
//
// Arithmetic: every operation rounds to nearest in f32, in the order of the
// plain version (kernels/ref.py:adam_ref); the __f*_rn intrinsics keep the
// compiler from contracting a multiply and an add into one FMA, so kernel
// and plain version agree bit for bit.
//
// Bound on this card: the update has no reuse. Each element reads 16 bytes
// (p, g, m, v in f32) and writes 14 (p, m, v in f32, p in bf16), 30 bytes
// for ~15 flops, far under the H100's ridge, so the least time is the bytes
// over 3.35 TB/s: 0.254 ms for the tied smollm-135m embedding (28.3 M
// elements). Design for that bound: a grid-stride loop in which each thread
// moves 16 bytes per array per access (float4 loads and stores, the bf16
// copy as two bf16x2 stores), a few blocks per SM in flight.
//
// C interface (ctypes): pointers and the stream are void*, the arrays are
// contiguous and 16-byte aligned, n is a multiple of 4. Returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Hyper {
  float lr, b1, b2, eps, wd, c1, c2, omb1, omb2;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mh = __fdiv_rn(m, h.c1);
  const float vh = __fdiv_rn(v, h.c2);
  const float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
  p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(u, __fmul_rn(h.wd, p))));
}

__global__ void __launch_bounds__(THREADS)
fused_adam_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                  float4* __restrict__ m, float4* __restrict__ v,
                  __nv_bfloat162* __restrict__ pbf,
                  const float* __restrict__ s, int64_t n4) {
  Hyper h;
  h.lr = s[0]; h.b1 = s[1]; h.b2 = s[2]; h.eps = s[3]; h.wd = s[4];
  h.c1 = s[5]; h.c2 = s[6];
  h.omb1 = __fsub_rn(1.f, h.b1);
  h.omb2 = __fsub_rn(1.f, h.b2);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n4; i += stride) {
    float4 pp = p[i], mm = m[i], vv = v[i];
    const float4 gg = g[i];
    adam_one(pp.x, gg.x, mm.x, vv.x, h);
    adam_one(pp.y, gg.y, mm.y, vv.y, h);
    adam_one(pp.z, gg.z, mm.z, vv.z, h);
    adam_one(pp.w, gg.w, mm.w, vv.w, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
    pbf[2 * i] = __floats2bfloat162_rn(pp.x, pp.y);
    pbf[2 * i + 1] = __floats2bfloat162_rn(pp.z, pp.w);
  }
}

}  // namespace

extern "C" int fused_adam(void* p, const void* g, void* m, void* v, void* pbf,
                          const void* scalars, int64_t n, void* stream) {
  cudaGetLastError();  // clear any stale error so the return is this launch's
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  const int64_t want = (n4 + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  fused_adam_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(p), static_cast<const float4*>(g),
      static_cast<float4*>(m), static_cast<float4*>(v),
      static_cast<__nv_bfloat162*>(pbf), static_cast<const float*>(scalars), n4);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
