// K7: the RG-LRU diagonal recurrence h_t = a_t * h_{t-1} + b_t on Hopper,
// forward and backward.
//
// Replaces repro/kernels/lru_scan/kernel.py:lru_scan_kernel (body _kernel).
// Built by repro_torch/kernels/lru_scan/kernel.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/repro_torch/lru_scan-<hash>.so lru_scan.cu
// and loaded with ctypes.  Each entry point takes raw pointers and the
// caller's CUDA stream, launches on that stream, never synchronises and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// What it computes (the same as lru_scan_ref): a, b (B,T,R) and h0 (B,R)
// or none (zeros), f32 or bf16; the carry is f32 and h (B,T,R) is written
// in a's dtype.  The backward runs the same recurrence in reverse with an
// f32 carry g:
//   g_t = dh_t + a_{t+1} g_{t+1}     (g_T = 0)
//   db_t = g_t,  da_t = g_t h_{t-1}  (h_{-1} = h0),  dh0 = a_0 g_0
// in one pass, reading a, the forward's h and dh.  Neither kernel uses
// atomics: every output element has one writer, so both are deterministic.
//
// Bound: bytes.  The forward reads a and b and writes h (3 B T R elements
// plus h0); the backward reads a, h and dh and writes da and db (5 B T R
// plus h0 and dh0).  At the training slice's shape (B=2, T=1024, R=2560,
// f32) that is 63 MB, 0.019 ms at 3.35 TB/s, and 105 MB, 0.031 ms.
//
// Design, simple and right first: one thread per (b, r) channel walks T
// with the carry in a register; neighbouring threads own neighbouring r, so
// every load and store of a time step is coalesced along R.  The walk loads
// kUnroll time steps of every input before it uses them, so that many loads
// are in flight per thread.  It takes any T >= 1 and any R: no padding and
// no T % 8 or R % 128 branch (the TPU's 256 x 128 tiles are VMEM blocking,
// not semantics).  Its parallelism is B R threads, 5,120 at the training
// shape, far below what the card can keep in flight; a chunked two-pass
// scan over T is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;  // small blocks: B R threads spread over SMs
constexpr int kUnroll = 8;    // time steps loaded ahead of use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lru_forward_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ h0, T* __restrict__ h, int B,
                       int Tn, int R) {
  const int64_t ch = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= (int64_t)B * R) return;
  const int bi = (int)(ch / R), r = (int)(ch - (int64_t)bi * R);
  const int64_t base = (int64_t)bi * Tn * R + r;
  float carry = h0 ? to_f32(h0[ch]) : 0.f;
  for (int t0 = 0; t0 < Tn; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      av[u] = t < Tn ? to_f32(a[base + (int64_t)t * R]) : 0.f;
      bv[u] = t < Tn ? to_f32(b[base + (int64_t)t * R]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < Tn) {
        carry = fmaf(av[u], carry, bv[u]);
        h[base + (int64_t)t * R] = from_f32<T>(carry);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lru_backward_kernel(const T* __restrict__ a, const T* __restrict__ h,
                        const T* __restrict__ h0, const T* __restrict__ dh,
                        T* __restrict__ da, T* __restrict__ db,
                        T* __restrict__ dh0, int B, int Tn, int R) {
  const int64_t ch = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= (int64_t)B * R) return;
  const int bi = (int)(ch / R), r = (int)(ch - (int64_t)bi * R);
  const int64_t base = (int64_t)bi * Tn * R + r;
  const float h_init = h0 ? to_f32(h0[ch]) : 0.f;
  float g = 0.f;       // g_{t+1}
  float a_next = 0.f;  // a_{t+1}
  // walk t = Tn-1 .. 0 in groups of kUnroll, loads of a group first
  for (int t1 = Tn - 1; t1 >= 0; t1 -= kUnroll) {
    float av[kUnroll], hp[kUnroll], dv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - u;
      const bool in = t >= 0;
      av[u] = in ? to_f32(a[base + (int64_t)t * R]) : 0.f;
      dv[u] = in ? to_f32(dh[base + (int64_t)t * R]) : 0.f;
      hp[u] = t > 0 ? to_f32(h[base + (int64_t)(t - 1) * R]) : h_init;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        g = fmaf(a_next, g, dv[u]);
        db[base + (int64_t)t * R] = from_f32<T>(g);
        da[base + (int64_t)t * R] = from_f32<T>(g * hp[u]);
        a_next = av[u];
      }
    }
  }
  if (dh0) dh0[ch] = from_f32<T>(a_next * g);  // a_0 g_0
}

inline unsigned blocks_for(int B, int R) {
  return (unsigned)(((int64_t)B * R + kThreads - 1) / kThreads);
}

inline bool bad_shape(int B, int Tn, int R) {
  return B < 1 || Tn < 1 || R < 1 ||
         (int64_t)B * R > (int64_t)kThreads * 2147483647LL;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  h0 may be null (zeros).
int lru_forward(const void* a, const void* b, const void* h0, void* h, int B,
                int Tn, int R, int dtype, void* stream) {
  if (bad_shape(B, Tn, R)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for(B, R);
  switch (dtype) {
    case 0:
      lru_forward_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<const float*>(h0), static_cast<float*>(h), B, Tn, R);
      break;
    case 1:
      lru_forward_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(b),
          static_cast<const __nv_bfloat16*>(h0),
          static_cast<__nv_bfloat16*>(h), B, Tn, R);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// h is the forward's output; h0 and dh0 may be null (no initial state).
int lru_backward(const void* a, const void* h, const void* h0, const void* dh,
                 void* da, void* db, void* dh0, int B, int Tn, int R,
                 int dtype, void* stream) {
  if (bad_shape(B, Tn, R)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = blocks_for(B, R);
  switch (dtype) {
    case 0:
      lru_backward_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(h),
          static_cast<const float*>(h0), static_cast<const float*>(dh),
          static_cast<float*>(da), static_cast<float*>(db),
          static_cast<float*>(dh0), B, Tn, R);
      break;
    case 1:
      lru_backward_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(h),
          static_cast<const __nv_bfloat16*>(h0),
          static_cast<const __nv_bfloat16*>(dh),
          static_cast<__nv_bfloat16*>(da), static_cast<__nv_bfloat16*>(db),
          static_cast<__nv_bfloat16*>(dh0), B, Tn, R);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
