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
// reading a, the forward's h and dh.  Neither kernel uses atomics: every
// output element has one writer and every sum one order, so both are
// deterministic.
//
// Bound: bytes.  The forward reads a and b and writes h (3 B T R elements
// plus h0); the backward reads a, h and dh and writes da and db (5 B T R
// plus h0 and dh0).  At the training slice's shape (B=2, T=1024, R=2560,
// f32) that is 63 MB, 0.019 ms at 3.35 TB/s, and 105 MB, 0.031 ms.
//
// Both kernels cut T into chunks of kSteps steps.  One thread walking all
// of T for its channel would be latency-bound: B R threads (5,120 at the
// training shape) cannot keep the ~3.4 MB in flight that the card's memory
// needs.  The recurrence is linear in its carry, so a chunk walked from a
// zero carry gives a partial result and the product of its a, and the
// chunks' true carries follow from those by a short serial chain.  A block
// owns one batch row and a slab of 32 channels (one a lane, so a warp's
// loads of a step are one coalesced row) and walks T in segments of kWarps
// chunks, one chunk a warp:
//   1. each warp loads its chunk's inputs into registers (all of them
//      before any is used) and walks it with a zero carry: c^ and Q into
//      shared memory;
//   2. warp 0 chains the segment's chunks in order, starting from the
//      segment's carry (the previous segment's out), and writes each
//      chunk's carry in;
//   3. each warp walks its chunk again from registers with its true carry
//      and writes its outputs.
// Each input element is read once and each output written once: the
// bound's bytes.  Two barriers a segment; at the training shape 160 blocks
// of 512 threads.  Neither kernel uses fused multiply-adds in its steps:
// each step rounds as the plain version (and autograd through it) does.
//
// Forward, in time order: h_t = a_t h_{t-1} + b_t.  A chunk [s, e) walked
// from h = 0 gives c^ (its last h) and Q = a_s ... a_{e-1}, and its true
// last h is
//   h_{e-1} = c^ + Q h_{s-1}.
// The carry into the first segment is h0 (0 without it), into each later
// one the previous segment's last h.  Each thread holds 64 B of loads in
// flight (f32): 5.2 MB at the training shape.  Steps past T read as a = 1,
// b = 0.  Numerics: each step is a * h rounded, then + b rounded, as
// lru_scan_ref; so every row's first chunk (steps 0 .. kSteps - 1, whose
// carry in is h0 exactly) is bit for bit the plain version's, and later
// chunks differ from a serial walk by the chain's one rounding a chunk
// (Q * carry, then + c^, each rounded: ref.lru_scan_chunked_ref's order).
// A zero carry stays an exact zero: where h0 is 0 and b is 0 up to step t,
// c^ = 0 and the chain gives Q 0 + 0 = 0, so h is exactly 0 up to t.
//
// Backward, in reverse: the same recurrence with carry g.  Written with
// x_t = a_t g_t (the carry into step t - 1), a chunk [s, e) walked with a
// zero carry gives c^ = a_s g^_s and Q = a_s ... a_{e-1}, and its true
// carry out is
//   x_s = c^ + Q x_e.
// It walks T in reverse; warp 0 chains the chunks from the last to the
// first, starting from 0 at T.  Each thread holds 96 B of loads in flight
// (f32: a, dh and h_{t-1}): 7.9 MB at the training shape.  Steps past T
// read as a = 1, dh = 0, which pass a carry through exactly.  Numerics:
// each step is x = a * g rounded, then g = dh + x rounded, which is what
// autograd through the plain version does; the carries differ from a
// serial walk by one rounding per chunk (fmaf(Q, x_e, c^)).  Where dh is 0
// from t onward, g, da and db are exact zeros there.
//
// Q is the product of kSteps values of a: a in [0, 1], as the RG-LRU's gate
// makes it, keeps it finite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 16;  // chunks a segment: one a warp
constexpr int kSteps = 8;   // time steps a chunk
constexpr int kThreads = 32 * kWarps;
constexpr int kSegment = kWarps * kSteps;

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
__global__ void __launch_bounds__(kThreads, 2)
    lru_forward_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ h0, T* __restrict__ h, int B,
                       int Tn, int R) {
  __shared__ float c_hat[kWarps][32];  // the chunk's last h from h = 0
  __shared__ float q_all[kWarps][32];  // a_s ... a_{e-1}
  __shared__ float c_in[kWarps][32];   // h_{s-1}, the true carry in
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slabs = (R + 31) / 32;
  const int bi = blockIdx.x / slabs;
  const int r = (blockIdx.x - bi * slabs) * 32 + lane;
  const bool live = r < R;
  const int64_t base = (int64_t)bi * Tn * R + r;
  // warp 0: h at the current segment's start (h0, or 0, before step 0)
  float carry = live && h0 ? to_f32(h0[(int64_t)bi * R + r]) : 0.f;
  const int segments = (Tn + kSegment - 1) / kSegment;
  for (int seg = 0; seg < segments; ++seg) {
    const int s = seg * kSegment + warp * kSteps;  // the warp's chunk
    float av[kSteps], bv[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int t = s + u;
      const bool in = live && t < Tn;
      av[u] = in ? to_f32(a[base + (int64_t)t * R]) : 1.f;
      bv[u] = in ? to_f32(b[base + (int64_t)t * R]) : 0.f;
    }
    // 1. the chunk from a zero carry
    float x = 0.f, q = 1.f;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      x = __fadd_rn(__fmul_rn(av[u], x), bv[u]);
      q = __fmul_rn(q, av[u]);
    }
    c_hat[warp][lane] = x;
    q_all[warp][lane] = q;
    __syncthreads();
    // 2. the segment's chunks in order, first to last
    if (warp == 0) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        c_in[w][lane] = carry;
        carry = __fadd_rn(__fmul_rn(q_all[w][lane], carry), c_hat[w][lane]);
      }
    }
    __syncthreads();
    // 3. the chunk again from its true carry
    x = c_in[warp][lane];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int t = s + u;
      x = __fadd_rn(__fmul_rn(av[u], x), bv[u]);
      if (live && t < Tn) h[base + (int64_t)t * R] = from_f32<T>(x);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    lru_backward_kernel(const T* __restrict__ a, const T* __restrict__ h,
                        const T* __restrict__ h0, const T* __restrict__ dh,
                        T* __restrict__ da, T* __restrict__ db,
                        T* __restrict__ dh0, int B, int Tn, int R) {
  __shared__ float c_hat[kWarps][32];  // a_s g^_s of each chunk
  __shared__ float q_all[kWarps][32];  // a_s ... a_{e-1}
  __shared__ float c_in[kWarps][32];   // x_e, the true carry in
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slabs = (R + 31) / 32;
  const int bi = blockIdx.x / slabs;
  const int r = (blockIdx.x - bi * slabs) * 32 + lane;
  const bool live = r < R;
  const int64_t base = (int64_t)bi * Tn * R + r;
  const float h_init = live && h0 ? to_f32(h0[(int64_t)bi * R + r]) : 0.f;
  float carry = 0.f;  // warp 0: x at the current segment's end (0 at T)
  for (int seg = (Tn - 1) / kSegment; seg >= 0; --seg) {
    const int s = seg * kSegment + warp * kSteps;  // the warp's chunk
    float av[kSteps], dv[kSteps], hp[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int t = s + u;
      const bool in = live && t < Tn;
      av[u] = in ? to_f32(a[base + (int64_t)t * R]) : 1.f;
      dv[u] = in ? to_f32(dh[base + (int64_t)t * R]) : 0.f;
      hp[u] = in && t > 0 ? to_f32(h[base + (int64_t)(t - 1) * R]) : h_init;
    }
    // 1. the chunk with a zero carry
    float x = 0.f, q = 1.f;
#pragma unroll
    for (int u = kSteps - 1; u >= 0; --u) {
      x = __fmul_rn(av[u], __fadd_rn(dv[u], x));
      q = __fmul_rn(q, av[u]);
    }
    c_hat[warp][lane] = x;
    q_all[warp][lane] = q;
    __syncthreads();
    // 2. the segment's chunks in order, last to first
    if (warp == 0) {
#pragma unroll
      for (int w = kWarps - 1; w >= 0; --w) {
        c_in[w][lane] = carry;
        carry = fmaf(q_all[w][lane], carry, c_hat[w][lane]);
      }
    }
    __syncthreads();
    // 3. the chunk again with its true carry
    x = c_in[warp][lane];
#pragma unroll
    for (int u = kSteps - 1; u >= 0; --u) {
      const int t = s + u;
      const float g = __fadd_rn(dv[u], x);
      if (live && t < Tn) {
        db[base + (int64_t)t * R] = from_f32<T>(g);
        da[base + (int64_t)t * R] = from_f32<T>(__fmul_rn(g, hp[u]));
      }
      x = __fmul_rn(av[u], g);
    }
  }
  // carry = x_0 = a_0 g_0
  if (warp == 0 && live && dh0) dh0[(int64_t)bi * R + r] = from_f32<T>(carry);
}

// One block per (batch row, 32-channel slab).
inline unsigned blocks_for(int B, int R) {
  return (unsigned)((int64_t)B * ((R + 31) / 32));
}

inline bool bad_shape(int B, int Tn, int R) {
  return B < 1 || Tn < 1 || R < 1 ||
         (int64_t)B * ((R + 31) / 32) > 2147483647LL;
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
