// K6: flash attention forward on Hopper (GQA, causal, sliding window, tanh
// logit softcap).
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_kernel
// (body _kernel).  Built by repro_torch/kernels/flash_attention/kernel.py at
// first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/repro_torch/flash_attention-<hash>.so
//        flash_attention.cu
// and loaded with ctypes.  The entry point takes raw pointers and the
// caller's CUDA stream, launches on that stream, never synchronises and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// What it computes (the same as flash_attention_ref): q (B,Tq,H,D), k
// (B,Tk,K,D), v (B,Tk,K,Dv) in the JAX layout, f32/bf16/f16; query head h
// reads KV head h / (H/K), with no repeated KV in memory.
//   s = (q * scale) . k^T in f32;  s = cap * tanh(s / cap) when cap > 0;
//   masked (k >= Tk, causal k > q, window q - k >= window) to the finite
//   -2.3819763e38, never -inf;
//   online softmax with m, l and acc in f32, l floored at 1e-37;
//   o (B,Tq,H,Dv) in q's dtype.
// The kernel takes any Tq, Tk >= 1 and masks the ragged edge itself: the
// TPU entry padded T to 128 with zero keys, which a non-causal call then
// attended to (ROADMAP Queue 3).
//
// Bound at the serving slice's prefill shape (B=4, T=1024, H=24, K=8,
// D=Dv=128, bf16, causal): 2*2*B*H*T^2*D/2 = 25.8 GFLOP, 0.026 ms at
// 989 TFLOP/s dense bf16; q/k/v/o are 67.1 MB, 0.020 ms at 3.35 TB/s; so
// 0.026 ms, compute-bound.  32 launches per prefill (one per layer).
//
// Design, simple and right first: one block of 256 threads per (b, h, 64
// query rows); the 64 x D query tile is scaled into shared memory as f32;
// a loop over 64-key tiles (the TPU's sequential "arbitrary" grid axis)
// loads K and V as f32 into shared memory, each thread computes a 4 x 4
// block of S with f32 FMA, one warp per 8 rows runs the online softmax,
// and each thread keeps a 4 x (Dv/16) slice of the f32 accumulator in
// registers.  Key tiles that lie wholly above the diagonal or wholly
// outside the window are skipped: the TPU kernel runs them, but their
// contribution is wiped by corr = 0 once a row meets a valid key, so the
// result is the same.  CUDA cores only: wgmma, TMA and warp specialisation
// are later work, and the tensor cores would round f32 inputs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16 threads over a 64 x 64 tile
constexpr int kMaxHead = 256;  // D and Dv up to 256 (gemma-7b head_dim)
constexpr float kNeg = -2.3819763e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

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
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Tq, Tk, H, K, D, Dv;
  float scale;
  int causal;
  int window;  // <= 0: no window
  float cap;   // <= 0: no softcap
};

// Shared memory, in floats: Q (kBQ x D+1), K (kBK x D+1), V (kBK x Dv),
// S/P (kBQ x kBK+1), then m, l and corr (kBQ each).  The odd row stride of
// Q, K and S puts the rows a warp reads on distinct banks.
inline size_t smem_floats(int D, int Dv) {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * Dv +
         (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

// NJ = accumulator columns per thread: thread (tx, ty) owns rows ty + 16 i
// (i < 4) and columns tx + 16 j (j < NJ) of the 64 x Dv output tile.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) fa_forward_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  const int ld = D + 1;
  const int lds = kBK + 1;
  float* Qs = smem;
  float* Ks = Qs + kBQ * ld;
  float* Vs = Ks + kBK * ld;
  float* Ss = Vs + kBK * Dv;
  float* m_s = Ss + kBQ * lds;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int t = q0 + r;
    float x = 0.f;
    if (t < p.Tq)
      x = to_f32(q[(((int64_t)b * p.Tq + t) * p.H + h) * D + c]) * p.scale;
    Qs[r * ld + c] = x;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + kBQ, p.Tq) - 1;
  const int nk = (p.Tk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    // block-uniform skips of wholly masked tiles (see the note above)
    if (p.causal && k0 > q_last) break;
    if (p.window > 0 && q0 - (k0 + kBK - 1) >= p.window) continue;

    __syncthreads();  // the previous tile's readers are done with K, V, P
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      const int t = k0 + r;
      Ks[r * ld + c] =
          t < p.Tk ? to_f32(k[(((int64_t)b * p.Tk + t) * p.K + kh) * D + c])
                   : 0.f;
    }
    for (int e = tid; e < kBK * Dv; e += kThreads) {
      const int r = e / Dv, c = e - r * Dv;
      const int t = k0 + r;
      Vs[r * Dv + c] =
          t < p.Tk ? to_f32(v[(((int64_t)b * p.Tk + t) * p.K + kh) * Dv + c])
                   : 0.f;
    }
    __syncthreads();

    // S = (q * scale) . k^T, softcap, mask
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float x = s[i][j];
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        bool ok = kpos < p.Tk;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        Ss[r * lds + c] = ok ? x : kNeg;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, two keys per lane
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* row = Ss + r * lds;
      const float a = row[lane], c = row[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      row[lane] = pa;
      row[lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * lds + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < Dv ? Vs[c * Dv + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    if (t >= p.Tq) continue;
    const float denom = fmaxf(l_s[r], 1e-37f);
    T* out = o + (((int64_t)b * p.Tq + t) * p.H + h) * Dv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < Dv) out[col] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.D, p.Dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + kBQ - 1) / kBQ, p.H, p.B);
  fa_forward_kernel<T, NJ><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dv(const Params& p, cudaStream_t stream) {
  if (p.Dv <= 64) return launch<T, 4>(p, stream);
  if (p.Dv <= 128) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  window <= 0 and cap <= 0 turn
// the window and the softcap off.
int fa_forward(const void* q, const void* k, const void* v, void* o, int B,
               int Tq, int Tk, int H, int K, int D, int Dv, float scale,
               int causal, int window, float cap, int dtype, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || K < 1 || H < K || H % K != 0 || D < 1 ||
      D > kMaxHead || Dv < 1 || Dv > kMaxHead || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, B, Tq, Tk, H, K, D, Dv, scale, causal, window,
                 cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dv<float>(p, s); break;
    case 1: err = launch_dv<__nv_bfloat16>(p, s); break;
    case 2: err = launch_dv<__half>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
