// K6: flash attention on Hopper (GQA, causal, sliding window, tanh logit
// softcap), forward and backward.
//
// The forward replaces repro/kernels/flash_attention/kernel.py:
// flash_attention_kernel (body _kernel).  The backward has no TPU
// counterpart: the reference trains attention through XLA
// (models/attention.py, _ATTN_IMPL "auto"), and autograd's gradient through
// flash_attention_ref is what it must equal.  Built by
// repro_torch/kernels/flash_attention/kernel.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/repro_torch/flash_attention-<hash>.so
//        flash_attention.cu
// and loaded with ctypes.  Each entry point takes raw pointers and the
// caller's CUDA stream, launches on that stream, never synchronises and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// What the forward computes (the same as flash_attention_ref): q
// (B,Tq,H,D), k (B,Tk,K,D), v (B,Tk,K,Dv) in the JAX layout, f32/bf16/f16;
// query head h reads KV head h / (H/K), with no repeated KV in memory.
//   s = (q * scale) . k^T in f32;  s = cap * tanh(s / cap) when cap > 0;
//   masked (k >= Tk, causal k > q, window q - k >= window) to the finite
//   -2.3819763e38, never -inf;
//   online softmax with m, l and acc in f32, l floored at 1e-37;
//   o (B,Tq,H,Dv) in q's dtype, and when asked what the backward reads:
//   the row log-sum-exp lse = m + log(l), f32 (B,H,Tq), and for bf16/f16
//   inputs o once more in f32 (o32), before its rounding.
// The kernel takes any Tq, Tk >= 1 and masks the ragged edge itself: the
// TPU entry padded T to 128 with zero keys, which a non-causal call then
// attended to (ROADMAP Queue 3).
//
// The backward (FlashAttention-2's) recomputes P = exp(s - lse) tile by
// tile and never stores a T x T matrix:
//   Dl_i = sum_c dO_ic O_ic       (f32, from the f32 output: with o rounded
//                                  to bf16, Dl is off by 2^-9 relative and
//                                  dS = P (dP - Dl) carries that error)
//   dP_ij = dO_i . V_j;  dS_ij = P_ij (dP_ij - Dl_i), times 1 - tanh^2
//   under the softcap; masked pairs have P = 0 and so dS = 0;
//   dQ_i = scale sum_j dS_ij K_j,  dK_j = sum_i dS_ij (q_i scale),
//   dV_j = sum_i P_ij dO_i.
// fa_backward_dq runs first, one block per (b, h, 64 query rows) looping
// over 32-key tiles; it also writes Dl.  fa_backward_dkdv then runs one
// block per (b, kv head, 32 keys), looping over the G query heads of the
// group and the query tiles that reach its keys, so GQA and MQA sum dK and
// dV in registers with no atomics: the backward is deterministic.  At
// head_dim 256 a 64-key tile's dK and dV accumulators would need 128 f32
// registers a thread, so key tiles are 32 rows (64 registers).
//
// Bounds.  Forward at the serving slice's prefill shape (B=4, T=1024,
// H=24, K=8, D=Dv=128, bf16, causal): 2*2*B*H*T^2*D/2 = 25.8 GFLOP, 0.026
// ms at 989 TFLOP/s dense bf16; q/k/v/o are 67.1 MB, 0.020 ms at 3.35
// TB/s; so 0.026 ms, compute-bound.  The backward does 2.5 times the
// forward's products (S, dP, dQ, dK, dV).
//
// Design, simple and right first: the forward is one block of 256 threads
// per (b, h, 64 query rows); the 64 x D query tile is scaled into shared
// memory as f32; a loop over 64-key tiles (the TPU's sequential
// "arbitrary" grid axis) loads K and V as f32 into shared memory, each
// thread computes a 4 x 4 block of S with f32 FMA, one warp per 8 rows
// runs the online softmax, and each thread keeps a 4 x (Dv/16) slice of
// the f32 accumulator in registers.  Key tiles that lie wholly above the
// diagonal or wholly outside the window are skipped: the TPU kernel runs
// them, but their contribution is wiped by corr = 0 once a row meets a
// valid key, so the result is the same; the backward skips the same
// pairs, whose P is 0.  CUDA cores only: wgmma, TMA and warp
// specialisation are later work, and the tensor cores would round f32
// inputs.

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
  float* lse;  // (B, H, Tq) row log-sum-exp, or null
  float* o32;  // (B, Tq, H, Dv) o in f32, or null
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
    if (p.lse && tx == 0)
      p.lse[((int64_t)b * p.H + h) * p.Tq + t] = m_s[r] + logf(denom);
    const int64_t row = (((int64_t)b * p.Tq + t) * p.H + h) * Dv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < Dv) {
        const float x = acc[i][j] / denom;
        o[row + col] = from_f32<T>(x);
        if (p.o32) p.o32[row + col] = x;
      }
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


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBBQ = 64;  // query rows per backward tile
constexpr int kBBK = 32;  // keys per backward tile

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* o;    // (B, Tq, H, Dv): the forward's output in f32
  const void* dout;
  const float* lse;  // (B, H, Tq)
  float* dl;         // (B, H, Tq): written by the dQ pass, read by dK/dV
  void* dq;
  void* dk;
  void* dv;
  int B, Tq, Tk, H, K, D, Dv;
  float scale;
  int causal;
  int window;
  float cap;
};

// Both passes hold, in floats: Q (kBBQ x D+1, scaled), dO (kBBQ x Dv+1),
// K (kBBK x D+1), V (kBBK x Dv+1), dS (kBBQ x kBBK+1), lse and Dl (kBBQ
// each); the dK/dV pass also P (kBBQ x kBBK+1).
inline size_t bwd_smem_floats(int D, int Dv, bool with_p) {
  return (size_t)kBBQ * (D + 1) + (size_t)kBBQ * (Dv + 1) +
         (size_t)kBBK * (D + 1) + (size_t)kBBK * (Dv + 1) +
         (size_t)kBBQ * (kBBK + 1) * (with_p ? 2 : 1) + 2 * kBBQ;
}

// The tile's pairs: thread (tx, ty) owns query rows ty + 16 i (i < 4) and
// keys tx + 16 j (j < 2).  From Q, dO, K, V, lse and Dl in shared memory
// it writes P (when Ps is not null) and dS for its 8 pairs.
template <bool kWithP>
__device__ __forceinline__ void bwd_tile_ds(const BwdParams& p, int q0,
                                            int k0, const float* Qs,
                                            const float* dOs, const float* Ks,
                                            const float* Vs, const float* lse_s,
                                            const float* dl_s, float* Ps,
                                            float* dSs, int tx, int ty) {
  const int ld = p.D + 1, ldv = p.Dv + 1, lds = kBBK + 1;
  float s[4][2], dp[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < p.D; ++d) {
    float qa[4], kb[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 2; ++j) kb[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
  }
  for (int d = 0; d < p.Dv; ++d) {
    float oa[4], vb[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) oa[i] = dOs[(ty + 16 * i) * ldv + d];
#pragma unroll
    for (int j = 0; j < 2; ++j) vb[j] = Vs[(tx + 16 * j) * ldv + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      float x = s[i][j], dtanh = 1.f;
      if (p.cap > 0.f) {
        const float th = tanhf(x / p.cap);
        x = p.cap * th;
        dtanh = 1.f - th * th;
      }
      bool ok = qpos < p.Tq && kpos < p.Tk;
      if (p.causal) ok = ok && qpos >= kpos;
      if (p.window > 0) ok = ok && qpos - kpos < p.window;
      const float pr = ok ? expf(x - lse_s[r]) : 0.f;
      if (kWithP) Ps[r * lds + c] = pr;
      dSs[r * lds + c] = pr * (dp[i][j] - dl_s[r]) * dtanh;
    }
  }
}

// Loads a key tile of K and V (rows k0 .. k0 + kBBK) as f32, zeros past Tk.
template <typename T>
__device__ __forceinline__ void bwd_load_kv(const BwdParams& p, int b, int kh,
                                            int k0, float* Ks, float* Vs,
                                            int tid) {
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  const int D = p.D, Dv = p.Dv;
  for (int e = tid; e < kBBK * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int t = k0 + r;
    Ks[r * (D + 1) + c] =
        t < p.Tk ? to_f32(k[(((int64_t)b * p.Tk + t) * p.K + kh) * D + c])
                 : 0.f;
  }
  for (int e = tid; e < kBBK * Dv; e += kThreads) {
    const int r = e / Dv, c = e - r * Dv;
    const int t = k0 + r;
    Vs[r * (Dv + 1) + c] =
        t < p.Tk ? to_f32(v[(((int64_t)b * p.Tk + t) * p.K + kh) * Dv + c])
                 : 0.f;
  }
}

// Loads a query tile of q (scaled) and dO as f32, zeros past Tq.
template <typename T>
__device__ __forceinline__ void bwd_load_q(const BwdParams& p, int b, int h,
                                           int q0, float* Qs, float* dOs,
                                           int tid) {
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ dout = static_cast<const T*>(p.dout);
  const int D = p.D, Dv = p.Dv;
  for (int e = tid; e < kBBQ * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int t = q0 + r;
    Qs[r * (D + 1) + c] =
        t < p.Tq
            ? to_f32(q[(((int64_t)b * p.Tq + t) * p.H + h) * D + c]) * p.scale
            : 0.f;
  }
  for (int e = tid; e < kBBQ * Dv; e += kThreads) {
    const int r = e / Dv, c = e - r * Dv;
    const int t = q0 + r;
    dOs[r * (Dv + 1) + c] =
        t < p.Tq ? to_f32(dout[(((int64_t)b * p.Tq + t) * p.H + h) * Dv + c])
                 : 0.f;
  }
}

// dQ pass: one block per (b, h, kBBQ query rows).  NJ = dQ columns per
// thread: thread (tx, ty) owns rows ty + 16 i (i < 4), columns tx + 16 j.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) fa_backward_dq_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  float* Qs = smem;
  float* dOs = Qs + kBBQ * (D + 1);
  float* Ks = dOs + kBBQ * (Dv + 1);
  float* Vs = Ks + kBBK * (D + 1);
  float* dSs = Vs + kBBK * (Dv + 1);
  float* lse_s = dSs + kBBQ * (kBBK + 1);
  float* dl_s = lse_s + kBBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const float* __restrict__ o = p.o;
  const int64_t row0 = ((int64_t)b * p.H + h) * p.Tq;

  bwd_load_q<T>(p, b, h, q0, Qs, dOs, tid);
  __syncthreads();
  // Dl = rowsum(dO * O): warp w owns rows 8w .. 8w+7
  for (int rr = 0; rr < kBBQ / 8; ++rr) {
    const int r = warp * (kBBQ / 8) + rr;
    const int t = q0 + r;
    float sum = 0.f;
    if (t < p.Tq) {
      const float* orow = o + (((int64_t)b * p.Tq + t) * p.H + h) * Dv;
      for (int c = lane; c < Dv; c += 32)
        sum = fmaf(dOs[r * (Dv + 1) + c], orow[c], sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      dl_s[r] = sum;
      lse_s[r] = t < p.Tq ? p.lse[row0 + t] : 0.f;
      if (t < p.Tq) p.dl[row0 + t] = sum;
    }
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + kBBQ, p.Tq) - 1;
  const int nk = (p.Tk + kBBK - 1) / kBBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBBK;
    if (p.causal && k0 > q_last) break;
    if (p.window > 0 && q0 - (k0 + kBBK - 1) >= p.window) continue;
    __syncthreads();  // the previous tile's readers are done with K, V, dS
    bwd_load_kv<T>(p, b, kh, k0, Ks, Vs, tid);
    __syncthreads();
    bwd_tile_ds<false>(p, q0, k0, Qs, dOs, Ks, Vs, lse_s, dl_s, nullptr, dSs,
                       tx, ty);
    __syncthreads();
    for (int c = 0; c < kBBK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * (kBBK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float kv = col < D ? Ks[c * (D + 1) + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }
  T* __restrict__ dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= p.Tq) continue;
    T* out = dq + (((int64_t)b * p.Tq + t) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) out[col] = from_f32<T>(acc[i][j] * p.scale);
    }
  }
}

// dK/dV pass: one block per (b, kv head, kBBK keys), looping over the G
// query heads of the group and the query tiles that reach these keys.
// Thread (tx, ty) owns keys ty and ty + 16, columns tx + 16 j.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    fa_backward_dkdv_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  float* Qs = smem;
  float* dOs = Qs + kBBQ * (D + 1);
  float* Ks = dOs + kBBQ * (Dv + 1);
  float* Vs = Ks + kBBK * (D + 1);
  float* dSs = Vs + kBBK * (Dv + 1);
  float* Ps = dSs + kBBQ * (kBBK + 1);
  float* lse_s = Ps + kBBQ * (kBBK + 1);
  float* dl_s = lse_s + kBBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBBK;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.K;
  const int k_last = min(k0 + kBBK, p.Tk) - 1;
  const int nq = (p.Tq + kBBQ - 1) / kBBQ;
  // query tiles that reach these keys: causal needs q >= k0, the window
  // q - k_last < window
  const int qt_first = p.causal ? k0 / kBBQ : 0;
  int qt_end = nq;
  if (p.window > 0) {
    const int64_t q_max = (int64_t)k_last + p.window - 1;
    qt_end = (int)min((int64_t)nq, q_max / kBBQ + 1);
  }

  float acc_k[2][NJ], acc_v[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  bwd_load_kv<T>(p, b, kh, k0, Ks, Vs, tid);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const int64_t row0 = ((int64_t)b * p.H + h) * p.Tq;
    for (int qt = qt_first; qt < qt_end; ++qt) {
      const int q0 = qt * kBBQ;
      __syncthreads();  // the previous tile's readers are done
      bwd_load_q<T>(p, b, h, q0, Qs, dOs, tid);
      if (tid < kBBQ) {
        const int t = q0 + tid;
        lse_s[tid] = t < p.Tq ? p.lse[row0 + t] : 0.f;
        dl_s[tid] = t < p.Tq ? p.dl[row0 + t] : 0.f;
      }
      __syncthreads();
      bwd_tile_ds<true>(p, q0, k0, Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, tx,
                        ty);
      __syncthreads();
      for (int r = 0; r < kBBQ; ++r) {
        float pr[2], ds[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pr[i] = Ps[r * (kBBK + 1) + ty + 16 * i];
          ds[i] = dSs[r * (kBBK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          const float dov = col < Dv ? dOs[r * (Dv + 1) + col] : 0.f;
          const float qv = col < D ? Qs[r * (D + 1) + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc_v[i][j] = fmaf(pr[i], dov, acc_v[i][j]);
            acc_k[i][j] = fmaf(ds[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }
  T* __restrict__ dk = static_cast<T*>(p.dk);
  T* __restrict__ dv = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= p.Tk) continue;
    T* outk = dk + (((int64_t)b * p.Tk + t) * p.K + kh) * D;
    T* outv = dv + (((int64_t)b * p.Tk + t) * p.K + kh) * Dv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) outk[col] = from_f32<T>(acc_k[i][j]);
      if (col < Dv) outv[col] = from_f32<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch_bwd(const BwdParams& p, bool dq_pass, cudaStream_t stream) {
  const size_t bytes = bwd_smem_floats(p.D, p.Dv, !dq_pass) * sizeof(float);
  if (dq_pass) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_backward_dq_kernel<T, NJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Tq + kBBQ - 1) / kBBQ, p.H, p.B);
    fa_backward_dq_kernel<T, NJ><<<grid, kThreads, bytes, stream>>>(p);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        fa_backward_dkdv_kernel<T, NJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Tk + kBBK - 1) / kBBK, p.K, p.B);
    fa_backward_dkdv_kernel<T, NJ><<<grid, kThreads, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_d(const BwdParams& p, bool dq_pass,
                         cudaStream_t stream) {
  const int d = p.D > p.Dv ? p.D : p.Dv;
  if (d <= 64) return launch_bwd<T, 4>(p, dq_pass, stream);
  if (d <= 128) return launch_bwd<T, 8>(p, dq_pass, stream);
  return launch_bwd<T, 16>(p, dq_pass, stream);
}

inline bool bad_shape(int B, int Tq, int Tk, int H, int K, int D, int Dv) {
  return B < 1 || Tq < 1 || Tk < 1 || K < 1 || H < K || H % K != 0 ||
         D < 1 || D > kMaxHead || Dv < 1 || Dv > kMaxHead || H > 65535 ||
         B > 65535;
}

cudaError_t run_bwd(const BwdParams& p, int dtype, bool dq_pass,
                    cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_bwd_d<float>(p, dq_pass, s);
    case 1: return launch_bwd_d<__nv_bfloat16>(p, dq_pass, s);
    case 2: return launch_bwd_d<__half>(p, dq_pass, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  window <= 0 and cap <= 0 turn
// the window and the softcap off.
// lse and o32 may be null (no log-sum-exp, no f32 copy of o).
int fa_forward(const void* q, const void* k, const void* v, void* o,
               float* lse, float* o32, int B, int Tq, int Tk, int H, int K,
               int D, int Dv, float scale, int causal, int window, float cap,
               int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, K, D, Dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k,  v,  o,     lse,    o32,    B,  Tq, Tk,
                 H, K,  D,  Dv,    scale,  causal, window, cap};
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

// The backward's first pass: dq (B,Tq,H,D) and dl (B,H,Tq, f32 scratch the
// second pass reads), from q, k, v, the forward's output in f32 (o), its
// lse, and dout.
int fa_backward_dq(const void* q, const void* k, const void* v,
                   const float* o, const void* dout, const float* lse,
                   float* dl, void* dq, int B, int Tq, int Tk, int H, int K,
                   int D, int Dv, float scale, int causal, int window,
                   float cap, int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, K, D, Dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{q,  k,  v,  o,  dout,  lse,    dl,     dq,  nullptr,
                    nullptr, B, Tq, Tk, H, K, D, Dv, scale, causal, window,
                    cap};
  return static_cast<int>(run_bwd(p, dtype, true,
                                  static_cast<cudaStream_t>(stream)));
}

// The backward's second pass, after the first on the same stream: dk
// (B,Tk,K,D) and dv (B,Tk,K,Dv).
int fa_backward_dkdv(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* dl,
                     void* dk, void* dv, int B, int Tq, int Tk, int H, int K,
                     int D, int Dv, float scale, int causal, int window,
                     float cap, int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, K, D, Dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{q,  k,  v,  nullptr, dout, lse, const_cast<float*>(dl),
                    nullptr, dk, dv, B, Tq, Tk, H, K, D, Dv, scale, causal,
                    window, cap};
  return static_cast<int>(run_bwd(p, dtype, false,
                                  static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
