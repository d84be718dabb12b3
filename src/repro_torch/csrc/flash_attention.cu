// K6: flash attention on Hopper (GQA, causal, sliding window, tanh logit
// softcap), forward and backward.
//
// The forward replaces repro/kernels/flash_attention/kernel.py:78
// flash_attention_kernel (body _kernel, line 34).  The backward has no TPU
// counterpart: the reference trains attention through XLA
// (models/attention.py, _ATTN_IMPL "auto"), and autograd's gradient through
// flash_attention_ref is what it must equal.  Built by
// repro_torch/kernels/flash_attention/kernel.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/flash_attention-<hash>.so
//        flash_attention.cu
// and loaded with ctypes.  Each entry point takes raw pointers and the
// caller's CUDA stream, launches on that stream, never synchronises and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// What the forward computes (the same as flash_attention_ref): q
// (B,Tq,H,D), k (B,Tk,K,D), v (B,Tk,K,Dv) in the JAX layout, f32/bf16/f16;
// query head h reads KV head h / (H/K), with no repeated KV in memory.
//   s = (q . k^T) * scale in f32;  s = cap * tanh(s / cap) when cap > 0;
//   masked (k >= Tk, causal k > q, window q - k >= window) to the finite
//   -2.3819763e38, never -inf;
//   online softmax with m, l and acc in f32, l floored at 1e-37;
//   o (B,Tq,H,Dv) in q's dtype, and when asked what the backward reads:
//   the row log-sum-exp lse = m + log(l), f32 (B,H,Tq), and for bf16/f16
//   inputs o once more in f32 (o32), before its rounding.
// The kernels take any Tq, Tk >= 1, D and Dv from 1 to 256, and mask the
// ragged edge themselves: the TPU entry padded T to 128 with zero keys,
// which a non-causal call then attended to (ROADMAP Queue 3).
//
// The backward (FlashAttention-2's) recomputes P = exp(s - lse) tile by
// tile and never stores a T x T matrix:
//   Dl_i = sum_c dO_ic O_ic       (f32, from the f32 output: with o rounded
//                                  to bf16, Dl is off by 2^-9 relative and
//                                  dS = P (dP - Dl) carries that error)
//   dP_ij = dO_i . V_j;  dS_ij = P_ij (dP_ij - Dl_i), times 1 - tanh^2
//   under the softcap; masked pairs have P = 0 and so dS = 0;
//   dQ_i = scale sum_j dS_ij K_j,  dK_j = scale sum_i dS_ij q_i,
//   dV_j = sum_i P_ij dO_i.
// fa_backward_dq runs first, one block per (b, h, 64 query rows) looping
// over key tiles; it also writes Dl.  fa_backward_dkdv then sums dK and dV.
// Neither pass uses atomics, so two launches on the same inputs give the
// same bytes: a restored training run continues bitwise.
//
// Bounds on this card (989 TFLOP/s dense bf16, 3.35 TB/s).  Forward at the
// serving prefill (B=4, T=1024, H=24, K=8, D=Dv=128, bf16, causal):
// 2*B*H*T(T+1)/2*(D+Dv) = 25.8 GFLOP, 0.026 ms; q/k/v/o are 67.1 MB, 0.020
// ms; so 0.026 ms, operations.  Backward at the training step's attention
// (B=2, T=1024, H=10, K=1, D=Dv=256, bf16, causal, window 2048):
// 2*B*H*T(T+1)/2*(3D+2Dv) (S, dP, dQ, dK, dV) = 26.9 GFLOP, 0.027 ms; its
// 56.7 MB of inputs and outputs 0.017 ms; so 0.027 ms, operations.  Both
// are tensor-core work, so:
//
// bf16 inputs (every config of the repo computes attention in bf16) take
// the tensor-core kernels (fa_*_tc_kernel below).  Every product is
// mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32 with operands through
// ldmatrix from shared memory:
// - S = q . k^T and dP = dO . v^T on the inputs as stored: a product of two
//   bf16 values is exact in f32, and scale multiplies S in f32 after it;
// - P . V, dS . K, dS^T . q and P^T . dO take P or dS (f32) as three bf16
//   terms hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which
//   hold its 24-bit significand exactly: each product equals the f32
//   CUDA-core kernel's but for the order of summation (and the tensor
//   cores' accumulation, which does not round to nearest at every step).
//   P rounded once to bf16 would move the output by about 2^-9 relative,
//   which 32 bf16 layers of a served model amplify past the prefill's
//   control (chip_smoke.py phase 6).  Two terms (hi and mid, 16 bits)
//   were measured at most 7 % faster and are not built.
// - the online softmax, the softcap and its derivative, the masks, Dl and
//   every accumulator stay in f32 registers.
// Tiles: 64 rows a block (16 a warp); the forward and the dQ pass loop over
// 64-key tiles, the dK/dV pass over 32-query tiles.  Each block keeps its
// own 64-row tiles in shared memory and double-buffers the tiles it loops
// over with 16-byte cp.async (loads of tile t + 1 overlap the products on
// tile t), rows padded by 16 bytes so that ldmatrix is free of bank
// conflicts, columns past D or Dv zero up to a multiple of 16 and rows past
// T zero, so the padding adds nothing.  D and Dv that are not multiples of
// 8, or unaligned pointers, take plain loads into the same layout.  The
// head width is a template bucket of 64, 128 or 256; where one warp's f32
// accumulators over all its columns would spill (16 rows x 256 columns of
// O or dQ, or of dK and dV together, is 128 registers a thread or more),
// the block has 8 warps, two per 16 rows, each holding half the columns and
// both computing the rows' S (and dP).
// The dK/dV pass runs one block per (b, query head, 64 keys), so MQA
// (K = 1, B = 2, T = 1024: 320 blocks) fills the 132 SMs, and writes f32
// partials (B, Tk, H, D + Dv); fa_sum_heads_kernel then sums the G heads
// of each group in a fixed order (g = 0 .. G-1), times scale for dK, and
// rounds to bf16 once.
//
// f32 and f16 inputs take the CUDA-core kernels (fa_forward_kernel,
// fa_backward_{dq,dkdv}_kernel): f32 products on the tensor cores would
// round to TF32, and no config computes in f16.  Their design: one block
// of 256 threads per (b, h, 64 query rows); the query tile scaled into
// shared memory as f32; a loop over 64-key tiles (the TPU's sequential
// "arbitrary" grid axis) loads K and V as f32 into shared memory, each
// thread computes a 4 x 4 block of S with f32 FMA, one warp per 8 rows runs
// the online softmax, and each thread keeps a 4 x (Dv/16) slice of the
// accumulator in registers.  Their backward's dK/dV pass runs one block per
// (b, kv head, 32 keys), looping over the G query heads of its group, so
// dK and dV are summed in registers (at head_dim 256 a 64-key tile's
// accumulators would need 128 registers a thread).
// Both designs skip key tiles that lie wholly above the diagonal or wholly
// outside the window (the TPU kernel runs them, but their contribution is
// wiped by corr = 0 once a row meets a valid key, so the result is the
// same), and the backward skips the same pairs, whose P is 0.

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
  int vec;     // tensor-core kernels: 16-byte loads (D, Dv % 8 == 0, aligned)
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
  float* part;  // tensor-core dK/dV pass: f32 partials (B, Tk, H, D + Dv)
  int vec;
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;        // rows a block: queries, or keys (dK/dV)
constexpr int kTcFwdKeys = 64;     // keys a forward tile
constexpr int kTcDqKeys = 64;      // keys a dQ tile
constexpr int kTcDkvQueries = 32;  // queries a dK/dV tile

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8 x 8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of each matrix, row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 (with .trans: rows 2 (l % 4) and
// 2 (l % 4) + 1 of column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// d += a . b: a 16 x 16 bf16 (row major), b 16 x 8 bf16 (column major), d
// 16 x 8 f32.  Lane l holds rows l / 4 and l / 4 + 8 of a and d, columns
// 2 (l % 4) + {0, 1} (and + 8 for a), and of b rows 2 (l % 4) + {0, 1}
// (and + 8) of column l / 4.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; bytes = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (lo, hi) f32 -> bf16x2 rounded to nearest even, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// A pair of f32 values as bf16 terms hi + mid + lo, exactly: each residual
// is exact in f32, and three 8-bit significands hold the 24 of an f32.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float r0 = x0 - bf16_lo(hi), r1 = x1 - bf16_hi(hi);
  mid = pack_bf16(r0, r1);
  lo = pack_bf16(r0 - bf16_lo(mid), r1 - bf16_hi(mid));
}

// The 16 x 16 a operand over columns 16 kc .. 16 kc + 15 of a warp's f32
// accumulator s (16 rows x SB n-blocks of 8, in the layout mma_bf16 writes),
// split into bf16 terms.  kc must be a compile-time index.
template <int SB>
__device__ __forceinline__ void a_from_acc(const float (&s)[SB][4], int kc,
                                           uint32_t (&hi)[4],
                                           uint32_t (&mid)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], mid[0], lo[0]);
  split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], mid[1], lo[1]);
  split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], mid[2], lo[2]);
  split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], mid[3], lo[3]);
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// s (16 x SB*8) += a . b^T over k < HD: a = 16 rows and b = SB*8 rows of
// row-major bf16 tiles in shared memory (row stride HD + 8).
template <int SB, int HD>
__device__ __forceinline__ void mma_abt(float (&s)[SB][4], const bf16* a,
                                        const bf16* b, int lane) {
  constexpr int LDS = HD + 8;
  const bf16* pa = a + (lane & 15) * LDS + (lane >> 4) * 8;
  const bf16* pb = b + ((lane & 7) + (lane >> 4) * 8) * LDS +
                   ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, pa + kc * 16);
#pragma unroll
    for (int nb = 0; nb < SB; nb += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, pb + nb * 8 * LDS + kc * 16);
      mma_bf16(s[nb], af, bf[0], bf[1]);
      mma_bf16(s[nb + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x NB*8, columns col0 ..) += a . b, a the 16 x 16 operand as three
// bf16 terms (the smallest first), b rows kr .. kr + 15 of a row-major bf16
// tile in shared memory (row stride LDS).  Straight-line code, so that the
// scheduler interleaves the accumulators' dependent chains.
template <int NB, int LDS>
__device__ __forceinline__ void mma_split_t(float (&acc)[NB][4],
                                            const uint32_t (&hi)[4],
                                            const uint32_t (&mid)[4],
                                            const uint32_t (&lo)[4],
                                            const bf16* tile,
                                            int kr, int col0, int lane) {
  const bf16* base = tile +
                     (kr + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                     col0 + (lane >> 4) * 8;
#pragma unroll
  for (int nb = 0; nb < NB; nb += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, base + nb * 8);
    mma_bf16(acc[nb], lo, b[0], b[1]);
    mma_bf16(acc[nb + 1], lo, b[2], b[3]);
    mma_bf16(acc[nb], mid, b[0], b[1]);
    mma_bf16(acc[nb + 1], mid, b[2], b[3]);
    mma_bf16(acc[nb], hi, b[0], b[1]);
    mma_bf16(acc[nb + 1], hi, b[2], b[3]);
  }
}

// Rows t0 .. t0 + nrows - 1 of x (B, T, nh, width) at batch b, head hh into
// shared memory as HD columns (row stride HD + 8): zeros past T and past
// width.  vec: 16-byte cp.async (width % 8 == 0 and x 16-byte aligned);
// otherwise plain loads and stores.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* x, int b,
                                          int t0, int T, int nh, int hh,
                                          int width, int nrows, bool vec,
                                          int tid, int nthreads) {
  constexpr int LDS = HD + 8;
  constexpr int chunks = HD / 8;  // 8 values a chunk
  for (int e = tid; e < nrows * chunks; e += nthreads) {
    const int r = e / chunks, c = (e - r * chunks) * 8;
    const int t = t0 + r;
    bf16* d = dst + r * LDS + c;
    const bf16* src = x + (((int64_t)b * T + t) * nh + hh) * width + c;
    if (vec) {
      const bool ok = t < T && c < width;
      cp_async16(d, ok ? src : x, ok ? 16 : 0);
    } else {
      for (int i = 0; i < 8; ++i)
        d[i] = t < T && c + i < width ? src[i] : __float2bfloat16(0.f);
    }
  }
}

// The key tiles [begin, end) of width bn that the query rows q0 .. q_last
// reach: causal stops at the diagonal, the window starts where the first
// row's window does (the tiles skipped are wholly masked for every row).
struct TileRange {
  int begin, end;
};
__device__ __forceinline__ TileRange key_tiles(int Tk, int causal,
                                               int window, int q0,
                                               int q_last, int bn) {
  TileRange r{0, (Tk + bn - 1) / bn};
  if (causal) r.end = min(r.end, q_last / bn + 1);
  if (window > 0) {
    const int lo = q0 - window - bn + 2;  // least k0 not wholly outside
    if (lo > 0) r.begin = (lo + bn - 1) / bn;
  }
  return r;
}

// Forward: one block per (b, h, 64 query rows); warp w owns rows
// 16 (w % 4) .. + 15 and O columns (w / 4) HD/NCG .. + HD/NCG - 1.  HD: the
// head-width bucket (D, Dv <= HD).
template <int HD, int NCG>
__global__ void __launch_bounds__(128 * NCG)
    fa_forward_tc_kernel(Params p) {
  constexpr int NT = 128 * NCG;
  constexpr int LDS = HD + 8;
  constexpr int BN = kTcFwdKeys;
  constexpr int SB = BN / 8;    // n-blocks of S
  constexpr int CW = HD / NCG;  // O columns a warp
  constexpr int NB = CW / 8;    // n-blocks of O
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + kTcRows * LDS;  // two tiles
  bf16* Vs = Ks + 2 * BN * LDS;   // two tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const int D = p.D, Dv = p.Dv;
  const bool vec = p.vec != 0;
  const int q_last = min(q0 + kTcRows, p.Tq) - 1;
  const TileRange kt = key_tiles(p.Tk, p.causal, p.window, q0, q_last, BN);

  load_rows<HD>(Qs, q, b, q0, p.Tq, p.H, h, D, kTcRows, vec, tid, NT);
  if (kt.begin < kt.end) {
    load_rows<HD>(Ks, k, b, kt.begin * BN, p.Tk, p.K, kh, D, BN, vec, tid,
                   NT);
    load_rows<HD>(Vs, v, b, kt.begin * BN, p.Tk, p.K, kh, Dv, BN, vec, tid,
                   NT);
  }
  cp_async_commit();

  float acc[NB][4];
  zero_acc(acc);
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};  // rows g, g + 8
  const int row_q = q0 + rg * 16 + g;

  for (int t = kt.begin; t < kt.end; ++t) {
    const int buf = (t - kt.begin) & 1;
    __syncthreads();  // every warp is done with the other buffer's tile
    if (t + 1 < kt.end) {
      load_rows<HD>(Ks + (buf ^ 1) * BN * LDS, k, b, (t + 1) * BN, p.Tk,
                     p.K, kh, D, BN, vec, tid, NT);
      load_rows<HD>(Vs + (buf ^ 1) * BN * LDS, v, b, (t + 1) * BN, p.Tk,
                     p.K, kh, Dv, BN, vec, tid, NT);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: Q and tile t are in
    __syncthreads();
    const bf16* Kt = Ks + buf * BN * LDS;
    const bf16* Vt = Vs + buf * BN * LDS;

    float s[SB][4];
    zero_acc(s);
    mma_abt<SB, HD>(s, Qs + rg * 16 * LDS, Kt, lane);

    // scale, softcap, mask (not on a tile that every row sees whole); the
    // running max over the quad's row
    const int k0 = t * BN;
    const bool whole = k0 + BN <= p.Tk && (!p.causal || k0 + BN - 1 <= q0) &&
                       (p.window <= 0 || q_last - k0 < p.window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nb = 0; nb < SB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row_q + (e >> 1) * 8;
        const int kpos = k0 + nb * 8 + 2 * t4 + (e & 1);
        float x = s[nb][e] * p.scale;
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        if (!whole) {
          bool ok = kpos < p.Tk;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          x = ok ? x : kNeg;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];  // this thread's share of the row sum
    }
#pragma unroll
    for (int nb = 0; nb < SB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(s[nb][e] - m_r[e >> 1]);
        s[nb][e] = pr;
        l_r[e >> 1] += pr;
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      acc[nb][0] *= corr[0];
      acc[nb][1] *= corr[0];
      acc[nb][2] *= corr[1];
      acc[nb][3] *= corr[1];
    }
    // acc += P . V, P as bf16 terms
#pragma unroll
    for (int kc = 0; kc < SB / 2; ++kc) {
      uint32_t hi[4], mid[4], lo[4];
      a_from_acc(s, kc, hi, mid, lo);
      mma_split_t<NB, LDS>(acc, hi, mid, lo, Vt, kc * 16, cg * CW,
                           lane);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  bf16* o = static_cast<bf16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row_q + r * 8;
    if (t >= p.Tq) continue;
    const float denom = fmaxf(l_r[r], 1e-37f);
    if (p.lse && t4 == 0 && cg == 0)
      p.lse[((int64_t)b * p.H + h) * p.Tq + t] = m_r[r] + logf(denom);
    const int64_t row = (((int64_t)b * p.Tq + t) * p.H + h) * Dv;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cg * CW + nb * 8 + 2 * t4 + e;
        if (col < Dv) {
          const float x = acc[nb][2 * r + e] / denom;
          o[row + col] = __float2bfloat16(x);
          if (p.o32) p.o32[row + col] = x;
        }
      }
  }
}

// How many warps share 16 rows (each holding HD / NCG columns of the
// accumulators): one where 16 rows x HD columns fit in registers, two
// where they would spill.
constexpr int fwd_ncg(int hd) { return hd > 128 ? 2 : 1; }
constexpr int dq_ncg(int hd) { return hd > 128 ? 2 : 1; }
constexpr int dkdv_ncg(int hd) { return hd > 64 ? 2 : 1; }

inline size_t tc_fwd_smem(int hd) {
  return (size_t)(kTcRows + 4 * kTcFwdKeys) * (hd + 8) * sizeof(bf16);
}
inline size_t tc_dq_smem(int hd) {
  return (size_t)(2 * kTcRows + 4 * kTcDqKeys) * (hd + 8) * sizeof(bf16) +
         2 * kTcRows * sizeof(float);
}
inline size_t tc_dkdv_smem(int hd) {
  return (size_t)(2 * kTcRows + 4 * kTcDkvQueries) * (hd + 8) *
             sizeof(bf16) +
         4 * kTcDkvQueries * sizeof(float);
}

// dQ pass: one block per (b, h, 64 query rows); warp w owns rows
// 16 (w % 4) .. + 15 and dQ columns (w / 4) HD/NCG .. + HD/NCG - 1.
template <int HD, int NCG>
__global__ void __launch_bounds__(128 * NCG)
    fa_backward_dq_tc_kernel(BwdParams p) {
  constexpr int NT = 128 * NCG;
  constexpr int LDS = HD + 8;
  constexpr int BN = kTcDqKeys;
  constexpr int SB = BN / 8;
  constexpr int CW = HD / NCG;  // dQ columns a warp
  constexpr int NB = CW / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dOs = Qs + kTcRows * LDS;
  bf16* Ks = dOs + kTcRows * LDS;  // two tiles
  bf16* Vs = Ks + 2 * BN * LDS;    // two tiles
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * BN * LDS);
  float* dl_s = lse_s + kTcRows;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const int D = p.D, Dv = p.Dv;
  const bool vec = p.vec != 0;
  const int64_t row0 = ((int64_t)b * p.H + h) * p.Tq;
  const int q_last = min(q0 + kTcRows, p.Tq) - 1;
  const TileRange kt = key_tiles(p.Tk, p.causal, p.window, q0, q_last, BN);

  load_rows<HD>(Qs, q, b, q0, p.Tq, p.H, h, D, kTcRows, vec, tid, NT);
  load_rows<HD>(dOs, dout, b, q0, p.Tq, p.H, h, Dv, kTcRows, vec, tid, NT);
  if (kt.begin < kt.end) {
    load_rows<HD>(Ks, k, b, kt.begin * BN, p.Tk, p.K, kh, D, BN, vec, tid,
                   NT);
    load_rows<HD>(Vs, v, b, kt.begin * BN, p.Tk, p.K, kh, Dv, BN, vec, tid,
                   NT);
  }
  cp_async_commit();

  // Dl = rowsum(dO * O) in f32, from dO as stored and the f32 output
  for (int r = warp; r < kTcRows; r += NT / 32) {
    const int t = q0 + r;
    float sum = 0.f;
    if (t < p.Tq) {
      const int64_t off = (((int64_t)b * p.Tq + t) * p.H + h) * Dv;
      for (int c = lane; c < Dv; c += 32)
        sum = fmaf(__bfloat162float(dout[off + c]), p.o[off + c], sum);
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
  __syncthreads();
  const int rl = rg * 16 + g;  // this thread's rows rl and rl + 8
  const float lse_r[2] = {lse_s[rl], lse_s[rl + 8]};
  const float dl_r[2] = {dl_s[rl], dl_s[rl + 8]};

  float acc[NB][4];
  zero_acc(acc);
  for (int t = kt.begin; t < kt.end; ++t) {
    const int buf = (t - kt.begin) & 1;
    __syncthreads();
    if (t + 1 < kt.end) {
      load_rows<HD>(Ks + (buf ^ 1) * BN * LDS, k, b, (t + 1) * BN, p.Tk,
                     p.K, kh, D, BN, vec, tid, NT);
      load_rows<HD>(Vs + (buf ^ 1) * BN * LDS, v, b, (t + 1) * BN, p.Tk,
                     p.K, kh, Dv, BN, vec, tid, NT);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + buf * BN * LDS;
    const bf16* Vt = Vs + buf * BN * LDS;

    float s[SB][4], dp[SB][4];
    zero_acc(s);
    zero_acc(dp);
    mma_abt<SB, HD>(s, Qs + rg * 16 * LDS, Kt, lane);
    mma_abt<SB, HD>(dp, dOs + rg * 16 * LDS, Vt, lane);

    // dS = P (dP - Dl), times 1 - tanh^2 under the softcap, into s
    const int k0 = t * BN;
    const bool whole = k0 + BN <= p.Tk && q_last + 1 == q0 + kTcRows &&
                       (!p.causal || k0 + BN - 1 <= q0) &&
                       (p.window <= 0 || q_last - k0 < p.window);
#pragma unroll
    for (int nb = 0; nb < SB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + rl + (e >> 1) * 8;
        const int kpos = k0 + nb * 8 + 2 * t4 + (e & 1);
        float x = s[nb][e] * p.scale, dtanh = 1.f;
        if (p.cap > 0.f) {
          const float th = tanhf(x / p.cap);
          x = p.cap * th;
          dtanh = 1.f - th * th;
        }
        bool ok = true;
        if (!whole) {
          ok = qpos < p.Tq && kpos < p.Tk;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
        }
        const float pr = ok ? expf(x - lse_r[e >> 1]) : 0.f;
        s[nb][e] = pr * (dp[nb][e] - dl_r[e >> 1]) * dtanh;
      }
    // dQ += dS . K, dS as bf16 terms
#pragma unroll
    for (int kc = 0; kc < SB / 2; ++kc) {
      uint32_t hi[4], mid[4], lo[4];
      a_from_acc(s, kc, hi, mid, lo);
      mma_split_t<NB, LDS>(acc, hi, mid, lo, Kt, kc * 16, cg * CW,
                           lane);
    }
  }
  cp_async_wait<0>();

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + rl + r * 8;
    if (t >= p.Tq) continue;
    bf16* out = dq + (((int64_t)b * p.Tq + t) * p.H + h) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cg * CW + nb * 8 + 2 * t4 + e;
        if (col < D) out[col] = __float2bfloat16(acc[nb][2 * r + e] * p.scale);
      }
  }
}

// dK/dV pass: one block per (b, query head h, 64 keys) looping over the
// 32-query tiles that reach its keys; warp w owns keys 16 (w % 4) .. + 15
// and columns (w / 4) HD/NCG .. + HD/NCG - 1 of dK and dV.  S^T = K . q^T
// and dP^T = V . dO^T put the keys on the rows, so P^T and dS^T are the a
// operands of dV += P^T . dO and dK += dS^T . q straight from registers.
// Writes this head's f32 partials; fa_sum_heads_kernel sums the group.
template <int HD, int NCG>
__global__ void __launch_bounds__(128 * NCG)
    fa_backward_dkdv_tc_kernel(BwdParams p) {
  constexpr int NT = 128 * NCG;
  constexpr int LDS = HD + 8;
  constexpr int BQ = kTcDkvQueries;
  constexpr int SB = BQ / 8;
  constexpr int CW = HD / NCG;
  constexpr int NB = CW / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* Vs = Ks + kTcRows * LDS;
  bf16* Qs = Vs + kTcRows * LDS;  // two tiles
  bf16* dOs = Qs + 2 * BQ * LDS;  // two tiles
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LDS);  // two
  float* dl_s = lse_s + 2 * BQ;                                  // two

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const int k0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const int D = p.D, Dv = p.Dv;
  const bool vec = p.vec != 0;
  const int64_t row0 = ((int64_t)b * p.H + h) * p.Tq;
  // the query tiles that reach these keys: causal needs q >= k0, the
  // window q - k_last < window
  const int k_last = min(k0 + kTcRows, p.Tk) - 1;
  const int qt_first = p.causal ? k0 / BQ : 0;
  int qt_end = (p.Tq + BQ - 1) / BQ;
  if (p.window > 0) {
    const int64_t q_max = (int64_t)k_last + p.window - 1;
    qt_end = (int)min((int64_t)qt_end, q_max / BQ + 1);
  }

  auto load_q_tile = [&](int buf, int qt) {
    const int q0 = qt * BQ;
    load_rows<HD>(Qs + buf * BQ * LDS, q, b, q0, p.Tq, p.H, h, D, BQ, vec,
                   tid, NT);
    load_rows<HD>(dOs + buf * BQ * LDS, dout, b, q0, p.Tq, p.H, h, Dv, BQ,
                   vec, tid, NT);
    for (int i = tid; i < BQ; i += NT) {
      const int t = q0 + i;
      const bool ok = t < p.Tq;
      cp_async4(lse_s + buf * BQ + i, ok ? p.lse + row0 + t : p.lse,
                ok ? 4 : 0);
      cp_async4(dl_s + buf * BQ + i, ok ? p.dl + row0 + t : p.dl,
                ok ? 4 : 0);
    }
  };

  load_rows<HD>(Ks, k, b, k0, p.Tk, p.K, kh, D, kTcRows, vec, tid, NT);
  load_rows<HD>(Vs, v, b, k0, p.Tk, p.K, kh, Dv, kTcRows, vec, tid, NT);
  if (qt_first < qt_end) load_q_tile(0, qt_first);
  cp_async_commit();

  float acc_k[NB][4], acc_v[NB][4];
  zero_acc(acc_k);
  zero_acc(acc_v);
  const int kl = rg * 16 + g;  // this thread's keys kl and kl + 8
  for (int qt = qt_first; qt < qt_end; ++qt) {
    const int buf = (qt - qt_first) & 1;
    __syncthreads();
    if (qt + 1 < qt_end) load_q_tile(buf ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + buf * BQ * LDS;
    const bf16* dOt = dOs + buf * BQ * LDS;
    const float* lse_t = lse_s + buf * BQ;
    const float* dl_t = dl_s + buf * BQ;

    float s[SB][4], dp[SB][4];
    zero_acc(s);
    zero_acc(dp);
    mma_abt<SB, HD>(s, Ks + rg * 16 * LDS, Qt, lane);
    mma_abt<SB, HD>(dp, Vs + rg * 16 * LDS, dOt, lane);

    // P^T into s, dS^T into dp
    const int q0 = qt * BQ;
    const bool whole = q0 + BQ <= p.Tq && k_last + 1 == k0 + kTcRows &&
                       (!p.causal || k_last <= q0) &&
                       (p.window <= 0 || q0 + BQ - 1 - k0 < p.window);
#pragma unroll
    for (int nb = 0; nb < SB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + kl + (e >> 1) * 8;
        const int ql = nb * 8 + 2 * t4 + (e & 1);
        const int qpos = q0 + ql;
        float x = s[nb][e] * p.scale, dtanh = 1.f;
        if (p.cap > 0.f) {
          const float th = tanhf(x / p.cap);
          x = p.cap * th;
          dtanh = 1.f - th * th;
        }
        bool ok = true;
        if (!whole) {
          ok = qpos < p.Tq && kpos < p.Tk;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
        }
        const float pr = ok ? expf(x - lse_t[ql]) : 0.f;
        s[nb][e] = pr;
        dp[nb][e] = pr * (dp[nb][e] - dl_t[ql]) * dtanh;
      }
    // dV += P^T . dO and dK += dS^T . q, P^T and dS^T as bf16 terms
#pragma unroll
    for (int kc = 0; kc < SB / 2; ++kc) {
      uint32_t hi[4], mid[4], lo[4];
      a_from_acc(s, kc, hi, mid, lo);
      mma_split_t<NB, LDS>(acc_v, hi, mid, lo, dOt, kc * 16, cg * CW,
                           lane);
      a_from_acc(dp, kc, hi, mid, lo);
      mma_split_t<NB, LDS>(acc_k, hi, mid, lo, Qt, kc * 16, cg * CW,
                           lane);
    }
  }
  cp_async_wait<0>();

  float* part_k = p.part;
  float* part_v = p.part + (int64_t)p.B * p.Tk * p.H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + kl + r * 8;
    if (t >= p.Tk) continue;
    const int64_t rk = (((int64_t)b * p.Tk + t) * p.H + h);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = cg * CW + nb * 8 + 2 * t4 + e;
        if (col < D) part_k[rk * D + col] = acc_k[nb][2 * r + e];
        if (col < Dv) part_v[rk * Dv + col] = acc_v[nb][2 * r + e];
      }
  }
}

// dk = bf16(scale sum_g part_k), dv = bf16(sum_g part_v) over the G query
// heads of each KV head, g = 0 .. G-1 in order.
__global__ void fa_sum_heads_kernel(const float* __restrict__ part,
                                    bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, int B, int Tk,
                                    int H, int K, int D, int Dv,
                                    float scale) {
  const int G = H / K;
  const int64_t nk = (int64_t)B * Tk * K * D;
  const int64_t n = nk + (int64_t)B * Tk * K * Dv;
  const float* part_v = part + (int64_t)B * Tk * H * D;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool is_k = i < nk;
    const int64_t j = is_k ? i : i - nk;  // ((b, t), kh, c)
    const int w = is_k ? D : Dv;
    const int64_t r = j / w;
    const int c = (int)(j - r * w);
    const int64_t bt = r / K;
    const int kh = (int)(r - bt * K);
    const float* src = (is_k ? part : part_v) + (bt * H + (int64_t)kh * G) * w + c;
    float sum = 0.f;
    for (int gg = 0; gg < G; ++gg) sum += src[(int64_t)gg * w];
    if (is_k)
      dk[j] = __float2bfloat16(sum * scale);
    else
      dv[j] = __float2bfloat16(sum);
  }
}

inline int head_bucket(int D, int Dv) {
  const int d = D > Dv ? D : Dv;
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

template <int HD>
cudaError_t launch_fwd_tc(const Params& p, cudaStream_t stream) {
  constexpr int NCG = fwd_ncg(HD);
  const size_t bytes = tc_fwd_smem(HD);
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward_tc_kernel<HD, NCG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + kTcRows - 1) / kTcRows, p.H, p.B);
  fa_forward_tc_kernel<HD, NCG><<<grid, 128 * NCG, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t run_fwd_tc(const Params& p, cudaStream_t s) {
  switch (head_bucket(p.D, p.Dv)) {
    case 64: return launch_fwd_tc<64>(p, s);
    case 128: return launch_fwd_tc<128>(p, s);
    default: return launch_fwd_tc<256>(p, s);
  }
}

template <int HD>
cudaError_t launch_bwd_tc(const BwdParams& p, bool dq_pass,
                          cudaStream_t stream) {
  if (dq_pass) {
    constexpr int NCG = dq_ncg(HD);
    const size_t bytes = tc_dq_smem(HD);
    cudaError_t err = cudaFuncSetAttribute(
        fa_backward_dq_tc_kernel<HD, NCG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Tq + kTcRows - 1) / kTcRows, p.H, p.B);
    fa_backward_dq_tc_kernel<HD, NCG><<<grid, 128 * NCG, bytes, stream>>>(p);
    return cudaGetLastError();
  }
  if (p.part == nullptr) return cudaErrorInvalidValue;
  constexpr int NCG = dkdv_ncg(HD);
  const size_t bytes = tc_dkdv_smem(HD);
  cudaError_t err = cudaFuncSetAttribute(
      fa_backward_dkdv_tc_kernel<HD, NCG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tk + kTcRows - 1) / kTcRows, p.H, p.B);
  fa_backward_dkdv_tc_kernel<HD, NCG><<<grid, 128 * NCG, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = (int64_t)p.B * p.Tk * p.K * (p.D + p.Dv);
  const int64_t blocks = (n + 255) / 256;
  fa_sum_heads_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                        stream>>>(p.part, static_cast<bf16*>(p.dk),
                                  static_cast<bf16*>(p.dv), p.B, p.Tk, p.H,
                                  p.K, p.D, p.Dv, p.scale);
  return cudaGetLastError();
}

cudaError_t run_bwd_tc(const BwdParams& p, bool dq_pass, cudaStream_t s) {
  switch (head_bucket(p.D, p.Dv)) {
    case 64: return launch_bwd_tc<64>(p, dq_pass, s);
    case 128: return launch_bwd_tc<128>(p, dq_pass, s);
    default: return launch_bwd_tc<256>(p, dq_pass, s);
  }
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

inline bool bad_shape(int B, int Tq, int Tk, int H, int K, int D, int Dv) {
  return B < 1 || Tq < 1 || Tk < 1 || K < 1 || H < K || H % K != 0 ||
         D < 1 || D > kMaxHead || Dv < 1 || Dv > kMaxHead || H > 65535 ||
         B > 65535;
}

// f32 and f16 take the CUDA-core kernels, bf16 the tensor-core kernels
cudaError_t run_bwd(const BwdParams& p, int dtype, bool dq_pass,
                    cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_bwd_d<float>(p, dq_pass, s);
    case 1: return run_bwd_tc(p, dq_pass, s);
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
  Params p{q, k,  v,  o,     lse,    o32,    B,  Tq, Tk,
           H, K,  D,  Dv,    scale,  causal, window, cap};
  p.vec = D % 8 == 0 && Dv % 8 == 0 && aligned16(q) && aligned16(k) &&
          aligned16(v);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dv<float>(p, s); break;
    case 1: err = run_fwd_tc(p, s); break;
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
  BwdParams p{q,  k,  v,  o,  dout,  lse,    dl,     dq,  nullptr,
              nullptr, B, Tq, Tk, H, K, D, Dv, scale, causal, window,
              cap};
  p.vec = D % 8 == 0 && Dv % 8 == 0 && aligned16(q) && aligned16(k) &&
          aligned16(v) && aligned16(dout);
  return static_cast<int>(run_bwd(p, dtype, true,
                                  static_cast<cudaStream_t>(stream)));
}

// The backward's second pass, after the first on the same stream: dk
// (B,Tk,K,D) and dv (B,Tk,K,Dv).  part: for bf16, f32 scratch of
// B*Tk*H*(D+Dv) values for the per-head partials (null for f32 and f16).
int fa_backward_dkdv(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* dl,
                     void* dk, void* dv, float* part, int B, int Tq, int Tk,
                     int H, int K, int D, int Dv, float scale, int causal,
                     int window, float cap, int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, K, D, Dv))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q,  k,  v,  nullptr, dout, lse, const_cast<float*>(dl),
              nullptr, dk, dv, B, Tq, Tk, H, K, D, Dv, scale, causal,
              window, cap};
  p.part = part;
  p.vec = D % 8 == 0 && Dv % 8 == 0 && aligned16(q) && aligned16(k) &&
          aligned16(v) && aligned16(dout);
  return static_cast<int>(run_bwd(p, dtype, false,
                                  static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
