// Hand-written Hopper kernels for the checkpoint mask path (K1-K5).
//
// Built by repro_torch/kernels/mask_pack/kernel.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/repro_torch/mask_pack-<hash>.so mask_pack.cu
// and loaded with ctypes.  Every entry point takes raw pointers and the
// caller's CUDA stream, launches on that stream, never synchronises and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// All five kernels move bytes and never do arithmetic on the values they
// move, so they are exact for every dtype (templated on the element width:
// 1, 2, 4, 8 or 16 bytes) and for non-finite values.  The TPU versions
// compacted with a 0/1 permutation matmul, where a single inf or NaN in a
// tile poisons every output of that tile (0 * inf = NaN); nothing here can.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

struct alignas(16) U128 {
  unsigned long long lo, hi;
};

constexpr int kBitpackTile = 1024;  // K1 tile (BITPACK_BLOCK)
constexpr int kTile = 512;          // K2/K4 tile (BLOCK)
constexpr int kDeltaThreads = 128;  // K3: 128 x 16 B = one 2048-byte chunk

// ---------------------------------------------------------------------------
// K1  threshold + bit-pack
// Replaces kernels/mask_pack/kernel.py:bitpack_blocks_kernel (_bitpack_kernel).
// Bound: bytes.  It reads 4 or 8 bytes per element and writes 1/8 byte, so
// at 3.35 TB/s the read of the magnitudes is the whole cost.  Design: one
// thread per element, coalesced loads; a warp ballot yields 32 mask bits
// with lane 0 in the LSB, __brev + __byte_perm turn them into four
// np.packbits-order bytes stored as one 32-bit word; the per-tile count is
// __popc per warp summed by warp 0 from shared memory.  Bits past N are 0
// (no -inf pad pass), and NaN is never > tol, so its bit is 0.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kBitpackTile)
bitpack_kernel(const T* __restrict__ mag, T tol, long long n,
               uint32_t* __restrict__ words, int32_t* __restrict__ counts) {
  __shared__ int warp_count[kBitpackTile / 32];
  const long long tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = tile * kBitpackTile + threadIdx.x;
  const bool bit = i < n && mag[i] > tol;
  const unsigned ballot = __ballot_sync(0xffffffffu, bit);
  const long long base = tile * kBitpackTile + warp * 32;
  if (lane == 0) {
    if (base < n) words[base >> 5] = __byte_perm(__brev(ballot), 0, 0x0123);
    warp_count[warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {
    int c = warp_count[lane];
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0) counts[tile] = c;
  }
}

// ---------------------------------------------------------------------------
// Shared by K2 and K4: critical elements per 512-element tile of a byte mask.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kTile)
tile_counts_kernel(const uint8_t* __restrict__ mask, long long n,
                   int32_t* __restrict__ counts) {
  __shared__ int warp_count[kTile / 32];
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool m = i < n && mask[i] != 0;
  const unsigned b = __ballot_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = __popc(b);
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < kTile / 32; ++w) c += warp_count[w];
    counts[blockIdx.x] = c;
  }
}

// In-tile exclusive scan of the mask (K2, K4, K5): the slot of this
// thread's element among the critical elements of its tile (ballot + popc
// within the warp, a 16-entry shared prefix across warps).
__device__ __forceinline__ int tile_slot(bool m, int* warp_count) {
  const unsigned b = __ballot_sync(0xffffffffu, m);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_count[warp] = __popc(b);
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_count[w];
  return before + __popc(b & ((1u << lane) - 1u));
}

// ---------------------------------------------------------------------------
// K2  pack (left-compaction of critical elements)
// Replaces kernels/mask_pack/kernel.py:pack_blocks_kernel (_pack_kernel)
// and fuses the inter-tile gather of ref.py:gather_payload_ref.
// Bound: bytes.  It reads every mask byte, loads a value only where the
// mask is set (so only the 32-byte sectors that hold a critical value
// must come from memory), and writes only the critical values.  Design: the tile's destination ``starts[tile]``
// comes from an exclusive scan of tile_counts_kernel's counts (taken by
// the wrapper); each critical element finds its slot by an in-tile scan
// and is stored straight at starts[tile] + slot, so one launch writes the
// dense payload (starts[tile] = tile*512 gives the tiled, zero-tailed
// form).  No matmul, no intermediate tiled buffer.  Stores past ``cap``
// are dropped, so an inconsistent count can never write out of bounds.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void __launch_bounds__(kTile)
pack_kernel(const W* __restrict__ src, const uint8_t* __restrict__ mask,
            long long n, const long long* __restrict__ starts,
            W* __restrict__ dst, long long cap) {
  __shared__ int warp_count[kTile / 32];
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool m = i < n && mask[i] != 0;
  const int slot = tile_slot(m, warp_count);
  if (m) {
    const long long d = starts[blockIdx.x] + slot;
    if (d < cap) dst[d] = src[i];
  }
}

// ---------------------------------------------------------------------------
// K3  delta flags
// Replaces kernels/mask_pack/kernel.py:delta_blocks_kernel (_delta_kernel).
// Bound: bytes.  It reads both payloads once and writes one byte per
// 2048-byte chunk.  Design: one block per chunk, 128 threads each compare
// one 16-byte vector (uint4) when both pointers and the chunk size are
// 16-byte aligned, bytes otherwise (a leaf's payload slice inside a dtype
// group may start anywhere); __syncthreads_or reduces the block.  The tail
// chunk is bounds-checked: its missing part counts as equal.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kDeltaThreads)
delta_kernel(const uint8_t* __restrict__ curr,
             const uint8_t* __restrict__ base, long long nbytes,
             long long chunk, int8_t* __restrict__ flags) {
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < nbytes ? lo + chunk : nbytes;
  const bool aligned = ((reinterpret_cast<uintptr_t>(curr) |
                         reinterpret_cast<uintptr_t>(base) |
                         static_cast<uintptr_t>(chunk)) & 15u) == 0;
  int diff = 0;
  for (long long off = lo + 16LL * threadIdx.x; off < hi;
       off += 16LL * blockDim.x) {
    if (aligned && off + 16 <= hi) {
      const uint4 a = *reinterpret_cast<const uint4*>(curr + off);
      const uint4 b = *reinterpret_cast<const uint4*>(base + off);
      diff |= (a.x != b.x) | (a.y != b.y) | (a.z != b.z) | (a.w != b.w);
    } else {
      const long long e = off + 16 < hi ? off + 16 : hi;
      for (long long k = off; k < e; ++k) diff |= curr[k] != base[k];
    }
  }
  diff = __syncthreads_or(diff);
  if (threadIdx.x == 0) flags[blockIdx.x] = diff ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K4  mask scatter (fused restore expand)
// Replaces kernels/mask_pack/kernel.py:scatter_blocks_kernel
// (_scatter_kernel).
// Bound: bytes.  It reads the mask and the critical payload once and
// writes every output element once.  Design: the same tile counts + scan
// as K2 give each tile's payload start; the in-tile scan gives the slot;
// each thread writes mask ? payload[start + slot] : fill.  No two-block
// window or matmul: every output is a load or the fill bytes.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void __launch_bounds__(kTile)
scatter_kernel(const W* __restrict__ payload, long long total,
               const uint8_t* __restrict__ mask, long long n,
               const long long* __restrict__ starts, W fill,
               W* __restrict__ out) {
  __shared__ int warp_count[kTile / 32];
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool m = i < n && mask[i] != 0;
  const int slot = tile_slot(m, warp_count);
  if (i < n) {
    W v = fill;
    if (m) {
      long long s = starts[blockIdx.x] + slot;
      if (s > total - 1) s = total - 1;
      v = payload[s];
    }
    out[i] = v;
  }
}

// ---------------------------------------------------------------------------
// K5  unpack (the inverse of the tiled K2)
// Replaces kernels/mask_pack/kernel.py:unpack_blocks_kernel (_unpack_kernel).
// Bound: bytes.  It reads every mask byte and the critical prefix of each
// packed tile once and writes every output element once.  Design: K4
// without the count pass: tile i's values start at packed[i * 512], so
// the in-tile scan alone gives each critical element its source; each
// thread writes mask ? packed[tile * 512 + slot] : fill.  The TPU kernel
// unpacked with the transposed 0/1 permutation matmul, so one non-finite
// critical value poisoned its tile (0 * inf = NaN); a load cannot.  The
// ragged last tile is masked here (i < n), with no padded copy.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void __launch_bounds__(kTile)
unpack_kernel(const W* __restrict__ packed, const uint8_t* __restrict__ mask,
              long long n, W fill, W* __restrict__ out) {
  __shared__ int warp_count[kTile / 32];
  const long long base = (long long)blockIdx.x * kTile;
  const long long i = base + threadIdx.x;
  const bool m = i < n && mask[i] != 0;
  const int slot = tile_slot(m, warp_count);
  if (i < n) out[i] = m ? packed[base + slot] : fill;
}

inline unsigned grid_for(long long n, int tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

template <typename W>
W fill_from(unsigned long long lo, unsigned long long hi) {
  unsigned long long buf[2] = {lo, hi};
  W w;
  std::memcpy(&w, buf, sizeof(W));
  return w;
}

template <typename W>
void launch_pack(const void* src, const uint8_t* mask, long long n,
                 const long long* starts, void* dst, long long cap,
                 cudaStream_t s) {
  pack_kernel<W><<<grid_for(n, kTile), kTile, 0, s>>>(
      static_cast<const W*>(src), mask, n, starts, static_cast<W*>(dst), cap);
}

template <typename W>
void launch_scatter(const void* payload, long long total, const uint8_t* mask,
                    long long n, const long long* starts,
                    unsigned long long fill_lo, unsigned long long fill_hi,
                    void* out, cudaStream_t s) {
  scatter_kernel<W><<<grid_for(n, kTile), kTile, 0, s>>>(
      static_cast<const W*>(payload), total, mask, n, starts,
      fill_from<W>(fill_lo, fill_hi), static_cast<W*>(out));
}

template <typename W>
void launch_unpack(const void* packed, const uint8_t* mask, long long n,
                   unsigned long long fill_lo, unsigned long long fill_hi,
                   void* out, cudaStream_t s) {
  unpack_kernel<W><<<grid_for(n, kTile), kTile, 0, s>>>(
      static_cast<const W*>(packed), mask, n, fill_from<W>(fill_lo, fill_hi),
      static_cast<W*>(out));
}

}  // namespace

extern "C" {

int mp_bitpack_f32(const float* mag, float tol, long long n, uint32_t* words,
                   int32_t* counts, void* stream) {
  if (n > 0)
    bitpack_kernel<float><<<grid_for(n, kBitpackTile), kBitpackTile, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        mag, tol, n, words, counts);
  return static_cast<int>(cudaGetLastError());
}

int mp_bitpack_f64(const double* mag, double tol, long long n,
                   uint32_t* words, int32_t* counts, void* stream) {
  if (n > 0)
    bitpack_kernel<double><<<grid_for(n, kBitpackTile), kBitpackTile, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        mag, tol, n, words, counts);
  return static_cast<int>(cudaGetLastError());
}

int mp_tile_counts(const uint8_t* mask, long long n, int32_t* counts,
                   void* stream) {
  if (n > 0)
    tile_counts_kernel<<<grid_for(n, kTile), kTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(mask, n, counts);
  return static_cast<int>(cudaGetLastError());
}

int mp_pack(const void* src, const uint8_t* mask, long long n,
            const long long* starts, void* dst, long long cap, int itemsize,
            void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: launch_pack<uint8_t>(src, mask, n, starts, dst, cap, s); break;
    case 2: launch_pack<uint16_t>(src, mask, n, starts, dst, cap, s); break;
    case 4: launch_pack<uint32_t>(src, mask, n, starts, dst, cap, s); break;
    case 8: launch_pack<unsigned long long>(src, mask, n, starts, dst, cap, s);
      break;
    case 16: launch_pack<U128>(src, mask, n, starts, dst, cap, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int mp_delta_flags(const uint8_t* curr, const uint8_t* base, long long nbytes,
                   long long chunk, int8_t* flags, void* stream) {
  if (nbytes > 0)
    delta_kernel<<<grid_for(nbytes, static_cast<int>(chunk)), kDeltaThreads,
                   0, static_cast<cudaStream_t>(stream)>>>(
        curr, base, nbytes, chunk, flags);
  return static_cast<int>(cudaGetLastError());
}

int mp_mask_scatter(const void* payload, long long total, const uint8_t* mask,
                    long long n, const long long* starts,
                    unsigned long long fill_lo, unsigned long long fill_hi,
                    void* out, int itemsize, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: launch_scatter<uint8_t>(payload, total, mask, n, starts, fill_lo,
                                    fill_hi, out, s); break;
    case 2: launch_scatter<uint16_t>(payload, total, mask, n, starts, fill_lo,
                                     fill_hi, out, s); break;
    case 4: launch_scatter<uint32_t>(payload, total, mask, n, starts, fill_lo,
                                     fill_hi, out, s); break;
    case 8: launch_scatter<unsigned long long>(payload, total, mask, n, starts,
                                               fill_lo, fill_hi, out, s);
      break;
    case 16: launch_scatter<U128>(payload, total, mask, n, starts, fill_lo,
                                  fill_hi, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int mp_unpack(const void* packed, const uint8_t* mask, long long n,
              unsigned long long fill_lo, unsigned long long fill_hi,
              void* out, int itemsize, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: launch_unpack<uint8_t>(packed, mask, n, fill_lo, fill_hi, out, s);
      break;
    case 2: launch_unpack<uint16_t>(packed, mask, n, fill_lo, fill_hi, out, s);
      break;
    case 4: launch_unpack<uint32_t>(packed, mask, n, fill_lo, fill_hi, out, s);
      break;
    case 8: launch_unpack<unsigned long long>(packed, mask, n, fill_lo,
                                              fill_hi, out, s); break;
    case 16: launch_unpack<U128>(packed, mask, n, fill_lo, fill_hi, out, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
