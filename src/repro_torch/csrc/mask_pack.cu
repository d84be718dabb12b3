// Hand-written Hopper kernels for the checkpoint mask path (K1-K5, K8).
//
// Built by repro_torch/kernels/mask_pack/kernel.py at first use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/repro_torch/mask_pack-<hash>.so mask_pack.cu
// and loaded with ctypes.  Every entry point takes raw pointers and the
// caller's CUDA stream, launches on that stream, never synchronises and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// K1-K5 move bytes and never do arithmetic on the values they move, so
// they are exact for every dtype (templated on the element width: 1, 2, 4,
// 8 or 16 bytes) and for non-finite values.  The TPU versions
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

// Four packbits-order bytes, loaded as a little-endian word, in lane order:
// bit l is element 32g + l, and back (it is its own inverse).  __brev
// reverses the byte order and the bits within each byte, the byte permute
// restores the byte order, so the pair reverses the bits within each byte.
__device__ __forceinline__ uint32_t lane_order(uint32_t w) {
  return __byte_perm(__brev(w), 0, 0x0123);
}

// ---------------------------------------------------------------------------
// K1  threshold + bit-pack
// Replaces kernels/mask_pack/kernel.py:bitpack_blocks_kernel (_bitpack_kernel).
// Bound: bytes.  It reads 4 or 8 bytes per element and writes 1/8 byte plus
// 4 B per 1024 elements, so the read of the magnitudes is the whole cost:
// 0.66 ms for 2^29 f32 at 3.35 TB/s.  To cover about 1 us of DRAM latency
// at that rate the card must hold about 3.4 MB of loads in flight (Little's
// law); one 4-byte load a thread, with every thread of the card resident,
// holds 1.1 MB.
// Design: one warp owns a 1024-element tile and walks the tiles grid-stride
// (8 warps a block, no barrier, as many blocks as the card holds at once).
// A tile is 8 chunks of 128 elements; in chunk j lane l holds elements
// 128j + 4l .. 128j + 4l + 3, one 16-byte load (f32) or two (f64), so each
// load instruction of the warp is 512 contiguous bytes, and all of a tile's
// loads (128 B a lane in f32, 256 B in f64) are issued before any is used.
// Bit mapping: chunk j gives four ballots, bit l of ballot c being element
// 128j + 4l + c > tol.  Lane l writes word l of the tile, elements
// 32l .. 32l + 31 (chunk j = l / 4, group g = l % 4, ballot lanes
// 8g .. 8g + 7): it takes byte g of each of chunk j's four ballots and
// interleaves them, bit 4i + c of the word = bit i of byte g of ballot c,
// which puts element 32l + b at bit b (lane order); lane_order() turns that
// into np.packbits order (element 8k the MSB of byte k), stored as one
// 32-bit word, so a tile's 128 mask bytes are one coalesced store.  The
// tile's count is the popcount of its 32 ballots, the same on every lane:
// no shuffle and no shared memory.
// Edges: the ragged last tile, and a magnitude pointer that is not 16-byte
// aligned (ops.threshold_bitpack takes views, and no copy is made: the
// whole launch then takes the unaligned variant), read the same elements
// with 4- or 8-byte loads, guarded; an element past N reads as NaN.  NaN is
// never > tol, so NaN's bit and the tail bits are 0.
// ---------------------------------------------------------------------------
constexpr int kBitpackWarps = 8;                      // tiles a block walks at once
constexpr int kBitpackThreads = 32 * kBitpackWarps;
constexpr int kBitpackChunks = kBitpackTile / 128;    // 4 elements a lane each

// Bit i of an 8-bit x to bit 4i.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// mag[e .. e + 3], e a multiple of 4 and mag 16-byte aligned: streaming
// 16-byte loads (read once, so they need not stay in the caches).
__device__ __forceinline__ void load_quad(const float* mag, long long e,
                                          float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(mag + e));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_quad(const double* mag, long long e,
                                          double (&v)[4]) {
  const double2 p = __ldcs(reinterpret_cast<const double2*>(mag + e));
  const double2 q = __ldcs(reinterpret_cast<const double2*>(mag + e + 2));
  v[0] = p.x; v[1] = p.y; v[2] = q.x; v[3] = q.y;
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kBitpackThreads)
bitpack_kernel(const T* __restrict__ mag, T tol, long long n,
               uint32_t* __restrict__ words, int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long tiles = (n + kBitpackTile - 1) / kBitpackTile;
  const long long nwords = (n + 31) >> 5;
  const long long stride = (long long)gridDim.x * kBitpackWarps;
  for (long long tile = (long long)blockIdx.x * kBitpackWarps +
                        (threadIdx.x >> 5);
       tile < tiles; tile += stride) {
    const long long e0 = tile * kBitpackTile + 4 * lane;
    T v[kBitpackChunks][4];
    if (kAligned && (tile + 1) * kBitpackTile <= n) {
#pragma unroll
      for (int j = 0; j < kBitpackChunks; ++j)
        load_quad(mag, e0 + 128 * j, v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kBitpackChunks; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const long long e = e0 + 128 * j + c;
          v[j][c] = e < n ? mag[e] : quiet_nan<T>();
        }
    }
    uint32_t mine[4] = {0u, 0u, 0u, 0u};  // chunk lane / 4's ballots
    int count = 0;
#pragma unroll
    for (int j = 0; j < kBitpackChunks; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t b = __ballot_sync(0xffffffffu, v[j][c] > tol);
        count += __popc(b);
        if (j == (lane >> 2)) mine[c] = b;
      }
    const int g = 8 * (lane & 3);
    uint32_t bits = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) bits |= spread4((mine[c] >> g) & 0xffu) << c;
    if (tile * 32 + lane < nwords) words[tile * 32 + lane] = lane_order(bits);
    if (lane == 0) counts[tile] = count;
  }
}

// ---------------------------------------------------------------------------
// K2 and K4 read the mask as np.packbits words, the ceil(N/8) bytes that K1
// writes and a checkpoint's bitmap stores: element 8k is the MSB of byte k.
// A 512-element tile is 64 bytes, 16 groups of 32 elements, one 32-bit word
// each.  The wrappers hand over a 16-byte aligned words pointer.
// ---------------------------------------------------------------------------
constexpr int kGroups = kTile / 32;   // 32-element groups per tile
constexpr int kCountThreads = 256;    // count pass: 16 B (128 elements) each
constexpr int kMoveThreads = 256;     // move passes: one warp per tile

// The four word bytes of elements [e0, e0 + 32), e0 a multiple of 32, as
// loaded (packbits order).  A word inside the mask is one aligned 4-byte
// load; the ragged last word is read byte by byte, so nothing past the
// ceil(n/8) bytes is read.
__device__ __forceinline__ uint32_t group_word(
    const uint8_t* __restrict__ words, long long e0, long long n) {
  if (e0 >= n) return 0u;
  if (e0 + 32 <= n)
    return *reinterpret_cast<const uint32_t*>(words + (e0 >> 3));
  const long long nbytes = (n + 7) >> 3;
  uint32_t w = 0;
  int shift = 0;
  for (long long k = e0 >> 3; k < nbytes; ++k, shift += 8)
    w |= static_cast<uint32_t>(words[k]) << shift;
  return w;
}

// group_word's bytes as lane-order bits; bits at or past n are 0 whatever
// the words hold there.
__device__ __forceinline__ uint32_t group_bits(uint32_t word, long long e0,
                                               long long n) {
  const uint32_t b = lane_order(word);
  return e0 + 32 <= n ? b : e0 < n ? b & ((1u << (n - e0)) - 1u) : 0u;
}

// ---------------------------------------------------------------------------
// K2/K4 count pass: critical elements per 512-element tile, from the words.
// Replaces the byte-mask tile_counts_kernel: it reads N/8 bytes, not N.
// Bound: bytes, the words read once and 4 B per tile written.  Design:
// each thread pops one 16-byte vector (128 elements: a count needs no bit
// order), four neighbouring lanes sum a tile with two shuffles.  The ragged
// end is read byte by byte and the last byte's bits past n are taken off.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kCountThreads)
word_counts_kernel(const uint8_t* __restrict__ words, long long n,
                   int32_t* __restrict__ counts) {
  const long long nbytes = (n + 7) >> 3;
  const long long b0 =
      ((long long)blockIdx.x * kCountThreads + threadIdx.x) * 16;
  int c = 0;
  if (b0 + 16 <= nbytes) {
    const uint4 v = *reinterpret_cast<const uint4*>(words + b0);
    c = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  } else {
    for (long long k = b0; k < nbytes; ++k) c += __popc(words[k]);
  }
  if ((n & 7) && b0 < nbytes && nbytes <= b0 + 16)
    c -= __popc(words[nbytes - 1] & ((1u << (8 - (n & 7))) - 1u));
  c += __shfl_down_sync(0xffffffffu, c, 2);
  c += __shfl_down_sync(0xffffffffu, c, 1);
  const long long tile = b0 >> 6;                  // 64 bytes per tile
  if ((threadIdx.x & 3) == 0 && tile * kTile < n) counts[tile] = c;
}

// A warp's view of the tile at element e0, from lane g's group_word (lanes
// 0-15): lane g gets group g's lane-order bits and the tile's critical
// elements before group g (a shuffle scan).  Returns the tile's count, on
// every lane.
__device__ __forceinline__ int tile_groups(uint32_t word, long long e0,
                                           long long n, int lane,
                                           uint32_t* bits, int* before) {
  const uint32_t b = lane < kGroups ? group_bits(word, e0 + 32 * lane, n)
                                    : 0u;
  int incl = __popc(b);
  for (int off = 1; off < kGroups; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  *bits = b;
  *before = incl - __popc(b);
  return __shfl_sync(0xffffffffu, incl, kGroups - 1);
}

// What a warp loads for tile t before it can move any value: lanes 0-15
// the tile's words, every lane its start (ends[t] - counts[t] for the
// dense payload, t * 512 tiled).  The move loops load tile t + stride's
// right after issuing tile t's value loads, so both latencies overlap.
struct TileHead {
  uint32_t word;
  long long start;
};

__device__ __forceinline__ TileHead tile_head(
    const uint8_t* __restrict__ words, long long n,
    const int32_t* __restrict__ counts, const long long* __restrict__ ends,
    long long t, int lane) {
  TileHead h{0u, t * kTile};
  if (lane < kGroups) h.word = group_word(words, t * kTile + 32 * lane, n);
  if (ends != nullptr) h.start = ends[t] - counts[t];
  return h;
}

// K4's move works in 16-byte lanes: per step a lane covers kE =
// 16 / sizeof(W) consecutive elements (4 f32, 16 bool), so a warp covers
// 512 bytes and a tile takes kSteps = 16 / kE steps.  Lane16 holds them
// as one 16-byte vector.
template <typename W>
struct Lane16 {
  static constexpr int kE = 16 / static_cast<int>(sizeof(W));
  static constexpr int kSteps = kTile / (32 * kE);
  union {
    uint4 u;
    W x[kE];
  };
};

// Step c's span for this lane: its kE mask bits (bit k: element r0 + k of
// the tile) and the payload rank of its first critical element.
struct Span {
  int r0;            // first element, in the tile
  uint32_t mine;     // its kE bits
  long long rank;    // start + critical elements of the tile before r0
};

template <int kE>
__device__ __forceinline__ Span lane_span(int c, int lane, uint32_t bits,
                                          int before, long long start) {
  const int r0 = (32 * c + lane) * kE;
  const uint32_t w = __shfl_sync(0xffffffffu, bits, r0 >> 5);
  const int b = __shfl_sync(0xffffffffu, before, r0 >> 5);
  const int off = r0 & 31;
  return Span{r0, (w >> off) & ((1u << kE) - 1u),
              start + b + __popc(w & ((1u << off) - 1u))};
}

// ---------------------------------------------------------------------------
// K2  pack (left-compaction of critical elements), from the words
// Replaces kernels/mask_pack/kernel.py:pack_blocks_kernel (_pack_kernel)
// and fuses the inter-tile gather of ref.py:gather_payload_ref.
// Bound: bytes.  It reads the N/8 words, loads a value only where its bit
// is set (only the 32-byte sectors that hold a critical value must come
// from memory) and writes the critical values once.  The byte-mask design
// before it read N mask bytes twice and ran one element per thread with a
// __syncthreads and a serial 16-warp prefix per 512-element block.
// Design: warp-cooperative compaction.  A warp owns a whole tile at a time
// (grid-stride over the tiles, as many blocks as fit on the card).  Lanes
// 0-15 load the tile's 16 words (64 B) and scan their counts with
// shuffles: no shared memory, no __syncthreads.  For each group its word
// is broadcast, lane l loads src[e0 + 32g + l] only if bit l is set, and
// stores it at start + before[g] + popc(word & lanes below l), so a
// group's critical values leave as one contiguous run.  The 16 groups'
// loads are issued before any store, to keep bytes in flight, and then
// the next tile's words and start (TileHead), so a warp waits on one
// memory latency per tile, not two.  (16-byte loads per lane, tried on
// the card, gained nothing once the stores were made contiguous again.)
// The tile's start is ends[t] - counts[t] (ends: the inclusive scan of the
// count pass, taken by the wrapper) for the dense payload, or t * 512 for
// the tiled, zero-tailed form, which needs no count pass (no ``ends``: the
// kernel writes the tile counts itself).  Stores past ``cap`` are dropped,
// so an inconsistent count can never write out of bounds.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void __launch_bounds__(kMoveThreads)
pack_kernel(const W* __restrict__ src, const uint8_t* __restrict__ words,
            long long n, const int32_t* __restrict__ counts,
            const long long* __restrict__ ends, W* __restrict__ dst,
            long long cap, int32_t* __restrict__ tile_counts) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long warps = (long long)gridDim.x * (kMoveThreads / 32);
  long long t = ((long long)blockIdx.x * kMoveThreads + threadIdx.x) >> 5;
  TileHead next = t < tiles ? tile_head(words, n, counts, ends, t, lane)
                            : TileHead{0u, 0};
  for (; t < tiles; t += warps) {
    const long long e0 = t * kTile;
    const long long start = next.start;
    uint32_t bits;
    int before;
    const int count = tile_groups(next.word, e0, n, lane, &bits, &before);
    W v[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const uint32_t b = __shfl_sync(0xffffffffu, bits, g);
      if (b >> lane & 1u) v[g] = src[e0 + 32 * g + lane];
    }
    if (t + warps < tiles)
      next = tile_head(words, n, counts, ends, t + warps, lane);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const uint32_t b = __shfl_sync(0xffffffffu, bits, g);
      const int off = __shfl_sync(0xffffffffu, before, g);
      if (b >> lane & 1u) {
        const long long d = start + off + __popc(b & below);
        if (d < cap) dst[d] = v[g];
      }
    }
    if (ends == nullptr && lane == 0) tile_counts[t] = count;
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
// K4  mask scatter (fused restore expand), from the words
// Replaces kernels/mask_pack/kernel.py:scatter_blocks_kernel
// (_scatter_kernel).
// Bound: bytes.  It reads the N/8 words and the critical payload once and
// writes every output element once.  The byte-mask design before it read N
// mask bytes twice, one element per thread with a block-wide scan.
// Design: the inverse of K2's move, with the same count pass, ends,
// 16-byte lanes and prefetched tile heads.  A warp owns a tile; each step a
// lane fills 16 bytes of elements, payload[start + before[g] + rank] where
// the bit is set (a contiguous run of the payload per step) and ``fill``
// elsewhere, and writes them with one 16-byte store, so a warp's store is
// 512 contiguous bytes (the ragged end element by element; the output is a
// fresh, aligned tensor).  A critical position past the payload's end
// reads its last element (total - 1, the reference's clip).  No two-block
// window or matmul: every output is a load or the fill bytes.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void __launch_bounds__(kMoveThreads)
scatter_kernel(const W* __restrict__ payload, long long total,
               const uint8_t* __restrict__ words, long long n,
               const int32_t* __restrict__ counts,
               const long long* __restrict__ ends, W fill,
               W* __restrict__ out) {
  using L = Lane16<W>;
  const int lane = threadIdx.x & 31;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long warps = (long long)gridDim.x * (kMoveThreads / 32);
  long long t = ((long long)blockIdx.x * kMoveThreads + threadIdx.x) >> 5;
  TileHead next = t < tiles ? tile_head(words, n, counts, ends, t, lane)
                            : TileHead{0u, 0};
  for (; t < tiles; t += warps) {
    const long long e0 = t * kTile;
    uint32_t bits;
    int before;
    tile_groups(next.word, e0, n, lane, &bits, &before);
    L v[L::kSteps];
#pragma unroll
    for (int c = 0; c < L::kSteps; ++c) {
      const Span sp = lane_span<L::kE>(c, lane, bits, before, next.start);
      long long s = sp.rank;
#pragma unroll
      for (int k = 0; k < L::kE; ++k) {
        v[c].x[k] = fill;
        if (sp.mine >> k & 1u) {
          v[c].x[k] = payload[s < total - 1 ? s : total - 1];
          ++s;
        }
      }
    }
    if (t + warps < tiles)
      next = tile_head(words, n, counts, ends, t + warps, lane);
#pragma unroll
    for (int c = 0; c < L::kSteps; ++c) {
      const long long e = e0 + (32 * c + lane) * L::kE;
      if (e + L::kE <= n) {
        *reinterpret_cast<uint4*>(out + e) = v[c].u;
      } else {
#pragma unroll
        for (int k = 0; k < L::kE; ++k)
          if (e + k < n) out[e + k] = v[c].x[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5  unpack (the inverse of the tiled K2), from the words, a group of
// leaves in one launch
// Replaces kernels/mask_pack/kernel.py:unpack_blocks_kernel (_unpack_kernel).
// Bound: bytes.  It reads the N/8 words and each tile's critical prefix
// once and writes every output element once: for the 2^29-element f32 leaf
// at 14.8 % critical, 0.76 ms at 3.35 TB/s (a byte mask would add 7/8 N).
// Design: K4's move without its count pass.  Tile i of a leaf's tiled pack
// holds its critical values from packed[i * 512] on, so the in-tile scan
// of the tile's 64 bytes of words gives every critical element its source:
// no count pass, no scan over tiles.  One warp owns a 512-element tile and
// walks the group's tiles grid-stride (8 warps a block, no barrier, no
// shared memory); lanes 0-15 load the tile's words and scan their counts
// with shuffles, and each step a lane fills 16 bytes of elements,
// packed[...] where its bit is set and the fill elsewhere, and writes them
// with one 16-byte streaming store (__stcs: the output is not read back
// here, so it need not stay in L2), so a warp's store is 512 contiguous
// bytes.  The next tile's words are loaded while this tile's values are in
// flight.  The widest width's path sets the registers for all (64).
// The group: its callers (the NPB restart rebuilds every leaf of a
// program) hand over many small leaves of mixed dtypes, where one launch a
// leaf costs the host's issue time and not the card's.  The leaf table
// travels in the kernel's parameters (__grid_constant__, kGroupLeaves
// entries, 2 KB: no copy is issued for it); a warp finds its tile's leaf
// by walking the table forward, which its grid-stride tiles do in order,
// and dispatches on the leaf's element width, the same on every lane, so
// the warp does not diverge.  Each leaf's fill travels as its bytes.
// Edges: tail bits past n are masked off; words at an odd address are read
// byte by byte, packed tiles at any element address element by element;
// the ragged end of a leaf is written element by element.  A load cannot
// turn inf into NaN, as the TPU kernel's transposed 0/1 permutation matmul
// did (0 * inf = NaN): every output is a packed value or the fill bytes.
// ---------------------------------------------------------------------------
constexpr int kGroupLeaves = 32;  // leaves a launch takes (the table's
                                  // limit); the wrapper splits a longer list

struct UnpackLeaf {
  const void* packed;
  const uint8_t* words;
  void* out;
  long long n;
  long long first_tile;  // in the group
  int width;             // bytes an element: 1, 2, 4, 8 or 16
  U128 fill;
};

struct UnpackTable {
  UnpackLeaf leaf[kGroupLeaves];
  int count;
  long long tiles;
};

// Lanes 0-15: the words of tile t of the group.  Walks *leaf forward to
// t's leaf (a warp's tiles come in order).
__device__ __forceinline__ uint32_t group_tile_word(const UnpackTable& table,
                                                   int* leaf, long long t,
                                                   int lane) {
  while (*leaf + 1 < table.count && table.leaf[*leaf + 1].first_tile <= t)
    ++*leaf;
  const UnpackLeaf& l = table.leaf[*leaf];
  if (lane >= kGroups) return 0u;
  const long long e0 = (t - l.first_tile) * kTile + 32 * lane;
  if ((reinterpret_cast<uintptr_t>(l.words) & 3u) == 0)
    return group_word(l.words, e0, l.n);
  // words at an odd address: byte by byte, nothing past ceil(n/8) bytes
  if (e0 >= l.n) return 0u;
  const long long nbytes = (l.n + 7) >> 3, k0 = e0 >> 3;
  const long long k1 = k0 + 4 < nbytes ? k0 + 4 : nbytes;
  uint32_t w = 0;
  for (long long k = k0; k < k1; ++k)
    w |= static_cast<uint32_t>(l.words[k]) << (8 * (k - k0));
  return w;
}

// Tile t of ``leaf`` from its words (lanes 0-15): the values' loads of at
// most four 16-byte steps a lane are issued before their stores (64 B a
// lane, whatever the width, so no width's registers hold the others back),
// and ``next`` (the next tile's words) right after the first loads, so a
// warp waits on one memory latency a tile, not two.
template <typename W, typename Next>
__device__ __forceinline__ void unpack_tile(const UnpackLeaf& leaf,
                                            long long t, int lane,
                                            uint32_t word, Next next) {
  using L = Lane16<W>;
  constexpr int kBatch = L::kSteps < 4 ? L::kSteps : 4;
  const W* __restrict__ packed = static_cast<const W*>(leaf.packed);
  W* __restrict__ out = static_cast<W*>(leaf.out);
  const long long n = leaf.n, e0 = t * kTile;
  W fill;
  memcpy(&fill, &leaf.fill, sizeof(W));
  uint32_t bits;
  int before;
  tile_groups(word, e0, n, lane, &bits, &before);
#pragma unroll
  for (int c0 = 0; c0 < L::kSteps; c0 += kBatch) {
    L v[kBatch];
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {
      const Span sp = lane_span<L::kE>(c0 + c, lane, bits, before, e0);
      long long s = sp.rank;
#pragma unroll
      for (int k = 0; k < L::kE; ++k) {
        v[c].x[k] = fill;
        if (sp.mine >> k & 1u) v[c].x[k] = packed[s++];
      }
    }
    if (c0 == 0) next();
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {
      const long long e = e0 + (32 * (c0 + c) + lane) * L::kE;
      if (e + L::kE <= n) {
        __stcs(reinterpret_cast<uint4*>(out + e), v[c].u);
      } else {
#pragma unroll
        for (int k = 0; k < L::kE; ++k)
          if (e + k < n) out[e + k] = v[c].x[k];
      }
    }
  }
}

__global__ void __launch_bounds__(kMoveThreads)
unpack_group_kernel(const __grid_constant__ UnpackTable table) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kMoveThreads / 32);
  long long t = ((long long)blockIdx.x * kMoveThreads + threadIdx.x) >> 5;
  int i = 0;  // t's leaf
  uint32_t word = t < table.tiles ? group_tile_word(table, &i, t, lane) : 0u;
  for (; t < table.tiles; t += warps) {
    const UnpackLeaf& leaf = table.leaf[i];
    const long long lt = t - leaf.first_tile;
    int j = i;
    uint32_t next_word = 0u;
    auto next = [&]() {
      if (t + warps < table.tiles)
        next_word = group_tile_word(table, &j, t + warps, lane);
    };
    switch (leaf.width) {
      case 1: unpack_tile<uint8_t>(leaf, lt, lane, word, next); break;
      case 2: unpack_tile<uint16_t>(leaf, lt, lane, word, next); break;
      case 4: unpack_tile<uint32_t>(leaf, lt, lane, word, next); break;
      case 8: unpack_tile<unsigned long long>(leaf, lt, lane, word, next);
        break;
      default: unpack_tile<U128>(leaf, lt, lane, word, next); break;
    }
    i = j;
    word = next_word;
  }
}

// ---------------------------------------------------------------------------
// K8  regions → words
// Replaces no TPU kernel.  It was added for the device restore: a leaf
// stored as a region table (packing's ``regions`` aux, sorted disjoint
// [start, stop) int64 runs) sends that table H2D, 16 B a run, and the card
// writes the ceil(n/8) np.packbits words that K4 reads.  Before it the host
// widened the table into an element-wide mask and packed it again.
// Bound: bytes.  It writes the words once (n/8 B: 33.5 MB for a
// 2^28-element leaf, 0.010 ms at 3.35 TB/s) and reads the table, which is
// small enough to stay in L1 and L2.
// Design: one thread per 16-byte store (128 elements).  A thread binary-
// searches the runs' stops (increasing, since the runs are sorted and
// disjoint) for the first run that ends past its first element, then ORs
// in each run that starts before its last element, clipped to n, as
// lane-order bits of four 32-bit words; lane_order() turns each into
// np.packbits order and one 16-byte store writes them, so a warp's store
// is 512 contiguous bytes.  The wrapper pads the buffer to a multiple of
// 16 bytes, so every store is whole; the bits past n are 0.
// ---------------------------------------------------------------------------
constexpr int kRegionThreads = 256;

// Lane-order bits of elements [a, b) among the 32 from w0.
__device__ __forceinline__ uint32_t run_bits(long long a, long long b,
                                             long long w0) {
  const long long lo = a > w0 ? a : w0;
  const long long hi = b < w0 + 32 ? b : w0 + 32;
  if (lo >= hi) return 0u;
  const int len = static_cast<int>(hi - lo);
  const uint32_t m = len == 32 ? 0xffffffffu : (1u << len) - 1u;
  return m << static_cast<int>(lo - w0);
}

__global__ void __launch_bounds__(kRegionThreads)
regions_words_kernel(const long long* __restrict__ regions, long long count,
                     long long n, uint4* __restrict__ out,
                     long long vectors) {
  const long long v = (long long)blockIdx.x * kRegionThreads + threadIdx.x;
  if (v >= vectors) return;
  const long long e0 = v * 128, e1 = e0 + 128;
  long long lo = 0, hi = count;  // the first run with stop > e0
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(regions + 2 * mid + 1) > e0) hi = mid;
    else lo = mid + 1;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (long long j = lo; j < count; ++j) {
    const long long s = __ldg(regions + 2 * j);
    if (s >= e1) break;
    const long long stop = __ldg(regions + 2 * j + 1);
    const long long e = stop < n ? stop : n;
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] |= run_bits(s, e, e0 + 32 * k);
  }
  out[v] = make_uint4(lane_order(w[0]), lane_order(w[1]), lane_order(w[2]),
                      lane_order(w[3]));
}

inline unsigned grid_for(long long n, int tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

// Blocks for a grid-stride kernel with one warp per tile: one per
// `threads / 32` tiles, at most as many as the card holds at once.
template <typename Kernel>
unsigned warp_grid(Kernel kernel, long long tiles, int threads) {
  const long long want = (tiles + threads / 32 - 1) / (threads / 32);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const long long most = (long long)(sms > 0 ? sms : 1) *
                         (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(want < most ? want : most);
}

// Blocks for a K2/K4 move pass (512-element tiles).
template <typename Kernel>
unsigned move_grid(Kernel kernel, long long n) {
  return warp_grid(kernel, (n + kTile - 1) / kTile, kMoveThreads);
}

// K1 on the aligned or the unaligned variant (see its note).
template <typename T>
int launch_bitpack(const T* mag, T tol, long long n, uint32_t* words,
                   int32_t* counts, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kBitpackTile - 1) / kBitpackTile;
  if (reinterpret_cast<uintptr_t>(mag) % 16 == 0)
    bitpack_kernel<T, true><<<warp_grid(bitpack_kernel<T, true>, tiles,
                                        kBitpackThreads),
                              kBitpackThreads, 0, s>>>(mag, tol, n, words,
                                                       counts);
  else
    bitpack_kernel<T, false><<<warp_grid(bitpack_kernel<T, false>, tiles,
                                         kBitpackThreads),
                               kBitpackThreads, 0, s>>>(mag, tol, n, words,
                                                        counts);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
W fill_from(unsigned long long lo, unsigned long long hi) {
  unsigned long long buf[2] = {lo, hi};
  W w;
  std::memcpy(&w, buf, sizeof(W));
  return w;
}

template <typename W>
void launch_pack(const void* src, const uint8_t* words, long long n,
                 const int32_t* counts, const long long* ends, void* dst,
                 long long cap, int32_t* tile_counts, cudaStream_t s) {
  pack_kernel<W><<<move_grid(pack_kernel<W>, n), kMoveThreads, 0, s>>>(
      static_cast<const W*>(src), words, n, counts, ends,
      static_cast<W*>(dst), cap, tile_counts);
}

template <typename W>
void launch_scatter(const void* payload, long long total,
                    const uint8_t* words, long long n, const int32_t* counts,
                    const long long* ends, unsigned long long fill_lo,
                    unsigned long long fill_hi, void* out, cudaStream_t s) {
  scatter_kernel<W><<<move_grid(scatter_kernel<W>, n), kMoveThreads, 0, s>>>(
      static_cast<const W*>(payload), total, words, n, counts, ends,
      fill_from<W>(fill_lo, fill_hi), static_cast<W*>(out));
}

}  // namespace

// What the host hands over, leaf by leaf (mp_unpack_group); outside the
// anonymous namespace, so that the entry point keeps external linkage.
struct UnpackArg {
  const void* packed;
  const uint8_t* words;
  void* out;
  long long n;
  unsigned long long fill_lo, fill_hi;
  int width;
};

extern "C" {

int mp_bitpack_f32(const float* mag, float tol, long long n, uint32_t* words,
                   int32_t* counts, void* stream) {
  return launch_bitpack<float>(mag, tol, n, words, counts, stream);
}

int mp_bitpack_f64(const double* mag, double tol, long long n,
                   uint32_t* words, int32_t* counts, void* stream) {
  return launch_bitpack<double>(mag, tol, n, words, counts, stream);
}

// K2/K4's count pass: ceil(n/512) int32 counts from the words.
int mp_word_counts(const uint8_t* words, long long n, int32_t* counts,
                   void* stream) {
  if (n > 0)
    word_counts_kernel<<<grid_for(4 * grid_for(n, kTile), kCountThreads),
                         kCountThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(words, n,
                                                              counts);
  return static_cast<int>(cudaGetLastError());
}

// K2's move.  Dense: ``counts`` and ``ends`` from the count pass, the
// payload in ``dst``.  Tiled: ``ends`` null, tile t at dst + t * 512, its
// count written to ``tile_counts``.
int mp_pack(const void* src, const uint8_t* words, long long n,
            const int32_t* counts, const long long* ends, void* dst,
            long long cap, int32_t* tile_counts, int itemsize,
            void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: launch_pack<uint8_t>(src, words, n, counts, ends, dst, cap,
                                 tile_counts, s); break;
    case 2: launch_pack<uint16_t>(src, words, n, counts, ends, dst, cap,
                                  tile_counts, s); break;
    case 4: launch_pack<uint32_t>(src, words, n, counts, ends, dst, cap,
                                  tile_counts, s); break;
    case 8: launch_pack<unsigned long long>(src, words, n, counts, ends, dst,
                                            cap, tile_counts, s); break;
    case 16: launch_pack<U128>(src, words, n, counts, ends, dst, cap,
                               tile_counts, s); break;
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

int mp_mask_scatter(const void* payload, long long total,
                    const uint8_t* words, long long n, const int32_t* counts,
                    const long long* ends, unsigned long long fill_lo,
                    unsigned long long fill_hi, void* out, int itemsize,
                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: launch_scatter<uint8_t>(payload, total, words, n, counts, ends,
                                    fill_lo, fill_hi, out, s); break;
    case 2: launch_scatter<uint16_t>(payload, total, words, n, counts, ends,
                                     fill_lo, fill_hi, out, s); break;
    case 4: launch_scatter<uint32_t>(payload, total, words, n, counts, ends,
                                     fill_lo, fill_hi, out, s); break;
    case 8: launch_scatter<unsigned long long>(payload, total, words, n,
                                               counts, ends, fill_lo,
                                               fill_hi, out, s); break;
    case 16: launch_scatter<U128>(payload, total, words, n, counts, ends,
                                  fill_lo, fill_hi, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5 over 1 .. kGroupLeaves leaves, each with n > 0, in one launch (the
// wrapper splits a longer list); anything else, and a width other than 1,
// 2, 4, 8 or 16, is refused before anything is launched.
int mp_unpack_group(const UnpackArg* args, int count, void* stream) {
  if (count < 1 || count > kGroupLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  UnpackTable table{};
  for (int j = 0; j < count; ++j) {
    const UnpackArg& a = args[j];
    if (a.n <= 0 || (a.width != 1 && a.width != 2 && a.width != 4 &&
                     a.width != 8 && a.width != 16))
      return static_cast<int>(cudaErrorInvalidValue);
    UnpackLeaf& leaf = table.leaf[j];
    leaf.packed = a.packed;
    leaf.words = a.words;
    leaf.out = a.out;
    leaf.n = a.n;
    leaf.first_tile = table.tiles;
    leaf.width = a.width;
    leaf.fill = U128{a.fill_lo, a.fill_hi};
    table.tiles += (a.n + kTile - 1) / kTile;
  }
  table.count = count;
  unpack_group_kernel<<<warp_grid(unpack_group_kernel, table.tiles,
                                  kMoveThreads),
                        kMoveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table);
  return static_cast<int>(cudaGetLastError());
}

// K8: the words of n elements from ``count`` sorted, disjoint runs
// (``regions``: count (start, stop) pairs) into ``out``, ceil(n/8) bytes
// padded to a multiple of 16 and 16-byte aligned.
int mp_regions_words(const long long* regions, long long count, long long n,
                     void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (count < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vectors = (n + 127) / 128;
  regions_words_kernel<<<grid_for(vectors, kRegionThreads), kRegionThreads,
                         0, static_cast<cudaStream_t>(stream)>>>(
      regions, count, n, static_cast<uint4*>(out), vectors);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
