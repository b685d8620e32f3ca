// prefix_sum_small: inclusive int32 prefix sum (+ bias, optionally clipped to
// [0, clip_hi]) of small non-negative values, reduce-then-scan in three
// launches.
//
// Replaces the TPU kernel gsplat_tpu/render/scan_pallas.py::_scan_kernel
// (through prefix_sum_small, from binning.bin_gaussians' saturation bound
// cull: the running sum of each sorted pair's 6-bit saturation quantum).
// The TPU kernel walks the array in order on one core and carries the total
// in scratch memory; its in-block sums are triangular matmuls in f32, exact
// because the values are <= 255. Here blocks run in no order, so the carry
// becomes two extra passes:
//   1. block_sums: each block sums its kTile elements (warp shuffles);
//   2. scan_sums:  one block turns the block sums into exclusive offsets;
//   3. scan_tiles: each block scans its tile again, adds its offset, the
//                  bias and the clip, and writes the result.
// Every sum is an integer add, so the result is bit-equal to cumsum in int32
// whatever the order. The adds run in uint32 so that a sum past 2^31 wraps as
// torch's int32 cumsum does instead of being undefined; the wrapper keeps
// n < 2^25, where the binning's 6-bit quanta (63 * 2^25 < 2^31) never wrap.
//
// Bound on this card: bytes, 4 read + 4 written per element. This design
// reads each element twice (passes 1 and 3), 12 bytes per element; the second
// read of a 16 KB tile may hit the 50 MB L2 only when the array fits in it.
// A single-pass decoupled look-back scan would reach the 8-byte bound.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                    // contiguous elements a thread scans
constexpr int kTile = kThreads * kItems;      // 4096 elements a block
constexpr int kWarps = kThreads / 32;

// shared-memory index of tile element j: one word of skew every 32 words, so
// that thread t reading its element t*kItems + i hits a bank of its own
__device__ __forceinline__ int skew(int j) { return j + (j >> 5); }

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// pass 1: sums[b] = sum of tile b
__global__ void block_sums_kernel(const int32_t* __restrict__ x, int n,
                                  uint32_t* __restrict__ sums) {
  __shared__ uint32_t warp_tot[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  uint32_t acc = 0;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const size_t j = base + i;
    if (j < static_cast<size_t>(n)) acc += static_cast<uint32_t>(x[j]);
  }
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_tot[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_tot[w];
    sums[blockIdx.x] = t;
  }
}

// pass 2, one block of 1024 threads: sums[b] <- sum of sums[0..b) (exclusive)
__global__ void scan_sums_kernel(uint32_t* __restrict__ sums, int nb) {
  __shared__ uint32_t warp_tot[32];
  __shared__ uint32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int b0 = 0; b0 < nb; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const uint32_t v = b < nb ? sums[b] : 0u;
    const uint32_t inc = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const uint32_t w = lane < static_cast<int>(blockDim.x >> 5) ? warp_tot[lane] : 0u;
      warp_tot[lane] = warp_inclusive_scan(w, lane) - w;   // exclusive over warps
    }
    __syncthreads();
    const uint32_t c = carry;
    if (b < nb) sums[b] = c + warp_tot[warp] + inc - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = c + warp_tot[warp] + inc;
    __syncthreads();
  }
}

// pass 3: out[j] = clip(offset[b] + inclusive in-tile prefix + bias)
__global__ void scan_tiles_kernel(const int32_t* __restrict__ x, int n,
                                  const uint32_t* __restrict__ offsets,
                                  int32_t bias, int has_clip, int32_t clip_hi,
                                  int32_t* __restrict__ out) {
  __shared__ uint32_t tile[kTile + kTile / 32];
  __shared__ uint32_t warp_tot[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const size_t j = base + i;
    tile[skew(i)] = j < static_cast<size_t>(n) ? static_cast<uint32_t>(x[j]) : 0u;
  }
  __syncthreads();
  const int first = threadIdx.x * kItems;
  uint32_t own = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) own += tile[skew(first + i)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t inc = warp_inclusive_scan(own, lane);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? warp_tot[lane] : 0u;
    const uint32_t e = warp_inclusive_scan(w, lane) - w;
    if (lane < kWarps) warp_tot[lane] = e;
  }
  __syncthreads();
  uint32_t run = offsets[blockIdx.x] + warp_tot[warp] + inc - own;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run += tile[skew(first + i)];
    int32_t v = static_cast<int32_t>(run + static_cast<uint32_t>(bias));
    if (has_clip) v = min(max(v, 0), clip_hi);
    tile[skew(first + i)] = static_cast<uint32_t>(v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const size_t j = base + i;
    if (j < static_cast<size_t>(n)) out[j] = static_cast<int32_t>(tile[skew(i)]);
  }
}

}  // namespace

// Scratch `sums` holds at least prefix_sum_small_blocks(n) uint32 words.
extern "C" int prefix_sum_small_blocks(int n) { return (n + kTile - 1) / kTile; }

// x, out: (n,) int32; bias, clip to [0, clip_hi] when has_clip. Returns
// cudaGetLastError() after the launches (none for n == 0).
extern "C" int prefix_sum_small_launch(const void* x, int n, int bias, int has_clip,
                                       int clip_hi, void* sums, void* out,
                                       void* stream) {
  if (n > 0) {
    const int nb = (n + kTile - 1) / kTile;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int32_t* xi = static_cast<const int32_t*>(x);
    uint32_t* s = static_cast<uint32_t*>(sums);
    block_sums_kernel<<<nb, kThreads, 0, st>>>(xi, n, s);
    scan_sums_kernel<<<1, 1024, 0, st>>>(s, nb);
    scan_tiles_kernel<<<nb, kThreads, 0, st>>>(xi, n, s, bias, has_clip, clip_hi,
                                               static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
