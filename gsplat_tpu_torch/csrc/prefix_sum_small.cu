// prefix_sum_small: inclusive int32 prefix sum (+ bias, optionally clipped to
// [0, clip_hi]) of small non-negative values, in one pass: a chained scan with
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", NVIDIA, 2016).
//
// Replaces the TPU kernel gsplat_tpu/render/scan_pallas.py::_scan_kernel
// (through prefix_sum_small, from binning.bin_gaussians' saturation bound
// cull: the running sum of each sorted pair's 6-bit saturation quantum).
// The TPU kernel walks the array in order on one core and carries the total
// in scratch memory; its in-block sums are triangular matmuls in f32, exact
// because the values are <= 255. Here blocks run in no order, and the carry
// travels through a status word per tile in global memory:
//   - a block takes its tile from an atomicAdd on a counter, so every tile
//     below its own belongs to a block that is already running, and the
//     look-back's spin cannot deadlock however many tiles there are;
//   - each of its 8 warps owns 1024 consecutive elements of the 8192-element
//     tile and reads them with coalesced 16-byte loads, lane l holding chunk
//     32 i + l of row i (8 rows of 128 elements); a row is scanned with
//     shuffles and carried into the next, so no element passes through
//     shared memory (a shared-memory transpose to 32 consecutive elements a
//     thread moved each tile through shared memory four times);
//   - the block publishes its aggregate as soon as the warps' totals are
//     summed; warp 0 then looks back over 32 predecessors at a time: it sums
//     their aggregates until it meets a tile that has published its
//     inclusive prefix, then publishes its own inclusive prefix;
//   - every lane adds the exclusive prefix, the bias and the clip, and
//     stores its chunks with 16-byte stores in the layout it loaded them.
// A status word is one 64-bit store (flag in the high half, the uint32 value
// in the low half), written with st.release.gpu and read with ld.acquire.gpu,
// so a reader never sees a flag without its value. Each word has a 128-byte
// line of its own: a wave of blocks spins on its predecessors' words, and
// packed 16 to a line they fall on a few L2 slices and queue there. The
// launch zeroes the words and the counter with one cudaMemsetAsync on the
// same stream: a call never depends on what an earlier one left there.
//
// Every sum is an integer add, so the result is bit-equal to cumsum in int32
// whatever the order. The adds run in uint32 so that a sum past 2^31 wraps as
// torch's int32 cumsum does instead of being undefined; the wrapper keeps
// n < 2^25, where the binning's 6-bit quanta (63 * 2^25 < 2^31) never wrap.
//
// Bound on this card: bytes, 4 read + 4 written per element, which this
// design moves once each (the three-launch design before it read each
// element twice). Input whose address is not 16-byte aligned (a slice) takes
// scalar loads; so does the ragged last tile.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 32;                    // elements a thread scans
constexpr int kTile = kThreads * kItems;      // 8192 elements a block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kItems / 4;             // 16-byte chunks a thread
constexpr int kSeg = 32 * kItems;             // elements a warp

constexpr uint64_t kAggregate = 1ull << 32;   // status flags, in the high half
constexpr uint64_t kPrefix = 2ull << 32;
constexpr int kStride = 16;                   // status words a tile: one per line

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

__device__ __forceinline__ void store_release(unsigned long long* p, uint64_t v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t load_acquire(const unsigned long long* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Warp 0 of tile b > 0: the sum of every element before the tile.
__device__ uint32_t look_back(const unsigned long long* status, int b, int lane) {
  uint32_t excl = 0;
  for (int last = b - 1;; last -= 32) {
    // lane i reads tile last - i; tiles before 0 read as a prefix of 0
    const int p = last - lane;
    for (;;) {
      const uint64_t w = p >= 0 ? load_acquire(status + static_cast<size_t>(p) * kStride)
                                : kPrefix;
      const uint32_t ready = __ballot_sync(0xffffffffu, (w >> 32) != 0);
      const uint32_t prefix = __ballot_sync(0xffffffffu, (w >> 32) == (kPrefix >> 32));
      // the lanes up to the nearest inclusive prefix, or all 32
      const uint32_t low = prefix & (0u - prefix);
      const uint32_t need = prefix ? (low << 1) - 1u : 0xffffffffu;
      if ((ready & need) == need) {
        excl += warp_sum((need >> lane) & 1u ? static_cast<uint32_t>(w) : 0u);
        if (prefix) return excl;
        break;
      }
    }
  }
}

__device__ __forceinline__ int32_t finish(uint32_t run, int32_t bias, int has_clip,
                                          int32_t clip_hi) {
  int32_t v = static_cast<int32_t>(run + static_cast<uint32_t>(bias));
  return has_clip ? min(max(v, 0), clip_hi) : v;
}

__global__ void __launch_bounds__(kThreads) scan_kernel(
    const int32_t* __restrict__ x, int n, int vec_ok, int32_t bias, int has_clip,
    int32_t clip_hi, unsigned long long* __restrict__ status,
    unsigned int* __restrict__ counter, int32_t* __restrict__ out) {
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ int s_b;
  __shared__ uint32_t s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_b = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  const int b = s_b;
  // the warp's segment; lane l's chunk of row i starts at seg + 4 (32 i + l)
  const size_t seg = static_cast<size_t>(b) * kTile + static_cast<size_t>(warp) * kSeg;
  const bool full = static_cast<size_t>(b + 1) * kTile <= static_cast<size_t>(n);
  uint4 v[kRows];
  if (full && vec_ok) {
    const uint4* src = reinterpret_cast<const uint4*>(x + seg);
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = __ldg(src + 32 * i + lane);
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const size_t j = seg + 4 * (32 * i + lane);
      uint32_t e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        e[c] = j + c < static_cast<size_t>(n) ? static_cast<uint32_t>(x[j + c]) : 0u;
      v[i] = make_uint4(e[0], e[1], e[2], e[3]);
    }
  }

  // each chunk's exclusive prefix within the warp's segment: rows in order,
  // lanes in order within a row
  uint32_t pre[kRows];
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const uint32_t sum = v[i].x + v[i].y + v[i].z + v[i].w;
    const uint32_t inc = warp_inclusive_scan(sum, lane);
    pre[i] = carry + inc - sum;
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) warp_tot[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < kWarps ? warp_tot[lane] : 0u;
    const uint32_t winc = warp_inclusive_scan(w, lane);
    const uint32_t aggregate = __shfl_sync(0xffffffffu, winc, 31);
    uint32_t excl = 0;
    if (b == 0) {
      if (lane == 0) store_release(status, kPrefix | aggregate);
    } else {
      unsigned long long* own = status + static_cast<size_t>(b) * kStride;
      if (lane == 0) store_release(own, kAggregate | aggregate);
      excl = look_back(status, b, lane);
      if (lane == 0) store_release(own, kPrefix | static_cast<uint32_t>(excl + aggregate));
    }
    if (lane < kWarps) warp_tot[lane] = winc - w;   // exclusive over warps
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();

  // epilogue: the offsets, the bias and the clip, stored as loaded
  const uint32_t off = s_excl + warp_tot[warp];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const uint32_t r0 = off + pre[i] + v[i].x;
    const uint32_t r1 = r0 + v[i].y, r2 = r1 + v[i].z, r3 = r2 + v[i].w;
    v[i] = make_uint4(finish(r0, bias, has_clip, clip_hi), finish(r1, bias, has_clip, clip_hi),
                      finish(r2, bias, has_clip, clip_hi), finish(r3, bias, has_clip, clip_hi));
  }
  if (full) {
    // out is a fresh allocation, 16-byte aligned
    uint4* dst = reinterpret_cast<uint4*>(out + seg);
#pragma unroll
    for (int i = 0; i < kRows; ++i) dst[32 * i + lane] = v[i];
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const size_t j = seg + 4 * (32 * i + lane);
      const uint32_t e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j + c < static_cast<size_t>(n)) out[j + c] = static_cast<int32_t>(e[c]);
    }
  }
}

}  // namespace

// Bytes of scratch prefix_sum_small_launch needs for n elements: a 128-byte
// line a tile for its status word, then the tile counter.
extern "C" long long prefix_sum_small_scratch_bytes(int n) {
  return 8ll * kStride * ((n + kTile - 1) / kTile) + 8;
}

// x, out: (n,) int32, out 16-byte aligned; bias, clip to [0, clip_hi] when
// has_clip. scratch: prefix_sum_small_scratch_bytes(n) bytes, 8-byte aligned,
// zeroed here. One memset and one kernel on `stream` (none for n == 0);
// returns cudaGetLastError() after them.
extern "C" int prefix_sum_small_launch(const void* x, int n, int bias, int has_clip,
                                       int clip_hi, void* scratch, void* out,
                                       void* stream) {
  if (n > 0) {
    const int nb = (n + kTile - 1) / kTile;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e = cudaMemsetAsync(scratch, 0, prefix_sum_small_scratch_bytes(n), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    unsigned long long* status = static_cast<unsigned long long*>(scratch);
    const int vec_ok = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    scan_kernel<<<nb, kThreads, 0, st>>>(
        static_cast<const int32_t*>(x), n, vec_ok, bias, has_clip, clip_hi, status,
        reinterpret_cast<unsigned int*>(status + static_cast<size_t>(nb) * kStride),
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
