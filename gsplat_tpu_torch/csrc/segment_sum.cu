// segment_sum: the per-Gaussian gradient reduction of the backward. For each
// Gaussian g, the sum of the first nine columns of the d-table rows whose gid
// key is g, in an order fixed by the data alone.
//
// Replaces the reference's XLA chain in gsplat_tpu/render/render.py::
// _rasterize_bwd (a key sort, a float32 cumsum table over the sorted rows,
// the rows at the segment ends and their adjacent difference). The caller
// sorts the key column (stable) and finds each gid's segment end (the
// segment_ends kernel); Gaussian g owns the sorted positions
// [ends[g - 1], ends[g]) (ends[-1] = 0), and the kernel reads the d-table
// rows at perm[i] for those positions straight from the table: no gathered
// copy, no cumsum table, no difference of two running sums.
//
// Determinism: each sum is accumulated in float64 registers and rounded to
// float32 once. A segment of at most kShort rows is summed by the
// Gaussian's own thread, row by row in sorted order. A longer one (a large
// splat near the camera covers hundreds of tiles, and so owns hundreds of
// rows) is summed by its whole warp: lane l takes positions s + l, s + l +
// 32, ... in order, then a fixed xor butterfly adds the 32 partial sums.
// Which path a segment takes depends on its length alone, and no sum uses
// atomics, so two launches on one table give the same bits. In float64 the
// sum of a few thousand float32 values is exact to ~1e-13 of their
// magnitudes, so the rounded result is the float32 nearest the exact sum
// in all but the rarest ties: the float32 cumsum difference the reference
// takes misses 1e-3 of the colour columns' max at 1080p, the float64 one
// the port took before was not reproducible on CUDA.
//
// Bound on this card: bytes. Each live row is read once through the
// permutation (64 bytes: its nine gradient columns span both 32-byte
// sectors, plus 8 bytes of perm), each Gaussian's end read and its 64-byte
// output row written once. The row reads are random: the d-table is in
// tile order and the permutation sorts it by gid.

#include "common.cuh"

namespace {

constexpr int kAttrDim = 16;
constexpr int kCols = 9;       // d mean xy, conic abc, rgb, opacity
constexpr int kShort = 8;      // longest segment a single thread sums
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add_row(const float* __restrict__ d, long long r,
                                        double (&acc)[kCols]) {
  const float* row = d + static_cast<size_t>(r) * kAttrDim;
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(row));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
  const float a2 = __ldg(row + 8);
  acc[0] += a0.x;
  acc[1] += a0.y;
  acc[2] += a0.z;
  acc[3] += a0.w;
  acc[4] += a1.x;
  acc[5] += a1.y;
  acc[6] += a1.z;
  acc[7] += a1.w;
  acc[8] += a2;
}

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ d, const long long* __restrict__ perm,
    const int32_t* __restrict__ ends, int n_gauss, int n_rows,
    float* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // gids past n_gauss (the null Gaussian, the grid's round-up) own nothing
  int s = 0, e = 0;
  if (g < n_gauss) {
    s = g > 0 ? ends[g - 1] : 0;
    e = ends[g];
  }
  double acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0;
  const bool is_long = e - s > kShort;
  if (!is_long) {
    for (int i = s; i < e; ++i) add_row(d, perm[i], acc);
  }
  // the warp's long segments, one after another in lane order
  unsigned todo = __ballot_sync(kFull, is_long);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int ls = __shfl_sync(kFull, s, src), le = __shfl_sync(kFull, e, src);
    double part[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) part[c] = 0.0;
    for (int i = ls + lane; i < le; i += 32) add_row(d, perm[i], part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[c] += __shfl_xor_sync(kFull, part[c], o);
    }
    // a + b and b + a round alike: every lane holds the same totals
    if (lane == src) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = part[c];
    }
  }
  if (g >= n_rows) return;
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(g) * kAttrDim);
  o[0] = make_float4(static_cast<float>(acc[0]), static_cast<float>(acc[1]),
                     static_cast<float>(acc[2]), static_cast<float>(acc[3]));
  o[1] = make_float4(static_cast<float>(acc[4]), static_cast<float>(acc[5]),
                     static_cast<float>(acc[6]), static_cast<float>(acc[7]));
  o[2] = make_float4(static_cast<float>(acc[8]), 0.f, 0.f, 0.f);
  o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace

// d: (c, 16) float32, 16-byte aligned; perm: (c,) int64, the stable sort of
// d's key column; ends: (n_gauss,) int32 segment ends in that order; out:
// (n_rows, 16) float32, 16-byte aligned, n_rows >= n_gauss (rows n_gauss..
// n_rows - 1 come out zero). Returns cudaGetLastError() after the launch.
extern "C" int segment_sum_launch(const void* d, const void* perm, const void* ends,
                                  int n_gauss, int n_rows, void* out, void* stream) {
  if (n_rows > 0) {
    segment_sum_kernel<<<(n_rows + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(d), static_cast<const long long*>(perm),
        static_cast<const int32_t*>(ends), n_gauss, n_rows, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
