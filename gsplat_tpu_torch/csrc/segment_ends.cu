// segment_ends: per-Gaussian segment ends in the gid-sorted key row of the
// backward's d-table, ends[g] = #{keys < g + 1}. One pass over the keys.
//
// Replaces the TPU kernel gsplat_tpu/render/bounds_pallas.py::_ends_kernel
// (through segment_ends). The keys are integer-valued f32 gids in
// ascending order, KEY_INVALID (2^30) on the inert tail; a gid with no rows
// gets the end of the gid before it.
//
// For sorted keys, #{keys < g + 1} = j exactly for the gids g in
// [b(j - 1), b(j)), where b(i) = floor(key[i]) clamped to [0, n] (the
// least integer g with g + 1 > key[i]), b(-1) = 0 and b(p) = n. So thread j
// of p + 1 reads keys j - 1 and j and writes j over its range: every gid is
// written exactly once, by the thread of the first key above it; the
// result is the count torch.searchsorted(keys, g + 1, side="left") returns,
// bit for bit. Ranges are empty where a gid repeats, one gid long where
// consecutive gids both have rows, and long where gids have no rows
// (culled or offscreen Gaussians, the dead capacity past the live ones, up
// to all n gids when every key is KEY_INVALID). A range longer than
// kLongGap goes to a list in shared memory, and the whole block fills each
// listed range with 16-byte stores (the tail of dead gids is one range of
// tens of thousands of gids), so no thread writes a long range alone.
//
// Bound on this card: bytes. The function reads the p keys once and writes
// the n int32 ends once. The design it replaces binary-searched the key row
// from every gid, ~21 dependent L2 loads a thread.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLongGap = 32;

__device__ __forceinline__ int boundary(float key, int n) {
  // floor(key) clamped to [0, n]; KEY_INVALID clamps to n
  if (!(key > 0.f)) return 0;
  if (key >= static_cast<float>(n)) return n;
  return static_cast<int>(floorf(key));
}

__global__ void __launch_bounds__(kThreads) segment_ends_kernel(
    const float* __restrict__ keys, int p, int n, int32_t* __restrict__ ends) {
  __shared__ int s_lo[kThreads], s_hi[kThreads], s_val[kThreads];
  __shared__ int s_count;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;   // 0 .. p
  if (j <= p) {
    const int lo = j > 0 ? boundary(__ldg(keys + j - 1), n) : 0;
    const int hi = j < p ? boundary(__ldg(keys + j), n) : n;
    if (hi - lo > kLongGap) {
      const int slot = atomicAdd(&s_count, 1);
      s_lo[slot] = lo;
      s_hi[slot] = hi;
      s_val[slot] = j;
    } else {
      for (int g = lo; g < hi; ++g) ends[g] = j;
    }
  }
  __syncthreads();
  // the block's long ranges, each by all threads: a scalar head up to a
  // 16-byte boundary, int4 stores, a scalar tail. The list's order does not
  // matter: every gid of a range gets the range's value.
  const int count = s_count;
  for (int r = 0; r < count; ++r) {
    const int lo = s_lo[r], hi = s_hi[r], v = s_val[r];
    const int a = min(hi, (lo + 3) & ~3), b = max(a, hi & ~3);
    for (int g = lo + threadIdx.x; g < a; g += blockDim.x) ends[g] = v;
    const int4 v4 = make_int4(v, v, v, v);
    for (int g = a + 4 * threadIdx.x; g < b; g += 4 * blockDim.x)
      *reinterpret_cast<int4*>(ends + g) = v4;
    for (int g = b + threadIdx.x; g < hi; g += blockDim.x) ends[g] = v;
  }
}

}  // namespace

// keys: (p,) float32 sorted ascending; ends: (n,) int32, 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int segment_ends_launch(const void* keys, int p, int n, void* ends,
                                   void* stream) {
  if (n > 0) {
    segment_ends_kernel<<<p / kThreads + 1, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(keys), p, n, static_cast<int32_t*>(ends));
  }
  return static_cast<int>(cudaGetLastError());
}
