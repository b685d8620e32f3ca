// segment_ends: per-Gaussian segment ends in the gid-sorted key row of the
// backward's d-table, ends[g] = #{keys < g + 1}. One thread per Gaussian.
//
// Replaces the TPU kernel gsplat_tpu/render/bounds_pallas.py::_ends_kernel
// (through segment_ends). The keys are integer-valued f32 gids in
// ascending order, KEY_INVALID (2^30) on the inert tail; a gid with no rows
// gets the end of the gid before it. Thread g binary-searches the first key
// >= g + 1 (std::lower_bound): the same count torch.searchsorted(keys,
// g + 1, side="left") returns, bit for bit.
//
// Bound on this card: bytes. The function reads the P keys once and writes
// N int32 ends; the search reads ~log2(P) keys per thread, but neighbouring
// threads follow nearly the same path and the key row (6.4 MB at 1.6M rows)
// stays in the 50 MB L2. The TPU kernel's block windows and per-block DMA
// sweep were a workaround for a machine without gathers.

#include "common.cuh"

namespace {

__global__ void segment_ends_kernel(const float* __restrict__ keys, int p, int n,
                                    int32_t* __restrict__ ends) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const float q = static_cast<float>(g + 1);
  int lo = 0, hi = p;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  ends[g] = lo;
}

}  // namespace

// keys: (p,) float32 sorted ascending; ends: (n,) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int segment_ends_launch(const void* keys, int p, int n, void* ends,
                                   void* stream) {
  if (n > 0) {
    constexpr int kThreads = 256;
    segment_ends_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(keys), p, n, static_cast<int32_t*>(ends));
  }
  return static_cast<int>(cudaGetLastError());
}
