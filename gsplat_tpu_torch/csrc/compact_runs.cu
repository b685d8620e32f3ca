// compact_runs: per-tile copy of a run of the sorted pair array into its
// packed region, one block per tile.
//
// Replaces the TPU kernel gsplat_tpu/render/compact_pallas.py::_compact_kernel
// (through compact_runs, from binning.bin_gaussians' saturation bound cull).
// For each tile t it copies src[astart_t, astart_t + length_t) to
// out[rbase_t, rbase_t + length_t); the wrapper has filled `out` with the
// null value first (the reference's aliased init buffer), so rows no region
// covers keep it.
//
// The TPU kernel copies 16-chunk blocks and may write up to 15 chunks past a
// region, relying on its sequential grid: the next tile overwrites them.
// Blocks here run in no order, so every write stays inside its own region and
// inside [0, out_size), and every read inside [0, n_src): where the binning's
// budget overflowed and clamped regions overlap or run past the end, the
// copy stays in bounds (that content is garbage the caller never reads: the
// step's gradient is zeroed and n_dropped reports it).
//
// Bound on this card: bytes, each surviving row read once and written once,
// plus the fill. Design: 16-byte vector copies where the run's two ends are
// 4-row aligned (chunk-aligned starts with chunk % 4 == 0 and 16-byte
// aligned bases, which the wrapper checks), scalar copies otherwise.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void compact_runs_kernel(const int32_t* __restrict__ src, int n_src,
                                    const int32_t* __restrict__ astart,
                                    const int32_t* __restrict__ rbase,
                                    const int32_t* __restrict__ length,
                                    int out_size, int aligned,
                                    int32_t* __restrict__ out) {
  const int t = blockIdx.x;
  const int a = astart[t], r = rbase[t], len = length[t];
  // rows j of the run with 0 <= r + j < out_size and 0 <= a + j < n_src
  const int lo = max(0, max(-r, -a));
  const int hi = min(len, min(out_size - r, n_src - a));
  if (hi <= lo) return;
  int j0 = lo;
  if (aligned && lo == 0 && (a & 3) == 0 && (r & 3) == 0) {
    const int nv = hi >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src + a);
    int4* d4 = reinterpret_cast<int4*>(out + r);
    for (int v = threadIdx.x; v < nv; v += kThreads) d4[v] = __ldg(s4 + v);
    j0 = nv << 2;
  }
  for (int j = j0 + threadIdx.x; j < hi; j += kThreads) out[r + j] = __ldg(src + a + j);
}

}  // namespace

// src: (n_src,) int32; astart, rbase, length: (num_tiles,) int32 device
// arrays; out: (out_size,) int32, pre-filled. aligned: src and out start on
// 16-byte boundaries. Returns cudaGetLastError() after the launch.
extern "C" int compact_runs_launch(const void* src, int n_src, const void* astart,
                                   const void* rbase, const void* length,
                                   int num_tiles, int out_size, int aligned,
                                   void* out, void* stream) {
  if (num_tiles > 0) {
    compact_runs_kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(src), n_src, static_cast<const int32_t*>(astart),
        static_cast<const int32_t*>(rbase), static_cast<const int32_t*>(length),
        out_size, aligned, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
