// compact_runs: per-tile copy of a run of the sorted pair array into its
// packed region, and the null value in every row no region covers, in one
// launch that writes each row of the output once.
//
// Replaces the TPU kernel gsplat_tpu/render/compact_pallas.py::_compact_kernel
// (through compact_runs, from binning.bin_gaussians' saturation bound cull).
// For each tile t it copies src[astart_t, astart_t + length_t) to
// out[rbase_t, rbase_t + length_t); every other row of `out` gets `fill`
// (the reference's aliased init buffer). The wrapper allocates `out` with
// torch.empty: nothing is written before the kernel.
//
// Who writes what. Block t < num_tiles copies region t (a row whose source
// lies outside [0, n_src) gets the fill) and fills the gap from its region's
// end to the next region's start. The rows before the first region and
// after the last are filled by every block of the grid together, in
// grid-strided 16-byte stores: on the sparse view that tail is a sixth of the
// output, too much for one block. The grid has max(num_tiles,
// out_size / kFillRows) blocks, so no regions still fills the output.
//
// Which rows a gap holds. Regions with non-decreasing starts and ends (the
// binning's packed regions, ascending and disjoint) leave no uncovered row
// outside the head, the gaps and the tail, and no gap or tail row is covered
// by a region. The binning's overflow clamps rbase so that each region
// starts inside the budget: the regions past the clamp all end at or past
// out_size and overlap, their gaps are then empty or negative (nothing is
// filled), and together with the packed prefix they cover [0, out_size).
// So every row is written, and a fill never lands on a row a region copies.
// Where two regions overlap the row holds either region's value (the TPU
// kernel's sequential grid let the later tile win; blocks here run in no
// order); that content is garbage the caller never reads (the step's
// gradient is zeroed and n_dropped reports it).
//
// Every write stays inside [0, out_size) and every read inside [0, n_src).
// The TPU kernel copies 16-chunk blocks and may write past a region,
// relying on its sequential grid; nothing here does.
//
// Bound on this card: bytes, each surviving row read once and written once,
// and every other output row written once. Design: 16-byte vector copies
// where the run's source and destination are 4-row aligned (chunk-aligned
// starts with chunk % 4 == 0 and 16-byte aligned bases, which the wrapper
// checks), 16-byte fills between 4-row boundaries, scalar rows otherwise.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// rows of output a block is given for the head and tail fill, which sizes
// the grid when the regions are fewer than out_size / kFillRows
constexpr int kFillRows = 8192;

__device__ __forceinline__ int clamp_row(long long v, int hi) {
  return static_cast<int>(v < 0 ? 0 : (v > hi ? hi : v));
}

// out[g0, g1) = fill, shared by `parts` blocks of which this is `part`.
__device__ __forceinline__ void fill_rows(int32_t* __restrict__ out, int g0, int g1,
                                          int32_t fill, bool aligned, int part,
                                          int parts) {
  if (g1 <= g0) return;
  int a0 = g0, a1 = g0;  // [a0, a1): the rows written by 16-byte stores
  if (aligned) {
    a0 = min((g0 + 3) & ~3, g1);
    a1 = max(a0, g1 & ~3);
  }
  const int stride = parts * kThreads;
  const int first = part * kThreads + threadIdx.x;
  const int4 f4 = make_int4(fill, fill, fill, fill);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int v = (a0 >> 2) + first; v < (a1 >> 2); v += stride) o4[v] = f4;
  for (int j = g0 + first; j < a0; j += stride) out[j] = fill;
  for (int j = a1 + first; j < g1; j += stride) out[j] = fill;
}

__global__ void compact_runs_kernel(const int32_t* __restrict__ src, int n_src,
                                    const int32_t* __restrict__ astart,
                                    const int32_t* __restrict__ rbase,
                                    const int32_t* __restrict__ length,
                                    int num_tiles, int out_size, int32_t fill,
                                    int aligned, int32_t* __restrict__ out) {
  const int t = blockIdx.x;
  int head_end = out_size, tail_start = out_size;
  if (num_tiles > 0) {
    head_end = clamp_row(rbase[0], out_size);
    tail_start = clamp_row(static_cast<long long>(rbase[num_tiles - 1]) +
                               length[num_tiles - 1], out_size);
  }
  fill_rows(out, 0, head_end, fill, aligned, t, gridDim.x);
  fill_rows(out, tail_start, out_size, fill, aligned, t, gridDim.x);
  if (t >= num_tiles) return;

  const int a = astart[t], r = rbase[t], len = length[t];
  // rows j of the run inside the output: [j_lo, j_hi); of them, those whose
  // source lies inside src: [c_lo, c_hi)
  const int j_lo = clamp_row(-static_cast<long long>(r), max(len, 0));
  const int j_hi = max(j_lo, clamp_row(static_cast<long long>(out_size) - r, max(len, 0)));
  const int c_lo = max(j_lo, clamp_row(-static_cast<long long>(a), j_hi));
  const int c_hi = max(c_lo, clamp_row(static_cast<long long>(n_src) - a, j_hi));
  fill_rows(out, r + j_lo, r + c_lo, fill, aligned, 0, 1);
  fill_rows(out, r + c_hi, r + j_hi, fill, aligned, 0, 1);
  int j0 = c_lo;
  if (aligned && ((a + c_lo) & 3) == 0 && ((r + c_lo) & 3) == 0) {
    const int nv = (c_hi - c_lo) >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src + a + c_lo);
    int4* d4 = reinterpret_cast<int4*>(out + r + c_lo);
    for (int v = threadIdx.x; v < nv; v += kThreads) d4[v] = __ldg(s4 + v);
    j0 = c_lo + (nv << 2);
  }
  for (int j = j0 + threadIdx.x; j < c_hi; j += kThreads) out[r + j] = __ldg(src + a + j);

  // the gap to the next region
  if (t + 1 < num_tiles) {
    fill_rows(out, clamp_row(static_cast<long long>(r) + len, out_size),
              clamp_row(rbase[t + 1], out_size), fill, aligned, 0, 1);
  }
}

}  // namespace

// src: (n_src,) int32; astart, rbase, length: (num_tiles,) int32 device
// arrays; out: (out_size,) int32, written in full. aligned: src and out
// start on 16-byte boundaries. Returns cudaGetLastError() after the launch.
extern "C" int compact_runs_launch(const void* src, int n_src, const void* astart,
                                   const void* rbase, const void* length,
                                   int num_tiles, int out_size, int fill, int aligned,
                                   void* out, void* stream) {
  const int fill_blocks = (out_size + kFillRows - 1) / kFillRows;
  const int grid = num_tiles > fill_blocks ? num_tiles : fill_blocks;
  if (out_size > 0 && grid > 0) {
    compact_runs_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(src), n_src, static_cast<const int32_t*>(astart),
        static_cast<const int32_t*>(rbase), static_cast<const int32_t*>(length),
        num_tiles, out_size, fill, aligned, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
