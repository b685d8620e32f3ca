// expand_pairs: (Gaussian, tile) pair expansion, one thread per pair slot.
//
// Replaces the TPU kernel gsplat_tpu/render/expand_pallas.py::_expand_kernel
// (through expand_pairs, from binning._expand_fused). For each slot p < S it
// finds the owning Gaussian in the live-compacted column table by binary
// search of the offset column, decomposes that Gaussian's tile rectangle into
// the slot's tile, applies the tight tile cull and packs the
// (tile << db | depth) sort key. Invalid (p >= total) and culled slots get
// key_invalid and the null gid n_orig. Keys and gids are bit-equal to the
// plain PyTorch version (render/expand.py), which repeats
// binning._expand_xla's arithmetic in the same order; the library is built
// with --fmad=false so no a*b+c contracts into one rounding.
//
// With sat_pack (the saturation bound cull) a kept slot's gid carries its
// 6-bit saturation quantum, gid << 6 | q, and null slots carry n_orig << 6
// (binning._expand_xla's sat_pack branch). q comes from the tile box's
// farthest corner (rect_max_q) through expf and log1pf, the libdevice
// functions torch's own CUDA kernels call, so the plain version on the card
// gives the same bits.
//
// Bound on this card: memory. Each slot writes 8 bytes and reads one table
// row; the arithmetic is a few integer ops plus, with the cull, ~40 f32 ops
// and one expf. The search costs log2(n) dependent loads, but at 1M Gaussians
// the whole (11, n) table (44 MB) sits in the 50 MB L2, and neighbouring
// slots walk the same search path and read the same or adjacent rows.
// Design: the table is column-major, so the offset column the search walks is
// contiguous and each column load of a warp touches one or two cache lines.
// The TPU kernel's DMA'd column windows, 128-lane gathers and reciprocal
// division were workarounds for a machine without gathers or vector integer
// division; here a thread loads what it needs and divides exactly.

#include "common.cuh"

namespace {

// column order of binning.expansion_table
constexpr int COL_OFF = 0, COL_X0Y0 = 1, COL_W = 2, COL_DQ = 3, COL_GID = 4,
              COL_MX = 5, COL_MY = 6, COL_CA = 7, COL_CB = 8, COL_CC = 9,
              COL_OP = 10;

// Q(d) = 0.5*a*dx^2 + b*dx*dy + 0.5*c*dy^2 on the box edge dx = e (resp. dy =
// e) at its clamped minimiser; binning._rect_min_Q's operation order.
__device__ __forceinline__ float edge_x(float a, float b, float c, float c_s,
                                        float e, float ly, float hy) {
  const float dy = fminf(fmaxf(-b * e / c_s, ly), hy);
  return 0.5f * a * e * e + b * e * dy + 0.5f * c * dy * dy;
}

__device__ __forceinline__ float edge_y(float a, float b, float c, float a_s,
                                        float e, float lx, float hx) {
  const float dx = fminf(fmaxf(-b * e / a_s, lx), hx);
  return 0.5f * a * dx * dx + b * dx * e + 0.5f * c * e * e;
}

// exact min of Q over the box [lx,hx] x [ly,hy] (0 when it holds the mean)
__device__ __forceinline__ float rect_min_q(float a, float b, float c, float lx,
                                            float hx, float ly, float hy) {
  const bool inside = lx <= 0.f && hx >= 0.f && ly <= 0.f && hy >= 0.f;
  const float eps = static_cast<float>(1e-12);
  const float a_s = fmaxf(a, eps), c_s = fmaxf(c, eps);
  const float m = fminf(
      fminf(edge_x(a, b, c, c_s, lx, ly, hy), edge_x(a, b, c, c_s, hx, ly, hy)),
      fminf(edge_y(a, b, c, a_s, ly, lx, hx), edge_y(a, b, c, a_s, hy, lx, hx)));
  return inside ? 0.f : fmaxf(m, 0.f);
}

// Q at the box's farthest corner: its max over the box (Q is convex);
// binning._rect_max_Q's operation order
__device__ __forceinline__ float rect_max_q(float a, float b, float c, float lx,
                                            float hx, float ly, float hy) {
  auto q = [&](float dx, float dy) {
    return 0.5f * a * dx * dx + b * dx * dy + 0.5f * c * dy * dy;
  };
  return fmaxf(fmaxf(q(lx, ly), q(lx, hy)), fmaxf(q(hx, ly), q(hx, hy)));
}

constexpr int SAT_Q_BITS = 6;

// 6-bit -log2(1 - alpha_min) in quarter units, rounded down; binning._sat_q
__device__ __forceinline__ int32_t sat_q(float op, float max_q) {
  const float raw_min = op * expf(-max_q) * 0.98f;
  const float alpha_min =
      raw_min >= static_cast<float>(1.0 / 255.0) ? fminf(raw_min, 0.99f) : 0.f;
  const float lb = -log1pf(-alpha_min) * static_cast<float>(1.4426950408889634);
  const int32_t q = static_cast<int32_t>(floorf(lb * 4.f));
  return min(max(q, 0), (1 << SAT_Q_BITS) - 1);
}

__global__ void expand_pairs_kernel(
    const int32_t* __restrict__ table, int n, const int32_t* __restrict__ total_p,
    int S, int tw, float ts, int db, int n_orig, int do_cull, int sat_pack,
    float alpha_thresh,
    int32_t key_invalid, int32_t* __restrict__ key_out,
    int32_t* __restrict__ gid_out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= S) return;
  int32_t key = key_invalid, gid = sat_pack ? n_orig << SAT_Q_BITS : n_orig;
  if (p < *total_p) {
    // owning row = #{rows with offset <= p} - 1; row 0 is live at offset 0
    const int32_t* off = table + static_cast<size_t>(COL_OFF) * n;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= p) lo = mid + 1; else hi = mid;
    }
    const int row = lo - 1;
    auto col = [&](int c) { return table[static_cast<size_t>(c) * n + row]; };
    const int local = p - col(COL_OFF);
    const int w = col(COL_W);
    const int x0y0 = col(COL_X0Y0);
    const int tx = (x0y0 & 0xFFFF) + local % w;
    const int ty = (x0y0 >> 16) + local / w;
    bool keep = true;
    int32_t q = 0;
    if (do_cull) {
      const float lx = static_cast<float>(tx) * ts - __int_as_float(col(COL_MX));
      const float ly = static_cast<float>(ty) * ts - __int_as_float(col(COL_MY));
      const float ca = __int_as_float(col(COL_CA)), cb = __int_as_float(col(COL_CB)),
                  cc = __int_as_float(col(COL_CC)), op = __int_as_float(col(COL_OP));
      const float hx = lx + (ts - 1.f), hy = ly + (ts - 1.f);
      keep = op * expf(-rect_min_q(ca, cb, cc, lx, hx, ly, hy)) >= alpha_thresh;
      if (keep && sat_pack) q = sat_q(op, rect_max_q(ca, cb, cc, lx, hx, ly, hy));
    }
    if (keep) {
      key = ((ty * tw + tx) << db) | col(COL_DQ);
      gid = sat_pack ? (col(COL_GID) << SAT_Q_BITS) | q : col(COL_GID);
    }
  }
  key_out[p] = key;
  gid_out[p] = gid;
}

}  // namespace

// table: (nc, n) int32 column-major; total: device int32 scalar; key, gid:
// (S,) int32; sat_pack needs do_cull. Returns cudaGetLastError() after the
// launch.
extern "C" int expand_pairs_launch(const void* table, int n, const void* total,
                                   int S, int tw, int tile_size, int db,
                                   int n_orig, int do_cull, int sat_pack,
                                   float alpha_thresh,
                                   int key_invalid, void* key, void* gid,
                                   void* stream) {
  if (S > 0) {
    constexpr int kThreads = 256;
    const int blocks = (S + kThreads - 1) / kThreads;
    expand_pairs_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), n,
        static_cast<const int32_t*>(total), S, tw,
        static_cast<float>(tile_size), db, n_orig, do_cull, sat_pack, alpha_thresh,
        key_invalid, static_cast<int32_t*>(key), static_cast<int32_t*>(gid));
  }
  return static_cast<int>(cudaGetLastError());
}
