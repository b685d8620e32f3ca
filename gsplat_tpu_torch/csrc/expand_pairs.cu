// expand_pairs: (Gaussian, tile) pair expansion. One block per 1024 items
// of the merged sequence of pair slots and table rows.
//
// Replaces the TPU kernel gsplat_tpu/render/expand_pallas.py::_expand_kernel
// (through expand_pairs, from binning._expand_fused). For each slot p < S it
// finds the owning Gaussian in the live-compacted column table (the last row
// whose pair offset is <= p), decomposes that Gaussian's tile rectangle into
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
// Bound on this card: memory. Each slot writes 8 bytes; the table (one row
// per Gaussian) is read once; the arithmetic is a few integer operations
// plus, with the cull, ~40 f32 operations, four divisions and one expf.
// A binary search of the offset column per slot (about 20 dependent L2 loads
// at 1M rows) made the kernel a latency chain that grew with the slot count:
// 0.83 ms for 32M slots against a 0.09 ms byte bound. Design, against it:
//   - a merge-path (load-balanced) partition: the slots [0, min(total, S))
//     and the row offsets, merged (a row before a slot when its offset is at
//     most the slot), are cut into blocks of kItems items. Two warps of each
//     block find where its range starts and ends with a 32-ary search of
//     the offset column (about 4 dependent loads at 1M rows); so a block's
//     row window never holds more than kItems + 1 rows, whatever the
//     distribution (one Gaussian over every tile, runs of one-slot rows).
//   - the window's columns are read once per block, coalesced, into shared
//     memory; each slot finds its row by a binary search there and reads
//     its columns there.
//   - slots at or past the live total write the invalid pair without a
//     search, in a grid-stride loop; every store is coalesced.

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

constexpr int kThreads = 256;
constexpr int kItems = 1024;  // merged items (slots and rows) per block
constexpr int kStride = kItems + 1;  // shared words per window column
constexpr unsigned kFull = 0xffffffffu;

// The number of rows among the first d items of the merged sequence of slots
// [0, T) and rows off[0..n): the largest b in [max(0, d - T), min(d, n)] with
// b == 0, d - b == T or off[b - 1] <= d - b (row b - 1 precedes slot d - b).
// The predicate falls from true to false as b grows; each step tests 32
// evenly spaced candidates, one a lane, and keeps the gap after the last
// that holds. Called by a whole warp; every lane returns the answer.
__device__ int merge_split(const int32_t* __restrict__ off, int n, int T, int d,
                           int lane) {
  int lo = max(0, d - T), hi = min(d, n);
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int c = min(lo + (lane + 1) * step, hi);
    const bool ok = d - c >= T || off[c - 1] <= d - c;
    const int held = __popc(__ballot_sync(kFull, ok));
    const int nlo = held ? min(lo + held * step, hi) : lo;
    hi = held < 32 ? min(lo + (held + 1) * step, hi) - 1 : hi;
    lo = nlo;
  }
  return lo;
}

template <int NC>
__global__ void __launch_bounds__(kThreads) expand_pairs_kernel(
    const int32_t* __restrict__ table, int n, const int32_t* __restrict__ total_p,
    int S, int tw, float ts, int db, int n_orig, int sat_pack, float alpha_thresh,
    int32_t key_invalid, int32_t* __restrict__ key_out,
    int32_t* __restrict__ gid_out) {
  extern __shared__ int32_t s_tab[];  // [column][window row], kStride apart
  __shared__ int s_split[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = min(*total_p, S);
  const int32_t gid_null = sat_pack ? n_orig << SAT_Q_BITS : n_orig;
  for (int p = T + blockIdx.x * kThreads + tid; p < S; p += gridDim.x * kThreads) {
    key_out[p] = key_invalid;
    gid_out[p] = gid_null;
  }
  const int len = T + n;
  const int d0 = min(blockIdx.x * kItems, len), d1 = min(d0 + kItems, len);
  if (warp < 2) {
    const int b = merge_split(table + static_cast<size_t>(COL_OFF) * n, n, T,
                              warp ? d1 : d0, lane);
    if (lane == 0) s_split[warp] = b;
  }
  __syncthreads();
  const int b0 = s_split[0], b1 = s_split[1];
  const int a0 = d0 - b0, a1 = d1 - b1;
  if (a0 >= a1) return;  // no slot in this block's range (the same for all)
  // window rows [r0, b1): the row that owns slot a0 may start before the
  // block's range (row b0 - 1)
  const int r0 = max(b0 - 1, 0), m = b1 - r0;
  for (int r = tid; r < m; r += kThreads) {
    int32_t v[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = table[static_cast<size_t>(c) * n + r0 + r];
#pragma unroll
    for (int c = 0; c < NC; ++c) s_tab[c * kStride + r] = v[c];
  }
  __syncthreads();
  const int first = b0 - r0;  // window index of the first row inside the range
  for (int p = a0 + tid; p < a1; p += kThreads) {
    // owning row = the last window row whose offset is <= p
    int lo = first, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_tab[mid] <= p) lo = mid + 1; else hi = mid;
    }
    const int row = lo - 1;
    auto col = [&](int c) { return s_tab[c * kStride + row]; };
    const int local = p - col(COL_OFF);
    const int w = col(COL_W);
    const int x0y0 = col(COL_X0Y0);
    const int tx = (x0y0 & 0xFFFF) + local % w;
    const int ty = (x0y0 >> 16) + local / w;
    bool keep = true;
    int32_t q = 0;
    if constexpr (NC > COL_OP) {
      const float lx = static_cast<float>(tx) * ts - __int_as_float(col(COL_MX));
      const float ly = static_cast<float>(ty) * ts - __int_as_float(col(COL_MY));
      const float ca = __int_as_float(col(COL_CA)), cb = __int_as_float(col(COL_CB)),
                  cc = __int_as_float(col(COL_CC)), op = __int_as_float(col(COL_OP));
      const float hx = lx + (ts - 1.f), hy = ly + (ts - 1.f);
      keep = op * expf(-rect_min_q(ca, cb, cc, lx, hx, ly, hy)) >= alpha_thresh;
      if (keep && sat_pack) q = sat_q(op, rect_max_q(ca, cb, cc, lx, hx, ly, hy));
    }
    int32_t key = key_invalid, gid = gid_null;
    if (keep) {
      key = ((ty * tw + tx) << db) | col(COL_DQ);
      gid = sat_pack ? (col(COL_GID) << SAT_Q_BITS) | q : col(COL_GID);
    }
    key_out[p] = key;
    gid_out[p] = gid;
  }
}

}  // namespace

// table: (nc, n) int32 column-major, nc 11 with the cull columns (do_cull)
// else 5; total: device int32 scalar; key, gid: (S,) int32; sat_pack needs
// do_cull; S + n below 2^31. Returns cudaGetLastError() after the launch.
extern "C" int expand_pairs_launch(const void* table, int n, const void* total,
                                   int S, int tw, int tile_size, int db,
                                   int n_orig, int do_cull, int sat_pack,
                                   float alpha_thresh,
                                   int key_invalid, void* key, void* gid,
                                   void* stream) {
  if (S > 0) {
    // every merged item has a block: the slots below the live total number
    // at most S, the rows n
    const int blocks = static_cast<int>((static_cast<long long>(S) + n + kItems - 1) / kItems);
    const int nc = do_cull ? COL_OP + 1 : COL_GID + 1;
    const size_t smem = sizeof(int32_t) * static_cast<size_t>(nc) * kStride;
    auto kernel = do_cull ? expand_pairs_kernel<COL_OP + 1> : expand_pairs_kernel<COL_GID + 1>;
    kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), n, static_cast<const int32_t*>(total), S, tw,
        static_cast<float>(tile_size), db, n_orig, sat_pack, alpha_thresh, key_invalid,
        static_cast<int32_t*>(key), static_cast<int32_t*>(gid));
  }
  return static_cast<int>(cudaGetLastError());
}
