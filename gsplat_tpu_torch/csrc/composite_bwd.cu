// composite_bwd: the backward sweep of composite_fwd. One block per image
// tile, one thread per 2x2 block of pixels.
//
// Replaces the TPU kernel gsplat_tpu/render/raster_pallas.py::_bwd_kernel
// (through _bwd_call / composite_bwd). Block t replays exactly nproc[t]
// chunks of its tile's chunk-aligned segment of the sorted gids, front to
// back, as the forward composited them (pairs outside [tile_start,
// +tile_count) masked to opacity 0), pair i's attributes read as row gid[i]
// of the (N+1, 16) per-Gaussian rows (composite_fwd.cu: no pair table), and
// writes one 16-float d-row per swept pair into the tile's own
// region of the d-table: row comp_start[t] + j*chunk + k holds
//   d mean x | d mean y | d conic a, b, c | d r, g, b | d opacity |
//   the pair's gid as an f32 key (KEY_INVALID on masked rows) | 0 x 6.
// Regions of different tiles do not overlap (the caller's cumsum of
// nproc*chunk), so no two blocks write one row and there are no atomics;
// rows no region covers keep the caller's prefill (zeros, KEY_INVALID).
// A tile with nproc = 0 writes nothing.
//
// Per pixel and pair, the quantities of raster_pallas.py:686-747:
//   t_i    = t_exc * t_run      (in-chunk exclusive product, carried T)
//   w      = alpha * t_i,  cg = rgb . g_rgb
//   pref   = (in-chunk inclusive sum of w*cg) + carried prefix
//   dalpha = chain * (t_i*cg - ((total_cg - pref) + t_final*g_t) / (1 - alpha))
//   gda    = G * dalpha,  dpow = opacity * gda
// and each pair's d-values are sums over the tile's pixels of
//   w*g_rgb (3), gda (1), dpow * [px^2, py^2, px*py, px, py, 1] (6),
// the last six turned into d conic and d mean by the reference's algebra
// (d_a = -0.5*dU0 + mxl*dU3 - 0.5*mxl*mxl*dU5, ...). total_cg is the
// forward's saved colour dotted with the cotangent, so no suffix pass runs.
//
// Bound on this card: operations. Each replayed chunk costs chunk * ts^2
// pair-pixel evaluations of ~65 f32 operations, one expf and (where the pair
// touches the pixel) a division, against 64 bytes read and 64 written per
// pair. A thread per pixel spent more instructions on the ten per-pair
// warp sums (ten xor butterflies, 100 per 32 pixels) than on the replay, ran
// the whole replay where alpha is 0, and summed 32 warps' partials on 32
// threads. Design, against that count:
//   - a thread holds a 2x2 pixel block, at the warp map of composite_fwd
//     (block_origin; a warp is a 16x8-pixel rectangle at tile 32): the
//     power's products are shared by pixel pairs, a pair costs three
//     broadcast 16-byte shared loads for four pixels, and each of the ten
//     values is summed over the thread's four pixels first.
//   - the exact warp-uniform skip of composite_fwd: staging computes each
//     pair's threshold thr = logf(1/255 / op) - 1e-3 (+inf where op is 0,
//     which covers the masked rows). Where every valid pixel of the warp has
//     power < thr, alpha is 0 at each of them, so w = 0, chain = 0, dalpha =
//     0: all ten sums are 0, and t_exc and the running colour sum keep their
//     bits (t_exc * 1, s + 0 * cg). The warp skips the replay and the
//     reductions of that pair and writes zeros as its share.
//   - a reduce-scatter across the warp: the ten values halve at each xor
//     step (10 -> 5 -> 3 -> 2 -> 1, then the last pair of lanes), 12
//     shuffles in place of 50, and lanes 0, 2, ... of the warp each end with
//     one of the ten warp totals.
//   - the cross-warp sum runs once per 32 pairs on all threads, eight a
//     pair, over the 8 warps (2 at tile 16) in warp order, from a
//     double-buffered shared array: one barrier per 32 pairs. Every sum's
//     order is fixed, so two launches give the same bits.
//   - staging one chunk ahead, as in composite_fwd: every thread copies its
//     rows of the next chunk with 16-byte cp.async while the block replays
//     this one, each row through its pair's gid, the gids a chunk further
//     ahead (composite_fwd.cu's prefetch_rows). nproc is known, so there is
//     no exit vote.
//   - two blocks an SM (96 registers, no spills). Capped at 80 for a third
//     block the kernel ran ~9% faster but spilled, with the per-pixel
//     cotangent terms in registers and with them in shared memory alike.
//   - tiles from 33 to 64 run in composite_fwd's pixel passes (256
//     threads, pass p on map thread p * 256 + tid). Within a round of 32
//     pairs the passes run in turn, and each adds its warp totals into the
//     lane's slot of the partial array after the passes before it; the
//     cross-warp round then sums the warps as before. So a d-row sums its
//     pixels pass by pass within a warp, then warp by warp: a fixed order.
//   - tiles above 64 run in composite_fwd's windows (composite_bwd_windows:
//     windows of at most 64x64 pixels, each cut into units of 256 map
//     threads). Each unit replays the tile's nproc chunks over its pixels
//     with the one-pass body above, its running state in registers. A
//     unit's six basis sums are taken about its window's centre, not the
//     tile's (the d-values are the same sums of dpow * (pixel - mean) terms
//     either way): about the tile's centre the basis reaches 64^2 at tile
//     128 where a splat's own terms are a few px^2, and the algebra that
//     turns the sums into d conic cancels them, ~1e-4 of a column's max in
//     f32, where about a window's centre it stays at tile 64's ~2e-5. Each
//     unit turns its sums into d-values, and a d-row adds them unit by
//     unit: the first unit writes the row, each later one adds its values
//     (the block's own rows: no atomics). So a d-row sums its pixels in a
//     fixed order, and two launches give the same bits.
// --fmad=false and an IEEE division keep the plain version's rounding of
// the power, of alpha and of the alpha >= 1/255 decision (the forward's
// decisions); only the pixel sums use explicit fused multiply-adds.
//
// The packed rows (PACK, the port of _bwd_kernel's packed branch,
// raster_pallas.py:687-697): composite_fwd's (N+1, 8) rows of 32 bytes, two
// 16-byte copies a pair, rgb and opacity unpacked from their bf16 halves in
// staging, the key from column 7. The replay runs on the unpacked values
// and the d-rows are the same 16 columns: the gradient passes straight
// through the bf16 rounding, as the reference's does.

#include "common.cuh"

#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kAttrDim = 16;   // a d-table row (and a 16-column attribute row)
// an attribute row: 16 floats, or 8 packed
template <bool PACK>
constexpr int kRowDim = PACK ? 8 : 16;
// the 16-byte pieces of a row the kernel copies: columns 0-11, or 0-7 packed
template <bool PACK>
constexpr int kRowVecs = PACK ? 2 : 3;
constexpr int kSums = 10;         // per pair: w*g (3), gda (1), dpow * basis (6)
constexpr int kSub = 32;          // pairs per cross-warp round
// threads of a block: a 32x32 tile's 2x2 pixel blocks. A tile up to kWin
// runs in pixel passes of kMaxThreads blocks each, up to four (tile 64); a
// larger one in windows of at most kWin x kWin pixels.
constexpr int kMaxThreads = 256;
constexpr int kWin = 64;
constexpr unsigned kFull = 0xffffffffu;
// render/raster.py::SKIP_MARGIN: the skip's margin below log(1/255 / op)
constexpr float kSkipMargin = 1e-3f;

// Upper-left pixel of thread tid's 2x2 block in a w x h rectangle (a tile
// or a window): composite_fwd.cu's map (render/raster.py::fwd_pixel_blocks).
__device__ __forceinline__ void block_origin(int tid, int w, int h, int& x0, int& y0) {
  if (w % 16 == 0 && h % 8 == 0) {
    const int warp = tid >> 5, lane = tid & 31, wpr = w / 16;
    x0 = (warp % wpr) * 16 + (lane & 7) * 2;
    y0 = (warp / wpr) * 8 + (lane >> 3) * 2;
  } else {
    const int nbx = (w + 1) / 2;
    x0 = (tid % nbx) * 2;
    y0 = (tid / nbx) * 2;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Chunk jj's rows, staged by gid into raw, chunk jj + 1's gids (jj + 1 <
// np) into the other half of the two chunks of gids that follow raw:
// composite_fwd.cu's prefetch_rows.
template <bool PACK, bool FIRST>
__device__ __forceinline__ void prefetch_rows(const float* __restrict__ attrs,
                                              const int32_t* __restrict__ gid, float4* raw,
                                              int astart, int jj, int np, int chunk) {
  int32_t* s_gid = reinterpret_cast<int32_t*>(raw + kRowVecs<PACK> * chunk);
  const int32_t* cur = s_gid + (jj & 1) * chunk;
  int32_t* nxt = s_gid + ((jj + 1) & 1) * chunk;
  const int next = astart + (jj + 1) * chunk;
  for (int k = threadIdx.x; k < chunk; k += blockDim.x) {
    const int32_t g = FIRST ? __ldg(gid + astart + k) : cur[k];
    const float* a = attrs + static_cast<size_t>(g) * kRowDim<PACK>;
#pragma unroll
    for (int v = 0; v < kRowVecs<PACK>; ++v) cp_async16(raw + kRowVecs<PACK> * k + v, a + 4 * v);
    if (jj + 1 < np) cp_async4(nxt + k, gid + next + k);
  }
  cp_async_commit();
}

// Copied row k's columns 0-11 in the 16-column layout (composite_fwd.cu's
// row_columns): (mx, my, a, b), (c, r, g, b), (op, gid, -, -).
template <bool PACK>
__device__ __forceinline__ void row_columns(const float4* raw, int k, float4& a0, float4& a1,
                                            float4& a2) {
  if constexpr (PACK) {
    const float4 p0 = raw[2 * k], p1 = raw[2 * k + 1];
    const unsigned rg = __float_as_uint(p1.y), bo = __float_as_uint(p1.z);
    a0 = p0;
    a1 = make_float4(p1.x, __uint_as_float(rg & 0xFFFF0000u), __uint_as_float(rg << 16),
                     __uint_as_float(bo & 0xFFFF0000u));
    a2 = make_float4(__uint_as_float(bo << 16), p1.w, 0.f, 0.f);
  } else {
    a0 = raw[3 * k], a1 = raw[3 * k + 1], a2 = raw[3 * k + 2];
  }
}

// keep + the partner's send, across the xor distance `o`
__device__ __forceinline__ float swap_add(bool hi, float lo_keep, float hi_keep, int o) {
  const float keep = hi ? hi_keep : lo_keep;
  const float send = hi ? lo_keep : hi_keep;
  return keep + __shfl_xor_sync(kFull, send, o);
}

// The warp totals of v[0..9], scattered: at each xor step a lane keeps the
// half of its values its side of the step owns and adds the partner's copy
// of them. Lane l ends holding the total of value reduce_slot(l) (lanes
// with an odd index hold their even neighbour's; some hold none).
__device__ __forceinline__ float warp_reduce_scatter(const float (&v)[kSums], int lane) {
  float u[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) u[i] = swap_add(lane & 16, v[i], v[i + 5], 16);
  // 5 -> 3: the low side keeps u0..u2, the high side u3, u4 and a zero
  const bool h8 = lane & 8;
  const float w0 = swap_add(h8, u[0], u[3], 8);
  const float w1 = swap_add(h8, u[1], u[4], 8);
  const float w2 = swap_add(h8, u[2], 0.f, 8);
  // 3 -> 2: the low side keeps w0, w1, the high side w2 and a zero
  const bool h4 = lane & 4;
  const float x0 = swap_add(h4, w0, w2, 4);
  const float x1 = swap_add(h4, w1, 0.f, 4);
  // 2 -> 1, then the last pair of lanes
  const float y = swap_add(lane & 2, x0, x1, 2);
  return y + __shfl_xor_sync(kFull, y, 1);
}

// The value index whose warp total warp_reduce_scatter leaves in lane l, for
// even lanes; -1 where the lane holds none (or is odd).
__device__ __forceinline__ int reduce_slot(int lane) {
  if (lane & 1) return -1;
  const int base = (lane & 16) ? 5 : 0;
  const bool h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
  if (!h8) return h4 ? (h2 ? -1 : base + 2) : base + (h2 ? 1 : 0);
  return h4 ? -1 : base + 3 + (h2 ? 1 : 0);
}

// The cotangent terms of a thread's four pixels at block origin (x0, y0):
// g_rgb, the forward colour dotted with it (total_cg) and t_final * g_t.
// Index: the type of a pixel's offset in the tile's four planes (int up to
// tile 64, size_t above).
template <typename Index>
__device__ __forceinline__ void load_cotangent(
    const float* __restrict__ res, const float* __restrict__ gt, int ts, int x0, int y0,
    const bool (&valid)[4], float (&gr)[4], float (&gg)[4], float (&gb)[4],
    float (&total_cg)[4], float (&tf_gt)[4]) {
  const Index npix = static_cast<Index>(ts) * ts;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Index p = static_cast<Index>(y0 + (q >> 1)) * ts + x0 + (q & 1);
    gr[q] = gg[q] = gb[q] = total_cg[q] = tf_gt[q] = 0.f;
    if (valid[q]) {
      gr[q] = gt[p];
      gg[q] = gt[npix + p];
      gb[q] = gt[2 * npix + p];
      total_cg[q] = res[p] * gr[q] + res[npix + p] * gg[q] + res[2 * npix + p] * gb[q];
      tf_gt[q] = res[3 * npix + p] * gt[3 * npix + p];
    }
  }
}

#define COMPOSITE_BWD_ARGS                                                              \
  const float *__restrict__ attrs, const int32_t *__restrict__ gid,                     \
      const int32_t *__restrict__ tile_start,                                           \
      const int32_t *__restrict__ tile_count, const int32_t *__restrict__ comp_start,  \
      const int32_t *__restrict__ nproc, const float *__restrict__ tiles,              \
      const float *__restrict__ g_tiles, int tw, int tile_size, int chunk, int p_out,  \
      float alpha_min, float alpha_max, float key_invalid, float *__restrict__ d_out
#define COMPOSITE_BWD_PASS                                                            \
  attrs, gid, tile_start, tile_count, comp_start, nproc, tiles, g_tiles, tw, tile_size, chunk, \
      p_out, alpha_min, alpha_max, key_invalid, d_out

// The replay of tile blockIdx.x's nproc chunks over the pixels of map
// threads v0 + p * blockDim.x + tid (p < NPASS) of the ww x wh window at
// (wx, wy) of the tile (the whole tile: (0, 0, ts, ts, v0 = 0)). With more
// than one pass the per-pixel running state of every pass stays in
// registers, and the cotangent terms are reloaded for each pass of a
// round. WIN: one unit of composite_bwd_windows, whose basis sums are
// taken about its window's centre and whose d-values add to the d-rows the
// units before it wrote (`first`: none has). PACK: the packed rows.
template <int NPASS, bool PACK, bool WIN>
__device__ __forceinline__ void replay_tile(COMPOSITE_BWD_ARGS, int np, int wx, int wy,
                                            int ww, int wh, int v0, bool first) {
  // per pair: (mx - ox, my - oy, 0.5 a, b), (0.5 c, r, g, b), (op, thr, a, c);
  // then the raw rows of the next chunk (columns 0-11, or 0-7 packed),
  // copied in flight; then two chunks of gids (prefetch_rows); then two
  // buffers of [warp][pair of the round][sum] partials; then the keys
  extern __shared__ float4 sm[];
  float4* raw = sm + 3 * chunk;
  const int nwarps = blockDim.x >> 5;
  float* s_part = reinterpret_cast<float*>(sm + (3 + kRowVecs<PACK>) * chunk) + 2 * chunk;
  const int part_size = nwarps * kSub * kSums;
  float* s_key = s_part + 2 * part_size;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ts = tile_size;
  const size_t npix = static_cast<size_t>(ts) * ts;
  const int nblk = ((ww + 1) / 2) * ((wh + 1) / 2);
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int astart = (start / chunk) * chunk;
  const int head = start - astart;
  const int ostart = comp_start[t];
  const int h = ts / 2;
  const float ox = static_cast<float>((t % tw) * ts + h);
  const float oy = static_cast<float>((t / tw) * ts + h);
  // pass p runs the 2x2 block of thread p * blockDim.x + tid of
  // fwd_pixel_blocks' map; pixel q of a block: x0 + (q & 1), y0 + (q >> 1)
  int x0[NPASS], y0[NPASS];
  float px0[NPASS], px1[NPASS], py0[NPASS], py1[NPASS];
  bool valid[NPASS][4];
#pragma unroll
  for (int p = 0; p < NPASS; ++p) {
    const int v = v0 + p * blockDim.x + tid;
    block_origin(v, ww, wh, x0[p], y0[p]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      valid[p][q] = v < nblk && x0[p] + (q & 1) < ww && y0[p] + (q >> 1) < wh;
    x0[p] += wx, y0[p] += wy;
    px0[p] = static_cast<float>(x0[p] - h), px1[p] = static_cast<float>(x0[p] + 1 - h);
    py0[p] = static_cast<float>(y0[p] - h), py1[p] = static_cast<float>(y0[p] + 1 - h);
  }
  const int slot = reduce_slot(lane);
  // the basis's origin: the window's centre in tile-centred pixels (an
  // integer, so the shifted pixel coordinates stay exact)
  const float wcx = static_cast<float>(wx + ww / 2 - h);
  const float wcy = static_cast<float>(wy + wh / 2 - h);

  const float* res = tiles + static_cast<size_t>(t) * 4 * npix;
  const float* gt = g_tiles + static_cast<size_t>(t) * 4 * npix;
  float gr[4], gg[4], gb[4], total_cg[4], tf_gt[4];
  using Index = typename std::conditional<WIN, size_t, int>::type;
  if (NPASS == 1)
    load_cotangent<Index>(res, gt, ts, x0[0], y0[0], valid[0], gr, gg, gb, total_cg, tf_gt);

  prefetch_rows<PACK, true>(attrs, gid, raw, astart, 0, np, chunk);

  float t_run[NPASS][4], prefix[NPASS][4];
#pragma unroll
  for (int p = 0; p < NPASS; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) t_run[p][q] = 1.f, prefix[p][q] = 0.f;
  int rnd = 0;  // rounds so far: selects the partial buffer
  for (int j = 0; j < np; ++j) {
    __syncthreads();  // every thread is done with the previous chunk's records
    cp_async_wait_all();
    for (int k = tid; k < chunk; k += blockDim.x) {
      const int idx = j * chunk + k;
      float4 a0, a1, a2;
      row_columns<PACK>(raw, k, a0, a1, a2);
      const bool ok = idx >= head && idx < head + count;
      const float op = ok ? a2.x : 0.f;
      const float thr = op > 0.f ? logf(alpha_min / op) - kSkipMargin : CUDART_INF_F;
      sm[3 * k] = make_float4(a0.x - ox, a0.y - oy, 0.5f * a0.z, a0.w);
      sm[3 * k + 1] = make_float4(0.5f * a1.x, a1.y, a1.z, a1.w);
      sm[3 * k + 2] = make_float4(op, thr, a0.z, a1.x);
      s_key[k] = ok ? a2.y : key_invalid;
    }
    // the next chunk's rows travel while this one is replayed
    if (j + 1 < np) prefetch_rows<PACK, false>(attrs, gid, raw, astart, j + 1, np, chunk);
    __syncthreads();

    float t_exc[NPASS][4], csum[NPASS][4];
#pragma unroll
    for (int p = 0; p < NPASS; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) t_exc[p][q] = 1.f, csum[p][q] = 0.f;
    for (int k0 = 0; k0 < chunk; k0 += kSub, ++rnd) {
      const int kn = min(kSub, chunk - k0);
      float* part = s_part + (rnd & 1) * part_size;
      // each pass adds its warp totals into the lane's slot, passes in
      // order: the warp's share of a pair sums pass 0, 1, ... in turn
#pragma unroll
      for (int p = 0; p < NPASS; ++p) {
        if (NPASS > 1)
          load_cotangent<Index>(res, gt, ts, x0[p], y0[p], valid[p], gr, gg, gb, total_cg,
                                tf_gt);
        // kept a loop: unrolled 32 times (nvcc does so at one pass) the
        // round's code outgrows the instruction cache, ~7x slower
#pragma unroll 1
        for (int kk = 0; kk < kn; ++kk) {
          const int k = k0 + kk;
          const float4 g0 = sm[3 * k], g1 = sm[3 * k + 1], g2 = sm[3 * k + 2];
          const float dx0 = px0[p] - g0.x, dx1 = px1[p] - g0.x;
          const float dy0 = py0[p] - g0.y, dy1 = py1[p] - g0.y;
          const float ax0 = g0.z * (dx0 * dx0), ax1 = g0.z * (dx1 * dx1);
          const float cy0 = g1.x * (dy0 * dy0), cy1 = g1.x * (dy1 * dy1);
          float power[4];
          power[0] = -((ax0 + g0.w * (dx0 * dy0)) + cy0);
          power[1] = -((ax1 + g0.w * (dx1 * dy0)) + cy0);
          power[2] = -((ax0 + g0.w * (dx0 * dy1)) + cy1);
          power[3] = -((ax1 + g0.w * (dx1 * dy1)) + cy1);
          bool below = true;
#pragma unroll
          for (int q = 0; q < 4; ++q) below &= power[q] < g2.y || !valid[p][q];
          float* dst = part + (warp * kSub + kk) * kSums;
          if (__all_sync(kFull, below)) {
            if (p == 0 && slot >= 0) dst[slot] = 0.f;
            continue;
          }
          const float op = g2.x;
          float sr = 0.f, sg = 0.f, sb = 0.f, sgda = 0.f, dpow[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float G = expf(power[q] > 0.f ? -100.f : power[q]);
            const float raw_a = op * G;
            const bool keep = valid[p][q] && raw_a >= alpha_min;
            const float alpha = keep ? fminf(raw_a, alpha_max) : 0.f;
            const float t_i = t_exc[p][q] * t_run[p][q];
            const float w = alpha * t_i;
            const float cg = g1.y * gr[q] + g1.z * gg[q] + g1.w * gb[q];
            csum[p][q] += w * cg;
            float dalpha = 0.f;
            if (keep && raw_a <= alpha_max)
              dalpha = t_i * cg - ((total_cg[q] - (csum[p][q] + prefix[p][q])) + tf_gt[q]) /
                                      (1.f - alpha);
            const float gda = G * dalpha;
            dpow[q] = op * gda;
            sr = __fmaf_rn(w, gr[q], sr);
            sg = __fmaf_rn(w, gg[q], sg);
            sb = __fmaf_rn(w, gb[q], sb);
            sgda += gda;
            t_exc[p][q] *= 1.f - alpha;
          }
          // the basis sums over the block: columns x0, x1 and rows y0, y1,
          // about the tile's centre (a window's with WIN)
          const float sx0 = dpow[0] + dpow[2], sx1 = dpow[1] + dpow[3];
          const float sy0 = dpow[0] + dpow[1], sy1 = dpow[2] + dpow[3];
          const float bx0 = WIN ? px0[p] - wcx : px0[p], bx1 = WIN ? px1[p] - wcx : px1[p];
          const float by0 = WIN ? py0[p] - wcy : py0[p], by1 = WIN ? py1[p] - wcy : py1[p];
          float v[kSums];
          v[0] = sr;
          v[1] = sg;
          v[2] = sb;
          v[3] = sgda;
          v[4] = __fmaf_rn(bx1 * bx1, sx1, (bx0 * bx0) * sx0);
          v[5] = __fmaf_rn(by1 * by1, sy1, (by0 * by0) * sy0);
          v[6] = __fmaf_rn(bx1 * by1, dpow[3],
                           __fmaf_rn(bx0 * by1, dpow[2],
                                     __fmaf_rn(bx1 * by0, dpow[1], (bx0 * by0) * dpow[0])));
          v[7] = __fmaf_rn(bx1, sx1, bx0 * sx0);
          v[8] = __fmaf_rn(by1, sy1, by0 * sy0);
          v[9] = sx0 + sx1;
          const float total = warp_reduce_scatter(v, lane);
          if (slot >= 0) dst[slot] = p == 0 ? total : dst[slot] + total;
        }
      }
      __syncthreads();
      // the round's cross-warp sums: eight threads a pair, thread s of a
      // pair summing values s (and s + 8) over the warps in warp order
      for (int p0 = 0; p0 < kn; p0 += blockDim.x >> 3) {
        const int p = p0 + (tid >> 3), s = tid & 7;
        const bool act = p < kn;
        const int pc = act ? p : 0;
        float t0 = 0.f, t1 = 0.f;
        for (int wi = 0; wi < nwarps; ++wi) {
          const float* src = part + (wi * kSub + pc) * kSums;
          t0 += src[s];
          if (s < kSums - 8) t1 += src[8 + s];
        }
        float tot[kSums];
#pragma unroll
        for (int i = 0; i < kSums; ++i)
          tot[i] = __shfl_sync(kFull, i < 8 ? t0 : t1, (lane & ~7) | (i & 7));
        const int k = k0 + pc;
        const float4 g0 = sm[3 * k], g2 = sm[3 * k + 2];
        // the mean relative to the basis's origin
        float mxl = g0.x, myl = g0.y;
        if constexpr (WIN) mxl -= wcx, myl -= wcy;
        const float ca = g2.z, cb = g0.w, cc = g2.w;
        const float du0 = tot[4], du1 = tot[5], du2 = tot[6];
        const float du3 = tot[7], du4 = tot[8], du5 = tot[9];
        float2 o = make_float2(0.f, 0.f);
        if (s == 0) {
          o.x = (ca * du3 + cb * du4) - (ca * mxl + cb * myl) * du5;
          o.y = (cb * du3 + cc * du4) - (cc * myl + cb * mxl) * du5;
        } else if (s == 1) {
          o.x = (-0.5f * du0 + mxl * du3) - ((0.5f * mxl) * mxl) * du5;
          o.y = ((-du2 + myl * du3) + mxl * du4) - (mxl * myl) * du5;
        } else if (s == 2) {
          o.x = (-0.5f * du1 + myl * du4) - ((0.5f * myl) * myl) * du5;
          o.y = tot[0];
        } else if (s == 3) {
          o = make_float2(tot[1], tot[2]);
        } else if (s == 4) {
          o = make_float2(tot[3], s_key[k]);
        }
        const int row = ostart + j * chunk + k;
        if (act && row >= 0 && row < p_out) {
          float2* drow = reinterpret_cast<float2*>(d_out + static_cast<size_t>(row) * kAttrDim);
          if (WIN && !first) {
            // the d-values of the units before this one (the key is the same)
            const float2 prev = __ldcg(drow + s);
            o.x = prev.x + o.x;
            if (s != 4) o.y = prev.y + o.y;
          }
          drow[s] = o;
        }
      }
      // no barrier here: the next round writes the other buffer, and the
      // round after it passes the next round's barrier first
    }
#pragma unroll
    for (int p = 0; p < NPASS; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        t_run[p][q] *= t_exc[p][q];
        prefix[p][q] = csum[p][q] + prefix[p][q];
      }
  }
}

// NPASS pixel passes of blockDim.x 2x2 blocks each (one at tiles up to 32);
// two blocks an SM only at one pass.
template <int NPASS, bool PACK>
__global__ void __launch_bounds__(kMaxThreads, NPASS == 1 ? 2 : 1)
    composite_bwd_kernel(COMPOSITE_BWD_ARGS) {
  const int np = nproc[blockIdx.x];
  if (np <= 0) return;  // the same for every thread of the block
  replay_tile<NPASS, PACK, false>(COMPOSITE_BWD_PASS, np, 0, 0, tile_size, tile_size, 0, true);
}

// Tiles above kWin: composite_fwd_windows' windows and units, in its order,
// one unit at a time.
template <bool PACK>
__global__ void __launch_bounds__(kMaxThreads, 2) composite_bwd_windows(COMPOSITE_BWD_ARGS) {
  const int np = nproc[blockIdx.x];
  if (np <= 0) return;
  const int ts = tile_size;
  for (int wy = 0; wy < ts; wy += kWin)
    for (int wx = 0; wx < ts; wx += kWin) {
      const int ww = min(kWin, ts - wx), wh = min(kWin, ts - wy);
      const int nblk = ((ww + 1) / 2) * ((wh + 1) / 2);
      for (int v0 = 0; v0 < nblk; v0 += blockDim.x)
        replay_tile<1, PACK, true>(COMPOSITE_BWD_PASS, np, wx, wy, ww, wh, v0,
                                   wx == 0 && wy == 0 && v0 == 0);
    }
}

// fwd_pixel_blocks' threads at this tile size: one per 2x2 pixel block, in
// whole warps (render/raster.py::fwd_pixel_blocks).
int map_threads(int tile_size) {
  const int nbx = (tile_size + 1) / 2;
  return (nbx * nbx + 31) / 32 * 32;
}

template <int NPASS, bool PACK>
cudaError_t launch(int num_tiles, int threads, int chunk, cudaStream_t stream,
                   const float* attrs, const int32_t* gid, const int32_t* tile_start,
                   const int32_t* tile_count, const int32_t* comp_start,
                   const int32_t* nproc, const float* tiles, const float* g_tiles,
                   int tw, int tile_size, int p_out, float alpha_min, float alpha_max,
                   float key_invalid, float* d_out) {
  // the staged records, the copy of the next chunk, two chunks of gids,
  // the partials and the keys
  const size_t smem = (3 + kRowVecs<PACK>) * sizeof(float4) * static_cast<size_t>(chunk) +
                      sizeof(float) * (2 * static_cast<size_t>(threads / 32) * kSub * kSums +
                                       static_cast<size_t>(chunk)) +
                      2 * sizeof(int32_t) * static_cast<size_t>(chunk);
  void (*kernel)(COMPOSITE_BWD_ARGS);
  if constexpr (NPASS == 0) {
    kernel = composite_bwd_windows<PACK>;
  } else {
    kernel = composite_bwd_kernel<NPASS, PACK>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<num_tiles, threads, smem, stream>>>(
      attrs, gid, tile_start, tile_count, comp_start, nproc, tiles, g_tiles, tw, tile_size,
      chunk, p_out, alpha_min, alpha_max, key_invalid, d_out);
  return cudaGetLastError();
}

template <bool PACK>
cudaError_t launch_passes(int npass, int num_tiles, int threads, int chunk, cudaStream_t st,
                          const float* a, const int32_t* gi, const int32_t* s,
                          const int32_t* c, const int32_t* cs, const int32_t* np, const float* r,
                          const float* g, int tw, int tile_size, int p_out, float alpha_min,
                          float alpha_max, float key_invalid, float* d) {
  switch (npass) {
    case 0: return launch<0, PACK>(num_tiles, threads, chunk, st, a, gi, s, c, cs, np, r, g, tw,
                                   tile_size, p_out, alpha_min, alpha_max, key_invalid, d);
    case 1: return launch<1, PACK>(num_tiles, threads, chunk, st, a, gi, s, c, cs, np, r, g, tw,
                                   tile_size, p_out, alpha_min, alpha_max, key_invalid, d);
    case 2: return launch<2, PACK>(num_tiles, threads, chunk, st, a, gi, s, c, cs, np, r, g, tw,
                                   tile_size, p_out, alpha_min, alpha_max, key_invalid, d);
    case 3: return launch<3, PACK>(num_tiles, threads, chunk, st, a, gi, s, c, cs, np, r, g, tw,
                                   tile_size, p_out, alpha_min, alpha_max, key_invalid, d);
    default: return launch<4, PACK>(num_tiles, threads, chunk, st, a, gi, s, c, cs, np, r, g, tw,
                                    tile_size, p_out, alpha_min, alpha_max, key_invalid, d);
  }
}

}  // namespace

// attrs: (N+1, 16) float32 per-Gaussian rows, or (N+1, 8) packed where
// `packed` is nonzero, 16-byte aligned; gid: (P,) int32 sorted gids, each in
// [0, N], with P a multiple of chunk and every segment inside it; tile_start, tile_count, comp_start, nproc:
// (num_tiles,) int32; tiles, g_tiles: (num_tiles, 4, tile_size^2) float32;
// d_out: (p_out, 16) float32, prefilled by the caller. tile_size >= 1: up
// to kWin in pixel passes (1 to 4), above it in windows. alpha_min,
// alpha_max, key_invalid: render/raster.py's ALPHA_MIN, ALPHA_MAX,
// KEY_INVALID. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a tile below 1).
extern "C" int composite_bwd_launch(
    const void* attrs, const void* gid, const void* tile_start, const void* tile_count,
    const void* comp_start, const void* nproc, const void* tiles,
    const void* g_tiles, int num_tiles, int tw, int tile_size, int chunk,
    int p_out, int packed, float alpha_min, float alpha_max, float key_invalid,
    void* d_out, void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (tile_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  // pixel passes up to kWin (1 to 4); 0 selects the windows
  const int virt = tile_size <= kWin ? map_threads(tile_size) : kMaxThreads;
  const int threads = virt < kMaxThreads ? virt : kMaxThreads;
  const int npass = tile_size <= kWin ? (virt + kMaxThreads - 1) / kMaxThreads : 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(attrs);
  const auto* gi = static_cast<const int32_t*>(gid);
  const auto* s = static_cast<const int32_t*>(tile_start);
  const auto* c = static_cast<const int32_t*>(tile_count);
  const auto* cs = static_cast<const int32_t*>(comp_start);
  const auto* np = static_cast<const int32_t*>(nproc);
  const auto* r = static_cast<const float*>(tiles);
  const auto* g = static_cast<const float*>(g_tiles);
  auto* d = static_cast<float*>(d_out);
  const cudaError_t e =
      packed ? launch_passes<true>(npass, num_tiles, threads, chunk, st, a, gi, s, c, cs, np, r, g,
                                   tw, tile_size, p_out, alpha_min, alpha_max, key_invalid, d)
             : launch_passes<false>(npass, num_tiles, threads, chunk, st, a, gi, s, c, cs, np, r, g,
                                    tw, tile_size, p_out, alpha_min, alpha_max, key_invalid, d);
  return static_cast<int>(e);
}
