// composite_fwd: forward front-to-back tile compositing over the compact
// sorted pair layout. One block per image tile, one thread per 2x2 block of
// pixels.
//
// Replaces the TPU kernel gsplat_tpu/render/raster_pallas.py::_fwd_kernel
// (through _fwd_call / composite_fwd). A tile's pairs are the segment
// [tile_start, +tile_count) of the (P,) sorted gids; pair i's attributes are
// row gid[i] of the (N+1, 16) per-Gaussian rows (row layout of
// render/raster.py: mean xy, conic abc, rgb, opacity, gid; row N the inert
// null Gaussian the padding slots point at). No (P, 16) pair table is
// gathered: the kernel stages each pair's row through its gid. The block
// walks the chunk-aligned superset of the segment: chunk j covers pairs
// [align_down(tile_start) + j*chunk, +chunk), and pairs outside the segment
// (neighbour tiles' pairs) are masked to opacity 0. Per pixel:
// alpha = min(op * exp(power <= 0 ? power : -100), 0.99), zeroed below 1/255,
// composited front to back. Before each chunk the block stops if every one of
// its pixels (those below the image's last row too) has T < 1e-4:
// __syncthreads_or, the reference's whole-tile exit at chunk granularity, so
// nproc[t] (chunks composited) matches it and the backward can replay it.
// Pixel coordinates are the reference's tile-centred ones:
// dx = (px - h) - (mx - ox), ox = tile_x * ts + h, h = ts / 2.
//
// Bound on this card: operations. Each composited chunk costs chunk * ts^2
// pair-pixel evaluations of ~31 f32 operations and one expf, against 64
// bytes of attributes per pair read once per tile: ~300 operations per byte
// at tile 32, far above the fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 per
// byte). So what bounds it is its instruction count: a thread per pixel
// ran 51.5 warp instructions per 32 pair-pixels in its inner loop (SASS;
// nine scalar shared-memory loads, the power's products for one pixel
// alone, unfused colour sums). Design, against that count (33.5 where a
// warp composites a pair, 11 where it skips one):
//   - a thread holds a 2x2 pixel block: dx, dy, dx*dx, dy*dy and their conic
//     products are shared by two pixels each, and a pair costs three
//     broadcast 16-byte shared loads for four pixels. At tile 32 a block is
//     256 threads, a warp a 16x8-pixel rectangle (tile 16: 64 threads).
//   - an exact warp-uniform skip: staging computes each pair's threshold
//     thr = logf(1/255 / op) - 1e-3 (+inf where op is 0, which covers the
//     masked rows). A warp whose pixels all have power < thr has alpha 0 at
//     every pixel: exp(power) < (1/255 / op) * e^-0.001, a margin far above
//     expf's and logf's few-ulp errors. It skips the rest of the pair, which
//     would leave every sum as it is bit for bit (w = 0, c + r*0 = c,
//     t_exc * 1 = t_exc) for finite colours.
//   - the colour sums are explicit __fmaf_rn (the library is built with
//     --fmad=false). Only the colour's rounding changes, within 2e-5 of the
//     plain version, which sums colour in matmul order anyway. The power,
//     alpha and transmittance chain stays unfused, as the plain version's
//     separate operations round it: the 1/255 test, the exit vote and the
//     backward's replay depend on its bits.
//   - staging one chunk ahead: every thread copies its rows of the next
//     chunk with 16-byte cp.async while the block composites this one, and
//     turns them into the packed pair records after the next exit vote.
//     The row of a pair is found through its gid, a dependent load: the
//     gids travel one chunk further ahead (a 4-byte cp.async of chunk j + 2's
//     gids beside chunk j + 1's rows, into shared memory), so issuing a
//     chunk's row copies never waits on its gids (only the first chunk's
//     gids are read from global memory before their copies).
//   - tiles from 33 to 64 run in pixel passes: the block stays at 256
//     threads, and in pass p thread tid takes the 2x2 block of map thread
//     p * 256 + tid (at tile 64 a pass is a 64x16 band). The kernel is a
//     template on the pass count, so one pass compiles to the tile-32 code;
//     with more, every pass's running state stays in registers (at most
//     128, two blocks an SM), a staged chunk is composited pass after pass,
//     and the exit vote covers all of the tile's pixels, so nproc is the
//     tile's and not a pass's.
//   - tiles above 64 run in windows (composite_fwd_windows): the tile is cut
//     into windows of at most 64x64 pixels, row-major (tile 96: 64 + 32 in
//     each direction), each mapped as a tile of its own size is, and cut
//     into units of 256 map threads. Each staged chunk is composited unit
//     after unit; a unit's running colour and T live in the output tile
//     between chunks (loaded before the chunk, stored after it: the same
//     bits as registers would hold), so the registers hold one unit's
//     state whatever the tile. The exit vote still covers every pixel of
//     the tile before each chunk: a window whose pixels saturate early goes
//     on compositing to the tile's exit, as the reference's pixels do.
// Within a chunk T is held fixed and the exclusive product of (1 - alpha)
// runs beside it, w = (alpha * t_exc) * T, T *= t_chunk after the chunk: the
// plain PyTorch version's association.
//
// The packed rows (PACK, the port of _fwd_kernel's packed branch,
// raster_pallas.py:572-577): (N+1, 8) rows of 32 bytes, mean xy, conic abc,
// (bf16(r) << 16) | bf16(g), (bf16(b) << 16) | bf16(opacity), the gid. A
// pair's copy is two 16-byte loads instead of three; staging unpacks rgb and
// opacity with a mask and a shift (a bf16 is the top half of an f32) into
// the same shared records, and everything after it runs as above. It halves
// the bytes a pair costs; the kernel stays bound by its operations.

#include "common.cuh"

#include <math_constants.h>

namespace {

// an attribute row: 16 floats, or 8 packed (see the note above)
template <bool PACK>
constexpr int kRowDim = PACK ? 8 : 16;
// the 16-byte pieces of a row the kernel copies: columns 0-11, or 0-7 packed
template <bool PACK>
constexpr int kRowVecs = PACK ? 2 : 3;
// threads of a block: a 32x32 tile's 2x2 pixel blocks. A tile up to kWin
// runs in pixel passes of kMaxThreads blocks each, up to four (tile 64); a
// larger one in windows of at most kWin x kWin pixels.
constexpr int kMaxThreads = 256;
constexpr int kWin = 64;
// render/raster.py::SKIP_MARGIN: the skip's margin below log(1/255 / op)
constexpr float kSkipMargin = 1e-3f;

// Upper-left pixel of thread tid's 2x2 block in a w x h rectangle of pixels
// (a tile, or a window of one). A width that is a multiple of 16 and a
// height that is a multiple of 8 give each warp a 16x8-pixel rectangle (8 x
// 4 blocks), which makes the skip likelier than a 32x4 strip; others go
// row-major over blocks. render/raster.py::fwd_pixel_blocks is the same map.
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

// 16-byte asynchronous copy from global to shared memory (sm_80 and up)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

// 4-byte asynchronous copy (the .ca form: .cg copies 16 bytes only)
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

// Chunk jj's rows, staged by gid into raw (columns 0-11, or 0-7 packed): a
// thread copies the rows of pairs k = tid, tid + blockDim.x, ... of the
// chunk, pair k's row being attrs[gid[astart + jj * chunk + k]], and later
// stages only rows it copied itself, so the copy needs no barrier of its
// own. Chunk jj's gids are in half jj & 1 of the two chunks of gids that
// follow raw in shared memory, copied there with chunk jj - 1's rows (with
// FIRST, for chunk 0, they are read from global memory); chunk jj + 1's
// gids, where there is such a chunk (jj + 1 < nch), go into the other half
// in the same copy group, by the thread that will read them.
template <bool PACK, bool FIRST>
__device__ __forceinline__ void prefetch_rows(const float* __restrict__ attrs,
                                              const int32_t* __restrict__ gid, float4* raw,
                                              int astart, int jj, int nch, int chunk) {
  int32_t* s_gid = reinterpret_cast<int32_t*>(raw + kRowVecs<PACK> * chunk);
  const int32_t* cur = s_gid + (jj & 1) * chunk;
  int32_t* nxt = s_gid + ((jj + 1) & 1) * chunk;
  // an int offset: a 64-bit pointer here made a pixel-pass kernel, at its
  // 128-register cap, spill
  const int next = astart + (jj + 1) * chunk;
  for (int k = threadIdx.x; k < chunk; k += blockDim.x) {
    const int32_t g = FIRST ? __ldg(gid + astart + k) : cur[k];
    const float* a = attrs + static_cast<size_t>(g) * kRowDim<PACK>;
#pragma unroll
    for (int v = 0; v < kRowVecs<PACK>; ++v) cp_async16(raw + kRowVecs<PACK> * k + v, a + 4 * v);
    if (jj + 1 < nch) cp_async4(nxt + k, gid + next + k);
  }
  cp_async_commit();
}

// Copied row k's columns 0-11 in the 16-column layout: (mx, my, a, b),
// (c, r, g, b), (op, gid, -, -). A packed row's rgb and opacity are the
// bf16 halves of its columns 5 and 6 (raster_pallas.py::_unpack_rgbop).
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

// Chunk j's copied rows (raw) -> the pair records the compositing reads
// (sm): thread tid stages the rows it copied, rows outside the segment
// [head, head + count) masked to opacity 0.
template <bool PACK>
__device__ __forceinline__ void stage_chunk(float4* sm, const float4* raw, int j, int chunk,
                                            int head, int count, float ox, float oy,
                                            float alpha_min) {
  for (int k = threadIdx.x; k < chunk; k += blockDim.x) {
    const int idx = j * chunk + k;
    float4 a0, a1, a2;
    row_columns<PACK>(raw, k, a0, a1, a2);
    const float op = idx >= head && idx < head + count ? a2.x : 0.f;
    const float thr = op > 0.f ? logf(alpha_min / op) - kSkipMargin : CUDART_INF_F;
    sm[3 * k] = make_float4(a0.x - ox, a0.y - oy, 0.5f * a0.z, a0.w);
    sm[3 * k + 1] = make_float4(0.5f * a1.x, a1.y, a1.z, a1.w);
    sm[3 * k + 2] = make_float4(op, thr, 0.f, 0.f);
  }
}

// One staged chunk composited into a thread's 2x2 block (pixel columns
// px0, px1 and rows py0, py1, tile-centred): its running colour and T.
__device__ __forceinline__ void composite_chunk(const float4* sm, int chunk, float px0,
                                                float px1, float py0, float py1,
                                                const bool (&valid)[4], float (&T)[4],
                                                float (&cr)[4], float (&cg)[4],
                                                float (&cb)[4], float alpha_min,
                                                float alpha_max) {
  float t_exc[4] = {1.f, 1.f, 1.f, 1.f};
  for (int k = 0; k < chunk; ++k) {
    const float4 g0 = sm[3 * k], g1 = sm[3 * k + 1], g2 = sm[3 * k + 2];
    const float dx0 = px0 - g0.x, dx1 = px1 - g0.x;
    const float dy0 = py0 - g0.y, dy1 = py1 - g0.y;
    const float ax0 = g0.z * (dx0 * dx0), ax1 = g0.z * (dx1 * dx1);
    const float cy0 = g1.x * (dy0 * dy0), cy1 = g1.x * (dy1 * dy1);
    float power[4];
    power[0] = -((ax0 + g0.w * (dx0 * dy0)) + cy0);
    power[1] = -((ax1 + g0.w * (dx1 * dy0)) + cy0);
    power[2] = -((ax0 + g0.w * (dx0 * dy1)) + cy1);
    power[3] = -((ax1 + g0.w * (dx1 * dy1)) + cy1);
    bool below = true;
#pragma unroll
    for (int q = 0; q < 4; ++q) below &= power[q] < g2.y || !valid[q];
    if (__all_sync(0xffffffffu, below)) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float raw = g2.x * expf(power[q] > 0.f ? -100.f : power[q]);
      const float alpha = raw >= alpha_min ? fminf(raw, alpha_max) : 0.f;
      const float w = alpha * t_exc[q] * T[q];
      cr[q] = __fmaf_rn(g1.y, w, cr[q]);
      cg[q] = __fmaf_rn(g1.z, w, cg[q]);
      cb[q] = __fmaf_rn(g1.w, w, cb[q]);
      t_exc[q] *= 1.f - alpha;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) T[q] *= t_exc[q];
}

// One tile in NPASS pixel passes (the two kernels below), on a 16-column
// or packed rows.
template <int NPASS, bool PACK>
__device__ __forceinline__ void composite_tile(
    const float* __restrict__ attrs, const int32_t* __restrict__ gid,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count, int tw, int tile_size, int chunk,
    float alpha_min, float alpha_max, float t_eps, float* __restrict__ tiles,
    int32_t* __restrict__ nproc) {
  // per pair: (mx - ox, my - oy, 0.5 a, b), (0.5 c, r, g, b), (op, thr, -, -);
  // then the raw rows of the next chunk (columns 0-11, or 0-7 packed),
  // copied in flight; then two chunks of gids (prefetch_rows)
  extern __shared__ float4 sm[];
  float4* raw = sm + 3 * chunk;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int ts = tile_size;
  const int npix = ts * ts;
  const int nblk = ((ts + 1) / 2) * ((ts + 1) / 2);
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int astart = (start / chunk) * chunk;
  const int head = start - astart;
  const int nch = (head + count + chunk - 1) / chunk;
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
    const int v = p * blockDim.x + tid;
    block_origin(v, ts, ts, x0[p], y0[p]);
    px0[p] = static_cast<float>(x0[p] - h), px1[p] = static_cast<float>(x0[p] + 1 - h);
    py0[p] = static_cast<float>(y0[p] - h), py1[p] = static_cast<float>(y0[p] + 1 - h);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      valid[p][q] = v < nblk && x0[p] + (q & 1) < ts && y0[p] + (q >> 1) < ts;
  }

  if (nch > 0) prefetch_rows<PACK, true>(attrs, gid, raw, astart, 0, nch, chunk);

  float T[NPASS][4], cr[NPASS][4], cg[NPASS][4], cb[NPASS][4];
#pragma unroll
  for (int p = 0; p < NPASS; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) T[p][q] = 1.f, cr[p][q] = cg[p][q] = cb[p][q] = 0.f;
  int j = 0;
  for (; j < nch; ++j) {
    // the whole-tile exit: a vote over every pixel of every pass
    bool alive = false;
#pragma unroll
    for (int p = 0; p < NPASS; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) alive |= valid[p][q] && T[p][q] >= t_eps;
    // the barrier also keeps the staging below from overwriting a chunk
    // another thread is still compositing
    if (!__syncthreads_or(alive)) break;
    cp_async_wait_all();
    stage_chunk<PACK>(sm, raw, j, chunk, head, count, ox, oy, alpha_min);
    // the next chunk's rows travel while this one is composited
    if (j + 1 < nch) prefetch_rows<PACK, false>(attrs, gid, raw, astart, j + 1, nch, chunk);
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NPASS; ++p)
      composite_chunk(sm, chunk, px0[p], px1[p], py0[p], py1[p], valid[p], T[p], cr[p], cg[p],
                      cb[p], alpha_min, alpha_max);
  }
  // a tile that exits early leaves its next chunk's copy in flight: retire it
  cp_async_wait_all();
  float* out = tiles + static_cast<size_t>(t) * 4 * npix;
#pragma unroll
  for (int p = 0; p < NPASS; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!valid[p][q]) continue;
      const int px = (y0[p] + (q >> 1)) * ts + x0[p] + (q & 1);
      out[px] = cr[p][q];
      out[npix + px] = cg[p][q];
      out[2 * npix + px] = cb[p][q];
      out[3 * npix + px] = T[p][q];
    }
  if (tid == 0) nproc[t] = j;
}

#define COMPOSITE_FWD_ARGS                                                          \
  const float *__restrict__ attrs, const int32_t *__restrict__ gid,                \
      const int32_t *__restrict__ tile_start, const int32_t *__restrict__ tile_count, \
      int tw, int tile_size, int chunk, float alpha_min, float alpha_max, float t_eps, \
      float *__restrict__ tiles, int32_t *__restrict__ nproc

// tiles up to 32: one pass
template <bool PACK>
__global__ void __launch_bounds__(kMaxThreads) composite_fwd_kernel(COMPOSITE_FWD_ARGS) {
  composite_tile<1, PACK>(attrs, gid, tile_start, tile_count, tw, tile_size, chunk, alpha_min,
                          alpha_max, t_eps, tiles, nproc);
}

// larger tiles: every pass's state lives in registers, capped so that two
// blocks share an SM (one block alone waits on its latencies, ~25% slower)
template <int NPASS, bool PACK>
__global__ void __launch_bounds__(kMaxThreads, 2) composite_fwd_passes(COMPOSITE_FWD_ARGS) {
  composite_tile<NPASS, PACK>(attrs, gid, tile_start, tile_count, tw, tile_size, chunk,
                              alpha_min, alpha_max, t_eps, tiles, nproc);
}

// Tiles above kWin, in windows (see the note at the top). Window (wx, wy)
// covers pixels [wx, wx + ww) x [wy, wy + wh) of the tile, mapped by
// block_origin as a ww x wh tile; its map threads run in units of
// blockDim.x, unit by unit after the windows before it.
template <bool PACK>
__global__ void __launch_bounds__(kMaxThreads, 2) composite_fwd_windows(COMPOSITE_FWD_ARGS) {
  extern __shared__ float4 sm[];
  float4* raw = sm + 3 * chunk;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int ts = tile_size;
  const size_t npix = static_cast<size_t>(ts) * ts;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int astart = (start / chunk) * chunk;
  const int head = start - astart;
  const int nch = (head + count + chunk - 1) / chunk;
  const int h = ts / 2;
  const float ox = static_cast<float>((t % tw) * ts + h);
  const float oy = static_cast<float>((t / tw) * ts + h);
  float* out = tiles + static_cast<size_t>(t) * 4 * npix;

  if (nch > 0) prefetch_rows<PACK, true>(attrs, gid, raw, astart, 0, nch, chunk);

  bool alive = true;  // before the first chunk every pixel has T = 1
  int j = 0;
  for (; j < nch; ++j) {
    // the whole-tile exit: a vote over every pixel of every window
    if (!__syncthreads_or(alive)) break;
    cp_async_wait_all();
    stage_chunk<PACK>(sm, raw, j, chunk, head, count, ox, oy, alpha_min);
    if (j + 1 < nch) prefetch_rows<PACK, false>(attrs, gid, raw, astart, j + 1, nch, chunk);
    __syncthreads();
    alive = false;
    for (int wy = 0; wy < ts; wy += kWin)
      for (int wx = 0; wx < ts; wx += kWin) {
        const int ww = min(kWin, ts - wx), wh = min(kWin, ts - wy);
        const int nblk = ((ww + 1) / 2) * ((wh + 1) / 2);
        for (int v0 = 0; v0 < nblk; v0 += blockDim.x) {
          const int v = v0 + tid;
          int x0, y0;
          block_origin(v, ww, wh, x0, y0);
          bool valid[4];
          size_t px[4];
          float T[4], cr[4], cg[4], cb[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            valid[q] = v < nblk && x0 + (q & 1) < ww && y0 + (q >> 1) < wh;
            px[q] = static_cast<size_t>(wy + y0 + (q >> 1)) * ts + wx + x0 + (q & 1);
            T[q] = 1.f, cr[q] = cg[q] = cb[q] = 0.f;
            if (j > 0 && valid[q]) {
              cr[q] = out[px[q]];
              cg[q] = out[npix + px[q]];
              cb[q] = out[2 * npix + px[q]];
              T[q] = out[3 * npix + px[q]];
            }
          }
          x0 += wx, y0 += wy;
          composite_chunk(sm, chunk, static_cast<float>(x0 - h), static_cast<float>(x0 + 1 - h),
                          static_cast<float>(y0 - h), static_cast<float>(y0 + 1 - h), valid, T,
                          cr, cg, cb, alpha_min, alpha_max);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (!valid[q]) continue;
            out[px[q]] = cr[q];
            out[npix + px[q]] = cg[q];
            out[2 * npix + px[q]] = cb[q];
            out[3 * npix + px[q]] = T[q];
            alive |= T[q] >= t_eps;
          }
        }
      }
  }
  cp_async_wait_all();
  // a tile with no chunk to composite: every pixel (0, 0, 0, T = 1)
  if (j == 0)
    for (size_t i = tid; i < npix; i += blockDim.x)
      out[i] = out[npix + i] = out[2 * npix + i] = 0.f, out[3 * npix + i] = 1.f;
  if (tid == 0) nproc[t] = j;
}

// fwd_pixel_blocks' threads at this tile size: one per 2x2 pixel block, in
// whole warps (render/raster.py::fwd_pixel_blocks).
int map_threads(int tile_size) {
  const int nbx = (tile_size + 1) / 2;
  return (nbx * nbx + 31) / 32 * 32;
}

template <int NPASS, bool PACK>
cudaError_t launch(int num_tiles, int threads, cudaStream_t stream,
                   const float* attrs, const int32_t* gid, const int32_t* tile_start,
                   const int32_t* tile_count, int tw, int tile_size, int chunk,
                   float alpha_min, float alpha_max, float t_eps, float* tiles,
                   int32_t* nproc) {
  // the staged records (3 float4 a pair), the copy of the next chunk and
  // two chunks of gids
  const size_t smem = ((3 + kRowVecs<PACK>) * sizeof(float4) + 2 * sizeof(int32_t)) *
                      static_cast<size_t>(chunk);
  void (*kernel)(COMPOSITE_FWD_ARGS);
  if constexpr (NPASS == 0) {
    kernel = composite_fwd_windows<PACK>;
  } else if constexpr (NPASS == 1) {
    kernel = composite_fwd_kernel<PACK>;
  } else {
    kernel = composite_fwd_passes<NPASS, PACK>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<num_tiles, threads, smem, stream>>>(
      attrs, gid, tile_start, tile_count, tw, tile_size, chunk, alpha_min, alpha_max,
      t_eps, tiles, nproc);
  return cudaGetLastError();
}

template <bool PACK>
cudaError_t launch_passes(int npass, int num_tiles, int threads, cudaStream_t st,
                          const float* a, const int32_t* gid, const int32_t* s,
                          const int32_t* c, int tw,
                          int tile_size, int chunk, float alpha_min, float alpha_max,
                          float t_eps, float* o, int32_t* n) {
  switch (npass) {
    case 0: return launch<0, PACK>(num_tiles, threads, st, a, gid, s, c, tw, tile_size, chunk,
                                   alpha_min, alpha_max, t_eps, o, n);
    case 1: return launch<1, PACK>(num_tiles, threads, st, a, gid, s, c, tw, tile_size, chunk,
                                   alpha_min, alpha_max, t_eps, o, n);
    case 2: return launch<2, PACK>(num_tiles, threads, st, a, gid, s, c, tw, tile_size, chunk,
                                   alpha_min, alpha_max, t_eps, o, n);
    case 3: return launch<3, PACK>(num_tiles, threads, st, a, gid, s, c, tw, tile_size, chunk,
                                   alpha_min, alpha_max, t_eps, o, n);
    default: return launch<4, PACK>(num_tiles, threads, st, a, gid, s, c, tw, tile_size, chunk,
                                    alpha_min, alpha_max, t_eps, o, n);
  }
}

}  // namespace

// attrs: (N+1, 16) float32 per-Gaussian rows, or (N+1, 8) packed where
// `packed` is nonzero, 16-byte aligned; gid: (P,) int32 sorted gids, each in
// [0, N], with P a multiple of chunk and every segment inside it;
// tile_start, tile_count: (num_tiles,) int32; tiles:
// (num_tiles, 4, tile_size^2) float32; nproc: (num_tiles,) int32.
// tile_size >= 1: up to kWin in pixel passes (1 to 4), above it in
// windows. alpha_min, alpha_max, t_eps: render/raster.py's ALPHA_MIN,
// ALPHA_MAX, T_EPS. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a tile below 1).
extern "C" int composite_fwd_launch(const void* attrs, const void* gid, const void* tile_start,
                                    const void* tile_count, int num_tiles,
                                    int tw, int tile_size, int chunk, int packed,
                                    float alpha_min, float alpha_max,
                                    float t_eps, void* tiles, void* nproc,
                                    void* stream) {
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
  auto* o = static_cast<float*>(tiles);
  auto* n = static_cast<int32_t*>(nproc);
  const cudaError_t e =
      packed ? launch_passes<true>(npass, num_tiles, threads, st, a, gi, s, c, tw, tile_size,
                                   chunk, alpha_min, alpha_max, t_eps, o, n)
             : launch_passes<false>(npass, num_tiles, threads, st, a, gi, s, c, tw, tile_size,
                                    chunk, alpha_min, alpha_max, t_eps, o, n);
  return static_cast<int>(e);
}
