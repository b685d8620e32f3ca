// composite_bwd: the backward sweep of composite_fwd. One block per image
// tile, one thread per pixel.
//
// Replaces the TPU kernel gsplat_tpu/render/raster_pallas.py::_bwd_kernel
// (through _bwd_call / composite_bwd). Block t replays exactly nproc[t]
// chunks of its tile's chunk-aligned segment, front to back, as the forward
// composited them (rows outside [tile_start, +tile_count) masked to opacity
// 0), and writes one 16-float d-row per swept pair into the tile's own
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
// pair-pixel evaluations of ~45 f32 operations, one expf and (where the pair
// touches the pixel) a division, plus the reductions, against 64 bytes read
// and 64 written per pair.
// Design: the chunk's attributes are staged once into shared memory and
// read as broadcasts. The ten per-pair sums reduce first inside each warp
// (xor shuffles; a warp in which no pixel has alpha > 0 skips them, its
// sums are exactly zero), then across warps in warp order from shared
// memory, 32 pairs per round: the association is fixed, so two runs give
// the same bits. --fmad=false and an IEEE division keep the plain version's
// rounding of alpha and of the alpha >= 1/255 decision.

#include "common.cuh"

namespace {

constexpr int kAttrDim = 16;
constexpr int kKeyCol = 9;
constexpr int kSums = 10;  // per pair: w*g (3), gda (1), dpow * basis (6)
constexpr int kSub = 32;   // pairs per cross-warp reduction round
constexpr int kStaged = 12;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(1024) composite_bwd_kernel(
    const float* __restrict__ attrs, const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ comp_start, const int32_t* __restrict__ nproc,
    const float* __restrict__ tiles, const float* __restrict__ g_tiles, int tw,
    int tile_size, int chunk, int p_out, float alpha_min, float alpha_max,
    float key_invalid, float* __restrict__ d_out) {
  extern __shared__ float sm[];
  float* s_mx = sm;              // mean x - ox
  float* s_my = sm + chunk;      // mean y - oy
  float* s_ha = sm + 2 * chunk;  // 0.5 * conic a
  float* s_b = sm + 3 * chunk;   // conic b
  float* s_hc = sm + 4 * chunk;  // 0.5 * conic c
  float* s_r = sm + 5 * chunk;
  float* s_g = sm + 6 * chunk;
  float* s_bl = sm + 7 * chunk;
  float* s_op = sm + 8 * chunk;  // opacity, 0 outside the segment
  float* s_key = sm + 9 * chunk;
  float* s_ca = sm + 10 * chunk;  // conic a, c as they are (d-row algebra)
  float* s_cc = sm + 11 * chunk;
  float* s_part = sm + kStaged * chunk;  // [warp][pair of the round][sum]

  const int t = blockIdx.x;
  const int np = nproc[t];
  if (np <= 0) return;  // the same for every thread of the block
  const int pix = threadIdx.x;
  const int npix = blockDim.x;
  const int lane = pix & 31;
  const int warp = pix >> 5;
  const int nwarps = npix >> 5;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int astart = (start / chunk) * chunk;
  const int head = start - astart;
  const int ostart = comp_start[t];
  const int h = tile_size / 2;
  const float ox = static_cast<float>((t % tw) * tile_size + h);
  const float oy = static_cast<float>((t / tw) * tile_size + h);
  const float px = static_cast<float>(pix % tile_size - h);
  const float py = static_cast<float>(pix / tile_size - h);
  const float basis[6] = {px * px, py * py, px * py, px, py, 1.f};

  const float* res = tiles + static_cast<size_t>(t) * 4 * npix;
  const float* gt = g_tiles + static_cast<size_t>(t) * 4 * npix;
  const float gr = gt[pix], gg = gt[npix + pix], gb = gt[2 * npix + pix];
  const float total_cg = res[pix] * gr + res[npix + pix] * gg +
                         res[2 * npix + pix] * gb;
  const float tf_gt = res[3 * npix + pix] * gt[3 * npix + pix];

  float t_run = 1.f, prefix = 0.f;
  for (int j = 0; j < np; ++j) {
    __syncthreads();  // the previous chunk's readers are done with staging
    for (int k = pix; k < chunk; k += npix) {
      const int idx = j * chunk + k;
      const float* a = attrs + static_cast<size_t>(astart + idx) * kAttrDim;
      const bool ok = idx >= head && idx < head + count;
      s_mx[k] = a[0] - ox;
      s_my[k] = a[1] - oy;
      s_ha[k] = 0.5f * a[2];
      s_b[k] = a[3];
      s_hc[k] = 0.5f * a[4];
      s_r[k] = a[5];
      s_g[k] = a[6];
      s_bl[k] = a[7];
      s_op[k] = ok ? a[8] : 0.f;
      s_key[k] = ok ? a[kKeyCol] : key_invalid;
      s_ca[k] = a[2];
      s_cc[k] = a[4];
    }
    __syncthreads();
    float t_exc = 1.f, csum = 0.f;
    for (int k0 = 0; k0 < chunk; k0 += kSub) {
      const int kn = min(kSub, chunk - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const int k = k0 + kk;
        const float dx = px - s_mx[k];
        const float dy = py - s_my[k];
        const float power = -(s_ha[k] * (dx * dx) + s_b[k] * (dx * dy) +
                              s_hc[k] * (dy * dy));
        const float G = expf(power > 0.f ? -100.f : power);
        const float op = s_op[k];
        const float raw = op * G;
        const bool keep = raw >= alpha_min;
        const float alpha = keep ? fminf(raw, alpha_max) : 0.f;
        const float t_i = t_exc * t_run;
        const float w = alpha * t_i;
        const float cg = s_r[k] * gr + s_g[k] * gg + s_bl[k] * gb;
        csum += w * cg;
        float v[kSums];
#pragma unroll
        for (int i = 0; i < kSums; ++i) v[i] = 0.f;
        if (__any_sync(0xffffffffu, alpha > 0.f)) {
          const float pref = csum + prefix;
          float dalpha = 0.f;
          if (keep && raw <= alpha_max)
            dalpha = t_i * cg - ((total_cg - pref) + tf_gt) / (1.f - alpha);
          const float gda = G * dalpha;
          const float dpow = op * gda;
          v[0] = w * gr;
          v[1] = w * gg;
          v[2] = w * gb;
          v[3] = gda;
#pragma unroll
          for (int i = 0; i < 6; ++i) v[4 + i] = dpow * basis[i];
#pragma unroll
          for (int i = 0; i < kSums; ++i) v[i] = warp_sum(v[i]);
        }
        if (lane == 0) {
          float* dst = s_part + (warp * kSub + kk) * kSums;
#pragma unroll
          for (int i = 0; i < kSums; ++i) dst[i] = v[i];
        }
        t_exc *= 1.f - alpha;
      }
      __syncthreads();
      for (int q = pix; q < kn; q += npix) {
        float s[kSums];
#pragma unroll
        for (int i = 0; i < kSums; ++i) s[i] = 0.f;
        for (int wi = 0; wi < nwarps; ++wi) {
          const float* src = s_part + (wi * kSub + q) * kSums;
#pragma unroll
          for (int i = 0; i < kSums; ++i) s[i] += src[i];
        }
        const int k = k0 + q;
        const float mxl = s_mx[k], myl = s_my[k];
        const float ca = s_ca[k], cb = s_b[k], cc = s_cc[k];
        const float du0 = s[4], du1 = s[5], du2 = s[6];
        const float du3 = s[7], du4 = s[8], du5 = s[9];
        const float d_a = (-0.5f * du0 + mxl * du3) - ((0.5f * mxl) * mxl) * du5;
        const float d_c = (-0.5f * du1 + myl * du4) - ((0.5f * myl) * myl) * du5;
        const float d_b = ((-du2 + myl * du3) + mxl * du4) - (mxl * myl) * du5;
        const float d_mx = (ca * du3 + cb * du4) - (ca * mxl + cb * myl) * du5;
        const float d_my = (cb * du3 + cc * du4) - (cc * myl + cb * mxl) * du5;
        const int row = ostart + j * chunk + k;
        if (row >= 0 && row < p_out) {
          float4* o = reinterpret_cast<float4*>(d_out + static_cast<size_t>(row) * kAttrDim);
          o[0] = make_float4(d_mx, d_my, d_a, d_b);
          o[1] = make_float4(d_c, s[0], s[1], s[2]);
          o[2] = make_float4(s[3], s_key[k], 0.f, 0.f);
          o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      __syncthreads();  // s_part is rewritten by the next round
    }
    t_run *= t_exc;
    prefix = csum + prefix;
  }
}

}  // namespace

// attrs: (P, 16) float32, P a multiple of chunk; tile_start, tile_count,
// comp_start, nproc: (num_tiles,) int32; tiles, g_tiles: (num_tiles, 4,
// tile_size^2) float32; d_out: (p_out, 16) float32, prefilled by the caller.
// tile_size^2 a multiple of 32, at most 1024. alpha_min, alpha_max,
// key_invalid: render/raster.py's ALPHA_MIN, ALPHA_MAX, KEY_INVALID.
// Returns cudaGetLastError() after the launch.
extern "C" int composite_bwd_launch(
    const void* attrs, const void* tile_start, const void* tile_count,
    const void* comp_start, const void* nproc, const void* tiles,
    const void* g_tiles, int num_tiles, int tw, int tile_size, int chunk,
    int p_out, float alpha_min, float alpha_max, float key_invalid,
    void* d_out, void* stream) {
  if (num_tiles > 0) {
    const int npix = tile_size * tile_size;
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(kStaged) * chunk +
                         static_cast<size_t>(npix / 32) * kSub * kSums);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    composite_bwd_kernel<<<num_tiles, npix, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(attrs),
        static_cast<const int32_t*>(tile_start),
        static_cast<const int32_t*>(tile_count),
        static_cast<const int32_t*>(comp_start),
        static_cast<const int32_t*>(nproc), static_cast<const float*>(tiles),
        static_cast<const float*>(g_tiles), tw, tile_size, chunk, p_out,
        alpha_min, alpha_max, key_invalid, static_cast<float*>(d_out));
  }
  return static_cast<int>(cudaGetLastError());
}
