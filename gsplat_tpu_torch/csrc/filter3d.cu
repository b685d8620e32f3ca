// filter3d: Mip-Splatting's 3D smoothing filter of every Gaussian over a set
// of training cameras (render/filter3d.py; Yu et al. 2024).
//
// Replaces no TPU kernel: the JAX package has no Mip-Splatting. The
// published code loops over the cameras in Python, a dozen full-size
// elementwise passes a camera; here one thread takes one row through every
// camera.
//
// filter3d_depth_kernel: the camera table ((K, 20) floats: world_view's
// first three columns, fx, fy, W / 2, H / 2 and the screen's bounds with the
// 15% margin) is staged in shared memory once a block; each live row reads
// its centre (12 B) and, camera by camera, takes its depth, the clamped
// projection and the validity test, keeping the least valid depth. It
// writes the depth and the validity flag, and the block's largest valid
// depth goes into one atomic max (a positive float's bits order as an
// unsigned integer's). filter3d_finish_kernel fills the rows valid in no
// camera with that largest depth (1e5 where no row is valid) and scales by
// sqrt(variance) / F; dead rows get 0.
//
// Every operation is filter3d_plain's, in its order, one IEEE rounding each
// (--fmad=false): the two agree bit for bit. Bound on this card: compute,
// about 34 operations a row a camera against 16 bytes a row (the filter
// and the flag written, the depth written and read back).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCamFloats = 20;
constexpr float kNear = 0.2f;
constexpr float kZMin = 0.001f;
constexpr float kFar = 100000.0f;

__global__ void __launch_bounds__(kThreads) filter3d_depth_kernel(
    const float* __restrict__ xyz, const int32_t* __restrict__ n_live, int cap,
    const float* __restrict__ table, int k, float* __restrict__ depth,
    bool* __restrict__ valid, unsigned* __restrict__ dmax_bits) {
  extern __shared__ float cams[];
  for (int e = threadIdx.x; e < k * kCamFloats; e += kThreads) cams[e] = table[e];
  __shared__ unsigned block_max;
  if (threadIdx.x == 0) block_max = 0u;
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int live = *n_live;
  if (i < cap) {
    float d = kFar;
    bool ok_any = false;
    if (i < live) {
      const float x = __ldg(xyz + 3 * i), y = __ldg(xyz + 3 * i + 1), z = __ldg(xyz + 3 * i + 2);
#pragma unroll 4
      for (int c = 0; c < k; ++c) {
        const float* t = cams + c * kCamFloats;
        const float zc = ((x * t[2] + y * t[5]) + z * t[8]) + t[11];
        const float zz = fmaxf(zc, kZMin);
        const float px = (((x * t[0] + y * t[3]) + z * t[6]) + t[9]) / zz * t[12] + t[14];
        const float py = (((x * t[1] + y * t[4]) + z * t[7]) + t[10]) / zz * t[13] + t[15];
        const bool ok = zc > kNear && px >= t[16] && px <= t[17] && py >= t[18] && py <= t[19];
        if (ok) d = fminf(d, zz);
        ok_any = ok_any || ok;
      }
    }
    depth[i] = d;
    valid[i] = ok_any;
    if (ok_any) atomicMax(&block_max, __float_as_uint(d));
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_max != 0u) atomicMax(dmax_bits, block_max);
}

__global__ void __launch_bounds__(kThreads) filter3d_finish_kernel(
    const int32_t* __restrict__ n_live, int cap, const float* __restrict__ depth,
    const bool* __restrict__ valid, const unsigned* __restrict__ dmax_bits, float focal,
    float factor, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= cap) return;
  if (i >= *n_live) {
    out[i] = 0.0f;
    return;
  }
  const unsigned m = *dmax_bits;
  const float d = valid[i] ? depth[i] : (m != 0u ? __uint_as_float(m) : kFar);
  out[i] = d / focal * factor;
}

}  // namespace

// xyz (cap, 3) float32, n_live () int32, table (k, 20) float32, all on one
// device; depth (cap,) float32 scratch, dmax (1,) uint32 zeroed, out (cap,)
// float32, valid (cap,) bool. Returns cudaGetLastError() after the launches.
extern "C" int filter3d_launch(const void* xyz, const void* n_live, int cap, const void* table,
                               int k, float focal, float factor, void* depth, void* dmax,
                               void* out, void* valid, void* stream) {
  if (cap <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(k) * kCamFloats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        filter3d_depth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (cap + kThreads - 1) / kThreads;
  filter3d_depth_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(xyz), static_cast<const int32_t*>(n_live), cap,
      static_cast<const float*>(table), k, static_cast<float*>(depth),
      static_cast<bool*>(valid), static_cast<unsigned*>(dmax));
  filter3d_finish_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(n_live), cap, static_cast<const float*>(depth),
      static_cast<const bool*>(valid), static_cast<const unsigned*>(dmax), focal, factor,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
