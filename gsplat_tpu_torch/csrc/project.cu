// project: the projection of every Gaussian into one camera (project_fwd)
// and its gradient (project_bwd), one thread a row.
//
// Replaces no TPU kernel: the JAX package leaves the projection to XLA
// (gsplat_tpu/render/project.py::project_gaussians and its autodiff), which
// fuses it. Run as plain torch on the card it was ~150 elementwise kernels
// over the whole capacity forward, and autograd's saved intermediates, a
// (CAP, 16, 3) feature copy and one full-size gradient per SH slice
// backward.
//
// project_fwd reads each row's parameters (xyz, f_dc, the active f_rest
// coefficients, the opacity logit, the log-scale, the quaternion) straight
// from the leaves and writes the Projection fields: mean2d (plus the
// optional offset), conic, depth, radius, rgb (unless the caller overrides
// the colour), the masked opacity and visible. Every operation is the plain
// version's (render/project.py::project_plain), in its order, one IEEE
// rounding each (--fmad=false; rsqrtf and expf as torch's CUDA kernels call
// them; a sum over a row's components in the order torch's reduction adds
// them), so mean2d, depth and radius (a ceil: one pixel off moves a tile
// rectangle) land on the plain version's bits on the card.
//
// project_bwd recomputes the same intermediates from the same inputs (the
// forward saves nothing) and writes the gradient of every leaf and of the
// offset in closed form (render/project.py::project_bwd_plain, the same
// formulas in the same order): the clamps of the Jacobian, the rgb and the
// norms pass gradient as autograd's clamp, minimum and maximum do (half
// each way at a tie), the torch.where masks (z_safe, det_safe, the opacity)
// pass it only on their branch, the radius has none. A row whose incoming
// gradients are all zero (culled, dead, off screen: no pair of the render)
// computes nothing and writes zeros; a row whose rgb gradient is zero reads
// no SH coefficient. Each row's sums run in a fixed order, with no atomics:
// two launches give the same bits.
//
// Mip-Splatting (Yu et al. 2024) is a compile-time variant of both kernels
// (project_fwd_mip_kernel, project_bwd_mip_kernel; the 3DGS kernels keep
// their code and names): the row's 3D filter f widens its scales to
// sqrt(s^2 + f^2) and compensates its opacity by c3 = sqrt(prod of
// s^2 / (s^2 + f^2)); the 2D filter adds var2d (0.1) to the screen-space
// covariance in place of 3DGS's 0.3 and compensates the opacity by c2 =
// sqrt(det / det(+ var2d)) (0 where det <= 0). The opacity written is
// (sigmoid(logit) c3) c2; the backward carries both compensations in closed
// form (project_bwd_plain's formulas, in its order).
//
// Bound on this card: bytes. Forward, a row reads its 59 parameter floats
// (236 B at SH degree 3) and writes 45 B; backward, it reads them again
// (f_rest's 180 B only where the rgb gradient is not zero) with its nine
// incoming gradient columns and writes 236 B of gradients and the offset's
// 8 B. The f_rest rows (180 B, not a multiple of 16) are staged through
// shared memory a warp at a time, so the warp's loads and stores of them
// are coalesced 128-byte runs; the other leaves are at most 16 B a row and
// go straight to registers. On an H100 at 2^22 rows the two run at 60% and
// 57% of their byte bounds.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRest3 = 45;   // 15 rest coefficients x 3 channels (degree 3)
constexpr unsigned kFull = 0xffffffffu;

// eval_sh's constants (core/sh.py), rounded to float as torch rounds a
// Python scalar for a float32 tensor
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f;
constexpr float C2_1 = -1.0925484305920792f;
constexpr float C2_2 = 0.31539156525252005f;
constexpr float C2_3 = -1.0925484305920792f;
constexpr float C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f;
constexpr float C3_1 = 2.890611442640554f;
constexpr float C3_2 = -0.4570457994644658f;
constexpr float C3_3 = 0.3731763325901154f;
constexpr float C3_4 = -0.4570457994644658f;
constexpr float C3_5 = 1.445305721320277f;
constexpr float C3_6 = -0.5900435899266435f;

// torch.maximum / torch.minimum / clamp on CUDA: a NaN operand wins
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a != a || a < b) ? a : b; }

// The camera, staged in shared memory once a block. wv, fp: (4, 4)
// row-vector matrices, row-major; the focal lengths and the Jacobian's
// limits as Camera.focal_x and project_plain compute them from tan(fov/2).
struct Cam {
  float wv[16], fp[16], cc[3];
  float fx, fy, limx, limy, width, height;
  int n_live;
};

__device__ void load_cam(Cam& c, const float* wv, const float* fp, const float* cc,
                         const float* tanx, const float* tany, int width, int height,
                         const int32_t* n_live) {
  const int t = threadIdx.x;
  if (t < 16) {
    c.wv[t] = wv[t];
    c.fp[t] = fp[t];
  }
  if (t < 3) c.cc[t] = cc[t];
  if (t == 0) {
    const float tx = *tanx, ty = *tany;
    // width / (2 tan): torch's reciprocal, then the product
    c.fx = (1.0f / (2.0f * tx)) * static_cast<float>(width);
    c.fy = (1.0f / (2.0f * ty)) * static_cast<float>(height);
    c.limx = 1.3f * tx;
    c.limy = 1.3f * ty;
    c.width = static_cast<float>(width);
    c.height = static_cast<float>(height);
    c.n_live = *n_live;
  }
  __syncthreads();
}

// One row's forward intermediates, as project_plain computes them.
struct Geo {
  float h0, h1, pw;                  // clip x, y and 1 / (w + 1e-7)
  float pv0, pv1, depth;             // view-space position
  bool base, det_ok;                 // in front of the near plane and live; det > 0
  float ex[3], s[3], s2[3];          // exp(log-scale), scaled, squared
  float sq, rs, q[4];                // quaternion: squared norm, rsqrt, normalised
  float r[9];                        // rotation, row-major
  float c00, c01, c02, c11, c12, c22;  // Sigma = R diag(s^2) R^T
  float zs, u0, u1, txtz, tytz, tx, ty, iz, iz2, j00, j02, j11, j12;
  float a[3], b[3], sa[3], sb[3];    // rows of J W and Sigma times them
  float A, B, C, det, ds, idet;      // the 2D covariance (+0.3), its determinant
  // Mip: the filter's f^2, exp(log-scale)^2, + f^2, its sqrt, their ratio;
  // c3; the covariance before its dilation, its determinant; their ratio, c2
  float ff, e2[3], t2[3], sf[3], rr[3], c3, A0, C0, det0, q2d, c2;
};

__device__ __forceinline__ float dot_wv_col(const Cam& c, float x, float y, float z, int j) {
  return ((x * c.wv[j] + y * c.wv[4 + j]) + z * c.wv[8 + j]) + c.wv[12 + j];
}

__device__ __forceinline__ float dot_fp_col(const Cam& c, float x, float y, float z, int j) {
  return ((x * c.fp[j] + y * c.fp[4 + j]) + z * c.fp[8 + j]) + c.fp[12 + j];
}

template <bool MIP>
__device__ __forceinline__ void geometry(Geo& g, const Cam& c, float x, float y, float z,
                                         const float (&scl)[3], const float4 qin,
                                         bool live, float mod, float f, float var2d) {
  g.h0 = dot_fp_col(c, x, y, z, 0);
  g.h1 = dot_fp_col(c, x, y, z, 1);
  const float h3 = dot_fp_col(c, x, y, z, 3);
  g.pw = 1.0f / (h3 + 1e-7f);
  g.pv0 = dot_wv_col(c, x, y, z, 0);
  g.pv1 = dot_wv_col(c, x, y, z, 1);
  g.depth = dot_wv_col(c, x, y, z, 2);
  g.base = g.depth > 0.2f && live;

  if (MIP) g.ff = f * f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.ex[k] = expf(scl[k]);
    if (MIP) {
      g.e2[k] = g.ex[k] * g.ex[k];
      g.t2[k] = g.e2[k] + g.ff;
      g.sf[k] = sqrtf(g.t2[k]);
      g.rr[k] = g.e2[k] / g.t2[k];
      g.s[k] = g.sf[k] * mod;
    } else {
      g.s[k] = g.ex[k] * mod;
    }
    g.s2[k] = g.s[k] * g.s[k];
  }
  if (MIP) g.c3 = sqrtf((g.rr[0] * g.rr[1]) * g.rr[2]);
  // get_rotation: the row sum as torch's CUDA reduction adds four elements
  // (0 + 2 and 1 + 3, then the two), the clamped rsqrt
  g.sq = (qin.x * qin.x + qin.z * qin.z) + (qin.y * qin.y + qin.w * qin.w);
  g.rs = rsqrtf(max_nan(g.sq, 1e-12f));
  const float qr = qin.x * g.rs, qi = qin.y * g.rs, qj = qin.z * g.rs, qk = qin.w * g.rs;
  g.q[0] = qr; g.q[1] = qi; g.q[2] = qj; g.q[3] = qk;
  g.r[0] = 1.0f - 2.0f * (qj * qj + qk * qk);
  g.r[1] = 2.0f * (qi * qj - qr * qk);
  g.r[2] = 2.0f * (qi * qk + qr * qj);
  g.r[3] = 2.0f * (qi * qj + qr * qk);
  g.r[4] = 1.0f - 2.0f * (qi * qi + qk * qk);
  g.r[5] = 2.0f * (qj * qk - qr * qi);
  g.r[6] = 2.0f * (qi * qk - qr * qj);
  g.r[7] = 2.0f * (qj * qk + qr * qi);
  g.r[8] = 1.0f - 2.0f * (qi * qi + qj * qj);
  const float* r = g.r;
  g.c00 = (r[0] * r[0] * g.s2[0] + r[1] * r[1] * g.s2[1]) + r[2] * r[2] * g.s2[2];
  g.c01 = (r[0] * r[3] * g.s2[0] + r[1] * r[4] * g.s2[1]) + r[2] * r[5] * g.s2[2];
  g.c02 = (r[0] * r[6] * g.s2[0] + r[1] * r[7] * g.s2[1]) + r[2] * r[8] * g.s2[2];
  g.c11 = (r[3] * r[3] * g.s2[0] + r[4] * r[4] * g.s2[1]) + r[5] * r[5] * g.s2[2];
  g.c12 = (r[3] * r[6] * g.s2[0] + r[4] * r[7] * g.s2[1]) + r[5] * r[8] * g.s2[2];
  g.c22 = (r[6] * r[6] * g.s2[0] + r[7] * r[7] * g.s2[1]) + r[8] * r[8] * g.s2[2];

  g.zs = g.base ? g.depth : 1.0f;
  g.u0 = g.pv0 / g.zs;
  g.u1 = g.pv1 / g.zs;
  g.txtz = min_nan(max_nan(g.u0, -c.limx), c.limx);
  g.tytz = min_nan(max_nan(g.u1, -c.limy), c.limy);
  g.tx = g.txtz * g.zs;
  g.ty = g.tytz * g.zs;
  g.iz = 1.0f / g.zs;
  g.iz2 = g.iz * g.iz;
  g.j00 = c.fx * g.iz;
  g.j02 = (-c.fx * g.tx) * g.iz2;
  g.j11 = c.fy * g.iz;
  g.j12 = (-c.fy * g.ty) * g.iz2;
  // W = world_view[:3, :3]^T: a_k = j00 W[0][k] + j02 W[2][k], W[i][k] = wv[k][i]
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.a[k] = g.j00 * c.wv[4 * k] + g.j02 * c.wv[4 * k + 2];
    g.b[k] = g.j11 * c.wv[4 * k + 1] + g.j12 * c.wv[4 * k + 2];
  }
  g.sa[0] = (g.c00 * g.a[0] + g.c01 * g.a[1]) + g.c02 * g.a[2];
  g.sa[1] = (g.c01 * g.a[0] + g.c11 * g.a[1]) + g.c12 * g.a[2];
  g.sa[2] = (g.c02 * g.a[0] + g.c12 * g.a[1]) + g.c22 * g.a[2];
  g.sb[0] = (g.c00 * g.b[0] + g.c01 * g.b[1]) + g.c02 * g.b[2];
  g.sb[1] = (g.c01 * g.b[0] + g.c11 * g.b[1]) + g.c12 * g.b[2];
  g.sb[2] = (g.c02 * g.b[0] + g.c12 * g.b[1]) + g.c22 * g.b[2];
  const float A0 = (g.a[0] * g.sa[0] + g.a[1] * g.sa[1]) + g.a[2] * g.sa[2];
  g.B = (g.b[0] * g.sa[0] + g.b[1] * g.sa[1]) + g.b[2] * g.sa[2];
  const float C0 = (g.b[0] * g.sb[0] + g.b[1] * g.sb[1]) + g.b[2] * g.sb[2];
  const float kv = MIP ? var2d : 0.3f;
  g.A = A0 + kv;
  g.C = C0 + kv;
  g.det = g.A * g.C - g.B * g.B;
  g.det_ok = g.det > 0.0f;
  g.ds = g.det_ok ? g.det : 1.0f;
  g.idet = 1.0f / g.ds;
  if (MIP) {
    g.A0 = A0;
    g.C0 = C0;
    g.det0 = A0 * C0 - g.B * g.B;
    g.q2d = g.det0 > 0.0f ? g.det0 / g.ds : 1.0f;
    g.c2 = g.det0 > 0.0f ? sqrtf(g.q2d) : 0.0f;
  }
}

// The view direction, normalised as project_plain normalises it: the
// three-element row sum in torch's reduction order (elements 0 and 2, then
// 1), the clamped rsqrt.
struct Dir {
  float d0, d1, d2, n2, rs, x, y, z;
};

__device__ __forceinline__ void direction(Dir& d, const Cam& c, float x, float y, float z) {
  d.d0 = x - c.cc[0];
  d.d1 = y - c.cc[1];
  d.d2 = z - c.cc[2];
  d.n2 = (d.d0 * d.d0 + d.d2 * d.d2) + d.d1 * d.d1;
  d.rs = rsqrtf(max_nan(d.n2, 1e-16f));
  d.x = d.d0 * d.rs;
  d.y = d.d1 * d.rs;
  d.z = d.d2 * d.rs;
}

// The SH basis of coefficients 1..15 at direction (x, y, z), each as
// eval_sh forms the factor it multiplies the coefficient by (the sign of
// coefficients 1 and 3 is applied where they are used).
template <int DEG>
__device__ __forceinline__ void basis(float (&bk)[16], float x, float y, float z) {
  if (DEG > 0) {
    bk[1] = C1 * y;
    bk[2] = C1 * z;
    bk[3] = C1 * x;
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    bk[4] = C2_0 * xy;
    bk[5] = C2_1 * yz;
    bk[6] = C2_2 * ((2.0f * zz - xx) - yy);
    bk[7] = C2_3 * xz;
    bk[8] = C2_4 * (xx - yy);
    if (DEG > 2) {
      bk[9] = (C3_0 * y) * (3.0f * xx - yy);
      bk[10] = (C3_1 * xy) * z;
      bk[11] = (C3_2 * y) * ((4.0f * zz - xx) - yy);
      bk[12] = (C3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      bk[13] = (C3_4 * x) * ((4.0f * zz - xx) - yy);
      bk[14] = (C3_5 * z) * (xx - yy);
      bk[15] = (C3_6 * x) * (xx - 3.0f * yy);
    }
  }
}

// eval_sh + 0.5 of one channel, before the clamp; dc the row's f_dc, rest
// its staged f_rest row (coefficient k >= 1, channel ch at (k - 1) * 3 + ch).
template <int DEG>
__device__ __forceinline__ float sh_eval(const float (&bk)[16], float dc,
                                         const float* rest, int ch) {
  float res = C0 * dc;
  if (DEG > 0) {
    res = ((res - bk[1] * rest[ch]) + bk[2] * rest[3 + ch]) - bk[3] * rest[6 + ch];
  }
  if (DEG > 1) {
    res = ((((res + bk[4] * rest[9 + ch]) + bk[5] * rest[12 + ch]) + bk[6] * rest[15 + ch])
           + bk[7] * rest[18 + ch]) + bk[8] * rest[21 + ch];
  }
  if (DEG > 2) {
    res = ((((((res + bk[9] * rest[24 + ch]) + bk[10] * rest[27 + ch])
               + bk[11] * rest[30 + ch]) + bk[12] * rest[33 + ch])
             + bk[13] * rest[36 + ch]) + bk[14] * rest[39 + ch])
          + bk[15] * rest[42 + ch];
  }
  return res + 0.5f;
}

// The (row, column) of float e = lane + 32 j of a warp's span of rows of
// m3 floats, stepped from j to j + 1.
struct SpanPos {
  int r, col;
  __device__ __forceinline__ SpanPos(int lane, int m3) : r(lane / m3), col(lane % m3) {}
  __device__ __forceinline__ void next(int m3) {
    col += 32;
    while (col >= m3) {
      col -= m3;
      ++r;
    }
  }
};

// A warp's f_rest rows [row0, row0 + nrows) through shared memory: the
// first k3 floats of each row whose bit is set in `need` (the others are
// not read), in 32-float runs along the rows' contiguous span, every load
// of a lane issued before the first store (a loop that waited on each load
// would pay the memory's latency 45 times a warp). buf holds a row every
// `stride` floats (odd: the rows' own reads are conflict-free).
__device__ __forceinline__ void stage_in(const float* __restrict__ f_rest, int m3, int k3,
                                         int stride, long long row0, int nrows,
                                         unsigned need, float* buf, int lane) {
  const float* src = f_rest + row0 * m3;
  const int total = nrows * m3;
  float v[kMaxRest3];
  SpanPos p(lane, m3);
#pragma unroll
  for (int j = 0; j < kMaxRest3; ++j) {
    const int e = lane + 32 * j;
    v[j] = (e < total && p.col < k3 && (need >> p.r & 1u)) ? __ldg(src + e) : 0.0f;
    p.next(m3);
  }
  p = SpanPos(lane, m3);
#pragma unroll
  for (int j = 0; j < kMaxRest3; ++j) {
    if (lane + 32 * j < total && p.col < k3) buf[p.r * stride + p.col] = v[j];
    p.next(m3);
  }
  __syncwarp();
}

// ... and back out: each row's first k3 floats from buf where its bit is
// set in `have`, zeros elsewhere (every float of the span is written).
__device__ __forceinline__ void stage_out(float* __restrict__ g_rest, int m3, int k3,
                                          int stride, long long row0, int nrows,
                                          unsigned have, const float* buf, int lane) {
  __syncwarp();
  float* dst = g_rest + row0 * m3;
  const int total = nrows * m3;
  SpanPos p(lane, m3);
#pragma unroll
  for (int j = 0; j < kMaxRest3; ++j) {
    const int e = lane + 32 * j;
    if (e < total) dst[e] = (p.col < k3 && (have >> p.r & 1u)) ? buf[p.r * stride + p.col] : 0.0f;
    p.next(m3);
  }
}

struct Leaves {
  const float* xyz;       // (n, 3)
  const float* f_dc;      // (n, 3)
  const float* f_rest;    // (n, m, 3)
  const float* opacity;   // (n, 1)
  const float* scaling;   // (n, 3)
  const float* rotation;  // (n, 4), 16-byte aligned
  const int32_t* n_live;  // ()
};

struct CamPtrs {
  const float *wv, *fp, *cc, *tanx, *tany;
  int width, height;
};

// One row's leaves but f_rest, in registers.
struct Row {
  float x, y, z, logit, sl[3], dc[3];
  float4 q;
};

__device__ __forceinline__ Row load_row(const Leaves& in, long long i, bool dc) {
  Row w;
  w.x = __ldg(in.xyz + 3 * i);
  w.y = __ldg(in.xyz + 3 * i + 1);
  w.z = __ldg(in.xyz + 3 * i + 2);
  w.q = __ldg(reinterpret_cast<const float4*>(in.rotation) + i);
  w.logit = __ldg(in.opacity + i);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w.sl[k] = __ldg(in.scaling + 3 * i + k);
    w.dc[k] = dc ? __ldg(in.f_dc + 3 * i + k) : 0.0f;
  }
  return w;
}

// The Mip variant's inputs: the rows' 3D filter (n,) and the 2D filter's
// variance.
struct MipArgs {
  const float* filter;
  float var2d;
};

// DEG: the active SH degree, or -1 where the caller overrides the colour
// (no rgb, no view direction). MIP: the Mip-Splatting variant.
struct Fields {
  const float* offset;  // (n, 2) or null
  float *mean2d, *conic, *depth, *radius, *rgb, *opacity;
  bool* visible;
};

template <int DEG, bool MIP>
__device__ __forceinline__ void project_fwd_row(Leaves in, int n, int m3, CamPtrs cp, float mod,
                                                MipArgs mip, Fields f) {
  __shared__ Cam cam;
  __shared__ float rest_buf[DEG > 0 ? kWarps * 32 * kMaxRest3 : 1];
  load_cam(cam, cp.wv, cp.fp, cp.cc, cp.tanx, cp.tany, cp.width, cp.height, in.n_live);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
  const long long i = row0 + lane;
  const bool in_range = i < n;
  const int k3 = DEG > 0 ? ((DEG + 1) * (DEG + 1) - 1) * 3 : 0;
  const int stride = (m3 | 1);
  float* buf = rest_buf + (DEG > 0 ? warp * 32 * stride : 0);
  Row w = {};
  float fr = 0.0f;
  if (in_range) {
    w = load_row(in, i, DEG >= 0);
    if (MIP) fr = __ldg(mip.filter + i);
  }
  if (DEG > 0) {
    const unsigned need = __ballot_sync(kFull, in_range);
    const int nrows = static_cast<int>(min(32LL, static_cast<long long>(n) - row0));
    if (nrows > 0) stage_in(in.f_rest, m3, k3, stride, row0, nrows, need, buf, lane);
  }
  if (!in_range) return;

  const float x = w.x, y = w.y, z = w.z;
  Geo g;
  geometry<MIP>(g, cam, x, y, z, w.sl, w.q, i < cam.n_live, mod, fr, mip.var2d);

  f.conic[3 * i] = g.C * g.idet;
  f.conic[3 * i + 1] = -g.B * g.idet;
  f.conic[3 * i + 2] = g.A * g.idet;
  const float mid = 0.5f * (g.A + g.C);
  const float lambda1 = mid + sqrtf(max_nan(mid * mid - g.ds, 0.1f));
  const bool vis = g.base && g.det_ok;
  f.radius[i] = vis ? ceilf(3.0f * sqrtf(max_nan(lambda1, 0.0f))) : 0.0f;
  f.visible[i] = vis;
  f.depth[i] = g.depth;
  float mx = ((g.h0 * g.pw + 1.0f) * cam.width - 1.0f) * 0.5f;
  float my = ((g.h1 * g.pw + 1.0f) * cam.height - 1.0f) * 0.5f;
  if (f.offset != nullptr) {
    const float2 o = __ldg(reinterpret_cast<const float2*>(f.offset) + i);
    mx = mx + o.x;
    my = my + o.y;
  }
  reinterpret_cast<float2*>(f.mean2d)[i] = make_float2(mx, my);
  const float sig = 1.0f / (1.0f + expf(-w.logit));
  if (MIP) {
    f.opacity[i] = vis ? (sig * g.c3) * g.c2 : 0.0f;
  } else {
    f.opacity[i] = vis ? sig : 0.0f;
  }

  if (DEG >= 0) {
    float bk[16];
    if (DEG > 0) {
      Dir d;
      direction(d, cam, x, y, z);
      basis<DEG>(bk, d.x, d.y, d.z);
    }
    const float* rest = buf + lane * stride;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      f.rgb[3 * i + ch] = max_nan(sh_eval<DEG>(bk, w.dc[ch], rest, ch), 0.0f);
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(kThreads) project_fwd_kernel(
    Leaves in, int n, int m3, CamPtrs cp, float mod, Fields f) {
  project_fwd_row<DEG, false>(in, n, m3, cp, mod, MipArgs{nullptr, 0.0f}, f);
}

template <int DEG>
__global__ void __launch_bounds__(kThreads) project_fwd_mip_kernel(
    Leaves in, int n, int m3, CamPtrs cp, float mod, MipArgs mip, Fields f) {
  project_fwd_row<DEG, true>(in, n, m3, cp, mod, mip, f);
}

// The incoming gradients: row-strided views (the pair table's packing hands
// back column slices of its (N + 1, 16) gradient); null where autograd
// passes none.
struct Grads {
  const float *mean2d, *conic, *depth, *rgb, *opacity;
  long long s_mean2d, s_conic, s_depth, s_rgb, s_opacity;
};

struct Outs {
  float *xyz, *f_dc, *f_rest, *opacity, *scaling, *rotation, *offset;
};

// The gradient through clamp(v, -lim, lim) = minimum(maximum(v, -lim), lim):
// autograd's rule, half the gradient each way at a tie.
__device__ __forceinline__ float clamp_grad(float v, float lim, float gout) {
  const float m = max_nan(v, -lim);
  const float gm = m == lim ? gout / 2.0f : (m > lim ? 0.0f : gout);
  return v == -lim ? gm / 2.0f : (v < -lim ? 0.0f : gm);
}

template <int DEG, bool MIP>
__device__ __forceinline__ void project_bwd_row(Leaves in, int n, int m3, CamPtrs cp, float mod,
                                                MipArgs mip, Grads gr, Outs out) {
  __shared__ Cam cam;
  __shared__ float rest_buf[DEG > 0 ? kWarps * 32 * kMaxRest3 : 1];
  load_cam(cam, cp.wv, cp.fp, cp.cc, cp.tanx, cp.tany, cp.width, cp.height, in.n_live);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
  const long long i = row0 + lane;
  const bool in_range = i < n;
  const int k3 = DEG > 0 ? ((DEG + 1) * (DEG + 1) - 1) * 3 : 0;
  const int stride = (m3 | 1);
  float* buf = rest_buf + (DEG > 0 ? warp * 32 * stride : 0);
  const int nrows = static_cast<int>(max(0LL, min(32LL, static_cast<long long>(n) - row0)));

  // the incoming gradients, and the row's leaves but f_rest (56 B, read
  // with them rather than after them); a row with no rgb gradient reads no
  // SH coefficient
  Row w = {};
  float fr = 0.0f;
  if (in_range) {
    w = load_row(in, i, DEG >= 0);
    if (MIP) fr = __ldg(mip.filter + i);
  }
  float gm0 = 0.f, gm1 = 0.f, gc0 = 0.f, gc1 = 0.f, gc2 = 0.f, gd = 0.f, go = 0.f;
  float gc[3] = {0.f, 0.f, 0.f};
  if (in_range) {
    if (gr.mean2d) {
      gm0 = __ldg(gr.mean2d + i * gr.s_mean2d);
      gm1 = __ldg(gr.mean2d + i * gr.s_mean2d + 1);
    }
    if (gr.conic) {
      gc0 = __ldg(gr.conic + i * gr.s_conic);
      gc1 = __ldg(gr.conic + i * gr.s_conic + 1);
      gc2 = __ldg(gr.conic + i * gr.s_conic + 2);
    }
    if (gr.depth) gd = __ldg(gr.depth + i * gr.s_depth);
    if (gr.opacity) go = __ldg(gr.opacity + i * gr.s_opacity);
    if (DEG >= 0 && gr.rgb) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) gc[ch] = __ldg(gr.rgb + i * gr.s_rgb + ch);
    }
  }
  const bool geo_on = in_range && (gm0 != 0.f || gm1 != 0.f || gc0 != 0.f || gc1 != 0.f ||
                                   gc2 != 0.f || gd != 0.f || go != 0.f);
  const bool sh_on = in_range && DEG >= 0 && (gc[0] != 0.f || gc[1] != 0.f || gc[2] != 0.f);
  if (DEG > 0) {
    const unsigned need = __ballot_sync(kFull, sh_on);
    if (need) stage_in(in.f_rest, m3, k3, stride, row0, nrows, need, buf, lane);
  }

  float gx = 0.f, gy = 0.f, gz = 0.f;
  if (in_range && out.offset) {
    reinterpret_cast<float2*>(out.offset)[i] = make_float2(gm0, gm1);
  }
  const float x = w.x, y = w.y, z = w.z;

  if (geo_on) {
    const float4 q4 = w.q;
    const float logit = w.logit;
    Geo g;
    geometry<MIP>(g, cam, x, y, z, w.sl, q4, i < cam.n_live, mod, fr, mip.var2d);
    const bool vis = g.base && g.det_ok;

    // opacity = where(visible, sigmoid(logit), 0); Mip: (sigmoid c3) c2
    const float sig = 1.0f / (1.0f + expf(-logit));
    float g_c3 = 0.0f, g_c2 = 0.0f;
    if (MIP) {
      const float gsig = (go * g.c2) * g.c3;
      out.opacity[i] = vis ? (gsig * (1.0f - sig)) * sig : 0.0f;
      g_c3 = vis ? (go * g.c2) * sig : 0.0f;
      g_c2 = vis ? go * (sig * g.c3) : 0.0f;
    } else {
      out.opacity[i] = vis ? (go * (1.0f - sig)) * sig : 0.0f;
    }

    // mean2d = ndc2pix(h * pw): h0, h1, and h3 through pw
    const float gpx = (gm0 * 0.5f) * cam.width;
    const float gpy = (gm1 * 0.5f) * cam.height;
    const float gh0 = gpx * g.pw, gh1 = gpy * g.pw;
    const float gpw = gpx * g.h0 + gpy * g.h1;
    const float gh3 = -gpw * (g.pw * g.pw);

    // conic = (C, -B, A) / det_safe
    float gA = gc2 * g.idet, gB = -(gc1 * g.idet), gC = gc0 * g.idet;
    const float gidet = (gc0 * g.C + gc1 * (-g.B)) + gc2 * g.A;
    float gdet = g.det_ok ? -gidet * (g.idet * g.idet) : 0.0f;
    if (MIP) {
      // c2 = sqrt(det0 / det_safe), det0 = A0 C0 - B^2 (before the dilation)
      const float gq = g.c2 > 0.0f ? (0.5f * g_c2) / g.c2 : 0.0f;
      const float gdet0 = gq * g.idet;
      if (g.det_ok) gdet = gdet - (gq * g.q2d) * g.idet;
      gA = gA + gdet0 * g.C0;
      gC = gC + gdet0 * g.A0;
      gB = gB - 2.0f * g.B * gdet0;
    }
    gA = gA + gdet * g.C;
    gC = gC + gdet * g.A;
    gB = gB - 2.0f * g.B * gdet;

    // A = a S a + 0.3, B = b S a, C = b S b + 0.3
    float gsa[3], gsb[3], ga[3], gb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gsa[k] = gA * g.a[k] + gB * g.b[k];
      gsb[k] = gC * g.b[k];
    }
    ga[0] = gA * g.sa[0] + ((g.c00 * gsa[0] + g.c01 * gsa[1]) + g.c02 * gsa[2]);
    ga[1] = gA * g.sa[1] + ((g.c01 * gsa[0] + g.c11 * gsa[1]) + g.c12 * gsa[2]);
    ga[2] = gA * g.sa[2] + ((g.c02 * gsa[0] + g.c12 * gsa[1]) + g.c22 * gsa[2]);
    gb[0] = (gB * g.sa[0] + gC * g.sb[0]) + ((g.c00 * gsb[0] + g.c01 * gsb[1]) + g.c02 * gsb[2]);
    gb[1] = (gB * g.sa[1] + gC * g.sb[1]) + ((g.c01 * gsb[0] + g.c11 * gsb[1]) + g.c12 * gsb[2]);
    gb[2] = (gB * g.sa[2] + gC * g.sb[2]) + ((g.c02 * gsb[0] + g.c12 * gsb[1]) + g.c22 * gsb[2]);
    const float g00 = gsa[0] * g.a[0] + gsb[0] * g.b[0];
    const float g01 = (gsa[0] * g.a[1] + gsa[1] * g.a[0]) + (gsb[0] * g.b[1] + gsb[1] * g.b[0]);
    const float g02 = (gsa[0] * g.a[2] + gsa[2] * g.a[0]) + (gsb[0] * g.b[2] + gsb[2] * g.b[0]);
    const float g11 = gsa[1] * g.a[1] + gsb[1] * g.b[1];
    const float g12 = (gsa[1] * g.a[2] + gsa[2] * g.a[1]) + (gsb[1] * g.b[2] + gsb[2] * g.b[1]);
    const float g22 = gsa[2] * g.a[2] + gsb[2] * g.b[2];

    // a_k = j00 W[0][k] + j02 W[2][k], b_k = j11 W[1][k] + j12 W[2][k]
    const float* wv = cam.wv;
    const float gj00 = (ga[0] * wv[0] + ga[1] * wv[4]) + ga[2] * wv[8];
    const float gj02 = (ga[0] * wv[2] + ga[1] * wv[6]) + ga[2] * wv[10];
    const float gj11 = (gb[0] * wv[1] + gb[1] * wv[5]) + gb[2] * wv[9];
    const float gj12 = (gb[0] * wv[2] + gb[1] * wv[6]) + gb[2] * wv[10];
    // j00 = fx iz, j02 = (-fx tx) iz2, j11 = fy iz, j12 = (-fy ty) iz2
    const float giz2 = gj02 * (-cam.fx * g.tx) + gj12 * (-cam.fy * g.ty);
    const float gtx = (gj02 * g.iz2) * -cam.fx;
    const float gty = (gj12 * g.iz2) * -cam.fy;
    const float giz = (gj00 * cam.fx + gj11 * cam.fy) + 2.0f * g.iz * giz2;
    float gzs = -giz * (g.iz * g.iz);
    // t = clamp(pv / zs, -lim, lim) * zs
    gzs = gzs + gtx * g.txtz;
    gzs = gzs + gty * g.tytz;
    const float gu0 = clamp_grad(g.u0, cam.limx, gtx * g.zs);
    const float gu1 = clamp_grad(g.u1, cam.limy, gty * g.zs);
    const float gpv0 = gu0 / g.zs;
    const float gpv1 = gu1 / g.zs;
    gzs = gzs - gu0 * (g.u0 / g.zs);
    gzs = gzs - gu1 * (g.u1 / g.zs);
    const float gpv2 = (g.base ? gzs : 0.0f) + gd;

    // Sigma = R diag(s2) R^T
    const float* r = g.r;
    float gr9[9];
    float gs2[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float r0 = r[m], r1 = r[3 + m], r2 = r[6 + m];
      gr9[m] = g.s2[m] * ((2.0f * g00 * r0 + g01 * r1) + g02 * r2);
      gr9[3 + m] = g.s2[m] * ((g01 * r0 + 2.0f * g11 * r1) + g12 * r2);
      gr9[6 + m] = g.s2[m] * ((g02 * r0 + g12 * r1) + 2.0f * g22 * r2);
      gs2[m] = ((g00 * r0 * r0 + g11 * r1 * r1) + g22 * r2 * r2) +
               ((g01 * r0 * r1 + g02 * r0 * r2) + g12 * r1 * r2);
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      if (MIP) {
        // s = sqrt(exp(l)^2 + f^2) mod; c3 = sqrt(r0 r1 r2), r = e2 / (e2 + f^2):
        // dc3 / dl = c3 f^2 / (e2 + f^2)
        const float gsf = (2.0f * g.s[m] * gs2[m]) * mod;
        const float gt2 = (gsf * 0.5f) / g.sf[m];
        out.scaling[3 * i + m] = (gt2 * (2.0f * g.ex[m])) * g.ex[m] +
                                 (g_c3 * g.c3) * (g.ff / g.t2[m]);
      } else {
        // s2 = s s, s = exp(l) mod
        out.scaling[3 * i + m] = ((2.0f * g.s[m] * gs2[m]) * mod) * g.ex[m];
      }
    }
    // R from the normalised quaternion (qr, qi, qj, qk)
    const float qr = g.q[0], qi = g.q[1], qj = g.q[2], qk = g.q[3];
    const float gqr = 2.0f * (((-qk * gr9[1] + qj * gr9[2]) + (qk * gr9[3] - qi * gr9[5])) +
                              (-qj * gr9[6] + qi * gr9[7]));
    const float gqi = 2.0f * (((qj * gr9[1] + qk * gr9[2]) + (qj * gr9[3] - qr * gr9[5])) +
                              (qk * gr9[6] + qr * gr9[7])) - 4.0f * qi * (gr9[4] + gr9[8]);
    const float gqj = 2.0f * (((qi * gr9[1] + qr * gr9[2]) + (qi * gr9[3] + qk * gr9[5])) +
                              (-qr * gr9[6] + qk * gr9[7])) - 4.0f * qj * (gr9[0] + gr9[8]);
    const float gqk = 2.0f * (((-qr * gr9[1] + qi * gr9[2]) + (qr * gr9[3] + qj * gr9[5])) +
                              (qi * gr9[6] + qj * gr9[7])) - 4.0f * qk * (gr9[0] + gr9[4]);
    // q = p rsqrt(max(|p|^2, 1e-12))
    const float p0 = q4.x, p1 = q4.y, p2 = q4.z, p3 = q4.w;
    const float grs = ((gqr * p0 + gqi * p1) + gqj * p2) + gqk * p3;
    const float gsq = g.sq >= 1e-12f ? (-0.5f * grs) * ((g.rs * g.rs) * g.rs) : 0.0f;
    reinterpret_cast<float4*>(out.rotation)[i] =
        make_float4(gqr * g.rs + 2.0f * p0 * gsq, gqi * g.rs + 2.0f * p1 * gsq,
                    gqj * g.rs + 2.0f * p2 * gsq, gqk * g.rs + 2.0f * p3 * gsq);

    // the clip and view transforms
    const float* fp = cam.fp;
    gx = ((gh0 * fp[0] + gh1 * fp[1]) + gh3 * fp[3]) +
         ((gpv0 * wv[0] + gpv1 * wv[1]) + gpv2 * wv[2]);
    gy = ((gh0 * fp[4] + gh1 * fp[5]) + gh3 * fp[7]) +
         ((gpv0 * wv[4] + gpv1 * wv[5]) + gpv2 * wv[6]);
    gz = ((gh0 * fp[8] + gh1 * fp[9]) + gh3 * fp[11]) +
         ((gpv0 * wv[8] + gpv1 * wv[9]) + gpv2 * wv[10]);
  } else if (in_range) {
    out.opacity[i] = 0.0f;
    out.scaling[3 * i] = 0.0f;
    out.scaling[3 * i + 1] = 0.0f;
    out.scaling[3 * i + 2] = 0.0f;
    reinterpret_cast<float4*>(out.rotation)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (DEG >= 0) {
    float* rest = buf + lane * stride;
    if (sh_on) {
      float bk[16];
      Dir d;
      if (DEG > 0) {
        direction(d, cam, x, y, z);
        basis<DEG>(bk, d.x, d.y, d.z);
      }
      // the clamp at 0 passes gradient where eval + 0.5 >= 0
      float ge[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        ge[ch] = sh_eval<DEG>(bk, w.dc[ch], rest, ch) >= 0.0f ? gc[ch] : 0.0f;
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) out.f_dc[3 * i + ch] = C0 * ge[ch];
      if (DEG > 0) {
        // v[k] = sum over channels of ge * coefficient k; then the
        // coefficients' own gradients overwrite the staged row
        float v[16];
#pragma unroll
        for (int k = 1; k < (DEG + 1) * (DEG + 1); ++k) {
          v[k] = (ge[0] * rest[3 * (k - 1)] + ge[1] * rest[3 * (k - 1) + 1]) +
                 ge[2] * rest[3 * (k - 1) + 2];
        }
#pragma unroll
        for (int k = 1; k < (DEG + 1) * (DEG + 1); ++k) {
          const float f = (k == 1 || k == 3) ? -bk[k] : bk[k];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) rest[3 * (k - 1) + ch] = f * ge[ch];
        }
        const float dx = d.x, dy = d.y, dz = d.z;
        float tx = -C1 * v[3];
        float ty = -C1 * v[1];
        float tz = C1 * v[2];
        if (DEG > 1) {
          tx = tx + ((C2_0 * dy * v[4] + C2_2 * (-2.0f * dx) * v[6]) +
                     (C2_3 * dz * v[7] + C2_4 * (2.0f * dx) * v[8]));
          ty = ty + ((C2_0 * dx * v[4] + C2_1 * dz * v[5]) +
                     (C2_2 * (-2.0f * dy) * v[6] + C2_4 * (-2.0f * dy) * v[8]));
          tz = tz + ((C2_1 * dy * v[5] + C2_2 * (4.0f * dz) * v[6]) + C2_3 * dx * v[7]);
        }
        if (DEG > 2) {
          const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
          tx = tx + (((C3_0 * (6.0f * dx * dy) * v[9] + C3_1 * (dy * dz) * v[10]) +
                      (C3_2 * (-2.0f * dx * dy) * v[11] + C3_3 * (-6.0f * dx * dz) * v[12])) +
                     ((C3_4 * ((4.0f * zz - 3.0f * xx) - yy) * v[13] +
                       C3_5 * (2.0f * dx * dz) * v[14]) +
                      C3_6 * (3.0f * xx - 3.0f * yy) * v[15]));
          ty = ty + (((C3_0 * (3.0f * xx - 3.0f * yy) * v[9] + C3_1 * (dx * dz) * v[10]) +
                      (C3_2 * ((4.0f * zz - xx) - 3.0f * yy) * v[11] +
                       C3_3 * (-6.0f * dy * dz) * v[12])) +
                     ((C3_4 * (-2.0f * dx * dy) * v[13] + C3_5 * (-2.0f * dy * dz) * v[14]) +
                      C3_6 * (-6.0f * dx * dy) * v[15]));
          tz = tz + ((C3_1 * (dx * dy) * v[10] + C3_2 * (8.0f * dy * dz) * v[11]) +
                     ((C3_3 * ((6.0f * zz - 3.0f * xx) - 3.0f * yy) * v[12] +
                       C3_4 * (8.0f * dx * dz) * v[13]) +
                      C3_5 * (xx - yy) * v[14]));
        }
        // d = dirs rsqrt(max(|dirs|^2, 1e-16)), dirs = xyz - cam_center
        const float grs = (tx * d.d0 + ty * d.d1) + tz * d.d2;
        const float gn2 = d.n2 >= 1e-16f ? (-0.5f * grs) * ((d.rs * d.rs) * d.rs) : 0.0f;
        gx = gx + (tx * d.rs + 2.0f * d.d0 * gn2);
        gy = gy + (ty * d.rs + 2.0f * d.d1 * gn2);
        gz = gz + (tz * d.rs + 2.0f * d.d2 * gn2);
      }
    } else if (in_range) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) out.f_dc[3 * i + ch] = 0.0f;
    }
    // every f_rest row is written: at degree 0 (k3 = 0) all zeros
    const unsigned have = __ballot_sync(kFull, sh_on);
    if (nrows > 0 && m3 > 0) stage_out(out.f_rest, m3, k3, stride, row0, nrows, have, buf, lane);
  }
  if (in_range) {
    out.xyz[3 * i] = gx;
    out.xyz[3 * i + 1] = gy;
    out.xyz[3 * i + 2] = gz;
  }
}

template <int DEG>
__global__ void __launch_bounds__(kThreads) project_bwd_kernel(
    Leaves in, int n, int m3, CamPtrs cp, float mod, Grads gr, Outs out) {
  project_bwd_row<DEG, false>(in, n, m3, cp, mod, MipArgs{nullptr, 0.0f}, gr, out);
}

template <int DEG>
__global__ void __launch_bounds__(kThreads) project_bwd_mip_kernel(
    Leaves in, int n, int m3, CamPtrs cp, float mod, MipArgs mip, Grads gr, Outs out) {
  project_bwd_row<DEG, true>(in, n, m3, cp, mod, mip, gr, out);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Leaves: xyz, f_dc, scaling (n, 3), f_rest (n, m3 / 3, 3), opacity (n, 1),
// rotation (n, 4) 16-byte aligned, n_live () int32, all float32 contiguous
// on one device; cam: world_view, full_proj (4, 4) row-major, cam_center
// (3,), tan_fovx, tan_fovy (). deg -1..3 (-1: no rgb). offset (n, 2) or
// null. Outputs: mean2d (n, 2), conic (n, 3), depth, radius, opacity (n,),
// rgb (n, 3) (unused at deg -1), visible (n,) bool. filter3d (n,) or null:
// with it the Mip variant runs, the 2D filter's variance var2d.
// Returns cudaGetLastError() after the launch.
extern "C" int project_fwd_launch(
    const void* xyz, const void* f_dc, const void* f_rest, const void* opac,
    const void* scaling, const void* rotation, const void* n_live, int n, int m3,
    const void* wv, const void* fp, const void* cc, const void* tanx, const void* tany,
    int width, int height, float mod, int deg, const void* offset, void* mean2d,
    void* conic, void* depth, void* radius, void* rgb, void* opacity, void* visible,
    const void* filter3d, float var2d, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (m3 > kMaxRest3) return static_cast<int>(cudaErrorInvalidValue);
  Leaves in{static_cast<const float*>(xyz), static_cast<const float*>(f_dc),
            static_cast<const float*>(f_rest), static_cast<const float*>(opac),
            static_cast<const float*>(scaling), static_cast<const float*>(rotation),
            static_cast<const int32_t*>(n_live)};
  CamPtrs cp{static_cast<const float*>(wv), static_cast<const float*>(fp),
             static_cast<const float*>(cc), static_cast<const float*>(tanx),
             static_cast<const float*>(tany), width, height};
  Fields f{static_cast<const float*>(offset), static_cast<float*>(mean2d),
           static_cast<float*>(conic), static_cast<float*>(depth),
           static_cast<float*>(radius), static_cast<float*>(rgb),
           static_cast<float*>(opacity), static_cast<bool*>(visible)};
  auto s = static_cast<cudaStream_t>(stream);
  const int b = blocks(n);
  if (filter3d != nullptr) {
    const MipArgs mip{static_cast<const float*>(filter3d), var2d};
    switch (deg) {
      case -1: project_fwd_mip_kernel<-1><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, f); break;
      case 0: project_fwd_mip_kernel<0><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, f); break;
      case 1: project_fwd_mip_kernel<1><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, f); break;
      case 2: project_fwd_mip_kernel<2><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, f); break;
      case 3: project_fwd_mip_kernel<3><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, f); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  switch (deg) {
    case -1: project_fwd_kernel<-1><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, f); break;
    case 0: project_fwd_kernel<0><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, f); break;
    case 1: project_fwd_kernel<1><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, f); break;
    case 2: project_fwd_kernel<2><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, f); break;
    case 3: project_fwd_kernel<3><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, f); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same leaves and camera; the incoming gradients g_mean2d (n, >= 2),
// g_conic (n, >= 3), g_depth (n,), g_rgb (n, >= 3), g_opacity (n,), each a
// pointer and a row stride in floats (unit stride within the row), or null
// for none. Outputs, every row written: the gradients of xyz, f_dc,
// scaling (n, 3), f_rest (n, m3 / 3, 3), opacity (n, 1), rotation (n, 4)
// (16-byte aligned) and, unless null, the offset (n, 2). filter3d, var2d:
// as project_fwd_launch's.
// Returns cudaGetLastError() after the launch.
extern "C" int project_bwd_launch(
    const void* xyz, const void* f_dc, const void* f_rest, const void* opac,
    const void* scaling, const void* rotation, const void* n_live, int n, int m3,
    const void* wv, const void* fp, const void* cc, const void* tanx, const void* tany,
    int width, int height, float mod, int deg,
    const void* g_mean2d, long long s_mean2d, const void* g_conic, long long s_conic,
    const void* g_depth, long long s_depth, const void* g_rgb, long long s_rgb,
    const void* g_opacity, long long s_opacity,
    void* o_xyz, void* o_f_dc, void* o_f_rest, void* o_opacity, void* o_scaling,
    void* o_rotation, void* o_offset, const void* filter3d, float var2d, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (m3 > kMaxRest3) return static_cast<int>(cudaErrorInvalidValue);
  Leaves in{static_cast<const float*>(xyz), static_cast<const float*>(f_dc),
            static_cast<const float*>(f_rest), static_cast<const float*>(opac),
            static_cast<const float*>(scaling), static_cast<const float*>(rotation),
            static_cast<const int32_t*>(n_live)};
  CamPtrs cp{static_cast<const float*>(wv), static_cast<const float*>(fp),
             static_cast<const float*>(cc), static_cast<const float*>(tanx),
             static_cast<const float*>(tany), width, height};
  Grads gr{static_cast<const float*>(g_mean2d), static_cast<const float*>(g_conic),
           static_cast<const float*>(g_depth), static_cast<const float*>(g_rgb),
           static_cast<const float*>(g_opacity), s_mean2d, s_conic, s_depth, s_rgb,
           s_opacity};
  Outs out{static_cast<float*>(o_xyz), static_cast<float*>(o_f_dc),
           static_cast<float*>(o_f_rest), static_cast<float*>(o_opacity),
           static_cast<float*>(o_scaling), static_cast<float*>(o_rotation),
           static_cast<float*>(o_offset)};
  auto s = static_cast<cudaStream_t>(stream);
  const int b = blocks(n);
  if (filter3d != nullptr) {
    const MipArgs mip{static_cast<const float*>(filter3d), var2d};
    switch (deg) {
      case -1: project_bwd_mip_kernel<-1><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, gr, out); break;
      case 0: project_bwd_mip_kernel<0><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, gr, out); break;
      case 1: project_bwd_mip_kernel<1><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, gr, out); break;
      case 2: project_bwd_mip_kernel<2><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, gr, out); break;
      case 3: project_bwd_mip_kernel<3><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, mip, gr, out); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  switch (deg) {
    case -1: project_bwd_kernel<-1><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, gr, out); break;
    case 0: project_bwd_kernel<0><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, gr, out); break;
    case 1: project_bwd_kernel<1><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, gr, out); break;
    case 2: project_bwd_kernel<2><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, gr, out); break;
    case 3: project_bwd_kernel<3><<<b, kThreads, 0, s>>>(in, n, m3, cp, mod, gr, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
