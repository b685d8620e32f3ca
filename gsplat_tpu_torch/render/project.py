"""Gaussian projection: frustum cull, EWA 3D->2D covariance, SH->RGB, radii.

Port of gsplat_tpu/render/project.py::project_gaussians with the same
explicit elementwise expansion in the same operation order, so that
`radius = ceil(3*sqrt(lambda_max))` lands on the same integers as the
reference (a radius one pixel off moves a Gaussian's tile rectangle).
Semantics follow upstream 3DGS's preprocess: near cull at view z <= 0.2, the
1.3*tan_fov Jacobian clamp, +0.3 low-pass on the 2D covariance diagonal,
ndc2pix(v, S) = ((v+1)*S - 1) * 0.5.

On CUDA the projection is one `torch.autograd.Function`, `_Project`, over
the kernels of csrc/project.cu (`project_fwd`, `project_bwd`: one thread a
row, nothing saved but the inputs, a closed-form backward). On the CPU it
is `project_plain`, the elementwise expansion above, differentiated by
autograd op by op as the JAX package differentiates its own: the CPU
tests hold it to the reference, and Adam turns the rounding of a gradient
whose true value is ~0 (a near-isotropic splat's quaternion) into full
steps, so another rounding order drifts from the reference within a few
iterations of a densifying run. `project_bwd_plain` is the backward
kernel's plain version: the same closed form in the same order, held to
autograd on the CPU and to the kernel on the card. An `override_color`
skips SH (the kernels' no-SH branch): it is the rgb, and its gradient
passes straight through.

Mip-Splatting (Yu et al. 2024, arXiv 2311.16493), for a model that carries
`filter_3d` (Gaussians.mip): the 3D filter f widens each scale to
sqrt(s^2 + f^2) (before the scaling modifier) and compensates the opacity
by c3 = sqrt(prod(s^2 / (s^2 + f^2))); the 2D filter adds MIP_FILTER_2D
(0.1) to the screen-space covariance's diagonal in place of 0.3, its conic
and radius from the sum, and compensates the opacity by c2 = sqrt(det /
det(+ 0.1)) (0 where det <= 0). The opacity is (sigmoid c3) c2. The kernels'
Mip variants and the plain version compute it alike. MIP_FILTER_2D is read
at call time, so a test can plant a fault.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch

from gsplat_tpu_torch import _build
from gsplat_tpu_torch.core.camera import Camera
from gsplat_tpu_torch.core.gaussians import Gaussians
from gsplat_tpu_torch.core.sh import C0, C1, C2, C3, eval_sh, sh_basis, sh_to_rgb_color


# the 2D filters: 3DGS's dilation, and Mip-Splatting's filter variance (pixels^2)
DILATION_2D = 0.3
MIP_FILTER_2D = 0.1
# the Mip variants' launches, counted apart from project_fwd's and
# project_bwd's own (which count every launch)
mip_fwd_count = SimpleNamespace(launches=0)
mip_bwd_count = SimpleNamespace(launches=0)


class Projection(NamedTuple):
    mean2d: torch.Tensor   # (N,2) pixel coords
    conic: torch.Tensor    # (N,3) inverse 2D covariance (a,b,c)
    depth: torch.Tensor    # (N,) view-space z
    radius: torch.Tensor   # (N,) float pixel radius (0 = culled)
    rgb: torch.Tensor      # (N,3) SH-evaluated color (>=0)
    opacity: torch.Tensor  # (N,) activated opacity, 0 where not visible
    visible: torch.Tensor  # (N,) bool: radius > 0


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def _terms(g: Gaussians, cam: Camera, scaling_modifier: float) -> SimpleNamespace:
    """The projection's per-row intermediates up to the 2D covariance and its
    determinant, each operation the reference's, made in its order (autograd
    then sums each input's gradient in the order it always has)."""
    t = SimpleNamespace()
    xyz = g.get_xyz()
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    FP = cam.full_proj  # row-vector convention
    t.hom = [x * FP[0, j] + y * FP[1, j] + z * FP[2, j] + FP[3, j] for j in range(4)]
    t.p_w = 1.0 / (t.hom[3] + 1e-7)
    t.px_ndc = t.hom[0] * t.p_w
    t.py_ndc = t.hom[1] * t.p_w
    WV = cam.world_view
    t.p_view = [x * WV[0, j] + y * WV[1, j] + z * WV[2, j] + WV[3, j] for j in range(3)]
    t.depth = t.p_view[2]
    t.base_mask = (t.depth > 0.2) & g.live_mask

    # --- EWA 2D covariance (explicit symmetric-form expansion) ---
    t.ex = g.get_scaling()
    t.mip = g.mip
    if t.mip:
        # the 3D filter: s = sqrt(exp(l)^2 + f^2); c3 = sqrt(r0 r1 r2), r = e2 / t2
        t.ff = (g.filter_3d * g.filter_3d)[:, None]
        t.e2 = t.ex * t.ex
        t.t2 = t.e2 + t.ff
        t.sf = torch.sqrt(t.t2)
        t.rr = t.e2 / t.t2
        t.c3 = torch.sqrt((t.rr[:, 0] * t.rr[:, 1]) * t.rr[:, 2])
        t.s3 = t.sf * scaling_modifier
    else:
        t.s3 = t.ex * scaling_modifier
    # get_rotation, its squared norm and clamped rsqrt kept
    t.sq = (g.rotation * g.rotation).sum(-1, keepdim=True)
    t.rs = torch.rsqrt(torch.clamp(t.sq, min=1e-12))
    t.q = g.rotation * t.rs
    qr, qi, qj, qk = t.q[:, 0], t.q[:, 1], t.q[:, 2], t.q[:, 3]
    t.r = [1 - 2 * (qj * qj + qk * qk), 2 * (qi * qj - qr * qk), 2 * (qi * qk + qr * qj),
           2 * (qi * qj + qr * qk), 1 - 2 * (qi * qi + qk * qk), 2 * (qj * qk - qr * qi),
           2 * (qi * qk - qr * qj), 2 * (qj * qk + qr * qi), 1 - 2 * (qi * qi + qj * qj)]
    t.s2 = [t.s3[:, m] * t.s3[:, m] for m in range(3)]
    r, s2 = t.r, t.s2

    def cov(k, m):  # Sigma = R diag(s^2) R^T, entry (k, m)
        return r[3 * k] * r[3 * m] * s2[0] + r[3 * k + 1] * r[3 * m + 1] * s2[1] \
            + r[3 * k + 2] * r[3 * m + 2] * s2[2]

    c00, c01, c02, c11, c12, c22 = cov(0, 0), cov(0, 1), cov(0, 2), cov(1, 1), cov(1, 2), cov(2, 2)
    t.cov = [[c00, c01, c02], [c01, c11, c12], [c02, c12, c22]]

    t.fx, t.fy = cam.focal_x, cam.focal_y
    t.limx = 1.3 * cam.tan_fovx
    t.limy = 1.3 * cam.tan_fovy
    t.z_safe = torch.where(t.base_mask, t.depth, torch.ones_like(t.depth))
    t.u = [t.p_view[0] / t.z_safe]
    t.txtz = torch.minimum(torch.maximum(t.u[0], -t.limx), t.limx)
    t.u.append(t.p_view[1] / t.z_safe)
    t.tytz = torch.minimum(torch.maximum(t.u[1], -t.limy), t.limy)
    t.tx = t.txtz * t.z_safe
    t.ty = t.tytz * t.z_safe

    t.inv_z = 1.0 / t.z_safe
    t.inv_z2 = t.inv_z * t.inv_z
    # rows a, b of A = J @ W, W = WV[:3,:3]^T (view rotation),
    # J = [[fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]]
    j00, j02 = t.fx * t.inv_z, -t.fx * t.tx * t.inv_z2
    j11, j12 = t.fy * t.inv_z, -t.fy * t.ty * t.inv_z2
    t.a = [j00 * WV[k, 0] + j02 * WV[k, 2] for k in range(3)]
    t.b = [j11 * WV[k, 1] + j12 * WV[k, 2] for k in range(3)]
    # cov2d = A Sigma A^T = [[A, B], [B, C]] (+0.3 on the diagonal)
    cv, a, b = t.cov, t.a, t.b
    t.sa = [cv[k][0] * a[0] + cv[k][1] * a[1] + cv[k][2] * a[2] for k in range(3)]
    t.sb = [cv[k][0] * b[0] + cv[k][1] * b[1] + cv[k][2] * b[2] for k in range(3)]
    t.A0 = a[0] * t.sa[0] + a[1] * t.sa[1] + a[2] * t.sa[2]
    t.B = b[0] * t.sa[0] + b[1] * t.sa[1] + b[2] * t.sa[2]
    t.C0 = b[0] * t.sb[0] + b[1] * t.sb[1] + b[2] * t.sb[2]
    kv = MIP_FILTER_2D if t.mip else DILATION_2D
    t.A = t.A0 + kv
    t.C = t.C0 + kv

    t.det = t.A * t.C - t.B * t.B
    t.det_ok = t.det > 0.0
    t.det_safe = torch.where(t.det_ok, t.det, torch.ones_like(t.det))
    t.inv_det = 1.0 / t.det_safe
    t.visible = t.base_mask & t.det_ok
    if t.mip:
        # the 2D filter's compensation c2 = sqrt(det0 / det_safe), 0 where det0 <= 0
        t.det0 = t.A0 * t.C0 - t.B * t.B
        pos = t.det0 > 0.0
        t.q2d = torch.where(pos, t.det0, torch.ones_like(t.det0)) / t.det_safe
        t.c2 = torch.where(pos, torch.sqrt(t.q2d), torch.zeros_like(t.q2d))
    return t


def project_plain(
    g: Gaussians,
    cam: Camera,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Projection:
    """The projection as plain elementwise torch (the kernels' plain
    version, differentiable by autograd)."""
    t = _terms(g, cam, scaling_modifier)
    conic = torch.stack([t.C * t.inv_det, -t.B * t.inv_det, t.A * t.inv_det], dim=-1)

    mid = 0.5 * (t.A + t.C)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - t.det_safe, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))
    radius = torch.where(t.visible, radius, torch.zeros_like(radius)).detach()

    mean2d = torch.stack([ndc2pix(t.px_ndc, cam.width), ndc2pix(t.py_ndc, cam.height)],
                         dim=-1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    if override_color is not None:
        rgb = override_color
    else:
        xyz = g.get_xyz()
        dirs = xyz - cam.cam_center[None, :]
        dirs = dirs * torch.rsqrt(
            torch.clamp((dirs * dirs).sum(-1, keepdim=True), min=1e-16)
        )
        rgb = sh_to_rgb_color(g.active_sh_degree, g.get_features(), dirs)

    sig = g.get_opacity()[:, 0]
    if t.mip:
        sig = (sig * t.c3) * t.c2
    opacity = torch.where(t.visible, sig, torch.zeros_like(t.depth))
    return Projection(
        mean2d=mean2d,
        conic=conic,
        depth=t.depth,
        radius=radius,
        rgb=rgb,
        opacity=opacity,
        visible=t.visible,
    )


def _clamp_grad(v, lim, g):
    """The gradient through minimum(maximum(v, -lim), lim): autograd's rule
    for each, half the gradient each way at a tie."""
    m = torch.maximum(v, -lim)
    gm = torch.where(m == lim, g / 2.0, torch.where(m > lim, 0.0, g))
    return torch.where(v == -lim, gm / 2.0, torch.where(v < -lim, 0.0, gm))


def project_bwd_plain(g: Gaussians, cam: Camera, scaling_modifier: float, sh: bool,
                      g_mean2d, g_conic, g_depth, g_rgb, g_opacity):
    """The projection's gradient in closed form, elementwise, in the order
    project_bwd computes it: the incoming gradients of mean2d (N,2), conic
    (N,3), depth (N,), rgb (N,3) (sh only) and opacity (N,), each a tensor or
    None -> the gradients of xyz, f_dc, f_rest, opacity (N,1), scaling and
    rotation (f_dc and f_rest None without sh). The offset's gradient is
    g_mean2d."""
    xyz, n = g.xyz, g.capacity
    zero = xyz.new_zeros(n)
    gm = g_mean2d if g_mean2d is not None else xyz.new_zeros((n, 2))
    gc = g_conic if g_conic is not None else xyz.new_zeros((n, 3))
    gd = g_depth if g_depth is not None else zero
    go = g_opacity if g_opacity is not None else zero
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    FP, WV = cam.full_proj, cam.world_view
    t = _terms(g, cam, scaling_modifier)
    h0, h1, pw = t.hom[0], t.hom[1], t.p_w
    base, zs, iz, iz2 = t.base_mask, t.z_safe, t.inv_z, t.inv_z2
    u0, u1, txtz, tytz, tx, ty = t.u[0], t.u[1], t.txtz, t.tytz, t.tx, t.ty
    fx, fy, limx, limy = t.fx, t.fy, t.limx, t.limy
    av, bv, cm, sa, sb = t.a, t.b, t.cov, t.sa, t.sb
    A, B, C, det_ok, idet, vis = t.A, t.B, t.C, t.det_ok, t.inv_det, t.visible
    r, s2c, ex, s = t.r, t.s2, t.ex, t.s3
    p, sq, rs = g.rotation, t.sq[:, 0], t.rs[:, 0]
    qr, qi, qj, qk = t.q[:, 0], t.q[:, 1], t.q[:, 2], t.q[:, 3]

    # opacity = where(visible, sigmoid(logit), 0); Mip: (sigmoid c3) c2
    sig = torch.sigmoid(g.opacity[:, 0])
    if t.mip:
        g_logit = torch.where(vis, (go * t.c2) * t.c3 * (1.0 - sig) * sig, 0.0)
        g_c3 = torch.where(vis, (go * t.c2) * sig, 0.0)
        g_c2 = torch.where(vis, go * (sig * t.c3), 0.0)
    else:
        g_logit = torch.where(vis, go * (1.0 - sig) * sig, 0.0)

    # mean2d = ndc2pix(h * pw)
    gpx = gm[:, 0] * 0.5 * cam.width
    gpy = gm[:, 1] * 0.5 * cam.height
    gh0, gh1 = gpx * pw, gpy * pw
    gpw = gpx * h0 + gpy * h1
    gh3 = -gpw * (pw * pw)

    # conic = (C, -B, A) / det_safe
    gc0, gc1, gc2 = gc[:, 0], gc[:, 1], gc[:, 2]
    gA, gB, gC = gc2 * idet, -(gc1 * idet), gc0 * idet
    gidet = gc0 * C + gc1 * (-B) + gc2 * A
    gdet = torch.where(det_ok, -gidet * (idet * idet), 0.0)
    if t.mip:
        # c2 = sqrt(det0 / det_safe), det0 = A0 C0 - B^2
        gq = torch.where(t.c2 > 0.0, (0.5 * g_c2) / torch.where(t.c2 > 0.0, t.c2, 1.0), 0.0)
        gdet0 = gq * idet
        gdet = torch.where(det_ok, gdet - (gq * t.q2d) * idet, gdet)
        gA = gA + gdet0 * t.C0
        gC = gC + gdet0 * t.A0
        gB = gB - 2.0 * B * gdet0
    gA = gA + gdet * C
    gC = gC + gdet * A
    gB = gB - 2.0 * B * gdet

    # A = a S a + 0.3, B = b S a, C = b S b + 0.3
    gsa = [gA * av[k] + gB * bv[k] for k in range(3)]
    gsb = [gC * bv[k] for k in range(3)]
    ga = [gA * sa[k] + (cm[k][0] * gsa[0] + cm[k][1] * gsa[1] + cm[k][2] * gsa[2])
          for k in range(3)]
    gb = [(gB * sa[k] + gC * sb[k]) + (cm[k][0] * gsb[0] + cm[k][1] * gsb[1] + cm[k][2] * gsb[2])
          for k in range(3)]
    g00 = gsa[0] * av[0] + gsb[0] * bv[0]
    g01 = (gsa[0] * av[1] + gsa[1] * av[0]) + (gsb[0] * bv[1] + gsb[1] * bv[0])
    g02 = (gsa[0] * av[2] + gsa[2] * av[0]) + (gsb[0] * bv[2] + gsb[2] * bv[0])
    g11 = gsa[1] * av[1] + gsb[1] * bv[1]
    g12 = (gsa[1] * av[2] + gsa[2] * av[1]) + (gsb[1] * bv[2] + gsb[2] * bv[1])
    g22 = gsa[2] * av[2] + gsb[2] * bv[2]

    # the Jacobian
    gj00 = ga[0] * WV[0, 0] + ga[1] * WV[1, 0] + ga[2] * WV[2, 0]
    gj02 = ga[0] * WV[0, 2] + ga[1] * WV[1, 2] + ga[2] * WV[2, 2]
    gj11 = gb[0] * WV[0, 1] + gb[1] * WV[1, 1] + gb[2] * WV[2, 1]
    gj12 = gb[0] * WV[0, 2] + gb[1] * WV[1, 2] + gb[2] * WV[2, 2]
    giz2 = gj02 * (-fx * tx) + gj12 * (-fy * ty)
    gtx = gj02 * iz2 * -fx
    gty = gj12 * iz2 * -fy
    giz = (gj00 * fx + gj11 * fy) + 2.0 * iz * giz2
    gzs = -giz * (iz * iz)
    gzs = gzs + gtx * txtz
    gzs = gzs + gty * tytz
    gu0 = _clamp_grad(u0, limx, gtx * zs)
    gu1 = _clamp_grad(u1, limy, gty * zs)
    gpv0, gpv1 = gu0 / zs, gu1 / zs
    gzs = gzs - gu0 * (u0 / zs)
    gzs = gzs - gu1 * (u1 / zs)
    gpv2 = torch.where(base, gzs, 0.0) + gd

    # Sigma = R diag(s2) R^T
    gr9 = [None] * 9
    gs2 = []
    for m in range(3):
        r0, r1, r2 = r[m], r[3 + m], r[6 + m]
        gr9[m] = s2c[m] * ((2.0 * g00 * r0 + g01 * r1) + g02 * r2)
        gr9[3 + m] = s2c[m] * ((g01 * r0 + 2.0 * g11 * r1) + g12 * r2)
        gr9[6 + m] = s2c[m] * ((g02 * r0 + g12 * r1) + 2.0 * g22 * r2)
        gs2.append(((g00 * r0 * r0 + g11 * r1 * r1) + g22 * r2 * r2)
                   + ((g01 * r0 * r1 + g02 * r0 * r2) + g12 * r1 * r2))
    if t.mip:
        # s = sqrt(e2 + f^2) mod; dc3 / dl = c3 f^2 / (e2 + f^2)
        g_scaling = torch.stack([
            ((2.0 * s[:, m] * gs2[m] * scaling_modifier) * 0.5 / t.sf[:, m]) * (2.0 * ex[:, m])
            * ex[:, m] + (g_c3 * t.c3) * (t.ff[:, 0] / t.t2[:, m]) for m in range(3)], dim=-1)
    else:
        g_scaling = torch.stack([2.0 * s[:, m] * gs2[m] * scaling_modifier * ex[:, m]
                                 for m in range(3)], dim=-1)
    gqr = 2.0 * (((-qk * gr9[1] + qj * gr9[2]) + (qk * gr9[3] - qi * gr9[5]))
                 + (-qj * gr9[6] + qi * gr9[7]))
    gqi = 2.0 * (((qj * gr9[1] + qk * gr9[2]) + (qj * gr9[3] - qr * gr9[5]))
                 + (qk * gr9[6] + qr * gr9[7])) - 4.0 * qi * (gr9[4] + gr9[8])
    gqj = 2.0 * (((qi * gr9[1] + qr * gr9[2]) + (qi * gr9[3] + qk * gr9[5]))
                 + (-qr * gr9[6] + qk * gr9[7])) - 4.0 * qj * (gr9[0] + gr9[8])
    gqk = 2.0 * (((-qr * gr9[1] + qi * gr9[2]) + (qr * gr9[3] + qj * gr9[5]))
                 + (qi * gr9[6] + qj * gr9[7])) - 4.0 * qk * (gr9[0] + gr9[4])
    gq = [gqr, gqi, gqj, gqk]
    grs = ((gqr * p[:, 0] + gqi * p[:, 1]) + gqj * p[:, 2]) + gqk * p[:, 3]
    gsq = torch.where(sq >= 1e-12, -0.5 * grs * (rs * rs * rs), 0.0)
    g_rotation = torch.stack([gq[k] * rs + 2.0 * p[:, k] * gsq for k in range(4)], dim=-1)

    # the clip and view transforms
    gxyz = [((gh0 * FP[i, 0] + gh1 * FP[i, 1]) + gh3 * FP[i, 3])
            + ((gpv0 * WV[i, 0] + gpv1 * WV[i, 1]) + gpv2 * WV[i, 2]) for i in range(3)]

    g_f_dc = g_f_rest = None
    if sh:
        deg = g.active_sh_degree
        grgb = g_rgb if g_rgb is not None else xyz.new_zeros((n, 3))
        k_act = (deg + 1) ** 2 - 1
        rest = g.f_rest
        # the view direction and the colour before its clamp, as project_plain
        dirs = xyz - cam.cam_center[None, :]
        n2 = (dirs * dirs).sum(-1, keepdim=True)
        rsd = torch.rsqrt(torch.clamp(n2, min=1e-16))
        d = dirs * rsd
        ge = torch.where(eval_sh(deg, g.get_features(), d) + 0.5 >= 0.0, grgb, 0.0)
        d0, d1, d2, n2, rsd = dirs[:, 0], dirs[:, 1], dirs[:, 2], n2[:, 0], rsd[:, 0]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        bk = sh_basis(deg, d[:, 0:1], d[:, 1:2], d[:, 2:3])
        g_f_dc = C0 * ge
        g_f_rest = torch.zeros_like(rest)
        if deg > 0:
            v = {k: (ge[:, 0] * rest[:, k - 1, 0] + ge[:, 1] * rest[:, k - 1, 1])
                 + ge[:, 2] * rest[:, k - 1, 2] for k in range(1, k_act + 1)}
            for k in range(1, k_act + 1):
                g_f_rest[:, k - 1] = (-bk[k] if k in (1, 3) else bk[k]) * ge
            tx_, ty_, tz_ = -C1 * v[3], -C1 * v[1], C1 * v[2]
            if deg > 1:
                tx_ = tx_ + ((C2[0] * dy * v[4] + C2[2] * (-2.0 * dx) * v[6])
                             + (C2[3] * dz * v[7] + C2[4] * (2.0 * dx) * v[8]))
                ty_ = ty_ + ((C2[0] * dx * v[4] + C2[1] * dz * v[5])
                             + (C2[2] * (-2.0 * dy) * v[6] + C2[4] * (-2.0 * dy) * v[8]))
                tz_ = tz_ + ((C2[1] * dy * v[5] + C2[2] * (4.0 * dz) * v[6]) + C2[3] * dx * v[7])
            if deg > 2:
                xx, yy, zz = dx * dx, dy * dy, dz * dz
                tx_ = tx_ + (((C3[0] * (6.0 * dx * dy) * v[9] + C3[1] * (dy * dz) * v[10])
                              + (C3[2] * (-2.0 * dx * dy) * v[11]
                                 + C3[3] * (-6.0 * dx * dz) * v[12]))
                             + ((C3[4] * ((4.0 * zz - 3.0 * xx) - yy) * v[13]
                                 + C3[5] * (2.0 * dx * dz) * v[14])
                                + C3[6] * (3.0 * xx - 3.0 * yy) * v[15]))
                ty_ = ty_ + (((C3[0] * (3.0 * xx - 3.0 * yy) * v[9] + C3[1] * (dx * dz) * v[10])
                              + (C3[2] * ((4.0 * zz - xx) - 3.0 * yy) * v[11]
                                 + C3[3] * (-6.0 * dy * dz) * v[12]))
                             + ((C3[4] * (-2.0 * dx * dy) * v[13]
                                 + C3[5] * (-2.0 * dy * dz) * v[14])
                                + C3[6] * (-6.0 * dx * dy) * v[15]))
                tz_ = tz_ + ((C3[1] * (dx * dy) * v[10] + C3[2] * (8.0 * dy * dz) * v[11])
                             + ((C3[3] * ((6.0 * zz - 3.0 * xx) - 3.0 * yy) * v[12]
                                 + C3[4] * (8.0 * dx * dz) * v[13])
                                + C3[5] * (xx - yy) * v[14]))
            grsd = (tx_ * d0 + ty_ * d1) + tz_ * d2
            gn2 = torch.where(n2 >= 1e-16, -0.5 * grsd * (rsd * rsd * rsd), 0.0)
            gxyz[0] = gxyz[0] + (tx_ * rsd + 2.0 * d0 * gn2)
            gxyz[1] = gxyz[1] + (ty_ * rsd + 2.0 * d1 * gn2)
            gxyz[2] = gxyz[2] + (tz_ * rsd + 2.0 * d2 * gn2)
    return (torch.stack(gxyz, dim=-1), g_f_dc, g_f_rest, g_logit[:, None], g_scaling,
            g_rotation)


def _cam_args(cam: Camera, device) -> Tuple[torch.Tensor, ...]:
    """world_view, full_proj, cam_center, tan_fovx, tan_fovy as contiguous
    float32 on `device` (no copy where they already are)."""
    return tuple(t.to(device=device, dtype=torch.float32).contiguous()
                 for t in (cam.world_view, cam.full_proj, cam.cam_center, cam.tan_fovx,
                           cam.tan_fovy))


def _check_leaves(leaves, n_live) -> int:
    xyz = leaves[0]
    if xyz.device.type != "cuda":
        raise ValueError(f"the projection kernels run on cuda, not {xyz.device}")
    n = xyz.shape[0]
    shapes = [(n, 3), (n, 3), None, (n, 1), (n, 3), (n, 4)]
    for t, want in zip(leaves, shapes):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != xyz.device \
                or (want is not None and tuple(t.shape) != want):
            raise ValueError("the projection kernels need contiguous float32 leaves "
                             "(xyz, f_dc, f_rest, opacity, scaling, rotation) on one device")
    rest = leaves[2]
    if rest.dim() != 3 or rest.shape[0] != n or rest.shape[2] != 3 or rest.shape[1] > 15:
        raise ValueError("f_rest must be (n, m, 3) with m <= 15")
    if leaves[5].data_ptr() % 16:
        raise ValueError("the rotation leaf must be 16-byte aligned")
    if n_live.dtype != torch.int32 or n_live.device != xyz.device or n_live.dim() != 0:
        raise ValueError("n_live must be an int32 scalar on the leaves' device")
    if n >= 1 << 31:
        raise ValueError("the projection kernels count rows in int32")
    return n


def _kernel_deg(deg: int, m: int) -> int:
    if deg < -1 or deg > 3 or (deg > 0 and (deg + 1) ** 2 - 1 > m):
        raise ValueError(f"SH degree {deg} needs {(deg + 1) ** 2 - 1} rest coefficients, "
                         f"f_rest has {m}")
    return deg


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


_FWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int]
                 + [ctypes.c_void_p] * 9 + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int]
                 + [ctypes.c_void_p, ctypes.c_longlong] * 5 + [ctypes.c_void_p] * 8
                 + [ctypes.c_float, ctypes.c_void_p])


def _check_filter(filter_3d: Optional[torch.Tensor], n: int, device) -> None:
    if filter_3d is not None and (filter_3d.shape != (n,) or filter_3d.dtype != torch.float32
                                  or not filter_3d.is_contiguous()
                                  or filter_3d.device != device):
        raise ValueError("filter_3d must be a contiguous float32 (n,) on the leaves' device")


def project_fwd(leaves, n_live: torch.Tensor, cam: Camera, scaling_modifier: float, deg: int,
                offset: Optional[torch.Tensor] = None,
                filter_3d: Optional[torch.Tensor] = None, var2d: float = MIP_FILTER_2D):
    """The forward kernel: leaves (xyz, f_dc, f_rest, opacity, scaling,
    rotation), n_live () int32, deg the active SH degree or -1 (no rgb) ->
    (mean2d, conic, depth, radius, rgb or None, opacity, visible), each field
    as project_plain's. With filter_3d (n,) the Mip variant runs, its 2D
    filter's variance var2d."""
    n = _check_leaves(leaves, n_live)
    _check_filter(filter_3d, n, leaves[0].device)
    xyz = leaves[0]
    m = leaves[2].shape[1]
    deg = _kernel_deg(deg, m)
    if offset is not None and (offset.shape != (n, 2) or offset.dtype != torch.float32
                               or not offset.is_contiguous() or offset.device != xyz.device
                               or offset.data_ptr() % 8):
        raise ValueError("mean2d_offset must be a contiguous, 8-byte aligned float32 (n, 2) "
                         "on the leaves' device")
    new = dict(dtype=torch.float32, device=xyz.device)
    mean2d = torch.empty((n, 2), **new)
    conic = torch.empty((n, 3), **new)
    depth = torch.empty(n, **new)
    radius = torch.empty(n, **new)
    rgb = torch.empty((n, 3), **new) if deg >= 0 else None
    opacity = torch.empty(n, **new)
    visible = torch.empty(n, dtype=torch.bool, device=xyz.device)
    wv, fp, cc, tanx, tany = _cam_args(cam, xyz.device)
    lib = _build.load("project")
    fn = lib.project_fwd_launch
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(xyz.device):
        err = fn(*[t.data_ptr() for t in leaves], n_live.data_ptr(), n, m * 3,
                 wv.data_ptr(), fp.data_ptr(), cc.data_ptr(), tanx.data_ptr(), tany.data_ptr(),
                 cam.width, cam.height, float(scaling_modifier), deg, _ptr(offset),
                 mean2d.data_ptr(), conic.data_ptr(), depth.data_ptr(), radius.data_ptr(),
                 _ptr(rgb), opacity.data_ptr(), visible.data_ptr(), _ptr(filter_3d),
                 float(var2d), torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(lib, err, "project_fwd launch")
    project_fwd.launches += 1
    mip_fwd_count.launches += filter_3d is not None
    return mean2d, conic, depth, radius, rgb, opacity, visible


project_fwd.launches = 0


def _grad_arg(t: Optional[torch.Tensor], n: int, cols: int, device):
    """An incoming gradient as (pointer, row stride): a (n,) or (n, >= cols)
    float32 view with unit column stride is read in place."""
    if t is None:
        return None, 0
    if t.dtype != torch.float32 or t.device != device:
        t = t.to(device=device, dtype=torch.float32)
    if t.dim() == 1:
        t = t[:, None]
    if t.shape[0] != n or t.shape[1] < cols or (t.shape[1] > 1 and t.stride(1) != 1):
        t = t.contiguous()
    return t.data_ptr(), t.stride(0)


def project_bwd(leaves, n_live: torch.Tensor, cam: Camera, scaling_modifier: float, deg: int,
                g_mean2d, g_conic, g_depth, g_rgb, g_opacity, want_offset: bool,
                filter_3d: Optional[torch.Tensor] = None, var2d: float = MIP_FILTER_2D):
    """The backward kernel: the leaves and settings of project_fwd's call and
    the incoming gradients (tensors or None) -> the gradients of xyz, f_dc,
    f_rest, opacity, scaling, rotation (f_dc and f_rest None at deg -1) and,
    with want_offset, of the offset (else None)."""
    n = _check_leaves(leaves, n_live)
    _check_filter(filter_3d, n, leaves[0].device)
    xyz = leaves[0]
    m = leaves[2].shape[1]
    deg = _kernel_deg(deg, m)
    outs = [None if deg < 0 and k in (1, 2) else torch.empty_like(t)
            for k, t in enumerate(leaves)]
    g_offset = torch.empty((n, 2), dtype=torch.float32, device=xyz.device) if want_offset else None
    grads = [_grad_arg(t, n, c, xyz.device) for t, c in
             ((g_mean2d, 2), (g_conic, 3), (g_depth, 1), (g_rgb if deg >= 0 else None, 3),
              (g_opacity, 1))]
    wv, fp, cc, tanx, tany = _cam_args(cam, xyz.device)
    lib = _build.load("project")
    fn = lib.project_bwd_launch
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(xyz.device):
        err = fn(*[t.data_ptr() for t in leaves], n_live.data_ptr(), n, m * 3,
                 wv.data_ptr(), fp.data_ptr(), cc.data_ptr(), tanx.data_ptr(), tany.data_ptr(),
                 cam.width, cam.height, float(scaling_modifier), deg,
                 *[v for pair in grads for v in pair], *[_ptr(t) for t in outs],
                 _ptr(g_offset), _ptr(filter_3d), float(var2d),
                 torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(lib, err, "project_bwd launch")
    project_bwd.launches += 1
    mip_bwd_count.launches += filter_3d is not None
    return (*outs, g_offset)


project_bwd.launches = 0


class _Project(torch.autograd.Function):
    """The kernels as one autograd Function (CUDA tensors):
    (xyz, f_dc, f_rest, opacity, scaling, rotation, mean2d_offset) ->
    (mean2d, conic, depth, radius, opacity, visible[, rgb]); f_dc and f_rest
    None and no rgb where the caller overrides the colour. static: (g, cam,
    scaling_modifier); g gives n_live, the active SH degree and, for a Mip
    model, the 3D filter (MIP_FILTER_2D is read once, at the forward). Saves
    only its inputs; radius and visible carry no gradient."""

    @staticmethod
    def forward(ctx, xyz, f_dc, f_rest, opacity, scaling, rotation, offset, static):
        g, cam, mod = static
        sh = f_dc is not None
        if not sh:
            f_dc, f_rest = xyz, xyz.new_empty((xyz.shape[0], 0, 3))
        leaves = tuple(t.contiguous() for t in (xyz, f_dc, f_rest, opacity, scaling, rotation))
        n_live = g.n_live.to(device=xyz.device, dtype=torch.int32)
        ctx.save_for_backward(*leaves, n_live)
        ctx.static, ctx.sh, ctx.has_offset = static, sh, offset is not None
        ctx.var2d = MIP_FILTER_2D
        ctx.set_materialize_grads(False)
        mean2d, conic, depth, radius, rgb, opac, visible = project_fwd(
            leaves, n_live, cam, mod, g.active_sh_degree if sh else -1,
            None if offset is None else offset.contiguous(), g.filter_3d, ctx.var2d)
        ctx.mark_non_differentiable(radius, visible)
        return (mean2d, conic, depth, radius, opac, visible) + ((rgb,) if sh else ())

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, g_depth, _g_radius, g_opacity, _g_visible,
                 g_rgb=None):
        g, cam, mod = ctx.static
        saved = ctx.saved_tensors
        gx, gdc, grest, gop, gsc, grot, goff = project_bwd(
            saved[:6], saved[6], cam, mod, g.active_sh_degree if ctx.sh else -1,
            g_mean2d, g_conic, g_depth, g_rgb, g_opacity, ctx.has_offset, g.filter_3d,
            ctx.var2d)
        return gx, gdc, grest, gop, gsc, grot, goff, None


def project_gaussians(
    g: Gaussians,
    cam: Camera,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Projection:
    """Project all (capacity-padded) Gaussians into camera `cam`: the CUDA
    kernels (`_Project`) for CUDA tensors, `project_plain` for others.

    mean2d_offset: optional (N,2) zeros whose gradient is the screen-space
    position gradient densification reads (upstream's screenspace_points)."""
    if g.xyz.device.type != "cuda":
        return project_plain(g, cam, scaling_modifier, override_color, mean2d_offset)
    sh = override_color is None
    out = _Project.apply(g.xyz, g.f_dc if sh else None, g.f_rest if sh else None, g.opacity,
                         g.scaling, g.rotation, mean2d_offset, (g, cam, scaling_modifier))
    mean2d, conic, depth, radius, opacity, visible = out[:6]
    return Projection(mean2d=mean2d, conic=conic, depth=depth, radius=radius,
                      rgb=out[6] if sh else override_color, opacity=opacity, visible=visible)
