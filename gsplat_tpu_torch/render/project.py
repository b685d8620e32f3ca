"""Gaussian projection: frustum cull, EWA 3D->2D covariance, SH->RGB, radii.

Port of gsplat_tpu/render/project.py::project_gaussians with the same
explicit elementwise expansion in the same operation order, so that
`radius = ceil(3*sqrt(lambda_max))` lands on the same integers as the
reference (a radius one pixel off moves a Gaussian's tile rectangle).
Semantics follow upstream 3DGS's preprocess: near cull at view z <= 0.2, the
1.3*tan_fov Jacobian clamp, +0.3 low-pass on the 2D covariance diagonal,
ndc2pix(v, S) = ((v+1)*S - 1) * 0.5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch.core.camera import Camera
from gsplat_tpu_torch.core.gaussians import Gaussians
from gsplat_tpu_torch.core.sh import sh_to_rgb_color


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


def project_gaussians(
    g: Gaussians,
    cam: Camera,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
) -> Projection:
    """Project all (capacity-padded) Gaussians into camera `cam`.

    mean2d_offset: optional (N,2) zeros whose gradient is the screen-space
    position gradient densification reads (upstream's screenspace_points)."""
    xyz = g.get_xyz()
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    FP = cam.full_proj  # row-vector convention
    hom = [x * FP[0, j] + y * FP[1, j] + z * FP[2, j] + FP[3, j] for j in range(4)]
    p_w = 1.0 / (hom[3] + 1e-7)
    px_ndc = hom[0] * p_w
    py_ndc = hom[1] * p_w
    WV = cam.world_view
    p_view = [x * WV[0, j] + y * WV[1, j] + z * WV[2, j] + WV[3, j] for j in range(3)]
    depth = p_view[2]

    in_front = depth > 0.2
    base_mask = in_front & g.live_mask

    # --- EWA 2D covariance (explicit symmetric-form expansion) ---
    s3 = g.get_scaling() * scaling_modifier
    q = g.get_rotation()
    qr, qi, qj, qk = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qj * qj + qk * qk)
    r01 = 2 * (qi * qj - qr * qk)
    r02 = 2 * (qi * qk + qr * qj)
    r10 = 2 * (qi * qj + qr * qk)
    r11 = 1 - 2 * (qi * qi + qk * qk)
    r12 = 2 * (qj * qk - qr * qi)
    r20 = 2 * (qi * qk - qr * qj)
    r21 = 2 * (qj * qk + qr * qi)
    r22 = 1 - 2 * (qi * qi + qj * qj)
    s0sq, s1sq, s2sq = s3[:, 0] * s3[:, 0], s3[:, 1] * s3[:, 1], s3[:, 2] * s3[:, 2]
    # Sigma = R diag(s^2) R^T, 6 unique entries
    c00 = r00 * r00 * s0sq + r01 * r01 * s1sq + r02 * r02 * s2sq
    c01 = r00 * r10 * s0sq + r01 * r11 * s1sq + r02 * r12 * s2sq
    c02 = r00 * r20 * s0sq + r01 * r21 * s1sq + r02 * r22 * s2sq
    c11 = r10 * r10 * s0sq + r11 * r11 * s1sq + r12 * r12 * s2sq
    c12 = r10 * r20 * s0sq + r11 * r21 * s1sq + r12 * r22 * s2sq
    c22 = r20 * r20 * s0sq + r21 * r21 * s1sq + r22 * r22 * s2sq

    fx, fy = cam.focal_x, cam.focal_y
    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    z_safe = torch.where(base_mask, depth, torch.ones_like(depth))
    txtz = torch.minimum(torch.maximum(p_view[0] / z_safe, -limx), limx)
    tytz = torch.minimum(torch.maximum(p_view[1] / z_safe, -limy), limy)
    tx = txtz * z_safe
    ty = tytz * z_safe

    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    # rows of A = J @ W, W = WV[:3,:3]^T (view rotation),
    # J = [[fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]]
    W = cam.world_view[:3, :3].T
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    a0 = j00 * W[0, 0] + j02 * W[2, 0]
    a1 = j00 * W[0, 1] + j02 * W[2, 1]
    a2 = j00 * W[0, 2] + j02 * W[2, 2]
    b0 = j11 * W[1, 0] + j12 * W[2, 0]
    b1 = j11 * W[1, 1] + j12 * W[2, 1]
    b2 = j11 * W[1, 2] + j12 * W[2, 2]
    # cov2d = A Sigma A^T with A rows a=(a0,a1,a2), b=(b0,b1,b2)
    sa0 = c00 * a0 + c01 * a1 + c02 * a2
    sa1 = c01 * a0 + c11 * a1 + c12 * a2
    sa2 = c02 * a0 + c12 * a1 + c22 * a2
    sb0 = c00 * b0 + c01 * b1 + c02 * b2
    sb1 = c01 * b0 + c11 * b1 + c12 * b2
    sb2 = c02 * b0 + c12 * b1 + c22 * b2
    a = a0 * sa0 + a1 * sa1 + a2 * sa2 + 0.3
    b = b0 * sa0 + b1 * sa1 + b2 * sa2
    c = b0 * sb0 + b1 * sb1 + b2 * sb2 + 0.3

    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))
    visible = base_mask & det_ok
    radius = torch.where(visible, radius, torch.zeros_like(radius)).detach()

    mean2d = torch.stack(
        [ndc2pix(px_ndc, cam.width), ndc2pix(py_ndc, cam.height)], dim=-1
    )
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    if override_color is not None:
        rgb = override_color
    else:
        dirs = xyz - cam.cam_center[None, :]
        dirs = dirs * torch.rsqrt(
            torch.clamp((dirs * dirs).sum(-1, keepdim=True), min=1e-16)
        )
        rgb = sh_to_rgb_color(g.active_sh_degree, g.get_features(), dirs)

    opacity = torch.where(visible, g.get_opacity()[:, 0], torch.zeros_like(depth))
    return Projection(
        mean2d=mean2d,
        conic=conic,
        depth=depth,
        radius=radius,
        rgb=rgb,
        opacity=opacity,
        visible=visible,
    )
