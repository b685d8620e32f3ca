"""Real spherical harmonics (degrees 0..3) -> RGB, as upstream 3DGS evaluates
them (port of gsplat_tpu/core/sh.py, same constants and operation order)."""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def rgb2sh(rgb):
    """RGB in [0, 1] -> the degree-0 SH coefficient (arrays or tensors)."""
    return (rgb - 0.5) / C0


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(deg: int, x, y, z) -> dict:
    """{k: the factor eval_sh multiplies coefficient k by} for k in
    1..(deg+1)^2-1, at direction components x, y, z (coefficients 1 and 3
    enter the sum with a minus)."""
    bk = {}
    if deg > 0:
        bk[1], bk[2], bk[3] = C1 * y, C1 * z, C1 * x
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        bk[4] = C2[0] * xy
        bk[5] = C2[1] * yz
        bk[6] = C2[2] * (2.0 * zz - xx - yy)
        bk[7] = C2[3] * xz
        bk[8] = C2[4] * (xx - yy)
        if deg > 2:
            bk[9] = C3[0] * y * (3 * xx - yy)
            bk[10] = C3[1] * xy * z
            bk[11] = C3[2] * y * (4 * zz - xx - yy)
            bk[12] = C3[3] * z * (2 * zz - 3 * xx - 3 * yy)
            bk[13] = C3[4] * x * (4 * zz - xx - yy)
            bk[14] = C3[5] * z * (xx - yy)
            bk[15] = C3[6] * x * (xx - 3 * yy)
    return bk


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh (..., K, 3) with K >= (deg+1)^2; dirs (..., 3) unit view directions.
    Returns (..., 3), before the upstream +0.5 offset."""
    result = C0 * sh[..., 0, :]
    if deg > 0:
        bk = sh_basis(deg, dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3])
        result = result - bk[1] * sh[..., 1, :] + bk[2] * sh[..., 2, :] - bk[3] * sh[..., 3, :]
        for k in range(4, (deg + 1) ** 2):
            result = result + bk[k] * sh[..., k, :]
    return result


def sh_to_rgb_color(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Upstream rasterizer convention: eval + 0.5, clamped to >= 0."""
    return torch.clamp(eval_sh(deg, sh, dirs) + 0.5, min=0.0)
