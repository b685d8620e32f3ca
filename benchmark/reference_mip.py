"""Plain PyTorch reference of Mip-Splatting's render, loss, Adam step, 3D
filter and densify decisions (Yu, Chen, Huang, Sattler, Geiger, CVPR 2024,
arXiv 2311.16493; github.com/autonomousvision/mip-splatting).

Imports nothing of the program under test and nothing of JAX: the
yardstick of `correct` in the Mip-Splatting cells and of the work their
roofline shares count. Float32 throughout, TF32 off (set at import); the
per-Gaussian gradient sums in float64. Binning, compositing, the loss and
Adam are reference.py's (3DGS's, which Mip-Splatting keeps); what differs
is here:

- the 3D filter (`filter_3d`, the published compute_3D_filter): for each
  centre, over the training cameras, the camera-space depth z of
  `xyz @ R + T` (here spelled out a column at a time), valid where z > 0.2
  and the centre's projection (x / z' fx + W / 2, y / z' fy + H / 2), z' =
  max(z, 0.001), lies in [-0.15 W, 1.15 W] x [-0.15 H, 1.15 H]; the least
  valid z; rows valid in no camera take the largest valid one; the filter is
  that depth / the largest focal_x * sqrt(0.2).
- the projection (`project`): the scales sqrt(s^2 + f^2), the opacity
  sigmoid(o) sqrt(prod s^2 / prod (s^2 + f^2)) (get_scaling_with_3D_filter,
  get_opacity_with_3D_filter); the 2D covariance + 0.1 I in place of 3DGS's
  + 0.3 I, the conic and the radius from it, the opacity times c2 =
  sqrt(det / det(+ 0.1 I)).
- densify's decisions (`densify_decisions`), 3DGS's: the mean accumulated
  view-space gradient at or above the threshold clones a small splat (its
  largest scale at most percent_dense x extent) and splits a large one; a
  live row neither kept nor split is pruned where its opacity is below
  min_opacity or, with a screen-size limit, its radius or its world size
  is too large.

Departures from the published code, each where it has to choose:
- c2 = sqrt(det0 / det) where det0 > 0, else 0; the published code clamps
  both determinants at 1e-6 and adds 1e-6 inside and under the root (a
  change of under 1e-6 relative at the cells' splats) and culls at det == 0
  (here det <= 0, as the port's 3DGS projection culls).
- the filter of a dead (capacity-padding) row is 0, and its opacity
  compensation is taken at unit scales (its products of squared scales
  underflow); with no valid row at all the fill is 1e5, the published
  starting distance (the published code would take the max of an empty
  set).
- the filter's arithmetic is elementwise in float32, the centre's camera
  coordinates summed column by column, where the published code multiplies
  by a matrix (whose summation order the library chooses).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

# reference.py's camera, binning, compositing, loss and Adam, which Mip-Splatting
# keeps (ADAM_B1, adam_init and camera for callers)
from benchmark.reference import (ADAM_B1, adam_init, adam_step, bin_splats, camera,  # noqa: F401
                                 composite, composite_grad, eval_sh, fp32_only,
                                 learning_rates, photometric_loss, splat_rows)

FILTER_2D = 0.1           # the 2D Mip filter's variance, pixels^2
FILTER_3D_VARIANCE = 0.2  # the 3D filter's variance, pixels^2
FAR = 100000.0

fp32_only()


def filter_3d(xyz: torch.Tensor, n_live: int, cams: Sequence[Dict]):
    """compute_3D_filter over `cams` (reference.camera dicts) -> (filter
    (N,), valid (N,) bool)."""
    live = torch.arange(xyz.shape[0], device=xyz.device) < n_live
    distance = torch.full((xyz.shape[0],), FAR, dtype=torch.float32, device=xyz.device)
    valid_points = torch.zeros(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    focal_length = 0.0
    x0, y0, z0 = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    for cam in cams:
        wv = cam["world_view"]
        x, y, z = (x0 * wv[0, j] + y0 * wv[1, j] + z0 * wv[2, j] + wv[3, j] for j in range(3))
        valid_depth = z > 0.2
        z = torch.clamp(z, min=0.001)
        fx = cam["width"] / (2.0 * cam["tan_fovx"])
        fy = cam["height"] / (2.0 * cam["tan_fovy"])
        x = x / z * fx + cam["width"] / 2.0
        y = y / z * fy + cam["height"] / 2.0
        in_screen = ((x >= -0.15 * cam["width"]) & (x <= cam["width"] * 1.15)
                     & (y >= -0.15 * cam["height"]) & (y <= 1.15 * cam["height"]))
        valid = valid_depth & in_screen
        distance = torch.where(valid, torch.minimum(distance, z), distance)
        valid_points = valid_points | valid
        focal_length = max(focal_length, float(fx))
    valid_points = valid_points & live
    if bool(valid_points.any()):
        distance = torch.where(valid_points, distance, distance[valid_points].max())
    f = distance / focal_length * (FILTER_3D_VARIANCE ** 0.5)
    return torch.where(live, f, torch.zeros_like(f)), valid_points


def project(p: Dict[str, torch.Tensor], cam: Dict, n_live: int, sh_degree: int,
            filt: torch.Tensor) -> Dict:
    """Every row's screen-space splat with both Mip filters (`filt` the 3D
    filter, no gradient) -> reference.project's fields."""
    xyz = p["xyz"]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    fp, wv = cam["full_proj"], cam["world_view"]
    hom = [x * fp[0, j] + y * fp[1, j] + z * fp[2, j] + fp[3, j] for j in range(4)]
    p_w = 1.0 / (hom[3] + 1e-7)
    view = [x * wv[0, j] + y * wv[1, j] + z * wv[2, j] + wv[3, j] for j in range(3)]
    depth = view[2]
    live = torch.arange(xyz.shape[0], device=xyz.device) < n_live
    mask = (depth > 0.2) & live

    s = torch.exp(p["scaling"])
    f2 = torch.square(filt.detach())[:, None]
    s_sq = torch.square(s)
    # the padding rows' products underflow (0 / 0): they take s^2 = 1 here
    s_sq_live = torch.where(live[:, None], s_sq, torch.ones_like(s_sq))
    coef3d = torch.sqrt(s_sq_live.prod(dim=1) / (s_sq_live + f2).prod(dim=1))
    s = torch.sqrt(s_sq + f2)
    q = p["rotation"] * torch.rsqrt(torch.clamp((p["rotation"] ** 2).sum(-1, keepdim=True),
                                                min=1e-12))
    qr, qi, qj, qk = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = [[1 - 2 * (qj * qj + qk * qk), 2 * (qi * qj - qr * qk), 2 * (qi * qk + qr * qj)],
         [2 * (qi * qj + qr * qk), 1 - 2 * (qi * qi + qk * qk), 2 * (qj * qk - qr * qi)],
         [2 * (qi * qk - qr * qj), 2 * (qj * qk + qr * qi), 1 - 2 * (qi * qi + qj * qj)]]
    ss = [s[:, 0] * s[:, 0], s[:, 1] * s[:, 1], s[:, 2] * s[:, 2]]

    def cov(i, j):
        return r[i][0] * r[j][0] * ss[0] + r[i][1] * r[j][1] * ss[1] + r[i][2] * r[j][2] * ss[2]

    c00, c01, c02, c11, c12, c22 = cov(0, 0), cov(0, 1), cov(0, 2), cov(1, 1), cov(1, 2), \
        cov(2, 2)
    fx = cam["width"] / (2.0 * cam["tan_fovx"])
    fy = cam["height"] / (2.0 * cam["tan_fovy"])
    limx, limy = 1.3 * cam["tan_fovx"], 1.3 * cam["tan_fovy"]
    zs = torch.where(mask, depth, torch.ones_like(depth))
    tx = torch.minimum(torch.maximum(view[0] / zs, -limx), limx) * zs
    ty = torch.minimum(torch.maximum(view[1] / zs, -limy), limy) * zs
    iz = 1.0 / zs
    iz2 = iz * iz
    w = wv[:3, :3].T
    j00, j02 = fx * iz, -fx * tx * iz2
    j11, j12 = fy * iz, -fy * ty * iz2
    a0, a1, a2 = (j00 * w[0, k] + j02 * w[2, k] for k in range(3))
    b0, b1, b2 = (j11 * w[1, k] + j12 * w[2, k] for k in range(3))
    sa0 = c00 * a0 + c01 * a1 + c02 * a2
    sa1 = c01 * a0 + c11 * a1 + c12 * a2
    sa2 = c02 * a0 + c12 * a1 + c22 * a2
    sb0 = c00 * b0 + c01 * b1 + c02 * b2
    sb1 = c01 * b0 + c11 * b1 + c12 * b2
    sb2 = c02 * b0 + c12 * b1 + c22 * b2
    ca0 = a0 * sa0 + a1 * sa1 + a2 * sa2
    cb = b0 * sa0 + b1 * sa1 + b2 * sa2
    cc0 = b0 * sb0 + b1 * sb1 + b2 * sb2
    det0 = ca0 * cc0 - cb * cb
    ca, cc = ca0 + FILTER_2D, cc0 + FILTER_2D
    det = ca * cc - cb * cb
    ok = det > 0.0
    det = torch.where(ok, det, torch.ones_like(det))
    pos = det0 > 0.0
    coef2d = torch.where(pos, torch.sqrt(torch.where(pos, det0, torch.ones_like(det0)) / det),
                         torch.zeros_like(det))
    inv = 1.0 / det
    conic = torch.stack([cc * inv, -cb * inv, ca * inv], dim=-1)
    mid = 0.5 * (ca + cc)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    visible = mask & ok
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    radius = torch.where(visible, radius, torch.zeros_like(radius)).detach()
    mean2d = torch.stack([((hom[0] * p_w + 1.0) * cam["width"] - 1.0) * 0.5,
                          ((hom[1] * p_w + 1.0) * cam["height"] - 1.0) * 0.5], dim=-1)
    dirs = xyz - cam["cam_center"][None, :]
    dirs = dirs * torch.rsqrt(torch.clamp((dirs * dirs).sum(-1, keepdim=True), min=1e-16))
    sh = torch.cat([p["f_dc"][:, None, :], p["f_rest"]], dim=1)
    rgb = torch.clamp(eval_sh(sh_degree, sh, dirs) + 0.5, min=0.0)
    opacity = torch.sigmoid(p["opacity"][:, 0]) * coef3d * coef2d
    opacity = torch.where(visible, opacity, torch.zeros_like(depth))
    return {"mean2d": mean2d, "conic": conic, "depth": depth, "radius": radius, "rgb": rgb,
            "opacity": opacity}


def render(params: Dict, cam: Dict, bg: torch.Tensor, *, n_live: int, sh_degree: int,
           tile_size: int, chunk: int = 128, count_work: bool = False,
           filt: torch.Tensor = None):
    """A view's image (H, W, 3) without gradient -> (image, work);
    reference.render's signature, the 3D filter `filt` (zeros: the 2D
    filter alone)."""
    if filt is None:
        filt = torch.zeros(params["xyz"].shape[0], dtype=torch.float32,
                           device=params["xyz"].device)
    with torch.no_grad():
        proj = project(params, cam, n_live, sh_degree, filt)
        bins = bin_splats(proj, cam["width"], cam["height"], tile_size)
        img, _, work = composite(splat_rows(proj), bins, cam["width"], cam["height"],
                                 tile_size, bg, chunk, count_work)
    work["visible"] = int((proj["radius"] > 0).sum())
    return img, work


def train_step(params: Dict, state: Dict, cam: Dict, target: torch.Tensor,
               bg: torch.Tensor, step: int, *, n_live: int, sh_degree: int, tile_size: int,
               lam: float, lr: Dict, extent: float, filt: torch.Tensor, chunk: int = 128):
    """One training step -> (params, state, loss (float), image, grads)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        proj = project(leaves, cam, n_live, sh_degree, filt)
        rows = splat_rows(proj)
    bins = bin_splats(proj, cam["width"], cam["height"], tile_size)
    img, used, _ = composite(rows.detach(), bins, cam["width"], cam["height"], tile_size,
                             bg, chunk)
    with torch.enable_grad():
        x = img.detach().requires_grad_()
        loss = photometric_loss(x, target, lam)
        (cot,) = torch.autograd.grad(loss, [x])
    d_rows = composite_grad(rows.detach(), bins, used, cot, cam["width"], cam["height"],
                            tile_size, bg, chunk)
    del bins
    grads = dict(zip(leaves, torch.autograd.grad([rows], list(leaves.values()), [d_rows])))
    new, state = adam_step({k: v.detach() for k, v in params.items()}, grads, state,
                           learning_rates(lr, step, extent))
    return new, state, float(loss.detach()), img, grads


def densify_decisions(accum: torch.Tensor, denom: torch.Tensor, max_radii: torch.Tensor,
                      scaling: torch.Tensor, opacity: torch.Tensor, n_live: int, *,
                      grad_threshold: float, min_opacity: float, extent: float,
                      max_screen_size: float, percent_dense: float) -> Dict[str, int]:
    """The live rows that 3DGS's densify_and_prune clones, splits and prunes
    (a split source counts as split, not pruned), from the accumulators."""
    live = torch.arange(accum.shape[0], device=accum.device) < n_live
    grads = accum / denom
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
    big = torch.exp(scaling).max(dim=1).values > percent_dense * extent
    over = live & (grads >= grad_threshold)
    clone, split = over & ~big, over & big
    prune = torch.sigmoid(opacity[:, 0]) < min_opacity
    if max_screen_size:
        prune = prune | (max_radii > max_screen_size) | \
            (torch.exp(scaling).max(dim=1).values > 0.1 * extent)
    return {"cloned": int(clone.sum()), "split": int(split.sum()),
            "pruned": int((live & ~split & prune).sum())}


# ---------------------------------------------------------------- the work


# a camera of the 3D filter, a row: the three camera coordinates (3 x 6),
# the clamp (1), two divides, multiplies and adds (6), the depth and the
# four bound tests (5), their and (4), the min and the or (2)
FILTER_OPS_PER_CAMERA = 18 + 1 + 6 + 5 + 4 + 2
# a row: its centre read (12 B), its depth written and read back, the
# flag written, the filter written (4 + 4 + 1 + 4)
FILTER_BYTES_PER_ROW = 12 + 4 + 4 + 1 + 4


def filter_work(rows: int, cameras: int) -> Dict[str, float]:
    """(operations, bytes) of one 3D filter pass over `rows` live rows and
    `cameras` cameras."""
    return {"ops": float(FILTER_OPS_PER_CAMERA) * rows * cameras,
            "bytes": float(FILTER_BYTES_PER_ROW) * rows}

