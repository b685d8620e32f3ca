"""Plain PyTorch reference of 3D Gaussian Splatting's render, loss and Adam step.

Imports nothing of the program under test: it is the benchmark's yardstick
for `correct` and for the work the roofline shares count. Float32
throughout, TF32 off (`fp32_only`); the per-Gaussian gradient sums in float64.

Semantics (upstream 3DGS, Kerbl et al. 2023, as the port states them):
- projection: near cull at view z <= 0.2, the 1.3 tan(fov/2) Jacobian
  clamp, +0.3 on the 2D covariance's diagonal, radius ceil(3 sqrt(lambda_max)),
  SH up to degree 3 plus 0.5 clamped at 0, sigmoid opacity. The arithmetic is
  written out element by element in the port's order, so that the integer
  radii, which decide a splat's tile rectangle, land on the same integers.
- binning: each splat covers the tiles of its clamped rectangle (getRect);
  a tile composites its splats sorted by (quantized depth, index): the top
  bits of the float32 depth that the packed (tile, depth) sort key keeps.
- compositing: alpha = min(0.99, opacity exp(power)), zero where power > 0
  or below 1/255, front to back; image = colour + T bg. No early stop
  inside the image's arithmetic: a tile stops only once every pixel's
  transmittance is below T_STOP (1e-9), which leaves out less than 1e-9 of
  any pixel. The program stops a tile once every pixel is below 1e-4 (its
  whole-tile exit), so the two differ by at most 1e-4 of a pixel.
- loss: (1 - lambda) L1 + lambda (1 - SSIM), SSIM with an 11-tap Gaussian
  window (sigma 1.5), zero padding, C1 = 0.01^2, C2 = 0.03^2.
- Adam: eps 1e-15, bias-corrected, one learning rate a group, the xyz
  rate on the exponential schedule scaled by the camera extent.

The gradient is autograd's: the loss's cotangent of the image, then each
block of tiles composited again under autograd and differentiated, the
per-pair attribute gradients summed a splat, then autograd through the
projection.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-9          # a tile stops once every pixel's transmittance is below this
T_SAT = 1e-4           # upstream 3DGS's early stop: a pixel saturates below this
ELEMENTS = 1 << 26     # pair-pixel elements a block computes at once (no autograd)
GRAD_ELEMENTS = 1 << 24  # the same under autograd, which keeps about ten of each
PARAM_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
      -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


def fp32_only() -> None:
    """Full float32 in matrix products and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def camera(mats: Dict, fovx: float, fovy: float, width: int, height: int, device) -> Dict:
    """A view's matrices (scene.view_matrices) as tensors on `device`."""
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in mats.items()}
    t.update(tan_fovx=torch.tensor(math.tan(fovx * 0.5), dtype=torch.float32, device=device),
             tan_fovy=torch.tensor(math.tan(fovy * 0.5), dtype=torch.float32, device=device),
             width=width, height=height)
    return t


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH of degree `deg` (<= 3): sh (N, K, 3), dirs (N, 3) unit -> (N, 3)."""
    out = C0 * sh[:, 0]
    if deg > 0:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        out = out - C1 * y * sh[:, 1] + C1 * z * sh[:, 2] - C1 * x * sh[:, 3]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            out = (out + C2[0] * xy * sh[:, 4] + C2[1] * yz * sh[:, 5]
                   + C2[2] * (2.0 * zz - xx - yy) * sh[:, 6] + C2[3] * xz * sh[:, 7]
                   + C2[4] * (xx - yy) * sh[:, 8])
            if deg > 2:
                out = (out + C3[0] * y * (3 * xx - yy) * sh[:, 9] + C3[1] * xy * z * sh[:, 10]
                       + C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
                       + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
                       + C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
                       + C3[5] * z * (xx - yy) * sh[:, 14] + C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return out


def project(p: Dict[str, torch.Tensor], cam: Dict, n_live: int, sh_degree: int) -> Dict:
    """Every row's screen-space splat -> {mean2d (N, 2), conic (N, 3) as
    (a, b, c) of power = -(a dx^2 + c dy^2) / 2 - b dx dy, depth, radius
    (no gradient), rgb (N, 3), opacity (N,), zero where culled}."""
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
    ca = a0 * sa0 + a1 * sa1 + a2 * sa2 + 0.3
    cb = b0 * sa0 + b1 * sa1 + b2 * sa2
    cc = b0 * sb0 + b1 * sb1 + b2 * sb2 + 0.3
    det = ca * cc - cb * cb
    ok = det > 0.0
    det = torch.where(ok, det, torch.ones_like(det))
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
    opacity = torch.where(visible, torch.sigmoid(p["opacity"][:, 0]), torch.zeros_like(depth))
    return {"mean2d": mean2d, "conic": conic, "depth": depth, "radius": radius, "rgb": rgb,
            "opacity": opacity}


def splat_rows(proj: Dict) -> torch.Tensor:
    """(N, 9) rows: mean x, y, conic a, b, c, r, g, b, opacity."""
    return torch.cat([proj["mean2d"], proj["conic"], proj["rgb"], proj["opacity"][:, None]],
                     dim=1)


def tile_grid(width: int, height: int, ts: int) -> Tuple[int, int]:
    return -(-width // ts), -(-height // ts)


def bin_splats(proj: Dict, width: int, height: int, ts: int) -> Dict:
    """Every (splat, tile) pair of the splats' tile rectangles, sorted by
    (tile, quantized depth, index) -> {gid (P,) int64, start, count (T,)}."""
    mean, radius, depth = proj["mean2d"].detach(), proj["radius"], proj["depth"].detach()
    tw, th = tile_grid(width, height, ts)
    x0 = torch.clamp(((mean[:, 0] - radius) / ts).to(torch.int32), 0, tw).long()
    y0 = torch.clamp(((mean[:, 1] - radius) / ts).to(torch.int32), 0, th).long()
    x1 = torch.clamp(((mean[:, 0] + radius + ts - 1) // ts).to(torch.int32), 0, tw).long()
    y1 = torch.clamp(((mean[:, 1] + radius + ts - 1) // ts).to(torch.int32), 0, th).long()
    rw = torch.clamp(x1 - x0, min=0)
    counts = torch.where(radius > 0, rw * torch.clamp(y1 - y0, min=0), 0)
    n = counts.shape[0]
    gid = torch.repeat_interleave(torch.arange(n, device=counts.device), counts)
    local = torch.arange(gid.shape[0], device=counts.device) - (torch.cumsum(counts, 0)
                                                                 - counts)[gid]
    rwg = rw[gid]
    tile = (y0[gid] + local // rwg) * tw + x0[gid] + local % rwg
    del local, rwg
    db = 31 - max(1, (tw * th + 1).bit_length())
    bits = depth.to(torch.float32).contiguous().view(torch.int32).long() & 0xFFFFFFFF
    dq = torch.clamp(bits >> (32 - db), max=(1 << db) - 1)
    key = (((tile << db) | dq[gid]) << 32) | gid
    key, order = torch.sort(key)
    gid = gid[order]
    count = torch.bincount(key >> (32 + db), minlength=tw * th)
    return {"gid": gid, "start": torch.cumsum(count, 0) - count, "count": count,
            "tw": tw, "th": th}


def _tile_pixels(tiles: torch.Tensor, tw: int, ts: int):
    """Pixel coordinates (B, npix) of each tile's pixels, row-major."""
    pix = torch.arange(ts * ts, device=tiles.device)
    px = (tiles[:, None] % tw) * ts + pix[None] % ts
    py = (tiles[:, None] // tw) * ts + pix[None] // ts
    return px, py


def _alpha(rows: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """rows (B, L, 9), pixel coords (B, npix) -> alpha (B, L, npix)."""
    dx = rows[..., 0:1] - px[:, None, :].float()
    dy = rows[..., 1:2] - py[:, None, :].float()
    power = -0.5 * (rows[..., 2:3] * dx * dx + rows[..., 4:5] * dy * dy) \
        - rows[..., 3:4] * dx * dy
    alpha = torch.clamp(rows[..., 8:9] * torch.exp(power), max=ALPHA_MAX)
    return torch.where((power > 0.0) | (alpha < ALPHA_MIN), 0.0, alpha)


def composite(rows: torch.Tensor, bins: Dict, width: int, height: int, ts: int,
              bg: torch.Tensor, chunk: int = 128, count_work: bool = False):
    """Front-to-back compositing of every tile, without gradient -> (image
    (H, W, 3), chunks each tile ran (T,), work {pair_pixels, pairs}: the
    pair-pixels with alpha >= 1/255 in front of which the pixel's
    transmittance is still >= T_SAT, and the pairs with any such pixel)."""
    dev = rows.device
    tw, th = bins["tw"], bins["th"]
    n_tiles, npix = tw * th, ts * ts
    image = torch.zeros((3, th * ts, tw * ts), dtype=torch.float32, device=dev)
    used = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    work = torch.zeros(2, dtype=torch.int64, device=dev)
    lane = torch.arange(chunk, device=dev)
    block = max(1, ELEMENTS // (chunk * npix))
    nch_all = (bins["count"] + chunk - 1) // chunk
    for b0 in range(0, n_tiles, block):
        tiles = torch.arange(b0, min(b0 + block, n_tiles), device=dev)
        start, count, nch = bins["start"][tiles], bins["count"][tiles], nch_all[tiles]
        px, py = _tile_pixels(tiles, tw, ts)
        inside = (px < width) & (py < height)
        T = torch.ones((tiles.shape[0], npix), dtype=torch.float32, device=dev)
        acc = torch.zeros((tiles.shape[0], 3, npix), dtype=torch.float32, device=dev)
        for j in range(int(nch.max()) if tiles.numel() else 0):
            run = torch.nonzero((j < nch) & (T.amax(1) >= T_STOP)).squeeze(1)
            if run.numel() == 0:
                break
            idx = start[run, None] + j * chunk + lane
            valid = idx < (start + count)[run, None]
            r = rows[bins["gid"][torch.where(valid, idx, 0)]] * valid[..., None]
            alpha = _alpha(r, px[run], py[run])
            cp = torch.cumprod(1.0 - alpha, dim=1)
            t_exc = T[run, None, :] * torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], 1)
            acc[run] += torch.einsum("bkc,bkp->bcp", r[..., 5:8], alpha * t_exc)
            if count_work:
                hit = (alpha > 0.0) & (t_exc >= T_SAT) & inside[run, None, :]
                work[0] += hit.sum()
                work[1] += hit.any(-1).sum()
            T[run] = T[run] * cp[:, -1]
            used[tiles[run]] = j + 1
        out = acc + T[:, None, :] * bg[None, :, None]
        ty, tx = tiles // tw, tiles % tw
        # two index tensors apart: the block's axis comes first, (B, 3, ts, ts)
        image.view(3, th, ts, tw, ts)[:, ty, :, tx, :] = out.view(-1, 3, ts, ts)
    img = image[:, :height, :width].permute(1, 2, 0)
    return img, used, {"pair_pixels": int(work[0]), "pairs": int(work[1])}


def composite_grad(rows: torch.Tensor, bins: Dict, used: torch.Tensor, cot: torch.Tensor,
                   width: int, height: int, ts: int, bg: torch.Tensor,
                   chunk: int = 128) -> torch.Tensor:
    """The gradient of sum(cot * image) with respect to the splat rows
    (N, 9), compositing each tile's first `used` chunks again under
    autograd, a block of tiles at a time (the most chunks first), the pair
    gradients summed a splat in float64."""
    dev = rows.device
    tw, th = bins["tw"], bins["th"]
    npix = ts * ts
    grad = torch.zeros(rows.shape, dtype=torch.float64, device=dev)
    cot_t = torch.zeros((3, th * ts, tw * ts), dtype=torch.float32, device=dev)
    cot_t[:, :height, :width] = cot.permute(2, 0, 1)
    cot_t = cot_t.view(3, th, ts, tw, ts)
    order = torch.argsort(used, descending=True)
    u_sorted = used[order].tolist()
    i = 0
    while i < len(u_sorted) and u_sorted[i] > 0:
        k = u_sorted[i]
        b = max(1, GRAD_ELEMENTS // (k * chunk * npix))
        tiles = order[i:i + b]
        i += b
        start, count = bins["start"][tiles], bins["count"][tiles]
        idx = start[:, None] + torch.arange(k * chunk, device=dev)
        valid = (idx < (start + count)[:, None]) & \
            (torch.arange(k * chunk, device=dev) < used[tiles][:, None] * chunk)
        gid = bins["gid"][torch.where(valid, idx, 0)]
        r = (rows[gid] * valid[..., None]).requires_grad_()
        px, py = _tile_pixels(tiles, tw, ts)
        with torch.enable_grad():
            alpha = _alpha(r, px, py)
            cp = torch.cumprod(1.0 - alpha, dim=1)
            t_exc = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], 1)
            out = torch.einsum("bkc,bkp->bcp", r[..., 5:8], alpha * t_exc) \
                + cp[:, -1][:, None, :] * bg[None, :, None]
            c = cot_t[:, tiles // tw, :, tiles % tw, :].reshape(out.shape)
            (out * c).sum().backward()
        grad.index_add_(0, gid[valid], r.grad[valid].double())
    return grad.float()


def _window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / g.sum()


def _blur(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> separable zero-padded SAME blur."""
    c, h = x.shape[-1], w.shape[0] // 2
    y = x.permute(2, 0, 1)[None]
    y = F.conv2d(y, w.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(h, 0), groups=c)
    y = F.conv2d(y, w.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, h), groups=c)
    return y[0].permute(1, 2, 0)


def photometric_loss(img: torch.Tensor, gt: torch.Tensor, lam: float) -> torch.Tensor:
    """(1 - lam) L1 + lam (1 - SSIM)."""
    w = _window(11, 1.5, img.device)
    c = img.shape[-1]
    mu1, mu2, b11, b22, b12 = torch.split(
        _blur(torch.cat([img, gt, img * img, gt * gt, img * gt], -1), w), c, dim=-1)
    s1, s2, s12 = b11 - mu1 * mu1, b22 - mu2 * mu2, b12 - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1)
                                                      * (s1 + s2 + c2))
    return (1.0 - lam) * (img - gt).abs().mean() + lam * (1.0 - ssim.mean())


def learning_rates(lr: Dict, step: int, extent: float) -> Dict[str, float]:
    """Each group's rate at `step`: xyz on 3DGS's log-linear schedule from
    position_lr_init to position_lr_final (times the extent) over
    position_lr_max_steps, the others constant, f_rest at feature_lr / 20."""
    t = min(max(step / lr["position_lr_max_steps"], 0.0), 1.0)
    xyz = math.exp(math.log(lr["position_lr_init"] * extent) * (1 - t)
                   + math.log(lr["position_lr_final"] * extent) * t)
    return {"xyz": xyz, "f_dc": lr["feature_lr"], "f_rest": lr["feature_lr"] / 20.0,
            "opacity": lr["opacity_lr"], "scaling": lr["scaling_lr"],
            "rotation": lr["rotation_lr"]}


def adam_step(params: Dict, grads: Dict, state: Dict, lrs: Dict[str, float]):
    """One bias-corrected Adam step -> (params, state {mu, nu, count})."""
    t = state["count"] + 1
    bc1, bc2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
    new, mu, nu = {}, {}, {}
    for k in params:
        g = grads[k]
        mu[k] = ADAM_B1 * state["mu"][k] + (1.0 - ADAM_B1) * g
        nu[k] = ADAM_B2 * state["nu"][k] + (1.0 - ADAM_B2) * g * g
        new[k] = params[k] - lrs[k] * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
    return new, {"mu": mu, "nu": nu, "count": t}


def adam_init(params: Dict) -> Dict:
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}, "count": 0}


def render(params: Dict, cam: Dict, bg: torch.Tensor, *, n_live: int, sh_degree: int,
           tile_size: int, chunk: int = 128, count_work: bool = False):
    """A view's image (H, W, 3) without gradient -> (image, work)."""
    with torch.no_grad():
        proj = project(params, cam, n_live, sh_degree)
        bins = bin_splats(proj, cam["width"], cam["height"], tile_size)
        img, _, work = composite(splat_rows(proj), bins, cam["width"], cam["height"],
                                 tile_size, bg, chunk, count_work)
    work["visible"] = int((proj["radius"] > 0).sum())
    return img, work


def train_step(params: Dict, state: Dict, cam: Dict, target: torch.Tensor,
               bg: torch.Tensor, step: int, *, n_live: int, sh_degree: int, tile_size: int,
               lam: float, lr: Dict, extent: float, chunk: int = 128):
    """One training step -> (params, state, loss (float), image, grads)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        proj = project(leaves, cam, n_live, sh_degree)
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
