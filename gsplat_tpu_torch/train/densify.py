"""Densification: the per-step statistics, and clone / split / prune /
reset-opacity on capacity-padded tensors.

Port of gsplat_tpu/train/densify.py (upstream 3DGS densify_and_clone,
densify_and_split, prune_points and reset_opacity, with the reference's
defaults). One pass builds a virtual candidate list of 4*CAP rows, [kept
originals | clones | split sample 0 | split sample 1], orders it by
validity with a stable sort (so the survivors, the order of the new rows,
n_live and n_dropped are the JAX function's), and gathers the first CAP
rows. Optimizer moments ride the same gather: survivors keep their rows,
new rows get zeros. Capacity overflow drops the tail and reports it; the
training loop then grows the capacity.

The split noise is drawn by `split_noise` from an explicit torch.Generator
(the reference draws jax.random.normal from its key): densify_and_prune
takes the draw itself, so a test can pass in the JAX draw.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gsplat_tpu_torch.core.gaussians import Gaussians, inverse_sigmoid, pad_fill
from gsplat_tpu_torch.core.transforms import build_rotation
from gsplat_tpu_torch.train.optim import AdamState

SPLIT_N = 2  # upstream densify_and_split N


def add_densification_stats(g: Gaussians, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor, width: int, height: int) -> Gaussians:
    """Accumulate screen-space positional gradient norms for visible Gaussians.

    Upstream convention: the stored viewspace gradient is NDC-scaled (the
    pixel-space d/dmean2d times (0.5*W, 0.5*H)) and the densify threshold
    2e-4 applies to its norm; denom counts the views that saw the Gaussian;
    max_radii2D tracks the largest projected radius."""
    visible = radii > 0.0
    gx = mean2d_grad[:, 0] * (0.5 * width)
    gy = mean2d_grad[:, 1] * (0.5 * height)
    gnorm = torch.sqrt(gx * gx + gy * gy)
    zero = torch.zeros_like(gnorm)
    return g.replace(
        xyz_gradient_accum=g.xyz_gradient_accum + torch.where(visible, gnorm, zero),
        denom=g.denom + visible.to(torch.float32),
        max_radii2D=torch.maximum(g.max_radii2D, torch.where(visible, radii, zero)),
    )


def split_noise(gen: torch.Generator, capacity: int) -> torch.Tensor:
    """The split samples' standard normal draw, (capacity, 3) float32 on the
    generator's device (the reference's jax.random.normal(key, (cap, 3)))."""
    return torch.randn((capacity, 3), generator=gen, dtype=torch.float32,
                       device=gen.device)


def _f32(x: float) -> float:
    """x rounded to float32, as the reference's traced f32 scalars are."""
    return float(np.float32(x))


def densify_selection(g: Gaussians, *, max_grad: float, min_opacity: float,
                      extent: float, max_screen_size: float, percent_dense: float):
    """Which candidate each output row takes -> (src, kind, valid, total):
    (CAP,) int64 source rows, (CAP,) int64 kinds (0 kept, 1 clone, 2 and 3
    the split samples), (CAP,) bool, and the () int64 count of valid
    candidates. Valid candidates come first, each segment in row order (a
    stable sort on invalidity, the reference's lax.sort)."""
    cap = g.capacity
    live = g.live_mask
    grads = torch.where(g.denom > 0, g.xyz_gradient_accum / torch.clamp(g.denom, min=1.0),
                        torch.zeros_like(g.denom))
    max_scale = torch.exp(g.scaling).amax(dim=-1)

    over_thresh = grads >= _f32(max_grad)
    small = max_scale <= _f32(np.float32(percent_dense) * np.float32(extent))
    clone_mask = live & over_thresh & small
    split_mask = live & over_thresh & ~small

    prune_mask = torch.sigmoid(g.opacity[:, 0]) < _f32(min_opacity)
    if max_screen_size > 0:  # upstream gates the size prune on max_screen_size
        prune_mask = prune_mask | (g.max_radii2D > _f32(max_screen_size)) | (
            max_scale > _f32(np.float32(0.1) * np.float32(extent)))
    keep_mask = live & ~prune_mask & ~split_mask  # split sources are pruned

    cand_valid = torch.cat([keep_mask, clone_mask, split_mask, split_mask])
    order = torch.sort((~cand_valid).to(torch.int32), stable=True).indices[:cap]
    src = order % cap
    kind = torch.div(order, cap, rounding_mode="floor")
    return src, kind, cand_valid[order], cand_valid.sum()


def densify_and_prune(
    g: Gaussians,
    opt_state: AdamState,
    noise: torch.Tensor,
    *,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float,
) -> Tuple[Gaussians, AdamState, torch.Tensor]:
    """One densify + prune pass (upstream densify_and_prune) -> (gaussians,
    optimizer state, () int64 count dropped by capacity). `noise` is the
    (CAP, 3) standard normal draw of the split samples (split_noise)."""
    cap = g.capacity
    src, kind, valid, total = densify_selection(
        g, max_grad=max_grad, min_opacity=min_opacity, extent=extent,
        max_screen_size=max_screen_size, percent_dense=percent_dense)
    n_live = torch.clamp(total, max=cap).to(torch.int32)
    n_dropped = torch.clamp(total - cap, min=0)

    # split sampling: noise ~ N(0, diag(scale)) rotated into world space,
    # the products summed in the einsum's order
    scaling = torch.exp(g.scaling)
    scaled = noise * scaling
    q = g.rotation / torch.linalg.vector_norm(g.rotation, dim=-1, keepdim=True)
    R = build_rotation(q)
    offset = (R[:, :, 0] * scaled[:, None, 0] + R[:, :, 1] * scaled[:, None, 1]
              + R[:, :, 2] * scaled[:, None, 2])
    # a tensor divisor: CUDA divides by a Python scalar through its reciprocal
    split_scaling = torch.log(scaling / torch.tensor(0.8 * SPLIT_N, device=g.device))

    xyz = g.xyz[src]
    off = offset[src]
    new_xyz = torch.where((kind == 2)[:, None], xyz + off,
                          torch.where((kind == 3)[:, None], xyz - off, xyz))
    new_scaling = torch.where((kind >= 2)[:, None], split_scaling[src], g.scaling[src])
    params = {
        "xyz": new_xyz,
        "f_dc": g.f_dc[src],
        "f_rest": g.f_rest[src],
        "opacity": g.opacity[src],
        "scaling": new_scaling,
        "rotation": g.rotation[src],
    }
    # inert pad rows for invalid slots
    for k, v in params.items():
        mask = valid.reshape((cap,) + (1,) * (v.ndim - 1))
        params[k] = torch.where(mask, v, pad_fill(k, v.shape, v.device))

    # optimizer moments: survivors gather their rows, new rows get zeros
    keeps_state = (kind == 0) & valid

    def carry(tree):
        out = {}
        for k, a in tree.items():
            mask = keeps_state.reshape((cap,) + (1,) * (a.ndim - 1))
            out[k] = torch.where(mask, a[src], torch.zeros((), dtype=a.dtype, device=a.device))
        return out

    new_state = AdamState(mu=carry(opt_state.mu), nu=carry(opt_state.nu),
                          count=opt_state.count)
    zeros = torch.zeros(cap, dtype=torch.float32, device=g.device)
    g_new = g.replace(**params, xyz_gradient_accum=zeros, denom=zeros.clone(),
                      max_radii2D=zeros.clone(), n_live=n_live)
    return g_new, new_state, n_dropped


def reset_opacity(g: Gaussians, opt_state: AdamState, max_opacity: float = 0.01
                  ) -> Tuple[Gaussians, AdamState]:
    """opacity <- logit(min(sigmoid(opacity), max_opacity)) for live rows;
    the opacity Adam moments are zeroed (upstream replace_tensor_to_optimizer),
    the other groups' kept."""
    live = g.live_mask[:, None]
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(g.opacity), max=_f32(max_opacity)))
    new_op = torch.where(live, new_op, g.opacity)
    mu, nu = dict(opt_state.mu), dict(opt_state.nu)
    mu["opacity"] = torch.zeros_like(mu["opacity"])
    nu["opacity"] = torch.zeros_like(nu["opacity"])
    return g.replace(opacity=new_op), AdamState(mu=mu, nu=nu, count=opt_state.count)

