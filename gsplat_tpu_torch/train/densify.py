"""Densification statistics, accumulated every training step.

Port of gsplat_tpu/train/densify.py::add_densification_stats. The clone,
split, prune and opacity-reset operations that read these accumulators come
with a later slice of the port.
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.core.gaussians import Gaussians


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
