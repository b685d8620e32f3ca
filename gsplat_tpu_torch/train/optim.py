"""Per-group Adam with the upstream 3DGS learning-rate surface.

Port of gsplat_tpu/train/optim.py. Six parameter groups, eps 1e-15, the xyz
LR (scaled by spatial_lr_scale) on the exponential log-lerp schedule,
f_rest at feature_lr / 20, and torch::optim::Adam's bias correction
(step = lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)).

Adam is a plain function over a dataclass of tensor dicts, not
`torch.optim.Adam`: densification edits the moments row by row beside the
parameters (upstream's cat_tensors_to_optimizer / _prune_optimizer), which
is plain indexing here. The update is functional (new tensors), as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from gsplat_tpu_torch.config import OptimizationParams
from gsplat_tpu_torch.core.transforms import get_expon_lr_func

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15  # upstream 3DGS value


@dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor  # () int32, shared across groups (stepped together)


def init_adam_state(params: Dict[str, torch.Tensor]) -> AdamState:
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return AdamState(mu=zeros, nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=torch.zeros((), dtype=torch.int32,
                                       device=next(iter(params.values())).device))


def make_lr_fns(opt: OptimizationParams, spatial_lr_scale: float
                ) -> Dict[str, Callable]:
    """Per-group LR callables of the step (upstream's setup)."""
    xyz_schedule = get_expon_lr_func(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )

    def const(v):
        return lambda step: torch.tensor(v, dtype=torch.float32)

    return {
        "xyz": xyz_schedule,
        "f_dc": const(opt.feature_lr),
        "f_rest": const(opt.feature_lr / 20.0),
        "opacity": const(opt.opacity_lr),
        "scaling": const(opt.scaling_lr),
        "rotation": const(opt.rotation_lr),
    }


def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: AdamState, lrs: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], AdamState]:
    """One Adam step over the parameter dict; `lrs` maps group -> () LR
    (a CPU scalar tensor enters the device arithmetic as a scalar)."""
    count = state.count + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - ADAM_B1 ** t
    bc2 = 1.0 - ADAM_B2 ** t
    new_params, new_mu, new_nu = {}, {}, {}
    for k in params:
        g = grads[k]
        mu = ADAM_B1 * state.mu[k] + (1.0 - ADAM_B1) * g
        nu = ADAM_B2 * state.nu[k] + (1.0 - ADAM_B2) * (g * g)
        step = lrs[k] * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        new_params[k] = params[k] - step
        new_mu[k] = mu
        new_nu[k] = nu
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)


def current_lrs(lr_fns: Dict[str, Callable], step) -> Dict[str, torch.Tensor]:
    return {k: fn(step) for k, fn in lr_fns.items()}
