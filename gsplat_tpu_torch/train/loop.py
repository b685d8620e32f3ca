"""The training step: render -> L1 + D-SSIM loss -> gradients -> per-group
Adam -> densification statistics.

Port of gsplat_tpu/train/loop.py::make_train_step and the budget helpers it
reads. The gradients come from autograd through the
projection and render._Rasterize (the composite_bwd and segment_ends
kernels on CUDA). The
rest of the reference's loop (densify/prune/reset, adaptive budgets,
evaluation, checkpoints) comes with a later slice of the port.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gsplat_tpu_torch.config import MeshParams, OptimizationParams
from gsplat_tpu_torch.core.camera import Camera
from gsplat_tpu_torch.core.gaussians import Gaussians
from gsplat_tpu_torch.render.render import render
from gsplat_tpu_torch.train.densify import add_densification_stats
from gsplat_tpu_torch.train.loss import photometric_loss
from gsplat_tpu_torch.train.optim import (AdamState, adam_update, current_lrs,
                                          make_lr_fns)


def _kept_budget(mesh: MeshParams, budget: int) -> Optional[int]:
    """kept_frac in (0, 1) sizes the post-sort stages as a fraction of the
    pair budget; AUTO (< 0, the default) and 1 start unsplit (None)."""
    if mesh.kept_frac >= 1.0 or mesh.kept_frac < 0:
        return None
    return max(int(budget * mesh.kept_frac), mesh.chunk_size)


def _sat_budget0(mesh: MeshParams, budget: int) -> Optional[int]:
    """sat_frac > 0 turns the saturation bound cull on, its packed survivors
    sized as that fraction of the pair budget; AUTO (< 0, the default) and 0
    start with it off (None)."""
    if mesh.sat_frac <= 0.0:
        return None
    return max(int(budget * mesh.sat_frac), mesh.chunk_size)


def _contrib_budget0(mesh: MeshParams, budget: int) -> Optional[int]:
    """contrib_frac in (0, 1) sizes the backward d-table as a fraction of the
    pair budget; AUTO and 1 start at the worst case (None)."""
    if mesh.contrib_frac >= 1.0 or mesh.contrib_frac < 0:
        return None
    return max(int(budget * mesh.contrib_frac), 512)


def _stage(on_stage, name: str) -> None:
    if on_stage is not None:
        on_stage(name)


def make_train_step(
    opt: OptimizationParams,
    mesh: MeshParams,
    spatial_lr_scale: float,
    width: int,
    height: int,
    pair_budget: Optional[int] = None,
    contrib_budget: Optional[int] = None,
    sat_budget: Optional[int] = None,
    kept_budget: Optional[int] = None,
) -> Callable:
    """The train step for a fixed camera resolution. pair_budget overrides
    mesh.pair_budget; contrib_budget / kept_budget / sat_budget override
    what the mesh fractions give.

    train_step(g, opt_state, cam, bg, step, ema) -> (g_new, opt_state_new,
    loss, ema_new, n_pairs, n_dropped, n_culled, n_contrib, n_sat), the
    reference's nine outputs (n_sat is 0 with the saturation cull off). The
    target image is cam.image; step is the 1-based iteration (an int) the
    LR schedule reads; ema is the previous EMA of the loss (a tensor or a
    float; ignored at step 1). on_stage(name), if given, is called after
    each stage (render's forward stages, then "loss", "backward", "adam",
    "densify_stats") so a caller can time them."""
    lr_fns = make_lr_fns(opt, spatial_lr_scale)
    budget = pair_budget if pair_budget is not None else mesh.pair_budget
    kept = kept_budget if kept_budget is not None else _kept_budget(mesh, budget)
    if contrib_budget is None:
        contrib_budget = _contrib_budget0(mesh, budget)
    if sat_budget is None:
        sat_budget = _sat_budget0(mesh, budget)

    def train_step(g: Gaussians, opt_state: AdamState, cam: Camera, bg: torch.Tensor,
                   step: int, ema, on_stage: Optional[Callable[[str], None]] = None):
        step = int(step)
        params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
        offset = torch.zeros((g.capacity, 2), dtype=torch.float32, device=g.device,
                             requires_grad=True)
        with torch.enable_grad():
            out = render(cam, g.replace(**params), bg, tile_size=mesh.tile_size,
                         chunk=mesh.chunk_size, pair_budget=budget, kept_budget=kept,
                         contrib_budget=contrib_budget, sat_budget=sat_budget,
                         mean2d_offset=offset, on_stage=on_stage)
            loss = photometric_loss(out.image, cam.image, opt.lambda_dssim)
            _stage(on_stage, "loss")
            grads = torch.autograd.grad(loss, list(params.values()) + [offset])
            _stage(on_stage, "backward")
        pgrads = dict(zip(params, grads[:-1]))
        loss = loss.detach()
        lrs = current_lrs(lr_fns, step)
        new_params, new_opt_state = adam_update(
            {k: v.detach() for k, v in params.items()}, pgrads, opt_state, lrs)
        _stage(on_stage, "adam")
        g_new = add_densification_stats(g.replace(**new_params), grads[-1],
                                        out.radii, width, height)
        _stage(on_stage, "densify_stats")
        # the EMA stays on the device: no host sync per iteration
        new_ema = loss if step <= 1 else 0.4 * loss + 0.6 * ema
        return (g_new, new_opt_state, loss, new_ema, out.n_pairs, out.n_dropped,
                out.n_culled, out.n_contrib, out.n_sat)

    return train_step
