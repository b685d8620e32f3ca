"""The plain reference against gsplat_tpu_torch's plain path (the kernels'
plain versions on the CPU) on a tiny scene: the image, and a training step's
loss, gradients and Adam update."""

import math

import pytest
import torch

from benchmark import reference, scene
from benchmark.tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell("sparse-train")
    cfg = cell.config
    params = scene.build_params(cfg, 123456789012, torch.device("cpu"))
    mats = scene.view_matrices(cfg, 2.0, -1.5)
    return cell, cfg, params, mats


def program_render(cfg, params, mats, bg, grad=False):
    from benchmark import harness
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loss import photometric_loss

    leaves = {k: v.detach().requires_grad_(grad) for k, v in params.items()}
    g = harness.program_gaussians(leaves, cfg, 1.0)
    cam = harness.program_camera(mats, cfg, "cpu")
    with torch.set_grad_enabled(grad):
        out = render(cam, g, bg, tile_size=cfg["tile_size"], chunk=cfg["chunk"],
                     pair_budget=cfg["pair_budget"])
    return out, leaves, photometric_loss


def ref_cam(cfg, mats):
    return reference.camera(mats, cfg["fovx"], cfg["fovy"], cfg["width"], cfg["height"], "cpu")


def test_image_agrees(tiny):
    _, cfg, params, mats = tiny
    bg = torch.tensor([0.2, 0.5, 0.9])
    out, _, _ = program_render(cfg, params, mats, bg)
    img, wk = reference.render(params, ref_cam(cfg, mats), bg, n_live=cfg["n_gaussians"],
                               sh_degree=cfg["sh_degree"], tile_size=cfg["tile_size"],
                               chunk=cfg["chunk"], count_work=True)
    # the program stops a tile once every pixel is below 1e-4, the reference
    # at 1e-9: they differ by at most 1e-4 of a pixel
    assert float((out.image - img).abs().max()) < 1e-4
    assert 0 < wk["pair_pixels"] and wk["visible"] == cfg["n_gaussians"]


def test_train_step_agrees(tiny):
    cell, cfg, params, mats = tiny
    tr = cell.traffic
    target = torch.rand((cfg["height"], cfg["width"], 3),
                        generator=torch.Generator().manual_seed(3))
    bg = torch.tensor([0.3, 0.1, 0.6])
    out, leaves, loss_fn = program_render(cfg, params, mats, bg, grad=True)
    with torch.enable_grad():
        loss = loss_fn(out.image, target, tr["lambda_dssim"])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    state = reference.adam_init(params)
    new, state, loss_r, img, grads_r = reference.train_step(
        params, state, ref_cam(cfg, mats), target, bg, 3001, n_live=cfg["n_gaussians"],
        sh_degree=cfg["sh_degree"], tile_size=cfg["tile_size"], lam=tr["lambda_dssim"],
        lr=tr["lr"], extent=1.0, chunk=cfg["chunk"])
    assert abs(float(loss.detach()) - loss_r) <= 1e-6 * loss_r
    for k in grads:
        scale = float(grads_r[k].abs().max())
        assert float((grads[k] - grads_r[k]).abs().max()) <= 1e-4 * max(scale, 1e-12), k
    # Adam's first step moves each element with a gradient by its group's rate
    lrs = reference.learning_rates(tr["lr"], 3001, 1.0)
    moved = (new["opacity"] - params["opacity"]).abs()
    hit = grads_r["opacity"].abs() > 1e-9     # eps 1e-15 is far below these
    assert torch.allclose(moved[hit], torch.full_like(moved[hit], lrs["opacity"]), rtol=1e-3)
    t = 3001 / 30000      # the log-linear schedule a tenth of the way down
    assert math.isclose(lrs["xyz"], 1.6e-4 ** (1 - t) * 1.6e-6 ** t, rel_tol=1e-12)
