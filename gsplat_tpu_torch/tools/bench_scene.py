"""bench.py's scene in numpy: the step and frame tools' fixed workload.

`build_scene` makes the JAX bench's draws in the same order (1M Gaussians on
a flattened normal cloud in front of one camera, scales sized for a target
count of tile pairs per Gaussian, random colours, zero opacity logits, a
random target image; with `aniso`, random rotations and scales stretched
along one axis), so one seed gives the JAX package's scene.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from gsplat_tpu_torch.core.camera import Camera, make_camera
from gsplat_tpu_torch.core.gaussians import Gaussians
from gsplat_tpu_torch.scene import gaussians_from_raw


def build_scene(n, width, height, seed=0, target_pairs_per_gaussian=4.0, tile_size=16,
                aniso=0.0):
    """bench.py::build_scene in numpy, with the same draws in the same order
    -> (raw PLY arrays of the n live Gaussians, camera args (R, T, fovx,
    fovy), the (height, width, 3) target image).

    aniso > 0 stretches each splat's major axis by U[1, 1+aniso] and shrinks
    the minor by the same factor, under a random (unnormalised) quaternion;
    aniso 0 keeps the splats isotropic with the identity quaternion."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.5
    fovx, fovy = 1.2, 0.8
    focal = 0.5 * width / math.tan(fovx / 2)
    z_mean = 4.0
    radius_px = tile_size * (math.sqrt(target_pairs_per_gaussian) - 1.0) / 2.0
    sigma = radius_px * z_mean / (3.0 * focal)
    # drawn even at aniso 0, so the later draws stay where bench.py makes them
    s_an = np.log(rng.uniform(1.0, 1.0 + aniso, n)).astype(np.float32)
    f_dc = rng.random((n, 3)).astype(np.float32)
    if aniso > 0:
        stretch = np.stack([s_an, -s_an, np.zeros(n, np.float32)], axis=1)
        # bench.py's sum in numpy's own precision, rounded to float32 as
        # jnp.asarray rounds it
        scaling = (np.log(sigma) + stretch.astype(np.float32)).astype(np.float32)
        rotation = rng.normal(size=(n, 4)).astype(np.float32)
    else:
        scaling = np.full((n, 3), np.log(sigma), np.float32)
        rotation = np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1))
    img = rng.random((height, width, 3)).astype(np.float32)
    raw = {
        "xyz": pts,
        "features_dc": f_dc,
        "features_rest": np.zeros((n, 15, 3), np.float32),
        "opacity": np.zeros((n, 1), np.float32),
        "scaling": scaling,
        "rotation": rotation,
    }
    return raw, (np.eye(3), np.array([0.0, 0.0, z_mean]), fovx, fovy), img


def scene_on_device(n, width, height, target_pairs_per_gaussian=4.0, tile_size=16,
                    device: Optional[Union[str, torch.device]] = None, aniso=0.0
                    ) -> Tuple[Gaussians, Camera]:
    """build_scene's model (capacity the next power of two) and its camera,
    the target image attached, on `device` (CUDA unless named)."""
    raw, (R, T, fovx, fovy), img = build_scene(
        n, width, height, target_pairs_per_gaussian=target_pairs_per_gaussian,
        tile_size=tile_size, aniso=aniso)
    g = gaussians_from_raw(raw, capacity=1 << (n - 1).bit_length(), sh_degree=3,
                           device=device)
    cam = make_camera(R, T, fovx, fovy, width, height, image=img, device=g.device)
    return g, cam


def fwd_bwd(g: Gaussians, cam: Camera, bg: torch.Tensor, **render_kw):
    """One forward + backward of the bench's training objective (render,
    L1 + D-SSIM at lambda 0.2, gradients of every parameter group) ->
    (loss, RenderOutput, {group: gradient})."""
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loss import photometric_loss

    params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
    with torch.enable_grad():
        out = render(cam, g.replace(**params), bg, **render_kw)
        loss = photometric_loss(out.image, cam.image, 0.2)
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), out, dict(zip(params, grads))
