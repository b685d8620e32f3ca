"""Carry weights, optimiser state and cameras across from and to gsplat_tpu
as plain numpy.

The port never imports the JAX package; a caller holding a gsplat_tpu model
hands over `np.asarray` of each `Gaussians` leaf (and of each `AdamState`
moment) and gets the port's state, array for array (capacity padding
included); the numpy exports go the other way, so whole states compare.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.core.camera import Camera, make_camera
from gsplat_tpu_torch.core.gaussians import Gaussians
from gsplat_tpu_torch.train.optim import AdamState

_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
           "max_radii2D", "xyz_gradient_accum", "denom")


def gaussians_from_numpy(
    params: Dict[str, np.ndarray],
    n_live: int,
    active_sh_degree: int,
    max_sh_degree: int,
    device: Optional[Union[str, torch.device]] = None,
    spatial_lr_scale: float = 1.0,
) -> Gaussians:
    """gsplat_tpu `Gaussians` array fields (numpy, capacity-padded: the six
    parameters and the three densification accumulators) -> the port's
    `Gaussians` on `device` (CUDA unless named)."""
    device = resolve_device(device)
    return Gaussians(
        **{k: torch.from_numpy(np.array(params[k], np.float32)).to(device)
           for k in _FIELDS},
        n_live=torch.tensor(int(n_live), dtype=torch.int32, device=device),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree),
        spatial_lr_scale=float(spatial_lr_scale),
    )


def gaussians_to_numpy(g: Gaussians) -> Dict[str, np.ndarray]:
    """The port's `Gaussians` -> its nine array fields and n_live as numpy
    (the keys gaussians_from_numpy takes)."""
    out = {k: getattr(g, k).detach().cpu().numpy() for k in _FIELDS}
    out["n_live"] = np.asarray(int(g.n_live), np.int32)
    return out


def adam_state_from_numpy(
    mu: Dict[str, np.ndarray],
    nu: Dict[str, np.ndarray],
    count: int,
    device: Optional[Union[str, torch.device]] = None,
) -> AdamState:
    """gsplat_tpu `AdamState` moments (numpy dicts keyed by parameter group)
    and step count -> the port's `AdamState` on `device` (CUDA unless
    named)."""
    device = resolve_device(device)

    def tensors(d):
        return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                for k, v in d.items()}

    return AdamState(mu=tensors(mu), nu=tensors(nu),
                     count=torch.tensor(int(count), dtype=torch.int32, device=device))


def adam_state_to_numpy(state: AdamState):
    """The port's `AdamState` -> (mu, nu) numpy dicts and the int count."""
    def arrays(d):
        return {k: v.detach().cpu().numpy() for k, v in d.items()}

    return arrays(state.mu), arrays(state.nu), int(state.count)


def camera_from_numpy(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    image: Optional[np.ndarray] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Camera:
    """The camera gsplat_tpu's `make_camera(R, T, fovx, fovy, width,
    height, image)` builds, as the port's `Camera` (identical float32
    matrices and target image)."""
    return make_camera(R, T, fovx, fovy, width, height, image=image, device=device)
