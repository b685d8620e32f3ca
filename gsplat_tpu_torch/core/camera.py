"""Render-ready camera with precomputed view/projection matrices.

Port of gsplat_tpu/core/camera.py::Camera/make_camera. The matrices are built
in float64 numpy exactly as the reference builds them (row-vector convention:
world_view = W2V(R,T,trans,scale)^T, full_proj = world_view @ P^T,
cam_center = inv(world_view)[3,:3]) and only then rounded to float32 tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.core.transforms import get_projection_matrix, get_world2view_2

ZNEAR = 0.01
ZFAR = 100.0


@dataclass
class Camera:
    world_view: torch.Tensor   # (4,4), transposed (row-vector) world->view
    full_proj: torch.Tensor    # (4,4), transposed world->clip
    cam_center: torch.Tensor   # (3,)
    tan_fovx: torch.Tensor     # () tangent of half fov
    tan_fovy: torch.Tensor     # ()
    image: Optional[torch.Tensor] = None  # (H,W,3) ground truth in [0,1], or None
    width: int = 0
    height: int = 0
    image_name: str = ""
    uid: int = 0

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tan_fovy)


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    image: Optional[np.ndarray] = None,
    trans: np.ndarray = np.zeros(3),
    scale: float = 1.0,
    image_name: str = "",
    uid: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Camera:
    """Build the precomputed-matrix camera on `device` (CUDA unless named).
    `image`, the training target, is clipped to [0, 1] as float32, as the
    reference clips it."""
    device = resolve_device(device)
    world_view = get_world2view_2(R, T, trans, scale).T
    proj = get_projection_matrix(ZNEAR, ZFAR, fovx, fovy).T
    cam_center = np.linalg.inv(world_view)[3, :3]
    full_proj = world_view @ proj

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return Camera(
        world_view=f32(world_view),
        full_proj=f32(full_proj),
        cam_center=f32(cam_center),
        tan_fovx=f32(math.tan(fovx * 0.5)),
        tan_fovy=f32(math.tan(fovy * 0.5)),
        image=None if image is None else f32(np.clip(image, 0.0, 1.0)),
        width=width,
        height=height,
        image_name=image_name,
        uid=uid,
    )
