"""Quaternion/scale geometry (torch) and camera matrices (numpy).

Port of gsplat_tpu/core/transforms.py. The camera-matrix builders are numpy
in the reference and are copied as they are, so both packages build the very
same float64 matrices.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (N,4) [w,x,y,z] -> rotation matrices (N,3,3), normalising
    by a clamped rsqrt (a zero quaternion maps to the zero matrix instead of
    NaN)."""
    q = q * torch.rsqrt(torch.clamp((q * q).sum(-1, keepdim=True), min=1e-12))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R(q) @ diag(s): (N,3),(N,4) -> (N,3,3)."""
    return build_rotation(q) * s[..., None, :]


def get_expon_lr_func(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Log-lerp LR schedule with an optional sine delay ramp: step (int or
    tensor) -> () float32 tensor, computed in float32 as the reference
    computes it on its traced step."""

    def helper(step):
        step_f = torch.as_tensor(step).to(torch.float32)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step_f / lr_delay_steps, 0.0, 1.0)
            )
        else:
            delay_rate = 1.0
        t = torch.clamp(step_f / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        out = delay_rate * log_lerp
        # 0 for step < 0, and for all-zero lr endpoints
        if lr_init == 0.0 and lr_final == 0.0:
            return torch.zeros_like(out)
        return torch.where(step_f < 0, torch.zeros_like(out), out)

    return helper


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def get_world2view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """World->view 4x4: top-left R^T, last column t (R is camera->world)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    return Rt


def get_world2view_2(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray = np.zeros(3),
    scale: float = 1.0,
) -> np.ndarray:
    """World->view with the camera-centre translate/scale applied."""
    Rt = get_world2view(R, t)
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + np.asarray(translate)) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W)


def get_projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection (z_sign=+1)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    bottom, left = -top, -right
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P
