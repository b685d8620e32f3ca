"""Mip-Splatting's 3D smoothing filter (Yu et al. 2024, arXiv 2311.16493).

Each Gaussian k gets a world-space filter f_k = d_k / F * sqrt(0.2): F the
largest focal_x over the training cameras, d_k the least camera-space depth
of its centre over the cameras in which it is valid, 0.2 the filter's
variance in pixels squared. A camera is valid for a centre when its depth
z > 0.2 and the projected centre (x / z' fx + W / 2, y / z' fy + H / 2),
z' = max(z, 0.001), lies in [-0.15 W, 1.15 W] x [-0.15 H, 1.15 H]. A live
row valid in no camera takes the largest d of the valid rows (1e5, the
published code's starting distance, where no row is valid); dead rows get 0.
No gradient flows through the filter.

On CUDA it is two kernels of csrc/filter3d.cu (`filter3d`): one thread a
row with the cameras staged in shared memory, the least valid depth, the
validity flag and the largest valid depth (an atomic max); then the fill
and the scale. `filter3d_plain` is their plain version, the same
operations in the same order, so the two agree bit for bit; it runs only
for CPU tensors.

FILTER_VARIANCE and `filter_factor` are module attributes looked up at call
time, so a test can plant a fault underneath.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from gsplat_tpu_torch import _build
from gsplat_tpu_torch.core.camera import Camera

FILTER_VARIANCE = 0.2   # the 3D filter's variance in pixels squared
NEAR = 0.2              # a valid camera sees the centre beyond this depth
Z_MIN = 0.001           # the depth the projection divides by is clamped here
LO, HI = -0.15, 1.15    # the screen's bounds with its margin, shares of W and H
FAR = 100000.0          # the published code's starting distance
CAM_FLOATS = 20         # a camera in the table: see camera_table
MAX_CAMERAS = 2048      # the kernel stages at most this many (160 KB of 227 KB)


def filter_factor() -> float:
    """sqrt of the filter's variance: f = d / F * filter_factor()."""
    return math.sqrt(FILTER_VARIANCE)


def camera_table(cams: Sequence[Camera], device) -> Tuple[torch.Tensor, float]:
    """The cameras as a (K, 20) float32 table on `device` and F, the largest
    focal_x. A row: world_view's rows 0-3, columns 0-2 (x_cam_j = x wv[0, j]
    + y wv[1, j] + z wv[2, j] + wv[3, j]), fx, fy, W / 2, H / 2, and the
    screen's bounds -0.15 W, 1.15 W, -0.15 H, 1.15 H (float32, as a float32
    tensor compares with a Python scalar)."""
    rows, focal = [], 0.0
    for c in cams:
        wv = c.world_view.detach().to("cpu", torch.float32).numpy()
        fx, fy = float(c.focal_x), float(c.focal_y)
        w, h = float(c.width), float(c.height)
        rows.append(np.concatenate([wv[:4, :3].reshape(-1),
                                    [fx, fy, w / 2.0, h / 2.0, LO * w, HI * w, LO * h, HI * h]]
                                   ).astype(np.float32))
        focal = max(focal, fx)
    table = np.stack(rows) if rows else np.zeros((0, CAM_FLOATS), np.float32)
    return torch.from_numpy(table).to(device), focal


def filter3d_plain(xyz: torch.Tensor, n_live: torch.Tensor, table: torch.Tensor,
                   focal: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The filter of every row, (CAP,) float32, and its validity, (CAP,) bool,
    as plain torch (the kernels' plain version)."""
    cap = xyz.shape[0]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    live = torch.arange(cap, device=xyz.device) < n_live
    dist = torch.full((cap,), FAR, dtype=torch.float32, device=xyz.device)
    valid = torch.zeros(cap, dtype=torch.bool, device=xyz.device)
    for c in table:
        zc = ((x * c[2] + y * c[5]) + z * c[8]) + c[11]
        zz = torch.clamp(zc, min=Z_MIN)
        px = (((x * c[0] + y * c[3]) + z * c[6]) + c[9]) / zz * c[12] + c[14]
        py = (((x * c[1] + y * c[4]) + z * c[7]) + c[10]) / zz * c[13] + c[15]
        ok = (zc > NEAR) & (px >= c[16]) & (px <= c[17]) & (py >= c[18]) & (py <= c[19])
        dist = torch.where(ok, torch.minimum(dist, zz), dist)
        valid = valid | ok
    valid = valid & live
    dmax = dist[valid].max() if bool(valid.any()) else torch.tensor(FAR, device=xyz.device)
    d = torch.where(valid, dist, dmax)
    f = d / torch.tensor(focal, dtype=torch.float32, device=xyz.device) * filter_factor()
    return torch.where(live, f, torch.zeros_like(f)), valid


_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int]
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 4)


def filter3d(xyz: torch.Tensor, n_live: torch.Tensor, table: torch.Tensor,
             focal: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3D filter and its validity: the kernels for CUDA tensors,
    filter3d_plain for CPU ones. xyz (CAP, 3) float32, n_live () int32,
    table and focal from camera_table."""
    if xyz.device.type != "cuda":
        return filter3d_plain(xyz, n_live, table, focal)
    cap, k = xyz.shape[0], table.shape[0]
    if xyz.dtype != torch.float32 or tuple(xyz.shape[1:]) != (3,) or not xyz.is_contiguous():
        raise ValueError("filter3d needs contiguous float32 (CAP, 3) centres")
    if n_live.dtype != torch.int32 or n_live.device != xyz.device or n_live.dim() != 0:
        raise ValueError("n_live must be an int32 scalar on the centres' device")
    if table.dtype != torch.float32 or tuple(table.shape[1:]) != (CAM_FLOATS,) \
            or table.device != xyz.device or not table.is_contiguous():
        raise ValueError("the camera table must be contiguous float32 (K, 20) on the "
                         "centres' device")
    if not 0 < k <= MAX_CAMERAS:
        raise ValueError(f"filter3d stages 1 to {MAX_CAMERAS} cameras, not {k}")
    if cap >= 1 << 31:
        raise ValueError("filter3d counts rows in int32")
    out = torch.empty(cap, dtype=torch.float32, device=xyz.device)
    valid = torch.empty(cap, dtype=torch.bool, device=xyz.device)
    depth = torch.empty(cap, dtype=torch.float32, device=xyz.device)
    dmax = torch.zeros(1, dtype=torch.int32, device=xyz.device)
    lib = _build.load("filter3d")
    fn = lib.filter3d_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(xyz.device):
        err = fn(xyz.data_ptr(), n_live.data_ptr(), cap, table.data_ptr(), k,
                 float(np.float32(focal)), float(np.float32(filter_factor())),
                 depth.data_ptr(), dmax.data_ptr(), out.data_ptr(), valid.data_ptr(),
                 torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(lib, err, "filter3d launch")
    filter3d.launches += 1
    return out, valid


filter3d.launches = 0
