"""Render-ready camera with precomputed view/projection matrices.

Port of gsplat_tpu/core/camera.py: Camera, make_camera, and the dataset
side (_scaled_resolution, _resize_image, load_camera, camera_to_json). The
matrices are built in float64 numpy exactly as the reference builds them
(row-vector convention: world_view = W2V(R,T,trans,scale)^T, full_proj =
world_view @ P^T, cam_center = inv(world_view)[3,:3]) and only then rounded
to float32 tensors.

The reference resizes a ground-truth image with PIL's LANCZOS; the port
computes the same filter itself (`lanczos_resize`): PIL's coefficients
(support 3, widened by the downscale factor, normalised, then rounded to
22-bit fixed point), the horizontal pass and then the vertical one, each
rounded and clipped to uint8 as PIL rounds it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.core.transforms import (fov2focal, get_projection_matrix,
                                              get_world2view_2)
from gsplat_tpu_torch.io.dataset import CameraInfo

ZNEAR = 0.01
ZFAR = 100.0
WARNED = [False]
# PIL's fixed-point precision for 8-bit resampling (Resample.c PRECISION_BITS)
_PRECISION_BITS = 32 - 8 - 2


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


def _scaled_resolution(info: CameraInfo, resolution: int, resolution_scale: float = 1.0
                       ) -> Tuple[int, int]:
    """Upstream camera_utils.loadCam resolution policy: -1 caps width at 1600px;
    positive values divide."""
    if resolution in (1, 2, 4, 8):
        down = resolution_scale * resolution
    elif resolution == -1:
        if info.width > 1600:
            if not WARNED[0]:
                print(
                    "[ INFO ] Encountered quite large input images (>1.6K pixels "
                    "width), rescaling to 1.6K.\n If this is not desired, please "
                    "explicitly specify '--resolution/-r' as 1"
                )
                WARNED[0] = True
            down = resolution_scale * (info.width / 1600)
        else:
            down = resolution_scale
    else:
        down = resolution_scale * (info.width / resolution)
    return round(info.width / down), round(info.height / down)


def _lanczos(x: np.ndarray) -> np.ndarray:
    """PIL's lanczos_filter: sinc(x) * sinc(x / 3) on [-3, 3)."""
    def sinc(v):
        pv = np.pi * v
        return np.where(v == 0.0, 1.0, np.sin(pv) / np.where(v == 0.0, 1.0, pv))

    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _lanczos_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One of PIL's two resampling passes (Resample.c precompute_coeffs,
    normalize_coeffs_8bpc, ImagingResample{Horizontal,Vertical}_8bpc) of a
    uint8 (H, W, C) image along `axis` (1: width, 0: height)."""
    in_size = img.shape[axis]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    ss = 1.0 / filterscale
    w = _lanczos((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for c in range(ksize):          # PIL's order of the sum
        ww = ww + w[:, c]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    kk = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5)).astype(np.int32)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)   # PIL's INT32 sum
    for c in range(ksize):
        src = np.take(img, np.minimum(xmin + c, in_size - 1), axis=axis).astype(np.int32)
        acc += src * kk[:, c].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def lanczos_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's `Image.resize((width, height), LANCZOS)` of a uint8 (H, W, C)
    image: the horizontal pass, then the vertical one, each skipped where
    that side keeps its size, as PIL skips it."""
    if img.shape[1] != width:
        img = _lanczos_pass(img, 1, width)
    if img.shape[0] != height:
        img = _lanczos_pass(img, 0, height)
    return img


def _resize_image(img: np.ndarray, width: int, height: int) -> np.ndarray:
    if img.shape[1] == width and img.shape[0] == height:
        return img
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.asarray(lanczos_resize(u8, width, height), np.float32) / 255.0


def load_camera(
    info: CameraInfo,
    resolution: int = -1,
    resolution_scale: float = 1.0,
    trans: np.ndarray = np.zeros(3),
    scale: float = 1.0,
    white_background: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Camera:
    """CameraInfo -> Camera with image decode/rescale (upstream loadCam), its
    target image on `device` (CUDA unless named). The reference's `pad_to`
    (a static shape for batching under jit) has no caller and is not
    carried."""
    width, height = _scaled_resolution(info, resolution, resolution_scale)
    img = info.load_image()
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        bg = 1.0 if white_background else 0.0
        img = img[..., :3] * img[..., 3:4] + bg * (1 - img[..., 3:4])
    img = _resize_image(img, width, height)
    return make_camera(
        info.R,
        info.T,
        info.fovx,
        info.fovy,
        width,
        height,
        image=img,
        trans=trans,
        scale=scale,
        image_name=info.image_name,
        uid=info.uid,
        device=device,
    )


def camera_to_json(idx: int, info: CameraInfo) -> dict:
    """Upstream camera_to_JSON for `cameras.json` (viewer interop)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = info.R.T
    Rt[:3, 3] = info.T
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    pos = c2w[:3, 3]
    rot = c2w[:3, :3]
    return {
        "id": idx,
        "img_name": info.image_name,
        "width": info.width,
        "height": info.height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": fov2focal(info.fovy, info.height),
        "fx": fov2focal(info.fovx, info.width),
    }
