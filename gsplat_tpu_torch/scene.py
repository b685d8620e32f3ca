"""Scene: dataset + camera ownership + model-path bookkeeping.

Port of gsplat_tpu/scene.py: `Scene` reads a COLMAP or Blender source,
writes the viewer's `input.ply` and `cameras.json` into a fresh model
directory, shuffles, loads each camera at its resolution scales (target
images on `ModelParams.data_device`), and either loads a trained model
(`point_cloud/iteration_*/point_cloud.ply`, through `gaussians_from_raw`) or
initialises one from the source's point cloud (`create_from_pcd`). Images
predecode through the port's native IO runtime (csrc/io_runtime.c: a pool
of C worker threads, bilinear resize), as the JAX package's do through its
library; a camera the runtime cannot decode (a CMYK JPEG, say) decodes with
the port's own codecs in load_camera (LANCZOS resize), as the reference's
fall to PIL. Loaded models start at full SH degree, as upstream's load_ply
does.
"""

from __future__ import annotations

import json
import random
import re
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.config import ModelParams
from gsplat_tpu_torch.core.camera import (Camera, _scaled_resolution, camera_to_json,
                                          load_camera)
from gsplat_tpu_torch.core.gaussians import Gaussians, _pad_rows, create_from_pcd
from gsplat_tpu_torch.io import native_loader
from gsplat_tpu_torch.io.dataset import (SceneInfo, detect_scene_type,
                                         read_blender_scene_info, read_colmap_scene_info)
from gsplat_tpu_torch.io.ply import load_gaussian_ply


def search_for_max_iteration(folder: Union[str, Path]) -> Optional[int]:
    """Max <name>_<iter> suffix in a checkpoint dir (reference
    src/utils/system_utils.cpp:7-31)."""
    folder = Path(folder)
    if not folder.exists():
        return None
    best = None
    for p in folder.iterdir():
        m = re.search(r"_(\d+)$", p.name)
        if m:
            it = int(m.group(1))
            best = it if best is None else max(best, it)
    return best


def _is_main_process() -> bool:
    """No process group, or rank 0 of one (the JAX package's
    jax.process_index() == 0)."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class Scene:
    """Reference Scene (src/scene/scene.h:9-29), completed per upstream."""

    def __init__(
        self,
        model: ModelParams,
        capacity: int = 1 << 17,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        resolution_scales: List[float] = [1.0],
        seed: int = 0,
    ):
        self.model_path = model.model_path
        self.loaded_iter: Optional[int] = None
        device = resolve_device(model.data_device)

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    Path(self.model_path) / "point_cloud"
                )
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        scene_type = detect_scene_type(model.source_path)
        if scene_type == "colmap":
            # images load lazily: _predecode_images_native fills them through the
            # native runtime's worker pool (at target resolution);
            # load_camera decodes any camera left unfilled
            info: SceneInfo = read_colmap_scene_info(
                model.source_path, images=model.images, eval_split=model.eval,
                load_images=False,
            )
        else:
            info = read_blender_scene_info(
                model.source_path,
                white_background=model.white_background,
                eval_split=model.eval,
            )
        self.scene_info = info

        if not self.loaded_iter and self.model_path and _is_main_process():
            out = Path(self.model_path)
            out.mkdir(parents=True, exist_ok=True)
            # viewer interop artifacts (upstream Scene.__init__)
            (out / "input.ply").write_bytes(Path(info.ply_path).read_bytes())
            cams = info.train_cameras + info.test_cameras
            with open(out / "cameras.json", "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)

        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(info.train_cameras)
            rng.shuffle(info.test_cameras)

        self.cameras_extent = float(info.nerf_normalization["radius"])
        self.train_cameras: Dict[float, List[Camera]] = {}
        self.test_cameras: Dict[float, List[Camera]] = {}
        if len(resolution_scales) == 1:
            _predecode_images_native(
                info.train_cameras + info.test_cameras,
                model.resolution, resolution_scales[0], model.white_background,
            )
        for scale in resolution_scales:
            self.train_cameras[scale] = [
                load_camera(c, model.resolution, scale,
                            white_background=model.white_background, device=device)
                for c in info.train_cameras
            ]
            self.test_cameras[scale] = [
                load_camera(c, model.resolution, scale,
                            white_background=model.white_background, device=device)
                for c in info.test_cameras
            ]

        if self.loaded_iter:
            ply = (
                Path(self.model_path)
                / "point_cloud"
                / f"iteration_{self.loaded_iter}"
                / "point_cloud.ply"
            )
            raw = load_gaussian_ply(ply)
            if model.mip_splatting and "filter_3d" not in raw:
                raise ValueError(f"{ply} has no filter_3D column: not a Mip-Splatting model")
            self.gaussians = gaussians_from_raw(
                raw, capacity=capacity, sh_degree=model.sh_degree,
                spatial_lr_scale=self.cameras_extent, device=device,
            )
        else:
            self.gaussians = create_from_pcd(
                info.point_cloud.points,
                info.point_cloud.colors,
                capacity=max(capacity, _next_pow2(len(info.point_cloud.points))),
                max_sh_degree=model.sh_degree,
                spatial_lr_scale=self.cameras_extent,
                device=device,
            )

    def get_train_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.test_cameras[scale]


def _predecode_images_native(infos, resolution, resolution_scale, white_background):
    """Fill lazy CameraInfo.image slots via the native IO runtime: PNG/JPEG
    decode + bilinear resize to the target resolution + RGBA-over-bg compositing
    in a pool of 4 C worker threads (csrc/io_runtime.c), grouped by target size.
    Cameras it cannot decode (unsupported format, corrupt file) stay lazy and
    take the port's own decoders in load_camera. The runtime builds on first
    use, and a failed build raises; a caller that holds it off (available()
    False) gets each camera decoded by load_camera, said once."""
    if not native_loader.available():
        native_loader.say_fallback("each camera decodes on this thread through io/png.py "
                                   "or io/jpeg.py and resizes with the port's LANCZOS")
        return
    bg = (1.0, 1.0, 1.0) if white_background else (0.0, 0.0, 0.0)
    groups: Dict[tuple, list] = {}
    for c in infos:
        if c.image is not None or not c.image_path.lower().endswith(
            (".png", ".jpg", ".jpeg")
        ):
            continue
        groups.setdefault(_scaled_resolution(c, resolution, resolution_scale), []).append(c)
    for (w, h), cams in groups.items():
        loader = native_loader.PrefetchLoader(
            [c.image_path for c in cams], w, h, bg=bg, threads=4
        )
        try:
            loader.prefetch(list(range(len(cams))))
            for i, c in enumerate(cams):
                try:
                    c.image = loader.get(i)
                except IOError:
                    pass  # leave lazy -> the port's own decoders
        finally:
            loader.close()


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def gaussians_from_raw(
    raw: Dict[str, np.ndarray],
    capacity: int,
    sh_degree: int,
    spatial_lr_scale: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Gaussians:
    """raw PLY/checkpoint arrays -> Gaussians padded to max(capacity,
    next_pow2(n)) on `device` (CUDA unless named); a `filter_3d` array makes
    a Mip-Splatting model."""
    device = resolve_device(device)
    n = len(raw["xyz"])
    cap = max(capacity, _next_pow2(n))
    pad = _pad_rows(cap, device)
    zeros = torch.zeros(cap, dtype=torch.float32, device=device)
    filt = None
    if "filter_3d" in raw:
        filt = torch.zeros(cap, dtype=torch.float32, device=device)
        filt[:n] = torch.from_numpy(np.asarray(raw["filter_3d"], np.float32)).to(device)
    return Gaussians(
        xyz=pad("xyz", raw["xyz"]),
        f_dc=pad("f_dc", raw["features_dc"]),
        f_rest=pad("f_rest", raw["features_rest"]),
        opacity=pad("opacity", raw["opacity"]),
        scaling=pad("scaling", raw["scaling"]),
        rotation=pad("rotation", raw["rotation"]),
        max_radii2D=zeros,
        xyz_gradient_accum=zeros.clone(),
        denom=zeros.clone(),
        n_live=torch.tensor(n, dtype=torch.int32, device=device),
        active_sh_degree=sh_degree,
        max_sh_degree=sh_degree,
        spatial_lr_scale=float(spatial_lr_scale),
        filter_3d=filt,
    )
