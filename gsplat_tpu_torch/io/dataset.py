"""Dataset assembly: COLMAP and Blender (NeRF-synthetic) scene loading.

The port's own copy of gsplat_tpu/io/dataset.py: the same CameraInfo and
SceneInfo, readers, train/test split (llffhold 8) and NeRF++
normalisation. It decodes images without PIL, with the port's own codecs
on every machine: `.png` through io/png.py, `.jpg`/`.jpeg` through
io/jpeg.py (both give PIL's bits); any other file raises an error that
names the file.
"""

from __future__ import annotations

import os

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from gsplat_tpu_torch.core.transforms import focal2fov, fov2focal, get_world2view_2
from gsplat_tpu_torch.io import colmap, jpeg, png
from gsplat_tpu_torch.io.ply import BasicPointCloud, fetch_ply, store_ply


@dataclass
class CameraInfo:
    """Reference `CameraInfo` (src/scene/dataset_readers.h:5-29)."""

    uid: int
    R: np.ndarray          # (3,3) camera->world rotation (qvec2rotmat(q).T)
    T: np.ndarray          # (3,) world->camera translation
    fovx: float
    fovy: float
    image: Optional[np.ndarray]  # (H,W,3) float32 in [0,1], None if lazy
    image_path: str
    image_name: str
    width: int
    height: int

    def load_image(self) -> np.ndarray:
        if self.image is not None:
            return self.image
        return load_image_rgb(self.image_path)


@dataclass
class SceneInfo:
    """Upstream `SceneInfo` (commented out of the reference,
    src/scene/dataset_readers.cpp:198-219)."""

    point_cloud: BasicPointCloud
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: Dict[str, np.ndarray]
    ply_path: str


def load_image_rgb(path: str | Path) -> np.ndarray:
    """Decode an image to float32, PIL's array / 255 with the channels the
    file has: what the JAX package's PIL path gives. PNG (io/png.py): every
    bit depth and colour type, interlaced or not; (H,W) grayscale, (H,W,2)
    LA, (H,W,3) RGB, (H,W,4) RGBA (and 16-bit LA), which the camera later
    puts over its background; as PIL's array divides, a 16-bit grayscale
    file's values reach 257 and a 1-bit one's are 0 and 1/255. JPEG
    (io/jpeg.py): baseline, extended-sequential and progressive Huffman
    files, (H,W) grayscale, (H,W,3) colour, (H,W,4) CMYK and YCCK (which
    the camera treats as RGBA, as the JAX package does). Any other image
    type (TIFF, BMP, WebP, ...), and the PNG and JPEG kinds those modules
    refuse, raise an error that names the file."""
    name = str(path)
    if name.lower().endswith(".png"):
        arr = png.read_png(path)
    elif name.lower().endswith((".jpg", ".jpeg")):
        arr = jpeg.read_jpeg(path)
    else:
        raise ValueError(f"{name}: no decoder for this image type (PNG and JPEG only; not "
                         "TIFF, BMP, WebP or any other type PIL opens)")
    return np.asarray(arr, dtype=np.float32) / 255.0


def get_center_and_diag(cam_centers: np.ndarray):
    """Reference: src/scene/dataset_readers.cpp:101-120."""
    center = cam_centers.mean(axis=0)
    dists = np.linalg.norm(cam_centers - center, axis=1)
    return center, float(dists.max())


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> Dict[str, np.ndarray]:
    """NeRF++-style scene normalization: camera-center mean and 1.1x max distance.

    Reference: src/scene/dataset_readers.cpp:122-137 (whose result the reference then
    discards — SURVEY.md §2.1; upstream uses it for spatial_lr_scale, so we keep it).
    """
    centers = []
    for cam in cam_infos:
        w2c = get_world2view_2(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    center, diagonal = get_center_and_diag(np.stack(centers))
    radius = diagonal * 1.1
    return {"translate": -center, "radius": np.float64(radius)}


def read_colmap_cameras(
    cam_extrinsics: Dict[int, colmap.Image],
    cam_intrinsics: Dict[int, colmap.Camera],
    images_folder: str | Path,
    load_images: bool = True,
) -> List[CameraInfo]:
    """Per-image CameraInfo assembly. Reference: src/scene/dataset_readers.cpp:40-95.

    R = qvec2rotmat(qvec).T, T = tvec; FoV from focal for SIMPLE_PINHOLE/PINHOLE.
    """
    infos: List[CameraInfo] = []
    for key in sorted(cam_extrinsics):
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        height, width = intr.height, intr.width
        R = colmap.qvec2rotmat(extr.qvec).T
        T = np.asarray(extr.tvec, dtype=np.float64)
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = intr.params[0]
            fovx = focal2fov(focal_x, width)
            fovy = focal2fov(focal_x, height)
        elif intr.model == "PINHOLE":
            fovx = focal2fov(intr.params[0], width)
            fovy = focal2fov(intr.params[1], height)
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE) are supported"
            )
        image_path = str(Path(images_folder) / extr.name)
        image = load_image_rgb(image_path) if load_images else None
        infos.append(
            CameraInfo(
                uid=intr.id,
                R=R,
                T=T,
                fovx=fovx,
                fovy=fovy,
                image=image,
                image_path=image_path,
                image_name=Path(extr.name).stem,
                width=width,
                height=height,
            )
        )
    # reference sorts by image name (dataset_readers.cpp:165-167)
    infos.sort(key=lambda c: c.image_name)
    return infos


def split_train_test(
    cam_infos: List[CameraInfo], eval_split: bool, llffhold: int = 8
):
    """Every llffhold-th camera to test when eval. Reference:
    src/scene/dataset_readers.cpp:171-194."""
    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = list(cam_infos), []
    return train, test


def read_colmap_scene_info(
    path: str | Path,
    images: str = "images",
    eval_split: bool = False,
    llffhold: int = 8,
    load_images: bool = True,
) -> SceneInfo:
    """Reference `read_colmap_scene_info` (src/scene/dataset_readers.cpp:140-220),
    completed: binary readers with text fallback, points3D -> points3D.ply, SceneInfo."""
    path = Path(path)
    sparse = path / "sparse" / "0"
    try:
        cam_extrinsics = colmap.read_extrinsics_binary(sparse / "images.bin")
        cam_intrinsics = colmap.read_intrinsics_binary(sparse / "cameras.bin")
    except FileNotFoundError:
        cam_extrinsics = colmap.read_extrinsics_text(sparse / "images.txt")
        cam_intrinsics = colmap.read_intrinsics_text(sparse / "cameras.txt")

    images_folder = path / (images if images else "images")
    cam_infos = read_colmap_cameras(
        cam_extrinsics, cam_intrinsics, images_folder, load_images=load_images
    )
    train_cams, test_cams = split_train_test(cam_infos, eval_split, llffhold)
    norm = get_nerfpp_norm(train_cams)

    ply_path = sparse / "points3D.ply"
    if not ply_path.exists():
        try:
            xyz, rgb, _ = colmap.read_points3D_binary(sparse / "points3D.bin")
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3D_text(sparse / "points3D.txt")
        # the ranks of a mesh may convert at once: each writes its own file
        # and renames it into place, so no reader sees a partial one
        part = ply_path.with_name(f".{ply_path.name}.{os.getpid()}")
        store_ply(part, xyz, rgb)
        os.replace(part, ply_path)
    pcd = fetch_ply(ply_path)

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train_cams,
        test_cameras=test_cams,
        nerf_normalization=norm,
        ply_path=str(ply_path),
    )


def read_blender_cameras(
    path: Path, transforms_file: str, white_background: bool, extension: str = ".png"
) -> List[CameraInfo]:
    """NeRF-synthetic transforms_{train,test}.json loader (upstream
    readCamerasFromTransforms; empty body in the reference,
    src/scene/dataset_readers.cpp:223-229)."""
    with open(path / transforms_file) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    infos: List[CameraInfo] = []
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        if not file_path.endswith(extension):
            file_path = file_path + extension
        image_path = path / file_path
        # NeRF 'transform_matrix' is camera-to-world with OpenGL axes: flip y,z
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        arr = load_image_rgb(image_path)
        bg = np.array([1.0, 1.0, 1.0]) if white_background else np.array([0.0, 0.0, 0.0])
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        if arr.shape[-1] == 4:
            rgb, alpha = arr[..., :3], arr[..., 3:4]
            arr = rgb * alpha + bg * (1 - alpha)
        height, width = arr.shape[:2]
        fovy = focal2fov(fov2focal(fovx, width), height)
        infos.append(
            CameraInfo(
                uid=idx,
                R=R,
                T=T,
                fovx=fovx,
                fovy=fovy,
                image=arr.astype(np.float32),
                image_path=str(image_path),
                image_name=Path(file_path).stem,
                width=width,
                height=height,
            )
        )
    return infos


def read_blender_scene_info(
    path: str | Path,
    white_background: bool = False,
    eval_split: bool = False,
    extension: str = ".png",
    num_init_points: int = 100_000,
    seed: int = 0,
) -> SceneInfo:
    """Upstream readNerfSyntheticInfo (absent in the reference): Blender scenes with
    random point-cloud init inside [-1.3, 1.3]^3 when no PLY exists."""
    path = Path(path)
    train_cams = read_blender_cameras(path, "transforms_train.json", white_background, extension)
    test_path = path / "transforms_test.json"
    test_cams = (
        read_blender_cameras(path, "transforms_test.json", white_background, extension)
        if test_path.exists()
        else []
    )
    if not eval_split:
        train_cams = train_cams + test_cams
        test_cams = []
    norm = get_nerfpp_norm(train_cams)

    ply_path = path / "points3d.ply"
    if not ply_path.exists():
        rng = np.random.default_rng(seed)
        xyz = rng.random((num_init_points, 3)) * 2.6 - 1.3
        shs = rng.random((num_init_points, 3)) / 255.0
        store_ply(ply_path, xyz, (shs * 255.0).astype(np.uint8))
    pcd = fetch_ply(ply_path)
    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train_cams,
        test_cameras=test_cams,
        nerf_normalization=norm,
        ply_path=str(ply_path),
    )


def detect_scene_type(source_path: str | Path) -> str:
    """Reference loader dispatch (src/scene/scene.cpp:36-52, including the 'sparce'
    typo bug we do not reproduce): 'sparse' dir -> colmap; transforms_train.json ->
    blender."""
    p = Path(source_path)
    if (p / "sparse").exists():
        return "colmap"
    if (p / "transforms_train.json").exists():
        return "blender"
    raise ValueError(f"Could not recognize scene type for {source_path}")
