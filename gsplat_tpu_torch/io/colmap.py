"""COLMAP sparse-reconstruction readers and writers (binary and text).

The port's own copy of gsplat_tpu/io/colmap.py (it imports neither PIL nor
jax, but the port imports nothing of the JAX package): cameras.bin /
images.bin / points3D.bin and their text forms, `qvec2rotmat`,
`rotmat2qvec` and the 11-entry camera-model table, with the same outputs.
The points3D reader and writer are vectorised where the reference loops in
Python once a point (gsplat_tpu/io/colmap.py:182-187, :289-295): a real
scene's sparse cloud holds 10^5-10^6 points. They read and write the same
bytes and arrays.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class CameraModel:
    model_id: int
    model_name: str
    num_params: int


# Reference CAMERA_MODELS table: src/scene/colmap_loader.cpp:194-206 (== COLMAP's).
CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


@dataclass
class Image:
    """Reference `colmap::Image` (src/scene/colmap_loader.h:10-33)."""

    id: int = -1
    qvec: np.ndarray = field(default_factory=lambda: np.zeros(4))
    tvec: np.ndarray = field(default_factory=lambda: np.zeros(3))
    camera_id: int = -1
    name: str = ""
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))


@dataclass
class Camera:
    """Reference `colmap::Camera` (src/scene/colmap_loader.h:35-50)."""

    id: int = -1
    model: str = ""
    width: int = 0
    height: int = 0
    params: np.ndarray = field(default_factory=lambda: np.zeros(0))


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """Quaternion [w,x,y,z] -> 3x3 rotation. Reference colmap_loader.cpp:265-279."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation -> quaternion [w,x,y,z] (COLMAP's convention; for writers/tests)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# ---------------------------------------------------------------------------
# binary readers
# ---------------------------------------------------------------------------


def read_extrinsics_binary(path: str | Path) -> Dict[int, Image]:
    """images.bin. Reference: src/scene/colmap_loader.cpp:120-170."""
    data = Path(path).read_bytes()
    images: Dict[int, Image] = {}
    (num_images,) = struct.unpack_from("<Q", data, 0)
    off = 8
    for _ in range(num_images):
        image_id = struct.unpack_from("<i", data, off)[0]
        props = np.frombuffer(data, dtype="<f8", count=7, offset=off + 4)
        camera_id = struct.unpack_from("<i", data, off + 60)[0]
        off += 64
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8")
        off = end + 1
        (num_pts,) = struct.unpack_from("<Q", data, off)
        off += 8
        rec = np.frombuffer(data, dtype="<f8", count=3 * num_pts, offset=off).reshape(
            num_pts, 3
        )
        xys = rec[:, :2].copy()
        point3D_ids = rec[:, 2].view("<i8").copy()
        off += 24 * num_pts
        images[image_id] = Image(
            id=image_id,
            qvec=props[:4].copy(),
            tvec=props[4:7].copy(),
            camera_id=camera_id,
            name=name,
            xys=xys,
            point3D_ids=point3D_ids,
        )
    return images


def read_intrinsics_binary(path: str | Path) -> Dict[int, Camera]:
    """cameras.bin. Reference: src/scene/colmap_loader.cpp:222-249."""
    data = Path(path).read_bytes()
    cameras: Dict[int, Camera] = {}
    (num_cameras,) = struct.unpack_from("<Q", data, 0)
    off = 8
    for _ in range(num_cameras):
        camera_id, model_id = struct.unpack_from("<ii", data, off)
        width, height = struct.unpack_from("<QQ", data, off + 8)
        off += 24
        model = CAMERA_MODEL_IDS[model_id]
        params = np.frombuffer(data, dtype="<f8", count=model.num_params, offset=off)
        off += 8 * model.num_params
        cameras[camera_id] = Camera(
            id=camera_id,
            model=model.model_name,
            width=int(width),
            height=int(height),
            params=params.copy(),
        )
    return cameras


# a points3D.bin record with an empty track (the writer's)
_POINT_RECORD = np.dtype([("id", "<i8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
                          ("error", "<f8"), ("track_len", "<u8")])


def read_points3D_binary(path: str | Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """points3D.bin -> (xyz (N,3) f64, rgb (N,3) u8, error (N,) f64).

    COLMAP's format: id i64, xyz 3*f64, rgb 3*u8, error f64, track_len u64,
    track 8B*len. A record's offset depends on the tracks before it, so only
    the track lengths are read in a loop; the fields are then gathered at once.
    """
    data = Path(path).read_bytes()
    (num_points,) = struct.unpack_from("<Q", data, 0)
    offs = np.empty(num_points, dtype=np.int64)
    off = 8
    for i in range(num_points):
        offs[i] = off
        (track_len,) = struct.unpack_from("<Q", data, off + 43)
        off += 51 + 8 * track_len
    buf = np.frombuffer(data, dtype=np.uint8)

    def field(at: int, nbytes: int) -> np.ndarray:
        return buf[offs[:, None] + at + np.arange(nbytes)]

    xyz = field(8, 24).view("<f8").astype(np.float64)
    rgb = field(32, 3)
    err = field(35, 8).view("<f8")[:, 0].astype(np.float64)
    return xyz, rgb, err


# ---------------------------------------------------------------------------
# text readers (reference stubs: colmap_loader.cpp:172-183,251-262)
# ---------------------------------------------------------------------------


def _data_lines(path: str | Path) -> List[str]:
    return [
        ln.strip()
        for ln in Path(path).read_text().splitlines()
        if ln.strip() and not ln.strip().startswith("#")
    ]


def read_extrinsics_text(path: str | Path) -> Dict[int, Image]:
    lines = _data_lines(path)
    images: Dict[int, Image] = {}
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        image_id = int(elems[0])
        qvec = np.array(elems[1:5], dtype=np.float64)
        tvec = np.array(elems[5:8], dtype=np.float64)
        camera_id = int(elems[8])
        name = elems[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array(pts, dtype=np.float64).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[image_id] = Image(
            id=image_id,
            qvec=qvec,
            tvec=tvec,
            camera_id=camera_id,
            name=name,
            xys=arr[:, :2].copy(),
            point3D_ids=arr[:, 2].astype(np.int64),
        )
    return images


def read_intrinsics_text(path: str | Path) -> Dict[int, Camera]:
    cameras: Dict[int, Camera] = {}
    for ln in _data_lines(path):
        elems = ln.split()
        camera_id = int(elems[0])
        model = elems[1]
        cameras[camera_id] = Camera(
            id=camera_id,
            model=model,
            width=int(elems[2]),
            height=int(elems[3]),
            params=np.array(elems[4:], dtype=np.float64),
        )
    return cameras


def read_points3D_text(path: str | Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rows = [ln.split() for ln in _data_lines(path)]
    if not rows:
        z = np.zeros((0, 3))
        return z, z.astype(np.uint8), np.zeros(0)
    xyz = np.array([r[1:4] for r in rows], dtype=np.float64)
    rgb = np.array([r[4:7] for r in rows], dtype=np.float64).astype(np.uint8)
    err = np.array([r[7] for r in rows], dtype=np.float64)
    return xyz, rgb, err


# ---------------------------------------------------------------------------
# binary writers (for hermetic test fixtures; the reference has none)
# ---------------------------------------------------------------------------


def write_extrinsics_binary(images: Dict[int, Image], path: str | Path) -> None:
    buf = bytearray(struct.pack("<Q", len(images)))
    for img in images.values():
        buf += struct.pack("<i", img.id)
        buf += np.concatenate([img.qvec, img.tvec]).astype("<f8").tobytes()
        buf += struct.pack("<i", img.camera_id)
        buf += img.name.encode("utf-8") + b"\x00"
        n = len(img.point3D_ids)
        buf += struct.pack("<Q", n)
        rec = np.empty((n, 3), dtype="<f8")
        rec[:, :2] = img.xys
        rec[:, 2] = img.point3D_ids.astype("<i8").view("<f8")
        buf += rec.tobytes()
    Path(path).write_bytes(bytes(buf))


def write_intrinsics_binary(cameras: Dict[int, Camera], path: str | Path) -> None:
    buf = bytearray(struct.pack("<Q", len(cameras)))
    for cam in cameras.values():
        model = CAMERA_MODEL_NAMES[cam.model]
        buf += struct.pack("<iiQQ", cam.id, model.model_id, cam.width, cam.height)
        buf += np.asarray(cam.params, dtype="<f8").tobytes()
    Path(path).write_bytes(bytes(buf))


def write_points3D_binary(
    xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray, path: str | Path
) -> None:
    """Records with ids 0..N-1 and empty tracks."""
    n = len(xyz)
    rec = np.zeros(n, dtype=_POINT_RECORD)
    rec["id"] = np.arange(n)
    rec["xyz"] = np.asarray(xyz, dtype="<f8").reshape(n, 3)
    rec["rgb"] = np.asarray(rgb, dtype=np.uint8).reshape(n, 3)
    rec["error"] = np.asarray(err, dtype="<f8").reshape(n)
    Path(path).write_bytes(struct.pack("<Q", n) + rec.tobytes())
