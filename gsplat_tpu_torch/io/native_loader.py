"""ctypes bindings for the native IO runtime (native/libgsplat_io.so).

The port's own copy of gsplat_tpu/io/native_loader.py: the same library,
built from the repo's native/ by `make -C native` on first use, with the
same COLMAP readers, one-shot decode and prefetching loader (a C worker
pool that decodes with libjpeg/libpng and resizes bilinearly). Where the
library neither exists nor builds (a machine without the libjpeg or libpng
headers), `available()` is False and `build_error` says why; the callers
then take the pure-Python paths, and report it.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libgsplat_io.so"
_lib = None

CAMERA_MODEL_NAMES = {
    0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL", 3: "RADIAL",
    4: "OPENCV", 5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
    8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE", 10: "THIN_PRISM_FISHEYE",
}


class _CCamera(ctypes.Structure):
    _fields_ = [
        ("camera_id", ctypes.c_int32),
        ("model_id", ctypes.c_int32),
        ("width", ctypes.c_uint64),
        ("height", ctypes.c_uint64),
        ("params", ctypes.c_double * 12),
        ("num_params", ctypes.c_int32),
    ]


class _CImageMeta(ctypes.Structure):
    _fields_ = [
        ("image_id", ctypes.c_int32),
        ("qvec", ctypes.c_double * 4),
        ("tvec", ctypes.c_double * 3),
        ("camera_id", ctypes.c_int32),
        ("name", ctypes.c_char * 256),
        ("num_points2d", ctypes.c_uint64),
    ]


# why the library is missing, once a build was tried and failed
build_error: Optional[str] = None
_fallback_said = False


def say_fallback(instead: str) -> None:
    """Print, once a process, that the library is missing, why, and what the
    caller does instead."""
    global _fallback_said
    if not _fallback_said:
        _fallback_said = True
        print(f"native IO library unavailable ({build_error}); {instead}", flush=True)


def _build() -> bool:
    global build_error
    try:
        subprocess.run(
            ["make", "-C", str(_LIB_PATH.parent)], check=True,
            capture_output=True, text=True, timeout=120,
        )
    except subprocess.CalledProcessError as e:
        build_error = f"make -C native failed: {(e.stderr or e.stdout).strip()[-2000:]}"
        return False
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"make -C native could not run: {e}"
        return False
    if not _LIB_PATH.exists():
        build_error = f"make -C native made no {_LIB_PATH.name}"
        return False
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building on demand, once) the native library; None if unavailable."""
    global _lib, build_error
    if _lib is not None:
        return _lib
    if build_error is not None:
        return None
    if not _LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:  # built on another machine: its libjpeg/libpng are missing here
        build_error = f"{_LIB_PATH.name} does not load: {e}"
        return None
    lib.colmap_read_cameras_bin.restype = ctypes.c_int
    lib.colmap_read_images_bin.restype = ctypes.c_int
    lib.colmap_read_points3d_bin.restype = ctypes.c_int64
    lib.decode_image_f32.restype = ctypes.c_int
    lib.image_size.restype = ctypes.c_int
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_get.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# COLMAP readers (drop-in for io.colmap binary readers)
# ---------------------------------------------------------------------------

def read_cameras_bin(path: str | Path):
    """-> {camera_id: (model_name, width, height, params ndarray)}"""
    lib = get_lib()
    assert lib is not None
    n = lib.colmap_read_cameras_bin(str(path).encode(), None, 0)
    if n < 0:
        raise FileNotFoundError(path)
    buf = (_CCamera * n)()
    lib.colmap_read_cameras_bin(str(path).encode(), buf, n)
    out = {}
    for c in buf:
        out[c.camera_id] = (
            CAMERA_MODEL_NAMES.get(c.model_id, f"UNKNOWN_{c.model_id}"),
            int(c.width), int(c.height),
            np.array(c.params[: c.num_params], dtype=np.float64),
        )
    return out


def read_images_bin(path: str | Path):
    """-> {image_id: (qvec(4,), tvec(3,), camera_id, name)}"""
    lib = get_lib()
    assert lib is not None
    n = lib.colmap_read_images_bin(str(path).encode(), None, 0)
    if n < 0:
        raise FileNotFoundError(path)
    buf = (_CImageMeta * n)()
    lib.colmap_read_images_bin(str(path).encode(), buf, n)
    out = {}
    for m in buf:
        out[m.image_id] = (
            np.array(m.qvec, dtype=np.float64),
            np.array(m.tvec, dtype=np.float64),
            int(m.camera_id),
            m.name.decode(),
        )
    return out


def read_points3d_bin(path: str | Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (xyz (n,3) f64, rgb (n,3) u8, error (n,) f64)"""
    lib = get_lib()
    assert lib is not None
    n = lib.colmap_read_points3d_bin(str(path).encode(), None, None, None, 0)
    if n < 0:
        raise FileNotFoundError(path)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    lib.colmap_read_points3d_bin(
        str(path).encode(),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
    )
    return xyz, rgb, err


# ---------------------------------------------------------------------------
# Image decode + prefetching loader
# ---------------------------------------------------------------------------

def decode_image(path: str | Path, width: int, height: int,
                 bg=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Decode+bilinear-resize to float32 RGB (height, width, 3) in [0,1];
    RGBA composited over `bg`."""
    lib = get_lib()
    assert lib is not None
    out = np.empty((height, width, 3), np.float32)
    bg_arr = np.asarray(bg, np.float32)
    rc = lib.decode_image_f32(
        str(path).encode(), width, height,
        bg_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise IOError(f"native decode failed for {path}")
    return out


def image_size(path: str | Path) -> Tuple[int, int]:
    """(width, height) of the image file at `path` (a full decode)."""
    lib = get_lib()
    assert lib is not None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.image_size(str(path).encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"native decode failed for {path}")
    return w.value, h.value


class PrefetchLoader:
    """Background worker pool decoding frames ahead of the training loop."""

    def __init__(self, paths: List[str], width: int, height: int,
                 bg=(0.0, 0.0, 0.0), threads: int = 4):
        lib = get_lib()
        assert lib is not None
        self._lib = lib
        self.width, self.height = width, height
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        bg_arr = np.asarray(bg, np.float32)
        self._handle = lib.loader_create(
            arr, len(self._paths), width, height,
            bg_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads,
        )

    def prefetch(self, indices: List[int]) -> None:
        arr = np.asarray(indices, np.int32)
        self._lib.loader_prefetch(
            ctypes.c_void_p(self._handle),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr),
        )

    def get(self, idx: int) -> np.ndarray:
        out = np.empty((self.height, self.width, 3), np.float32)
        rc = self._lib.loader_get(
            ctypes.c_void_p(self._handle), idx,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise IOError(f"native loader_get({idx}) failed")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(ctypes.c_void_p(self._handle))
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
