"""ctypes bindings for the port's native IO runtime (csrc/io_runtime.c).

The port's counterpart of gsplat_tpu/io/native_loader.py, with the same
Python API and the same results: COLMAP binary readers, a one-shot decode
(PNG and JPEG, bilinear resize to float32 RGB, RGBA composited over a
background) and `PrefetchLoader`, a pool of C worker threads that decodes
frames ahead of their use. The runtime is plain C with pthreads, built from
csrc/io_runtime.c and csrc/jpeg_decode.c by _build.py's host route on first
use into build/host/; `available()` is True once it has loaded, and a
failed build raises with the compiler's output (`build_error` keeps it).
Scene's predecode takes this path (scene.py::_predecode_images_native);
`say_fallback` reports a caller that holds the runtime off.

The plain version (`decode_image_plain`, numpy): the same decode from the
port's Python codecs (libpng's chunk rules and transforms over io/png.py's
unfiltered samples, io/jpeg.py for JPEG) and `resize_to_float_plain`, the
runtime's float32 expression one rounding an operation. The tests and
chip_smoke.py hold the runtime to it; nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gsplat_tpu_torch import _build
from gsplat_tpu_torch.io import jpeg, png

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


# the compiler's output, once a build of the runtime has failed
build_error: Optional[str] = None
_fallback_said = False
_P = ctypes.c_void_p


def say_fallback(instead: str) -> None:
    """Print, once a process, that the runtime is not in use, why, and what
    the caller does instead."""
    global _fallback_said
    if not _fallback_said:
        _fallback_said = True
        print(f"native IO library unavailable ({build_error or 'held off'}); {instead}",
              flush=True)


def get_lib() -> ctypes.CDLL:
    """The loaded runtime, built first if needed; raises RuntimeError with
    the compiler's output if the build fails."""
    global build_error
    try:
        lib = _build.load_host("io_runtime")
    except RuntimeError as e:
        build_error = str(e)
        raise
    if not getattr(lib, "_io_typed", False):
        c_int, c_char_p = ctypes.c_int, ctypes.c_char_p
        for fn, args, res in (
                ("colmap_read_cameras_bin", [c_char_p, _P, c_int], c_int),
                ("colmap_read_images_bin", [c_char_p, _P, c_int], c_int),
                ("colmap_read_points3d_bin", [c_char_p, _P, _P, _P, ctypes.c_int64],
                 ctypes.c_int64),
                ("decode_image_f32", [c_char_p, c_int, c_int, _P, _P], c_int),
                ("image_size", [c_char_p, ctypes.POINTER(c_int), ctypes.POINTER(c_int)],
                 c_int),
                ("io_inflate", [c_char_p, ctypes.c_size_t, _P, ctypes.c_size_t],
                 ctypes.c_int64),
                ("loader_create", [ctypes.POINTER(c_char_p), c_int, c_int, c_int, _P, c_int],
                 _P),
                ("loader_prefetch", [_P, _P, c_int], c_int),
                ("loader_get", [_P, c_int, _P], c_int),
                ("loader_destroy", [_P], None)):
            f = getattr(lib, fn)
            f.argtypes, f.restype = args, res
        lib._io_typed = True
    return lib


def available() -> bool:
    """True once the runtime has loaded (a failed build raises)."""
    get_lib()
    return True


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------------------
# COLMAP readers (drop-in for io.colmap's binary readers)
# ---------------------------------------------------------------------------

def read_cameras_bin(path: str | Path):
    """-> {camera_id: (model_name, width, height, params ndarray)}"""
    lib = get_lib()
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
    n = lib.colmap_read_points3d_bin(str(path).encode(), None, None, None, 0)
    if n < 0:
        raise FileNotFoundError(path)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    if lib.colmap_read_points3d_bin(str(path).encode(), _ptr(xyz), _ptr(rgb), _ptr(err),
                                    n) != n:
        raise IOError(f"{path}: truncated or corrupt points3D.bin")
    return xyz, rgb, err


# ---------------------------------------------------------------------------
# Image decode + prefetching loader
# ---------------------------------------------------------------------------

def decode_image(path: str | Path, width: int, height: int,
                 bg=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Decode+bilinear-resize to float32 RGB (height, width, 3) in [0,1];
    RGBA composited over `bg`."""
    lib = get_lib()
    out = np.empty((height, width, 3), np.float32)
    bg_arr = np.asarray(bg, np.float32)
    if lib.decode_image_f32(str(path).encode(), width, height, _ptr(bg_arr), _ptr(out)) != 0:
        raise IOError(f"native decode failed for {path}")
    return out


def image_size(path: str | Path) -> Tuple[int, int]:
    """(width, height) of the image file at `path` (a full decode)."""
    lib = get_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.image_size(str(path).encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"native decode failed for {path}")
    return w.value, h.value


def inflate(data: bytes, max_size: int) -> bytes:
    """The runtime's inflate of a whole zlib stream (at most `max_size`
    bytes out); ValueError if it is damaged, truncated or longer."""
    out = np.empty(max(max_size, 1), np.uint8)
    n = get_lib().io_inflate(data, len(data), _ptr(out), max_size)
    if n < 0:
        raise ValueError("damaged, truncated or too long zlib stream")
    return out[:n].tobytes()


class PrefetchLoader:
    """Background worker pool decoding frames ahead of the training loop."""

    def __init__(self, paths: List[str], width: int, height: int,
                 bg=(0.0, 0.0, 0.0), threads: int = 4):
        lib = get_lib()
        self._lib = lib
        self.width, self.height = width, height
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        bg_arr = np.asarray(bg, np.float32)
        self._handle = lib.loader_create(arr, len(self._paths), width, height, _ptr(bg_arr),
                                         threads)
        if not self._handle:
            raise MemoryError("the native loader could not start its workers")

    def _index(self, idx: int) -> int:
        if not 0 <= idx < len(self._paths):
            raise IndexError(f"frame {idx} of {len(self._paths)}")
        return idx

    def prefetch(self, indices: Sequence[int]) -> None:
        arr = np.asarray([self._index(int(i)) for i in indices], np.int32)
        if self._lib.loader_prefetch(self._handle, _ptr(arr), len(arr)) != 0:
            raise MemoryError("the native loader's queue could not grow")

    def get(self, idx: int) -> np.ndarray:
        out = np.empty((self.height, self.width, 3), np.float32)
        if self._lib.loader_get(self._handle, self._index(idx), _ptr(out)) != 0:
            raise IOError(f"native loader_get({idx}) failed")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# The plain version: numpy over the port's own codecs
# ---------------------------------------------------------------------------

def _png_rgb_plain(data: bytes, name: str) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3) RGB or (H, W, 4) RGBA as libpng reads
    them with the runtime's transforms (csrc/io_runtime.c's comment: the
    chunk rules, then io/png.py's unfiltered samples expanded, keyed and
    stripped to 8 bits); IOError where the runtime fails."""
    def refuse(why: str):
        raise IOError(f"{name}: {why}")

    if data[:8] != png.SIGNATURE:
        refuse("not a PNG file")
    at, size = 8, len(data)
    header = None
    palette = np.zeros((256, 3), np.uint8)
    trans_alpha = np.full(256, 255, np.uint8)
    have_plte, num_palette, trns_valid, num_trans, key = False, 0, False, 0, [0, 0, 0]
    while True:                                   # the chunks before the first IDAT
        if size - at < 8:
            refuse("truncated before its image data")
        length, kind = struct.unpack_from(">I4s", data, at)
        if length > 0x7FFFFFFF or not kind.isalpha():
            refuse(f"invalid chunk {kind!r}")
        if kind == b"IDAT":
            if header is None or (header[3] == 3 and not have_plte):
                refuse("image data before its IHDR or PLTE")
            break
        if size - at - 8 < length + 4:
            refuse(f"truncated {kind!r} chunk")
        body = data[at + 8:at + 8 + length]
        crc_ok = zlib.crc32(kind + body) == struct.unpack_from(">I", data, at + 8 + length)[0]
        critical = not kind[0] & 32
        at += 12 + length
        if critical and not crc_ok:
            refuse(f"bad CRC in its {kind!r} chunk")
        if kind == b"IHDR":
            if header is not None or length != 13:
                refuse("invalid IHDR")
            header = struct.unpack(">IIBBBBB", body)
            width, height, depth, ctype, comp, filt, interlace = header
            if ctype not in png.COLOR_TYPES or depth not in png.COLOR_TYPES[ctype][2] \
                    or not 0 < width <= 10 ** 6 or not 0 < height <= 10 ** 6 \
                    or comp or filt or interlace > 1:
                refuse(f"invalid IHDR {header}")
        elif header is None:
            refuse(f"{kind!r} before IHDR")
        elif kind == b"IEND":
            refuse("no image data")
        elif kind == b"PLTE":
            if have_plte:
                refuse("a second PLTE")
            have_plte = True
            if not ctype & 2:
                continue                          # ignored in a gray image
            if length > 768 or length % 3:
                if ctype == 3:
                    refuse("invalid PLTE")
                continue
            num = length // 3 if ctype != 3 else min(length // 3, 1 << depth)
            if num == 0:
                refuse("empty PLTE")
            palette[:num] = np.frombuffer(body, np.uint8, 3 * num).reshape(num, 3)
            num_palette = num
            if trns_valid:
                num_trans = 0                     # a tRNS must follow the PLTE
        elif kind == b"tRNS":
            if trns_valid or not crc_ok:
                continue
            if ctype == 0 and length == 2:
                key[0], num_trans = struct.unpack(">H", body)[0], 1
            elif ctype == 2 and length == 6:
                key, num_trans = list(struct.unpack(">3H", body)), 1
            elif ctype == 3 and have_plte and 0 < length <= num_palette:
                trans_alpha[:length] = np.frombuffer(body, np.uint8)
                num_trans = length
            else:
                continue                          # invalid, misplaced, or alpha
            trns_valid = True
        elif critical:
            refuse(f"unknown critical chunk {kind!r}")
    # the zlib stream through the IDAT chunks, each read (and its CRC
    # checked) only when the stream needs it
    channels = png.COLOR_TYPES[ctype][0]
    passes = png.ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(width - x0) // dx) if width > x0 else 0,
              -(-(height - y0) // dy) if height > y0 else 0) for x0, y0, dx, dy in passes]
    strides = [(pw * channels * depth + 7) // 8 for pw, _ in sizes]
    want = sum(ph * (st + 1) for (pw, ph), st in zip(sizes, strides) if pw and ph)
    dec, raw = zlib.decompressobj(), []
    while not dec.eof:
        if size - at < 8:
            refuse("zlib stream truncated")
        length, kind = struct.unpack_from(">I4s", data, at)
        if length > 0x7FFFFFFF or kind != b"IDAT" or size - at - 8 < length + 4:
            refuse("zlib stream truncated")
        body = data[at + 8:at + 8 + length]
        if zlib.crc32(kind + body) != struct.unpack_from(">I", data, at + 8 + length)[0]:
            refuse("bad CRC in an IDAT chunk")
        at += 12 + length
        try:
            raw.append(dec.decompress(body))
        except zlib.error as e:
            refuse(f"bad zlib stream ({e})")
    raw = b"".join(raw)
    if len(raw) < want:
        refuse(f"{len(raw)} bytes of image data (want {want})")
    samples = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    unit, off = max(channels * depth // 8, 1), 0
    for (x0, y0, dx, dy), (pw, ph), stride in zip(passes, sizes, strides):
        if not pw or not ph:
            continue
        rows = np.frombuffer(raw, np.uint8, ph * (stride + 1), off).reshape(ph, stride + 1)
        off += ph * (stride + 1)
        if (rows[:, 0] > png.PAETH).any():
            refuse("unknown row filter type")
        samples[y0::dy, x0::dx] = png._samples(
            png._unfilter(rows[:, 0], rows[:, 1:], stride // unit, unit), pw, channels, depth)
    # libpng's transforms: the key at the file's depth, masked to it
    mask = 0xFFFF if depth == 16 else (1 << depth) - 1
    key = [k & mask for k in key]
    v = samples.astype(np.int64)
    eight = (v >> 8) if depth == 16 else v
    if ctype == 3:
        rgb = palette[v[..., 0]]
        alpha = np.where(v[..., 0] < num_trans, trans_alpha[v[..., 0]], 255)
    elif ctype == 0:
        g = eight[..., 0] if depth >= 8 else v[..., 0] * (255 // mask)
        rgb = np.repeat(g[..., None], 3, axis=2)
        alpha = np.where(v[..., 0] == key[0], 0, 255)
    elif ctype == 2:
        rgb = eight
        alpha = np.where((v == np.asarray(key)).all(axis=2), 0, 255)
    else:
        rgb = np.repeat(eight[..., :1], 3, axis=2) if ctype == 4 else eight[..., :3]
        alpha = eight[..., -1]
    if ctype in (4, 6) or num_trans > 0:
        return np.concatenate([rgb, alpha[..., None]], axis=2).astype(np.uint8)
    return rgb.astype(np.uint8)


def decode_rgb_plain(path: str | Path) -> np.ndarray:
    """The runtime's decode, before the resize: uint8 (H, W, 3) or (H, W,
    4); PNG or JPEG by the suffix (any case), by the first bytes only
    where it is neither; IOError where the runtime fails (a CMYK or YCCK
    JPEG too: libjpeg does not convert them to RGB)."""
    name = str(path)
    low = name.lower()
    data = Path(path).read_bytes()
    if low.endswith(".png"):
        kind = "png"
    elif low.endswith((".jpg", ".jpeg")):
        kind = "jpeg"
    elif len(data) >= 4 and data[0] == 0x89 and data[1:2] == b"P":
        kind = "png"
    elif data[:2] == b"\xff\xd8":
        kind = "jpeg"
    else:
        raise IOError(f"{name}: neither a PNG nor a JPEG file")
    if kind == "png":
        return _png_rgb_plain(data, name)
    try:
        arr = jpeg.decode_jpeg(data, name)
    except jpeg.JPEGError as e:
        raise IOError(str(e)) from e
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, axis=2)
    if arr.shape[2] != 3:
        raise IOError(f"{name}: a CMYK or YCCK JPEG has no RGB decode")
    return arr


def resize_to_float_plain(img: np.ndarray, width: int, height: int,
                          bg=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The runtime's resize_to_float in float32 numpy, its expression in its
    order, one rounding an operation: uint8 (H, W, 3 or 4) -> float32
    (height, width, 3), RGBA composited over `bg`."""
    f32 = np.float32
    one, half = f32(1.0), f32(0.5)

    def axis(n_in, n_out):
        s = f32(n_in) / f32(n_out)
        f = (np.arange(n_out, dtype=f32) + half) * s - half
        i0 = np.where(f < 0, 0, f.astype(np.int64))
        i1 = np.where(i0 + 1 < n_in, i0 + 1, n_in - 1)
        w = f - i0.astype(f32)
        return i0, i1, np.where(w < 0, f32(0.0), w)

    y0, y1, wy = axis(img.shape[0], height)
    x0, x1, wx = axis(img.shape[1], width)
    v = img.astype(f32)
    wx, wy = wx[None, :, None], wy[:, None, None]
    ox, oy = one - wx, one - wy

    def lerp_x(rows):                     # v0 * (1 - wx) + v1 * wx, in place
        out = rows[:, x0]
        out *= ox
        right = rows[:, x1]
        right *= wx
        out += right
        return out

    px = lerp_x(v[y0])
    px *= oy
    bottom = lerp_x(v[y1])
    bottom *= wy
    px += bottom
    px /= f32(255.0)
    if img.shape[2] == 4:
        a = px[..., 3:]
        return px[..., :3] * a + np.asarray(bg, f32) * (one - a)
    return px


def decode_image_plain(path: str | Path, width: int, height: int,
                       bg=(0.0, 0.0, 0.0)) -> np.ndarray:
    """decode_image's plain version: decode_rgb_plain, then
    resize_to_float_plain."""
    return resize_to_float_plain(decode_rgb_plain(path), width, height, bg)
