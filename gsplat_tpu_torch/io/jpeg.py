"""A JPEG decoder of the port's own: the counterpart of io/png.py for the
JPEG images of real captures, where the JAX package decodes with PIL (the
machine with the GPU has no Pillow).

`decode_jpeg` and `read_jpeg` return what `np.asarray(PIL.Image.open(path))`
returns for a baseline, extended-sequential or progressive Huffman JPEG of
8-bit samples: uint8 (H, W, 3) for a colour file, (H, W) for a grayscale
one, (H, W, 4) for CMYK and YCCK (PIL's CMYK, its channels inverted as
PIL's "CMYK;I" inverts them), the same bits as PIL on libjpeg-turbo (its
integer IDCT, fancy upsampling, table-driven colour conversion; EXIF
orientation is not applied). The decoder is C (csrc/jpeg_decode.c), built
with the host's C compiler at first use (_build.load_host). Lossless,
hierarchical and arithmetic-coded files, 12-bit samples (which PIL does not
open either), 2 components, sampling other than 4:4:4, 4:2:2, 4:2:0 and
4:4:0, a progressive file whose scans leave a coefficient incomplete (which
libjpeg would smooth) or break the progression's rules, and a truncated or
corrupt stream raise `JPEGError` with the file's name and the reason: no
image is made up.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Union

import numpy as np

from gsplat_tpu_torch import _build

_ERRLEN = 512


class JPEGError(ValueError):
    """A JPEG this decoder cannot decode, or a damaged one."""


def _lib() -> ctypes.CDLL:
    lib = _build.load_host("jpeg_decode")
    if not getattr(lib, "_typed", False):
        lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_header.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_decode.restype = ctypes.c_int
        lib._typed = True
    return lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3), (H, W, 4) or (H, W); `name` goes into
    errors."""
    lib = _lib()
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                       err, _ERRLEN):
        raise JPEGError(f"{name}: {err.value.decode(errors='replace')}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, dtype=np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, w.value, h.value, c.value,
                       err, _ERRLEN):
        raise JPEGError(f"{name}: {err.value.decode(errors='replace')}")
    return out


def read_jpeg(path: Union[str, Path]) -> np.ndarray:
    """Decode the JPEG file at `path` (decode_jpeg)."""
    return decode_jpeg(Path(path).read_bytes(), str(path))
