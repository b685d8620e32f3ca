"""A PNG codec with zlib and struct only: the port's image path where the
JAX package uses PIL (the machine with the GPU has no Pillow).

`read_png` returns what `np.asarray(PIL.Image.open(path))` returns for a
non-interlaced PNG of 8 bits a sample: uint8 (H, W) for grayscale (L) and
for palette images (P: the palette indices, as PIL gives them; palettes of
1, 2 and 4 bits too), (H, W, 2) for LA, (H, W, 3) for RGB, (H, W, 4) for
RGBA. A tRNS chunk leaves the channels as they are, as PIL leaves them.
Any other bit depth (grayscale of 1, 2 or 4 bits, 16 bits), an
Adam7-interlaced file, a bad chunk CRC, a truncated file or a bad zlib
stream raises `PNGError` with the file's name and the kind: no image is
made up.

`write_png` encodes an 8-bit RGB image; each row's filter type is chosen by
the caller (Up by default). Decoding a file written here, by PIL or by
anything else gives the same pixels: equal bytes are not the contract.

Unfiltering. None, Sub and Up need nothing from a row's own decoded left
neighbour beyond a running sum, so an image that uses only those decodes in
a few whole-array steps (Sub a cumsum mod 256 along the row, Up a cumsum
down each run of Up rows). Average and Paeth take the decoded left
neighbour: byte (r, j) depends on (r, j-1), (r-1, j) and (r-1, j-1) only,
so an image that uses them decodes along anti-diagonals r + j = k, each a
strided view of the padded image, in H + W - 1 numpy steps.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, the kind as an error message names it)
COLOR_TYPES = {0: (1, "grayscale (L)"), 2: (3, "RGB"), 3: (1, "palette (P)"),
               4: (2, "grayscale with alpha (LA)"), 6: (4, "RGBA")}
NONE, SUB, UP, AVERAGE, PAETH = range(5)


class PNGError(ValueError):
    """A PNG this codec cannot decode, or a damaged one."""


def _chunks(data: bytes, name: str):
    if not data.startswith(SIGNATURE):
        raise PNGError(f"{name}: not a PNG file (bad signature)")
    off = len(SIGNATURE)
    while off + 12 <= len(data):
        (length,) = struct.unpack_from(">I", data, off)
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + length]
        if len(body) != length or off + 12 + length > len(data):
            raise PNGError(f"{name}: truncated {kind!r} chunk")
        (crc,) = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise PNGError(f"{name}: bad CRC in its {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        off += 12 + length
    raise PNGError(f"{name}: truncated (no IEND chunk)")


def _paeth(left: np.ndarray, up: np.ndarray, ul: np.ndarray) -> np.ndarray:
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    return np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))


def _unfilter(ftype: np.ndarray, filt: np.ndarray, width: int, bpp: int) -> np.ndarray:
    """Row filter types (H,) and filtered rows (H, width * bpp) uint8 ->
    the decoded rows."""
    height = filt.shape[0]
    if not np.isin(ftype, (AVERAGE, PAETH)).any():
        base = filt.copy()
        sub = ftype == SUB
        if sub.any():
            base[sub] = np.cumsum(filt[sub].reshape(-1, width, bpp), axis=1,
                                  dtype=np.uint8).reshape(-1, width * bpp)
        # an Up row adds the decoded row above: a cumsum down each run of Up
        # rows from the row that starts it
        rows = np.arange(height)
        seg = np.maximum.accumulate(np.where((ftype != UP) | (rows == 0), rows, 0))
        total = np.cumsum(base, axis=0, dtype=np.uint8)
        before = np.where((seg > 0)[:, None], total[np.maximum(seg - 1, 0)], 0)
        return (total - before).astype(np.uint8)
    # anti-diagonal wavefront over the image padded with a zero row on top
    # and a zero pixel on the left: pixel (r, j) lies at flat index
    # (r + 1) * (width + 1) + j + 1, so a diagonal is a slice of stride width
    rec = np.zeros(((height + 1) * (width + 1), bpp), np.int16)
    f = filt.reshape(height * width, bpp).astype(np.int16)
    t = ftype.astype(np.int16)[:, None]
    for k in range(height + width - 1):
        r0, r1 = max(0, k - width + 1), min(height - 1, k)
        n = r1 - r0 + 1
        i0 = r0 * width + k + width + 2
        at = slice(i0, i0 + (n - 1) * width + 1, width)
        left = rec[i0 - 1:i0 - 1 + (n - 1) * width + 1:width]
        up = rec[i0 - width - 1:i0 - width - 1 + (n - 1) * width + 1:width]
        ul = rec[i0 - width - 2:i0 - width - 2 + (n - 1) * width + 1:width]
        tk = t[r0:r1 + 1]
        pred = np.where(tk == SUB, left, 0)
        pred = np.where(tk == UP, up, pred)
        pred = np.where(tk == AVERAGE, (left + up) >> 1, pred)
        pred = np.where(tk == PAETH, _paeth(left, up, ul), pred)
        j0 = r0 * (width - 1) + k
        fk = f[j0:j0 + (n - 1) * (width - 1) + 1:width - 1] if width > 1 else f[j0:j0 + n]
        rec[at] = (fk + pred) & 255
    out = rec.reshape(height + 1, width + 1, bpp)[1:, 1:]
    return out.astype(np.uint8).reshape(height, width * bpp)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG file bytes -> the uint8 array PIL gives for them (see the module
    docstring); `name` is the file named in errors."""
    header, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError(f"{name}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in COLOR_TYPES:
        raise PNGError(f"{name}: unknown PNG colour type {ctype}")
    channels, kind = COLOR_TYPES[ctype]
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise PNGError(f"{name}: {depth}-bit {kind} PNG is not supported (8-bit, and "
                       "palettes of 1, 2 and 4 bits, only)")
    if interlace:
        raise PNGError(f"{name}: Adam7-interlaced {kind} PNG is not supported")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{name}: bad zlib stream in its IDAT chunks ({e})") from e
    stride = (width * channels * depth + 7) // 8
    if len(raw) != height * (stride + 1):
        raise PNGError(f"{name}: {len(raw)} bytes of image data for a {width}x{height} "
                       f"{depth}-bit {kind} image (want {height * (stride + 1)})")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    ftype = rows[:, 0]
    if (ftype > PAETH).any():
        raise PNGError(f"{name}: unknown row filter type {int(ftype.max())}")
    # filters work on whole bytes: a pixel's, or one byte below 8 bits
    unit = max(channels * depth // 8, 1)
    data = _unfilter(ftype, rows[:, 1:], stride // unit, unit)
    if depth < 8:
        # palette indices packed high bits first, rows padded to a byte
        bits = np.unpackbits(data, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :width]
    img = data.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path: Union[str, Path]) -> np.ndarray:
    """Decode the PNG file at `path` (see decode_png)."""
    return decode_png(Path(path).read_bytes(), str(path))


def encode_png(img: np.ndarray, filters: Optional[Union[int, Sequence[int]]] = None
               ) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (zlib level 6). `filters`: one
    filter type for every row, or one a row (None: Up, which a smooth render
    compresses well under and which decodes in one cumsum)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8 RGB, not {img.dtype} {img.shape}")
    height, width, bpp = img.shape
    types = np.broadcast_to(np.asarray(UP if filters is None else filters, np.uint8),
                            (height,))
    if (types > PAETH).any():
        raise ValueError(f"filter types are 0-4, not {int(types.max())}")
    x = img.reshape(height, width * bpp).astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    filt = x.copy()
    for ft, pred in ((SUB, lambda: left), (UP, lambda: up),
                     (AVERAGE, lambda: (left + up) >> 1),
                     (PAETH, lambda: _paeth(left, up, ul))):
        rows = types == ft
        if rows.any():
            filt[rows] = x[rows] - pred()[rows]
    body = np.concatenate([types[:, None], (filt & 255).astype(np.uint8)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: Union[str, Path], img: np.ndarray,
              filters: Optional[Union[int, Sequence[int]]] = None) -> None:
    """Encode (H, W, 3) uint8 RGB (see encode_png) into the file `path`,
    making its directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(img, filters))
