"""A PNG codec with zlib and struct only: the port's image path where the
JAX package uses PIL (the machine with the GPU has no Pillow).

`read_png` returns what `np.asarray(PIL.Image.open(path))` returns, dtype
included, for every bit depth and colour type of the format, interlaced
(Adam7) or not:
  - grayscale: uint8 (H, W) at 8 bits; at 2 and 4 bits the samples scaled
    to 0-255 (x 85, x 17: PIL's L); at 1 bit a bool array (PIL's mode 1);
    at 16 bits uint16 (PIL's I;16, so values reach 65535);
  - palette (P) of 1, 2, 4 or 8 bits: uint8 (H, W) palette indices;
  - LA: uint8 (H, W, 2) at 8 bits; at 16 bits (H, W, 4) uint8 (L, L, L, A)
    high bytes (PIL opens it as RGBA);
  - RGB, RGBA: uint8 (H, W, 3) and (H, W, 4); at 16 bits their high bytes.
A tRNS chunk leaves the channels as they are, as PIL leaves them. A bit
depth the format does not allow for the colour type, an unknown colour
type, filter or interlace method, a bad chunk CRC, a truncated file or a
bad zlib stream raises `PNGError` with the file's name and the kind: no
image is made up.

`write_png` encodes an 8-bit RGB image; each row's filter type is chosen by
the caller (Up by default). Decoding a file written here, by PIL or by
anything else gives the same pixels: equal bytes are not the contract.

Unfiltering. None, Sub and Up need nothing from a row's own decoded left
neighbour beyond a running sum, so an image that uses only those decodes in
a few whole-array steps (Sub a cumsum mod 256 along the row, Up a cumsum
down each run of Up rows). Average and Paeth take the decoded left
neighbour: byte (r, j) depends on (r, j-1), (r-1, j) and (r-1, j-1) only,
so an image that uses them decodes along anti-diagonals r + j = k, each a
strided view of the padded image, in H + W - 1 numpy steps. An interlaced
image is seven such reduced images (the Adam7 passes), each unfiltered on
its own and put in place with one strided assignment.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, the kind as an error message names it, the bit
# depths the format allows for it)
COLOR_TYPES = {0: (1, "grayscale (L)", (1, 2, 4, 8, 16)), 2: (3, "RGB", (8, 16)),
               3: (1, "palette (P)", (1, 2, 4, 8)),
               4: (2, "grayscale with alpha (LA)", (8, 16)), 6: (4, "RGBA", (8, 16))}
NONE, SUB, UP, AVERAGE, PAETH = range(5)
# the Adam7 passes: (x0, y0, dx, dy) of the pixels each one holds
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


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


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, stride) uint8 -> (h, width, channels) samples:
    uint8, or uint16 at 16 bits (big-endian in the file)."""
    h = rows.shape[0]
    if depth == 16:
        return np.ascontiguousarray(rows).view(">u2").astype(np.uint16).reshape(
            h, width, channels)
    if depth < 8:
        # packed high bits first, rows padded to a byte
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :width, None]
    return rows.reshape(h, width, channels)


def _as_pil(img: np.ndarray, ctype: int, depth: int) -> np.ndarray:
    """(H, W, channels) samples -> the array PIL gives (module docstring)."""
    if ctype == 3:
        return img[..., 0]
    if ctype == 0:
        if depth == 1:
            return img[..., 0].astype(bool)
        if depth < 8:
            return img[..., 0] * np.uint8(255 // ((1 << depth) - 1))
        return img[..., 0]
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:
            return img[..., [0, 0, 0, 1]]
    return img


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG file bytes -> the array PIL gives for them (see the module
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
    channels, kind, depths = COLOR_TYPES[ctype]
    if depth not in depths:
        raise PNGError(f"{name}: {depth}-bit {kind} PNG is not a valid PNG (depths "
                       f"{', '.join(map(str, depths))} only)")
    if interlace not in (0, 1):
        raise PNGError(f"{name}: unknown PNG interlace method {interlace}")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{name}: bad zlib stream in its IDAT chunks ({e})") from e
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(width - x0) // dx) if width > x0 else 0,
              -(-(height - y0) // dy) if height > y0 else 0) for x0, y0, dx, dy in passes]
    strides = [(pw * channels * depth + 7) // 8 for pw, _ in sizes]
    want = sum(ph * (st + 1) for (pw, ph), st in zip(sizes, strides) if pw and ph)
    if len(raw) != want:
        raise PNGError(f"{name}: {len(raw)} bytes of image data for a {width}x{height} "
                       f"{depth}-bit {kind} image{' (Adam7)' if interlace else ''} "
                       f"(want {want})")
    img = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    # filters work on whole bytes: a pixel's, or one byte below 8 bits
    unit = max(channels * depth // 8, 1)
    off = 0
    for (x0, y0, dx, dy), (pw, ph), stride in zip(passes, sizes, strides):
        if not pw or not ph:
            continue
        rows = np.frombuffer(raw, np.uint8, ph * (stride + 1), off).reshape(ph, stride + 1)
        off += ph * (stride + 1)
        ftype = rows[:, 0]
        if (ftype > PAETH).any():
            raise PNGError(f"{name}: unknown row filter type {int(ftype.max())}")
        img[y0::dy, x0::dx] = _samples(_unfilter(ftype, rows[:, 1:], stride // unit, unit),
                                       pw, channels, depth)
    return _as_pil(img, ctype, depth)


def read_png(path: Union[str, Path]) -> np.ndarray:
    """Decode the PNG file at `path` (see decode_png)."""
    return decode_png(Path(path).read_bytes(), str(path))


def encode_png(img: np.ndarray, filters: Optional[Union[int, Sequence[int]]] = None,
               level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes at zlib `level` (0-9; 6, zlib's
    default, unless named). `filters`: one filter type for every row, or one
    a row (None: Up, which a smooth render compresses well under and which
    decodes in one cumsum). Only the predictors the chosen types need are
    computed; Sub and Up subtract in uint8, which wraps mod 256 as the
    format asks."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8 RGB, not {img.dtype} {img.shape}")
    height, width, bpp = img.shape
    types = np.broadcast_to(np.asarray(UP if filters is None else filters, np.uint8),
                            (height,))
    if (types > PAETH).any():
        raise ValueError(f"filter types are 0-4, not {int(types.max())}")
    x = img.reshape(height, width * bpp)
    used = set(np.unique(types).tolist()) - {NONE}
    left = up = None
    if used & {SUB, AVERAGE, PAETH}:
        left = np.zeros_like(x)
        left[:, bpp:] = x[:, :-bpp]
    if used & {UP, AVERAGE, PAETH}:
        up = np.zeros_like(x)
        up[1:] = x[:-1]

    def paeth() -> np.ndarray:
        ul = np.zeros_like(x)
        ul[1:, bpp:] = x[:-1, :-bpp]
        return _paeth(left.astype(np.int16), up.astype(np.int16),
                      ul.astype(np.int16)).astype(np.uint8)

    preds = {SUB: lambda: left, UP: lambda: up,
             AVERAGE: lambda: ((left.astype(np.int16) + up) >> 1).astype(np.uint8),
             PAETH: paeth}
    body = np.empty((height, 1 + width * bpp), np.uint8)    # each row: type, bytes
    body[:, 0] = types
    body[:, 1:] = x
    for ft in sorted(used):
        rows = types == ft
        body[rows, 1:] = x[rows] - preds[ft]()[rows]

    def chunk(kind: bytes, data: bytes) -> Sequence[bytes]:
        return (struct.pack(">I", len(data)), kind, data,
                struct.pack(">I", zlib.crc32(data, zlib.crc32(kind))))

    return b"".join((SIGNATURE,
                     *chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)),
                     *chunk(b"IDAT", zlib.compress(body.data, level)),
                     *chunk(b"IEND", b"")))


def write_png(path: Union[str, Path], img: np.ndarray,
              filters: Optional[Union[int, Sequence[int]]] = None) -> None:
    """Encode (H, W, 3) uint8 RGB (see encode_png, zlib level 6) into the
    file `path`, making its directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(img, filters))
