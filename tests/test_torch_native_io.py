"""Port parity, the native IO runtime (gsplat_tpu_torch/csrc/io_runtime.c
through io/native_loader.py): its decode and bilinear resize bit-equal to the
JAX package's IO library (native/, libpng and libjpeg) on every PNG depth
and colour type, Adam7, tRNS keys and palettes, the chunk and zlib rules
that decide whether libpng decodes a file, and every JPEG fixture under
tests/data/jpeg/, each at its own size and three others over a black and a
white background; bit-equal to its plain numpy version on every file; the
same files refused. Its inflate against Python's zlib, its COLMAP readers
against io/colmap.py, and its prefetching loader. Tiny files, built here
from a seed; no JAX render."""

import ctypes
import struct
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest

from gsplat_tpu.io import native_loader as j_native
from gsplat_tpu_torch.io import colmap, native_loader, png

JPEG_DIR = Path(__file__).resolve().parent / "data" / "jpeg"
FILTERS = (0, 1, 2, 3, 4)
BGS = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))


# ---- a PNG writer: any depth, colour type, filter, stream and chunk order ----

def chunk(kind: bytes, data: bytes, bad_crc: bool = False) -> bytes:
    crc = zlib.crc32(kind + data) ^ (1 if bad_crc else 0)
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def ihdr(w, h, depth, ctype, interlace=0) -> bytes:
    return chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))


def pack(s: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) row bytes: high bits first below 8
    (rows padded to a byte), big-endian at 16."""
    h = s.shape[0]
    flat = s.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, -1)
    if depth == 8:
        return flat
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1).astype(np.int64)


def scanlines(samples, depth, interlace=0, filters=FILTERS) -> bytes:
    """The filtered rows of every pass (filter type cycled over a pass's
    rows; each predictor from the unfiltered neighbours, as the format
    defines it)."""
    h, w = samples.shape[:2]
    s = samples.reshape(h, w, -1)
    bpp = max(1, s.shape[2] * depth // 8)
    out = []
    for x0, y0, dx, dy in (png.ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = s[y0::dy, x0::dx]
        if not sub.size:
            continue
        x = pack(sub, depth)
        left, up, ul = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
        left[:, bpp:], up[1:], ul[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        preds = (0, left, up, (left + up) // 2, paeth)
        types = np.resize(np.asarray(filters), x.shape[0])
        rows = np.stack([(x[r] - preds[t][r] if t else x[r]) & 255 for r, t in enumerate(types)])
        out.append(np.concatenate([types[:, None], rows], axis=1).astype(np.uint8).tobytes())
    return b"".join(out)


def png_file(samples, ctype, depth, interlace=0, palette=None, trns=None, stream=None,
             pre=b"", tail=None) -> bytes:
    """A PNG: IHDR, `pre`, PLTE, tRNS, one IDAT of `stream` (default: the
    scanlines at zlib level 6), IEND (or `tail` in its place)."""
    h, w = samples.shape[:2]
    if stream is None:
        stream = zlib.compress(scanlines(samples, depth, interlace))
    out = png.SIGNATURE + ihdr(w, h, depth, ctype, interlace) + pre
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += chunk(b"IDAT", stream)
    return out + (chunk(b"IEND", b"") if tail is None else tail)


def deflate(data: bytes, level=6, strategy=zlib.Z_DEFAULT_STRATEGY) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
    return c.compress(data) + c.flush()


VARIANTS = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 1), (2, 8, 3), (2, 16, 3),
            (3, 1, 1), (3, 2, 1), (3, 4, 1), (3, 8, 1), (4, 8, 2), (4, 16, 2), (6, 8, 4),
            (6, 16, 4)]


def samples_of(ctype, depth, ch, h, w, seed):
    """Random samples; a palette of at most 40 colours for colour type 3."""
    rng = np.random.default_rng(seed)
    top = min(1 << depth, 40) if ctype == 3 else 1 << depth
    palette = rng.integers(0, 256, (top, 3)) if ctype == 3 else None
    return rng.integers(0, top, (h, w, ch)), palette


def keyed(ctype, depth, h=9, w=11, seed=3, key=None):
    """Gray or RGB samples with a tRNS key that a quarter of the pixels hold
    -> (samples, tRNS body)."""
    ch = 1 if ctype == 0 else 3
    s, _ = samples_of(ctype, depth, ch, h, w, seed)
    if key is None:
        key = s[0, 0]
    s[::2, ::2] = key
    return s, struct.pack(f">{ch}H", *np.asarray(key).reshape(-1).tolist())


def png_cases():
    """name -> (file name, bytes, whether libpng decodes it)."""
    cases = {}
    for ctype, depth, ch in VARIANTS:
        for lace in (0, 1):
            s, pal = samples_of(ctype, depth, ch, 13, 17, 7 * depth + ctype + lace)
            cases[f"type{ctype}-{depth}bit{'-adam7' if lace else ''}"] = (
                png_file(s, ctype, depth, lace, pal), True)
    for depth in (1, 2, 4, 8, 16):
        s, t = keyed(0, depth, seed=depth)
        cases[f"trns-gray{depth}"] = (png_file(s, 0, depth, trns=t), True)
    for depth in (8, 16):
        s, t = keyed(2, depth, seed=depth)
        cases[f"trns-rgb{depth}"] = (png_file(s, 2, depth, trns=t), True)
        s, t = keyed(2, depth, seed=depth + 1)
        cases[f"trns-rgb{depth}-adam7"] = (png_file(s, 2, depth, 1, trns=t), True)
    # 16-bit keys compared before the strip: pixels whose high bytes equal
    # the key's but not their low bytes stay opaque
    s, t = keyed(0, 16, seed=4, key=0x1234)
    s[1::2, ::3] = 0x1299
    cases["trns-gray16-highbyte"] = (png_file(s, 0, 16, trns=t), True)
    s, t = keyed(2, 16, seed=5, key=(0x1234, 0x5678, 0x9ABC))
    s[1::2, 1::2] = (0x1200, 0x5600, 0x9A00)
    cases["trns-rgb16-highbyte"] = (png_file(s, 2, 16, trns=t), True)
    # keys out of the file's depth are masked to it (8-bit 0x0105 keys 5)
    s, _ = keyed(0, 8, seed=6, key=5)
    cases["trns-gray8-masked"] = (png_file(s, 0, 8, trns=struct.pack(">H", 0x0105)), True)
    s, _ = keyed(0, 2, seed=6, key=1)
    cases["trns-gray2-masked"] = (png_file(s, 0, 2, trns=struct.pack(">H", 0x0005)), True)
    for depth in (1, 2, 4, 8):
        s, pal = samples_of(3, depth, 1, 9, 11, 40 + depth)
        alpha = np.random.default_rng(depth).integers(0, 256, len(pal)).astype(np.uint8)
        cases[f"trns-palette{depth}"] = (png_file(s, 3, depth, palette=pal,
                                                  trns=alpha.tobytes()), True)
    s, pal = samples_of(3, 8, 1, 9, 11, 50)
    cases["trns-palette-short"] = (png_file(s, 3, 8, palette=pal, trns=bytes(range(0, 250, 25))),
                                   True)
    cases["trns-palette-short-adam7"] = (png_file(s, 3, 8, 1, palette=pal, trns=b"\x00\x80"),
                                         True)
    cases["trns-palette-long"] = (png_file(s, 3, 8, palette=pal, trns=bytes(len(pal) + 1)),
                                  True)
    # indices past a 5-colour palette: black
    s = np.random.default_rng(9).integers(0, 16, (9, 11, 1))
    cases["palette-past-end"] = (png_file(s, 3, 4, palette=np.arange(15).reshape(5, 3) * 17),
                                 True)
    rgb, _ = samples_of(2, 8, 3, 9, 11, 60)
    rgb[::3, ::2] = (1, 2, 3)
    key = struct.pack(">3H", 1, 2, 3)
    plte = chunk(b"PLTE", bytes(range(30)))
    cases["rgb-plte-then-trns"] = (png_file(rgb, 2, 8, pre=plte, trns=key), True)
    cases["rgb-trns-then-plte"] = (png_file(rgb, 2, 8, pre=chunk(b"tRNS", key) + plte), True)
    gray, _ = samples_of(0, 8, 1, 9, 11, 61)
    cases["gray-plte-ignored"] = (png_file(gray, 0, 8, pre=plte), True)
    cases["trns-bad-crc"] = (png_file(rgb, 2, 8, pre=chunk(b"tRNS", key, bad_crc=True)), True)
    cases["trns-in-rgba"] = (png_file(samples_of(6, 8, 4, 9, 11, 62)[0], 6, 8,
                                      pre=chunk(b"tRNS", key)), True)
    s, pal = samples_of(3, 8, 1, 9, 11, 63)
    cases["trns-before-plte"] = (png_file(s, 3, 8, pre=chunk(b"tRNS", b"\x00\x10"),
                                          palette=pal), True)
    cases["ancillary-bad-crc"] = (png_file(rgb, 2, 8, pre=chunk(b"tEXt", b"k\x00v", True)),
                                  True)
    cases["ancillary-unknown"] = (png_file(rgb, 2, 8, pre=chunk(b"zzZz", b"abc")), True)
    raw = scanlines(rgb, 8)
    for name, stream in (("stored", deflate(raw, 0)), ("fixed", deflate(raw, 6, zlib.Z_FIXED)),
                         ("huffman-only", deflate(raw, 6, zlib.Z_HUFFMAN_ONLY)),
                         ("rle", deflate(raw, 6, zlib.Z_RLE)), ("level9", deflate(raw, 9))):
        cases[f"stream-{name}"] = (png_file(rgb, 2, 8, stream=stream), True)
    z = deflate(raw)
    split = chunk(b"IDAT", z[:5]) + chunk(b"IDAT", b"") + chunk(b"IDAT", z[5:20])
    cases["idat-split"] = (png.SIGNATURE + ihdr(11, 9, 8, 2) + split + chunk(b"IDAT", z[20:])
                           + chunk(b"IEND", b""), True)
    cases["idat-extra-after-end"] = (png_file(rgb, 2, 8, stream=z + b"junk"), True)
    cases["idat-too-much-data"] = (png_file(rgb, 2, 8, stream=deflate(raw + bytes(40))), True)
    cases["no-iend"] = (png_file(rgb, 2, 8, tail=b""), True)
    cases["damage-after-image"] = (png_file(rgb, 2, 8, tail=chunk(b"IDAT", b"xx", True)
                                            + b"\x00\x00\x01\x00tE"), True)
    # refused
    good = png_file(rgb, 2, 8)
    cases["bad-signature"] = (b"\x88" + good[1:], False)
    cases["ihdr-bad-crc"] = (good[:29] + bytes([good[29] ^ 1]) + good[30:], False)
    bare = png_file(rgb, 2, 8, tail=b"")                 # ends with the IDAT's CRC
    cases["idat-bad-crc"] = (bare[:-1] + bytes([bare[-1] ^ 1]), False)
    cases["idat-truncated"] = (bare[:-20], False)
    cases["adler-mismatch"] = (png_file(rgb, 2, 8, stream=z[:-1] + bytes([z[-1] ^ 1])), False)
    cases["stream-unfinished"] = (png_file(rgb, 2, 8, stream=z[:-6]), False)
    cases["stream-short"] = (png_file(rgb, 2, 8, stream=deflate(raw[:-5])), False)
    cases["zlib-header"] = (png_file(rgb, 2, 8, stream=bytes([z[0], z[1] ^ 1]) + z[2:]), False)
    cases["block-type-3"] = (png_file(rgb, 2, 8, stream=z[:2] + bytes([z[2] | 6]) + z[3:]),
                             False)
    bad_rows = bytearray(raw)
    bad_rows[34] = 5                                   # row 1's filter type
    cases["filter-type-5"] = (png_file(rgb, 2, 8, stream=deflate(bytes(bad_rows))), False)
    cases["critical-unknown"] = (png_file(rgb, 2, 8, pre=chunk(b"CrIt", b"")), False)
    cases["chunk-name-invalid"] = (png_file(rgb, 2, 8, pre=chunk(b"te5t", b"")), False)
    cases["palette-without-plte"] = (png_file(s, 3, 8), False)
    cases["plte-invalid"] = (png_file(s, 3, 8, pre=chunk(b"PLTE", b"\x00" * 7)), False)
    cases["no-image-data"] = (png.SIGNATURE + ihdr(11, 9, 8, 2) + chunk(b"IEND", b""), False)
    cases["palette-16bit"] = (png.SIGNATURE + ihdr(11, 9, 16, 3) + good[33:], False)
    cases["interlace-2"] = (png.SIGNATURE + ihdr(11, 9, 8, 2, 2) + good[33:], False)
    return {name: (f"{name}.png", data, ok) for name, (data, ok) in cases.items()}


JPEGS = sorted(p.name for p in JPEG_DIR.glob("*.jpg"))
REFUSED_JPEGS = {"cmyk.jpg", "ycck.jpg"}
PNG_CASES = png_cases()
# the file's suffix decides its decoder; the first bytes only where it is
# neither PNG nor JPEG
NAMED = {"png-as-dat": ("type2-8bit", "img.dat", True), "png-upper": ("type6-8bit", "IMG.PNG", True),
         "jpeg-upper": ("rgb420.jpg", "img.JPEG", True),
         "jpeg-as-jpeg": ("gray.jpg", "img.jpeg", True),
         "jpeg-as-dat": ("prog444.jpg", "img.bin", True),
         "jpeg-as-png": ("rgb444.jpg", "jpeg.png", False),
         "png-as-jpg": ("type0-8bit", "png.jpg", False)}
CASES = ([("png", n) for n in PNG_CASES] + [("jpeg", n) for n in JPEGS]
         + [("named", n) for n in NAMED] + [("other", "garbage.dat"), ("other", "missing.png")])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """id -> (path, whether it decodes)."""
    root = tmp_path_factory.mktemp("native_io")
    out = {}
    for name, (fname, data, ok) in PNG_CASES.items():
        (root / fname).write_bytes(data)
        out[f"png:{name}"] = (root / fname, ok)
    for name in JPEGS:
        out[f"jpeg:{name}"] = (JPEG_DIR / name, name not in REFUSED_JPEGS)
    for name, (src, fname, ok) in NAMED.items():
        data = (JPEG_DIR / src).read_bytes() if src.endswith(".jpg") else PNG_CASES[src][1]
        (root / name).mkdir()
        (root / name / fname).write_bytes(data)
        out[f"named:{name}"] = (root / name / fname, ok)
    (root / "garbage.dat").write_bytes(b"\x00\x01\x02\x03" * 8)
    out["other:garbage.dat"] = (root / "garbage.dat", False)
    out["other:missing.png"] = (root / "missing.png", False)
    assert native_loader.available()
    return out


@pytest.fixture(scope="module")
def jax_lib():
    if not j_native.available():
        pytest.skip("the JAX package's IO library (native/) does not build here")
    return j_native


def sizes(w, h):
    """Its own size, half, a few pixels up, and an odd size below it."""
    return [(w, h), (max(1, w // 2), max(1, h // 2)), (w + 7, h + 5),
            (max(1, 2 * w // 3) | 1, max(1, 2 * h // 3) | 1)]


def same_bits(got, want, what):
    """Equal arrays (np.array_equal: one pass, where assert_array_equal
    takes several over a 1080p image)."""
    assert got.shape == want.shape and np.array_equal(got, want), (
        what, got.shape, want.shape, float(np.abs(got - want).max()) if got.shape == want.shape
        else None)


def attempt(fn, *args):
    try:
        return fn(*args)
    except OSError:
        return None


def case_id(c):
    return f"{c[0]}:{c[1]}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_runtime_matches_jax_library(files, jax_lib, case):
    """The runtime's image_size and decode_image (each size, both
    backgrounds) the same bits as the JAX package's library, and refused
    where it refuses the file."""
    path, ok = files[case_id(case)]
    size = attempt(native_loader.image_size, path)
    assert (size is not None) == ok, (path, size)
    w, h = size or (5, 3)
    lib = jax_lib.get_lib()
    jw, jh = ctypes.c_int(), ctypes.c_int()
    jrc = lib.image_size(str(path).encode(), ctypes.byref(jw), ctypes.byref(jh))
    assert (jrc == 0) == ok and (not ok or (jw.value, jh.value) == (w, h))
    for tw, th in sizes(w, h):
        for bg in BGS:
            got = attempt(native_loader.decode_image, path, tw, th, bg)
            want = attempt(jax_lib.decode_image, path, tw, th, bg)
            assert (got is None) == (want is None) == (not ok), (path, tw, th)
            if ok:
                same_bits(got, want, f"{path} {tw}x{th} {bg}")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_runtime_matches_plain(files, case):
    """The runtime equal to its plain numpy version (libpng's rules over
    io/png.py, io/jpeg.py, the resize one rounding an operation) at the
    same sizes and backgrounds; both refuse the same files."""
    path, ok = files[case_id(case)]
    rgb = attempt(native_loader.decode_rgb_plain, path)
    assert (rgb is not None) == ok, path
    h, w = rgb.shape[:2] if ok else (3, 5)
    for tw, th in sizes(w, h):
        want = None
        for bg in BGS:
            got = attempt(native_loader.decode_image, path, tw, th, bg)
            assert (got is None) == (not ok), (path, tw, th)
            if not ok:
                continue
            if want is None or rgb.shape[2] == 4:     # RGB does not read bg
                want = native_loader.resize_to_float_plain(rgb, tw, th, bg)
            same_bits(got, want, f"{path} {tw}x{th} {bg}")


def test_transforms_as_libpng(files):
    """Spot checks of what both decoders are held to: channels, a key's
    alpha, 16-bit keys compared before the strip, a short tRNS opaque past
    its end, black past a palette, tRNS cancelled by a later PLTE."""
    def rgb(name):
        return native_loader.decode_rgb_plain(files[f"png:{name}"][0])

    assert rgb("type0-8bit").shape[2] == 3 and rgb("type4-16bit").shape[2] == 4
    a = rgb("trns-gray16-highbyte")
    assert (a[::2, ::2, 3] == 0).all() and (a[1::2, ::3, 3] == 255).all()
    a = rgb("trns-rgb16-highbyte")
    assert (a[::2, ::2, 3] == 0).all() and (a[1::2, 1::2, 3] == 255).all()
    assert (rgb("trns-gray8-masked")[::2, ::2, 3] == 0).all()
    a = rgb("trns-palette-short")
    assert a.shape[2] == 4 and set(np.unique(a[..., 3])) <= set(range(0, 250, 25)) | {255}
    assert (rgb("palette-past-end")[..., :3].max(axis=2) == 0).any()
    assert rgb("rgb-trns-then-plte").shape[2] == 3 and rgb("rgb-plte-then-trns").shape[2] == 4
    assert rgb("trns-bad-crc").shape[2] == 3 and rgb("trns-palette-long").shape[2] == 3


# ---- inflate ----

def stream_data(seed=0, n=70_000):
    """Text-like bytes with repeats up to the 32K window's far end."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9))) for _ in range(300)]
    data = b" ".join(words[i] for i in rng.integers(0, 300, n // 5))
    return data[:n // 2] + data[:n // 2 - 32760] + bytes(rng.integers(0, 256, 3000, np.uint8))


STREAMS = {"stored": (0, zlib.Z_DEFAULT_STRATEGY), "fixed": (6, zlib.Z_FIXED),
           "dynamic": (6, zlib.Z_DEFAULT_STRATEGY), "level1": (1, zlib.Z_DEFAULT_STRATEGY),
           "level9": (9, zlib.Z_DEFAULT_STRATEGY), "huffman-only": (6, zlib.Z_HUFFMAN_ONLY),
           "rle": (6, zlib.Z_RLE)}


@pytest.mark.parametrize("kind", list(STREAMS))
def test_inflate_matches_zlib(kind):
    """Stored (several blocks past 64K), fixed and dynamic streams, long
    back-references, an empty input: Python's zlib's bytes; cut anywhere
    (the header, a block, the Adler-32) the stream is refused."""
    level, strategy = STREAMS[kind]
    for data in (stream_data(), b""):
        z = deflate(data, level, strategy)
        assert native_loader.inflate(z, len(data) + 10) == zlib.decompress(z) == data
        assert native_loader.inflate(z + b"trailing", len(data)) == data
        for cut in sorted({1, 2, 3, len(z) // 2, len(z) - 4, len(z) - 1}):
            with pytest.raises(ValueError):
                native_loader.inflate(z[:cut], len(data) + 10)
    with pytest.raises(ValueError):                 # longer than the room given
        native_loader.inflate(deflate(b"abc" * 100, level, strategy), 299)


def test_inflate_refuses_what_zlib_refuses():
    """Corrupt header, a bad Adler-32, block type 3, a stored block whose
    lengths disagree, a preset dictionary, and 400 single-byte corruptions
    of a dynamic stream: refused exactly where zlib refuses, and the same
    bytes where it accepts."""
    data = stream_data(1, 6000)
    z = deflate(data)
    stored = deflate(b"hello", 0)
    dict_stream = zlib.compressobj(zdict=b"hello").compress(b"hello") + \
        zlib.compressobj(zdict=b"hello").flush()
    for bad in (bytes([z[0], z[1] ^ 1]) + z[2:], z[:-1] + bytes([z[-1] ^ 1]),
                z[:2] + bytes([z[2] | 6]) + z[3:], stored[:5] + bytes([stored[5] ^ 1]) + stored[6:],
                dict_stream):
        with pytest.raises(zlib.error):
            zlib.decompress(bad)
        with pytest.raises(ValueError):
            native_loader.inflate(bad, 1 << 16)
    rng = np.random.default_rng(2)
    agree = 0
    for pos, bit in zip(rng.integers(2, len(z), 400), rng.integers(0, 8, 400)):
        bad = bytearray(z)
        bad[pos] ^= 1 << bit
        try:
            want = zlib.decompress(bytes(bad))
        except zlib.error:
            want = None
        got = attempt_value(native_loader.inflate, bytes(bad), 1 << 20)
        assert got == want, (pos, bit)
        agree += want is None
    assert agree > 300


def attempt_value(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return None


# ---- COLMAP readers ----

def test_colmap_readers(tmp_path):
    """cameras.bin of several models, images.bin with 2-D points, points3D.bin
    with tracks: the runtime's readers equal io/colmap.py's (and the JAX
    library's); a truncated file raises."""
    rng = np.random.default_rng(4)
    cams = {i + 1: colmap.Camera(id=i + 1, model=m, width=100 + i, height=50 + i,
                                 params=rng.normal(size=colmap.CAMERA_MODEL_NAMES[m].num_params))
            for i, m in enumerate(("PINHOLE", "SIMPLE_RADIAL", "OPENCV", "FULL_OPENCV",
                                   "THIN_PRISM_FISHEYE"))}
    colmap.write_intrinsics_binary(cams, tmp_path / "cameras.bin")
    imgs = {}
    for i in range(1, 5):
        n = int(rng.integers(0, 6))
        imgs[i * 3] = colmap.Image(id=i * 3, qvec=rng.normal(size=4), tvec=rng.normal(size=3),
                                   camera_id=i, name=f"view_{i}" + "x" * (i * 90) + ".png",
                                   xys=rng.normal(size=(n, 2)),
                                   point3D_ids=rng.integers(-1, 50, n))
    colmap.write_extrinsics_binary(imgs, tmp_path / "images.bin")
    n = 40
    xyz, rgb, err = rng.normal(size=(n, 3)), rng.integers(0, 256, (n, 3)), rng.random(n)
    buf = bytearray(struct.pack("<Q", n))
    for i in range(n):
        track = rng.integers(0, 9, (int(rng.integers(0, 4)), 2))
        buf += struct.pack("<Q3d3Bd", i, *xyz[i], *rgb[i].tolist(), err[i])
        buf += struct.pack("<Q", len(track)) + track.astype("<i4").tobytes()
    (tmp_path / "points3D.bin").write_bytes(bytes(buf))

    want = colmap.read_intrinsics_binary(tmp_path / "cameras.bin")
    got = native_loader.read_cameras_bin(tmp_path / "cameras.bin")
    assert sorted(got) == sorted(want)
    for cid, (model, w, h, params) in got.items():
        assert (model, w, h) == (want[cid].model, want[cid].width, want[cid].height)
        np.testing.assert_array_equal(params, want[cid].params)
    want = colmap.read_extrinsics_binary(tmp_path / "images.bin")
    got = native_loader.read_images_bin(tmp_path / "images.bin")
    assert sorted(got) == sorted(want)
    for iid, (q, t, cid, name) in got.items():
        assert (cid, name) == (want[iid].camera_id, want[iid].name[:255])
        np.testing.assert_array_equal(q, want[iid].qvec)
        np.testing.assert_array_equal(t, want[iid].tvec)
    for a, b in zip(native_loader.read_points3d_bin(tmp_path / "points3D.bin"),
                    colmap.read_points3D_binary(tmp_path / "points3D.bin")):
        np.testing.assert_array_equal(a, b)
    if j_native.available():
        for a, b in zip(native_loader.read_points3d_bin(tmp_path / "points3D.bin"),
                        j_native.read_points3d_bin(tmp_path / "points3D.bin")):
            np.testing.assert_array_equal(a, b)
        names = [{k: v[3] for k, v in mod.read_images_bin(tmp_path / "images.bin").items()}
                 for mod in (native_loader, j_native)]
        assert names[0] == names[1]
    for name, fn in (("cameras.bin", native_loader.read_cameras_bin),
                     ("images.bin", native_loader.read_images_bin),
                     ("points3D.bin", native_loader.read_points3d_bin)):
        cut = tmp_path / f"cut_{name}"
        cut.write_bytes((tmp_path / name).read_bytes()[:20])
        with pytest.raises(OSError):
            fn(cut)
        with pytest.raises(OSError):
            fn(tmp_path / f"missing_{name}")


# ---- the prefetching loader ----

@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    paths = []
    for i in range(6):
        s, _ = samples_of(6, 8, 4, 12, 10, 90 + i)
        paths.append(root / f"f{i}.png")
        paths[-1].write_bytes(png_file(s, 6, 8))
    paths.append(root / "bad.png")
    paths[-1].write_bytes(b"not a png")
    return [str(p) for p in paths]


def test_loader_duplicates_and_unrequested(frames):
    """Duplicate prefetches give one frame each (a second get of it decodes
    inline); an index never requested decodes on the calling thread; each
    frame equals decode_image's."""
    bg = (0.2, 0.4, 0.6)
    want = [native_loader.decode_image(p, 7, 9, bg) for p in frames[:6]]
    loader = native_loader.PrefetchLoader(frames, 7, 9, bg=bg, threads=3)
    try:
        loader.prefetch([0, 1, 1, 2, 0, 2, 2])
        for i in (2, 0, 1, 1, 0, 3, 5, 2):
            np.testing.assert_array_equal(loader.get(i), want[i])
        with pytest.raises(IndexError):
            loader.get(len(frames))
        with pytest.raises(IndexError):
            loader.prefetch([-1])
    finally:
        loader.close()
    loader.close()


def test_loader_failure_raises(frames):
    """A frame a worker fails to decode raises IOError at get, once from the
    worker and again from the inline decode; the others still come."""
    loader = native_loader.PrefetchLoader(frames, 5, 4, threads=2)
    try:
        loader.prefetch([6, 4, 6])
        for _ in range(3):
            with pytest.raises(IOError):
                loader.get(6)
        np.testing.assert_array_equal(loader.get(4), native_loader.decode_image(frames[4], 5, 4))
    finally:
        loader.close()


def test_loader_close_with_requests_queued(frames):
    """close() with hundreds of requests still queued returns once the
    decodes under way end (the queued ones are dropped)."""
    loader = native_loader.PrefetchLoader(frames, 64, 64, threads=2)
    loader.prefetch([i % 6 for i in range(600)])
    t = threading.Thread(target=loader.close)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and loader._handle is None


def test_loader_stress_more_workers_than_cores(frames):
    """16 workers over many duplicate requests, gets from 4 threads at
    once: every frame the bits decode_image gives (no lost or crossed
    frame)."""
    want = [native_loader.decode_image(p, 6, 5) for p in frames[:6]]
    loader = native_loader.PrefetchLoader(frames, 6, 5, threads=16)
    errors = []

    def getter(k):
        try:
            for i in range(k, 300, 4):
                if not np.array_equal(loader.get(i % 6), want[i % 6]):
                    errors.append(i)
        except Exception as e:  # recorded for the assert below
            errors.append(repr(e))

    try:
        loader.prefetch([i % 6 for i in range(300)])
        threads = [threading.Thread(target=getter, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
    finally:
        loader.close()
