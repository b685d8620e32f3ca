"""Port parity, dataset IO: gsplat_tpu_torch.io's PNG codec against PIL, its
COLMAP readers and writers, dataset readers and synthetic writer against the
JAX package's, on numpy inputs from a seed at tiny sizes.

The PNG codec decodes what PIL writes (L, LA, RGB, RGBA, P, 16-bit
grayscale; PIL's own filter choices, and files whose rows use every filter
type) and files written here at every bit depth and colour type, Adam7
interlaced or not, to `np.asarray(Image.open(...))`, dtype included, and
PIL decodes what the codec writes to the same uint8 array. Readers give equal arrays, and the synthetic writer equal
sparse files and pixels."""

import io
import math
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gsplat_tpu.io import colmap as j_colmap
from gsplat_tpu.io import dataset as j_dataset
from gsplat_tpu.io import ply as j_ply
from gsplat_tpu.io.synthetic import make_colmap_scene as j_make_colmap_scene
from gsplat_tpu_torch.io import colmap, dataset, native_loader, png, ply
from gsplat_tpu_torch.io.synthetic import look_at_rig, make_colmap_scene

MODES = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6, "P": 3}


def image_for(mode, seed=0, h=32, w=48):
    """A smooth ramp with noise (PIL's adaptive filter then picks several
    types), as a PIL image of `mode`."""
    rng = np.random.default_rng(seed)
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 3}[mode]
    ramp = np.linspace(0, 255, h * w * ch).reshape(h, w, ch)
    arr = np.clip(ramp + rng.normal(0, 12, ramp.shape), 0, 255).astype(np.uint8)
    if mode == "P":
        return Image.fromarray(arr).quantize(200)
    return Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)


def pil_png(im) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()


def pack_samples(s, depth):
    """(h, w, c) integer samples -> (h, stride) row bytes at `depth` bits:
    high bits first below 8, rows padded to a byte; big-endian at 16."""
    h = s.shape[0]
    flat = s.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, -1)
    if depth == 8:
        return flat
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1).astype(np.int64)


def png_bytes(pixels, ctype, filters, depth=8, interlace=0, palette=None, trns=None) -> bytes:
    """A PNG of integer samples `pixels` (H, W[, C]) at `depth` bits, in
    Adam7's seven passes where `interlace`, with the given filter type a row
    (cycled over each pass's rows), filtered here byte by byte as the PNG
    specification states it (the reference both decoders are held to)."""
    h, w = pixels.shape[:2]
    s = pixels.reshape(h, w, -1)
    bpp = max(1, s.shape[2] * depth // 8)
    body = bytearray()
    for x0, y0, dx, dy in (png.ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = s[y0::dy, x0::dx]
        if not sub.size:
            continue
        x = pack_samples(sub, depth)
        for r in range(x.shape[0]):
            ft = filters[r % len(filters)]
            body.append(ft)
            for i in range(x.shape[1]):
                a = x[r, i - bpp] if i >= bpp else 0
                b = x[r - 1, i] if r > 0 else 0
                c = x[r - 1, i - bpp] if r > 0 and i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                pred = (0, a, b, (a + b) // 2, paeth)[ft]
                body.append((x[r, i] - pred) & 255)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data))

    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                       interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(bytes(body))) + chunk(b"IEND", b"")


def row_filters(data: bytes, height: int):
    raw = zlib.decompress(b"".join(b for k, b in png._chunks(data, "x") if k == b"IDAT"))
    stride = len(raw) // height
    return {raw[r * stride] for r in range(height)}


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_pil_written(mode):
    data = pil_png(image_for(mode))
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = png.decode_png(data)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if mode != "P":
        assert len(row_filters(data, 32)) >= 3     # PIL's adaptive choice


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_every_filter_type(mode):
    """Rows cycling through None, Sub, Up, Average, Paeth (the wavefront
    path), and rows of None/Sub/Up only (the whole-array path)."""
    im = image_for(mode, seed=1)
    pixels = np.asarray(im)
    palette = np.asarray(im.getpalette(), np.uint8)[:3 * 200] if mode == "P" else None
    for filters in ((0, 1, 2, 3, 4), (2, 2, 1, 0, 2), (4,), (3, 2)):
        data = png_bytes(pixels, MODES[mode], filters, palette=palette)
        assert row_filters(data, 32) == set(filters)
        want = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(want, pixels)
        np.testing.assert_array_equal(png.decode_png(data), want)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_decode_small_palettes(bits):
    colors = 1 << bits
    rng = np.random.default_rng(bits)
    arr = rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)
    data = pil_png(Image.fromarray(arr).quantize(colors))
    assert struct.unpack_from(">B", data, 24)[0] == bits
    np.testing.assert_array_equal(png.decode_png(data), np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("filters", [None, 0, 1, 2, 3, 4, [0, 1, 2, 3, 4, 4, 3, 1] * 5])
def test_encode_decodes_in_pil(filters, tmp_path):
    rng = np.random.default_rng(3)
    img = np.clip(np.linspace(0, 255, 40 * 50 * 3).reshape(40, 50, 3)
                  + rng.normal(0, 30, (40, 50, 3)), 0, 255).astype(np.uint8)
    png.write_png(tmp_path / "a" / "x.png", img, filters)
    with Image.open(tmp_path / "a" / "x.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(tmp_path / "a" / "x.png"), img)


# (colour type, bit depth, channels) of every combination the format allows
VARIANTS = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 1), (2, 8, 3), (2, 16, 3),
            (3, 1, 1), (3, 2, 1), (3, 4, 1), (3, 8, 1), (4, 8, 2), (4, 16, 2), (6, 8, 4),
            (6, 16, 4)]
# Adam7 sizes: passes that are empty (1x1, 2x3), odd sizes, and one larger
# than a pass's 8x8 period in both directions
LACE_SIZES = [(1, 1), (2, 3), (5, 7), (8, 8), (9, 17), (13, 31)]


def variant_samples(ctype, depth, ch, h, w, seed):
    """Random samples of a variant; a palette of 40 colours (fewer where the
    depth holds fewer) for colour type 3."""
    rng = np.random.default_rng(seed)
    top = 1 << depth
    palette = None
    if ctype == 3:
        top = min(top, 40)
        palette = rng.integers(0, 256, (top, 3))
    return rng.integers(0, top, (h, w, ch)), palette


def assert_pil_array(data, tag):
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im)
    got = png.decode_png(data, tag)
    assert got.dtype == want.dtype and got.shape == want.shape, (tag, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=tag)
    return got


@pytest.mark.parametrize("ctype,depth,ch", VARIANTS,
                         ids=[f"type{c}-{d}bit" for c, d, _ in VARIANTS])
def test_decode_every_depth_and_colour_type(ctype, depth, ch):
    """Every bit depth of every colour type, plain and Adam7-interlaced at
    sizes with empty passes and odd ones, rows of None, Sub, Up, Average
    and Paeth: PIL's array, dtype included (16-bit grayscale uint16, 1-bit
    bool, 2- and 4-bit grayscale scaled, 16-bit colour as high bytes,
    16-bit LA as RGBA)."""
    for i, (h, w) in enumerate(LACE_SIZES):
        samples, palette = variant_samples(ctype, depth, ch, h, w, 10 * i + depth)
        for interlace in (0, 1):
            data = png_bytes(samples, ctype, (0, 1, 2, 3, 4), depth, interlace, palette)
            got = assert_pil_array(data, f"type {ctype} {depth}-bit {h}x{w} lace {interlace}")
    want = {(0, 1): np.bool_, (0, 16): np.uint16}.get((ctype, depth), np.uint8)
    assert got.dtype == want
    if (ctype, depth) == (4, 16):
        assert got.shape[-1] == 4 and (got[..., 0] == got[..., 2]).all()


def test_transparency_and_pil_written_16_bit(tmp_path):
    """A tRNS chunk leaves the array as it is (grayscale of 1, 2 and 16 bits,
    16-bit RGB); PIL's own 16-bit grayscale and 1-bit files; and
    load_image_rgb equal to the JAX package's on 16-bit, 1-bit and
    interlaced files (uint16 values over 255 and bools divide as PIL's
    arrays do)."""
    rng = np.random.default_rng(5)
    for ctype, depth, ch, trns in ((0, 1, 1, b"\x00\x01"), (0, 2, 1, b"\x00\x02"),
                                   (0, 16, 1, b"\x01\x01"),
                                   (2, 16, 3, b"\x01\x01\x00\x05\x00\x07")):
        samples = rng.integers(0, 1 << depth, (6, 9, ch))
        assert_pil_array(png_bytes(samples, ctype, (1,), depth, trns=trns), f"tRNS {ctype}")
    files = {"gray16.png": Image.fromarray(rng.integers(0, 65536, (7, 5)).astype(np.uint16)),
             "bits.png": Image.fromarray(rng.integers(0, 2, (7, 5)).astype(bool))}
    for name, im in files.items():
        im.save(tmp_path / name)
    (tmp_path / "rgb16_lace.png").write_bytes(
        png_bytes(rng.integers(0, 65536, (7, 5, 3)), 2, (4,), 16, 1))
    (tmp_path / "la16.png").write_bytes(png_bytes(rng.integers(0, 65536, (7, 5, 2)), 4, (2,),
                                                  16))
    for path in sorted(tmp_path.glob("*.png")):
        assert_pil_array(path.read_bytes(), path.name)
        got, want = dataset.load_image_rgb(path), j_dataset.load_image_rgb(path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert dataset.load_image_rgb(tmp_path / "gray16.png").max() > 1.0


def bad_header(data, depth, ctype, interlace=0):
    """A PNG with its IHDR's bit depth, colour type and interlace method
    replaced (and the chunk's CRC made good)."""
    ihdr = bytearray(data[12:29])
    ihdr[12:14] = bytes([depth, ctype])
    ihdr[16] = interlace
    return data[:12] + bytes(ihdr) + struct.pack(">I", zlib.crc32(bytes(ihdr))) + data[33:]


def test_unsupported_and_damaged_files_raise(tmp_path):
    """A bit depth the format does not allow for the colour type (16-bit
    palette, 4-bit RGB), an unknown interlace method, a bad CRC, a truncated
    file and a bad zlib stream raise an error naming the file and the kind;
    nothing decodes to a blank."""
    pixels = np.zeros((4, 5, 3), np.uint8)
    for name, ctype, depth, kind in (("deep.png", 3, 16, "palette"), ("rgb4.png", 2, 4, "RGB")):
        path = tmp_path / name
        path.write_bytes(bad_header(png_bytes(pixels, 2, (0,)), depth, ctype))
        with pytest.raises(png.PNGError,
                           match=rf"{name.replace('.', '[.]')}: {depth}-bit {kind}.*not a valid"):
            png.read_png(path)
    lace = tmp_path / "lace.png"
    lace.write_bytes(bad_header(png_bytes(pixels, 2, (0,)), 8, 2, interlace=2))
    with pytest.raises(png.PNGError, match=r"lace\.png: unknown PNG interlace method 2"):
        png.read_png(lace)
    good = png.encode_png(pixels)
    bad_crc = tmp_path / "crc.png"
    bad_crc.write_bytes(good[:-5] + bytes([good[-5] ^ 1]) + good[-4:])
    with pytest.raises(png.PNGError, match=r"crc\.png: bad CRC"):
        png.read_png(bad_crc)
    cut = tmp_path / "cut.png"
    cut.write_bytes(good[:40])
    with pytest.raises(png.PNGError, match=r"cut\.png: truncated"):
        png.read_png(cut)
    with pytest.raises(png.PNGError, match="bad zlib stream"):
        png.decode_png(png_bytes(pixels, 2, (0,))[:33] + struct.pack(">I", 3) + b"IDAT"
                       + b"xyz" + struct.pack(">I", zlib.crc32(b"IDATxyz"))
                       + png_bytes(pixels, 2, (0,))[-12:], "z.png")
    with pytest.raises(ValueError, match="no decoder"):
        dataset.load_image_rgb(tmp_path / "x.tif")


def text_colmap(sparse, cams, imgs, pts):
    """The text forms of a binary sparse model (COLMAP's layout)."""
    (sparse / "cameras.txt").write_text("# cams\n" + "".join(
        f"{c.id} {c.model} {c.width} {c.height} " + " ".join(repr(float(v)) for v in c.params)
        + "\n" for c in cams.values()))
    (sparse / "images.txt").write_text("# imgs\n" + "".join(
        f"{i.id} " + " ".join(repr(float(v)) for v in (*i.qvec, *i.tvec))
        + f" {i.camera_id} {i.name}\n1.5 2.5 -1\n" for i in imgs.values()))
    xyz, rgb, err = pts
    (sparse / "points3D.txt").write_text("".join(
        f"{k} {x!r} {y!r} {z!r} {r} {g} {b} {e!r}\n"
        for k, ((x, y, z), (r, g, b), e) in enumerate(zip(xyz.tolist(), rgb.tolist(),
                                                            err.tolist()))))


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """tests/fixtures.make_colmap_scene's directory (the JAX writer, PIL PNGs)."""
    root = tmp_path_factory.mktemp("jscene")
    return j_make_colmap_scene(root, n_cams=9, width=48, height=32, n_points=50)


def test_colmap_readers_binary_and_text(jax_scene, tmp_path):
    sparse = jax_scene / "sparse" / "0"
    for name in ("cameras.bin", "images.bin"):
        reader = "read_intrinsics_binary" if name == "cameras.bin" else "read_extrinsics_binary"
        want, got = getattr(j_colmap, reader)(sparse / name), getattr(colmap, reader)(sparse / name)
        assert list(want) == list(got)
        for k in want:
            for field in vars(want[k]):
                np.testing.assert_array_equal(getattr(got[k], field), getattr(want[k], field))
    pts = j_colmap.read_points3D_binary(sparse / "points3D.bin")
    for a, b in zip(colmap.read_points3D_binary(sparse / "points3D.bin"), pts):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    text_colmap(tmp_path, j_colmap.read_intrinsics_binary(sparse / "cameras.bin"),
                j_colmap.read_extrinsics_binary(sparse / "images.bin"), pts)
    for reader, name in (("read_intrinsics_text", "cameras.txt"),
                         ("read_extrinsics_text", "images.txt")):
        want, got = getattr(j_colmap, reader)(tmp_path / name), getattr(colmap, reader)(tmp_path / name)
        assert list(want) == list(got)
        for k in want:
            for field in vars(want[k]):
                np.testing.assert_array_equal(getattr(got[k], field), getattr(want[k], field))
    for a, b in zip(colmap.read_points3D_text(tmp_path / "points3D.txt"),
                    j_colmap.read_points3D_text(tmp_path / "points3D.txt")):
        np.testing.assert_array_equal(a, b)


def test_points3d_writer_and_tracks(tmp_path):
    """The vectorised writer's bytes equal the reference's; the reader takes
    records with tracks (the offset loop) and without (the fixed stride)."""
    rng = np.random.default_rng(4)
    xyz, rgb, err = rng.normal(size=(37, 3)), rng.integers(0, 256, (37, 3)), rng.random(37)
    j_colmap.write_points3D_binary(xyz, rgb, err, tmp_path / "j.bin")
    colmap.write_points3D_binary(xyz, rgb, err, tmp_path / "t.bin")
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    buf = bytearray(struct.pack("<Q", 37))
    for i in range(37):
        track = rng.integers(0, 9, 2 * (i % 4)).astype("<i4")
        buf += struct.pack("<q", i) + xyz[i].astype("<f8").tobytes()
        buf += rgb[i].astype(np.uint8).tobytes() + struct.pack("<d", err[i])
        buf += struct.pack("<Q", len(track) // 2) + track.tobytes()
    (tmp_path / "tracks.bin").write_bytes(bytes(buf))
    for path in ("t.bin", "tracks.bin"):
        want = j_colmap.read_points3D_binary(tmp_path / path)
        for a, b in zip(colmap.read_points3D_binary(tmp_path / path), want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def same_infos(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("uid", "R", "T", "fovx", "fovy", "image", "image_name", "width",
                      "height"):
            a, b = getattr(g, field), getattr(w, field)
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
        assert g.image_path.endswith(w.image_path.split("/")[-1])


def same_scene_info(got, want):
    same_infos(got.train_cameras, want.train_cameras)
    same_infos(got.test_cameras, want.test_cameras)
    assert set(got.nerf_normalization) == set(want.nerf_normalization)
    for k in want.nerf_normalization:
        np.testing.assert_array_equal(got.nerf_normalization[k], want.nerf_normalization[k])
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got.point_cloud, f),
                                      getattr(want.point_cloud, f))


@pytest.mark.parametrize("eval_split,load_images,text", [
    (True, True, False), (False, True, False), (True, False, True)])
def test_read_colmap_scene_info(jax_scene, tmp_path, eval_split, load_images, text):
    """Each package reads its own copy of the scene (each writes its own
    points3D.ply): cameras, split, normalisation and point cloud equal, and
    the point clouds' PLY bytes too."""
    dirs = {}
    for who in ("jax", "torch"):
        dirs[who] = shutil.copytree(jax_scene, tmp_path / who)
        if text:
            sparse = dirs[who] / "sparse" / "0"
            text_colmap(sparse, j_colmap.read_intrinsics_binary(sparse / "cameras.bin"),
                        j_colmap.read_extrinsics_binary(sparse / "images.bin"),
                        j_colmap.read_points3D_binary(sparse / "points3D.bin"))
            for name in ("cameras.bin", "images.bin", "points3D.bin"):
                (sparse / name).unlink()
    want = j_dataset.read_colmap_scene_info(dirs["jax"], eval_split=eval_split,
                                            load_images=load_images)
    got = dataset.read_colmap_scene_info(dirs["torch"], eval_split=eval_split,
                                         load_images=load_images)
    same_scene_info(got, want)
    assert len(got.test_cameras) == (2 if eval_split else 0)
    assert open(got.ply_path, "rb").read() == open(want.ply_path, "rb").read()
    assert dataset.detect_scene_type(dirs["torch"]) == "colmap"


@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    """tests/test_blender.py's scene: RGBA PNGs written by PIL."""
    root = tmp_path_factory.mktemp("blender")
    rng = np.random.default_rng(0)
    (root / "train").mkdir()
    (root / "test").mkdir()
    for split, n in (("train", 4), ("test", 2)):
        frames = []
        for i in range(n):
            ang = 2 * math.pi * i / n
            c2w = np.eye(4)
            c2w[:3, 3] = [4 * math.sin(ang), 0, 4 * math.cos(ang)]
            arr = rng.integers(0, 256, size=(32, 40, 4), dtype=np.uint8)
            Image.fromarray(arr, "RGBA").save(root / split / f"r_{i}.png")
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        (root / f"transforms_{split}.json").write_text(
            __import__("json").dumps({"camera_angle_x": 0.7, "frames": frames}))
    return root


@pytest.mark.parametrize("white,eval_split", [(False, True), (True, False)])
def test_read_blender_scene_info(blender_scene, tmp_path, white, eval_split):
    dirs = {who: shutil.copytree(blender_scene, tmp_path / who) for who in ("jax", "torch")}
    want = j_dataset.read_blender_scene_info(dirs["jax"], white_background=white,
                                             eval_split=eval_split, num_init_points=300)
    got = dataset.read_blender_scene_info(dirs["torch"], white_background=white,
                                          eval_split=eval_split, num_init_points=300)
    same_scene_info(got, want)
    assert open(got.ply_path, "rb").read() == open(want.ply_path, "rb").read()
    assert dataset.detect_scene_type(dirs["torch"]) == "blender"
    with pytest.raises(ValueError, match="Could not recognize"):
        dataset.detect_scene_type(tmp_path)


def test_synthetic_writer_matches(jax_scene, tmp_path):
    """The port's make_colmap_scene: the same sparse files, byte for byte,
    and PNGs PIL decodes to the JAX writer's pixels."""
    make_colmap_scene(tmp_path, n_cams=9, width=48, height=32, n_points=50)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "sparse/0" / name).read_bytes() == \
            (jax_scene / "sparse/0" / name).read_bytes()
    for p in sorted((jax_scene / "images").iterdir()):
        with Image.open(p) as a, Image.open(tmp_path / "images" / p.name) as b:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    from gsplat_tpu.io.synthetic import look_at_rig as j_look_at_rig
    for (R, T), (jR, jT) in zip(look_at_rig(5, radius=3.0), j_look_at_rig(5, radius=3.0)):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(T, jT)


def test_point_cloud_ply(tmp_path):
    rng = np.random.default_rng(5)
    xyz, rgb = rng.normal(size=(20, 3)), rng.integers(0, 256, (20, 3))
    j_ply.store_ply(tmp_path / "j.ply", xyz, rgb)
    ply.store_ply(tmp_path / "t.ply", xyz, rgb)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    got, want = ply.fetch_ply(tmp_path / "t.ply"), j_ply.fetch_ply(tmp_path / "j.ply")
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_native_decode_and_readers(jax_scene):
    """Where the native library loads: its decode of a PNG at its own size
    equals the port's codec's, and its COLMAP readers the Python readers'."""
    if not native_loader.available():
        pytest.skip(f"native library not available: {native_loader.build_error}")
    path = sorted((jax_scene / "images").iterdir())[0]
    w, h = native_loader.image_size(path)
    np.testing.assert_array_equal(native_loader.decode_image(path, w, h),
                                  dataset.load_image_rgb(path))
    sparse = jax_scene / "sparse" / "0"
    cams = colmap.read_intrinsics_binary(sparse / "cameras.bin")
    for cid, (model, width, height, params) in native_loader.read_cameras_bin(
            sparse / "cameras.bin").items():
        assert (model, width, height) == (cams[cid].model, cams[cid].width, cams[cid].height)
        np.testing.assert_array_equal(params, cams[cid].params)
    for a, b in zip(native_loader.read_points3d_bin(sparse / "points3D.bin"),
                    colmap.read_points3D_binary(sparse / "points3D.bin")):
        np.testing.assert_array_equal(a, b)


def test_native_fallback_said_once(monkeypatch, capsys):
    """A caller that takes the port's own decoders because the native library
    is missing prints why, once a process."""
    monkeypatch.setattr(native_loader, "build_error", "libgsplat_io.so does not load")
    monkeypatch.setattr(native_loader, "_fallback_said", False)
    native_loader.say_fallback("images decode through io/png.py")
    native_loader.say_fallback("images decode through io/png.py")
    out = capsys.readouterr().out
    assert out == ("native IO library unavailable (libgsplat_io.so does not load); "
                   "images decode through io/png.py\n")
