"""The port's JPEG decoder (gsplat_tpu_torch/io/jpeg.py, csrc/jpeg_decode.c)
against PIL, which the JAX package decodes with: bit-equal to
np.asarray(PIL.Image.open(p)) on the committed fixtures (tests/data/jpeg/,
written by torch_port_fixtures.write_jpeg_fixtures, whose manifest holds
the sha256 of PIL's decode) and on files made here: sizes from 1x1 to
33x65, 4:4:4, 4:2:2, 4:2:0 (PIL), 4:4:0 (torch_port_fixtures.encode_jpeg:
PIL does not write it) and grayscale, quality 50, 95 and 100, optimised
tables, restart intervals of 1 and 7 MCUs, one scan a component, Adobe RGB
and 'R','G','B' component ids; progressive files (PIL's scan script, every
layout, restart intervals inside the scans); CMYK (PIL's, baseline and
progressive) and YCCK (encode_jpeg) as (H, W, 4). Unsupported and damaged
files raise with the file named: arithmetic coding, 12-bit samples, a
progressive file whose scans leave coefficients incomplete or break the
progression. Then the dataset side: load_image_rgb equal to the JAX
package's on every fixture, and on a JPEG COLMAP source with the native
library held off in both packages, load_image_rgb and Scene's images equal
to the JAX package's at --resolution 1 and 2.
"""

import dataclasses
import hashlib
import io
import json
import shutil
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_fixtures as F
from gsplat_tpu.config import ModelParams as JModelParams
from gsplat_tpu.io import dataset as j_dataset
from gsplat_tpu.io import native_loader as j_native_loader
from gsplat_tpu.scene import Scene as JScene
from gsplat_tpu_torch.config import ModelParams
from gsplat_tpu_torch.io import colmap, dataset, native_loader
from gsplat_tpu_torch.io.jpeg import JPEGError, decode_jpeg, read_jpeg
from gsplat_tpu_torch.io.synthetic import make_colmap_scene
from gsplat_tpu_torch.scene import Scene

torch.set_num_threads(1)
SIZES = [(1, 1), (1, 2), (2, 3), (5, 7), (8, 8), (9, 17), (16, 16), (17, 33), (33, 65),
         (23, 4), (3, 31)]
LAYOUT_440 = ((1, 2), (1, 1), (1, 1))


def pil_decode(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def pil_encode(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_pil_bits(data, what):
    want = pil_decode(data)
    got = decode_jpeg(data, what)
    assert got.dtype == np.uint8 and got.shape == want.shape, (what, got.shape, want.shape)
    if not np.array_equal(got, want):
        d = np.abs(got.astype(np.int32) - want)
        raise AssertionError(f"{what}: {int((d > 0).sum())} samples differ, max {int(d.max())}")
    return got


def images(h, w, seed):
    """A noisy and a smooth (H, W, 3) uint8 image."""
    rng = np.random.default_rng(seed)
    noisy = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    smooth = np.clip(np.cumsum(rng.normal(0, 20, (h, w, 3)), axis=1) + 128, 0, 255)
    return noisy, smooth.astype(np.uint8)


@pytest.mark.parametrize("name", sorted(F.JPEG_FIXTURES))
def test_fixture_bit_equal_to_pil_and_manifest(name):
    path = F.JPEG_DIR / name
    manifest = json.loads((F.JPEG_DIR / "manifest.json").read_text())[name]
    with Image.open(path) as im:
        want = np.asarray(im)
    assert list(want.shape) == manifest["shape"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == manifest["sha256"]
    got = read_jpeg(path)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("layout", ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "gray"])
@pytest.mark.parametrize("restart", [0, 1, 7])
def test_bit_equal_to_pil(layout, restart):
    """Every size, quality 50/95/100 and optimised tables (PIL's layouts),
    at a restart interval of `restart` MCUs (0: none)."""
    for i, (h, w) in enumerate(SIZES):
        for img in images(h, w, seed=31 * i + restart):
            tag = f"{layout} {h}x{w} rst {restart}"
            if layout == "4:4:0":
                assert_pil_bits(F.encode_jpeg(img, LAYOUT_440, restart=restart), tag)
                continue
            kw = dict(restart_marker_blocks=restart) if restart else {}
            if layout == "gray":
                img = img[..., 1]
            else:
                kw["subsampling"] = layout
            for q in (50, 95, 100):
                assert_pil_bits(pil_encode(img, quality=q, **kw), f"{tag} q{q}")
            assert_pil_bits(pil_encode(img, quality=80, optimize=True, **kw), f"{tag} opt")


@pytest.mark.parametrize("layout", ["4:4:4", "4:2:2", "4:2:0", "gray"])
@pytest.mark.parametrize("restart", [0, 1, 7])
def test_progressive_bit_equal_to_pil(layout, restart):
    """PIL's progressive files (libjpeg's default scan script: DC first and
    refinement, spectral selection, successive approximation, EOB runs),
    every size, quality 50/95/100 and optimised tables, at a restart interval
    of `restart` MCUs (0: none)."""
    for i, (h, w) in enumerate(SIZES):
        for img in images(h, w, seed=53 * i + restart):
            kw = dict(progressive=True, **(dict(restart_marker_blocks=restart) if restart else {}))
            if layout == "gray":
                img = img[..., 1]
            else:
                kw["subsampling"] = layout
            tag = f"progressive {layout} {h}x{w} rst {restart}"
            for q in (50, 95, 100):
                data = pil_encode(img, quality=q, **kw)
                assert b"\xff\xc2" in data
                assert_pil_bits(data, f"{tag} q{q}")
            assert_pil_bits(pil_encode(img, quality=80, optimize=True, **kw), f"{tag} opt")


@pytest.mark.parametrize("how", ["pil", "pil progressive", "numpy cmyk", "numpy ycck"])
def test_four_components_bit_equal_to_pil(how):
    """CMYK as PIL writes it (an Adobe APP14, transform 0; baseline and
    progressive) and, from encode_jpeg, CMYK and YCCK (transform 2) at
    4:4:4, with the K channel subsampled and with chroma subsampled, one
    scan a component and restart intervals: PIL's (H, W, 4) array, its
    CMYK;I inversion included."""
    for i, (h, w) in enumerate(SIZES):
        rng = np.random.default_rng(97 + i)
        img = (rng.random((h, w, 4)) * 255).astype(np.uint8)
        if how.startswith("pil"):
            buf = io.BytesIO()
            Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=90,
                                              progressive=how.endswith("progressive"))
            assert_pil_bits(buf.getvalue(), f"{how} {h}x{w}")
            continue
        for sampling, kw in ((((1, 1),) * 4, {}), (((1, 1),) * 3 + ((2, 2),), dict(restart=2)),
                             (((2, 2), (1, 1), (1, 1), (2, 2)), dict(interleaved=False))):
            data = F.encode_jpeg(img, sampling, colour=how.split()[1], **kw)
            got = assert_pil_bits(data, f"{how} {sampling} {kw} {h}x{w}")
            assert got.shape == (h, w, 4)


@pytest.mark.parametrize("kw", [dict(interleaved=False), dict(colour="adobe-rgb"),
                                dict(colour="rgb-ids"),
                                dict(sampling=((2, 2), (1, 2), (1, 2)), restart=2),
                                dict(sampling=((2, 1), (1, 1), (2, 1)), interleaved=False)],
                         ids=["one scan a component", "adobe rgb", "rgb ids", "h2v2 h1v2",
                              "mixed, one scan a component"])
def test_numpy_encoded_bit_equal_to_pil(kw):
    for i, (h, w) in enumerate(SIZES):
        for img in images(h, w, seed=7 + i):
            assert_pil_bits(F.encode_jpeg(img, **kw), f"{kw} {h}x{w}")


def scans(data):
    """(start, end) of each scan of a JPEG: its SOS segment and the
    entropy-coded data after it, up to the next marker that is not a
    restart marker."""
    out, i = [], 2
    while data[i + 1] != 0xD9:
        j = i + 2 + struct.unpack_from(">H", data, i + 2)[0]
        if data[i + 1] == 0xDA:
            while data[j] != 0xFF or data[j + 1] == 0 or 0xD0 <= data[j + 1] <= 0xD7:
                j += 1
            out.append((i, j))
        i = j
    return out


def unsupported(kind):
    img = images(24, 40, 3)[1]
    if kind.startswith("progressive"):
        data = pil_encode(img, quality=90, progressive=True)
        sc = scans(data)
        assert len(sc) == 10      # libjpeg's default script for YCbCr
        if kind == "progressive":
            # the last scan (luma's last AC bit) dropped
            return data[:sc[-1][0]] + b"\xff\xd9"
        # the first (the DC) dropped: AC scans before any DC
        return data[:sc[0][0]] + data[sc[0][1]:]
    if kind == "12-bit":
        data = pil_encode(img, quality=90)
        sof = data.index(b"\xff\xc0")
        return data[:sof + 4] + bytes([12]) + data[sof + 5:]
    if kind == "411":
        return F.encode_jpeg(img, ((4, 1), (1, 1), (1, 1)))
    data = pil_encode(img, quality=90)
    sof = data.index(b"\xff\xc0")
    if kind in ("arithmetic", "lossless"):
        return data[:sof + 1] + (b"\xc9" if kind == "arithmetic" else b"\xc3") + data[sof + 2:]
    if kind == "truncated":
        return data[:len(data) * 2 // 3]
    if kind == "no EOI":
        return data[:-2]
    return b"GIF89a" + data   # not a JPEG


@pytest.mark.parametrize("kind,reason", [
    ("progressive", "progressive JPEG whose scans leave coefficient .* without its last bits"),
    ("progressive without DC", "corrupt progression .* before its DC"),
    ("12-bit", "12-bit samples"), ("411", "sampling factors"),
    ("arithmetic", "arithmetic"), ("lossless", "lossless"), ("truncated", "truncated"),
    ("no EOI", "truncated"), ("not a JPEG", "not a JPEG")])
def test_unsupported_and_damaged_files_raise_with_the_name(tmp_path, kind, reason):
    path = tmp_path / f"{kind.replace(' ', '_')}.jpg"
    path.write_bytes(unsupported(kind))
    with pytest.raises(JPEGError, match=rf"{path.name}: .*{reason}"):
        read_jpeg(path)


def test_load_image_rgb_on_every_fixture():
    """load_image_rgb equal to the JAX package's (PIL's array / 255) on
    every fixture: grayscale (H, W), colour (H, W, 3), CMYK and YCCK (H, W,
    4), progressive or not."""
    for name in sorted(F.JPEG_FIXTURES):
        got, want = (dataset.load_image_rgb(F.JPEG_DIR / name),
                     j_dataset.load_image_rgb(F.JPEG_DIR / name))
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def jpeg_source(tmp_path_factory):
    """make_colmap_scene's source with each image re-encoded as a JPEG (PIL,
    4:2:0, quality 90) and images.bin naming the .jpg files."""
    root = make_colmap_scene(tmp_path_factory.mktemp("jpg") / "src", n_cams=9, width=48,
                             height=32, n_points=50)
    sparse = root / "sparse" / "0"
    imgs = colmap.read_extrinsics_binary(sparse / "images.bin")
    for k, im in imgs.items():
        png_path = root / "images" / im.name
        with Image.open(png_path) as pim:
            pim.save(png_path.with_suffix(".jpg"), "JPEG", quality=90, subsampling=2)
        png_path.unlink()
        imgs[k] = dataclasses.replace(im, name=png_path.with_suffix(".jpg").name)
    colmap.write_extrinsics_binary(imgs, sparse / "images.bin")
    return root


def test_load_image_rgb_and_scene_on_a_jpeg_source(jpeg_source, tmp_path, monkeypatch):
    """With the native library held off in both packages: load_image_rgb
    equal to the JAX package's on every image, and Scene's camera images
    equal at --resolution 1 and 2 (the port's LANCZOS against PIL's)."""
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(j_native_loader, "available", lambda: False)
    paths = sorted((jpeg_source / "images").glob("*.jpg"))
    assert len(paths) == 9
    for p in paths:
        got, want = dataset.load_image_rgb(p), j_dataset.load_image_rgb(p)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for resolution in (1, 2):
        scenes = {}
        for who, cls, params in (("jax", JScene, JModelParams), ("torch", Scene, ModelParams)):
            src = shutil.copytree(jpeg_source, tmp_path / f"{who}{resolution}" / "src")
            kw = dict(data_device="cpu") if who == "torch" else {}
            scenes[who] = cls(params(source_path=str(src),
                                     model_path=str(tmp_path / f"{who}{resolution}" / "m"),
                                     eval=True, resolution=resolution, **kw),
                              capacity=64, shuffle=False)
        for name in ("get_train_cameras", "get_test_cameras"):
            g_cams = getattr(scenes["torch"], name)()
            w_cams = getattr(scenes["jax"], name)()
            assert [c.image_name for c in g_cams] == [c.image_name for c in w_cams]
            for gc, wc in zip(g_cams, w_cams):
                assert (gc.width, gc.height) == (48 // resolution, 32 // resolution)
                np.testing.assert_array_equal(gc.image.numpy(), np.asarray(wc.image))
