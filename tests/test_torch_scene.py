"""Port parity, scene and render CLI: gsplat_tpu_torch's camera loading,
point-cloud init, `Scene` and `render_cli` against the JAX package's on the
same directories, at tiny sizes on the CPU.

Cameras within 1e-6, the LANCZOS resize within 1/255 of PIL's (it measures
0), Gaussians within 2e-6 relative, splits equal, `cameras.json` and
`input.ply` byte-equal. The render CLI's PNGs decode equal to the port's
own `render` of each camera, quantised as the CLI quantises it; `render`
itself is held against the JAX package by tests/test_torch_render.py, so
nothing here runs the JAX render."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gsplat_tpu.config import ModelParams as JModelParams
from gsplat_tpu.core import camera as j_camera
from gsplat_tpu.core.gaussians import create_from_pcd as j_create_from_pcd
from gsplat_tpu.io import dataset as j_dataset
from gsplat_tpu.io import native_loader as j_native_loader
from gsplat_tpu.scene import Scene as JScene
from gsplat_tpu_torch import render_cli
from gsplat_tpu_torch.config import ModelParams
from gsplat_tpu_torch.core import camera
from gsplat_tpu_torch.core.gaussians import create_from_pcd, inverse_sigmoid
from gsplat_tpu_torch.interop import gaussians_to_numpy
from gsplat_tpu_torch.io import dataset, native_loader, png
from gsplat_tpu_torch.io.ply import save_gaussian_ply
from gsplat_tpu_torch.io.synthetic import make_colmap_scene
from gsplat_tpu_torch.render.render import render
from gsplat_tpu_torch.scene import Scene, search_for_max_iteration

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "max_radii2D",
          "xyz_gradient_accum", "denom")


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    return make_colmap_scene(tmp_path_factory.mktemp("src"), n_cams=9, width=48,
                             height=32, n_points=50)


def same_gaussians(got, want, rtol=2e-6):
    """The port's Gaussians against the JAX package's, leaf by leaf."""
    g = gaussians_to_numpy(got)
    for k in FIELDS:
        w = np.asarray(getattr(want, k))
        assert g[k].shape == w.shape, k
        np.testing.assert_allclose(g[k], w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
    assert int(g["n_live"]) == int(want.n_live)
    assert (got.active_sh_degree, got.max_sh_degree) == (want.active_sh_degree,
                                                         want.max_sh_degree)
    assert got.spatial_lr_scale == pytest.approx(want.spatial_lr_scale, rel=1e-12)


def same_camera(got, want, image_atol=0.0):
    for k in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert (got.width, got.height, got.image_name, got.uid) == \
        (want.width, want.height, want.image_name, want.uid)
    diff = np.abs(got.image.numpy() - np.asarray(want.image)).max()
    assert diff <= image_atol, diff
    return diff


@pytest.mark.parametrize("width", [48, 1600, 1601, 2000, 3000])
@pytest.mark.parametrize("resolution", [-1, 1, 2, 4, 8, 24, 800])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_scaled_resolution(width, resolution, scale):
    info = dataset.CameraInfo(uid=0, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.8,
                              image=None, image_path="", image_name="", width=width,
                              height=width * 9 // 16)
    assert camera._scaled_resolution(info, resolution, scale) == \
        j_camera._scaled_resolution(info, resolution, scale)


def test_scaled_resolution_warns_once(capsys, monkeypatch):
    monkeypatch.setattr(camera, "WARNED", [False])
    info = dataset.CameraInfo(0, np.eye(3), np.zeros(3), 1.0, 0.8, None, "", "", 2000, 1000)
    assert camera._scaled_resolution(info, -1) == (1600, 800)
    camera._scaled_resolution(info, -1)
    assert capsys.readouterr().out.count("rescaling to 1.6K") == 1


@pytest.mark.parametrize("shape,size", [((32, 48), (24, 16)), ((33, 47), (13, 20)),
                                        ((20, 30), (61, 40)), ((64, 96), (45, 30)),
                                        ((48, 64), (64, 24))])
def test_resize_image_matches_pil(shape, size):
    """The port's LANCZOS against the JAX package's (PIL), on float images
    in [0, 1] as load_camera hands them over: within 1/255, and in fact
    equal."""
    rng = np.random.default_rng(shape[0])
    img = rng.random(shape + (3,)).astype(np.float32)
    got = camera._resize_image(img, *size)
    want = j_camera._resize_image(img, *size)
    assert got.shape == want.shape == (size[1], size[0], 3) and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1 / 255
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("resolution,white", [(1, False), (2, False), (-1, True)])
def test_load_camera(source, resolution, white):
    """load_camera on the same CameraInfo: matrices within 1e-6, the image
    equal (resized at resolution 2)."""
    want_infos = j_dataset.read_colmap_scene_info(source, eval_split=False).train_cameras
    got_infos = dataset.read_colmap_scene_info(source, eval_split=False).train_cameras
    for gi, wi in zip(got_infos[:3], want_infos[:3]):
        got = camera.load_camera(gi, resolution, white_background=white, device="cpu")
        want = j_camera.load_camera(wi, resolution, white_background=white)
        same_camera(got, want)
        assert got.width == (48 if resolution != 2 else 24)
        assert camera.camera_to_json(3, gi) == j_camera.camera_to_json(3, wi)


def test_load_camera_rgba_and_gray(tmp_path):
    """An RGBA target over a white or black background, and a grayscale one
    repeated to RGB, as the reference does them."""
    rng = np.random.default_rng(6)
    from PIL import Image
    Image.fromarray(rng.integers(0, 256, (20, 30, 4), dtype=np.uint8), "RGBA").save(
        tmp_path / "a.png")
    Image.fromarray(rng.integers(0, 256, (20, 30), dtype=np.uint8), "L").save(tmp_path / "g.png")
    for name in ("a.png", "g.png"):
        kw = dict(uid=1, R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), fovx=0.9, fovy=0.7,
                  image=None, image_path=str(tmp_path / name), image_name="a", width=30,
                  height=20)
        for white in (False, True):
            same_camera(camera.load_camera(dataset.CameraInfo(**kw), 2, white_background=white,
                                           device="cpu"),
                        j_camera.load_camera(j_dataset.CameraInfo(**kw), 2,
                                             white_background=white))


@pytest.mark.parametrize("n", [50, 3])
def test_create_from_pcd(n):
    rng = np.random.default_rng(n)
    pts, cols = rng.normal(size=(n, 3)), rng.random((n, 3))
    got = create_from_pcd(pts, cols, capacity=64, max_sh_degree=3, spatial_lr_scale=2.5,
                          device="cpu")
    want = j_create_from_pcd(pts, cols, capacity=64, max_sh_degree=3, spatial_lr_scale=2.5)
    same_gaussians(got, want)
    with pytest.raises(ValueError, match="exceed capacity"):
        create_from_pcd(pts, cols, capacity=2, device="cpu")
    x = torch.tensor([0.1, 0.5, 0.9])
    np.testing.assert_allclose(inverse_sigmoid(x).numpy(), np.log([1 / 9, 1.0, 9.0]), rtol=1e-6)


def write_model(model: Path, source: Path, iterations, n=40, seed=0):
    """A trained-model directory: one random Gaussian PLY an iteration, and
    a cfg_args that names the source."""
    rng = np.random.default_rng(seed)
    for it in iterations:
        save_gaussian_ply(model / "point_cloud" / f"iteration_{it}" / "point_cloud.ply",
                          rng.normal(size=(n, 3)) * 0.8, rng.random((n, 3)),
                          rng.normal(size=(n, 15, 3)) * 0.1, rng.normal(size=(n, 1)),
                          np.full((n, 3), -2.0) + rng.normal(size=(n, 3)) * 0.2,
                          rng.normal(size=(n, 4)))
    (model / "cfg_args").write_text(f"Namespace(sh_degree=3, source_path='{source}', "
                                    f"model_path='{model}', images='images', eval=True)")


@pytest.mark.parametrize("loaded,shuffle,native,resolution", [
    (False, True, True, -1),
    (False, False, False, 2),
    (True, True, False, 2),
    (True, False, True, 1),
])
def test_scene_matches(source, tmp_path, monkeypatch, loaded, shuffle, native, resolution):
    """Scene fresh (create_from_pcd; input.ply and cameras.json written) and
    loaded (--iteration -1 over point_cloud/iteration_*), shuffled and not,
    with the native predecode (bilinear, both packages) or without it (the
    port's LANCZOS against PIL's): each package on its own copy of the
    source."""
    if not native:
        monkeypatch.setattr(native_loader, "available", lambda: False)
        monkeypatch.setattr(j_native_loader, "available", lambda: False)
    scenes = {}
    for who, cls, params in (("jax", JScene, JModelParams), ("torch", Scene, ModelParams)):
        src = shutil.copytree(source, tmp_path / who / "src")
        model = tmp_path / who / "model"
        if loaded:
            write_model(model, src, (3, 12))
        kw = dict(data_device="cpu") if who == "torch" else {}
        scenes[who] = cls(params(source_path=str(src), model_path=str(model), eval=True,
                                 resolution=resolution, **kw),
                          capacity=64, load_iteration=-1 if loaded else None, shuffle=shuffle)
    got, want = scenes["torch"], scenes["jax"]
    assert got.loaded_iter == want.loaded_iter == (12 if loaded else None)
    assert got.cameras_extent == want.cameras_extent
    for name in ("get_train_cameras", "get_test_cameras"):
        g_cams, w_cams = getattr(got, name)(), getattr(want, name)()
        assert [c.image_name for c in g_cams] == [c.image_name for c in w_cams]
        for gc, wc in zip(g_cams, w_cams):
            same_camera(gc, wc)
    assert len(got.get_test_cameras()) == 2 and len(got.get_train_cameras()) == 7
    same_gaussians(got.gaussians, want.gaussians)
    for name in ("input.ply", "cameras.json"):
        g_file, w_file = tmp_path / "torch/model" / name, tmp_path / "jax/model" / name
        assert g_file.exists() == w_file.exists() == (not loaded)
        if not loaded:
            assert g_file.read_bytes() == w_file.read_bytes()
    if not loaded:
        assert len(json.loads((tmp_path / "torch/model/cameras.json").read_text())) == 9


def test_search_for_max_iteration(tmp_path):
    assert search_for_max_iteration(tmp_path / "missing") is None
    for name in ("iteration_7", "iteration_30000", "iteration_123", "other"):
        (tmp_path / name).mkdir()
    assert search_for_max_iteration(tmp_path) == 30000


def rendered_equal(model: Path, scene: Scene, iteration: int, split: str, cams, chunk=128):
    """Every PNG the CLI wrote for `split` decodes equal to the port's own
    render of that camera, quantised as save_png quantises it."""
    base = model / split / f"ours_{iteration}"
    bg = torch.zeros(3)
    for idx, cam in enumerate(cams):
        out = render(cam, scene.gaussians, bg, tile_size=32, chunk=chunk, pair_budget=4096)
        assert int(out.n_dropped) == 0
        want = (np.clip(out.image.numpy(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(png.read_png(base / "renders" / f"{idx:05d}.png"), want)
        gt = (np.clip(cam.image.numpy(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(png.read_png(base / "gt" / f"{idx:05d}.png"), gt)


@pytest.mark.parametrize("budget,chunk", [(4096, 128), (32, 32)])
def test_render_cli(source, tmp_path, capsys, budget, chunk):
    """render_cli.main on the CPU (--data_device cpu): the output tree of
    tests/test_cli_tools.py::test_render_cli (llffhold 8: 2 of 9 cameras to
    test), PNGs equal to the port's own render; at a pair budget of 32 the
    first camera drops pairs and the budget regrows."""
    model = tmp_path / "model"
    write_model(model, source, (8,))
    assert render_cli.main(["--model_path", str(model), "--iteration", "-1",
                            "--pair_budget", str(budget), "--chunk_size", str(chunk),
                            "--data_device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("pairs dropped; pair budget -> 64" in out) == (budget == 32)
    test_renders = model / "test" / "ours_8" / "renders"
    train_renders = model / "train" / "ours_8" / "renders"
    assert len(list(test_renders.iterdir())) == 2
    assert len(list(train_renders.iterdir())) == 7
    assert (model / "test" / "ours_8" / "gt" / "00000.png").exists()
    scene = Scene(ModelParams(source_path=str(source), model_path=str(model), eval=True,
                              data_device="cpu"), load_iteration=-1, shuffle=False)
    rendered_equal(model, scene, 8, "test", scene.get_test_cameras(), chunk)
    rendered_equal(model, scene, 8, "train", scene.get_train_cameras(), chunk)


def test_render_cli_module_entry_point(source, tmp_path):
    """`python -m gsplat_tpu_torch.render_cli`, with the source named on the
    command line and --skip_train."""
    model = tmp_path / "model"
    write_model(model, source, (5,))
    p = subprocess.run([sys.executable, "-m", "gsplat_tpu_torch.render_cli", "--model_path",
                        str(model), "--source_path", str(source), "--skip_train",
                        "--data_device", "cpu", "--resolution", "2"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert not (model / "train").exists()
    assert png.read_png(model / "test" / "ours_5" / "renders" / "00000.png").shape == (16, 24, 3)
