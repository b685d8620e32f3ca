"""Port parity, the eval tools: gsplat_tpu_torch's lpips.py and metrics_cli.py
against the JAX package's on the same inputs, full_eval.py and the tools
under gsplat_tpu_torch/tools/ on the CPU.

- lpips: the port's against the JAX lpips on tests/test_lpips.py's random
  VGG16-shaped weights, two 32x32 pairs, within 1e-5 relative (both run
  13 fp32 convolutions); load_lpips_weights from .npz and from .pth equal
  to the JAX loader's, array for array;
- evaluate_model on one model directory of PNGs that io/png.py writes:
  SSIM, PSNR, L1 and LPIPS within 1e-5 relative of the JAX evaluate_model's
  (which decodes through PIL), the keys and n_images equal; metrics_cli's
  results.json and printed lines;
- full_eval.main over two tiny make_colmap_scene scenes with --data_device
  cpu and random LPIPS weights: full_eval.json's layout, each scene's
  metrics equal to the port's metrics_cli on the PNGs it wrote; no JAX
  training or render in this file (each new shape compiles for minutes);
- the tools at tiny sizes: gpu_parity (the plain versions against the
  per-pixel oracle), selfcheck_train, quality_proxy (its scene through
  make_synthetic_scene, and the CLI run), profile_step and ab_step.
"""

import json

import numpy as np
import pytest
import torch

from gsplat_tpu import lpips as jlpips
from gsplat_tpu import metrics_cli as jmetrics
from gsplat_tpu_torch import full_eval, metrics_cli
from gsplat_tpu_torch import lpips as tlpips
from gsplat_tpu_torch.io import png
from gsplat_tpu_torch.io.synthetic import make_colmap_scene
from test_lpips import _rand_lin_state, _rand_vgg_state

torch.set_num_threads(2)
RTOL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """tests/test_lpips.py's random weights, written as .pth and .npz."""
    rng = np.random.default_rng(7)
    vgg_sd, lin_sd = _rand_vgg_state(rng), _rand_lin_state(rng)
    d = tmp_path_factory.mktemp("lpips")
    torch.save({k: torch.from_numpy(v) for k, v in vgg_sd.items()}, d / "vgg16.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lin_sd.items()}, d / "lin.pth")
    np.savez(d / "vgg16.npz", **vgg_sd)
    np.savez(d / "lin.npz", **lin_sd)
    return d


@pytest.mark.parametrize("vgg,lin", [("vgg16.pth", "lin.npz"), ("vgg16.npz", "lin.pth")])
def test_load_lpips_weights_matches_jax(weights, vgg, lin):
    got = tlpips.load_lpips_weights(weights / vgg, weights / lin)
    want = jlpips.load_lpips_weights(weights / vgg, weights / lin)
    assert len(got["convs"]) == len(want["convs"]) == 5
    for gl, wl in zip(got["convs"], want["convs"]):
        assert len(gl) == len(wl)
        for (gw, gb), (ww, wb) in zip(gl, wl):
            assert gw.dtype == np.float32 and np.array_equal(gw, ww) and np.array_equal(gb, wb)
    for gw, ww in zip(got["lins"], want["lins"]):
        assert gw.shape == ww.shape and np.array_equal(gw, ww)


def test_lpips_matches_jax(weights):
    params = tlpips.load_lpips_weights(weights / "vgg16.pth", weights / "lin.npz")
    rng = np.random.default_rng(3)
    for _ in range(2):
        a = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        got = float(tlpips.lpips(params, a, b, device="cpu"))
        want = float(jlpips.lpips(params, a, b))
        assert got == pytest.approx(want, rel=RTOL), (got, want)
        assert got > 0
    on_device = tlpips.lpips_to_device(params, "cpu")
    assert float(tlpips.lpips(on_device, torch.from_numpy(a), torch.from_numpy(b))) == got


def _write_model(root, rng, splits=("test", "train"), size=(24, 32)):
    """A model directory of rendered sets: <split>/ours_7/{renders,gt}/*.png."""
    for split in splits:
        for i in range(2):
            gt = rng.integers(0, 256, size + (3,), dtype=np.uint8)
            r = np.clip(gt.astype(int) + rng.integers(-40, 41, gt.shape), 0, 255)
            png.write_png(root / split / "ours_7" / "renders" / f"{i:05d}.png", r.astype(np.uint8))
            png.write_png(root / split / "ours_7" / "gt" / f"{i:05d}.png", gt)
    return root


def test_evaluate_model_matches_jax(weights, tmp_path):
    model = _write_model(tmp_path / "model", np.random.default_rng(11))
    params = tlpips.load_lpips_weights(weights / "vgg16.pth", weights / "lin.npz")
    got = metrics_cli.evaluate_model(model, params, device="cpu")
    want = jmetrics.evaluate_model(model, params)
    assert list(got) == list(want) == ["test/ours_7", "train/ours_7"]
    for key in want:
        assert list(got[key]) == list(want[key])
        assert got[key]["n_images"] == want[key]["n_images"] == 2
        for m in ("SSIM", "PSNR", "L1", "LPIPS"):
            assert got[key][m] == pytest.approx(want[key][m], rel=RTOL), (key, m)


def test_metrics_cli_main(weights, tmp_path, capsys):
    model = _write_model(tmp_path / "model", np.random.default_rng(5), splits=("test",))
    assert metrics_cli.main(["-m", str(model), "--data_device", "cpu",
                             "--lpips_vgg", str(weights / "vgg16.npz"),
                             "--lpips_lin", str(weights / "lin.npz")]) == 0
    res = json.loads((model / "results.json").read_text())
    assert res == metrics_cli.evaluate_model(
        model, tlpips.load_lpips_weights(weights / "vgg16.npz", weights / "lin.npz"), "cpu")
    out = capsys.readouterr().out
    assert f"Scene: {model}" in out and "test/ours_7: PSNR" in out and "(2 images)" in out
    with pytest.raises(SystemExit):
        metrics_cli.main(["-m", str(model), "--lpips_vgg", str(weights / "vgg16.npz")])


def test_metrics_need_a_device_by_name(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics_cli.evaluate_model(tmp_path)


def test_lpips_numpy_images_need_a_device_by_name(weights):
    """Numpy images go to the card unless the CPU is named; a tensor keeps
    its own device."""
    params = tlpips.load_lpips_weights(weights / "vgg16.npz", weights / "lin.npz")
    a = np.full((16, 16, 3), 0.25, np.float32)
    b = np.full((16, 16, 3), 0.75, np.float32)
    got = tlpips.lpips(params, a, b, device="cpu")
    assert got.device.type == "cpu"
    assert float(tlpips.lpips(params, torch.from_numpy(a), torch.from_numpy(b),
                              device="cuda")) == float(got)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlpips.lpips(params, a, b)


@pytest.fixture(scope="module")
def full_eval_run(weights, tmp_path_factory):
    root = tmp_path_factory.mktemp("full_eval")
    scenes = [make_colmap_scene(root / name, n_cams=5, width=40, height=32, n_points=30,
                                seed=seed) for name, seed in (("alpha", 0), ("beta", 1))]
    out = root / "eval"
    rc = full_eval.main(["--scenes", *map(str, scenes), "-o", str(out),
                         "--lpips_vgg", str(weights / "vgg16.npz"),
                         "--lpips_lin", str(weights / "lin.npz"),
                         "--iterations", "6", "--capacity", "64", "--pair_budget", "4096",
                         "--chunk_size", "32", "--tile_size", "16", "--resolution", "1",
                         "--data_device", "cpu"])
    return rc, out


def test_full_eval_layout(full_eval_run):
    rc, out = full_eval_run
    assert rc == 0
    summary = json.loads((out / "full_eval.json").read_text())
    assert sorted(summary) == ["alpha", "beta"]
    for scene, res in summary.items():
        assert sorted(res) == ["test/ours_6", "train/ours_6"], scene
        assert res["test/ours_6"]["n_images"] == 1 and res["train/ours_6"]["n_images"] == 4
        for vals in res.values():
            assert sorted(vals) == ["L1", "LPIPS", "PSNR", "SSIM", "n_images"]
            assert all(np.isfinite(vals[m]) for m in ("L1", "LPIPS", "PSNR", "SSIM"))
        # rendered at the trained resolution (--resolution forwarded)
        assert png.read_png(out / scene / "test" / "ours_6" / "renders" / "00000.png").shape \
            == (32, 40, 3)


def test_full_eval_metrics_equal_metrics_cli(full_eval_run, weights):
    _, out = full_eval_run
    summary = json.loads((out / "full_eval.json").read_text())
    params = tlpips.load_lpips_weights(weights / "vgg16.npz", weights / "lin.npz")
    for scene in ("alpha", "beta"):
        assert summary[scene] == metrics_cli.evaluate_model(out / scene, params, "cpu")


@pytest.mark.parametrize("argv,want", [
    (["--iterations", "5", "--data_device", "cpu"], ["--data_device", "cpu"]),
    (["--data_device=cuda:1", "-r", "2", "--data_device", "cpu"], ["--data_device", "cpu"]),
    (["--data_device=cuda:1"], ["--data_device", "cuda:1"]),
    (["--data_dev", "cpu", "--eval"], ["--data_device", "cpu"]),
    (["--iterations", "5"], []),
])
def test_full_eval_forwards_the_device(argv, want):
    assert full_eval._shared_flags(argv)[0] == want


@pytest.mark.parametrize("argv,want", [
    (["-r", "2", "--eval"], ["--resolution", "2"]),
    (["-r2", "--data_device", "cpu"], ["--resolution", "2"]),
    (["--resolution=4"], ["--resolution", "4"]),
    (["--resolution", "8", "--iterations", "5"], ["--resolution", "8"]),
    (["--iterations", "5"], []),
])
def test_full_eval_forwards_the_resolution(argv, want):
    assert full_eval._shared_flags(argv)[1] == want


# ---------------------------------------------------------------- tools


def test_gpu_parity_on_cpu(capsys):
    from gsplat_tpu_torch.tools import gpu_parity

    assert gpu_parity.main(["--device", "cpu", "--n", "40", "--size", "48"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["ok"] and rep["device"] == "cpu" and rep["kept_split_dropped"] == 0
    assert rep["fwd_max_abs_diff"] < gpu_parity.IMAGE_ATOL


def test_selfcheck_train_on_cpu(capsys):
    from gsplat_tpu_torch.tools import selfcheck_train

    rc = selfcheck_train.main(["--device", "cpu", "--iters", "40", "--size", "32",
                               "--n_gt", "120", "--n_cams", "8", "--min_psnr", "5"])
    out = capsys.readouterr().out
    assert rc == 0 and out.strip().splitlines()[-1] == "PASS"
    first = float(out.split("initial PSNR ")[1].split()[0])
    final = float(out.split("final PSNR ")[1].split()[0])
    assert final > first


def test_quality_proxy_on_cpu(tmp_path):
    from gsplat_tpu_torch.tools import quality_proxy

    assert quality_proxy.main([str(tmp_path), "--iters", "4", "--width", "32", "--height",
                               "24", "--n_cams", "9", "--n_gt", "150", "--capacity", "512",
                               "--pair_budget", "8192", "--data_device", "cpu"]) == 0
    scene = tmp_path / "scene"
    assert len(list((scene / "images").iterdir())) == 9
    assert png.read_png(scene / "images" / "img_001.png").shape == (24, 32, 3)
    summary = json.loads((tmp_path / "quality_proxy.json").read_text())
    assert list(summary["test_psnr_by_iter"]) == ["4"]
    assert summary["config"] == {"iters": 4, "resolution": "32x24", "n_cams": 9, "n_gt": 150}
    assert (tmp_path / "out" / "chkpnt4.npz").exists()


@pytest.mark.parametrize("tool", ["profile_step", "ab_step"])
def test_step_tools_on_cpu(tool, capsys):
    import importlib

    mod = importlib.import_module(f"gsplat_tpu_torch.tools.{tool}")
    extra = ["--steps", "1", "--top", "3"] if tool == "profile_step" else ["--iters", "1"]
    assert mod.main(["--device", "cpu", "--n", "300", "--size", "32", "32",
                     "--pair_budget", "4096", *extra]) == 0
    out = capsys.readouterr().out
    if tool == "ab_step":
        line = json.loads(out.strip().splitlines()[-1])
        assert line["device"] == "cpu" and line["pairs"] > 0 and np.isfinite(line["loss"])
    else:
        assert out.startswith("== cpu:") and len(out.strip().splitlines()) == 4


def test_tools_need_a_device_by_name(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from gsplat_tpu_torch.tools import make_synthetic_scene

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthetic_scene.main([str(tmp_path / "s")])
