"""The port's headline benchmark (gsplat_tpu_torch/tools/bench.py, run by
bench_torch.py) and its scene.

tools/bench_scene.build_scene against bench.py::build_scene, with and
without anisotropy, at both bench densities: the live rows, the live count,
the camera's matrices and the target image bit-equal. bench.py runs once, in
a subprocess (importing it points JAX's compile cache at a directory and
installs kernel cache keys for the whole process), and writes its arrays to
an .npz. No JAX render runs.

The tool on the CPU (the kernels' plain versions; its budget fits are
tested in test_torch_budgets.py): `main`'s JSON line (bench.py's
keys, renamed and added as the tool's docstring says) at a tiny scene, its
counts equal to a direct render's; the three passes of `run_config` on a
scene where all three run; and `main` without a card.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.core.gaussians import pad_fill
from gsplat_tpu_torch.render import budgets
from gsplat_tpu_torch.render.binning import bin_gaussians
from gsplat_tpu_torch.render.project import project_gaussians
from gsplat_tpu_torch.render.render import render
from gsplat_tpu_torch.tools import bench
from gsplat_tpu_torch.tools.bench_scene import fwd_bwd, scene_on_device

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N, W, H = 300, 64, 48
SCENES = [(aniso, ppg) for aniso in (0.0, 0.5) for ppg in (2.25, 33.0)]
LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
CAM = ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy", "image")
CPU = torch.device("cpu")


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def jax_scenes(tmp_path_factory):
    """bench.py::build_scene's arrays of every case of SCENES, from one
    subprocess -> {name: array}."""
    tmp = tmp_path_factory.mktemp("bench_py")
    out = tmp / "scenes.npz"
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import bench\n"
        "arrays = {}\n"
        f"for aniso, ppg in {SCENES!r}:\n"
        f"    g, cam = bench.build_scene({N}, {W}, {H}, target_pairs_per_gaussian=ppg,\n"
        "                               tile_size=32, aniso=aniso)\n"
        "    tag = f'{aniso}_{ppg}'\n"
        f"    for k in {LEAVES!r} + ('n_live',):\n"
        "        arrays[f'{tag}/{k}'] = np.asarray(getattr(g, k))\n"
        f"    for k in {CAM!r}:\n"
        "        arrays[f'{tag}/cam_{k}'] = np.asarray(getattr(cam, k))\n"
        f"np.savez({str(out)!r}, **arrays)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", GSPLAT_CACHE_DIR=str(tmp / "jax_cache"))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    with np.load(out) as z:
        return dict(z)


@pytest.mark.parametrize("aniso, ppg", SCENES, ids=[f"aniso{a}-ppg{p}" for a, p in SCENES])
def test_build_scene_matches_bench_py(jax_scenes, aniso, ppg):
    """The live rows, n_live, the camera and the target bit-equal to
    bench.py's. The padded rows are the port's inert template (bench.py
    fills opacity and scaling with -30 and the rest with zeros or the
    identity): the test holds them to the template, and n_live masks them
    out of the projection."""
    g, cam = scene_on_device(N, W, H, target_pairs_per_gaussian=ppg, tile_size=32,
                             device="cpu", aniso=aniso)
    tag = f"{aniso}_{ppg}"
    assert int(g.n_live) == int(jax_scenes[f"{tag}/n_live"]) == N
    assert g.capacity == jax_scenes[f"{tag}/xyz"].shape[0]
    for k in LEAVES:
        got, want = getattr(g, k).numpy(), jax_scenes[f"{tag}/{k}"]
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(bits(got[:N]), bits(want[:N]), err_msg=k)
        np.testing.assert_array_equal(got[N:], pad_fill(k, got[N:].shape, "cpu").numpy(),
                                      err_msg=f"{k} padding")
    for k in CAM:
        np.testing.assert_array_equal(bits(getattr(cam, k).numpy()),
                                      bits(jax_scenes[f"{tag}/cam_{k}"]), err_msg=k)
    if aniso > 0:      # the stretch and the random quaternions are there
        assert not np.array_equal(g.scaling[:N, 0].numpy(), g.scaling[:N, 1].numpy())
        assert not np.allclose(np.linalg.norm(g.rotation[:N].numpy(), axis=1), 1.0)
    p = project_gaussians(g, cam)
    assert not bool(g.live_mask[N:].any())
    assert int((p.radius[N:] != 0).sum()) == 0 and int((p.radius[:N] > 0).sum()) > 0


def expected_keys():
    """BENCH_r05.json's keys with the tool's renames and additions."""
    keys = set(json.loads((REPO / "BENCH_r05.json").read_text())["parsed"])
    renamed = {"vpu_sol_ms": "fp32_sol_ms", "dense_vpu_sol_ms": "dense_fp32_sol_ms",
               "vs_vpu_sol": "vs_fp32_sol", "vs_vpu_sol_synced": "vs_fp32_sol_synced",
               "compile_s": "first_call_s"}
    keys = (keys - set(renamed)) | set(renamed.values())
    timed = {p + k for p in ("", "dense_") for k in bench.TIMED}
    assert timed <= keys
    return keys | {bench.device_key(k) for k in timed} | {
        "power_limit", "peak_memory_bytes", "dense_peak_memory_bytes", "n_dropped",
        "dense_n_dropped"}


def plain_counts(n, size, ppg, budget, tile, chunk):
    """A direct forward render of the tool's scene at its plain pass's
    budget -> (pairs, culled, contrib, dropped)."""
    g, cam = scene_on_device(n, *size, target_pairs_per_gaussian=ppg, tile_size=32,
                             device="cpu")
    with torch.no_grad():
        out = render(cam, g, torch.zeros(3), tile_size=tile, chunk=chunk, pair_budget=budget)
    return int(out.n_pairs), int(out.n_culled), int(out.n_contrib), int(out.n_dropped)


def test_main_cpu_json_line(capsys):
    """`main --device cpu` at 200 Gaussians, 64x48: bench.py's smoke branch
    (tile 16, chunk 32, budgets 1 << 14 and 1 << 17, the plain pass only):
    one JSON line, the last of stdout, with the expected keys; no device
    metric, no peak share; its counts equal a direct render's."""
    assert bench.main(["--device", "cpu", "--n", "200", "--size", "64", "48"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    got = json.loads(out[-1])
    assert set(got) == expected_keys()
    assert got["metric"] == "pixels_per_s_cpu_smoke" and got["backend"] == "cpu"
    assert got["device"] == "cpu" and got["power_limit"] is None
    assert got["n_gaussians"] == 200 and got["resolution"] == "64x48"
    assert got["tile_size"] == 16
    for key in ("vs_baseline", "vs_fp32_sol", "vs_fp32_sol_synced", "fp32_sol_ms",
                "dense_fp32_sol_ms", "peak_memory_bytes", "dense_peak_memory_bytes"):
        assert got[key] is None, key
    assert all(got[k] is None for k in got if k.endswith("_device_ms"))
    for prefix in ("", "dense_"):
        for key in ("train_step_ms", "step_ms", "plain_step_ms", "pipelined_step_ms"):
            assert math.isfinite(got[prefix + key]) and got[prefix + key] > 0
        for key in ("kept_step_ms", "sat_step_ms", "kept_pipelined_ms", "sat_pipelined_ms"):
            assert got[prefix + key] is None
        assert got[prefix + "sat_kept"] == 0 and got[prefix + "n_dropped"] == 0
    assert got["value"] == 64 * 48 / (got["train_step_ms"] / 1e3)
    assert math.isfinite(got["loss"]) and got["first_call_s"] > 0
    for prefix, ppg, budget in (("", 4.0, 1 << 14), ("dense_", 36.0, 1 << 17)):
        pairs, culled, contrib, dropped = plain_counts(200, (64, 48), ppg, budget, 16, 32)
        assert dropped == 0
        assert got[prefix + "culled"] == culled and got[prefix + "contrib"] == contrib
        assert got[prefix + "pairs_per_pixel"] == pairs / (64 * 48)
        if not prefix:
            assert got["pairs"] == pairs


def test_run_config_three_passes(monkeypatch):
    """run_config with auto_kept on a scene where the probe culls pairs and
    the saturation cull leaves fewer rows than the kept budget: the kept
    and sat passes run, their times and counts are those of direct renders
    at the budgets bench.py's formulas fit, with no dropped pair."""
    monkeypatch.setattr(bench, "PIPELINE", 2)
    n, (w, h), ppg, budget, tile, chunk = 200, (128, 96), 36.0, 1 << 17, 16, 32
    res = bench.run_config(n, w, h, tile_size=tile, chunk=chunk, pair_budget=budget,
                           iters=1, device=CPU, target_pairs_per_gaussian=ppg,
                           auto_kept=True)
    pairs, plain_culled, contrib, dropped = plain_counts(n, (w, h), ppg, budget, tile, chunk)
    assert dropped == 0 and plain_culled == 0       # the budget is past 8 x capacity
    assert (res["pairs"], res["contrib"], res["n_dropped"]) == (pairs, contrib, 0)

    g, cam = scene_on_device(n, w, h, target_pairs_per_gaussian=ppg, tile_size=32,
                             device="cpu")
    bg = torch.zeros(3)
    p = project_gaussians(g, cam)
    b = bin_gaussians(p.mean2d, p.radius, p.depth, width=w, height=h, tile_size=tile,
                      chunk=chunk, pair_budget=budget, cull_conic=p.conic,
                      cull_opacity=p.opacity, kept_budget=budget - chunk)
    assert res["culled"] == int(b.n_culled) > 0
    pair_fit = budgets.fit_pair_bench(pairs, budget, chunk)
    kept = budgets.fit_kept(pairs, int(b.n_culled), chunk)
    contrib_fit = budgets.fit_contrib(contrib)
    fitted = dict(tile_size=tile, chunk=chunk, pair_budget=pair_fit, kept_budget=kept,
                  contrib_budget=contrib_fit)
    with torch.no_grad():
        probe = render(cam, g, bg, sat_budget=pair_fit, **fitted)
    assert res["sat_kept"] == int(probe.n_sat)
    sat = budgets.fit_sat_bench(int(probe.n_sat), int(probe.n_dropped), kept, chunk)
    assert sat is not None
    for kw in ({}, {"sat_budget": sat}):
        loss, out, grads = fwd_bwd(g, cam, bg, **fitted, **kw)
        assert int(out.n_dropped) == 0 and int(out.n_contrib) <= contrib_fit
    loss, _, _ = fwd_bwd(g, cam, bg, tile_size=tile, chunk=chunk, pair_budget=budget)
    assert res["loss"] == float(loss)
    for key in ("plain_step_ms", "kept_step_ms", "sat_step_ms", "pipelined_step_ms",
                "kept_pipelined_ms", "sat_pipelined_ms"):
        assert math.isfinite(res[key]) and res[key] > 0, key
        assert res[bench.device_key(key)] is None
    assert res["step_ms"] == min(res[k] for k in ("plain_step_ms", "kept_step_ms",
                                                  "sat_step_ms"))
    assert res["train_step_ms"] == min(res[k] for k in (
        "pipelined_step_ms", "kept_pipelined_ms", "sat_pipelined_ms"))


def test_main_without_card_names_it(monkeypatch):
    """No card and no --device: main raises, naming the missing device, and
    bench_torch.py exits nonzero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    p = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "no CUDA device" in p.stderr and not p.stdout.strip()
