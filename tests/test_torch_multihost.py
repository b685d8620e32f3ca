"""The port's training CLI on a mesh of gloo ranks on the CPU, one process a
rank, against the JAX CLI's single-process run on the same 4x2 mesh
(tests/test_multihost.py's comparison): the same seeds give the same camera
picks, so the final PLYs agree within 1e-6 (xyz, opacity). Also the
torchrun bootstrap, the mesh rule's errors, the launcher stopping every
rank when one fails, and tools/sharded_scale_demo.py. Every process they
start runs niced (torch_port_fixtures.niced).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gsplat_tpu_torch.dist.launch import free_port, run_ranks
from gsplat_tpu_torch.io.ply import load_gaussian_ply
from gsplat_tpu_torch.io.synthetic import make_colmap_scene
from torch_port_fixtures import niced

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_dist_worker.py")
ENV = {"OMP_NUM_THREADS": "1"}
TIMEOUT = 300
# tests/test_multihost.py::test_two_process_sharded_cli's flags (densify at 2,
# 4 and 6, eval at 3), saving at 4 too
SHARDED = ["--shard_gaussians", "--eval", "--iterations", "6", "--densify_from_iter", "1",
           "--densification_interval", "2", "--test_iterations", "3",
           "--save_iterations", "4", "6"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost") / "scene"
    make_colmap_scene(root, n_cams=8, width=48, height=32, n_points=40)
    return root


def jax_split_noise(path, n_draws=4, caps=(64, 128, 256, 512)):
    """The JAX loop's split noise in its key order (PRNGKey(0), one split a
    densify; no random background), each draw at every capacity the run
    may have grown to -> an .npz the port's ranks read."""
    import jax
    import jax.numpy as jnp

    key, out = jax.random.PRNGKey(0), {}
    for i in range(n_draws):
        key, sub = jax.random.split(key)
        for cap in caps:
            out[f"d{i}_{cap}"] = np.asarray(jax.random.normal(sub, (cap, 3), jnp.float32))
    np.savez(path, **out)
    return path


def port_ranks(scene, out_root, world, extra, noise="-"):
    port = free_port()
    res = run_ranks(lambda r: niced([sys.executable, WORKER, "cli", str(noise), str(r),
                                     str(world), str(port), str(scene),
                                     str(out_root / f"out{r}"), "--data_device", "cpu"] + extra),
                    world, TIMEOUT, env=ENV, cwd=str(REPO))
    for r, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {r} exit {rc}:\n{out[-4000:]}"
        assert f"process {r}: rows [{r // 2}] OK" in out
    return res


def jax_single_process(scene, out, extra):
    p = subprocess.run(niced([sys.executable, str(REPO / "scripts" / "multihost_smoke.py"),
                              "0", "1", str(free_port()), str(scene), str(out)] + extra),
                       capture_output=True, text=True, timeout=600, cwd=str(REPO))
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]


def ply(root, it):
    return load_gaussian_ply(root / "point_cloud" / f"iteration_{it}" / "point_cloud.ply")


def test_cli_mesh_matches_jax_single_process(scene, tmp_path):
    """The replicated 4x2 run (4 iterations, no densify): the final PLY
    within 1e-6 of the JAX package's."""
    port_ranks(scene, tmp_path, 8, [])
    # rank 0 alone writes
    assert (tmp_path / "out0" / "metrics.jsonl").exists()
    assert not any((tmp_path / f"out{r}").exists() for r in range(1, 8))
    jax_single_process(scene, tmp_path / "jax", [])
    got, ref = ply(tmp_path / "out0", 4), ply(tmp_path / "jax", 4)
    np.testing.assert_allclose(got["xyz"], ref["xyz"], atol=1e-6)
    np.testing.assert_allclose(got["opacity"], ref["opacity"], atol=1e-6)


def test_cli_sharded_mesh_matches_jax_single_process(scene, tmp_path):
    """--shard_gaussians through densify (at 2, 4, 6; the JAX loop's split
    noise) and an eval: the PLY within 1e-6 of the JAX package's at
    iteration 4 (after the first densify and the eval); at 6, opacity within
    1e-6 and xyz within 1e-4: the split at 4 places its samples through each
    Gaussian's quaternion, which follows its float-noise gradient under Adam
    (the JAX package's own replicated and sharded runs of these flags differ
    by ~1e-5 in xyz at 6). The replicated and sharded steps end on the
    same bits (test_torch_dist.py; chip_smoke.py's train CLI mesh phase
    holds the two CLI runs' PLYs bit-equal)."""
    noise = jax_split_noise(tmp_path / "noise.npz")
    port_ranks(scene, tmp_path / "sha", 8, SHARDED, noise)
    jax_single_process(scene, tmp_path / "jax", SHARDED)
    recs = [json.loads(line) for line in open(tmp_path / "sha" / "out0" / "metrics.jsonl")]
    assert any("test_psnr" in r for r in recs), recs
    for it, xyz_tol in ((4, 1e-6), (6, 1e-4)):
        got, ref = ply(tmp_path / "sha" / "out0", it), ply(tmp_path / "jax", it)
        assert got["xyz"].shape == ref["xyz"].shape and got["xyz"].shape[0] > 40
        np.testing.assert_allclose(got["xyz"], ref["xyz"], atol=xyz_tol)
        np.testing.assert_allclose(got["opacity"], ref["opacity"], atol=1e-6)


def test_cli_under_torchrun_environment(scene, tmp_path):
    """RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT / LOCAL_RANK (what
    torchrun sets) join a 2x1 mesh without the three flags; rank 0 prints
    the parameters and the banner naming the backend rule, rank 1 stays
    silent. A pair budget too small for the views regrows at iteration 10
    on every rank alike (the dropped pairs are summed over the world), and
    the run ends."""
    port = free_port()
    args = ["-s", str(scene), "--data_device", "cpu", "--iterations", "12", "--capacity",
            "64", "--pair_budget", "64", "--chunk_size", "32", "--tile_size", "16",
            "--data_axis", "-1", "--tile_axis", "1", "--densify_from_iter", "100",
            "--test_iterations"]
    res = run_ranks(lambda r: niced([sys.executable, "-m", "gsplat_tpu_torch.cli", "-m",
                                     str(tmp_path / "env")] + args),
                    2, TIMEOUT, cwd=str(REPO),
                    env=dict(ENV, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                             WORLD_SIZE="2"),
                    env_of_rank=lambda r: {"RANK": str(r), "LOCAL_RANK": str(r)})
    assert [rc for rc, _ in res] == [0, 0], res[0][1][-3000:] + res[1][1][-3000:]
    out0, out1 = res[0][1], res[1][1]
    assert "> Mesh parameters:" in out0 and "> Mesh parameters:" not in out1
    assert "SPMD: 2-camera batches x 1 tile bands" in out0
    assert "backend gloo (2 rank(s) on the CPU)" in out0
    assert "[iter 10] pair budget 64 -> 128" in out0
    assert (tmp_path / "env" / "point_cloud" / "iteration_12" / "point_cloud.ply").exists()


@pytest.mark.parametrize("case", ["world", "capacity"])
def test_cli_mesh_rule_raises(scene, tmp_path, case):
    """Two ranks for a 2x2 mesh (the world must be data x tile), and
    --shard_gaussians over a capacity that does not divide by data_axis,
    stop every rank with the rule's message."""
    extra = (["--data_axis", "2", "--tile_axis", "2"] if case == "world" else
             ["--data_axis", "2", "--tile_axis", "1", "--capacity", "65",
              "--shard_gaussians"])
    port = free_port()
    res = run_ranks(lambda r: niced([sys.executable, WORKER, "cli", "-", str(r), "2", str(port),
                                     str(scene), str(tmp_path / f"out{r}"), "--data_device",
                                     "cpu"] + extra), 2, TIMEOUT, env=ENV, cwd=str(REPO))
    want = ("world size must equal data_axis * tile_axis" if case == "world"
            else "capacity % data_axis == 0")
    assert all(rc != 0 for rc, _ in res)
    assert all(want in out for _, out in res), [out[-2000:] for _, out in res]


def test_ranks_read_a_fresh_source_at_once(tmp_path):
    """Every rank of a mesh loads the Scene: the first load of a COLMAP
    source converts points3D.bin to points3D.ply, and ranks that convert at
    once each rename a whole file into place (no rank reads a partial one)."""
    make_colmap_scene(tmp_path / "fresh", n_cams=4, width=48, height=32, n_points=3000)
    code = ("import sys; from gsplat_tpu_torch.io.dataset import read_colmap_scene_info; "
            "info = read_colmap_scene_info(sys.argv[1], 'images', False, 8, "
            "load_images=False); print(len(info.point_cloud.points))")
    res = run_ranks(lambda r: niced([sys.executable, "-c", code, str(tmp_path / "fresh")]), 8,
                    TIMEOUT, env=ENV, cwd=str(REPO))
    assert all(rc == 0 and out.strip().endswith("3000") for rc, out in res), res
    sparse = tmp_path / "fresh" / "sparse" / "0"
    assert (sparse / "points3D.ply").exists()
    assert [p.name for p in sparse.iterdir() if p.name.startswith(".")] == []


def test_run_ranks_stops_every_rank_when_one_fails():
    """A rank that fails ends the run at once: the others are killed, not
    waited for."""
    import time

    t0 = time.monotonic()
    res = run_ranks(lambda r: [sys.executable, "-c",
                               "import sys, time; time.sleep(0.5); sys.exit(3)" if r == 0
                               else "import time; time.sleep(120)"], 3, 60)
    assert time.monotonic() - t0 < 30
    assert res[0][0] == 3 and all(rc < 0 for rc, _ in res[1:])


def test_sharded_scale_demo_tool():
    p = subprocess.run(niced([sys.executable, "-m", "gsplat_tpu_torch.tools.sharded_scale_demo",
                              "--capacity", "4096", "--data", "2", "--tile", "2", "--device",
                              "cpu"]),
                       capture_output=True, text=True, timeout=TIMEOUT, cwd=str(REPO))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["ok"] and len(res["ranks"]) == 4
    for r in res["ranks"]:
        assert r["rows"] == 2048 and r["n_dropped"] == 0
        assert 2 * r["state_bytes_sharded"] == r["state_bytes_replicated"]
