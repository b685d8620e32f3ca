"""The port's mesh (gsplat_tpu_torch/dist/) against the JAX package's
gsplat_tpu/dist/ on the CPU.

The JAX steps run on virtual CPU devices (tests/conftest.py); the port runs
one gloo rank a mesh cell, each a subprocess of tests/torch_dist_worker.py
started by dist.launch.run_ranks, on the same numpy scene. Tolerances are
tests/test_spmd.py's: loss rtol 1e-5, xyz and Adam mu atol 1e-6, the
densification accumulators atol 1e-6 (max radii 1e-5, denom equal); images
2e-5.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.config import MeshParams, OptimizationParams
from gsplat_tpu_torch.core.camera import make_camera
from gsplat_tpu_torch.core.gaussians import create_from_pcd
from gsplat_tpu_torch.dist.launch import free_port, run_ranks
from gsplat_tpu_torch.dist.mesh import make_mesh
from gsplat_tpu_torch.dist.spmd import _band_height, stack_cameras
from gsplat_tpu_torch.interop import gaussians_from_numpy, gaussians_to_numpy
from gsplat_tpu_torch.io.synthetic import look_at_rig
from gsplat_tpu_torch.render.render import render
from gsplat_tpu_torch.train.densify import add_densification_stats
from gsplat_tpu_torch.train.loop import make_train_step
from gsplat_tpu_torch.train.loss import photometric_loss
from gsplat_tpu_torch.train.optim import adam_update, current_lrs, init_adam_state, make_lr_fns
from torch_port_fixtures import niced

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_dist_worker.py")
FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "max_radii2D",
          "xyz_gradient_accum", "denom")
W, H = 64, 32
MP = MeshParams(tile_size=16, chunk_size=32, pair_budget=1 << 12)
RANK_TIMEOUT = 240


def spmd_scene(n_cams, seed):
    """tests/test_spmd.py::scene in numpy: 30 points in a 64-row capacity,
    look_at_rig cameras, random 64x32 targets -> (Gaussians fields, cams
    as (R, T, image))."""
    rng = np.random.default_rng(seed)
    n = 30
    pts, cols = rng.normal(size=(n, 3)) * 0.5, rng.random((n, 3))
    g = gaussians_to_numpy(create_from_pcd(pts, cols, capacity=64, device="cpu"))
    cams = [(R, T, rng.random((H, W, 3)).astype(np.float32)) for R, T in look_at_rig(n_cams)]
    return g, cams


def tiny_scene(n_cams, n_points=40, capacity=64, width=64, height=32, seed=0):
    """__graft_entry__.py::_tiny_scene in numpy."""
    rng = np.random.default_rng(seed)
    pts, cols = rng.normal(size=(n_points, 3)) * 0.5, rng.random((n_points, 3))
    g = gaussians_to_numpy(create_from_pcd(pts, cols, capacity=capacity, device="cpu"))
    cams = []
    for i in range(n_cams):
        ang = 2 * math.pi * i / max(n_cams, 1)
        pos = np.array([4.0 * math.sin(ang), 0.0, 4.0 * math.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(fwd, right), fwd])
        img = rng.random((height, width, 3)).astype(np.float32)
        cams.append((R_w2c.T, -R_w2c @ pos, img))
    return g, cams


def run_port(tmp, g, cams, data, tile, evaluate=True):
    """Every rank of a data x tile gloo mesh runs torch_dist_worker.py's
    steps -> [rank outputs]."""
    tmp.mkdir(parents=True, exist_ok=True)
    inp = tmp / "in.npz"
    np.savez(inp, **{k: g[k] for k in FIELDS}, n_live=g["n_live"], active_sh=0, max_sh=3,
             R=np.stack([c[0] for c in cams]), T=np.stack([c[1] for c in cams]),
             images=np.stack([c[2] for c in cams]), fovx=0.9, fovy=0.6, W=W, H=H,
             data=data, tile=tile, tile_size=MP.tile_size, chunk=MP.chunk_size,
             budget=MP.pair_budget, eval=evaluate)
    world, port = data * tile, free_port()
    res = run_ranks(lambda r: niced([sys.executable, WORKER, "steps", str(r), str(world),
                                     str(port), str(inp), str(tmp)]), world, RANK_TIMEOUT,
                    env={"OMP_NUM_THREADS": "1"}, cwd=str(REPO))
    for r, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {r} exit {rc}:\n{out[-4000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def port_cams(cams):
    return [make_camera(R, T, fovx=0.9, fovy=0.6, width=W, height=H, image=img, device="cpu")
            for R, T, img in cams]


def port_g(g):
    return gaussians_from_numpy({k: g[k] for k in FIELDS}, int(g["n_live"]), 0, 3,
                                device="cpu")


def assert_step_matches(got, ref, prefix):
    """tests/test_spmd.py's checks of one step against its reference."""
    np.testing.assert_allclose(float(got[prefix + "loss"]), float(ref["loss"]), rtol=1e-5)
    assert int(got[prefix + "n_dropped"]) == 0 and int(got[prefix + "n_pairs"]) > 0
    np.testing.assert_allclose(got[prefix + "xyz"], ref["xyz"], atol=1e-6)
    np.testing.assert_allclose(got[prefix + "mu_opacity"], ref["mu_opacity"], atol=1e-6)
    np.testing.assert_allclose(got[prefix + "xyz_gradient_accum"], ref["xyz_gradient_accum"],
                               atol=1e-6)
    np.testing.assert_array_equal(got[prefix + "denom"], ref["denom"])
    np.testing.assert_allclose(got[prefix + "max_radii2D"], ref["max_radii2D"], atol=1e-5)


def assert_rep_sha_same_bits(outs):
    """Both steps add the same gradients in the same order: the replicated
    and the sharded step end on the same bits, on every rank."""
    keys = [k[4:] for k in outs[0] if k.startswith("rep_") and "grad" not in k
            and "sha_" + k[4:] in outs[0]]
    assert "xyz" in keys and "nu_rotation" in keys and "loss" in keys
    for res in outs:
        for k in keys:
            np.testing.assert_array_equal(res["sha_" + k], res["rep_" + k], err_msg=k)
            np.testing.assert_array_equal(res["rep_" + k], outs[0]["rep_" + k], err_msg=k)


# ------------------------------------------------------------- the JAX package


@pytest.fixture(scope="module")
def jax_2x2():
    """The JAX replicated and sharded steps and the eval step on a 2x2 mesh
    of virtual CPU devices (test_spmd.py's scene, seed 7)."""
    import jax
    import jax.numpy as jnp

    from gsplat_tpu.config import MeshParams as JMeshParams
    from gsplat_tpu.config import OptimizationParams as JOpt
    from gsplat_tpu.core.camera import make_camera as jcam
    from gsplat_tpu.core.gaussians import Gaussians
    from gsplat_tpu.dist.data import shard_gaussians
    from gsplat_tpu.dist.mesh import make_mesh as jmesh
    from gsplat_tpu.dist.spmd import (make_sharded_spmd_train_step, make_spmd_eval_step,
                                      make_spmd_train_step as jstep, stack_cameras as jstack)
    from gsplat_tpu.train.optim import init_adam_state as jinit

    g_np, cams = spmd_scene(2, seed=7)
    g = Gaussians(**{k: jnp.asarray(g_np[k]) for k in FIELDS},
                  n_live=jnp.asarray(g_np["n_live"]), active_sh_degree=0, max_sh_degree=3)
    jcams = [jcam(R, T, fovx=0.9, fovy=0.6, width=W, height=H, image=img)
             for R, T, img in cams]
    mesh = jmesh(data=2, tile=2, devices=jax.devices()[:4])
    mp = JMeshParams(tile_size=16, chunk_size=32, pair_budget=1 << 12)
    st = jinit(g.params())
    args = (jstack(jcams), jnp.zeros(3), jnp.asarray(1, jnp.int32), jnp.zeros((), jnp.float32))
    out = {}
    for prefix, fn, state in (
            ("rep_", jstep(mesh, JOpt(), mp, 1.0, W, H, interpret=True), (g, st)),
            ("sha_", make_sharded_spmd_train_step(mesh, JOpt(), mp, 1.0, W, H,
                                                  interpret=True),
             shard_gaussians(mesh, g, st))):
        g1, st1, loss, _, n_pairs, nd, *_ = fn(*state, *args)
        out[prefix] = dict({k: np.asarray(getattr(g1, k)) for k in FIELDS},
                           loss=float(loss), mu_opacity=np.asarray(st1.mu["opacity"]))
    loss, p, img, nd = make_spmd_eval_step(mesh, mp, 0.2, W, H, interpret=True)(
        g, jcams[0], jnp.zeros(3))
    out["eval"] = dict(loss=float(loss), psnr=float(p), image=np.asarray(img), nd=int(nd))
    return g_np, cams, out


@pytest.fixture(scope="module")
def port_2x2(jax_2x2, tmp_path_factory):
    g_np, cams, _ = jax_2x2
    return run_port(tmp_path_factory.mktemp("port_2x2"), g_np, cams, 2, 2)


def test_make_mesh_layout_matches_jax(port_2x2):
    """Rank r sits where device r sits in the JAX mesh; its tile group is
    its mesh row, its data group its column."""
    import jax

    from gsplat_tpu.dist.mesh import make_mesh as jmesh

    layout = np.vectorize(lambda d: d.id)(
        jmesh(data=2, tile=2, devices=jax.devices()[:4]).devices)
    for r, res in enumerate(port_2x2):
        d, t = int(res["d"]), int(res["t"])
        assert layout[d, t] == r
        assert list(res["tile_ranks"]) == list(layout[d, :])
        assert list(res["data_ranks"]) == list(layout[:, t])


def test_shard_gather_round_trip(port_2x2):
    """shard_gaussians keeps 1/n_data of every row leaf; the gather gives
    back the model and the Adam state bit for bit."""
    for res in port_2x2:
        assert int(res["shard_rows"]) == 32 and bool(res["shard_round_trip"])


@pytest.mark.parametrize("kind", ["rep_", "sha_"], ids=["replicated", "sharded"])
def test_2x2_step_matches_jax(jax_2x2, port_2x2, kind):
    _, _, ref = jax_2x2
    for res in port_2x2:
        assert_step_matches(res, ref[kind], kind)
    # every rank ends with the same model, bit for bit
    for res in port_2x2[1:]:
        for k in FIELDS:
            np.testing.assert_array_equal(res[kind + k], port_2x2[0][kind + k], err_msg=k)


def test_2x2_replicated_and_sharded_same_bits(port_2x2):
    assert_rep_sha_same_bits(port_2x2)


def test_eval_step_matches_jax(jax_2x2, port_2x2):
    _, _, ref = jax_2x2
    for res in port_2x2:
        np.testing.assert_allclose(res["eval_image"], ref["eval"]["image"], atol=2e-5)
        np.testing.assert_allclose(float(res["eval_loss"]), ref["eval"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(res["eval_psnr"]), ref["eval"]["psnr"], rtol=1e-5)
        assert int(res["eval_n_dropped"]) == ref["eval"]["nd"] == 0


def test_band_render_matches_jax_region():
    """render(region=(y0, band_h)) against the JAX package's at one tiny
    shape: the band's image within 2e-5."""
    import jax.numpy as jnp

    from gsplat_tpu.render.render import render as jrender
    from tests.torch_port_fixtures import make_scene, jax_objects, torch_objects

    s = make_scene()
    jg, jc = jax_objects(s)
    tg, tc = torch_objects(s)
    kw = dict(tile_size=16, chunk=32, pair_budget=1 << 12)
    ref = jrender(jc, jg, jnp.zeros(3), region=(16, 16), **kw).image
    got = render(tc, tg, torch.zeros(3), region=(16, 16), **kw).image
    assert got.shape == (16, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


# ------------------------------------------------------------- the port alone


def test_band_render_against_full():
    """Bands agree with the full render's rows within 2e-5; the region (0,
    band_h) with band_h the height rounded up to a tile is the full render's
    bits, and so is its gradient."""
    from tests.torch_port_fixtures import make_scene, torch_objects

    s = make_scene()
    g, cam = torch_objects(s)
    kw = dict(tile_size=16, chunk=32, pair_budget=1 << 12)
    full = render(cam, g, torch.zeros(3), **kw).image
    for y0 in (0, 16, 32):
        band = render(cam, g, torch.zeros(3), region=(y0, 16), **kw).image
        np.testing.assert_allclose(band.numpy(), full[y0:y0 + 16].numpy(), atol=2e-5)

    def grads(region):
        xyz = g.xyz.detach().requires_grad_()
        with torch.enable_grad():
            img = render(cam, g.replace(xyz=xyz), torch.zeros(3), region=region, **kw).image
            (gx,) = torch.autograd.grad((img[:cam.height] ** 2).sum(), [xyz])
        return img, gx

    img_r, g_r = grads((0, _band_height(cam.height, 1, 16)))
    img_f, g_f = grads(None)
    assert torch.equal(img_r[:cam.height], img_f) and torch.equal(g_r, g_f)


def test_band_lead_lays_pairs_on_the_full_frames_chunk_grid():
    """bin_gaussians(lead=...) with the kept pairs of the tiles above: each
    of the band's tiles starts at the full frame's offset modulo the chunk,
    with the same count and the same sorted gids (the compositors' chunk
    sweep and whole-tile exit then see the full frame's layout)."""
    from gsplat_tpu_torch.render.binning import bin_gaussians, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians
    from tests.torch_port_fixtures import make_scene, torch_objects

    g, cam = torch_objects(make_scene())
    p = project_gaussians(g, cam)
    kw = dict(tile_size=16, chunk=32, pair_budget=1 << 12, cull_conic=p.conic,
              cull_opacity=p.opacity, kept_budget=(1 << 12) - 32)
    full = bin_gaussians(p.mean2d, p.radius, p.depth, width=cam.width, height=cam.height,
                         **kw)
    tw, th = tile_grid(cam.width, cam.height, 16)
    shift = torch.tensor([0.0, 16.0])
    row = slice(tw, 2 * tw)                       # tile row 1: the band (16, 16)
    above = int(full.tile_count[:tw].sum())
    band = bin_gaussians(p.mean2d - shift, p.radius, p.depth, width=cam.width, height=16,
                         key_tiles=tw * th, lead=lambda kept: torch.tensor(above), **kw)
    assert above % 32 and int(band.tile_count.sum()) > 0
    assert torch.equal(band.tile_count, full.tile_count[row])
    assert torch.equal(band.tile_start % 32, full.tile_start[row] % 32)
    for i in range(tw):
        a, n = int(band.tile_start[i]), int(band.tile_count[i])
        b = int(full.tile_start[tw + i])
        assert torch.equal(band.gid_s[a:a + n], full.gid_s[b:b + n])


def test_make_mesh_without_process_group():
    mesh = make_mesh(1, 1)
    assert (mesh.d, mesh.t, mesh.shape) == (0, 0, {"data": 1, "tile": 1})
    with pytest.raises(ValueError, match="one process a mesh cell"):
        make_mesh(2, 2)


def reference_batch_step(g, cams, opt):
    """One device: the mean loss over the camera batch, one Adam step, and
    each view's own screen-space gradient and radii for the densification
    statistics (tests/test_spmd.py::reference_batch_step with the port)."""
    params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
    kw = dict(tile_size=MP.tile_size, chunk=MP.chunk_size, pair_budget=MP.pair_budget)
    with torch.enable_grad():
        loss = torch.stack([photometric_loss(render(c, g.replace(**params), torch.zeros(3),
                                                    **kw).image, c.image, opt.lambda_dssim)
                            for c in cams]).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
    new, st = adam_update({k: v.detach() for k, v in params.items()}, dict(zip(params, grads)),
                          init_adam_state(g.params()), current_lrs(make_lr_fns(opt, 1.0), 1))
    g_new = g.replace(**new)
    for c in cams:
        off = torch.zeros((g.capacity, 2), requires_grad=True)
        with torch.enable_grad():
            out = render(c, g, torch.zeros(3), mean2d_offset=off, **kw)
            (og,) = torch.autograd.grad(photometric_loss(out.image, c.image,
                                                         opt.lambda_dssim), [off])
        g_new = add_densification_stats(g_new, og, out.radii, W, H)
    ref = {k: getattr(g_new, k).numpy() for k in FIELDS}
    ref.update(loss=float(loss.detach()), mu_opacity=st.mu["opacity"].numpy())
    return ref, dict(zip(params, grads))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_mesh_matches_batch_reference(tmp_path, shape):
    data, tile = shape
    g_np, cams = spmd_scene(data, seed=3)
    outs = run_port(tmp_path, g_np, cams, data, tile, evaluate=False)
    ref, grads = reference_batch_step(port_g(g_np), port_cams(cams), OptimizationParams())
    assert_rep_sha_same_bits(outs)
    for res in outs:
        for kind in ("rep_", "sha_"):
            assert_step_matches(res, ref, kind)
        for k, v in grads.items():
            np.testing.assert_allclose(res["rep_grad_" + k], v.numpy(), rtol=0,
                                       atol=2e-6 * max(float(v.abs().max()), 1e-12))


def test_1x1_mesh_is_make_train_step(tmp_path):
    """A world of one gloo rank: the replicated and the sharded mesh steps
    give make_train_step's bits."""
    g_np, cams = spmd_scene(1, seed=5)
    (res,) = run_port(tmp_path, g_np, cams, 1, 1, evaluate=False)
    g = port_g(g_np)
    (cam,) = port_cams(cams)
    out = make_train_step(OptimizationParams(), MP, 1.0, W, H)(
        g, init_adam_state(g.params()), cam, torch.zeros(3), 1, torch.zeros(()))
    for kind in ("rep_", "sha_"):
        assert res[kind + "loss"] == out[2].numpy()
        for k in FIELDS:
            np.testing.assert_array_equal(res[kind + k], getattr(out[0], k).numpy(), err_msg=k)
        for k in out[1].mu:
            np.testing.assert_array_equal(res[f"{kind}mu_{k}"], out[1].mu[k].numpy())
            np.testing.assert_array_equal(res[f"{kind}nu_{k}"], out[1].nu[k].numpy())


def test_multichip_record_4x2(tmp_path):
    """MULTICHIP_r05.json: on a 4x2 mesh over __graft_entry__.py's tiny scene
    the JAX step's loss is 0.49170 (printed to 5 decimals), replicated and
    sharded; the port's eight ranks give it within 1e-5."""
    g_np, cams = tiny_scene(4)
    outs = run_port(tmp_path, g_np, cams, 4, 2, evaluate=False)
    assert_rep_sha_same_bits(outs)
    for res in outs:
        for kind in ("rep_", "sha_"):
            assert abs(float(res[kind + "loss"]) - 0.49170) <= 1e-5, (kind,
                                                                     float(res[kind + "loss"]))
            assert int(res[kind + "n_dropped"]) == 0


def test_stack_cameras():
    """stack_cameras stacks the matrices and images of a batch; a mixed
    batch raises."""
    _, cams = spmd_scene(2, seed=1)
    batch = stack_cameras(port_cams(cams))
    assert batch.world_view.shape == (2, 4, 4) and batch.image.shape == (2, H, W, 3)
    other = make_camera(cams[0][0], cams[0][1], 0.9, 0.6, W + 16, H, device="cpu")
    with pytest.raises(ValueError, match="mixed resolutions"):
        stack_cameras(port_cams(cams) + [other])


def test_backend_rule_two_hosts_of_eight_cards():
    """16 CUDA ranks on 2 hosts of 8 cards, the flags' layout read from the
    rendezvous store: each rank counts the 8 on its own host, so the rule
    takes nccl and rank r drives card r mod 8. Four ranks on a one-card host
    share it: gloo."""
    import torch.distributed as dist

    from gsplat_tpu_torch.dist.mesh import choose_backend, store_layout

    store = dist.HashStore()
    hosts = ["node-a"] * 8 + ["node-b"] * 8
    for r in range(16):
        store.set(f"gsplat_host/{r}", hosts[r])
    for r in range(16):
        local_rank, local_world = store_layout(store, r, 16, hosts[r])
        assert (local_rank, local_world) == (r % 8, 8)
        assert choose_backend("cuda", local_world, 8) == "nccl"
    assert choose_backend("cuda", 16, 8) == "gloo"      # what counting the world gave
    one = dist.HashStore()
    for r in range(4):
        one.set(f"gsplat_host/{r}", "h100")
    assert all(choose_backend("cuda", store_layout(one, r, 4, "h100")[1], 1) == "gloo"
               for r in range(4))
    assert choose_backend("cpu", 1, 0) == "gloo"


def test_env_layout_needs_local_world_size_past_the_cards(monkeypatch):
    """A launcher's RANK/WORLD_SIZE without LOCAL_WORLD_SIZE: CUDA ranks
    beyond this host's cards raise (shared cards or more hosts cannot be
    told apart); within them, or on the CPU, the world is this host's."""
    from gsplat_tpu_torch.dist.mesh import env_layout

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
        env_layout(16, "cuda", 8)
    assert env_layout(8, "cuda", 8) == (3, 8)
    assert env_layout(16, "cpu", 0) == (3, 16)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert env_layout(16, "cuda", 8) == (3, 8)


def test_collectives_take_the_backends_device(monkeypatch):
    """Each collective hands its backend tensors where the backend takes
    them: this rank's card under nccl, whatever device the caller built
    the tensor on; host memory under gloo."""
    from gsplat_tpu_torch.dist import collectives as C

    monkeypatch.setattr(C.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert C.wire_device(None) == torch.device("cuda", 2)
    monkeypatch.setattr(C.dist, "get_backend", lambda group=None: "gloo")
    assert C.wire_device(None) == torch.device("cpu")


def test_agree_builds_its_vector_on_the_ranks_device(monkeypatch):
    """train()'s agreement on buffer sizes hands the collective a vector on
    the rank's device (a card under nccl), not a host tensor."""
    from gsplat_tpu_torch.dist import collectives as C
    from gsplat_tpu_torch.dist.mesh import Mesh
    from gsplat_tpu_torch.train import loop

    seen = []

    def gather(t, group, name="all_gather"):
        seen.append(t.device)
        return torch.tensor([[5, 9], [7, 2]], dtype=torch.int64)

    monkeypatch.setattr(C, "all_gather_rows", gather)
    mesh = Mesh(data=2, tile=1, d=0, t=0, rank=0, distributed=True)
    assert loop._agree(mesh, torch.device("meta"), 5, 2) == [7, 9]
    assert seen == [torch.device("meta")]


def test_free_port_lies_below_the_ephemeral_range(monkeypatch, tmp_path):
    """free_port draws below the kernel's ephemeral range, where no bind(0)
    and no outgoing connection takes a port, and each port it returns
    binds; where the range leaves too few ports below it, bind(0)."""
    import socket

    from gsplat_tpu_torch.dist import launch

    low = launch._ephemeral_low()
    for _ in range(20):
        port = free_port()
        assert max(1024, low // 2) <= port < low
        with socket.socket() as s:
            s.bind(("localhost", port))
    fake = tmp_path / "range"
    fake.write_text("1500\t60999\n")
    monkeypatch.setattr(launch, "_PORT_RANGE", str(fake))
    assert launch._ephemeral_low() == 1500 and free_port() > 0

