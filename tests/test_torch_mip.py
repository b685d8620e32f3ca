"""Mip-Splatting on the port: the projection's two filters, the 3D filter's
pass, the training CLI with the switch, the PLY's filter column, and the
planted faults, against benchmark/reference_mip.py (plain float32 torch, no
port import) on the CPU at tens of Gaussians and 64x48 pixels.

- the projection (project_plain with a model's filter_3d) against
  reference_mip.project: mean2d, depth and radius equal, conic, rgb and
  opacity within 1e-5 relative (the reference takes the 3D compensation
  as a quotient of products, the port as a product of quotients: the two
  round apart); every leaf's autograd gradient within 1e-4 of the leaf's
  largest (the same two roundings, carried through the chain);
  project_bwd_plain (the kernels' closed form) against autograd through
  project_plain within 1e-5 of each leaf's largest, dead rows and a
  scaling modifier included;
- filter3d_plain against reference_mip.filter_3d over a crafted camera
  set (rows valid in no camera, on the 15% margin, at depth 0.2 and just
  beyond): bit for bit, validity equal;
- two iterations of `cli.main --mip_splatting` on a make_colmap_scene
  capture, densify at iteration 2: the filter at the start and after the
  densify pass equal to the reference's over the same centres and cameras;
  the first step's loss within 1e-5 relative, its image within 2e-4 (the
  reference composites until transmittance 1e-9, the port's tiles stop at
  1e-4) and the gradient Adam holds within 2e-3 of each leaf's largest (the
  same early stop, carried back);
- a PLY round trip keeps the filter; 3DGS PLYs have no filter column;
- each planted fault of benchmark/faults_mip.py makes the render, or the
  filter, leave the reference.

Tests marked `cuda` hold filter3d's kernels and the Mip projection kernels
to their plain versions on the card: the filter bit for bit; mean2d,
depth, radius and visible bit for bit, conic, rgb and opacity within 2
ulp; the backward within 1e-6 of each leaf's largest. On the machine with
the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mip.py -m cuda
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_fixtures as F
from torch_port_fixtures import cuda_device  # noqa: F401 (a fixture)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import faults_mip, reference_mip as R  # noqa: E402
from gsplat_tpu_torch import cli  # noqa: E402
from gsplat_tpu_torch.core.camera import make_camera  # noqa: E402
from gsplat_tpu_torch.interop import gaussians_from_numpy  # noqa: E402
from gsplat_tpu_torch.io.ply import load_gaussian_ply  # noqa: E402
from gsplat_tpu_torch.io.synthetic import make_colmap_scene  # noqa: E402
from gsplat_tpu_torch.render import filter3d as FL  # noqa: E402
from gsplat_tpu_torch.render import project as P  # noqa: E402
from gsplat_tpu_torch.render.render import render  # noqa: E402
from gsplat_tpu_torch.train import loop as tloop  # noqa: E402

torch.set_num_threads(1)
LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
N, CAP = 40, 48


def ref_cam(cam):
    """reference.camera's dict over the program's camera."""
    return {"world_view": cam.world_view, "full_proj": cam.full_proj,
            "cam_center": cam.cam_center, "tan_fovx": cam.tan_fovx, "tan_fovy": cam.tan_fovy,
            "width": cam.width, "height": cam.height}


def scene(seed=0, device="cpu", deg=3):
    """A Mip model of N live rows in CAP (the filter of the look-at camera
    and two neighbours) and the look-at camera."""
    s = F.make_scene(seed, n=N, capacity=CAP, sh_degree=3)
    g = gaussians_from_numpy(s.params, N, deg, 3, device=device)
    cams = [make_camera(*rig, F.FOVX, F.FOVY, F.W, F.H, device=device) for rig in rigs()]
    table, focal = FL.camera_table(cams, device)
    f, _ = FL.filter3d(g.xyz, g.n_live, table, focal)
    return g.replace(filter_3d=f), cams[0], cams


def rigs():
    R0, T0 = F._look_at()
    out = [(R0, T0)]
    for a in (0.15, -0.2):
        ry = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                       [-math.sin(a), 0.0, math.cos(a)]])
        out.append((ry @ R0, T0))
    return out


@pytest.fixture(scope="module")
def mip_scene():
    return scene()


@pytest.fixture(scope="module")
def ref_projection(mip_scene):
    """reference_mip.project's fields and its leaves' gradients under the
    incoming gradients of `incoming`."""
    g, cam, _ = mip_scene
    p = {k: getattr(g, k).detach().clone().requires_grad_() for k in LEAVES}
    out = R.project(p, ref_cam(cam), N, g.active_sh_degree, g.filter_3d)
    outs = [out["mean2d"], out["conic"], out["depth"], out["rgb"], out["opacity"]]
    grads = torch.autograd.grad(outs, list(p.values()), incoming(outs), allow_unused=True)
    return {k: v.detach() for k, v in out.items()}, dict(zip(LEAVES, grads))


def incoming(outs, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=gen).to(o.device) for o in outs]


def rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


# ---------------------------------------------------------------- projection


def test_projection_fields_match_reference(mip_scene, ref_projection):
    g, cam, _ = mip_scene
    proj = P.project_plain(g, cam)
    want, _ = ref_projection
    assert torch.equal(proj.mean2d, want["mean2d"])
    assert torch.equal(proj.depth, want["depth"])
    assert torch.equal(proj.radius, want["radius"])
    assert int(proj.visible.sum()) > N // 2
    for k in ("conic", "rgb", "opacity"):
        assert rel(getattr(proj, k), want[k]) <= 1e-5, k
    # both filters act: the opacity is compensated, the conic is 3DGS's no more
    three = P.project_plain(g.replace(filter_3d=None), cam)
    assert rel(proj.opacity, three.opacity) > 1e-3
    assert rel(proj.conic, three.conic) > 1e-3


def test_projection_gradients_match_reference(mip_scene, ref_projection):
    g, cam, _ = mip_scene
    p = {k: getattr(g, k).detach().clone().requires_grad_() for k in LEAVES}
    proj = P.project_plain(g.replace(**p), cam)
    outs = [proj.mean2d, proj.conic, proj.depth, proj.rgb, proj.opacity]
    got = torch.autograd.grad(outs, list(p.values()), incoming(outs), allow_unused=True)
    _, want = ref_projection
    for k, a in zip(LEAVES, got):
        assert rel(a, want[k]) <= 1e-4, k


@pytest.mark.parametrize("mod,dead", [(1.0, False), (0.7, False), (1.0, True)],
                         ids=["plain", "modifier", "dead_rows"])
def test_closed_form_backward_matches_autograd(mip_scene, mod, dead):
    g, cam, _ = mip_scene
    p = {k: getattr(g, k).detach().clone().requires_grad_() for k in LEAVES}
    off = torch.zeros((CAP, 2), requires_grad=True)
    proj = P.project_plain(g.replace(**p), cam, mod, None, off)
    outs = [proj.mean2d, proj.conic, proj.depth, proj.rgb, proj.opacity]
    grads = incoming(outs, seed=11)
    if dead:   # the incoming gradient on the padding rows alone
        grads = [gr * (torch.arange(CAP) >= N).view(-1, *([1] * (gr.dim() - 1)))
                 for gr in grads]
    auto = torch.autograd.grad(outs, list(p.values()), grads, allow_unused=True)
    closed = P.project_bwd_plain(g, cam, mod, True, *grads)
    for k, a, c in zip(LEAVES, auto, closed):
        assert torch.isfinite(c).all(), k
        a = torch.zeros_like(c) if a is None else a
        scale = max(float(a.abs().max()), 1e-30)
        assert float((a - c).abs().max()) <= 1e-5 * scale, k


# ---------------------------------------------------------------- the 3D filter


def crafted_filter_case():
    """Centres and cameras (identity rotation, tan 0.5 so fx = W) where the
    validity tests decide at their edges: depth 0.2 exactly and just past,
    x on the -15% and 115% margins and just outside, a centre behind every
    camera, dead rows."""
    xyz = np.array([[0.0, 0.0, 0.2], [0.0, 0.0, 0.2000001], [-0.65, 0.0, 1.0],
                    [-0.6500001, 0.0, 1.0], [0.65, 0.0, 1.0], [0.6500001, 0.0, 1.0],
                    [0.0, -0.65, 1.0], [0.0, 0.65, 1.0], [0.0, 0.0, -3.0], [0.3, 0.2, 2.0],
                    [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    n = 10
    cams = []
    for tx in (0.0, 0.05):
        cam = make_camera(np.eye(3), np.array([tx, 0.0, 0.0]), 2 * math.atan(0.5),
                          2 * math.atan(0.5), F.W, F.H, device="cpu")
        cams.append(cam)
    return torch.from_numpy(xyz), n, cams


def test_filter3d_plain_matches_reference():
    xyz, n, cams = crafted_filter_case()
    table, focal = FL.camera_table(cams, "cpu")
    f, valid = FL.filter3d_plain(xyz, torch.tensor(n, dtype=torch.int32), table, focal)
    rf, rvalid = R.filter_3d(xyz, n, [ref_cam(c) for c in cams])
    assert torch.equal(valid, rvalid)
    assert torch.equal(f, rf)
    assert not bool(valid[0]) and bool(valid[1])          # z > 0.2, strictly
    assert not bool(valid[8])                             # behind: takes the largest
    assert float(f[8]) == float(f[:n][valid[:n]].max())
    assert bool((f[n:] == 0).all()) and not bool(valid[n:].any())
    # the scene's filter: positive on every live row
    g, _, _ = scene()
    assert bool((g.filter_3d[:N] > 0).all()) and bool((g.filter_3d[N:] == 0).all())


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Two iterations of cli.main --mip_splatting (densify at 2), the first
    step's inputs and outputs, and every filter pass's centres and filter."""
    root = tmp_path_factory.mktemp("mip_cli")
    src = make_colmap_scene(root / "scene", n_cams=5, width=F.W, height=F.H, n_points=60)
    seen = {"filters": []}
    orig_step, orig_filter = tloop.make_train_step, tloop.mip_filter

    def make_train_step(*a, **k):
        step = orig_step(*a, **k)

        def wrapped(g, opt_state, cam, bg, it, ema, on_stage=None):
            first = "step" not in seen
            if first:
                seen["step"] = dict(params={k: v.clone() for k, v in g.params().items()},
                                    filt=g.filter_3d.clone(), n=int(g.n_live), cam=cam,
                                    bg=bg.clone(), it=it, deg=g.active_sh_degree,
                                    extent=g.spatial_lr_scale)
            out = step(g, opt_state, cam, bg, it, ema, on_stage)
            if first:
                seen["step"].update(loss=float(out[2]),
                                    mu={k: v.clone() for k, v in out[1].mu.items()})
            return out
        return wrapped

    def mip_filter(g, cams):
        out = orig_filter(g, cams)
        seen["filters"].append((out.xyz.clone(), int(out.n_live), out.filter_3d.clone()))
        return out

    spy = tloop.photometric_loss
    images = []

    def loss_spy(pred, gt, lam=0.2):
        images.append(pred.detach().clone())
        return spy(pred, gt, lam)

    tloop.make_train_step, tloop.mip_filter, tloop.photometric_loss = \
        make_train_step, mip_filter, loss_spy
    try:
        cli.main(["-s", str(src), "-m", str(root / "out"), "--data_device", "cpu",
                  "--iterations", "2", "--capacity", "64", "--pair_budget", "4096",
                  "--tile_size", "16", "--chunk_size", "32", "--densify_from_iter", "1",
                  "--densification_interval", "2", "--densify_grad_threshold", "1e-7",
                  "--quiet", "--mip_splatting"])
    finally:
        tloop.make_train_step, tloop.mip_filter, tloop.photometric_loss = \
            orig_step, orig_filter, spy
    seen["image"] = images[0]
    seen["out"] = root / "out"
    return seen


def test_cli_filter_passes_match_reference(cli_run):
    from gsplat_tpu_torch.scene import Scene
    from gsplat_tpu_torch.config import ModelParams

    assert len(cli_run["filters"]) == 2          # at the start and after densify
    src = cli_run["step"]["cam"]
    cams = Scene(ModelParams(source_path=str(Path(cli_run["out"]).parent / "scene"),
                             data_device="cpu"), capacity=64).get_train_cameras()
    assert any(torch.equal(c.world_view, src.world_view) for c in cams)
    grown = cli_run["filters"][1][1] > cli_run["filters"][0][1]
    assert grown                                 # the pass densified
    for xyz, n, f in cli_run["filters"]:
        rf, rvalid = R.filter_3d(xyz, n, [ref_cam(c) for c in cams])
        assert torch.equal(f, rf)
    cfg = (Path(cli_run["out"]) / "cfg_args").read_text()
    assert "mip_splatting=True" in cfg
    # the save at iteration 2 precedes its densify pass (upstream's order)
    raw = load_gaussian_ply(Path(cli_run["out"]) / "point_cloud" / "iteration_2"
                            / "point_cloud.ply")
    xyz, n, f = cli_run["filters"][0]
    assert np.array_equal(raw["filter_3d"], f[:n].numpy())


def test_cli_first_step_matches_reference(cli_run):
    s = cli_run["step"]
    cam = s["cam"]
    opt = tloop.OptimizationParams()
    lr = {k: getattr(opt, k) for k in ("position_lr_init", "position_lr_final",
                                       "position_lr_max_steps", "feature_lr", "opacity_lr",
                                       "scaling_lr", "rotation_lr")}
    state = R.adam_init(s["params"])
    _, _, loss, img, grads = R.train_step(
        s["params"], state, ref_cam(cam), cam.image, s["bg"], s["it"], n_live=s["n"],
        sh_degree=s["deg"], tile_size=16, lam=opt.lambda_dssim, lr=lr, extent=s["extent"],
        filt=s["filt"], chunk=32)
    assert abs(s["loss"] - loss) <= 1e-5 * abs(loss)
    assert float((cli_run["image"] - img).abs().max()) <= 2e-4
    for k, gr in grads.items():
        prog = s["mu"][k] / (1.0 - R.ADAM_B1)
        assert rel(prog, gr) <= 2e-3, k


def test_cli_spans_under_profiler(tmp_path):
    """Under a profiler the loop records `densify` (cloned, split, pruned,
    live), `grow` (capacity) and `filter3d` (rows, cameras), each a child
    of its iteration's root span."""
    from torch.profiler import ProfilerActivity, profile

    from gsplat_tpu_torch import spans

    src = make_colmap_scene(tmp_path / "scene", n_cams=4, width=F.W, height=F.H, n_points=60)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        cli.main(["-s", str(src), "-m", str(tmp_path / "out"), "--data_device", "cpu",
                  "--iterations", "2", "--capacity", "64", "--pair_budget", "4096",
                  "--tile_size", "16", "--chunk_size", "32", "--densify_from_iter", "1",
                  "--densification_interval", "2", "--densify_grad_threshold", "1e-9",
                  "--quiet", "--mip_splatting"])
    recs = spans.records()
    by_id = {r.id: r for r in recs}
    got = {name: [r for r in recs if r.name == name] for name in ("densify", "grow", "filter3d")}
    assert len(got["densify"]) == 1 and len(got["grow"]) == 1 and len(got["filter3d"]) == 2
    d, gr = got["densify"][0], got["grow"][0]
    assert set(d.counters) == {"cloned", "split", "pruned", "live"}
    assert int(d.counters["split"]) + int(d.counters["cloned"]) > 0
    # a split source leaves two rows, a clone adds one; the capacity (64) cuts
    assert int(d.counters["live"]) == min(64, 60 - int(d.counters["pruned"])
                                          + int(d.counters["cloned"]) + int(d.counters["split"]))
    assert gr.counters == {"capacity": 128}
    assert [int(f.counters["cameras"]) for f in got["filter3d"]] == [4, 4]
    assert int(got["filter3d"][1].counters["rows"]) == int(d.counters["live"])
    # the start's pass precedes the loop; the others are children of an iteration
    for r in [d, gr, got["filter3d"][1]]:
        assert by_id[r.parent].name == "iteration" and by_id[r.parent].parent is None


# ---------------------------------------------------------------- PLY


def test_ply_round_trip_keeps_filter(tmp_path, mip_scene):
    from gsplat_tpu_torch.ckpt import save_ply
    from gsplat_tpu_torch.scene import gaussians_from_raw

    g, _, _ = mip_scene
    save_ply(tmp_path / "m.ply", g)
    raw = load_gaussian_ply(tmp_path / "m.ply")
    back = gaussians_from_raw(raw, capacity=CAP, sh_degree=3, device="cpu")
    assert back.mip and torch.equal(back.filter_3d[:N], g.filter_3d[:N])
    assert bool((back.filter_3d[N:] == 0).all())
    save_ply(tmp_path / "p.ply", g.replace(filter_3d=None))
    raw = load_gaussian_ply(tmp_path / "p.ply")
    assert "filter_3d" not in raw
    assert not gaussians_from_raw(raw, capacity=CAP, sh_degree=3, device="cpu").mip


# ---------------------------------------------------------------- faults


def program_vs_reference(seed=1):
    """(largest image gap, largest filter gap) of a program render against
    the reference's, the filter taken by each over the same cameras."""
    s = F.make_scene(seed, n=N, capacity=CAP, sh_degree=3)
    g = gaussians_from_numpy(s.params, N, 3, 3, device="cpu")
    cams = [make_camera(*rig, F.FOVX, F.FOVY, F.W, F.H, device="cpu") for rig in rigs()]
    table, focal = FL.camera_table(cams, "cpu")
    f, _ = FL.filter3d(g.xyz, g.n_live, table, focal)
    rf, _ = R.filter_3d(g.xyz, N, [ref_cam(c) for c in cams])
    bg = torch.zeros(3)
    img = render(cams[0], g.replace(filter_3d=f), bg, tile_size=16, chunk=32,
                 pair_budget=4096).image
    rimg, _ = R.render(g.params(), ref_cam(cams[0]), bg, n_live=N, sh_degree=3, tile_size=16,
                       chunk=32, filt=rf)
    return float((img - rimg).abs().max()), float((f - rf).abs().max() / rf.abs().max())


@pytest.mark.parametrize("fault", [None, *faults_mip.FAULTS])
def test_planted_faults_are_caught(fault):
    if fault is None:
        img_gap, filt_gap = program_vs_reference()
        assert img_gap <= 2e-4 and filt_gap == 0.0
        return
    with faults_mip.FAULTS[fault]():
        img_gap, filt_gap = program_vs_reference()
    assert img_gap > 2e-3 or filt_gap > 1e-3, (img_gap, filt_gap)


def test_mesh_refuses_the_switch(tmp_path):
    from gsplat_tpu_torch.config import MeshParams, ModelParams, OptimizationParams, \
        OtherParams, PipelineParams

    with pytest.raises(ValueError, match="mip_splatting"):
        tloop.train(ModelParams(source_path=str(tmp_path), data_device="cpu",
                                mip_splatting=True),
                    OptimizationParams(), PipelineParams(), OtherParams(quiet=True),
                    MeshParams(data_axis=2, tile_axis=1, num_processes=0))


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
def test_filter3d_kernel_matches_plain(cuda_device):
    gen = torch.Generator().manual_seed(3)
    xyz = torch.randn((1 << 16, 3), generator=gen)
    xyz[:, 2] += 3.0
    cams = [make_camera(*rig, F.FOVX, F.FOVY, 1920, 1080, device="cpu") for rig in rigs()]
    table, focal = FL.camera_table(cams, "cpu")
    n = torch.tensor(60000, dtype=torch.int32)
    f, valid = FL.filter3d_plain(xyz, n, table, focal)
    fk, vk = FL.filter3d(xyz.to(cuda_device), n.to(cuda_device), table.to(cuda_device), focal)
    assert torch.equal(vk.cpu(), valid) and torch.equal(fk.cpu(), f)
    assert 0 < int(valid.sum()) < 60000


@pytest.mark.cuda
@pytest.mark.parametrize("deg,mod", [(3, 1.0), (0, 0.7), (1, 1.0)])
def test_mip_projection_kernels_match_plain(cuda_device, deg, mod):
    """The plain versions run on the card too (torch's CUDA kernels, whose
    roundings the kernels mirror)."""
    g, cam, _ = scene(deg=deg, device=cuda_device)
    want = P.project_plain(g, cam, mod)
    p = {k: getattr(g, k).detach().clone().requires_grad_() for k in LEAVES}
    n0 = (P.mip_fwd_count.launches, P.mip_bwd_count.launches)
    got = P.project_gaussians(g.replace(**p), cam, mod)
    for k in ("mean2d", "depth", "radius", "visible"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k in ("conic", "rgb", "opacity"):
        a, b = getattr(got, k).detach(), getattr(want, k)
        assert bool(((a - b).abs() <= b.abs() * 2.0 ** -22 + 1e-30).all()), k
    outs = [got.mean2d, got.conic, got.depth, got.rgb, got.opacity]
    grads = incoming(outs, seed=2)
    kern = torch.autograd.grad(outs, list(p.values()), grads)
    plain = P.project_bwd_plain(g, cam, mod, True, *grads)
    assert (P.mip_fwd_count.launches, P.mip_bwd_count.launches) == (n0[0] + 1, n0[1] + 1)
    for k, a, b in zip(LEAVES, kern, plain):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * scale, k
