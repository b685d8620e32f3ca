"""The projection's autograd Function (render/project.py::_Project) and its
CUDA kernels (csrc/project.cu).

On the CPU, `project_gaussians` is `project_plain` under autograd: its
fields and its autograd gradients are those of the projection as it was
written before the kernels (`seed_projection` below, kept as the oracle)
bit for bit; the CPU tests that hold training to the JAX package depend on
those bits. The closed-form `project_bwd_plain` (the backward kernel's
plain version) agrees with torch.autograd.grad through project_plain within
1e-5 of each leaf's largest. The cases: SH degrees 0 to 3, a degree below
the model's maximum, a scaling modifier, an override colour, a mean2d
offset, and (the incoming gradient on those rows alone) capacity-padded
dead rows, rows behind the 0.2 near plane, rows whose Jacobian clamps in x
and in y, rows with det <= 0 and a zero quaternion.

Tests marked `cuda` hold the kernels to the plain versions on the card:
mean2d, depth, radius and visible bit for bit, conic, rgb and opacity
within 1 ulp; the backward within 1e-6 of each leaf's largest, the same
bits from two passes, no host sync; the render's `project` span counting
the fused launch; and a 2^20-row scene whose 1080p pair counts equal the
plain projection's. This file imports no jax; on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_project.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_port_fixtures as F
from torch_port_fixtures import cuda_device  # noqa: F401 (a fixture)
from gsplat_tpu_torch import spans
from gsplat_tpu_torch.core.camera import make_camera
from gsplat_tpu_torch.core.gaussians import Gaussians, pad_fill
from gsplat_tpu_torch.core.sh import sh_to_rgb_color
from gsplat_tpu_torch.interop import gaussians_from_numpy
from gsplat_tpu_torch.render import project as P
from gsplat_tpu_torch.render.render import render, render_projected

torch.set_num_threads(1)
LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
N_LIVE, CAP = 96, 104      # eight dead rows at the end
# the crafted rows (make_params), by kind
ROWS = {
    "dead": list(range(N_LIVE, CAP)),
    "near": [0, 1, 2],              # view depth 0.15, 0.19, behind the camera
    "clamp_x": [3, 4],
    "clamp_y": [5, 6],
    "det": list(range(7, 23)),      # huge anisotropic splats: some have det <= 0
    "zero_quat": [23],
}


def make_params(seed: int, max_deg: int):
    """A capacity-padded scene of N_LIVE live rows (the crafted rows of ROWS
    first) seen by the fixtures' look-at camera from (0, 0, 4), as numpy."""
    rng = np.random.default_rng(seed)
    m = (max_deg + 1) ** 2 - 1
    n = N_LIVE
    xyz = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    xyz[0:3] = [[0.1, 0.0, 3.85], [-0.2, 0.1, 3.81], [0.0, -0.1, 5.0]]
    xyz[3:5] = [[3.0, 0.2, 0.0], [-3.2, -0.1, 0.3]]     # x / z beyond 1.3 tan(fovx / 2)
    xyz[5:7] = [[0.1, 2.6, 0.0], [-0.2, -2.9, 0.2]]     # y / z beyond 1.3 tan(fovy / 2)
    scaling = rng.uniform(-2.8, -1.2, size=(n, 3)).astype(np.float32)
    scaling[7:23] = [9.5, -7.0, -7.0]
    rotation = rng.normal(size=(n, 4)).astype(np.float32)
    rotation[23] = 0.0
    f_dc = rng.normal(size=(n, 3)).astype(np.float32)
    f_rest = (rng.normal(size=(n, m, 3)) * 0.3).astype(np.float32)
    opacity = rng.normal(0.0, 1.5, size=(n, 1)).astype(np.float32)
    return F._padded(CAP, xyz, f_dc, f_rest, opacity, scaling, rotation)


def objects(seed=0, deg=3, max_deg=3, device="cpu", width=F.W, height=F.H):
    g = gaussians_from_numpy(make_params(seed, max_deg), N_LIVE, deg, max_deg, device=device)
    R, T = F._look_at()
    return g, make_camera(R, T, F.FOVX, F.FOVY, width, height, device=device)


# case: (make_params / objects settings, scaling_modifier, override colour,
# mean2d offset, the crafted rows the incoming gradient is on, or None: all)
CASES = {
    "deg0": (dict(deg=0), 1.0, False, False, None),
    "deg1": (dict(deg=1), 1.0, False, False, None),
    "deg2": (dict(deg=2), 1.0, False, False, None),
    "deg3": (dict(deg=3), 1.0, False, False, None),
    "deg1_of_max2": (dict(deg=1, max_deg=2), 1.0, False, False, None),
    "modifier": (dict(deg=3, seed=1), 0.7, False, False, None),
    "override": (dict(deg=3, seed=2), 1.0, True, False, None),
    "offset": (dict(deg=3, seed=3), 1.0, False, True, None),
    **{f"rows_{k}": (dict(deg=3, seed=4), 1.0, False, True, k) for k in ROWS},
}


def seed_projection(g, cam, scaling_modifier=1.0, override_color=None, mean2d_offset=None):
    """The projection as the port wrote it before its kernels (plain torch,
    every line as it was): the oracle of project_plain's bits."""
    xyz = g.get_xyz()
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    FP = cam.full_proj
    hom = [x * FP[0, j] + y * FP[1, j] + z * FP[2, j] + FP[3, j] for j in range(4)]
    p_w = 1.0 / (hom[3] + 1e-7)
    px_ndc = hom[0] * p_w
    py_ndc = hom[1] * p_w
    WV = cam.world_view
    p_view = [x * WV[0, j] + y * WV[1, j] + z * WV[2, j] + WV[3, j] for j in range(3)]
    depth = p_view[2]
    base_mask = (depth > 0.2) & g.live_mask
    s3 = g.get_scaling() * scaling_modifier
    q = g.get_rotation()
    qr, qi, qj, qk = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qj * qj + qk * qk)
    r01 = 2 * (qi * qj - qr * qk)
    r02 = 2 * (qi * qk + qr * qj)
    r10 = 2 * (qi * qj + qr * qk)
    r11 = 1 - 2 * (qi * qi + qk * qk)
    r12 = 2 * (qj * qk - qr * qi)
    r20 = 2 * (qi * qk - qr * qj)
    r21 = 2 * (qj * qk + qr * qi)
    r22 = 1 - 2 * (qi * qi + qj * qj)
    s0sq, s1sq, s2sq = s3[:, 0] * s3[:, 0], s3[:, 1] * s3[:, 1], s3[:, 2] * s3[:, 2]
    c00 = r00 * r00 * s0sq + r01 * r01 * s1sq + r02 * r02 * s2sq
    c01 = r00 * r10 * s0sq + r01 * r11 * s1sq + r02 * r12 * s2sq
    c02 = r00 * r20 * s0sq + r01 * r21 * s1sq + r02 * r22 * s2sq
    c11 = r10 * r10 * s0sq + r11 * r11 * s1sq + r12 * r12 * s2sq
    c12 = r10 * r20 * s0sq + r11 * r21 * s1sq + r12 * r22 * s2sq
    c22 = r20 * r20 * s0sq + r21 * r21 * s1sq + r22 * r22 * s2sq
    fx, fy = cam.focal_x, cam.focal_y
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    z_safe = torch.where(base_mask, depth, torch.ones_like(depth))
    txtz = torch.minimum(torch.maximum(p_view[0] / z_safe, -limx), limx)
    tytz = torch.minimum(torch.maximum(p_view[1] / z_safe, -limy), limy)
    tx, ty = txtz * z_safe, tytz * z_safe
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    W = cam.world_view[:3, :3].T
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    a0 = j00 * W[0, 0] + j02 * W[2, 0]
    a1 = j00 * W[0, 1] + j02 * W[2, 1]
    a2 = j00 * W[0, 2] + j02 * W[2, 2]
    b0 = j11 * W[1, 0] + j12 * W[2, 0]
    b1 = j11 * W[1, 1] + j12 * W[2, 1]
    b2 = j11 * W[1, 2] + j12 * W[2, 2]
    sa0 = c00 * a0 + c01 * a1 + c02 * a2
    sa1 = c01 * a0 + c11 * a1 + c12 * a2
    sa2 = c02 * a0 + c12 * a1 + c22 * a2
    sb0 = c00 * b0 + c01 * b1 + c02 * b2
    sb1 = c01 * b0 + c11 * b1 + c12 * b2
    sb2 = c02 * b0 + c12 * b1 + c22 * b2
    a = a0 * sa0 + a1 * sa1 + a2 * sa2 + 0.3
    b = b0 * sa0 + b1 * sa1 + b2 * sa2
    c = b0 * sb0 + b1 * sb1 + b2 * sb2 + 0.3
    det = a * c - b * b
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))
    visible = base_mask & det_ok
    radius = torch.where(visible, radius, torch.zeros_like(radius)).detach()
    mean2d = torch.stack([P.ndc2pix(px_ndc, cam.width), P.ndc2pix(py_ndc, cam.height)], dim=-1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    if override_color is not None:
        rgb = override_color
    else:
        dirs = xyz - cam.cam_center[None, :]
        dirs = dirs * torch.rsqrt(torch.clamp((dirs * dirs).sum(-1, keepdim=True), min=1e-16))
        rgb = sh_to_rgb_color(g.active_sh_degree, g.get_features(), dirs)
    opacity = torch.where(visible, g.get_opacity()[:, 0], torch.zeros_like(depth))
    return P.Projection(mean2d=mean2d, conic=conic, depth=depth, radius=radius, rgb=rgb,
                        opacity=opacity, visible=visible)


def leaves_of(g, override):
    return [getattr(g, k) for k in LEAVES if not (override and k in ("f_dc", "f_rest"))]


def incoming(proj, rows, seed=7):
    """Random incoming gradients of mean2d, conic, depth, rgb and opacity,
    zero outside `rows` (None: every row)."""
    gen = torch.Generator().manual_seed(seed)
    outs = [proj.mean2d, proj.conic, proj.depth, proj.rgb, proj.opacity]
    grads = [torch.randn(o.shape, generator=gen).to(o.device) for o in outs]
    if rows is not None:
        mask = torch.zeros(proj.depth.shape[0], dtype=torch.bool)
        mask[ROWS[rows]] = True
        mask = mask.to(proj.depth.device)
        grads = [gr * mask.view(-1, *([1] * (gr.dim() - 1))) for gr in grads]
    return outs, grads


def run(case, device="cpu", project=P.project_gaussians):
    """(projection, gradients of the leaves (and offset, override colour))
    under `project` with autograd, for one case."""
    kw, mod, override, offset, rows = CASES[case]
    g, cam = objects(device=device, **kw)
    params = {k: getattr(g, k).detach().clone().requires_grad_() for k in LEAVES}
    g = g.replace(**params)
    extra = {}
    if override:
        extra["override_color"] = torch.rand(
            (CAP, 3), generator=torch.Generator().manual_seed(11)).to(device).requires_grad_()
    if offset:
        extra["mean2d_offset"] = torch.zeros((CAP, 2), device=device, requires_grad=True)
    proj = project(g, cam, scaling_modifier=mod, **extra)
    outs, grads = incoming(proj, rows)
    wrt = leaves_of(g, override) + list(extra.values())
    got = torch.autograd.grad(outs, wrt, grads)
    return proj, got


def assert_close_per_leaf(got, want, rel):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= rel * scale + 1e-30, f"leaf {i}: {err} against {rel} x {scale}"


def test_crafted_rows():
    """The scene holds what ROWS names: culled near rows, clamped Jacobians,
    det <= 0 rows that are in front and live, a zero quaternion."""
    g, cam = objects()
    p = P.project_plain(g, cam)
    assert not p.visible[ROWS["near"]].any() and not p.visible[ROWS["dead"]].any()
    view = g.xyz @ cam.world_view[:3, :3] + cam.world_view[3, :3]
    ux, uy = view[:, 0] / view[:, 2], view[:, 1] / view[:, 2]
    assert (ux[ROWS["clamp_x"]].abs() > 1.3 * cam.tan_fovx).all()
    assert (uy[ROWS["clamp_y"]].abs() > 1.3 * cam.tan_fovy).all()
    det_rows = torch.tensor(ROWS["det"])
    in_front = view[det_rows, 2] > 0.2
    assert (in_front & ~p.visible[det_rows]).any(), "no det <= 0 row"
    assert p.visible[ROWS["zero_quat"]].all()


@pytest.mark.parametrize("case", list(CASES))
def test_forward_fields_unchanged(case):
    """project_gaussians on the CPU against the projection as it was: the
    same bits in every field and in every gradient autograd gives."""
    got, got_grads = run(case)
    want, want_grads = run(case, project=seed_projection)
    for name in P.Projection._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)


def closed_form(case, device="cpu"):
    """The closed-form backward of one case's incoming gradients -> (its
    leaf gradients, autograd's through project_plain: the leaves', then the
    offset's and the override colour's where given)."""
    kw, mod, override, _, rows = CASES[case]
    g, cam = objects(device=device, **kw)
    _, auto = run(case, device=device, project=P.project_plain)
    _, grads = incoming(P.project_plain(g, cam, mod), rows)
    got = P.project_bwd_plain(g, cam, mod, not override, *grads)
    return [t for t in got if t is not None], auto


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_autograd(case):
    """project_bwd_plain against torch.autograd.grad through project_plain,
    per leaf."""
    got, want = closed_form(case)
    assert_close_per_leaf(got, want[:len(got)], 1e-5)


def test_backward_none_gradients():
    """Outputs without an incoming gradient (None) count as zeros: mean2d's
    gradient alone, as autograd gives it (no gradient to the colour)."""
    g, cam = objects()
    params = {k: getattr(g, k).detach().clone().requires_grad_() for k in LEAVES}
    gm = torch.randn(CAP, 2, generator=torch.Generator().manual_seed(5))
    p = P.project_plain(g.replace(**params), cam)
    want = torch.autograd.grad([p.mean2d], list(params.values()), [gm], allow_unused=True)
    got = P.project_bwd_plain(g, cam, 1.0, True, gm, None, None, None, None)
    want = [torch.zeros_like(v) if w is None else w for v, w in zip(params.values(), want)]
    assert not got[1].any() and not got[2].any()
    assert_close_per_leaf(got, want, 1e-5)


def test_project_span_counts_rows_and_path():
    g, cam = objects()
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        render(cam, g, torch.zeros(3), tile_size=F.TILE, chunk=32, pair_budget=1 << 12)
    proj = next(r for r in spans.records() if r.name == "project")
    assert proj.counters == {"rows": CAP, "fused": 0}


# ---- on the card ----

def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of float32 (same-sign values)."""
    ia, ib = a.view(torch.int32).to(torch.int64), b.view(torch.int32).to(torch.int64)
    both = (a == b)
    return torch.where(both, 0, (ia - ib).abs())


def big_scene(device, n=1 << 20, dead=4096, seed=5):
    """A 2^20-row scene (the last `dead` rows padded) before a 1080p camera."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    live = n - dead
    xyz = rnd(n, 3) * torch.tensor([1.2, 0.7, 0.9], device=device)
    params = {
        "xyz": xyz, "f_dc": rnd(n, 3), "f_rest": rnd(n, 15, 3) * 0.3,
        "opacity": rnd(n, 1), "scaling": rnd(n, 3) * 0.5 - 4.5, "rotation": rnd(n, 4),
    }
    for k in params:
        params[k][live:] = pad_fill(k, params[k][live:].shape, device)
    zeros = torch.zeros(n, device=device)
    g = Gaussians(**params, max_radii2D=zeros, xyz_gradient_accum=zeros.clone(),
                    denom=zeros.clone(),
                    n_live=torch.tensor(live, dtype=torch.int32, device=device),
                    active_sh_degree=3, max_sh_degree=3)
    R, T = F._look_at()
    return g, make_camera(R, T, 1.2, 0.7, 1920, 1080, device=device)


def assert_fwd_equal(got, want):
    for name in ("mean2d", "depth", "radius", "visible"):
        a, b = getattr(got, name), getattr(want, name)
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} differ"
    for name in ("conic", "rgb", "opacity"):
        u = ulps(getattr(got, name), getattr(want, name))
        assert int(u.max()) <= 1, f"{name}: {int(u.max())} ulp"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_forward_matches_plain(case, cuda_device):
    dev = cuda_device
    got, _ = run(case, device=dev)
    want, _ = run(case, device=dev, project=P.project_plain)
    assert_fwd_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_backward_matches_plain(case, cuda_device):
    """The backward kernel against project_bwd_plain on the card (the same
    formulas as torch ops), and against autograd within 1e-5."""
    n0 = P.project_bwd.launches
    _, got = run(case, device=cuda_device)
    assert P.project_bwd.launches == n0 + 1
    plain, auto = closed_form(case, cuda_device)
    assert_close_per_leaf(got[:len(plain)], plain, 1e-6)
    assert_close_per_leaf(got, auto, 1e-5)


@pytest.mark.cuda
def test_cuda_big_scene(cuda_device):
    """2^20 rows at 1080p: the forward fields as the plain version's, the
    render's pair counts equal, the gradient the same bits twice, and no
    host sync in the forward or the backward."""
    dev = cuda_device
    g, cam = big_scene(dev)
    want = P.project_plain(g, cam)
    got = P.project_gaussians(g, cam)
    assert_fwd_equal(got, want)
    assert int(got.visible.sum()) > 100_000
    bg = torch.zeros(3, device=dev)
    a = render_projected(got, 1920, 1080, bg, pair_budget=1 << 23)
    b = render_projected(want, 1920, 1080, bg, pair_budget=1 << 23)
    for k in ("n_pairs", "n_dropped", "n_culled", "n_contrib"):
        assert int(getattr(a, k)) == int(getattr(b, k)), k

    params = {k: getattr(g, k).detach().requires_grad_() for k in LEAVES}
    off = torch.zeros((g.capacity, 2), device=dev, requires_grad=True)
    gg = g.replace(**params)
    gen = torch.Generator(device=dev).manual_seed(1)
    vis = want.visible[:, None]
    gin = [torch.randn(s, generator=gen, device=dev) * vis for s in
           ((g.capacity, 2), (g.capacity, 3), (g.capacity, 3), (g.capacity, 1))]
    runs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            p = P.project_gaussians(gg, cam, mean2d_offset=off)
            runs.append(torch.autograd.grad([p.mean2d, p.conic, p.rgb, p.opacity],
                                            list(params.values()) + [off],
                                            [gin[0], gin[1], gin[2], gin[3][:, 0]]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    want_g = P.project_bwd_plain(g, cam, 1.0, True, gin[0], gin[1], None, gin[2], gin[3][:, 0])
    assert_close_per_leaf(runs[0][:6], want_g, 1e-6)


@pytest.mark.cuda
def test_cuda_project_span_counts_the_kernel(cuda_device):
    dev = cuda_device
    g, cam = objects(device=dev)
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        render(cam, g, torch.zeros(3, device=dev), tile_size=F.TILE, chunk=32,
               pair_budget=1 << 12)
    proj = next(r for r in spans.records() if r.name == "project")
    assert proj.counters == {"rows": CAP, "fused": 1}
