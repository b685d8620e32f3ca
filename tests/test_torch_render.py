"""Port parity, the forward render slice: gsplat_tpu_torch's
project_gaussians and render() on the CPU (the kernels' plain versions)
against gsplat_tpu's (Pallas in interpret mode) on the same numpy scene, and
against the port's own per-pixel oracle.

Tolerances: projection floats rtol 1e-5 (the EWA chain compounds ulp-level
transcendental differences), radius and visibility exactly; image and
transmittance 2e-5 abs (the README's parity tolerance); the integer
telemetry n_pairs, n_culled, n_contrib, n_sat exactly. The saturation
bound cull is held against the port's own render without it, bit for bit in
image and gradients, on tests/test_binning.py::test_saturation_bound_cull's
scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fixtures as F
from gsplat_tpu.render.project import project_gaussians as j_project
from gsplat_tpu.render.render import render as j_render
from gsplat_tpu_torch.render.project import Projection, project_gaussians
from gsplat_tpu_torch.render.raster_ref import composite_reference
from gsplat_tpu_torch.render.render import render, render_projected

torch.set_num_threads(1)
ATOL = 2e-5
BG = (0.1, 0.2, 0.3)
# (pair_budget, kept_budget): the B2 regime with the cull off, and the
# kept-budget split that turns the tight cull on
CONFIGS = {"cull_off": (F.BUDGET, None), "cull_on": (F.BUDGET, F.BUDGET - F.CHUNK)}


@pytest.fixture(scope="module")
def scene():
    return F.make_scene()


@pytest.fixture(scope="module")
def objects(scene):
    return F.jax_objects(scene), F.torch_objects(scene)


@pytest.fixture(scope="module")
def jax_renders(objects):
    (jg, jc), _ = objects
    out = {}
    for name, (budget, kept) in CONFIGS.items():
        o = jax.jit(lambda g: j_render(jc, g, jnp.asarray(BG), tile_size=F.TILE,
                                       chunk=F.CHUNK, pair_budget=budget,
                                       kept_budget=kept))(jg)
        out[name] = jax.tree.map(np.asarray, o)
    return out


def test_projection_matches_reference(objects):
    (jg, jc), (tg, tc) = objects
    want = jax.jit(j_project)(jg, jc)
    got = project_gaussians(tg, tc)
    for f in Projection._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f in ("radius", "visible"):
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=f)
    vis = got.visible.numpy()
    assert 0 < vis.sum() < F.make_scene().n_live  # the near plane culls some


@pytest.mark.parametrize("name", list(CONFIGS))
def test_render_matches_reference(objects, jax_renders, name):
    _, (tg, tc) = objects
    budget, kept = CONFIGS[name]
    want = jax_renders[name]
    got = render(tc, tg, torch.tensor(BG), tile_size=F.TILE, chunk=F.CHUNK,
                 pair_budget=budget, kept_budget=kept)
    np.testing.assert_allclose(got.image.numpy(), want.image, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.transmittance.numpy(), want.transmittance,
                               rtol=0, atol=ATOL)
    for f in ("n_pairs", "n_culled", "n_contrib", "n_dropped"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    np.testing.assert_array_equal(got.radii.numpy(), want.radii)
    np.testing.assert_array_equal(got.visible.numpy(), want.visible)
    assert int(got.n_dropped) == 0 and int(got.n_pairs) > 0
    assert (int(got.n_culled) > 0) == (name == "cull_on")


def test_render_matches_own_oracle(objects):
    _, (tg, tc) = objects
    bg = torch.tensor(BG)
    got = render(tc, tg, bg, tile_size=F.TILE, chunk=F.CHUNK, pair_budget=F.BUDGET)
    ref = composite_reference(project_gaussians(tg, tc), width=F.W, height=F.H,
                              tile_size=F.TILE, bg=bg)
    np.testing.assert_allclose(got.image.numpy(), ref.numpy(), rtol=0, atol=ATOL)


def test_empty_scene_renders_background(scene):
    g, cam = F.torch_objects(scene._replace(n_live=0))
    out = render(cam, g, torch.tensor(BG), tile_size=F.TILE, chunk=F.CHUNK,
                 pair_budget=F.BUDGET)
    np.testing.assert_allclose(out.image.numpy(), np.broadcast_to(BG, (F.H, F.W, 3)),
                               atol=1e-6)
    assert int(out.n_pairs) == 0 and int(out.n_contrib) == 0


def test_budget_overflow_reported(objects):
    _, (tg, tc) = objects
    out = render(tc, tg, torch.tensor(BG), tile_size=F.TILE, chunk=8, pair_budget=64)
    assert int(out.n_dropped) > 0
    assert torch.isfinite(out.image).all()


def test_render_refuses_what_the_slice_does_not_port(objects):
    _, (tg, tc) = objects
    kw = dict(tile_size=F.TILE, chunk=F.CHUNK, pair_budget=F.BUDGET)
    bg = torch.tensor(BG)
    # attr_pack renders now (the packed pair table): within
    # tests/test_attr_pack.py's bf16 tolerances of the f32 table
    packed, f32 = render(tc, tg, bg, attr_pack=True, **kw), render(tc, tg, bg, **kw)
    err = (packed.image - f32.image).abs()
    assert int(packed.n_pairs) == int(f32.n_pairs)
    assert float(err.max()) <= 2e-2 and float(err.mean()) < 2e-3
    # gradients flow now: grad-requiring inputs get them (the training slice)
    tg_grad = tg.replace(xyz=tg.xyz.clone().requires_grad_())
    bg_grad = bg.clone().requires_grad_()
    out = render(tc, tg_grad, bg_grad, **kw)
    g_xyz, g_bg = torch.autograd.grad(out.image.sum(), [tg_grad.xyz, bg_grad])
    assert float(g_xyz.abs().max()) > 0 and torch.isfinite(g_xyz).all()
    np.testing.assert_allclose(g_bg.numpy(), out.transmittance.sum().item(), rtol=1e-5)
    with torch.no_grad():
        assert render(tc, tg_grad, bg, **kw).image.grad_fn is None


def test_capacity_above_2_pow_24_raises():
    """gids ride the pair table as f32 values, exact below 2^24 only."""
    n = 1 << 24
    z = torch.zeros(1)
    proj = Projection(mean2d=z.expand(n, 2), conic=z.expand(n, 3), depth=z.expand(n),
                      radius=z.expand(n), rgb=z.expand(n, 3), opacity=z.expand(n),
                      visible=torch.zeros(1, dtype=torch.bool).expand(n))
    with pytest.raises(ValueError, match="2\\^24"):
        render_projected(proj, F.W, F.H, torch.tensor(BG), tile_size=F.TILE,
                         chunk=F.CHUNK, pair_budget=F.BUDGET)


# ------------------------------------------------- saturation bound cull


@pytest.fixture(scope="module")
def sat_case():
    """The saturating scene: the JAX package's probe render (sat_budget =
    pair_budget) and the port's renders without the cull, with the probe's
    budget and with the fitted one."""
    scene, _ = F.make_sat_scene()
    jg, jc = F.jax_objects(scene, F.SAT_W, F.SAT_H)
    bg = np.zeros(3, np.float32)
    want = jax.jit(lambda g: j_render(jc, g, jnp.asarray(bg), **F.SAT_KW,
                                      sat_budget=F.SAT_KW["pair_budget"]))(jg)
    tg, tc = F.torch_objects(scene, F.SAT_W, F.SAT_H)
    base = render(tc, tg, torch.from_numpy(bg), **F.SAT_KW)
    probe = render(tc, tg, torch.from_numpy(bg), **F.SAT_KW,
                   sat_budget=F.SAT_KW["pair_budget"])
    fitted = -(-int(probe.n_sat) // 8) * 8
    out = render(tc, tg, torch.from_numpy(bg), **F.SAT_KW, sat_budget=fitted)
    return jax.tree.map(np.asarray, want), (tg, tc), base, probe, out, fitted


def test_saturation_cull_render(sat_case):
    want, _, base, probe, out, fitted = sat_case
    n_sat = int(probe.n_sat)
    n_kept = int(base.n_pairs) - int(base.n_culled)
    assert 0 < n_sat < n_kept, (n_sat, n_kept)
    assert n_sat == int(want.n_sat) and int(out.n_sat) == n_sat
    assert int(base.n_sat) == 0
    for o in (probe, out):
        assert torch.equal(o.image, base.image) and torch.equal(o.transmittance,
                                                                base.transmittance)
        for f in ("n_pairs", "n_culled", "n_contrib", "n_dropped"):
            assert int(getattr(o, f)) == int(getattr(base, f)), f
    np.testing.assert_allclose(out.image.numpy(), want.image, rtol=0, atol=ATOL)
    assert int(out.n_contrib) == int(want.n_contrib) and int(out.n_dropped) == 0


def sat_grads(tg, tc, **kw):
    params = {k: v.clone().requires_grad_() for k, v in tg.params().items()}
    off = torch.zeros((tg.capacity, 2), requires_grad=True)
    out = render(tc, tg.replace(**params), torch.zeros(3), **F.SAT_KW,
                 mean2d_offset=off, **kw)
    return torch.autograd.grad((out.image ** 2).sum(), list(params.values()) + [off]), out


def test_saturation_cull_gradients_bit_identical(sat_case):
    _, (tg, tc), _, _, _, fitted = sat_case
    g_base, _ = sat_grads(tg, tc)
    g_sat, out = sat_grads(tg, tc, sat_budget=fitted)
    assert int(out.n_dropped) == 0
    for a, b in zip(g_base, g_sat):
        assert torch.equal(a, b)
    assert all(float(a.abs().max()) > 0 for a in g_base[:-2])   # rotation may be 0


@pytest.mark.parametrize("which", ["starved", "one_region_exceeds"])
def test_saturation_cull_overflow_zeroes_gradients(sat_case, which):
    """An overflowing sat budget: exactly zero gradients, n_dropped > 0. With
    one tile's region past the whole budget its segment is clamped into the
    table: the compositor reads no row past it (no IndexError here)."""
    _, (tg, tc), _, probe, _, fitted = sat_case
    budget = max(8, fitted // 32 * 8) if which == "starved" else 8
    grads, out = sat_grads(tg, tc, sat_budget=budget)
    assert int(out.n_dropped) == int(probe.n_sat) - budget > 0
    assert int(out.n_sat) == int(probe.n_sat)
    assert torch.isfinite(out.image).all()
    for g in grads:
        assert float(g.abs().max()) == 0.0


def test_sat_budget_requires_tight_cull(objects):
    _, (tg, tc) = objects
    with pytest.raises(ValueError, match="tight_cull"):
        render(tc, tg, torch.tensor(BG), tile_size=F.TILE, chunk=F.CHUNK,
               pair_budget=F.BUDGET, tight_cull=False, sat_budget=F.BUDGET)
