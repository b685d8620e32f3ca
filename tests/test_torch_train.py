"""Port parity, the training slice: gsplat_tpu_torch's losses, LR schedule,
Adam, render gradients and train step on the CPU (the kernels' plain
versions) against gsplat_tpu's (Pallas in interpret mode) on the same numpy
inputs, and the render gradients against autograd of the port's own
per-pixel oracle.

Tolerances: losses 1e-6 (both blur in full f32; the sums run in other
orders). Render gradients within 2e-4 of each parameter group's max |value|
of the JAX gradient, and within 1e-5 of the oracle's (the port sums each
Gaussian's rows in float64; the reference's float32 cumsum difference is
itself up to ~2e-4 of the rotation group's max away from the exact oracle
on these scenes, and up to 2e-3 on others: GRAD_SCENES are scenes where
the reference holds its own 2e-4 against its oracle, which the test checks
too). The train step: loss and EMA 1e-6 relative, integer telemetry and
denom exactly, Adam moments and accumulators 2e-4 of their max, parameters
within 1e-6 + 1e-5 relative where the gradient's sign is determined (the
first Adam steps move each element by about lr * sign(g)), and never
further than the steps' summed learning rates. A step with the saturation
bound cull equals the step without it bit for bit (the port alone: no
second JAX train step compiles)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fixtures as F
from gsplat_tpu.config import MeshParams as JMeshParams
from gsplat_tpu.config import OptimizationParams as JOpt
from gsplat_tpu.core.transforms import get_expon_lr_func as j_lr_func
from gsplat_tpu.render.render import render as j_render
from gsplat_tpu.render.render import render_reference as j_render_reference
from gsplat_tpu.train import loss as jloss
from gsplat_tpu.train.loop import make_train_step as j_make_train_step
from gsplat_tpu.train.optim import AdamState as JAdamState
from gsplat_tpu.train.optim import adam_update as j_adam_update
from gsplat_tpu.train.optim import init_adam_state as j_init_adam
from gsplat_tpu.train.optim import make_lr_fns as j_make_lr_fns
from gsplat_tpu_torch.config import MeshParams, OptimizationParams
from gsplat_tpu_torch.core.transforms import get_expon_lr_func
from gsplat_tpu_torch.interop import (adam_state_from_numpy, adam_state_to_numpy,
                                      camera_from_numpy, gaussians_to_numpy)
from gsplat_tpu_torch.render.project import project_gaussians
from gsplat_tpu_torch.render.raster_ref import composite_reference
from gsplat_tpu_torch.render.render import render
from gsplat_tpu_torch.train import loss as tloss
from gsplat_tpu_torch.train.loop import make_train_step
from gsplat_tpu_torch.train.optim import adam_update, init_adam_state, make_lr_fns

torch.set_num_threads(1)
BG = (0.1, 0.2, 0.3)
GRAD_SCENES = {
    "sparse": dict(seed=5),
    "dense": dict(seed=4, log_scale=(-1.0, -0.6), opacity_logit=(5.0, 0.5)),
}
RENDER_KW = dict(tile_size=F.TILE, chunk=F.CHUNK, pair_budget=F.BUDGET,
                 kept_budget=F.BUDGET - F.CHUNK)


def target_image(seed=7):
    return np.random.default_rng(seed).random((F.H, F.W, 3)).astype(np.float32)


def rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-30))


# ---------------------------------------------------------------- losses


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    a = rng.random((40, 56, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("fn", ["l1_loss", "mse", "psnr", "ssim", "photometric_loss"])
def test_losses_match_reference(images, fn):
    a, b = images
    want = float(getattr(jloss, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tloss, fn)(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1.0), (got, want)


def test_ssim_gradient_matches_reference(images):
    """The blur's hand-written backward (it is its own adjoint)."""
    a, b = images
    want = np.asarray(jax.grad(lambda x: jloss.ssim(x, jnp.asarray(b)))(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_()
    (got,) = torch.autograd.grad(tloss.ssim(x, torch.from_numpy(b)), [x])
    assert rel_err(got.numpy(), want) <= 1e-5


# ---------------------------------------------------------- LR and Adam


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01, max_steps=30_000),
    dict(lr_init=1e-2, lr_final=1e-4, lr_delay_steps=100, lr_delay_mult=0.1,
         max_steps=1000),
])
def test_expon_lr_matches_reference(kw):
    want, got = j_lr_func(**kw), get_expon_lr_func(**kw)
    for step in (-1, 0, 1, 7, 50, 100, 999, 1000, 15_000, 30_000, 40_000):
        w, g = float(want(jnp.asarray(step, jnp.int32))), float(got(step))
        assert abs(g - w) <= 1e-6 * abs(w) + 1e-30, (step, g, w)


def test_lr_fns_and_adam_match_reference():
    opt = OptimizationParams()
    j_fns, t_fns = j_make_lr_fns(JOpt(), 2.5), make_lr_fns(opt, 2.5)
    assert list(j_fns) == list(t_fns)
    rng = np.random.default_rng(0)
    shapes = {"xyz": (6, 3), "f_dc": (6, 3), "f_rest": (6, 15, 3), "opacity": (6, 1),
              "scaling": (6, 3), "rotation": (6, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = j_init_adam(jp), init_adam_state(tp)
    for step in (1, 2, 3):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** -step
                 for k, s in shapes.items()}
        jl = {k: fn(jnp.asarray(step, jnp.int32)) for k, fn in j_fns.items()}
        tl = {k: fn(step) for k, fn in t_fns.items()}
        for k in jl:
            assert abs(float(tl[k]) - float(jl[k])) <= 1e-7 * float(jl[k]), k
        jp, js = j_adam_update(jp, {k: jnp.asarray(v) for k, v in grads.items()}, js, jl)
        tp, ts = adam_update(tp, {k: torch.from_numpy(v) for k, v in grads.items()},
                             ts, tl)
    assert int(ts.count) == int(js.count) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-5)


# ------------------------------------------------------- render gradient


def torch_grads(tg, tc, target, loss=tloss.photometric_loss, **kw):
    params = {k: v.clone().requires_grad_() for k, v in tg.params().items()}
    off = torch.zeros((tg.capacity, 2), requires_grad=True)
    out = render(tc, tg.replace(**params), torch.tensor(BG), mean2d_offset=off,
                 **{**RENDER_KW, **kw})
    grads = torch.autograd.grad(loss(out.image, torch.from_numpy(target)),
                                list(params.values()) + [off])
    return dict(zip(list(params) + ["mean2d_offset"], grads)), out


@pytest.fixture(scope="module")
def grad_cases():
    """Per GRAD_SCENES entry: (the JAX render's gradients, the JAX oracle's,
    the port's, the port oracle's), each a dict over the six groups and
    mean2d_offset, for the photometric loss on a seeded target."""
    out = {}
    target = target_image()
    for name, kw in GRAD_SCENES.items():
        s = F.make_scene(**kw)
        (jg, jc), (tg, tc) = F.jax_objects(s), F.torch_objects(s)
        tgt = jnp.asarray(target)

        def j_loss(params, off, oracle):
            g = jg.with_params(params)
            if oracle:
                img = j_render_reference(jc, g, jnp.asarray(BG), tile_size=F.TILE,
                                         mean2d_offset=off)
            else:
                img = j_render(jc, g, jnp.asarray(BG), mean2d_offset=off,
                               **RENDER_KW).image
            return jloss.photometric_loss(img, tgt)

        jax_grads = []
        for oracle in (False, True):
            gp, goff = jax.jit(jax.grad(j_loss, argnums=(0, 1)), static_argnums=2)(
                jg.params(), jnp.zeros((s.params["xyz"].shape[0], 2)), oracle)
            jax_grads.append({**{k: np.asarray(v) for k, v in gp.items()},
                              "mean2d_offset": np.asarray(goff)})
        port, _ = torch_grads(tg, tc, target)
        params = {k: v.clone().requires_grad_() for k, v in tg.params().items()}
        off = torch.zeros((tg.capacity, 2), requires_grad=True)
        proj = project_gaussians(tg.replace(**params), tc, mean2d_offset=off)
        img = composite_reference(proj, width=F.W, height=F.H, tile_size=F.TILE,
                                  bg=torch.tensor(BG))
        og = torch.autograd.grad(tloss.photometric_loss(img, torch.from_numpy(target)),
                                 list(params.values()) + [off])
        oracle = dict(zip(list(params) + ["mean2d_offset"], og))
        out[name] = (jax_grads[0], jax_grads[1], port, oracle)
    return out


GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "mean2d_offset")


@pytest.mark.parametrize("name", list(GRAD_SCENES))
def test_render_gradients_match_reference(grad_cases, name):
    jax_g, jax_oracle, port, _ = grad_cases[name]
    for k in GROUPS:
        # the reference within its own tolerance of its oracle on this scene
        assert rel_err(jax_g[k], jax_oracle[k]) <= 2e-4, k
        assert rel_err(port[k].numpy(), jax_g[k]) <= 2e-4, (k, rel_err(port[k].numpy(), jax_g[k]))
    assert float(port["mean2d_offset"].abs().max()) > 0


@pytest.mark.parametrize("name", list(GRAD_SCENES))
def test_render_gradients_match_own_oracle(grad_cases, name):
    _, _, port, oracle = grad_cases[name]
    for k in GROUPS:
        assert rel_err(port[k].numpy(), oracle[k].numpy()) <= 1e-5, \
            (k, rel_err(port[k].numpy(), oracle[k].numpy()))


def test_render_without_grad_saves_nothing():
    """No input needs a gradient: the forward kernels alone, no autograd
    node (so no residuals kept)."""
    tg, tc = F.torch_objects(F.make_scene())
    out = render(tc, tg, torch.tensor(BG), **RENDER_KW)
    assert out.image.grad_fn is None
    with torch.no_grad():
        params = {k: v.clone().requires_grad_() for k, v in tg.params().items()}
        out = render(tc, tg.replace(**params), torch.tensor(BG), **RENDER_KW)
    assert out.image.grad_fn is None


def test_contrib_overflow_zeroes_every_gradient():
    tg, tc = F.torch_objects(F.make_scene())
    target = target_image()
    full, out_full = torch_grads(tg, tc, target)
    budget = F.CHUNK
    grads, out = torch_grads(tg, tc, target, contrib_budget=budget)
    assert int(out.n_contrib) > budget and int(out.n_contrib) == int(out_full.n_contrib)
    torch.testing.assert_close(out.image, out_full.image, rtol=0, atol=0)
    for k in GROUPS:
        assert float(full[k].abs().max()) > 0, k
        assert float(grads[k].abs().max()) == 0.0, k


# ------------------------------------------------------------ train step


@pytest.fixture(scope="module")
def train_runs():
    """Three steps of the JAX make_train_step and of the port's from the same
    numpy state -> per step (JAX outputs, port outputs) as numpy."""
    s = F.make_scene(**GRAD_SCENES["sparse"])
    target = target_image()
    jg, _ = F.jax_objects(s)
    from gsplat_tpu.core.camera import make_camera as j_make_camera

    jc = j_make_camera(s.R, s.T, fovx=F.FOVX, fovy=F.FOVY, width=F.W, height=F.H,
                       image=target)
    tg, _ = F.torch_objects(s)
    tc = camera_from_numpy(s.R, s.T, F.FOVX, F.FOVY, F.W, F.H, image=target, device="cpu")
    j_step = j_make_train_step(JOpt(), JMeshParams(tile_size=F.TILE, chunk_size=F.CHUNK,
                                                   pair_budget=F.BUDGET), 1.0, F.W, F.H)
    t_step = make_train_step(OptimizationParams(), MeshParams(
        tile_size=F.TILE, chunk_size=F.CHUNK, pair_budget=F.BUDGET), 1.0, F.W, F.H)
    js = j_init_adam(jg.params())
    mu, nu, count = ({k: np.asarray(v) for k, v in js.mu.items()},
                     {k: np.asarray(v) for k, v in js.nu.items()}, int(js.count))
    ts = adam_state_from_numpy(mu, nu, count, device="cpu")
    j_ema, t_ema = jnp.zeros((), jnp.float32), torch.zeros(())
    runs = []
    for step in (1, 2, 3):
        jo = j_step(jg, js, jc, jnp.asarray(BG, jnp.float32), jnp.asarray(step, jnp.int32),
                    j_ema)
        to = t_step(tg, ts, tc, torch.tensor(BG), step, t_ema)
        jg, js, j_ema = jo[0], jo[1], jo[3]
        tg, ts, t_ema = to[0], to[1], to[3]
        j_state = {k: np.asarray(getattr(jg, k)) for k in
                   ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
                    "max_radii2D", "xyz_gradient_accum", "denom")}
        runs.append(dict(
            jax=dict(g=j_state, mu={k: np.asarray(v) for k, v in js.mu.items()},
                     nu={k: np.asarray(v) for k, v in js.nu.items()}, count=int(js.count),
                     scalars=[float(x) for x in jo[2:4]] + [int(x) for x in jo[4:]]),
            port=dict(g=gaussians_to_numpy(tg), **dict(zip(("mu", "nu", "count"),
                                                          adam_state_to_numpy(ts))),
                      scalars=[float(x) for x in to[2:4]] + [int(x) for x in to[4:]])))
    return runs


def test_train_steps_match_reference(train_runs):
    opt = OptimizationParams()
    lr_sum = {"xyz": 3 * opt.position_lr_init, "f_dc": 3 * opt.feature_lr,
              "f_rest": 3 * opt.feature_lr / 20, "opacity": 3 * opt.opacity_lr,
              "scaling": 3 * opt.scaling_lr, "rotation": 3 * opt.rotation_lr}
    for i, run in enumerate(train_runs):
        j, t = run["jax"], run["port"]
        jl, jema, *j_tel = j["scalars"]
        tl, tema, *t_tel = t["scalars"]
        assert abs(tl - jl) <= 1e-6 * jl and abs(tema - jema) <= 1e-6 * jema, (i, tl, jl)
        assert t_tel == j_tel, (i, t_tel, j_tel)      # pairs, dropped, culled, contrib, sat
        assert t["count"] == j["count"] == i + 1
        np.testing.assert_array_equal(t["g"]["denom"], j["g"]["denom"])
        np.testing.assert_array_equal(t["g"]["max_radii2D"], j["g"]["max_radii2D"])
        assert rel_err(t["g"]["xyz_gradient_accum"], j["g"]["xyz_gradient_accum"]) <= 2e-4
        for k in lr_sum:
            assert rel_err(t["mu"][k], j["mu"][k]) <= 2e-4, (i, k)
            assert rel_err(t["nu"][k], j["nu"][k]) <= 4e-4, (i, k)
            # where the gradient's sign is determined, Adam moves both alike
            sure = np.abs(j["mu"][k]) > 1e-2 * np.abs(j["mu"][k]).max()
            np.testing.assert_allclose(t["g"][k][sure], j["g"][k][sure], rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i + 1} {k}")
            assert np.abs(t["g"][k] - j["g"][k]).max() <= 2 * lr_sum[k] * (1 + 1e-3)
    first, last = train_runs[0]["port"], train_runs[-1]["port"]
    assert last["scalars"][0] < first["scalars"][0]
    assert (last["g"]["denom"] <= 3).all() and (last["g"]["denom"] == 3).any()


def test_train_step_with_saturation_cull_is_bit_identical():
    """One step with sat_budget (and one with MeshParams.sat_frac > 0) on the
    saturating scene against one without: loss, parameters, moments and
    densification statistics bit-equal, n_sat > 0 returned."""
    scene, target = F.make_sat_scene()
    tg, _ = F.torch_objects(scene, F.SAT_W, F.SAT_H)
    tc = camera_from_numpy(scene.R, scene.T, scene.fovx, scene.fovy, F.SAT_W, F.SAT_H,
                           image=target, device="cpu")
    bg = torch.zeros(3)
    kw = F.SAT_KW
    # the probe: a sat budget that cannot overflow gives the rows needed
    with torch.no_grad():
        probe = render(tc, tg, bg, tile_size=kw["tile_size"], chunk=kw["chunk"],
                       pair_budget=kw["pair_budget"], sat_budget=kw["pair_budget"])
    n_sat, n_pairs, n_culled, n_dropped = (probe.n_sat, probe.n_pairs, probe.n_culled,
                                           probe.n_dropped)
    assert 0 < int(n_sat) < int(n_pairs) - int(n_culled) and int(n_dropped) == 0
    mesh = dict(tile_size=kw["tile_size"], chunk_size=kw["chunk"],
                pair_budget=kw["pair_budget"])
    fitted = -(-int(n_sat) // 8) * 8
    steps = {
        "base": make_train_step(OptimizationParams(), MeshParams(**mesh), 1.0, F.SAT_W,
                                F.SAT_H, kept_budget=kw["kept_budget"]),
        "sat_budget": make_train_step(OptimizationParams(), MeshParams(**mesh), 1.0,
                                      F.SAT_W, F.SAT_H, kept_budget=kw["kept_budget"],
                                      sat_budget=fitted),
        # _sat_budget0: sat_frac of the pair budget
        "sat_frac": make_train_step(OptimizationParams(), MeshParams(**mesh, sat_frac=0.5),
                                    1.0, F.SAT_W, F.SAT_H, kept_budget=kw["kept_budget"]),
    }
    outs = {k: fn(tg, init_adam_state(tg.params()), tc, bg, 1, 0.0)
            for k, fn in steps.items()}
    base = outs["base"]
    assert int(base[8]) == 0
    for name in ("sat_budget", "sat_frac"):
        out = outs[name]
        assert int(out[8]) == int(n_sat) and int(out[5]) == 0, name
        assert torch.equal(out[2], base[2]), name                     # loss
        assert [int(x) for x in out[4:8]] == [int(x) for x in base[4:8]], name
        for k, v in base[0].params().items():
            assert torch.equal(out[0].params()[k], v), (name, k)
        for k in ("xyz_gradient_accum", "denom", "max_radii2D"):
            assert torch.equal(getattr(out[0], k), getattr(base[0], k)), (name, k)
        for k in base[1].mu:
            assert torch.equal(out[1].mu[k], base[1].mu[k]), (name, k)
            assert torch.equal(out[1].nu[k], base[1].nu[k]), (name, k)
    assert float(base[0].xyz_gradient_accum.abs().max()) > 0
