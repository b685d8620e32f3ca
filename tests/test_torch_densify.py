"""Port parity, densification: gsplat_tpu_torch's add_densification_stats,
densify_and_prune, reset_opacity, grow_capacity and oneup_sh_degree on the
CPU against gsplat_tpu's on the same numpy inputs.

The cases are those of tests/test_densify.py (stats, clone, split, prune,
optimizer surgery, reset, capacity overflow), plus a size prune and a mixed
case where clones, splits and prunes land in one pass. The split noise is
the JAX draw (jax.random.normal of the same key) passed into the port.
Integer outputs (n_live, n_dropped, the capacity) are bit-equal; floats are
within 1e-6 relative of each leaf's max."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core.gaussians import create_from_pcd as j_create_from_pcd
from gsplat_tpu.core.gaussians import grow_capacity as j_grow_capacity
from gsplat_tpu.train import densify as jd
from gsplat_tpu.train.optim import init_adam_state as j_init_adam
from gsplat_tpu_torch.core.gaussians import grow_capacity
from gsplat_tpu_torch.interop import (adam_state_from_numpy, adam_state_to_numpy,
                                      gaussians_from_numpy, gaussians_to_numpy)
from gsplat_tpu_torch.train import densify as td

torch.set_num_threads(1)
FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "max_radii2D",
          "xyz_gradient_accum", "denom")
RTOL = 1e-6


def j_scene(n=8, capacity=32, seed=0):
    rng = np.random.default_rng(seed)
    g = j_create_from_pcd(rng.normal(size=(n, 3)), rng.random((n, 3)), capacity=capacity)
    return g, j_init_adam(g.params())


def to_port(g, opt):
    tg = gaussians_from_numpy({k: np.asarray(getattr(g, k)) for k in FIELDS}, int(g.n_live),
                              g.active_sh_degree, g.max_sh_degree, device="cpu",
                              spatial_lr_scale=g.spatial_lr_scale)
    tops = adam_state_from_numpy({k: np.asarray(v) for k, v in opt.mu.items()},
                                 {k: np.asarray(v) for k, v in opt.nu.items()},
                                 int(opt.count), device="cpu")
    return tg, tops


def close(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def same_state(tg, tops, g, opt):
    got = gaussians_to_numpy(tg)
    for k in FIELDS:
        close(got[k], getattr(g, k), k)
    assert int(got["n_live"]) == int(g.n_live)
    mu, nu, count = adam_state_to_numpy(tops)
    for k in opt.mu:
        close(mu[k], opt.mu[k], f"mu_{k}")
        close(nu[k], opt.nu[k], f"nu_{k}")
    assert count == int(opt.count)


# each case: (scene kwargs, edit of the JAX state, densify kwargs); the edits
# are those of tests/test_densify.py
def _clone(g, opt):
    return g.replace(xyz_gradient_accum=jnp.zeros(g.capacity).at[0].set(1.0),
                     denom=jnp.zeros(g.capacity).at[0].set(1.0)), opt


def _split(g, opt):
    return g.replace(scaling=jnp.where(g.live_mask[:, None], jnp.log(5.0), g.scaling),
                     xyz_gradient_accum=jnp.zeros(g.capacity).at[1].set(1.0),
                     denom=jnp.zeros(g.capacity).at[1].set(1.0)), opt


def _prune(g, opt):
    return g.replace(opacity=g.opacity.at[2].set(jd.inverse_sigmoid(jnp.asarray([[0.001]]))[0])), opt


def _surgery(g, opt):
    g, _ = _clone(g, opt)
    return g, opt.replace(mu={k: v + 7.0 for k, v in opt.mu.items()},
                          nu={k: v + 3.0 for k, v in opt.nu.items()})


def _overflow(g, opt):
    return g.replace(xyz_gradient_accum=jnp.ones(g.capacity), denom=jnp.ones(g.capacity)), opt


def _size_prune(g, opt):
    big = jnp.zeros(g.capacity).at[3].set(25.0)
    return g.replace(max_radii2D=big, scaling=g.scaling.at[4].set(jnp.log(20.0))), opt


def _mixed(g, opt):
    """Clones, splits and prunes in one pass, accumulators well off the
    threshold; rotations random (the split offset rotates the noise)."""
    rng = np.random.default_rng(3)
    cap, n = g.capacity, int(g.n_live)
    accum = np.zeros(cap, np.float32)
    denom = np.zeros(cap, np.float32)
    accum[:n] = rng.choice([0.1, 2.0], n) * rng.uniform(1, 3, n)
    denom[:n] = rng.integers(1, 4, n)
    scaling = np.asarray(g.scaling).copy()
    scaling[:n] = np.log(rng.choice([0.005, 0.5], (n, 1)) * rng.uniform(0.5, 1.5, (n, 3)))
    opacity = np.asarray(g.opacity).copy()
    opacity[:n:5] = -8.0
    rot = np.asarray(g.rotation).copy()
    rot[:n] = rng.normal(size=(n, 4))
    mu = {k: v + jnp.asarray(rng.normal(size=v.shape), jnp.float32) for k, v in opt.mu.items()}
    nu = {k: v + jnp.asarray(rng.random(v.shape), jnp.float32) for k, v in opt.nu.items()}
    return g.replace(xyz_gradient_accum=jnp.asarray(accum), denom=jnp.asarray(denom),
                     scaling=jnp.asarray(scaling), opacity=jnp.asarray(opacity),
                     rotation=jnp.asarray(rot)), opt.replace(mu=mu, nu=nu)


KW = dict(min_opacity=0.001, max_screen_size=0.0, percent_dense=0.01)
CASES = {
    "clone": ({}, _clone, dict(KW, max_grad=0.5, extent=1000.0)),
    "split": ({}, _split, dict(KW, max_grad=0.5, extent=1.0)),
    "prune": ({}, _prune, dict(KW, max_grad=9e9, min_opacity=0.005, extent=100.0)),
    "optimizer_surgery": ({}, _surgery, dict(KW, max_grad=0.5, extent=1000.0)),
    "capacity_overflow": (dict(n=8, capacity=9), _overflow,
                          dict(KW, max_grad=0.0001, extent=100.0)),
    "size_prune": ({}, _size_prune, dict(KW, max_grad=9e9, extent=100.0, max_screen_size=20.0)),
    "mixed": (dict(n=40, capacity=128, seed=2), _mixed,
              dict(KW, max_grad=0.5, min_opacity=0.005, extent=5.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_and_prune_matches_jax(case):
    scene_kw, edit, kw = CASES[case]
    g, opt = edit(*j_scene(**scene_kw))
    key = jax.random.PRNGKey(0)
    g2, opt2, dropped = jd.densify_and_prune(g, opt, key, **kw)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (g.capacity, 3), jnp.float32)))
    tg, tops = to_port(g, opt)
    tg2, tops2, tdropped = td.densify_and_prune(tg, tops, noise, **kw)
    assert int(tdropped) == int(dropped)
    same_state(tg2, tops2, g2, opt2)
    src, kind, valid, total = td.densify_selection(tg, **kw)
    n_new = int(tg2.n_live)
    assert bool(valid[:n_new].all()) and not bool(valid[n_new:].any())
    assert int(total) == n_new + int(tdropped)
    if case == "optimizer_surgery":  # kept rows carry their moments, new rows zeros
        n0 = int(g.n_live)
        assert np.allclose(tops2.mu["xyz"][:n0].numpy(), 7.0)
        assert np.allclose(tops2.mu["xyz"][n0].numpy(), 0.0)
    if case == "capacity_overflow":
        assert int(tdropped) > 0 and n_new == tg.capacity


def test_split_noise_draws_from_the_generator():
    gen = torch.Generator().manual_seed(5)
    a = td.split_noise(gen, 16)
    b = td.split_noise(torch.Generator().manual_seed(5), 16)
    assert a.shape == (16, 3) and a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, td.split_noise(gen, 16))


def test_stats_accumulation_matches_jax():
    g, _ = j_scene()
    grads = np.full((g.capacity, 2), 0.01, np.float32)
    grads[:, 1] = np.linspace(-0.02, 0.03, g.capacity)
    radii = np.where(np.arange(g.capacity) < 4, 5.0, 0.0).astype(np.float32)
    g = g.replace(max_radii2D=jnp.full(g.capacity, 3.0))
    want = jd.add_densification_stats(g, jnp.asarray(grads), jnp.asarray(radii), 100, 80)
    tg, _ = to_port(g, j_init_adam(g.params()))
    got = td.add_densification_stats(tg, torch.from_numpy(grads), torch.from_numpy(radii),
                                     100, 80)
    for k in ("xyz_gradient_accum", "denom", "max_radii2D"):
        close(getattr(got, k).numpy(), getattr(want, k), k)


def test_reset_opacity_matches_jax():
    g, opt = j_scene()
    g = g.replace(opacity=jnp.where(g.live_mask[:, None],
                                    jnp.linspace(-6.0, 5.0, g.capacity)[:, None], g.opacity))
    opt = opt.replace(mu={k: v + 2.0 for k, v in opt.mu.items()},
                      nu={k: v + 3.0 for k, v in opt.nu.items()})
    g2, opt2 = jd.reset_opacity(g, opt)
    tg, tops = to_port(g, opt)
    tg2, tops2 = td.reset_opacity(tg, tops)
    same_state(tg2, tops2, g2, opt2)
    assert float(tops2.nu["opacity"].abs().max()) == 0.0
    assert float((tops2.nu["xyz"] - 3.0).abs().max()) == 0.0


def test_grow_capacity_matches_jax():
    g, opt = _surgery(*j_scene())
    g = g.replace(denom=jnp.ones(g.capacity), max_radii2D=jnp.full(g.capacity, 2.0))
    want = j_grow_capacity(g, 80)
    tg, _ = to_port(g, opt)
    got = grow_capacity(tg, 80)
    assert got.capacity == want.capacity == 80
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert int(got.n_live) == int(want.n_live)


def test_oneup_sh_degree_matches_jax():
    g, opt = j_scene()
    tg, _ = to_port(g, opt)
    degrees = []
    for _ in range(5):
        g, tg = g.oneup_sh_degree(), tg.oneup_sh_degree()
        degrees.append((tg.active_sh_degree, g.active_sh_degree))
    assert degrees == [(1, 1), (2, 2), (3, 3), (3, 3), (3, 3)]
    assert tg.max_sh_degree == g.max_sh_degree == 3
