"""The projection's closed-form backward against the JAX package.

`project_bwd_plain` (render/project.py: the plain version of the CUDA
backward kernel, the same formulas in the same order) is fed the inputs and
incoming gradients of every case of tests/test_torch_project.py, and
jax.vjp of gsplat_tpu's project_gaussians the same numpy inputs and the same
cotangents: each leaf's gradient within 2e-4 of the JAX gradient's largest
|value|, the parity tolerance of
tests/test_torch_train.py::test_render_gradients_match_reference.

The comparison leaves out the rows whose forward the two packages do not
agree on (conic more than 1e-5 apart, relative): a few of the crafted huge
anisotropic splats, whose det = A*C - B*B cancels terms some 1e16 times its
size, so float32 rounding alone picks its sign (visible or culled) and its
magnitude. The port's forward on them is the one it had before its
projection kernels (tests/test_torch_project.py holds it bit for bit); the
test asserts that no other row disagrees, and zeroes the incoming gradient
on those rows on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import vjp

import torch_port_fixtures as F
from gsplat_tpu.core.camera import make_camera as j_make_camera
from gsplat_tpu.core.gaussians import Gaussians as JGaussians
from gsplat_tpu.render.project import project_gaussians as j_project_gaussians
from gsplat_tpu_torch.render import project as P
from test_torch_project import CASES, CAP, LEAVES, N_LIVE, ROWS, incoming, make_params, objects

RTOL = 2e-4
CONIC_RTOL = 1e-5    # the rows whose forward the packages agree on


def jax_projection(case):
    """The JAX package's projection of one case -> (its conic as numpy, the
    VJP of (mean2d, conic, depth, rgb, opacity) with respect to the leaves:
    f_dc and f_rest left out, and no rgb, under an override colour)."""
    kw, mod, override, offset, _ = CASES[case]
    deg, max_deg = kw.get("deg", 3), kw.get("max_deg", 3)
    params = {k: jnp.asarray(v) for k, v in make_params(kw.get("seed", 0), max_deg).items()}
    R, T = F._look_at()
    cam = j_make_camera(R, T, fovx=F.FOVX, fovy=F.FOVY, width=F.W, height=F.H)
    names = [k for k in LEAVES if not (override and k in ("f_dc", "f_rest"))]
    extra = {}
    if override:
        extra["override_color"] = jnp.asarray(np.random.default_rng(11).random((CAP, 3)),
                                              jnp.float32)
    if offset:
        extra["mean2d_offset"] = jnp.zeros((CAP, 2), jnp.float32)

    def project(*leaves):
        g = JGaussians(**{**params, **dict(zip(names, leaves))},
                       n_live=jnp.asarray(N_LIVE, jnp.int32), active_sh_degree=deg,
                       max_sh_degree=max_deg)
        p = j_project_gaussians(g, cam, scaling_modifier=mod, **extra)
        outs = (p.mean2d, p.conic, p.depth, p.opacity)
        return outs if override else outs + (p.rgb,)

    outs, pull = vjp(project, *[params[k] for k in names])

    def leaf_grads(g_mean2d, g_conic, g_depth, g_rgb, g_opacity):
        cots = [g_mean2d, g_conic, g_depth, g_opacity] + ([] if override else [g_rgb])
        return [np.asarray(t) for t in pull(tuple(jnp.asarray(c.numpy()) for c in cots))]

    return np.asarray(outs[1]), leaf_grads


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax(case):
    kw, mod, override, _, rows = CASES[case]
    g, cam = objects(**kw)
    proj = P.project_plain(g, cam, mod)
    j_conic, j_grads = jax_projection(case)
    gap = (np.abs(proj.conic.numpy() - j_conic).max(1)
           / np.maximum(np.abs(j_conic).max(1), 1e-30))
    apart = np.nonzero(gap > CONIC_RTOL)[0]
    assert set(apart.tolist()) <= set(ROWS["det"]), apart
    keep = torch.ones(CAP, dtype=torch.bool)
    keep[torch.from_numpy(apart)] = False
    _, grads = incoming(proj, rows)
    grads = [gr * keep.view(-1, *([1] * (gr.dim() - 1))) for gr in grads]
    assert any(bool(gr.any()) for gr in grads)
    got = [t for t in P.project_bwd_plain(g, cam, mod, not override, *grads) if t is not None]
    want = j_grads(*grads)
    names = [k for k in LEAVES if not (override and k in ("f_dc", "f_rest"))]
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        err = float(np.abs(a.numpy() - b).max())
        assert err <= RTOL * scale + 1e-30, f"{name}: {err} against {RTOL} x {scale}"
