"""Port parity, the packed pair table (render(attr_pack=True)): rgb and
opacity as bf16 pairs in a (P, 8) table (render/raster.py).

The packing, and the packed rows read through the sorted gids, bit-equal
to the JAX package's packing and gathered table (raster_pallas.pack_attrs8,
_unpack_hi/_unpack_lo, render._gather_with_gid);
the plain compositors on a packed table against the JAX kernels' packed
branch in interpret mode, at test_torch_raster.py's (tiles 2e-5 abs, nproc
equal) and test_torch_raster_bwd.py's tolerances (keys equal, each d column
2e-4 of its max); and render_projected with attr_pack on a projection whose
rgb and opacity are already bf16 values bit-equal to the f32 table in
image, nproc and gradients (with the saturation cull, and on a band too).
GSPLAT_PACK's values as the JAX package reads them. No JAX render runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fixtures as F
from gsplat_tpu.render import raster_pallas as jr
from gsplat_tpu.render.render import _gather_with_gid as j_gather
from gsplat_tpu_torch.render import raster as traster
from gsplat_tpu_torch.render import render as trender
from gsplat_tpu_torch.render.binning import out_budget, tile_grid
from gsplat_tpu_torch.render.project import project_gaussians
from gsplat_tpu_torch.render.render import contrib_regions, render_projected
from torch_port_fixtures import SCENES, pair_tables

torch.set_num_threads(1)
ATOL = 2e-5       # test_torch_raster.py
RTOL_COL = 2e-4   # test_torch_raster_bwd.py
TW, TH = tile_grid(F.W, F.H, F.TILE)


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def attr_rows(seed=0, n=96):
    """(n, 16) float32 rows with rgb and opacity at values whose bf16
    rounding ties (to even both ways), at signed zeros, tiny and huge
    values, and random values."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 16)).astype(np.float32)
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x00008000, 0x7F7F8000],
                    np.uint32).view(np.float32)
    special = np.array([0.0, -0.0, 1e-40, 3e38, 1.0, 0.5, 0.99], np.float32)
    vals = np.concatenate([ties, special])
    for c in range(5, 9):
        a[:len(vals), c] = np.roll(vals, c)
    return a


def test_pack_and_unpack_bit_equal_to_jax():
    a = attr_rows()
    got = traster.pack_attrs8(torch.from_numpy(a))
    want = jr.pack_attrs8(jnp.asarray(a))
    assert got.shape == (a.shape[0], 7)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    for fn, jfn in ((traster._unpack_hi, jr._unpack_hi), (traster._unpack_lo, jr._unpack_lo)):
        for col in (5, 6):
            np.testing.assert_array_equal(bits(fn(got[:, col]).numpy()),
                                          bits(jfn(want[:, col])))
    # the unpacked table holds each value rounded to bf16, the gid in column 9
    packed = torch.cat([got, torch.arange(a.shape[0], dtype=torch.float32)[:, None]], 1)
    rows = traster.unpack_rows(packed)
    rounded = torch.from_numpy(a[:, 5:9]).to(torch.bfloat16).to(torch.float32)
    np.testing.assert_array_equal(bits(rows[:, 5:9].numpy()), bits(rounded.numpy()))
    np.testing.assert_array_equal(rows[:, :5].numpy(), a[:, :5])
    np.testing.assert_array_equal(rows[:, traster.KEY_COL].numpy(), np.arange(a.shape[0]))


def test_packed_gather_bit_equal_to_jax():
    a = attr_rows(seed=1, n=40)
    a[-1] = 0.0   # the inert null row
    gid = np.sort(np.random.default_rng(2).integers(0, a.shape[0], 300)).astype(np.int32)
    # the packed rows read through the gids, as the compositors read them
    got = trender._gid_rows(torch.from_numpy(a), True)[torch.from_numpy(gid).long()]
    want = np.asarray(j_gather(jnp.asarray(a), jnp.asarray(gid), True)).T
    assert got.shape == (300, traster.PACKED_IN_DIM)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def packed(gathered):
    """A (P, 16) pair table -> its packed (P, 8) table."""
    return torch.cat([traster.pack_attrs8(gathered), gathered[:, traster.KEY_COL:
                                                              traster.KEY_COL + 1]], 1)


@pytest.fixture(scope="module")
def tables():
    """Per scene: (packed table, tile_start, tile_count, forward tiles,
    nproc, a seeded cotangent)."""
    out = {}
    for name, kw in SCENES.items():
        gathered, ts, tc = pair_tables(F.make_scene(**kw))
        p = packed(gathered)
        tiles, nproc = traster.composite_fwd(p, ts, tc, tw=TW, tile_size=F.TILE,
                                             chunk=F.CHUNK, gid=F.table_gids(p))
        g = np.random.default_rng(3).normal(size=tiles.shape).astype(np.float32)
        out[name] = (p, ts, tc, tiles, nproc, torch.from_numpy(g))
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_composite_fwd_packed_matches_jax(tables, name):
    p, ts, tc, tiles, nproc, _ = tables[name]
    want_tiles, want_np = jr.composite_fwd(
        jnp.asarray(p.numpy().T), jnp.asarray(ts.numpy()), jnp.asarray(tc.numpy()),
        num_tiles=ts.shape[0], tw=TW, tile_size=F.TILE, chunk=F.CHUNK, interpret=True)
    np.testing.assert_allclose(tiles.numpy(), np.asarray(want_tiles), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(nproc.numpy(), np.asarray(want_np))
    assert int(nproc.sum()) > 0


@pytest.mark.parametrize("name", list(SCENES))
def test_composite_bwd_packed_matches_jax(tables, name):
    p, ts, tc, tiles, nproc, g = tables[name]
    p_out = out_budget(p.shape[0], ts.shape[0], F.CHUNK)
    np_c, comp_start, _ = contrib_regions(nproc, F.CHUNK, p_out)
    got = traster.composite_bwd(p, ts, tc, comp_start, np_c, tiles, g, tw=TW,
                                tile_size=F.TILE, chunk=F.CHUNK, p_out=p_out,
                                gid=F.table_gids(p)).numpy()
    want = np.asarray(jr.composite_bwd(
        jnp.asarray(p.numpy().T), jnp.asarray(ts.numpy()), jnp.asarray(tc.numpy()),
        jnp.asarray(comp_start.numpy()), jnp.asarray(np_c.numpy()), jnp.asarray(tiles.numpy()),
        jnp.asarray(g.numpy()), num_tiles=ts.shape[0], tw=TW, tile_size=F.TILE,
        chunk=F.CHUNK, p_out=p_out, interpret=True)).T
    rows = slice(0, int(np_c.sum()) * F.CHUNK)
    np.testing.assert_array_equal(got[:, traster.KEY_COL], want[:, traster.KEY_COL])
    for c in range(traster.N_DCOLS):
        scale = max(float(np.abs(want[rows, c]).max()), 1e-12)
        np.testing.assert_allclose(got[rows, c], want[rows, c], rtol=0,
                                   atol=RTOL_COL * scale, err_msg=f"column {c}")
    assert (got[rows, traster.KEY_COL + 1:] == 0).all()
    # the d-table of the packed table is the f32 table's of the same values
    same = traster.composite_bwd(traster.unpack_rows(p), ts, tc, comp_start, np_c, tiles, g,
                                 tw=TW, tile_size=F.TILE, chunk=F.CHUNK, p_out=p_out,
                                 gid=F.table_gids(p))
    np.testing.assert_array_equal(bits(got), bits(same.numpy()))


def bf16_projection(scene, width=F.W, height=F.H):
    """The port's projection of `scene` with rgb and opacity rounded to
    bf16 values, each field a leaf that requires its gradient."""
    g, cam = F.torch_objects(scene, width, height)
    proj = project_gaussians(g, cam)
    proj = proj._replace(rgb=proj.rgb.to(torch.bfloat16).to(torch.float32),
                         opacity=proj.opacity.to(torch.bfloat16).to(torch.float32))
    return proj._replace(**{k: getattr(proj, k).detach().requires_grad_()
                            for k in ("mean2d", "conic", "rgb", "opacity")})


def render_both(proj, width, height, tile=F.TILE, chunk=F.CHUNK, **kw):
    """render_projected with attr_pack False and True -> per table:
    (output, nproc, the gradients of a seeded linear loss by mean2d, conic,
    rgb and opacity, the widths of the tables the compositor saw)."""
    real = trender.composite_fwd
    res = []
    for pack in (False, True):
        seen = []

        def spy(attrs, *a, **k):
            out = real(attrs, *a, **k)
            seen.append((attrs.shape[1], out[1]))
            return out

        trender.composite_fwd = spy
        try:
            out = render_projected(proj, width, height, torch.tensor([0.1, 0.2, 0.3]),
                                   tile_size=tile, chunk=chunk, attr_pack=pack, **kw)
        finally:
            trender.composite_fwd = real
        w = torch.from_numpy(np.random.default_rng(4).normal(
            size=tuple(out.image.shape)).astype(np.float32))
        leaves = [proj.mean2d, proj.conic, proj.rgb, proj.opacity]
        grads = torch.autograd.grad((out.image * w).sum(), leaves)
        res.append((out, seen[0][1], grads, [s[0] for s in seen]))
    return res


def assert_same_bits(f32, pk):
    (o32, np32, g32, w32), (opk, nppk, gpk, wpk) = f32, pk
    assert w32 == [traster.ATTR_DIM] and wpk == [traster.PACKED_IN_DIM]
    np.testing.assert_array_equal(bits(o32.image.detach()), bits(opk.image.detach()))
    np.testing.assert_array_equal(np32.numpy(), nppk.numpy())
    for a, b in zip(g32, gpk):
        np.testing.assert_array_equal(bits(a), bits(b))
    assert any(bool((a != 0).any()) for a in g32)


@pytest.mark.parametrize("name", list(SCENES))
def test_render_projected_packed_bit_equal_on_bf16_values(name):
    proj = bf16_projection(F.make_scene(**SCENES[name]))
    f32, pk = render_both(proj, F.W, F.H, pair_budget=F.BUDGET)
    assert_same_bits(f32, pk)
    assert int(pk[0].n_dropped) == 0 and int(pk[0].n_contrib) > 0


def test_packed_with_sat_cull_and_on_a_band():
    """The saturation cull's scene at SAT_KW (gather on the survivors) and a
    band of the sparse scene (region): the packed table the f32 one's bits."""
    scene, _ = F.make_sat_scene()
    proj = bf16_projection(scene, F.SAT_W, F.SAT_H)
    kw = dict(F.SAT_KW, sat_budget=F.SAT_KW["pair_budget"])
    f32, pk = render_both(proj, F.SAT_W, F.SAT_H, kw.pop("tile_size"), kw.pop("chunk"), **kw)
    assert int(pk[0].n_sat) > 0 and int(pk[0].n_dropped) == 0
    assert_same_bits(f32, pk)
    proj = bf16_projection(F.make_scene(**SCENES["sparse"]))
    f32, pk = render_both(proj, F.W, F.H, pair_budget=F.BUDGET, region=(F.TILE, F.TILE))
    assert tuple(pk[0].image.shape) == (F.TILE, F.W, 3)
    assert_same_bits(f32, pk)


@pytest.mark.parametrize("env,cpu,cuda", [("0", False, False), ("1", True, True),
                                          ("auto", False, True)])
def test_gsplat_pack_values(monkeypatch, env, cpu, cuda):
    """GSPLAT_PACK as the JAX package reads it (raster_pallas.py:258-259),
    and the default it gives render_projected: "auto" is the f32 table on
    the CPU, the packed one on CUDA tensors."""
    assert traster.pack_default(env) is {"0": False, "1": True, "auto": None}[env]
    assert traster.pack_default("yes") is False
    monkeypatch.setattr(traster, "PACK_DEFAULT", traster.pack_default(env))
    assert traster.resolve_attr_pack(None, "cpu") is cpu
    assert traster.resolve_attr_pack(None, torch.device("cuda")) is cuda
    assert traster.resolve_attr_pack(False, "cuda") is False
    proj = bf16_projection(F.make_scene(**SCENES["sparse"]))
    seen = []
    real = trender.composite_fwd

    def spy(attrs, *a, **k):
        seen.append(attrs.shape[1])
        return real(attrs, *a, **k)

    monkeypatch.setattr(trender, "composite_fwd", spy)
    with torch.no_grad():
        render_projected(proj, F.W, F.H, torch.zeros(3), tile_size=F.TILE, chunk=F.CHUNK,
                         pair_budget=F.BUDGET)
    assert seen == [traster.PACKED_IN_DIM if cpu else traster.ATTR_DIM]


def test_serving_bench_json_line(capsys):
    """tools/serving_bench.py (the packed serve path's entry point) at a
    tiny size on the CPU: one JSON line with the reference script's keys
    and the power limit, every time finite."""
    import json
    import math

    from gsplat_tpu_torch.tools import serving_bench

    assert serving_bench.main(["--device", "cpu", "--n", "300", "--size", "64", "48",
                               "--budgets", "4096", "16384", "--iters", "1", "--pack"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = [f"{c}_{m}" for c in ("sparse", "dense")
            for m in ("ms", "fps", "pipelined_ms", "pipelined_fps")]
    assert set(got) == {"n_gaussians", "resolution", "attr_pack", "device",
                        "power_limit", *keys}
    assert got["attr_pack"] is True and got["device"] == "cpu" and got["power_limit"] is None
    assert got["resolution"] == "64x48" and got["n_gaussians"] == 300
    assert all(math.isfinite(got[k]) and got[k] > 0 for k in keys)
