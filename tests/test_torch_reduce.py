"""Port parity, the per-Gaussian gradient reduction:
gsplat_tpu_torch.render.render.reduce_by_gid (the plain versions of
segment_ends and segment_sum on the CPU) against the JAX package's
reduction in gsplat_tpu.render.render._rasterize_bwd (a stable key sort, a
float32 cumsum table and its difference at the segment ends) on the same
d-tables, and against an exact float64 sum in numpy.

The JAX backward is run with its compositing kernel replaced by the given
d-table, so the two packages reduce the same rows. Tolerances: within 2e-4
of each column's max |value| of the JAX table (the JAX float32 cumsum
difference loses the digits the running sum has grown past); within 1e-6
of each column's max of the exact sum (the port's float64 sum is rounded
to float32 once: one ulp apart at most, where numpy adds in another
order). The tables: the backward of the fixture scenes (real d-tables, in
tile order), and crafted ones: gid 0 with no rows, trailing gids with no
rows, one gid owning every row, every row inert (KEY_INVALID), and a
segment longer than a warp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fixtures as F
from gsplat_tpu.render import render as jrender
from gsplat_tpu_torch.render import raster as traster
from gsplat_tpu_torch.render.binning import out_budget, tile_grid
from gsplat_tpu_torch.render.reduce import segment_sum, segment_sum_plain
from gsplat_tpu_torch.render.render import contrib_regions, reduce_by_gid
from torch_port_fixtures import D_TABLE_CASES, SCENES, crafted_d_table, pair_tables

torch.set_num_threads(1)
RTOL_JAX = 2e-4
RTOL_EXACT = 1e-6


def jax_reduction(d: np.ndarray, n_rows: int, monkeypatch) -> np.ndarray:
    """The JAX package's per-Gaussian table of d-table `d` ((c, 16) numpy):
    _rasterize_bwd with its composite_bwd returning `d`."""
    c = d.shape[0]
    monkeypatch.setattr(jrender, "composite_bwd", lambda *a, **k: jnp.asarray(d.T))
    static = (1, 1, F.TILE, 1, c, c, True, False)
    res = (jnp.zeros((16, c), jnp.float32), jnp.zeros(1, jnp.int32),
           jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32), jnp.asarray(True),
           jnp.zeros((1, 4, F.TILE * F.TILE), jnp.float32), n_rows)
    out = jrender._rasterize_bwd(static, res, (jnp.zeros((1, 4, F.TILE * F.TILE)), None))
    return np.asarray(out[0])


def exact(d: np.ndarray, n_rows: int) -> np.ndarray:
    """float64 sums of each gid's rows (columns 0..8), rounded to float32."""
    out = np.zeros((n_rows, traster.ATTR_DIM), np.float64)
    key = d[:, traster.KEY_COL]
    live = key != traster.KEY_INVALID
    np.add.at(out[:, :traster.N_DCOLS], key[live].astype(np.int64),
              d[live, :traster.N_DCOLS].astype(np.float64))
    out[n_rows - 1] = 0.0
    return out.astype(np.float32)


def assert_close(got, want, rtol):
    for c in range(traster.N_DCOLS):
        scale = max(float(np.abs(want[:, c]).max()), 1e-30)
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=0, atol=rtol * scale,
                                   err_msg=f"column {c}")
    assert (got[:, traster.N_DCOLS:] == 0).all()


def scene_d_table(name):
    """The plain composite_bwd's d-table of a fixture scene under a seeded
    cotangent, and the table's row count for its Gaussians (capacity + 1)."""
    tw, th = tile_grid(F.W, F.H, F.TILE)
    gathered, ts, tc = pair_tables(F.make_scene(**SCENES[name]))
    gid = F.table_gids(gathered)
    tiles, nproc = traster.composite_fwd(gathered, ts, tc, tw=tw, tile_size=F.TILE,
                                         chunk=F.CHUNK, gid=gid)
    p_out = out_budget(gathered.shape[0], tw * th, F.CHUNK)
    np_c, comp_start, _ = contrib_regions(nproc, F.CHUNK, p_out)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=tiles.shape).astype(np.float32))
    d = traster.composite_bwd(gathered, ts, tc, comp_start, np_c, tiles, g, tw=tw,
                              tile_size=F.TILE, chunk=F.CHUNK, p_out=p_out, gid=gid)
    return d.numpy(), F.make_scene().params["xyz"].shape[0] + 1


@pytest.mark.parametrize("name", list(SCENES))
def test_reduce_by_gid_matches_reference_on_scene_tables(name, monkeypatch):
    d, n_rows = scene_d_table(name)
    got = reduce_by_gid(torch.from_numpy(d), n_rows).numpy()
    assert got.shape == (n_rows, traster.ATTR_DIM) and got.dtype == np.float32
    want = exact(d, n_rows)
    assert_close(got, want, RTOL_EXACT)
    assert_close(got, jax_reduction(d, n_rows, monkeypatch), RTOL_JAX)
    assert np.abs(got).max() > 0 and (got[-1] == 0).all()


@pytest.mark.parametrize("case", D_TABLE_CASES)
def test_reduce_by_gid_crafted_tables(case, monkeypatch):
    d, n_rows = crafted_d_table(case)
    got = reduce_by_gid(torch.from_numpy(d), n_rows).numpy()
    want = exact(d, n_rows)
    assert_close(got, want, RTOL_EXACT)
    assert_close(got, jax_reduction(d, n_rows, monkeypatch), RTOL_JAX)
    owned = np.zeros(n_rows, bool)
    key = d[:, traster.KEY_COL]
    owned[key[key != traster.KEY_INVALID].astype(np.int64)] = True
    assert (got[~owned] == 0).all()
    if case == "all_invalid":
        assert (got == 0).all()


def test_segment_sum_plain_reads_through_the_permutation():
    """Gaussian g sums the rows at sorted positions [ends[g-1], ends[g]),
    each read through the permutation, in float64 rounded once: here three
    rows whose float32 running sum would lose the small one."""
    d = torch.zeros((4, traster.ATTR_DIM))
    d[:, 0] = torch.tensor([1e8, 3.0, -1e8, 5.0])
    perm = torch.tensor([0, 1, 2, 3])
    ends = torch.tensor([3, 4], dtype=torch.int32)
    out = segment_sum(d, perm, ends, 3)
    assert out[:, 0].tolist() == [3.0, 5.0, 0.0]
    assert torch.equal(out, segment_sum_plain(d, perm, ends, 3))
    assert (out[:, 1:] == 0).all()
