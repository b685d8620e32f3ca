"""Port parity, the compositing backward: gsplat_tpu_torch.render.raster.
composite_bwd (its plain version on the CPU) against gsplat_tpu's
composite_bwd Pallas kernel in interpret mode, on the same pair table, tile
tables, forward tiles and a seeded cotangent.

Keys (each row's gid, KEY_INVALID on masked and unwritten rows) exactly
equal; each d column within 2e-4 of that column's max |value| (the
reference's interpret mode sums the pixels through bf16-split matmuls,
~2^-16 relative, and the two sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fixtures as F
from gsplat_tpu.render.raster_pallas import composite_bwd as j_composite_bwd
from gsplat_tpu_torch.render import raster as traster
from gsplat_tpu_torch.render.binning import out_budget, tile_grid
from gsplat_tpu_torch.render.render import contrib_regions
from torch_port_fixtures import SCENES, banded_tile, crafted_tiles, pair_tables, skip_edge_tile

torch.set_num_threads(1)
RTOL_COL = 2e-4
TW, TH = tile_grid(F.W, F.H, F.TILE)


@pytest.fixture(scope="module")
def inputs():
    """Per scene: (gathered, tile_start, tile_count, tiles, nproc, cotangent)."""
    out = {}
    for name, kw in SCENES.items():
        gathered, ts, tc = pair_tables(F.make_scene(**kw))
        tiles, nproc = traster.composite_fwd(gathered, ts, tc, tw=TW, tile_size=F.TILE,
                                             chunk=F.CHUNK, gid=F.table_gids(gathered))
        g = np.random.default_rng(3).normal(size=tiles.shape).astype(np.float32)
        out[name] = (gathered, ts, tc, tiles, nproc, torch.from_numpy(g))
    return out


def both(gathered, ts, tc, tiles, g, comp_start, np_c, p_out, tw=TW, tile=F.TILE,
         chunk=F.CHUNK):
    want = j_composite_bwd(
        jnp.asarray(gathered.numpy().T), jnp.asarray(ts.numpy()), jnp.asarray(tc.numpy()),
        jnp.asarray(comp_start.numpy()), jnp.asarray(np_c.numpy()),
        jnp.asarray(tiles.numpy()), jnp.asarray(g.numpy()), num_tiles=ts.shape[0], tw=tw,
        tile_size=tile, chunk=chunk, p_out=p_out, interpret=True)
    got = traster.composite_bwd(gathered, ts, tc, comp_start, np_c, tiles, g, tw=tw,
                                tile_size=tile, chunk=chunk, p_out=p_out,
                                gid=F.table_gids(gathered))
    return got.numpy(), np.asarray(want).T


def assert_rows_match(got, want, rows):
    np.testing.assert_array_equal(got[rows, traster.KEY_COL], want[rows, traster.KEY_COL])
    for c in range(traster.N_DCOLS):
        scale = max(float(np.abs(want[rows, c]).max()), 1e-12)
        np.testing.assert_allclose(got[rows, c], want[rows, c], rtol=0,
                                   atol=RTOL_COL * scale, err_msg=f"column {c}")
    assert (got[rows, traster.KEY_COL + 1:] == 0).all()


def coverage(comp_start, np_c, p_out):
    """How many tiles' regions cover each row of the d-table."""
    cov = np.zeros(p_out, np.int64)
    for s, k in zip(comp_start.tolist(), np_c.tolist()):
        cov[s:s + k * F.CHUNK] += 1
    return cov


def inert(d, rows):
    return (d[rows, :traster.KEY_COL] == 0).all() and \
        (d[rows, traster.KEY_COL] == traster.KEY_INVALID).all() and \
        (d[rows, traster.KEY_COL + 1:] == 0).all()


@pytest.mark.parametrize("name", list(SCENES))
def test_composite_bwd_matches_reference(inputs, name):
    gathered, ts, tc, tiles, nproc, g = inputs[name]
    p_out = out_budget(gathered.shape[0], TW * TH, F.CHUNK)
    np_c, comp_start, overflow = contrib_regions(nproc, F.CHUNK, p_out)
    assert not bool(overflow)
    got, want = both(gathered, ts, tc, tiles, g, comp_start, np_c, p_out)
    assert_rows_match(got, want, np.arange(p_out))
    cov = coverage(comp_start, np_c, p_out)
    written = cov > 0
    assert inert(got, ~written) and (~written).any()
    # real gids on the rows of tile segments, and their d-values nonzero
    valid = got[written, traster.KEY_COL] != traster.KEY_INVALID
    assert valid.any() and np.abs(got[written][valid, :traster.N_DCOLS]).max() > 0


def test_tile_with_no_replayed_chunks_writes_nothing(inputs):
    """A tile with nproc = 0 (its region empty) leaves the prefill alone,
    even where a busy tile's region would have begun."""
    gathered, ts, tc, tiles, nproc, g = inputs["sparse"]
    busy = int(torch.argmax(nproc))
    assert int(nproc[busy]) > 0
    nproc0 = nproc.clone()
    nproc0[busy] = 0
    p_out = out_budget(gathered.shape[0], TW * TH, F.CHUNK)
    np_c, comp_start, _ = contrib_regions(nproc0, F.CHUNK, p_out)
    got, want = both(gathered, ts, tc, tiles, g, comp_start, np_c, p_out)
    assert_rows_match(got, want, np.arange(p_out))
    full, _, _ = contrib_regions(nproc, F.CHUNK, p_out)
    assert int(np_c.sum()) == int(full.sum()) - int(nproc[busy])
    assert inert(got, coverage(comp_start, np_c, p_out) == 0)


def test_contrib_overflow_clamps_regions(inputs):
    """A contrib budget below the replayed rows: overflow is flagged, every
    region is clamped inside the table (regions may then overlap; the
    render zeroes that step's gradient), rows one region covers match the
    reference and rows none covers stay inert."""
    gathered, ts, tc, tiles, nproc, g = inputs["sparse"]
    rows_needed = int(nproc.sum()) * F.CHUNK
    p_out = (rows_needed // F.CHUNK - 2) * F.CHUNK
    np_c, comp_start, overflow = contrib_regions(nproc, F.CHUNK, p_out)
    assert bool(overflow)
    # the reference's clamp (render.py:109-117), in numpy
    sizes = np.minimum(nproc.numpy(), p_out // F.CHUNK).astype(np.int64) * F.CHUNK
    cum = np.cumsum(sizes)
    np.testing.assert_array_equal(comp_start.numpy(), np.minimum(cum - sizes, p_out - sizes))
    assert ((comp_start.numpy() + sizes) <= p_out).all() and (comp_start.numpy() >= 0).all()
    got, want = both(gathered, ts, tc, tiles, g, comp_start, np_c, p_out)
    cov = coverage(comp_start, np_c, p_out)
    assert (cov > 1).any()
    assert_rows_match(got, want, np.nonzero(cov == 1)[0])
    if (cov == 0).any():
        assert inert(got, cov == 0)


@pytest.mark.parametrize("chunk", [8, 32])
def test_composite_bwd_skip_edges_match_reference(chunk):
    """The warp skip's edge cases (torch_port_fixtures.skip_edge_tile: op 0,
    op < 1/255, op 1, power > 0, power within 1e-3 of the threshold on either
    side) at tile 16 against the JAX kernel. A pair whose power lies below
    its threshold at every pixel of the tile (the kernel skips it in every
    warp) has d-values exactly 0; the near-threshold pairs do not."""
    tile = 16
    attrs, ts, tc = map(torch.from_numpy, skip_edge_tile(tile, chunk))
    tiles, nproc = traster.composite_fwd(attrs, ts, tc, tw=1, tile_size=tile, chunk=chunk,
                                         gid=F.table_gids(attrs))
    p_out = out_budget(attrs.shape[0], 1, chunk)
    np_c, comp_start, overflow = contrib_regions(nproc, chunk, p_out)
    assert not bool(overflow) and int(np_c[0]) >= 1
    g = torch.from_numpy(np.random.default_rng(5).normal(size=tiles.shape).astype(np.float32))
    got, want = both(attrs, ts, tc, tiles, g, comp_start, np_c, p_out, tw=1, tile=tile,
                     chunk=chunk)
    assert_rows_match(got, want, np.arange(p_out))
    # region row of segment row i: comp_start + (ts % chunk) + i
    rows = int(comp_start[0]) + int(ts[0]) % chunk + np.arange(int(tc[0]))
    h = tile // 2
    pix = torch.arange(tile * tile)
    px, py = (pix % tile - h).float(), (pix // tile - h).float()
    a = attrs[int(ts[0]):int(ts[0] + tc[0])]
    dx, dy = px - (a[:, 0] - h)[:, None], py - (a[:, 1] - h)[:, None]
    power = -((0.5 * a[:, 2:3]) * (dx * dx) + a[:, 3:4] * (dx * dy)
              + (0.5 * a[:, 4:5]) * (dy * dy))
    skipped = (power < traster.skip_threshold(a[:, 8])[:, None]).all(1).numpy()
    assert skipped[:2].all() and skipped.any() and not skipped.all()
    assert (got[rows[skipped], :traster.N_DCOLS] == 0).all()
    assert (np.abs(got[rows[~skipped], :traster.N_DCOLS]).max(1) > 0).any()


@pytest.mark.parametrize("tile,chunk,table", [(48, 8, "crafted"), (64, 32, "crafted"),
                                              (64, 8, "banded"), (96, 8, "crafted"),
                                              (128, 32, "crafted"), (96, 32, "banded"),
                                              (128, 8, "banded"), (128, 8, "columns")])
def test_composite_bwd_large_tiles_match_reference(tile, chunk, table):
    """Tiles above 32, which the kernel replays in pixel passes (above 64
    window by window), against the JAX kernel: crafted tiles, and a tile
    whose bands (at tile 64 the passes) or columns saturate at different
    chunks, so the rows of every replayed chunk take pixels of some passes
    or windows that are still open and some that are saturated."""
    if table == "crafted":
        attrs, ts, tc = map(torch.from_numpy, crafted_tiles(3, 2, tile, chunk))
        tw = 3
    else:
        attrs, ts, tc = map(torch.from_numpy,
                            banded_tile(tile, chunk, int(table == "columns"))[:3])
        tw = 1
    tiles, nproc = traster.composite_fwd(attrs, ts, tc, tw=tw, tile_size=tile, chunk=chunk,
                                         gid=F.table_gids(attrs))
    p_out = out_budget(attrs.shape[0], ts.shape[0], chunk)
    np_c, comp_start, overflow = contrib_regions(nproc, chunk, p_out)
    assert not bool(overflow)
    g = torch.from_numpy(np.random.default_rng(tile).normal(size=tiles.shape).astype(np.float32))
    got, want = both(attrs, ts, tc, tiles, g, comp_start, np_c, p_out, tw=tw, tile=tile,
                     chunk=chunk)
    assert_rows_match(got, want, np.arange(p_out))
    valid = got[:, traster.KEY_COL] != traster.KEY_INVALID
    assert valid.sum() > chunk and np.abs(got[valid, :traster.N_DCOLS]).max() > 0
