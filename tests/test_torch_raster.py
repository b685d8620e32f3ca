"""Port parity, compositing: gsplat_tpu_torch.render.raster.composite_fwd (its
plain version on the CPU) against gsplat_tpu's composite_fwd Pallas kernel in
interpret mode, on the same gathered pair table and tile tables.

tiles within 2e-5 abs (the README's parity tolerance: the two sum a chunk's
colour in different orders); nproc, the chunk count of the whole-tile early
exit, exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_fixtures as F
from gsplat_tpu.render.raster_pallas import composite_fwd as j_composite
from gsplat_tpu_torch.render import raster as traster
from gsplat_tpu_torch.render.binning import tile_grid
from torch_port_fixtures import SCENES, banded_tile, crafted_tiles, pair_tables, skip_edge_tile

torch.set_num_threads(1)
ATOL = 2e-5


def both(gathered, tile_start, tile_count, tw, tile, chunk):
    want_tiles, want_np = j_composite(
        jnp.asarray(gathered.numpy().T), jnp.asarray(tile_start.numpy()),
        jnp.asarray(tile_count.numpy()), num_tiles=tile_start.shape[0], tw=tw,
        tile_size=tile, chunk=chunk, interpret=True)
    got_tiles, got_np = traster.composite_fwd(gathered, tile_start, tile_count, tw=tw,
                                              tile_size=tile, chunk=chunk,
                                              gid=F.table_gids(gathered))
    np.testing.assert_allclose(got_tiles.numpy(), np.asarray(want_tiles), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got_np.numpy(), np.asarray(want_np))
    return got_tiles, got_np


@pytest.mark.parametrize("name", list(SCENES))
def test_composite_fwd_matches_reference(name):
    tw, _ = tile_grid(F.W, F.H, F.TILE)
    gathered, ts, tc = pair_tables(F.make_scene(**SCENES[name]))
    tiles, nproc = both(gathered, ts, tc, tw, F.TILE, F.CHUNK)
    head = ts - (ts // F.CHUNK) * F.CHUNK
    nch = (head + tc + F.CHUNK - 1) // F.CHUNK
    assert int(nproc.sum()) > 0
    if name == "dense":
        # some tiles stop before their last chunk, at a max T below T_EPS
        early = nproc < nch
        assert early.any(), (nproc, nch)
        assert (tiles[early, 3].amax(1) < traster.T_EPS).all()


def test_composite_fwd_empty_scene():
    s = F.make_scene()
    s = s._replace(n_live=0)
    tw, _ = tile_grid(F.W, F.H, F.TILE)
    gathered, ts, tc = pair_tables(s)
    tiles, nproc = both(gathered, ts, tc, tw, F.TILE, F.CHUNK)
    assert (nproc == 0).all()
    assert (tiles[:, :3] == 0).all() and (tiles[:, 3] == 1).all()


def test_early_exit_waits_for_pixels_below_the_image():
    """One 16x16 tile of an 8-row image: 96 opaque pairs saturate the 8 rows
    inside the image within the first chunk, but the tile's rows below the
    image stay above T_EPS, so the tile composites all 3 chunks (a rule over
    in-image pixels only would stop after 1)."""
    n, chunk, tile = 96, 32, 16
    attrs = torch.zeros((n, traster.ATTR_DIM))
    attrs[:, 0], attrs[:, 1] = 8.0, 3.0                     # mean at tile row 3
    attrs[:, 2], attrs[:, 4] = 1.0 / 2500.0, 1.0 / 16.0     # sigma 50 in x, 4 in y
    attrs[:, 5:8] = torch.linspace(0.1, 0.9, n)[:, None]
    attrs[:, 8] = 0.99
    attrs[:, 9] = torch.arange(n, dtype=torch.float32)
    ts, tc = torch.zeros(1, dtype=torch.int32), torch.full((1,), n, dtype=torch.int32)
    tiles, nproc = both(attrs, ts, tc, 1, tile, chunk)
    T = tiles[0, 3].reshape(tile, tile)
    assert int(nproc[0]) == 3
    assert float(T[:8].max()) < traster.T_EPS <= float(T[8:].max())
    # the same pairs into the in-image rows alone: saturated after chunk 1
    one, _ = traster.composite_fwd(attrs[:chunk], ts, torch.full((1,), chunk, dtype=torch.int32),
                                   tw=1, tile_size=tile, chunk=chunk,
                                   gid=F.table_gids(attrs[:chunk]))
    assert float(one[0, 3].reshape(tile, tile)[:8].max()) < traster.T_EPS


@pytest.mark.parametrize("tile,chunk", [(16, 8), (16, 32), (16, 128), (32, 8), (32, 32),
                                        (32, 128)])
def test_composite_fwd_crafted_tiles_match_reference(tile, chunk):
    """Empty tiles, segments that start mid-chunk and tiles that exit at a
    chunk boundary before their last chunk, at every tile size and chunk of
    the kernel's tests."""
    attrs, ts, tc = map(torch.from_numpy, crafted_tiles(3, 2, tile, chunk))
    _, nproc = both(attrs, ts, tc, 3, tile, chunk)
    head = ts % chunk
    nch = (head + tc + chunk - 1) // chunk
    assert ((tc == 0) & (head > 0)).any() and ((tc > 0) & (head > 0)).any()
    assert (nproc < nch).any()


@pytest.mark.parametrize("tile,chunk,table", [(48, 8, "crafted"), (64, 32, "crafted"),
                                              (48, 8, "banded"), (64, 32, "banded"),
                                              (64, 8, "skip_edges"), (96, 8, "crafted"),
                                              (128, 32, "crafted"), (96, 32, "banded"),
                                              (128, 8, "banded"), (96, 8, "columns"),
                                              (128, 32, "columns"), (128, 8, "skip_edges")])
def test_composite_fwd_large_tiles_match_reference(tile, chunk, table):
    """Tiles above 32, which the kernel runs in pixel passes (above 64 in
    windows of at most 64x64): crafted tiles, skip edges, and a tile whose
    bands (at tile 64 the passes) or columns saturate at different chunks,
    where the whole-tile exit waits for the last band; above 64 the windows
    the first bands cover saturate chunks before the tile's exit and go on
    compositing to it."""
    if table == "crafted":
        attrs, ts, tc = map(torch.from_numpy, crafted_tiles(3, 2, tile, chunk))
        _, nproc = both(attrs, ts, tc, 3, tile, chunk)
        assert (nproc < (ts % chunk + tc + chunk - 1) // chunk).any()
    elif table == "skip_edges":
        both(*map(torch.from_numpy, skip_edge_tile(tile, chunk)), 1, tile, chunk)
    else:
        axis = int(table == "columns")
        attrs, ts, tc, m = banded_tile(tile, chunk, axis)
        attrs, ts, tc = map(torch.from_numpy, (attrs, ts, tc))
        tiles, nproc = both(attrs, ts, tc, 1, tile, chunk)
        assert 0 < int(nproc[0]) < (int(ts[0]) % chunk + int(tc[0]) + chunk - 1) // chunk
        assert float(tiles[0, 3].max()) < traster.T_EPS
        # the first group alone saturates the first band and leaves the others
        part, _ = traster.composite_fwd(attrs, ts, torch.tensor([m], dtype=torch.int32),
                                        tw=1, tile_size=tile, chunk=chunk,
                                        gid=F.table_gids(attrs))
        T = part[0, 3].reshape(tile, tile)
        T = (T.T if axis else T).reshape(4, tile // 4, tile).amax((1, 2))
        assert float(T[0]) < traster.T_EPS < float(T[1:].min())


def power_and_alpha(attrs, ts, tc, tile, chunk):
    """The plain compositor's power and alpha of every (pair row, pixel) of
    a one-tile table (tw 1), with the rows' skip thresholds."""
    h = tile // 2
    pix = torch.arange(tile * tile)
    px, py = (pix % tile - h).float(), (pix // tile - h).float()
    rows = torch.arange(int(ts[0]), int(ts[0] + tc[0]))
    a = attrs[rows]
    dx = px - (a[:, 0] - h)[:, None]
    dy = py - (a[:, 1] - h)[:, None]
    power = -((0.5 * a[:, 2:3]) * (dx * dx) + a[:, 3:4] * (dx * dy)
              + (0.5 * a[:, 4:5]) * (dy * dy))
    raw = a[:, 8:9] * torch.exp(torch.where(power > 0, -100.0, power))
    alpha = torch.where(raw >= traster.ALPHA_MIN, torch.clamp(raw, max=traster.ALPHA_MAX), 0.0)
    return power, alpha, traster.skip_threshold(a[:, 8])[:, None]


@pytest.mark.parametrize("tile,chunk", [(16, 8), (32, 32)])
def test_composite_fwd_skip_edges_match_reference(tile, chunk):
    """The skip's edge cases (op 0, op < 1/255, op 1, power > 0, power
    within 1e-3 of the threshold on either side) against the JAX kernel;
    below the threshold alpha is 0 at every pixel, and the margin holds
    pixels that are not skipped though their alpha is 0."""
    attrs, ts, tc = map(torch.from_numpy, skip_edge_tile(tile, chunk))
    both(attrs, ts, tc, 1, tile, chunk)
    power, alpha, thr = power_and_alpha(attrs, ts, tc, tile, chunk)
    below = power < thr
    assert (alpha[below] == 0).all()
    assert ((alpha == 0) & ~below).any() and (alpha > 0).any() and below.any()
    # pixel (0, 0) of the op-0.5 rows sits at -2e-3 .. +2e-3 of the threshold
    near = (power[4:11, 0] - thr[4:11, 0]).tolist()
    assert [d < 0 for d in near] == [True] * 3 + [False] * 4 or \
        [d < 0 for d in near] == [True] * 4 + [False] * 3, near
    assert all(abs(d) <= 2.1e-3 for d in near), near


def test_skip_threshold_keeps_alpha_at_zero():
    """Over opacities from 0 to 1 (those below 1/255 and at it too) and
    powers down to 1e-3 below the threshold, the plain alpha rule gives 0."""
    rng = np.random.default_rng(0)
    op = np.concatenate([[0.0, 1e-6, 0.5 / 255, 1 / 255, np.nextafter(np.float32(1 / 255), 1),
                          0.5, 1.0], rng.uniform(0, 1, 500)]).astype(np.float32)
    op = torch.from_numpy(op)
    thr = traster.skip_threshold(op)
    assert thr[0] == torch.inf and thr.dtype == torch.float32
    # op below 1/255 puts the threshold above 0: every power <= 0 is below it
    assert (thr[1:3] > 0).all() and (thr[1:] < torch.inf).all()
    # powers in [thr - 1e-3, thr - 1e-5]; the positive ones take the -100 branch
    frac = torch.from_numpy(rng.uniform(0.01, 1, (1, 64)).astype(np.float32))
    power = thr[1:, None] - 1e-3 * frac
    assert (power < thr[1:, None]).all() and (power > 0).any()
    raw = op[1:, None] * torch.exp(torch.where(power > 0, -100.0, power))
    assert (raw < traster.ALPHA_MIN).all()


@pytest.mark.parametrize("tile", [1, 5, 8, 12, 15, 16, 24, 32, 33, 48, 63, 64, 65, 96, 128,
                                  256])
def test_fwd_pixel_blocks_cover_the_tile(tile):
    """Every pixel of the tile in exactly one map thread's 2x2 block, whole
    warps; at tiles that are multiples of 16 each warp's pixels form a 16x8
    rectangle, and at tile 64 pixel pass p (map threads 256 p .. 256 p +
    255) covers rows 16 p .. 16 p + 15. Above 64 each window of at most
    64x64 is mapped as a tile of its size, windows row-major, and no warp
    crosses a window."""
    blocks = traster.fwd_pixel_blocks(tile)
    wins = traster.tile_windows(tile)
    assert blocks.shape[1] == 4 and blocks.shape[0] % 32 == 0
    assert blocks.shape[0] == sum(-(-((w + 1) // 2) * ((h + 1) // 2) // 32) * 32
                                  for _, _, w, h in wins)
    got = blocks[blocks >= 0]
    assert sorted(got.tolist()) == list(range(tile * tile))
    if tile > 64:
        assert len(wins) == (-(-tile // 64)) ** 2 and max(max(w, h) for *_, w, h in wins) == 64
        assert wins[-1][2:] == (tile % 64 or 64,) * 2
        t0 = 0
        for x, y, w, h in wins:
            n = -(-((w + 1) // 2) * ((h + 1) // 2) // 32) * 32
            p = blocks[t0:t0 + n]
            p = p[p >= 0]
            assert (p % tile >= x).all() and (p % tile < x + w).all()
            assert (p // tile >= y).all() and (p // tile < y + h).all()
            t0 += n
    if tile % 16 == 0:
        for w in range(blocks.shape[0] // 32):
            p = blocks[32 * w:32 * (w + 1)].reshape(-1)
            x, y = p % tile, p // tile
            assert (int(x.max() - x.min()), int(y.max() - y.min())) == (15, 7)
    if tile == 64:
        for p in range(4):
            rows = blocks[256 * p:256 * (p + 1)].reshape(-1) // tile
            assert (int(rows.min()), int(rows.max())) == (16 * p, 16 * p + 15)


def test_untile_image():
    tw, th, tile, w, h = 3, 2, 4, 10, 7
    tiles = torch.arange(tw * th * 4 * tile * tile, dtype=torch.float32).reshape(
        tw * th, 4, tile * tile)
    rgb, T = traster.untile_image(tiles, tw, th, tile, w, h)
    for y, x in ((0, 0), (5, 9), (6, 4)):
        t = (y // tile) * tw + x // tile
        p = (y % tile) * tile + x % tile
        assert rgb[y, x].tolist() == tiles[t, :3, p].tolist()
        assert float(T[y, x]) == float(tiles[t, 3, p])
    assert rgb.shape == (h, w, 3) and T.shape == (h, w)
