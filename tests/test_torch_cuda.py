"""The port's CUDA kernels against their plain PyTorch versions on the GPU,
and the wrappers' refusal to fall back to them anywhere but the CPU.

This file imports no jax, so it runs on the machine with the card, where
tests/conftest.py (which imports jax) cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tests marked `cuda` skip where torch.cuda.is_available() is false. Keys,
gids (saturation quanta included), segment ends (key rows with long gaps
too), prefix sums (a misaligned slice and 50 calls in a row too) and
compacted rows must be bit-equal (into a poisoned buffer, every row
written); images and tiles within 2e-5 abs, nproc
equal (crafted tile tables, the warp skip's edge cases and tiles of 48 and
64 too); composite_bwd's d columns within 1e-4 of each column's max (the
kernel sums pixels in its own fixed order, the plain version in matmul
order) and the same bits from two launches (fixture scenes, crafted tiles,
skip edges, tiles of 48 and 64), on the packed pair table too (fixture
scenes, crafted tiles, skip edges, and a packed render against the CPU's);
expand_pairs on crafted tables too; the
per-Gaussian reduction (segment_sum) within 1e-6 of each column's max of
its plain version, the same bits twice; render gradients within 2e-4 of
each group's max of the CPU's, and two gradient passes of one train step
bit-equal in every parameter group; render_cli's PNGs equal to the
render of each camera."""

import numpy as np
import pytest
import torch

import torch_port_fixtures as F
from gsplat_tpu_torch import _build
from gsplat_tpu_torch.render import binning as tb
from gsplat_tpu_torch.render import bounds as tbounds
from gsplat_tpu_torch.render import compact as tcompact
from gsplat_tpu_torch.render import expand as texp
from gsplat_tpu_torch.render import raster as traster
from gsplat_tpu_torch.render import reduce as treduce
from gsplat_tpu_torch.render import scan as tscan
from torch_port_fixtures import (D_TABLE_CASES, EXP_H, EXP_S, EXP_TILE,  # noqa: F401
                                 EXP_W, EXPANSION_CASES, GAP_CASES, SCENES, banded_tile,
                                 crafted_d_table, crafted_projection, crafted_tiles,
                                 cuda_device, gap_row, pair_tables, random_projection,
                                 saturating_projection, skip_edge_tile)

torch.set_num_threads(1)
ATOL = 2e-5


def expansion_inputs(n, seed, budget, do_cull, sat_pack=False, saturating=False, **kw):
    width, height, ts = (64, 64, 16) if saturating else (256, 192, 16)
    tw, th = tb.tile_grid(width, height, ts)
    db = tb.depth_shift(tw * th)
    proj = saturating_projection(n, seed) if saturating else random_projection(n, seed, **kw)
    table, total = tb.expansion_table(*map(torch.from_numpy, proj), tw=tw, th=th,
                                      tile_size=ts, db=db, do_cull=do_cull)
    return table, total, dict(tw=tw, tile_size=ts, db=db, num_tiles=tw * th,
                              n_orig=n, do_cull=do_cull, sat_pack=sat_pack)


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed,budget,do_cull,kw", [
    (600, 0, 4096, True, {}),
    (600, 0, 4096, False, {}),
    (500, 2, 2048, True, {}),                             # budget overflow
    (400, 3, 4096, True, {"clustered_dead": True}),
    (64, 4, 1024, True, {"dead_frac": 1.0}),              # empty
    (600, 0, 4096, True, {"sat_pack": True}),             # saturation quanta
    (500, 2, 2048, True, {"sat_pack": True}),
    (100, 3, 2048, True, {"sat_pack": True, "saturating": True}),
])
def test_expand_pairs_kernel_bit_equal(cuda_device, n, seed, budget, do_cull, kw):
    table, total, meta = expansion_inputs(n, seed, budget, do_cull, **kw)
    want = texp.expand_pairs_plain(table, total, budget, **meta)
    before = texp.expand_pairs.launches
    got = texp.expand_pairs(table.to(cuda_device), total.to(cuda_device), budget, **meta)
    torch.cuda.synchronize()
    assert texp.expand_pairs.launches == before + 1
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["no_cull", "cull", "sat_pack"])
@pytest.mark.parametrize("case", list(EXPANSION_CASES))
def test_expand_pairs_kernel_crafted_tables(cuda_device, case, mode):
    """The merge-path partition on crafted tables (torch_port_fixtures.
    crafted_projection): a Gaussian over more slots than one block's 1024
    items, runs of one-slot rows, total 0, total = S and past it, S no
    multiple of the block."""
    do_cull, sat_pack = mode != "no_cull", mode == "sat_pack"
    arrays = crafted_projection(case)
    tw, th = tb.tile_grid(EXP_W, EXP_H, EXP_TILE)
    db = tb.depth_shift(tw * th)
    table, total = tb.expansion_table(*map(torch.from_numpy, arrays), tw=tw, th=th,
                                      tile_size=EXP_TILE, db=db, do_cull=do_cull)
    meta = dict(tw=tw, tile_size=EXP_TILE, db=db, num_tiles=tw * th,
                n_orig=arrays[0].shape[0], do_cull=do_cull, sat_pack=sat_pack)
    want = texp.expand_pairs_plain(table, total, EXP_S, **meta)
    got = texp.expand_pairs(table.to(cuda_device), total.to(cuda_device), EXP_S, **meta)
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_composite_fwd_kernel_matches_plain(cuda_device, name):
    tw, _ = tb.tile_grid(F.W, F.H, F.TILE)
    tables = [t.to(cuda_device) for t in pair_tables(F.make_scene(**SCENES[name]))]
    want_tiles, want_np = traster.composite_fwd_plain(*tables, tw=tw, tile_size=F.TILE,
                                                      chunk=F.CHUNK)
    before = traster.composite_fwd.launches
    got_tiles, got_np = traster.composite_fwd(*tables, tw=tw, tile_size=F.TILE,
                                              chunk=F.CHUNK)
    torch.cuda.synchronize()
    assert traster.composite_fwd.launches == before + 1
    np.testing.assert_allclose(got_tiles.cpu().numpy(), want_tiles.cpu().numpy(),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_np.cpu().numpy(), want_np.cpu().numpy())


def assert_composite_matches_plain(device, attrs, ts, tc, tw, tile, chunk):
    tables = [torch.from_numpy(a).to(device) for a in (attrs, ts, tc)]
    want_tiles, want_np = traster.composite_fwd_plain(*tables, tw=tw, tile_size=tile,
                                                      chunk=chunk)
    before = traster.composite_fwd.launches
    got_tiles, got_np = traster.composite_fwd(*tables, tw=tw, tile_size=tile, chunk=chunk)
    torch.cuda.synchronize()
    assert traster.composite_fwd.launches == before + 1
    np.testing.assert_allclose(got_tiles.cpu().numpy(), want_tiles.cpu().numpy(),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_np.cpu().numpy(), want_np.cpu().numpy())
    return got_np.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32, 48, 64, 65, 96, 128])
@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_composite_fwd_kernel_crafted_tiles(cuda_device, tile, chunk):
    """Empty tiles, segments starting mid-chunk, tiles that exit at a chunk
    boundary before their last chunk (torch_port_fixtures.crafted_tiles)."""
    attrs, ts, tc = crafted_tiles(3, 2, tile, chunk)
    nproc = assert_composite_matches_plain(cuda_device, attrs, ts, tc, 3, tile, chunk)
    nch = (ts % chunk + tc + chunk - 1) // chunk
    assert (nproc.numpy() < nch).any() and (tc == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32, 48, 64, 65, 96, 128])
@pytest.mark.parametrize("chunk", [8, 32])
def test_composite_fwd_kernel_skip_edges(cuda_device, tile, chunk):
    """The warp skip's edge cases: op 0, op < 1/255, op 1, power > 0, and
    power within 1e-3 of the threshold on both sides
    (torch_port_fixtures.skip_edge_tile)."""
    assert_composite_matches_plain(cuda_device, *skip_edge_tile(tile, chunk), 1, tile, chunk)


@pytest.mark.cuda
def test_render_on_gpu_matches_cpu(cuda_device):
    from gsplat_tpu_torch.interop import camera_from_numpy, gaussians_from_numpy
    from gsplat_tpu_torch.render.render import render

    s = F.make_scene()
    out = {}
    for dev in ("cpu", cuda_device):
        g = gaussians_from_numpy(s.params, s.n_live, 3, 3, device=dev)
        cam = camera_from_numpy(s.R, s.T, F.FOVX, F.FOVY, F.W, F.H, device=dev)
        out[str(dev)] = render(cam, g, torch.tensor([0.1, 0.2, 0.3]), tile_size=F.TILE,
                               chunk=F.CHUNK, pair_budget=F.BUDGET,
                               kept_budget=F.BUDGET - F.CHUNK)
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    assert gpu.image.is_cuda
    np.testing.assert_allclose(gpu.image.cpu().numpy(), cpu.image.numpy(), rtol=0,
                               atol=ATOL)
    for f in ("n_pairs", "n_culled", "n_contrib", "n_dropped"):
        assert int(getattr(gpu, f)) == int(getattr(cpu, f)), f


def bwd_inputs(name, device):
    """composite_bwd's inputs on a fixture scene: the pair table, its tile
    tables, the forward tiles, regions of a can't-overflow d-table and a
    seeded cotangent."""
    from gsplat_tpu_torch.render.render import contrib_regions

    tw, th = tb.tile_grid(F.W, F.H, F.TILE)
    gathered, ts, tc = pair_tables(F.make_scene(**SCENES[name]))
    tiles, nproc = traster.composite_fwd(gathered, ts, tc, tw=tw, tile_size=F.TILE,
                                         chunk=F.CHUNK)
    p_out = tb.out_budget(gathered.shape[0], tw * th, F.CHUNK)
    np_c, comp_start, _ = contrib_regions(nproc, F.CHUNK, p_out)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=tiles.shape).astype(np.float32))
    args = [t.to(device) for t in (gathered, ts, tc, comp_start, np_c, tiles, g)]
    return args, dict(tw=tw, tile_size=F.TILE, chunk=F.CHUNK, p_out=p_out)


def assert_d_tables_match(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got[:, traster.KEY_COL], want[:, traster.KEY_COL])
    for c in range(traster.N_DCOLS):
        scale = max(float(np.abs(want[:, c]).max()), 1e-12)
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=0, atol=1e-4 * scale,
                                   err_msg=f"column {c}")
    assert (got[:, traster.KEY_COL + 1:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_composite_bwd_kernel_matches_plain(cuda_device, name):
    args, kw = bwd_inputs(name, cuda_device)
    want = traster.composite_bwd_plain(*args, **kw)
    before = traster.composite_bwd.launches
    got = traster.composite_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert traster.composite_bwd.launches == before + 1
    assert_d_tables_match(got, want)
    again = traster.composite_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again, got)   # no atomics: the same bits twice


def assert_bwd_matches_plain(device, attrs, ts, tc, tw, tile, chunk):
    """composite_bwd against its plain version on a crafted table: the
    forward (plain, on the CPU), its regions and a seeded cotangent; the
    same bits from two launches."""
    from gsplat_tpu_torch.render.render import contrib_regions

    tables = [torch.from_numpy(a) for a in (attrs, ts, tc)]
    tiles, nproc = traster.composite_fwd_plain(*tables, tw=tw, tile_size=tile, chunk=chunk)
    p_out = tb.out_budget(attrs.shape[0], ts.shape[0], chunk)
    np_c, comp_start, _ = contrib_regions(nproc, chunk, p_out)
    g = torch.from_numpy(np.random.default_rng(tile + chunk).normal(
        size=tiles.shape).astype(np.float32))
    args = [t.to(device) for t in (*tables, comp_start, np_c, tiles, g)]
    kw = dict(tw=tw, tile_size=tile, chunk=chunk, p_out=p_out)
    want = traster.composite_bwd_plain(*args, **kw)
    before = traster.composite_bwd.launches
    got = traster.composite_bwd(*args, **kw)
    again = traster.composite_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert traster.composite_bwd.launches == before + 2
    assert_d_tables_match(got, want)
    assert torch.equal(again, got)
    return nproc


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32, 48, 64, 65, 96, 128])
@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_composite_bwd_kernel_crafted_tiles(cuda_device, tile, chunk):
    """Empty tiles, segments starting mid-chunk, tiles that exit at a chunk
    boundary before their last chunk (torch_port_fixtures.crafted_tiles)."""
    attrs, ts, tc = crafted_tiles(3, 2, tile, chunk)
    nproc = assert_bwd_matches_plain(cuda_device, attrs, ts, tc, 3, tile, chunk)
    assert (tc == 0).any() and (nproc.numpy() > 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32, 48, 64, 65, 96, 128])
@pytest.mark.parametrize("chunk", [8, 32])
def test_composite_bwd_kernel_skip_edges(cuda_device, tile, chunk):
    """The warp skip's edge cases: op 0, op < 1/255, op 1, power > 0, and
    power within 1e-3 of the threshold on both sides
    (torch_port_fixtures.skip_edge_tile)."""
    assert_bwd_matches_plain(cuda_device, *skip_edge_tile(tile, chunk), 1, tile, chunk)


def packed_table(attrs):
    """A (P, 16) pair table -> its packed (P, 8) table (render/raster.py)."""
    attrs = torch.as_tensor(attrs)
    return torch.cat([traster.pack_attrs8(attrs),
                      attrs[:, traster.KEY_COL:traster.KEY_COL + 1]], 1).contiguous()


def assert_packed_kernels_match_plain(device, attrs, ts, tc, tw, tile, chunk):
    """K2 and K3 on the packed table of `attrs` against their plain versions
    (tiles 2e-5 abs, nproc equal; keys equal, d columns 1e-4 of each
    column's max, the same bits twice), each launch counted in the packed
    counts and not in the wrappers' own."""
    from gsplat_tpu_torch.render.render import contrib_regions

    p = packed_table(attrs)
    tables = [t.to(device) for t in (p, torch.as_tensor(ts), torch.as_tensor(tc))]
    counts = (traster.composite_fwd, traster.composite_bwd, traster.packed_fwd_count,
              traster.packed_bwd_count)
    before = [c.launches for c in counts]
    want_tiles, want_np = traster.composite_fwd_plain(*tables, tw=tw, tile_size=tile,
                                                      chunk=chunk)
    got_tiles, got_np = traster.composite_fwd(*tables, tw=tw, tile_size=tile, chunk=chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got_tiles.cpu().numpy(), want_tiles.cpu().numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got_np.cpu().numpy(), want_np.cpu().numpy())
    p_out = tb.out_budget(p.shape[0], tables[1].shape[0], chunk)
    np_c, comp_start, _ = contrib_regions(want_np, chunk, p_out)
    g = torch.from_numpy(np.random.default_rng(tile + chunk).normal(
        size=want_tiles.shape).astype(np.float32)).to(device)
    args = (*tables, comp_start, np_c, want_tiles, g)
    kw = dict(tw=tw, tile_size=tile, chunk=chunk, p_out=p_out)
    want = traster.composite_bwd_plain(*args, **kw)
    got = traster.composite_bwd(*args, **kw)
    again = traster.composite_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert_d_tables_match(got, want)
    assert torch.equal(got, again)
    assert [c.launches for c in counts] == [before[0], before[1], before[2] + 1,
                                             before[3] + 2]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_composite_kernels_packed_match_plain(cuda_device, name):
    tw, _ = tb.tile_grid(F.W, F.H, F.TILE)
    gathered, ts, tc = pair_tables(F.make_scene(**SCENES[name]))
    assert_packed_kernels_match_plain(cuda_device, gathered, ts, tc, tw, F.TILE, F.CHUNK)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("chunk", [8, 128])
def test_composite_kernels_packed_crafted_tiles(cuda_device, tile, chunk):
    """The packed table of torch_port_fixtures.crafted_tiles (empty tiles,
    mid-chunk starts, exits before the last chunk) and of the warp skip's
    edge cases."""
    attrs, ts, tc = crafted_tiles(3, 2, tile, chunk)
    assert_packed_kernels_match_plain(cuda_device, attrs, ts, tc, 3, tile, chunk)
    attrs, ts, tc = skip_edge_tile(tile, chunk)
    assert_packed_kernels_match_plain(cuda_device, attrs, ts, tc, 1, tile, chunk)


@pytest.mark.cuda
def test_packed_render_on_gpu_matches_cpu(cuda_device):
    """render(attr_pack=True) on the card against the CPU: the image within
    2e-5, the counts equal, and the packed kernels launched."""
    from gsplat_tpu_torch.interop import camera_from_numpy, gaussians_from_numpy
    from gsplat_tpu_torch.render.render import render

    s = F.make_scene()
    out = {}
    before = traster.packed_fwd_count.launches
    for dev in ("cpu", cuda_device):
        g = gaussians_from_numpy(s.params, s.n_live, 3, 3, device=dev)
        cam = camera_from_numpy(s.R, s.T, F.FOVX, F.FOVY, F.W, F.H, device=dev)
        out[str(dev)] = render(cam, g, torch.tensor([0.1, 0.2, 0.3]), tile_size=F.TILE,
                               chunk=F.CHUNK, pair_budget=F.BUDGET, attr_pack=True)
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    assert traster.packed_fwd_count.launches == before + 1
    np.testing.assert_allclose(gpu.image.cpu().numpy(), cpu.image.numpy(), rtol=0,
                               atol=ATOL)
    for f in ("n_pairs", "n_culled", "n_contrib", "n_dropped"):
        assert int(getattr(gpu, f)) == int(getattr(cpu, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [48, 64, 96, 128])
@pytest.mark.parametrize("chunk", [8, 32, 128])
def test_composite_kernels_banded_tile(cuda_device, tile, chunk):
    """A tile whose bands (at tile 64 the kernels' pixel passes; above 64
    the rows of its windows) or columns saturate at different chunks: the
    whole-tile exit waits for the last band and the windows that saturate
    first go on compositing to it; both kernels against their plain
    versions, the backward's same bits twice."""
    for axis in (0, 1):
        attrs, ts, tc, _ = banded_tile(tile, chunk, axis)
        nproc = assert_composite_matches_plain(cuda_device, attrs, ts, tc, 1, tile, chunk)
        assert 0 < int(nproc[0]) < (3 + int(tc[0]) + chunk - 1) // chunk
        assert_bwd_matches_plain(cuda_device, attrs, ts, tc, 1, tile, chunk)


@pytest.mark.cuda
def test_composite_bwd_prefill_survives_a_poisoned_buffer(cuda_device):
    """Rows outside every region hold zeros and KEY_INVALID even when the
    caching allocator hands back a block full of NaN."""
    args, kw = bwd_inputs("sparse", cuda_device)
    poison = torch.full((kw["p_out"], traster.ATTR_DIM), float("nan"), device=cuda_device)
    ptr = poison.data_ptr()
    del poison
    d = traster.composite_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert d.data_ptr() == ptr   # the poisoned block was reused
    comp_start, np_c = args[3].cpu(), args[4].cpu()
    covered = torch.zeros(kw["p_out"], dtype=torch.bool)
    for s, k in zip(comp_start.tolist(), np_c.tolist()):
        covered[s:s + k * F.CHUNK] = True
    rest = d.cpu()[~covered]
    assert rest.shape[0] > 0 and torch.isfinite(d).all()
    assert (rest[:, traster.KEY_COL] == traster.KEY_INVALID).all()
    rest[:, traster.KEY_COL] = 0
    assert (rest == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("p,n_valid,n", [(1024, 900, 2048), (4096, 4096, 2048),
                                         (256, 0, 2048), (77, 60, 301), (1 << 20, 700_000, 1 << 20)])
def test_segment_ends_kernel_bit_equal(cuda_device, p, n_valid, n):
    rng = np.random.default_rng(p)
    keys = np.full(p, traster.KEY_INVALID, np.float32)
    keys[:n_valid] = np.sort(rng.integers(0, n, size=n_valid) // 3 * 3)
    k = torch.from_numpy(keys).to(cuda_device)
    want = tbounds.segment_ends_plain(k, n)
    before = tbounds.segment_ends.launches
    got = tbounds.segment_ends(k, n)
    torch.cuda.synchronize()
    assert tbounds.segment_ends.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    q = torch.arange(1, n + 1, device=cuda_device).to(torch.float32)
    assert torch.equal(got.long(), torch.searchsorted(k, q, side="left"))


@pytest.mark.cuda
@pytest.mark.parametrize("case,n", [(c, 4096) for c in GAP_CASES] + [
    ("tail", 1 << 20), ("all_invalid", 1 << 20), ("empty", 1 << 20)])
def test_segment_ends_kernel_long_gaps(cuda_device, case, n):
    """Key rows with long runs of gids that own no rows (gid 0 onwards, a
    run in the middle, all gids past the last valid key, every key
    KEY_INVALID, no keys at all) and a row of one gid: bit-equal, every
    gid written."""
    if case == "all_invalid":
        keys = np.full(3000, traster.KEY_INVALID, np.float32)
    elif case == "empty":
        keys = np.zeros(0, np.float32)
    else:
        keys = gap_row(case, n=n)
    k = torch.from_numpy(keys).to(cuda_device)
    want = tbounds.segment_ends_plain(k, n)
    got = tbounds.segment_ends(k, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def big_d_table(seed=0, n=100_000, c=400_000):
    """A (c, 16) d-table in tile order whose gids own 0 to a few thousand
    rows each (most own 1-3; a few large splats own hundreds or thousands),
    a fifth of the rows inert -> (d, n_rows)."""
    rng = np.random.default_rng(seed)
    owners = np.concatenate([rng.integers(0, n, c - 12_000),
                             np.repeat(rng.integers(0, n, 6), 2000)])
    key = owners.astype(np.float32)
    key[rng.random(c) < 0.2] = traster.KEY_INVALID
    d = np.zeros((c, traster.ATTR_DIM), np.float32)
    d[:, :traster.N_DCOLS] = rng.normal(size=(c, traster.N_DCOLS))
    d[key == traster.KEY_INVALID, :traster.N_DCOLS] = 0.0
    d[:, traster.KEY_COL] = key
    return d[rng.permutation(c)], n + 1


def assert_tables_close(got, want, rtol):
    scale = want[:, :traster.N_DCOLS].abs().amax(0).clamp(min=1e-30)
    err = (got[:, :traster.N_DCOLS] - want[:, :traster.N_DCOLS]).abs().amax(0) / scale
    assert float(err.max()) <= rtol, err
    assert (got[:, traster.N_DCOLS:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(D_TABLE_CASES) + ["big"])
def test_segment_sum_kernel_matches_plain(cuda_device, case):
    """The reduction against its plain version (float64 index_add_) within
    1e-6 of each column's max, and against a float64 index_add_ of the rows
    by their keys; the same bits from two calls; reduce_by_gid launches
    segment_ends and segment_sum once each."""
    from gsplat_tpu_torch.render.render import reduce_by_gid

    d, n_rows = big_d_table() if case == "big" else crafted_d_table(case)
    d = torch.from_numpy(d).to(cuda_device)
    key_s, perm = torch.sort(d[:, traster.KEY_COL], stable=True)
    ends = tbounds.segment_ends(key_s, n_rows - 1)
    want = treduce.segment_sum_plain(d, perm, ends, n_rows)
    before = treduce.segment_sum.launches, tbounds.segment_ends.launches
    got = reduce_by_gid(d, n_rows)
    again = reduce_by_gid(d, n_rows)
    torch.cuda.synchronize()
    assert (treduce.segment_sum.launches, tbounds.segment_ends.launches) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    assert_tables_close(got, want, 1e-6)
    valid = d[:, traster.KEY_COL] != traster.KEY_INVALID
    ref = torch.zeros((n_rows, traster.ATTR_DIM), dtype=torch.float64, device=cuda_device)
    ref[:, :traster.N_DCOLS].index_add_(0, d[valid, traster.KEY_COL].long(),
                                        d[valid, :traster.N_DCOLS].double())
    ref[-1] = 0
    assert_tables_close(got.double(), ref, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hi,bias,clip_hi", [
    (0, 63, 0, None), (1, 63, 0, None), (1023, 255, 0, None), (4095, 255, 0, None),
    (4097, 63, 0, None), (8191, 255, 0, None), (8193, 63, 0, None),
    ((1 << 20) + 17, 255, 0, None),
    ((1 << 20) + 17, 63, -1000, 5_000_000), (4096 * 3, 1, 7, 100),
    (tscan.MAX_LEN - 1, 63, 0, None), (tscan.MAX_LEN - 1, 63, -7, 1 << 30),
])
def test_prefix_sum_small_kernel_bit_equal(cuda_device, n, hi, bias, clip_hi):
    x = torch.from_numpy(np.random.default_rng(n).integers(0, hi + 1, n).astype(np.int32))
    x = x.to(cuda_device)
    want = tscan.prefix_sum_small_plain(x, bias, clip_hi)
    before = tscan.prefix_sum_small.launches
    got = tscan.prefix_sum_small(x, bias, clip_hi)
    torch.cuda.synchronize()
    assert tscan.prefix_sum_small.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 8193, (1 << 20) + 17])
def test_prefix_sum_small_kernel_misaligned_slice(cuda_device, n):
    """x[1:] starts 4 bytes past a 16-byte boundary: the kernel reads it with
    scalar loads, never out of alignment, and the sums stay bit-equal."""
    x = torch.from_numpy(np.random.default_rng(n).integers(0, 64, n + 1).astype(np.int32))
    x = x.to(cuda_device)[1:]
    assert x.data_ptr() % 16 == 4
    got = tscan.prefix_sum_small(x, -3, 1 << 20)
    torch.cuda.synchronize()
    assert torch.equal(got, tscan.prefix_sum_small_plain(x, -3, 1 << 20))


@pytest.mark.cuda
def test_prefix_sum_small_kernel_repeats_bit_equal(cuda_device):
    """50 calls in a row, on one stream and without syncs between them: each
    zeroes its own tile status words, so none reads a stale one."""
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 64, 3_000_001).astype(np.int32))
    x = x.to(cuda_device)
    want = tscan.prefix_sum_small_plain(x)
    outs = [tscan.prefix_sum_small(x) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def compact_inputs(seed, chunk, T=300, src_chunks=4096):
    """tests/test_compact_pallas.py's draws in pair units: T runs of up to 40
    chunks at random chunk-aligned sources, packed in tile order."""
    rng = np.random.default_rng(seed)
    nch = rng.integers(0, 40, T)
    rbase = np.concatenate([[0], np.cumsum(nch)[:-1]])
    astart = np.array([rng.integers(0, src_chunks - max(int(k), 1) + 1) for k in nch])
    src = torch.from_numpy(rng.integers(0, 1 << 20, src_chunks * chunk).astype(np.int32))
    out_size = int(nch.sum() + 24) * chunk
    tables = (torch.from_numpy((a * chunk).astype(np.int32)) for a in (astart, rbase, nch))
    return (src, *tables, out_size)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,chunk", [(0, 128), (1, 128), (2, 8), (3, 3)])
def test_compact_runs_kernel_bit_equal(cuda_device, seed, chunk):
    src, astart, rbase, length, out_size = compact_inputs(seed, chunk)
    args = [t.to(cuda_device) for t in (src, astart, rbase, length)]
    want = tcompact.compact_runs_plain(*args, out_size, -7)
    before = tcompact.compact_runs.launches
    got = tcompact.compact_runs(*args, out_size, -7)
    torch.cuda.synchronize()
    assert tcompact.compact_runs.launches == before + 1
    assert torch.equal(got, want) and int((got == -7).sum()) >= 24 * chunk


def covered_once(rbase, length, out_size):
    """(out_size,) int64: how many regions cover each row."""
    cover = torch.zeros(out_size + 1, dtype=torch.int64)
    for r, n in zip(rbase.tolist(), length.tolist()):
        cover[min(max(r, 0), out_size)] += 1
        cover[min(max(r + n, r, 0), out_size)] -= 1
    return torch.cumsum(cover, 0)[:out_size]


def starved_inputs(out_chunks=32):
    """The binning's overflow: rbase clamped to out_size - region, so the
    regions overlap (at 32 chunks the largest passes the whole budget and
    covers every row; at 96 some rows lie under one region only)."""
    src, astart, _, length, _ = compact_inputs(4, 128)
    out_size = out_chunks * 128
    rend = torch.cumsum(length.long(), 0)
    rbase = torch.minimum(rend - length, torch.clamp(out_size - length.long(), min=0))
    return src, astart, rbase.int(), length, out_size


@pytest.mark.cuda
@pytest.mark.parametrize("out_chunks", [32, 96])
def test_compact_runs_kernel_starved_stays_in_bounds(cuda_device, out_chunks):
    """Every write stays in the output (the sync raises nothing), every row
    holds the fill or a value of the source, and every row one region covers
    holds that region's value (the plain version's)."""
    src, astart, rbase, length, out_size = starved_inputs(out_chunks)
    args = [t.to(cuda_device) for t in (src, astart, rbase, length)]
    got = tcompact.compact_runs(*args, out_size, -7)
    want = tcompact.compact_runs_plain(*args, out_size, -7)
    torch.cuda.synchronize()
    cover = covered_once(rbase, length, out_size).to(cuda_device)
    once = cover == 1
    assert int((cover > 1).sum()) > 0
    assert int(length.max()) > out_size if out_chunks == 32 else int(once.sum()) > 0
    assert bool(torch.isin(got[got != -7].cpu(), src).all())
    assert torch.equal(got[once], want[once])


SENTINEL = -123_456_789


def poison_cases():
    """(name, src, astart, rbase, length, out_size): ascending disjoint runs
    with a long tail, the starved overlap, no regions, an empty output, a
    last region that ends exactly at out_size, a gap before the first
    region and between two, sources outside src, and a misaligned chunk."""
    src, astart, rbase, length, out_size = compact_inputs(0, 128)
    yield "ascending", src, astart, rbase, length, out_size + 300_000
    yield ("starved",) + starved_inputs()
    yield ("starved, rows under one region",) + starved_inputs(96)
    ar = torch.arange(100, dtype=torch.int32)
    yield "no regions", ar, *(torch.zeros(0, dtype=torch.int32),) * 3, 70_000
    yield "out_size 0", ar, torch.tensor([0]), torch.tensor([0]), torch.tensor([8]), 0
    yield ("ends at out_size", ar, torch.tensor([8, 40, 60]), torch.tensor([0, 16, 24]),
           torch.tensor([16, 8, 12]), 36)
    yield ("gaps", ar, torch.tensor([3, 50, 9]), torch.tensor([10, 30, 44]),
           torch.tensor([7, 5, 3]), 61)
    yield ("outside src", ar, torch.tensor([-3, 97]), torch.tensor([0, 10]),
           torch.tensor([6, 6]), 16)
    yield ("chunk 3",) + compact_inputs(3, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(9))
def test_compact_runs_kernel_writes_every_row(cuda_device, case):
    """One launch into a buffer poisoned with a sentinel: no sentinel is
    left, and every row no region covers or one region covers equals the
    plain version's."""
    name, src, astart, rbase, length, out_size = list(poison_cases())[case]
    args = [t.to(device=cuda_device, dtype=torch.int32) for t in (src, astart, rbase, length)]
    out = torch.full((out_size,), SENTINEL, dtype=torch.int32, device=cuda_device)
    before = tcompact.compact_runs.launches
    got = tcompact.compact_runs(*args, out_size, -7, out=out)
    want = tcompact.compact_runs_plain(*args, out_size, -7)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr(), name
    assert tcompact.compact_runs.launches == before + (out_size > 0), name
    assert int((got == SENTINEL).sum()) == 0, name
    defined = (covered_once(rbase, length, out_size) <= 1).to(cuda_device)
    assert torch.equal(got[defined], want[defined]), name


@pytest.mark.cuda
def test_render_cli_on_gpu(cuda_device, tmp_path):
    """render_cli.main on the card over a tiny COLMAP scene: every PNG
    decodes equal to the quantised render of the Scene's own camera."""
    from gsplat_tpu_torch import render_cli
    from gsplat_tpu_torch.config import ModelParams
    from gsplat_tpu_torch.io import png
    from gsplat_tpu_torch.io.ply import save_gaussian_ply
    from gsplat_tpu_torch.io.synthetic import make_colmap_scene
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.scene import Scene

    src = make_colmap_scene(tmp_path / "src", n_cams=9, width=96, height=64, n_points=60)
    rng = np.random.default_rng(2)
    n = 300
    model = tmp_path / "model"
    save_gaussian_ply(model / "point_cloud" / "iteration_4" / "point_cloud.ply",
                      rng.normal(size=(n, 3)) * 0.8, rng.random((n, 3)), np.zeros((n, 15, 3)),
                      rng.normal(size=(n, 1)), np.full((n, 3), -2.5), np.tile([1.0, 0, 0, 0], (n, 1)))
    (model / "cfg_args").write_text(f"Namespace(source_path='{src}')")
    before = (texp.expand_pairs.launches, traster.composite_fwd.launches)
    assert render_cli.main(["--model_path", str(model), "--pair_budget", "256",
                            "--chunk_size", "32"]) == 0
    assert texp.expand_pairs.launches > before[0] and traster.composite_fwd.launches > before[1]
    scene = Scene(ModelParams(source_path=str(src), model_path=str(model), eval=True),
                  load_iteration=-1, shuffle=False)
    bg = torch.zeros(3, device=cuda_device)
    for split, cams in (("train", scene.get_train_cameras()), ("test", scene.get_test_cameras())):
        for idx, cam in enumerate(cams):
            out = render(cam, scene.gaussians, bg, tile_size=32, chunk=32, pair_budget=1 << 14)
            want = (np.clip(out.image.cpu().numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)
            got = png.read_png(model / split / "ours_4" / "renders" / f"{idx:05d}.png")
            np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_sat_render_on_gpu(cuda_device, monkeypatch):
    """The saturating scene on the GPU: the sat render's image bit-equal to
    the GPU render without the cull and within 2e-5 of the CPU's, n_sat
    equal. With and without the cull the d-table (composite_bwd's output)
    is bit-equal, and so are the gradients: reduce_by_gid sums each
    Gaussian's rows in an order fixed by the d-table alone."""
    from gsplat_tpu_torch.interop import camera_from_numpy, gaussians_from_numpy
    from gsplat_tpu_torch.render import render as render_mod
    from gsplat_tpu_torch.render.render import render

    d_tables, reduce = [], render_mod.reduce_by_gid

    def capture(d, n_rows):
        d_tables.append(d.clone())
        return reduce(d, n_rows)

    monkeypatch.setattr(render_mod, "reduce_by_gid", capture)
    s, _ = F.make_sat_scene()
    res = {}
    for dev in ("cpu", cuda_device):
        g = gaussians_from_numpy(s.params, s.n_live, 3, 3, device=dev)
        cam = camera_from_numpy(s.R, s.T, s.fovx, s.fovy, F.SAT_W, F.SAT_H, device=dev)
        probe = render(cam, g, torch.zeros(3), **F.SAT_KW, sat_budget=F.SAT_KW["pair_budget"])
        fitted = -(-int(probe.n_sat) // 8) * 8
        for name, kw in (("base", {}), ("sat", dict(sat_budget=fitted))):
            params = {k: v.clone().requires_grad_() for k, v in g.params().items()}
            out = render(cam, g.replace(**params), torch.zeros(3, device=dev), **F.SAT_KW,
                         **kw)
            grads = torch.autograd.grad((out.image ** 2).sum(), list(params.values()))
            assert len(d_tables) == 1
            res[str(dev), name] = out, grads, d_tables.pop()
    cpu, gpu, gpu_base = res["cpu", "sat"][0], res[str(cuda_device), "sat"][0], \
        res[str(cuda_device), "base"][0]
    assert int(gpu.n_sat) == int(cpu.n_sat) > 0 and int(gpu.n_dropped) == 0
    assert torch.equal(gpu.image, gpu_base.image)
    np.testing.assert_allclose(gpu.image.detach().cpu().numpy(), cpu.image.detach().numpy(),
                               rtol=0, atol=ATOL)
    (_, g_base, d_base), (_, g_sat, d_sat) = (res[str(cuda_device), k] for k in ("base", "sat"))
    assert torch.equal(d_base, d_sat)
    for a, b in zip(g_base, g_sat):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_render_gradients_on_gpu_match_cpu(cuda_device):
    from gsplat_tpu_torch.interop import camera_from_numpy, gaussians_from_numpy
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loss import photometric_loss

    s = F.make_scene(seed=5)
    target = np.random.default_rng(7).random((F.H, F.W, 3)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        g = gaussians_from_numpy(s.params, s.n_live, 3, 3, device=dev)
        cam = camera_from_numpy(s.R, s.T, F.FOVX, F.FOVY, F.W, F.H, image=target, device=dev)
        params = {k: v.clone().requires_grad_() for k, v in g.params().items()}
        off = torch.zeros((g.capacity, 2), device=dev, requires_grad=True)
        out = render(cam, g.replace(**params), torch.tensor([0.1, 0.2, 0.3], device=dev),
                     tile_size=F.TILE, chunk=F.CHUNK, pair_budget=F.BUDGET,
                     kept_budget=F.BUDGET - F.CHUNK, mean2d_offset=off)
        gr = torch.autograd.grad(photometric_loss(out.image, cam.image),
                                 list(params.values()) + [off])
        grads[str(dev)] = [x.cpu().numpy() for x in gr]
    for want, got in zip(grads["cpu"], grads[str(cuda_device)]):
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale)


def small_step_grads(device, deterministic=False):
    """torch.autograd.grad of the photometric loss of one render (the train
    step's gradients, densification's mean2d offset too) on a fixture scene
    -> {group: gradient}."""
    from gsplat_tpu_torch.interop import camera_from_numpy, gaussians_from_numpy
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loss import photometric_loss

    s = F.make_scene(seed=5)
    target = np.random.default_rng(7).random((F.H, F.W, 3)).astype(np.float32)
    g = gaussians_from_numpy(s.params, s.n_live, 3, 3, device=device)
    cam = camera_from_numpy(s.R, s.T, F.FOVX, F.FOVY, F.W, F.H, image=target, device=device)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        params = {k: v.clone().requires_grad_() for k, v in g.params().items()}
        off = torch.zeros((g.capacity, 2), device=device, requires_grad=True)
        out = render(cam, g.replace(**params), torch.tensor([0.1, 0.2, 0.3], device=device),
                     tile_size=F.TILE, chunk=F.CHUNK, pair_budget=F.BUDGET,
                     kept_budget=F.BUDGET - F.CHUNK, mean2d_offset=off)
        grads = torch.autograd.grad(photometric_loss(out.image, cam.image),
                                    list(params.values()) + [off])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    return dict(zip(list(params) + ["mean2d_offset"], grads))


@pytest.mark.cuda
def test_step_gradients_on_gpu_are_bit_reproducible(cuda_device):
    """Two gradient passes of one step on the same inputs give equal bits in
    every parameter group. The step also runs under
    torch.use_deterministic_algorithms(True), which raises on an operation
    PyTorch knows to be nondeterministic (a float cumsum or index_add_ on
    CUDA) and fills fresh buffers with NaN (every output row the kernels
    leave unwritten would show); cuDNN may pick other convolution
    algorithms there, so that run is held to 1e-5 of each group's max."""
    a, b = small_step_grads(cuda_device), small_step_grads(cuda_device)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert float(a[k].abs().max()) > 0, k
    c = small_step_grads(cuda_device, deterministic=True)
    for k in a:
        assert bool(torch.isfinite(c[k]).all()), k
        assert float((c[k] - a[k]).abs().max()) <= 1e-5 * float(a[k].abs().max()), k


@pytest.mark.cuda
def test_ssim_on_gpu_ignores_tf32_flags(cuda_device):
    from gsplat_tpu_torch.train.loss import ssim

    rng = np.random.default_rng(11)
    a = rng.random((270, 480, 3))
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    want = float(ssim(torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device)))
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        x = torch.from_numpy(a).float().to(cuda_device).requires_grad_()
        got = ssim(x, torch.from_numpy(b).float().to(cuda_device))
        (g,) = torch.autograd.grad(got, [x])
        xd = torch.from_numpy(a).to(cuda_device).requires_grad_()
        (gd,) = torch.autograd.grad(ssim(xd, torch.from_numpy(b).to(cuda_device)), [xd])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    assert torch.backends.cudnn.allow_tf32 == prev[1]
    assert abs(float(got.detach()) - want) <= 1e-6, (float(got.detach()), want)
    scale = float(gd.abs().max())
    assert float((g.double() - gd).abs().max()) <= 1e-4 * scale


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU the wrappers never build or load a kernel."""
    def no_build(name):
        raise AssertionError(f"{name} built for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    table, total, meta = expansion_inputs(100, 1, 1024, True)
    counts = (texp.expand_pairs, traster.composite_fwd, traster.composite_bwd,
              tbounds.segment_ends, treduce.segment_sum, tscan.prefix_sum_small,
              tcompact.compact_runs, traster.packed_fwd_count, traster.packed_bwd_count)
    before = [f.launches for f in counts]
    texp.expand_pairs(table, total, 1024, **meta)
    texp.expand_pairs(table, total, 1024, **{**meta, "sat_pack": True})
    tscan.prefix_sum_small(torch.arange(9, dtype=torch.int32))
    tcompact.compact_runs(*compact_inputs(0, 8)[:4], 64, -1)
    tables = pair_tables(F.make_scene())
    traster.composite_fwd(*tables, tw=4, tile_size=F.TILE, chunk=F.CHUNK)
    args, kw = bwd_inputs("sparse", "cpu")
    traster.composite_bwd(*args, **kw)
    # the packed table too, with its own counts
    packed = packed_table(tables[0])
    traster.composite_fwd(packed, *tables[1:], tw=4, tile_size=F.TILE, chunk=F.CHUNK)
    traster.composite_bwd(packed_table(args[0]), *args[1:], **kw)
    tbounds.segment_ends(torch.arange(8, dtype=torch.float32), 10)
    d, n_rows = crafted_d_table("long_segment")
    d = torch.from_numpy(d)
    treduce.segment_sum(d, torch.arange(d.shape[0]), torch.zeros(n_rows - 1, dtype=torch.int32),
                        n_rows)
    assert [f.launches for f in counts] == before


def test_other_devices_raise():
    """No silent fallback: a tensor neither on the CPU nor on CUDA raises."""
    table, total, meta = expansion_inputs(100, 1, 1024, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        texp.expand_pairs(table.to("meta"), total.to("meta"), 1024, **meta)
    gathered, ts, tc = pair_tables(F.make_scene())
    with pytest.raises(ValueError, match="cuda or cpu"):
        traster.composite_fwd(gathered.to("meta"), ts.to("meta"), tc.to("meta"), tw=4,
                              tile_size=F.TILE, chunk=F.CHUNK)
    args, kw = bwd_inputs("sparse", "meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        traster.composite_bwd(*args, **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbounds.segment_ends(torch.zeros(8, device="meta"), 10)
    with pytest.raises(ValueError, match="cuda or cpu"):
        treduce.segment_sum(torch.zeros((8, 16), device="meta"),
                            torch.zeros(8, dtype=torch.int64, device="meta"),
                            torch.zeros(3, dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tscan.prefix_sum_small(torch.zeros(8, dtype=torch.int32, device="meta"))
    src, astart, rbase, length, _ = compact_inputs(0, 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tcompact.compact_runs(src.to("meta"), astart, rbase, length, 64, -1)


def test_ptxas_usage_parses_the_report():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111scan_kernelEPKiiiiiiPyPjPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111scan_kernelEPKiiiiiiPyPjPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 16932 bytes smem, 408 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'
ptxas info    : Function properties for _Z1kPf
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
"""
    got = _build.ptxas_usage(log)
    assert got == {
        "_ZN12_GLOBAL__N_111scan_kernelEPKiiiiiiPyPjPi":
            dict(registers=38, stack=0, spill_stores=0, spill_loads=0),
        "_Z1kPf": dict(registers=255, stack=24, spill_stores=8, spill_loads=12)}


def test_launch_errors_raise():
    """A nonzero cudaGetLastError() from an entry point becomes an exception."""
    class FakeLib:
        @staticmethod
        def gsplat_cuda_error_string(err):
            return b"invalid configuration argument"

    _build.check(FakeLib, 0, "composite_fwd launch")
    with pytest.raises(RuntimeError, match="CUDA error 9 .invalid configuration"):
        _build.check(FakeLib, 9, "composite_fwd launch")


def densify_state(device, n=3000, cap=4096, seed=5):
    """A state with clones, splits and prunes, every accumulator, scale and
    opacity well off its threshold (1e-2 relative)."""
    from gsplat_tpu_torch.interop import adam_state_from_numpy, gaussians_from_numpy

    rng = np.random.default_rng(seed)
    live = np.arange(cap) < n
    scale = np.where(live[:, None], rng.choice([0.005, 0.5], (cap, 1))
                     * rng.uniform(0.5, 1.5, (cap, 3)), np.exp(-30.0))
    opacity = np.where(live, rng.choice([-8.0, 1.0], cap), -30.0)[:, None]
    denom = np.where(live, rng.integers(1, 5, cap), 0).astype(np.float32)
    accum = np.where(live, rng.choice([0.1, 2.0], cap) * rng.uniform(1, 3, cap), 0) * denom
    rot = np.where(live[:, None], rng.normal(size=(cap, 4)), [1.0, 0, 0, 0])
    arrays = dict(xyz=rng.normal(size=(cap, 3)), f_dc=rng.random((cap, 3)),
                  f_rest=rng.normal(size=(cap, 15, 3)) * 0.1, opacity=opacity,
                  scaling=np.log(scale), rotation=rot, max_radii2D=rng.uniform(0, 30, cap),
                  xyz_gradient_accum=accum, denom=denom)
    g = gaussians_from_numpy(arrays, n, 3, 3, device=device)
    moments = {k: rng.normal(size=np.asarray(arrays[k]).shape) for k in
               ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")}
    opt = adam_state_from_numpy(moments, {k: np.abs(v) for k, v in moments.items()}, 9,
                                device=device)
    return g, opt


@pytest.mark.cuda
@pytest.mark.parametrize("max_screen", [0.0, 20.0])
def test_densify_on_gpu_matches_cpu(cuda_device, max_screen):
    """densify_and_prune on the card against the CPU on the same tensors and
    noise: the row choice, n_live and n_dropped bit-equal, parameters and
    moments within 1e-6 of each leaf's max."""
    from gsplat_tpu_torch.train import densify as td

    kw = dict(max_grad=0.5, min_opacity=0.005, extent=5.0, max_screen_size=max_screen,
              percent_dense=0.01)
    noise = torch.from_numpy(np.random.default_rng(1).normal(size=(4096, 3)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        g, opt = densify_state(dev)
        sel = [t.cpu() for t in td.densify_selection(g, **kw)]
        out[str(dev)] = sel, td.densify_and_prune(g, opt, noise.to(dev), **kw)
    (sel_c, (g_c, o_c, d_c)), (sel_g, (g_g, o_g, d_g)) = out["cpu"], out[str(cuda_device)]
    for a, b in zip(sel_c, sel_g):
        assert torch.equal(a, b)
    assert int(d_c) == int(d_g) and int(g_c.n_live) == int(g_g.n_live)
    kinds = sel_c[1][sel_c[2]]
    assert all(int((kinds == k).sum()) > 0 for k in range(4))
    pairs = [(getattr(g_c, k), getattr(g_g, k)) for k in
             ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")]
    pairs += [(o_c.mu[k], o_g.mu[k]) for k in o_c.mu] + [(o_c.nu[k], o_g.nu[k]) for k in o_c.nu]
    for want, got in pairs:
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got.cpu() - want).abs().max()) <= 1e-6 * scale


def train_on_gpu(root, out, iters, **other):
    import random as pyrandom

    from gsplat_tpu_torch import config
    from gsplat_tpu_torch.train import loop

    model = config.ModelParams(source_path=str(root), model_path=str(out))
    opt = config.OptimizationParams(iterations=iters, random_background=True,
                                    densify_from_iter=2, densification_interval=5,
                                    densify_until_iter=iters, opacity_reset_interval=10)
    mesh = config.MeshParams(tile_size=16, chunk_size=32, pair_budget=1 << 10, capacity=64)
    pyrandom.seed(0)
    return loop.train(model, opt, config.PipelineParams(),
                      config.OtherParams(test_iterations=[], save_iterations=[], quiet=True,
                                         **other), mesh)[0]


@pytest.mark.cuda
def test_train_on_gpu_resumes_exactly_and_grows(cuda_device, tmp_path):
    """train() on the card: a run resumed from its iteration-7 checkpoint
    ends bit-equal to the straight run (the generator state, the camera
    order, the budgets and the EMA ride the checkpoint; the step is the same
    bits every time), through densify, capacity growth and an opacity
    reset."""
    from gsplat_tpu_torch.interop import gaussians_to_numpy
    from gsplat_tpu_torch.io.synthetic import make_colmap_scene

    root = make_colmap_scene(tmp_path / "scene", n_cams=5, width=64, height=48, n_points=60)
    before = texp.expand_pairs.launches
    full = train_on_gpu(root, tmp_path / "full", 16, checkpoint_iterations=[7, 16])
    assert texp.expand_pairs.launches >= before + 16
    resumed = train_on_gpu(root, tmp_path / "resumed", 16, checkpoint_iterations=[16],
                           start_checkpoint=str(tmp_path / "full" / "chkpnt7.npz"))
    assert full.xyz.device.type == "cuda" and full.capacity > 64
    a, b = gaussians_to_numpy(full), gaussians_to_numpy(resumed)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    za, zb = (np.load(tmp_path / d / "chkpnt16.npz") for d in ("full", "resumed"))
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.cuda
def test_train_cli_on_gpu(cuda_device, tmp_path):
    """python -m gsplat_tpu_torch.cli trains on the card by default."""
    import subprocess
    import sys
    from pathlib import Path

    from gsplat_tpu_torch.io.synthetic import make_colmap_scene

    root = make_colmap_scene(tmp_path / "scene", n_cams=5, width=64, height=48, n_points=60)
    out = tmp_path / "out"
    p = subprocess.run(
        [sys.executable, "-m", "gsplat_tpu_torch.cli", "-s", str(root), "-m", str(out),
         "--iterations", "12", "--capacity", "64", "--pair_budget", "1024",
         "--tile_size", "16", "--chunk_size", "32", "--densify_from_iter", "2",
         "--densification_interval", "5", "--eval", "--test_iterations", "12"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.rstrip().endswith("Training complete.") and "eval test" in p.stdout
    assert "data_device: cuda" in p.stdout
    assert (out / "point_cloud" / "iteration_12" / "point_cloud.ply").exists()


def _lpips_weights(rng):
    """Random VGG16-shaped LPIPS weights (tests/test_lpips.py's shapes and
    scales), numpy float32 in the loader's layout."""
    from gsplat_tpu_torch.lpips import TAP_CHANNELS, VGG16_SLICES

    out_ch = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    convs, in_ch, k = [], 3, 0
    for sl in VGG16_SLICES:
        layers = []
        for _ in sl:
            layers.append((rng.normal(0, 0.08, (out_ch[k], in_ch, 3, 3)).astype(np.float32),
                           rng.normal(0, 0.02, (out_ch[k],)).astype(np.float32)))
            in_ch = out_ch[k]
            k += 1
        convs.append(layers)
    lins = [rng.uniform(0, 0.1, (1, ch, 1, 1)).astype(np.float32) for ch in TAP_CHANNELS]
    return {"convs": convs, "lins": lins}


@pytest.mark.cuda
def test_lpips_on_gpu_is_fp32_whatever_the_tf32_flag(cuda_device):
    """LPIPS runs its convolutions with cuDNN's TF32 off: the same value with
    the global flag on and off (where the flag does change a bare
    256-channel convolution on this card), the flag restored, and
    the CPU's within 1e-4 relative."""
    import torch.nn.functional as tf

    from gsplat_tpu_torch.lpips import lpips, lpips_to_device

    rng = np.random.default_rng(7)
    params = _lpips_weights(rng)
    a = rng.uniform(0, 1, (67, 93, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    on_gpu = lpips_to_device(params, cuda_device)
    ta, tb_ = torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    # conv3_2 (256 -> 256 channels, where cuDNN takes its tensor-core paths)
    # on random features
    w, bias = on_gpu["convs"][2][1]
    x = torch.from_numpy(rng.normal(size=(1, 256, 34, 47)).astype(np.float32)).to(cuda_device)
    prev = torch.backends.cudnn.allow_tf32
    try:
        vals, bare = {}, {}
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            vals[flag] = float(lpips(on_gpu, ta, tb_))
            assert torch.backends.cudnn.allow_tf32 is flag
            bare[flag] = tf.conv2d(x, w, bias, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert not torch.equal(bare[True], bare[False])   # the flag matters here
    assert vals[True] == vals[False]
    cpu = float(lpips(params, a, b, device="cpu"))
    assert vals[False] == pytest.approx(cpu, rel=1e-4)


@pytest.mark.cuda
def test_evaluate_model_on_gpu_matches_cpu(cuda_device, tmp_path):
    from gsplat_tpu_torch.io import png
    from gsplat_tpu_torch.metrics_cli import evaluate_model

    rng = np.random.default_rng(11)
    for split in ("test", "train"):
        for i in range(2):
            gt = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
            r = np.clip(gt.astype(int) + rng.integers(-40, 41, gt.shape), 0, 255)
            png.write_png(tmp_path / split / "ours_3" / "renders" / f"{i:05d}.png",
                          r.astype(np.uint8))
            png.write_png(tmp_path / split / "ours_3" / "gt" / f"{i:05d}.png", gt)
    params = _lpips_weights(rng)
    got = evaluate_model(tmp_path, params)          # the card by default
    want = evaluate_model(tmp_path, params, device="cpu")
    assert list(got) == list(want) == ["test/ours_3", "train/ours_3"]
    for key in want:
        assert got[key]["n_images"] == want[key]["n_images"] == 2
        for m in ("SSIM", "PSNR", "L1"):
            assert got[key][m] == pytest.approx(want[key][m], rel=1e-5), (key, m)
        assert got[key]["LPIPS"] == pytest.approx(want[key]["LPIPS"], rel=1e-4), key


@pytest.mark.cuda
def test_network_gui_request_on_gpu(cuda_device, tmp_path):
    """One SIBR request served on the card by the loop's _serve_gui_request:
    the reply's bytes equal image_to_bytes of a render of the same camera
    apart, and K1 and K2 launched for it."""
    from gsplat_tpu_torch import network_gui
    from gsplat_tpu_torch.config import MeshParams
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.interop import gaussians_from_numpy
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loop import _serve_gui_request

    s = F.make_scene(seed=0)
    g = gaussians_from_numpy(s.params, s.n_live, s.sh_degree, s.sh_degree, device=cuda_device)
    cam = make_camera(s.R, s.T, s.fovx, s.fovy, 75, 53, device="cpu")
    req = network_gui.parse_message({
        "resolution_x": 75, "resolution_y": 53, "train": True, "keep_alive": True,
        "fov_x": s.fovx, "fov_y": s.fovy, "scaling_modifier": 0.7,
        "view_matrix": cam.world_view.reshape(-1).tolist(),
        "view_projection_matrix": cam.full_proj.reshape(-1).tolist()})
    server = network_gui.NetworkGUIServer(tmp_path, ip="127.0.0.1", port=0)
    bg = torch.zeros(3, device=cuda_device)
    mesh = MeshParams(tile_size=16, chunk_size=32, pair_budget=1 << 12)
    try:
        before = (texp.expand_pairs.launches, traster.composite_fwd.launches)
        _serve_gui_request(server, req, g, bg, mesh, 1 << 12)
        after = (texp.expand_pairs.launches, traster.composite_fwd.launches)
    finally:
        server.close()
    assert server.render_errors == 0 and req._done.is_set()
    assert after[0] > before[0] and after[1] > before[1]
    out = render(network_gui.camera_from_request(req, cuda_device), g, bg, tile_size=16,
                 chunk=32, pair_budget=1 << 12, scaling_modifier=0.7)
    assert int(out.n_dropped) == 0
    assert req._image == network_gui.image_to_bytes(out.image)
    assert len(req._image) == 75 * 53 * 3


@pytest.mark.cuda
def test_spans_on_gpu(cuda_device):
    """A train step under torch.profiler on the card: the autograd engine's
    device thread runs _Rasterize.backward, whose span takes the step's
    `backward` as parent; every span has device times from its CUDA events;
    the backward's three parts tile it; the gather's live counter stays on
    the card and equals n_pairs - n_culled."""
    import dataclasses
    import threading

    from torch.profiler import ProfilerActivity, profile

    from gsplat_tpu_torch import spans
    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.interop import camera_from_numpy, gaussians_from_numpy
    from gsplat_tpu_torch.train.loop import make_train_step
    from gsplat_tpu_torch.train.optim import init_adam_state

    s = F.make_scene(seed=0)
    g = gaussians_from_numpy(s.params, s.n_live, s.sh_degree, s.sh_degree, device=cuda_device)
    cam = camera_from_numpy(s.R, s.T, s.fovx, s.fovy, F.W, F.H, device=cuda_device)
    cam = dataclasses.replace(cam, image=torch.rand(F.H, F.W, 3, device=cuda_device))
    step = make_train_step(OptimizationParams(), MeshParams(tile_size=F.TILE, chunk_size=F.CHUNK,
                                                            pair_budget=F.BUDGET),
                           1.0, F.W, F.H)
    bg = torch.zeros(3, device=cuda_device)
    step(g, init_adam_state(g.params()), cam, bg, 1, 0.0)      # builds the kernels
    threads = {}
    real = spans.Span.__enter__

    def enter(self):
        threads[self.name] = threading.get_ident()
        return real(self)

    spans.clear()
    try:
        spans.Span.__enter__ = enter
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            out = step(g, init_adam_state(g.params()), cam, bg, 1, 0.0)
            torch.cuda.synchronize()
    finally:
        spans.Span.__enter__ = real
    recs = {r.name: r for r in spans.records()}
    assert recs["backward.raster"].parent == recs["backward"].id
    assert recs["backward.raster.reduce"].parent == recs["backward.raster"].id
    assert threads["backward.raster"] != threads["backward"]   # the engine's thread
    assert {r.root for r in recs.values()} == {recs["step"].id}
    assert all(r.device_ms() is not None and r.device_ms() >= 0 for r in recs.values())
    bwd, raster = recs["backward"], recs["backward.raster"]
    parts = (spans.elapsed_ms(bwd.ev0, raster.ev0) + raster.device_ms()
             + spans.elapsed_ms(raster.ev1, bwd.ev1))
    assert abs(parts - bwd.device_ms()) <= 0.01 * bwd.device_ms() + 1e-3
    live = recs["gather"].counters["live"]
    assert live.device.type == "cuda"
    assert int(live) == int(out[4] - out[6]) > 0
