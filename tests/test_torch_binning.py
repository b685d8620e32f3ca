"""Port parity, binning: gsplat_tpu_torch.render.binning.bin_gaussians (the
plain version of the expand_pairs kernel on the CPU) against
gsplat_tpu.render.binning.bin_gaussians on the same numpy projection.

Everything binning returns is integer-valued, so every table must be
BIT-equal: gid_s, tile_start, tile_count, n_pairs, n_dropped, n_culled and
grad_ok, with the tight cull on and off and with budget overflow; with the
saturation bound cull also n_sat, and gid_s on the rows its regions cover
(the reference's plain form leaves other rows of its own there, the port
the null gid)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.render import binning as jb
from gsplat_tpu_torch.render import binning as tb
from gsplat_tpu_torch.render import expand as texp
from torch_port_fixtures import random_projection, saturating_projection

torch.set_num_threads(1)
FIELDS = ("gid_s", "tile_start", "tile_count", "n_pairs", "n_dropped",
          "n_culled", "grad_ok")


def simple_projection():
    """tests/test_binning.py::simple_case."""
    return (np.array([[8.0, 8.0], [30.0, 30.0], [50.0, 50.0]], np.float32),
            np.array([4.0, 10.0, 0.0], np.float32),
            np.array([2.0, 1.0, 3.0], np.float32), None, None)


def overflow_projection():
    """tests/test_binning.py::test_overflow_budget: 10 Gaussians covering
    all 16 tiles each, into a 64-slot budget."""
    return (np.full((10, 2), 32.0, np.float32), np.full(10, 40.0, np.float32),
            np.arange(10, dtype=np.float32), None, None)


CASES = {
    # name: (projection, width, height, tile, chunk, pair_budget, kept_budget)
    "simple": (simple_projection(), 64, 64, 16, 8, 64, None),
    "overflow": (overflow_projection(), 64, 64, 16, 8, 64, None),
    # the cull runs when pair_budget < 8n, or when kept_budget < pair_budget
    "cull_gather_regime": (random_projection(600, 0), 256, 192, 16, 8, 4096, None),
    "b2_regime_cull_off": (random_projection(100, 1), 256, 192, 16, 8, 8192, None),
    "b2_regime_kept_budget": (random_projection(100, 1), 256, 192, 16, 8, 8192, 2048),
    "heavy_overflow": (random_projection(500, 2), 256, 192, 16, 8, 2048, None),
    "kept_overflow": (random_projection(300, 5), 256, 192, 16, 8, 4096, 512),
    "dead_cluster": (random_projection(400, 3, clustered_dead=True), 256, 192, 16, 8,
                     4096, None),
    "empty": (random_projection(64, 4, dead_frac=1.0), 256, 192, 16, 8, 1024, None),
}


def run_both(case, cull):
    (mean2d, radius, depth, conic, opacity), w, h, ts, ch, budget, kept = CASES[case]
    if not cull or conic is None:
        conic = opacity = None
    kw = dict(width=w, height=h, tile_size=ts, chunk=ch, pair_budget=budget,
              kept_budget=kept)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (mean2d, radius, depth, conic, opacity)]
    want = jax.jit(lambda m, r, d, c, o: jb.bin_gaussians(
        m, r, d, cull_conic=c, cull_opacity=o, interpret=True, **kw))(*jargs)
    targs = [torch.from_numpy(a) if a is not None else None
             for a in (mean2d, radius, depth, conic, opacity)]
    got = tb.bin_gaussians(*targs[:3], cull_conic=targs[3], cull_opacity=targs[4], **kw)
    return want, got


@pytest.mark.parametrize("case,cull", [
    (case, cull) for case in CASES
    for cull in ((False, True) if CASES[case][0][3] is not None else (False,))
])
def test_bin_gaussians_bit_equal(case, cull):
    want, got = run_both(case, cull)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    if case in ("overflow", "heavy_overflow", "kept_overflow"):
        assert int(got.n_dropped) > 0
    if cull and case == "cull_gather_regime":
        assert int(got.n_culled) > 0


def test_expansion_matches_fused_pallas_kernel():
    """The port's expansion (column table + plain expand_pairs) against the
    JAX package's fused Pallas kernel in interpret mode, slot for slot, the
    way tests/test_expand_pallas.py runs it."""
    width, height, ts, budget = 256, 192, 16, 4096
    mean2d, radius, depth, conic, opacity = random_projection(300, 7)
    tw, th = jb.tile_grid(width, height, ts)
    num_tiles = tw * th
    x0, y0, x1, y1 = jb.tile_rects(jnp.asarray(mean2d), jnp.asarray(radius), tw, th, ts)
    rect_w = jnp.maximum(x1 - x0, 0)
    counts = jnp.where(jnp.asarray(radius) > 0, rect_w * jnp.maximum(y1 - y0, 0),
                       0).astype(jnp.int32)
    total = jnp.sum(counts)
    key_f, gid_f = jax.jit(lambda: jb._expand_fused(
        jnp.asarray(mean2d), jnp.asarray(depth), x0, y0, rect_w, counts, total,
        jnp.asarray(conic), jnp.asarray(opacity), n=300, tw=tw,
        num_tiles=num_tiles, tile_size=ts, pair_budget=budget, do_cull=True,
        interpret=True))()

    db = tb.depth_shift(num_tiles)
    table, t_total = tb.expansion_table(
        *map(torch.from_numpy, (mean2d, radius, depth, conic, opacity)),
        tw=tw, th=th, tile_size=ts, db=db, do_cull=True)
    assert int(t_total) == int(total)
    key, gid = texp.expand_pairs(table, t_total, budget, tw=tw, tile_size=ts,
                                 db=db, num_tiles=num_tiles, n_orig=300, do_cull=True)
    np.testing.assert_array_equal(key.numpy(), np.asarray(key_f))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(gid_f))
    assert (gid.numpy() == 300).sum() > budget - int(total)  # the cull removed pairs


@pytest.mark.parametrize("num_tiles", [16, 2040, 8160])
def test_pack_sort_key_and_out_budget(num_tiles):
    rng = np.random.default_rng(num_tiles)
    tile = rng.integers(0, num_tiles + 1, 500).astype(np.int32)
    depth = rng.uniform(-5, 50, 500).astype(np.float32)
    depth[:3] = [np.inf, 0.0, -0.0]
    want = np.asarray(jb.pack_sort_key(jnp.asarray(tile), jnp.asarray(depth), num_tiles))
    got = tb.pack_sort_key(torch.from_numpy(tile), torch.from_numpy(depth), num_tiles)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tb.out_budget(4096, num_tiles, 128) == jb.out_budget(4096, num_tiles, 128)


def test_expanded_keys_are_pack_sort_key():
    """Each kept slot's key is pack_sort_key(its tile, its Gaussian's depth);
    culled and invalid slots carry key_invalid, the key of (num_tiles, +inf)."""
    width, height, ts, budget, n = 256, 192, 16, 4096, 300
    arrays = random_projection(n, 7)
    tw, th = tb.tile_grid(width, height, ts)
    db = tb.depth_shift(tw * th)
    table, total = tb.expansion_table(*map(torch.from_numpy, arrays), tw=tw, th=th,
                                      tile_size=ts, db=db, do_cull=True)
    key, gid = texp.expand_pairs(table, total, budget, tw=tw, tile_size=ts, db=db,
                                 num_tiles=tw * th, n_orig=n, do_cull=True)
    kept = gid != n
    assert 0 < int(kept.sum()) < int(total)
    depth = torch.from_numpy(arrays[2])
    want = tb.pack_sort_key(key[kept] >> db, depth[gid[kept].long()], tw * th)
    assert torch.equal(key[kept], want)
    invalid = tb.pack_sort_key(torch.tensor([tw * th]), torch.tensor([float("inf")]),
                               tw * th)
    assert (key[~kept] == texp.key_invalid(tw * th, db)).all()
    assert texp.key_invalid(tw * th, db) == int(invalid)


def test_sat_pack_expansion_matches_reference():
    """K1 with sat_pack: the plain version against jb._expand_xla(...,
    sat_pack=True), the reference's plain form, slot for slot; every kept
    slot's gid packs its Gaussian and a quantum, null slots N << 6."""
    width, height, ts, budget = 64, 64, 16, 2048
    arrays = saturating_projection(100, 3)
    mean2d, radius, depth, conic, opacity = (jnp.asarray(a) for a in arrays)
    n = arrays[0].shape[0]
    tw, th = jb.tile_grid(width, height, ts)
    x0, y0, x1, y1 = jb.tile_rects(mean2d, radius, tw, th, ts)
    rect_w = jnp.maximum(x1 - x0, 0)
    counts = jnp.where(radius > 0, rect_w * jnp.maximum(y1 - y0, 0), 0).astype(jnp.int32)
    cum = jnp.cumsum(counts)
    key_x, gid_x = jax.jit(lambda: jb._expand_xla(
        mean2d, depth, x0, y0, rect_w, counts, cum, cum - counts, cum[-1], conic,
        opacity, n=n, tw=tw, num_tiles=tw * th, tile_size=ts, pair_budget=budget,
        do_cull=True, sat_pack=True))()
    db = tb.depth_shift(tw * th)
    table, total = tb.expansion_table(*map(torch.from_numpy, arrays), tw=tw, th=th,
                                      tile_size=ts, db=db, do_cull=True)
    key, gid = texp.expand_pairs(table, total, budget, tw=tw, tile_size=ts, db=db,
                                 num_tiles=tw * th, n_orig=n, do_cull=True, sat_pack=True)
    np.testing.assert_array_equal(key.numpy(), np.asarray(key_x))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(gid_x))
    kept = key.numpy() != texp.key_invalid(tw * th, db)
    q = gid.numpy() & 63
    assert (gid.numpy()[~kept] == n << 6).all() and (gid.numpy()[kept] >> 6 < n).all()
    assert 0 < (q[kept] > 0).sum() < kept.sum() and q.max() <= 26   # alpha <= 0.99


def test_packed_gid_round_trip():
    """gid << 6 | q and its logical-shift decode, for gids up to 2^24 - 1 and
    every q in [0, 63]; the packed values stay non-negative."""
    gid = torch.tensor([0, 1, 5, (1 << 23) + 3, (1 << 24) - 1], dtype=torch.int32)
    for q in range(64):
        packed = texp.pack_gid(gid, q)
        assert (packed >= 0).all() and ((packed & 63) == q).all()
        assert torch.equal(texp.unpack_gid(packed), gid)
    # the decode is logical: a negative int32 loses its sign bits
    assert texp.unpack_gid(torch.tensor([-64], dtype=torch.int32)).item() == (1 << 26) - 1


SAT_SETUP = dict(width=64, height=64, tile_size=16, chunk=8, pair_budget=2048)


@pytest.fixture(scope="module")
def sat_projection():
    arrays = saturating_projection(100, 3)
    probe = tb.bin_gaussians(*map(torch.from_numpy, arrays[:3]),
                             cull_conic=torch.from_numpy(arrays[3]),
                             cull_opacity=torch.from_numpy(arrays[4]),
                             sat_budget=SAT_SETUP["pair_budget"], **SAT_SETUP)
    return arrays, int(probe.n_sat), int(probe.tile_count.max())


def region_rows(tile_start, tile_count, chunk, size):
    """Rows the saturation cull's regions cover: each tile's run rounded out
    to whole chunks (regions start on a chunk boundary, at the tile's head
    offset before its first pair)."""
    covered = np.zeros(size, bool)
    for s, c in zip(tile_start.tolist(), tile_count.tolist()):
        head = s % chunk
        covered[s - head:s - head + -(-(head + c) // chunk) * chunk] = True
    return covered


@pytest.mark.parametrize("which", ["fitted", "probe", "starved", "one_region_exceeds"])
def test_bin_gaussians_sat_matches_reference(sat_projection, which):
    arrays, n_sat, max_count = sat_projection
    chunk, budget = SAT_SETUP["chunk"], SAT_SETUP["pair_budget"]
    sat = {"fitted": -(-n_sat // chunk) * chunk, "probe": budget,
           "starved": n_sat // 2 // chunk * chunk, "one_region_exceeds": chunk}[which]
    jargs = [jnp.asarray(a) for a in arrays]
    want = jax.jit(lambda m, r, d, c, o: jb.bin_gaussians(
        m, r, d, cull_conic=c, cull_opacity=o, sat_budget=sat, interpret=True,
        **SAT_SETUP))(*jargs)
    m, r, d, c, o = map(torch.from_numpy, arrays)
    got = tb.bin_gaussians(m, r, d, cull_conic=c, cull_opacity=o, sat_budget=sat,
                           **SAT_SETUP)
    w_start, w_count = np.asarray(want.tile_start), np.asarray(want.tile_count)
    if which == "one_region_exceeds":
        # a tile's region alone passes the budget: the reference leaves its
        # segment past the table, the port clamps it into [0, sat_budget]
        assert max_count > sat and (w_start + w_count > sat).any()
        w_start = np.clip(w_start, 0, sat)
        w_count = np.clip(np.minimum(w_count, sat - w_start), 0, None)
    np.testing.assert_array_equal(got.tile_start.numpy(), w_start)
    np.testing.assert_array_equal(got.tile_count.numpy(), w_count)
    for f in ("n_sat", "n_pairs", "n_dropped", "n_culled", "grad_ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.gid_s.shape == (sat,) and int(got.n_sat) == n_sat
    covered = region_rows(got.tile_start, got.tile_count, chunk, sat)
    np.testing.assert_array_equal(got.gid_s.numpy()[covered], np.asarray(want.gid_s)[covered])
    overflow = which in ("starved", "one_region_exceeds")
    assert bool(got.grad_ok) != overflow
    assert int(got.n_dropped) == (n_sat - sat if overflow else 0)
    if not overflow:
        kept = int(got.n_pairs) - int(got.n_culled)
        assert 0 < n_sat < kept and (got.gid_s.numpy()[~covered] == 100).all()
        assert int(got.tile_count.sum()) < kept   # the cull cut pairs
