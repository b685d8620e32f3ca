"""Port parity, pair expansion on crafted tables: the plain version of the
expand_pairs kernel (gsplat_tpu_torch.render.expand.expand_pairs on the CPU)
against the JAX package's expansion on the same numpy projection
(torch_port_fixtures.crafted_projection): a Gaussian owning more slots than
one block of the kernel's merged sequence, runs of one-slot rows, total 0,
total equal to the slot budget and past it, and a budget that is no
multiple of the kernel's block; without the cull, with it, and with the
saturation quanta packed under the gids.

The reference is gsplat_tpu.render.binning._expand_xla, the JAX package's
plain form of its Pallas expansion kernel: tests/test_expand_pallas.py holds
the Pallas kernel bit-equal to it, and tests/test_torch_binning.py holds the
port against the Pallas kernel itself once (its interpret-mode compile takes
minutes on the CPU, once for every table shape). Keys and gids BIT-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.render import binning as jb
from gsplat_tpu_torch.render import binning as tb
from gsplat_tpu_torch.render import expand as texp
from torch_port_fixtures import (EXP_H, EXP_S, EXP_TILE, EXP_W, EXPANSION_CASES,
                                 crafted_projection)

torch.set_num_threads(1)
MODES = {"no_cull": (False, False), "cull": (True, False), "sat_pack": (True, True)}


def reference(arrays, do_cull, sat_pack):
    mean2d, radius, depth, conic, opacity = (jnp.asarray(a) for a in arrays)
    n = arrays[0].shape[0]
    tw, th = jb.tile_grid(EXP_W, EXP_H, EXP_TILE)
    x0, y0, x1, y1 = jb.tile_rects(mean2d, radius, tw, th, EXP_TILE)
    rect_w = jnp.maximum(x1 - x0, 0)
    counts = jnp.where(radius > 0, rect_w * jnp.maximum(y1 - y0, 0), 0).astype(jnp.int32)
    cum = jnp.cumsum(counts)
    key, gid = jax.jit(lambda: jb._expand_xla(
        mean2d, depth, x0, y0, rect_w, counts, cum, cum - counts, cum[-1], conic,
        opacity, n=n, tw=tw, num_tiles=tw * th, tile_size=EXP_TILE, pair_budget=EXP_S,
        do_cull=do_cull, sat_pack=sat_pack))()
    return np.asarray(key), np.asarray(gid), int(cum[-1])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(EXPANSION_CASES))
def test_expand_pairs_crafted_tables_match_reference(case, mode):
    do_cull, sat_pack = MODES[mode]
    arrays = crafted_projection(case)
    key_want, gid_want, total = reference(arrays, do_cull, sat_pack)
    tw, th = tb.tile_grid(EXP_W, EXP_H, EXP_TILE)
    db = tb.depth_shift(tw * th)
    table, t_total = tb.expansion_table(*map(torch.from_numpy, arrays), tw=tw, th=th,
                                        tile_size=EXP_TILE, db=db, do_cull=do_cull)
    assert int(t_total) == total
    key, gid = texp.expand_pairs(table, t_total, EXP_S, tw=tw, tile_size=EXP_TILE, db=db,
                                 num_tiles=tw * th, n_orig=arrays[0].shape[0],
                                 do_cull=do_cull, sat_pack=sat_pack)
    np.testing.assert_array_equal(key.numpy(), key_want)
    np.testing.assert_array_equal(gid.numpy(), gid_want)
    # the tables have the shapes the case names
    counts = torch.diff(table[texp.COL_OFF], append=t_total.reshape(1))
    n_wide, n_one, _ = EXPANSION_CASES[case]
    assert int((counts == tw * th).sum()) == n_wide and int((counts == 1).sum()) == n_one
    assert (total, total == EXP_S, total > EXP_S) == (
        n_wide * tw * th + n_one, case == "full", case == "overflow")
    assert EXP_S % 1024 != 0 and tw * th > 1024
    if do_cull and case in ("wide", "full"):
        live = min(total, EXP_S)
        culled = int((key[:live] == texp.key_invalid(tw * th, db)).sum())
        assert 0 < culled < live
