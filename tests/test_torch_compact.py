"""Port parity, K6: gsplat_tpu_torch.render.compact.compact_runs's plain
version (what a CPU tensor takes) against the JAX package's Pallas kernel
gsplat_tpu.render.compact_pallas.compact_runs in interpret mode, on
tests/test_compact_pallas.py's inputs, scaled from the reference's 128-pair
rows to the port's pair units.

Region rows must be bit-equal. The Pallas kernel may write up to 15 rows of
128 past the last region (its blocks over-copy and its sequential grid lets
the next tile overwrite them); the port never writes outside a region, so
every other row must hold `fill` in the port, and is compared with the
reference only beyond that overhang."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.render.compact_pallas import compact_runs as j_compact_runs
from gsplat_tpu_torch.render import compact

torch.set_num_threads(1)
ROW = 128   # pairs per row of the reference's kernel


def run_both(src, astart, rbase, nch, out_rows, fill):
    want = np.asarray(j_compact_runs(
        jnp.asarray(src), jnp.asarray(astart), jnp.asarray(rbase), jnp.asarray(nch),
        out_size=out_rows * ROW, fill=fill, interpret=True))
    got = compact.compact_runs(
        torch.from_numpy(src), *(torch.from_numpy(a * ROW) for a in (astart, rbase, nch)),
        out_rows * ROW, fill).numpy()
    covered = np.zeros(out_rows * ROW, bool)
    for r, k in zip(rbase, nch):
        covered[r * ROW:(r + k) * ROW] = True
    np.testing.assert_array_equal(got[covered], want[covered])
    assert (got[~covered] == fill).all()
    rend = int((rbase + nch).max())
    beyond = np.arange(out_rows * ROW) >= (rend + 16) * ROW
    np.testing.assert_array_equal(got[beyond], want[beyond])
    return got, covered


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_runs_matches_pallas(seed):
    """tests/test_compact_pallas.py::test_compact_runs_matches_oracle's draws."""
    rng = np.random.default_rng(seed)
    T = 37
    nch = rng.integers(0, 40, T).astype(np.int32)
    rbase = np.concatenate([[0], np.cumsum(nch)[:-1]]).astype(np.int32)
    out_rows = int(np.cumsum(nch)[-1]) + 24
    src_rows = 2048
    astart = np.array([rng.integers(0, src_rows - max(int(k), 1) + 1) for k in nch],
                      np.int32)
    src = rng.integers(0, 1 << 20, src_rows * ROW).astype(np.int32)
    _, covered = run_both(src, astart, rbase, nch, out_rows, fill=-7)
    assert covered.sum() == nch.sum() * ROW and (~covered).sum() == 24 * ROW


def test_compact_runs_empty_and_full_blocks():
    """tests/test_compact_pallas.py's block-multiple and empty-tile case: a
    gap between two regions holds the fill."""
    got, covered = run_both(np.arange(64 * ROW, dtype=np.int32),
                            np.array([0, 16, 0], np.int32), np.array([0, 32, 48], np.int32),
                            np.array([32, 0, 16], np.int32), 80, fill=-1)
    np.testing.assert_array_equal(got[:32 * ROW], np.arange(32 * ROW))
    np.testing.assert_array_equal(got[48 * ROW:64 * ROW], np.arange(16 * ROW))
    assert (got[32 * ROW:48 * ROW] == -1).all() and (got[64 * ROW:] == -1).all()


def test_compact_runs_chunk_8_regions_and_bounds():
    """The binning's chunk-8 regions (no 128 multiple), and runs that pass
    the end of the output or of the source: rows past either keep the fill."""
    src = torch.arange(100, dtype=torch.int32)
    got = compact.compact_runs(src, torch.tensor([8, 40, 96]), torch.tensor([0, 16, 24]),
                               torch.tensor([16, 8, 16]), 36, -5)
    want = [*range(8, 24), *range(40, 48), 96, 97, 98, 99] + [-5] * 8
    assert got.tolist() == want


def test_compact_runs_plain_overlapping_regions():
    """The binning's clamped overflow (regions that overlap and pass the
    end): every row one region covers holds that region's source row, every
    row none covers the fill, through the CPU wrapper and into `out`."""
    rng = np.random.default_rng(9)
    length = torch.from_numpy(rng.integers(0, 12, 30).astype(np.int32) * 8)
    out_size = int(length.sum()) // 3
    rend = torch.cumsum(length.long(), 0)
    rbase = torch.minimum(rend - length, torch.clamp(out_size - length.long(), min=0)).int()
    astart = torch.from_numpy(rng.integers(0, 400, 30).astype(np.int32) * 8)
    src = torch.from_numpy(rng.integers(0, 1 << 20, 4000).astype(np.int32))
    out = torch.full((out_size,), -99, dtype=torch.int32)
    got = compact.compact_runs(src, astart, rbase, length, out_size, -5, out=out)
    assert got is out
    owners = [[] for _ in range(out_size)]
    for t, (a, r, n) in enumerate(zip(astart.tolist(), rbase.tolist(), length.tolist())):
        for j in range(n):
            if r + j < out_size:
                owners[r + j].append(int(src[a + j]))
    once = [o[0] for o in owners if len(o) == 1]
    assert len(once) > 0 and any(len(o) > 1 for o in owners)
    assert got[[len(o) == 1 for o in owners]].tolist() == once
    assert (got[[len(o) == 0 for o in owners]] == -5).all()
