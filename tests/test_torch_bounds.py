"""Port parity, segment ends: gsplat_tpu_torch.render.bounds.segment_ends
(its plain version on the CPU) against gsplat_tpu's segment_ends Pallas
kernel in interpret mode on sorted f32 gid-key rows: bit-equal int32 ends.

The rows carry what the backward's d-table carries after its key sort:
integer-valued gids with repeats, gids with no rows, and a KEY_INVALID
tail (or nothing but it). n = 2048 and P a multiple of 128 meet the TPU
kernel's tiling rule; the port has none (checked on odd sizes against
torch.searchsorted's definition). Key rows with long gaps (gids with no
rows over thousands of ids: gid 0 and those after it, a run in the middle,
every gid past the last valid key) and a row in which every key is one gid
are what the one-pass kernel writes with whole-block fills."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.render.bounds_pallas import segment_ends as j_segment_ends
from gsplat_tpu_torch.render.bounds import segment_ends
from gsplat_tpu_torch.render.raster import KEY_INVALID
from torch_port_fixtures import GAP_CASES, gap_row

N = 2048


def key_row(p, n_valid, seed, n=N):
    """(p,) sorted f32 keys: n_valid gids drawn with repeats from [0, n)
    (about a third of the gids get no row), then KEY_INVALID."""
    rng = np.random.default_rng(seed)
    gids = np.sort(rng.integers(0, n, size=n_valid) // 3 * 3)
    keys = np.full(p, KEY_INVALID, np.float32)
    keys[:n_valid] = gids
    return keys


@pytest.mark.parametrize("p,n_valid,seed", [
    (1024, 900, 0),     # KEY_INVALID tail, gids with no rows
    (4096, 4096, 1),    # every row valid, many repeats
    (256, 0, 2),        # all rows invalid
    (128, 5, 3),        # a few rows, most gids empty
])
def test_segment_ends_matches_reference(p, n_valid, seed):
    keys = key_row(p, n_valid, seed)
    want = np.asarray(j_segment_ends(jnp.asarray(keys), N, interpret=True))
    got = segment_ends(torch.from_numpy(keys), N)
    assert got.dtype == torch.int32 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), want)
    if n_valid == 0:
        assert (got == 0).all()


def test_segment_ends_any_size():
    """No n % 1024 or P % 128 rule: ends[g] = #{keys < g + 1} at odd sizes."""
    keys = key_row(77, 60, 4, n=301)
    got = segment_ends(torch.from_numpy(keys), 301).numpy()
    want = np.array([(keys < g + 1).sum() for g in range(301)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", GAP_CASES)
def test_segment_ends_long_gaps_match_reference(case):
    keys = gap_row(case)
    n = 4096
    want = np.asarray(j_segment_ends(jnp.asarray(keys), n, interpret=True))
    got = segment_ends(torch.from_numpy(keys), n)
    np.testing.assert_array_equal(got.numpy(), want)
    gaps = np.diff(np.concatenate([[0], got.numpy()]))
    assert (gaps == 0).sum() > 1000
