"""Port parity, K5: gsplat_tpu_torch.render.scan.prefix_sum_small's plain
version (what a CPU tensor takes) against the JAX package's Pallas kernel
gsplat_tpu.render.scan_pallas.prefix_sum_small in interpret mode, on
tests/test_scan_pallas.py's inputs and with a bias and a clip: int32 sums,
so bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.render.scan_pallas import prefix_sum_small as j_prefix_sum_small
from gsplat_tpu_torch.render import scan

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,n,hi,bias,clip_hi", [
    (0, 128 * 64, 1, 0, None), (1, 128 * 64 * 3, 63, 0, None),
    (2, 128 * 130, 255, 0, None),
    # the kernel path of the reference (n a multiple of 128, >= 8192) with
    # its static bias and clip inside the kernel
    (3, 128 * 64, 63, -40, 100_000),
    # its jnp.cumsum fallback (tests/test_scan_pallas.py's small case)
    (4, 5, 1, -1, 1),
])
def test_prefix_sum_small_matches_pallas(seed, n, hi, bias, clip_hi):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, hi + 1, n).astype(np.int32)
    want = np.asarray(j_prefix_sum_small(jnp.asarray(x), bias=bias, clip_hi=clip_hi,
                                         interpret=True))
    got = scan.prefix_sum_small(torch.from_numpy(x), bias=bias, clip_hi=clip_hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.cumsum(x.astype(np.int64)) + bias
    if clip_hi is not None:
        ref = np.clip(ref, 0, clip_hi)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_prefix_sum_small_refuses_lengths_past_2_pow_25():
    """63 * 2^25 < 2^31: a longer sum of 6-bit quanta could pass int32."""
    x = torch.zeros(1, dtype=torch.int32).expand(scan.MAX_LEN)   # no memory
    with pytest.raises(ValueError, match="2\\^25"):
        scan.prefix_sum_small(x)
