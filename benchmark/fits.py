"""Budget fits: frozen copies of the port's integer arithmetic.

`fit_pairs` is `tools/bench.py::fit_budgets`'s pair and kept fit (bench.py's
own, as `tools/serving_bench.py::fit_budgets` and `chip_smoke.py::
fit_budgets` repeat it), `fit_contrib` its contrib fit (`chip_smoke.py::
fit_contrib`), `fit_sat` the saturation cull's budget (`tools/serving_bench.
py::fit_budgets`'s rule: on where the survivors are under half the kept
pairs, as the training loop's AUTO rule enables it), and `with_headroom`
`chip_smoke.py::train_budgets`' slack over a fitted budget (the training
loop's regrowth factors). Copied so that a later change to the port cannot
move the budgets the benchmark runs at.
"""

from __future__ import annotations

from typing import Dict, Optional


# the saturation cull's prefix sum takes fewer than 2^25 kept pairs (the
# training loop probes the cull only below it)
SAT_KEPT_LIMIT = 1 << 25


def ceil_to(x: float, unit: int) -> int:
    return -(-int(x) // unit) * unit


def fit_pairs(n_pairs: int, n_kept: int, pair_budget: int, chunk: int):
    """-> (pair budget, kept budget): the most pairs rounded up to a chunk
    plus a chunk (capped at the configured budget), and the most pairs the
    tight cull keeps plus a chunk, rounded up to a chunk."""
    return (min(ceil_to(n_pairs, chunk) + chunk, pair_budget),
            ceil_to(n_kept + chunk, chunk))


def fit_contrib(n_contrib: int) -> int:
    """The composited rows rounded up to 512, plus 512."""
    return ceil_to(n_contrib, 512) + 512


def fit_sat(n_sat: int, n_kept: int, chunk: int) -> Optional[int]:
    """The saturation cull's budget (its survivor rows rounded up to a chunk
    plus a chunk), or None where it would not cut the kept pairs in half."""
    if 2 * n_sat >= n_kept:
        return None
    return ceil_to(n_sat, chunk) + chunk


def with_headroom(budgets: Dict[str, Optional[int]], slack: Dict[str, float],
                  chunk: int) -> Dict[str, Optional[int]]:
    """The fitted budgets times the traffic's slack: pair and kept rounded up
    to a chunk (kept no larger than pair, pair no larger than configured),
    contrib to 512, sat to a chunk."""
    pair = min(budgets["configured"], ceil_to(budgets["pair"] * slack["pair"], chunk))
    out = {"pair": pair,
           "kept": min(pair, ceil_to(budgets["kept"] * slack["kept"], chunk)),
           "contrib": ceil_to(budgets["contrib"] * slack["contrib"], 512),
           "sat": None}
    if budgets["sat"] is not None:
        out["kept"] = min(out["kept"], SAT_KEPT_LIMIT - chunk)
        out["sat"] = min(out["kept"], ceil_to(budgets["sat"] * slack["sat"], chunk))
    return out
