"""The render's budgets (gsplat_tpu_torch/render/budgets.py) on plain ints: no
render, no JAX.

- `BudgetPolicy`, the training loop's adaptive rules: one case for each rule
  of the check (sat regrowth, kept regrowth, the pair doubling with the
  contrib budget doubled, contrib regrowth, the pair shrink after 20 low
  checks, the contrib shrink, the AUTO contrib and kept fits, the sat
  shrink) and the saturation cull's AUTO enable, refused and accepted; the
  resume merge in fixed, AUTO and off modes, from a fresh start and from a
  checkpoint's extras; the extras' round trip. Every expected budget, streak
  and line was computed by the training loop's own code before it moved
  here (gsplat_tpu_torch/train/loop.py::train at the commit that held the
  rules inline, run on these counters), so the move changed no decision.
- `for_render`, render_projected's chunk rounding and caps.
- the tools' probe fits: tools/bench.py's (cases worked by hand from
  bench.py's formulas) and tools/serving_bench.py's.
"""

import numpy as np
import pytest

from gsplat_tpu_torch.config import MeshParams
from gsplat_tpu_torch.render import budgets

OFF = dict(kept_frac=1.0, contrib_frac=1.0, sat_frac=0.0)

# case -> (mesh fractions, extras, the counters of every check (n_pairs,
# n_dropped, n_culled, n_contrib, n_sat), checks, the budgets after (pair,
# kept, contrib, sat), the lines); pair budget 4096, chunk 128, one check
# every 10 iterations
CHECKS = {
    "sat_regrow": (dict(OFF, sat_frac=0.25), {}, (3000, 900, 100, 2000, 1500), 1,
                   (4096, None, None, 2048),
                   ["[iter 10] sat budget -> 2048 (1500 survivor slots; recompiling)"]),
    "kept_regrow": (dict(OFF, kept_frac=0.25), {}, (3000, 700, 100, 2000, 0), 1,
                    (4096, 2176, None, None),
                    ["[iter 10] kept budget -> 2176 (700 kept pairs dropped; recompiling)"]),
    "pair_double": (dict(OFF, contrib_frac=0.25), {}, (4096, 300, 0, 500, 0), 1,
                    (8192, None, 2048, None),
                    ["[iter 10] pair budget 4096 -> 8192 (300 pairs dropped; recompiling)"]),
    "contrib_regrow": (dict(OFF, contrib_frac=0.25), {}, (3000, 0, 100, 1500, 0), 1,
                       (4096, None, 2048, None),
                       ["[iter 10] contrib budget -> 2048 (1500 compacted rows; recompiling)"]),
    "pair_shrink": (dict(OFF), {"pair_budget": 16384}, (1000, 0, 100, 800, 0), 20,
                    (8192, None, None, None), ["[iter 200] pair budget shrink -> 8192"]),
    "contrib_shrink": (dict(OFF, contrib_frac=0.25), {"contrib_budget": 8192},
                       (3000, 0, 100, 900, 0), 20, (4096, None, 4096, None),
                       ["[iter 200] contrib budget shrink -> 4096"]),
    "contrib_fit": (dict(OFF, contrib_frac=-1.0), {}, (3000, 0, 100, 1000, 0), 20,
                    (4096, None, 1536, None),
                    ["[iter 200] contrib budget fit -> 1536 (1000 composited rows; "
                     "recompiling)"]),
    "sat_shrink": (dict(OFF, sat_frac=0.125), {"sat_budget": 4096}, (3000, 0, 100, 800, 700),
                   20, (4096, None, None, 2048), ["[iter 200] sat budget shrink -> 2048"]),
    "kept_fit": (dict(OFF, kept_frac=-1.0), {}, (2000, 0, 1500, 900, 0), 20,
                 (4096, 896, None, None),
                 ["[iter 200] kept budget fit -> 896 (kept 500 of 2000 pairs; recompiling)"]),
}
# case -> (the probe's counts (n_sat, n_pairs, n_culled, n_dropped), the
# budgets after, the lines); AUTO mode, a probe at iteration 500
PROBES = {
    "sat_enable_refused": ((1300, 3000, 500, 0), (4096, None, None, None), []),
    "sat_enable": ((1000, 3000, 200, 0), (4096, None, None, 1152),
                   ["[iter 500] saturation cull AUTO-ENABLED: 1000 survivor slots of 2800 "
                    "kept pairs (sat budget 1152; recompiling)"]),
}


def mesh(**fields):
    return MeshParams(pair_budget=4096, chunk_size=128, **fields)


@pytest.mark.parametrize("case", list(CHECKS) + list(PROBES))
def test_policy_rules(case):
    """Each rule of the adaptive budgets: the budgets after the checks, and
    the one line printed, on the last of them."""
    if case in CHECKS:
        fields, extras, counts, n, want, lines = CHECKS[case]
        policy = budgets.BudgetPolicy(mesh(**fields), extras)
        got = [policy.check(10 * (i + 1), *counts) for i in range(n)]
        assert got == [[]] * (n - 1) + [lines]
    else:
        counts, want, lines = PROBES[case]
        policy = budgets.BudgetPolicy(mesh(), {})
        assert policy.probes_sat(capacity=64)
        assert policy.sat_probe(500, *counts) == lines
        assert policy.probes_sat(capacity=64) == (not lines)   # off until enabled
    assert tuple(policy.budgets) == want


MODES = {"fixed": dict(kept_frac=0.25, contrib_frac=0.25, sat_frac=0.25),
         "auto": dict(kept_frac=-1.0, contrib_frac=-1.0, sat_frac=-1.0),
         "off": OFF}
SAVED = {"pair_budget": 8192, "kept_budget": 3000, "contrib_budget": 5000, "sat_budget": 1000,
         "low_usage_streak": 7}
# (mode, resumed) -> (pair, kept, contrib, sat, low_usage_streak)
MERGED = {
    ("fixed", False): (4096, 1024, 1024, 1024, 0),
    ("fixed", True): (8192, 3000, 5000, 2048, 7),
    ("auto", False): (4096, None, None, None, 0),
    ("auto", True): (8192, 3000, 5000, 1000, 7),
    ("off", False): (4096, None, None, None, 0),
    ("off", True): (8192, None, None, None, 7),
}


@pytest.mark.parametrize("mode,resumed", list(MERGED), ids=[f"{m}-{'resumed' if r else 'fresh'}"
                                                            for m, r in MERGED])
def test_resume_merge(mode, resumed):
    """The start budgets: a fixed fraction's grown to the checkpoint's, an
    AUTO one the checkpoint's, an off one off; the pair budget the larger."""
    extras = {k: np.asarray(v, np.int64) for k, v in SAVED.items()} if resumed else {}
    policy = budgets.BudgetPolicy(mesh(**MODES[mode]), extras)
    assert (*policy.budgets, policy.low["usage"]) == MERGED[(mode, resumed)]


def test_checkpoint_extras_round_trip():
    """The extras the loop checkpoints: the keys and order of its budget
    extras, each an int64 scalar, a budget that is None left out; a policy
    built from them resumes the same budgets and streak."""
    for mode, fields in MODES.items():
        extras = {k: np.asarray(v, np.int64) for k, v in SAVED.items()}
        policy = budgets.BudgetPolicy(mesh(**fields), extras)
        policy.check(10, 1000, 0, 100, 100, 0)     # a low check: the streak moves
        out = policy.extras()
        keys = ["pair_budget", "contrib_budget", "kept_budget", "sat_budget"]
        want = [k for k, v in zip(keys, (1, policy.contrib, policy.kept, policy.sat))
                if v is not None]
        assert list(out) == want + ["low_usage_streak"], mode
        assert all(v.dtype == np.int64 and v.shape == () for v in out.values())
        again = budgets.BudgetPolicy(mesh(**fields), out)
        assert again.budgets == policy.budgets and again.low["usage"] == policy.low["usage"] == 8
        assert {k: int(v) for k, v in again.extras().items()} == \
            {k: int(v) for k, v in out.items()}


# (budgets given, chunk, tiles) -> the sizes render_projected allocates
RENDER_CASES = [
    ((1000, None, None, None), 128, 6, (1024, 1024, 1024 + 2 * 128 * 6, None)),
    ((4096, 5000, 700, 5000), 128, 6, (4096, 4096, 768, 4096)),
    ((4096, 1000, None, 100), 32, 1, (4096, 1024, 1024 + 64, 128)),
]


@pytest.mark.parametrize("given,chunk,tiles,want", RENDER_CASES)
def test_for_render_rounds_and_caps(given, chunk, tiles, want):
    assert tuple(budgets.for_render(budgets.Budgets(*given), chunk, tiles)) == want


def test_resolve_takes_given_budgets_and_start_rules():
    fixed = mesh(**MODES["fixed"])
    assert budgets.resolve(fixed) == (4096, 1024, 1024, 1024)
    assert budgets.resolve(fixed, 1024, contrib=100) == (1024, 256, 100, 256)
    assert budgets.resolve(mesh(**OFF), kept=512).kwargs() == dict(
        pair_budget=4096, kept_budget=512, contrib_budget=None, sat_budget=None)


# (pairs, culled, contrib, pair budget, chunk) -> (pair budget, kept, contrib),
# each worked from bench.py:237-241 by hand
FIT_CASES = [
    # the sparse scene's counts in BENCH_r05.json: 2,105,855 pairs = 16,451
    # chunks + 127 -> 16,452 chunks + 1; 1,917,886 + 128 kept -> 14,985
    # chunks; 1,606,016 contrib = 3,136.75 x 512 -> 3,137 x 512 + 512
    ((2_105_855, 187_969, 1_606_016, 5 << 19, 128), (2_105_984, 1_918_080, 1_606_656)),
    # a whole number of chunks still gains one; contrib a multiple of 512 too
    ((1024, 0, 512, 4096, 128), (1152, 1152, 1024)),
    # the plain pass filled its budget: the pair budget stays
    ((4096, 100, 1000, 4096, 128), (4096, 4224, 1536)),
    # one pair short of the budget: rounded up, past it
    ((4095, 95, 1, 4096, 128), (4224, 4224, 1024)),
    ((300, 299, 0, 1 << 14, 32), (352, 64, 512)),
]
# (n_sat, n_dropped, kept, chunk) -> sat budget or None (bench.py:284-285)
SAT_CASES = [
    ((2_176_896, 0, 1_918_080, 128), None),    # the sparse scene: more survivors than kept
    ((1_823_232, 0, 25_948_160, 128), 1_823_360),   # 14,244 chunks exactly, plus one
    ((1000, 0, 1128, 128), None),              # n_sat + chunk == kept
    ((999, 0, 1128, 128), 1152),               # one row less: the pass runs
    ((10, 3, 4096, 128), None),                # the probe dropped pairs
    ((0, 0, 4096, 32), 32),
]


@pytest.mark.parametrize("args, want", FIT_CASES)
def test_fit_budgets(args, want):
    n_pairs, n_culled, n_contrib, pair_budget, chunk = args
    assert (budgets.fit_pair_bench(n_pairs, pair_budget, chunk),
            budgets.fit_kept(n_pairs, n_culled, chunk), budgets.fit_contrib(n_contrib)) == want


@pytest.mark.parametrize("args, want", SAT_CASES)
def test_fit_sat(args, want):
    assert budgets.fit_sat_bench(*args) == want


# (pairs, pair budget, chunk, survivors, kept pairs) -> (pair budget, sat
# budget or None): tools/serving_bench.py's rules
SERVING_CASES = [
    ((2_105_855, 5 << 19, 128, 2_176_896, 1_917_886), (2_105_984, None)),
    ((4095, 4096, 128, 999, 2000), (4096, 1152)),     # capped at the probe's budget
    ((100, 4096, 32, 50, 100), (160, None)),          # half the kept pairs: off
]


@pytest.mark.parametrize("args, want", SERVING_CASES)
def test_fit_serving(args, want):
    n_pairs, pair_budget, chunk, n_sat, n_kept = args
    assert (budgets.fit_pair(n_pairs, pair_budget, chunk),
            budgets.fit_sat(n_sat, n_kept, chunk)) == want
