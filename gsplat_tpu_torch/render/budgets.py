"""The render's budgets, decided in one place.

Four budgets size every buffer after the pair expansion (render's keywords
of the same names): pair, the expansion's slots; kept, the post-sort stages,
sized by the tight cull's survivors (None: unsplit); contrib, the backward's
d-table, sized by the pairs composited before each tile's exit (None: the
worst case); sat, the saturation bound cull's packed survivors (None: the
cull off). Here: their start sizes, render's rounding, the training loop's
`BudgetPolicy` and the tools' probe fits. A mesh is any object with the
fields pair_budget, chunk_size, kept_frac, contrib_frac and sat_frac.
"""

from __future__ import annotations

from typing import List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.render.binning import bin_gaussians, out_budget
from gsplat_tpu_torch.render.project import project_gaussians

CONTRIB_UNIT = 512     # the contrib fits' unit of rows
STREAK = 20            # low checks in a row before a shrink or an AUTO fit
KEPT_REGROW = 1.2      # a regrown kept budget's headroom over the demand it saw
FIT_HEADROOM = 1.5     # an AUTO fit's headroom over its counts


def ceil_to(x, unit: int) -> int:
    """int(x) rounded up to a multiple of unit."""
    return -(-int(x) // unit) * unit


def chunk_fit(n, chunk: int) -> int:
    """A count rounded up to a chunk, plus a chunk."""
    return ceil_to(n, chunk) + chunk


class Budgets(NamedTuple):
    pair: int
    kept: Optional[int] = None      # None: unsplit
    contrib: Optional[int] = None   # None: the worst case
    sat: Optional[int] = None       # None: the saturation cull off

    def kwargs(self) -> dict:
        """render's (and make_train_step's) budget keywords."""
        return dict(pair_budget=self.pair, kept_budget=self.kept,
                    contrib_budget=self.contrib, sat_budget=self.sat)


def kept_budget0(mesh, pair: int) -> Optional[int]:
    """kept_frac in (0, 1) sizes the post-sort stages as a fraction of the
    pair budget; AUTO (< 0, the default) and 1 start unsplit (None)."""
    if mesh.kept_frac >= 1.0 or mesh.kept_frac < 0:
        return None
    return max(int(pair * mesh.kept_frac), mesh.chunk_size)


def sat_budget0(mesh, pair: int) -> Optional[int]:
    """sat_frac > 0 turns the saturation bound cull on, its survivors sized
    as that fraction of the pair budget; AUTO (< 0, the default) and 0
    start with it off (None)."""
    if mesh.sat_frac <= 0.0:
        return None
    return max(int(pair * mesh.sat_frac), mesh.chunk_size)


def contrib_budget0(mesh, pair: int) -> Optional[int]:
    """contrib_frac in (0, 1) sizes the backward d-table as a fraction of the
    pair budget; AUTO and 1 start at the worst case (None)."""
    if mesh.contrib_frac >= 1.0 or mesh.contrib_frac < 0:
        return None
    return max(int(pair * mesh.contrib_frac), CONTRIB_UNIT)


def resolve(mesh, pair: Optional[int] = None, kept: Optional[int] = None,
            contrib: Optional[int] = None, sat: Optional[int] = None) -> Budgets:
    """A train step's budgets: each given one as given, else its start size
    at the pair budget (mesh.pair_budget unless given)."""
    pair = mesh.pair_budget if pair is None else pair
    return Budgets(pair, kept_budget0(mesh, pair) if kept is None else kept,
                   contrib_budget0(mesh, pair) if contrib is None else contrib,
                   sat_budget0(mesh, pair) if sat is None else sat)


def for_render(b: Budgets, chunk: int, num_tiles: int) -> Budgets:
    """The sizes a render allocates: each budget rounded up to whole chunks,
    kept (the pair budget when unsplit) and sat at most the pair budget,
    contrib when None the d-table of the kept pairs that cannot overflow."""
    pair = ceil_to(b.pair, chunk)
    kept = min(ceil_to(pair if b.kept is None else b.kept, chunk), pair)
    contrib = ceil_to(out_budget(kept, num_tiles, chunk) if b.contrib is None else b.contrib,
                      chunk)
    sat = None if b.sat is None else min(ceil_to(b.sat, chunk), pair)
    return Budgets(pair, kept, contrib, sat)


def _resumed(start: Optional[int], saved, auto: bool) -> Optional[int]:
    """A fixed start grown to the checkpoint's budget, an AUTO one the
    checkpoint's (fitted, or the cull enabled, before it), an off one off."""
    if saved is None or (start is None and not auto):
        return start
    return int(saved) if start is None else max(start, int(saved))


class BudgetPolicy:
    """The training loop's adaptive budgets (the reference's train()), from
    the mesh and the checkpoint's extras (a resume keeps the grown budgets).
    A budget regrows on overflow and shrinks after STREAK low checks; in
    AUTO mode (a fraction < 0) kept and contrib are fitted from the
    counters, and the saturation cull is off until `sat_probe` finds it
    would halve the kept pairs. Each method returns one line a budget it
    changed; the caller then rebuilds its step at `budgets`."""

    def __init__(self, mesh, extras: Optional[Mapping] = None):
        extras = extras or {}
        self.mesh, self.chunk = mesh, mesh.chunk_size
        self.kept_auto = mesh.kept_frac < 0.0
        self.contrib_auto = mesh.contrib_frac < 0.0
        self.sat_auto = mesh.sat_frac < 0.0
        self.pair = pair = max(mesh.pair_budget, int(extras.get("pair_budget", 0)))
        self.kept = _resumed(kept_budget0(mesh, pair), extras.get("kept_budget"),
                             self.kept_auto)
        self.contrib = _resumed(contrib_budget0(mesh, pair), extras.get("contrib_budget"),
                                self.contrib_auto)
        self.sat = _resumed(sat_budget0(mesh, pair), extras.get("sat_budget"), self.sat_auto)
        # checks in a row below a budget's shrink or fit line; the checkpoint
        # keeps the pair budget's ("low_usage_streak")
        self.low = {"usage": int(extras.get("low_usage_streak", 0)), "contrib": 0, "sat": 0,
                    "kept": 0}

    @property
    def budgets(self) -> Budgets:
        return Budgets(self.pair, self.kept, self.contrib, self.sat)

    def _streak(self, key: str, low: bool) -> bool:
        """One more low check of `key` (a check that is not low ends its
        streak) -> whether the streak reached STREAK; it then starts again."""
        n = self.low[key] + 1 if low else 0
        self.low[key] = 0 if n >= STREAK else n
        return n >= STREAK

    def check(self, iteration: int, n_pairs: int, n_dropped: int, n_culled: int,
              n_contrib: int, n_sat: int) -> List[str]:
        """A step's counters (host ints) -> the lines of the budgets changed:
        the first overflow rule that matches, else the pair shrink, else the
        contrib, sat and kept shrinks and fits."""
        chunk, at = self.chunk, f"[iter {iteration}]"
        if self.sat is not None and n_sat > self.sat:
            # sat overflow zeroed this step's gradients (and truncated the
            # image); regrow first: its excess also lands in n_dropped, so a
            # premature pair-budget doubling must not fire on it
            self.sat = max(self.sat * 2, ceil_to(n_sat, chunk))
            self.low["sat"] = 0
            return [f"{at} sat budget -> {self.sat} ({n_sat} survivor slots; recompiling)"]
        if self.kept is not None and n_dropped > 0 and n_pairs < self.pair:
            # the expansion fit, so the drop is a kept-budget overflow: regrow
            # to the observed demand (kept + dropped) with headroom
            self.kept = min(self.pair, max(self.kept * 2,
                                           ceil_to((self.kept + n_dropped) * KEPT_REGROW, chunk)))
            self.low["kept"] = 0
            return [f"{at} kept budget -> {self.kept} "
                    f"({n_dropped} kept pairs dropped; recompiling)"]
        if n_dropped > 0:
            self.pair *= 2
            if self.contrib is not None:
                self.contrib *= 2
            self.low["usage"] = 0
            return [f"{at} pair budget {self.pair // 2} -> {self.pair} "
                    f"({n_dropped} pairs dropped; recompiling)"]
        if self.contrib is not None and n_contrib > self.contrib:
            # contrib overflow zeroed this step's gradients (the image is exact)
            self.contrib = max(self.contrib * 2, ceil_to(n_contrib, CONTRIB_UNIT))
            self.low["contrib"] = 0
            return [f"{at} contrib budget -> {self.contrib} "
                    f"({n_contrib} compacted rows; recompiling)"]
        if n_pairs * 4 < self.pair and self.pair > self.mesh.pair_budget:
            if not self._streak("usage", True):
                return []
            self.pair //= 2
            return [f"{at} pair budget shrink -> {self.pair}"]
        self.low["usage"] = 0
        lines = []
        shrink = (self.contrib is not None and n_contrib * 4 < self.contrib
                  and self.contrib > (contrib_budget0(self.mesh, self.pair) or CONTRIB_UNIT))
        # AUTO contrib: bootstrap the backward's compaction once the
        # composited pairs are provably far below the worst case
        fit = (self.contrib_auto and self.contrib is None
               and n_contrib * 2 < (self.kept or self.pair))
        if self._streak("contrib", shrink or fit):
            if shrink:
                self.contrib //= 2
                lines.append(f"{at} contrib budget shrink -> {self.contrib}")
            else:
                self.contrib = max(ceil_to(n_contrib * FIT_HEADROOM, CONTRIB_UNIT),
                                   CONTRIB_UNIT)
                lines.append(f"{at} contrib budget fit -> {self.contrib} "
                             f"({n_contrib} composited rows; recompiling)")
        if self._streak("sat", self.sat is not None and n_sat * 4 < self.sat
                        and self.sat > (sat_budget0(self.mesh, self.pair) or chunk)):
            self.sat //= 2
            lines.append(f"{at} sat budget shrink -> {self.sat}")
        # AUTO kept: bootstrap, or refit, the post-sort split from the kept pairs
        fitted_kept = max(n_pairs - n_culled, 0)
        kept_target = ceil_to(fitted_kept * FIT_HEADROOM + chunk, chunk)
        if self._streak("kept", self.kept_auto and kept_target * 2 < (self.kept or self.pair)):
            self.kept = max(kept_target, chunk)
            lines.append(f"{at} kept budget fit -> {self.kept} "
                         f"(kept {fitted_kept} of {n_pairs} pairs; recompiling)")
        return lines

    def probes_sat(self, capacity: int) -> bool:
        """Whether the AUTO saturation cull is off and within its guards: its
        int32 quanta prefix sum is exact below 2^25 kept pairs, and its key
        packing needs gids below 2^24."""
        return (self.sat_auto and self.sat is None and self.pair < (1 << 25)
                and capacity < (1 << 24))

    def sat_probe(self, iteration: int, n_sat: int, n_pairs: int, n_culled: int,
                  n_dropped: int) -> List[str]:
        """loop._sat_probe's counts (host ints) -> the AUTO enable's line where
        the cull would cut the kept pairs at least in half (it is
        bit-identical: enabling it mid-run changes only the step's time)."""
        kept_live = n_pairs - n_culled
        if n_dropped != 0 or 2 * n_sat >= kept_live:
            return []
        self.sat = chunk_fit(n_sat, self.chunk)
        self.low["sat"] = 0
        return [f"[iter {iteration}] saturation cull AUTO-ENABLED: {n_sat} survivor slots "
                f"of {kept_live} kept pairs (sat budget {self.sat}; recompiling)"]

    def extras(self) -> dict:
        """The checkpoint's budget extras (int64 scalars): pair_budget, the
        contrib, kept and sat budgets that are set, low_usage_streak."""
        out = {"pair_budget": np.asarray(self.pair, np.int64)}
        for key, v in (("contrib_budget", self.contrib), ("kept_budget", self.kept),
                       ("sat_budget", self.sat)):
            if v is not None:
                out[key] = np.asarray(v, np.int64)
        out["low_usage_streak"] = np.asarray(self.low["usage"], np.int64)
        return out


def probe_pairs(g, cam, pair_budget: int, *, tile_size: int, chunk: int) -> Tuple[int, int]:
    """The reference's probe binning (bench.py, scripts/serving_bench.py): the
    view at pair_budget with kept_budget = pair_budget - chunk, which turns
    the tight cull on -> (n_pairs, n_culled)."""
    with torch.no_grad():
        p = project_gaussians(g, cam)
        b = bin_gaussians(p.mean2d, p.radius, p.depth, width=cam.width, height=cam.height,
                          tile_size=tile_size, chunk=chunk, pair_budget=pair_budget,
                          cull_conic=p.conic, cull_opacity=p.opacity,
                          kept_budget=pair_budget - chunk)
        return int(b.n_pairs), int(b.n_culled)


def fit_pair(n_pairs: int, pair_budget: int, chunk: int) -> int:
    """tools/serving_bench.py's and chip_smoke.py's pair budget: chunk_fit of
    the pairs, at most the probe's budget."""
    return min(chunk_fit(n_pairs, chunk), pair_budget)


def fit_pair_bench(n_pairs: int, pair_budget: int, chunk: int) -> int:
    """tools/bench.py's (bench.py:237-241): chunk_fit of the pairs, which may
    pass the probe's budget; a probe that filled its budget keeps it."""
    return pair_budget if n_pairs >= pair_budget else chunk_fit(n_pairs, chunk)


def fit_kept(n_pairs: int, n_culled: int, chunk: int) -> int:
    """The pairs the tight cull keeps, plus a chunk, rounded up to a chunk."""
    return ceil_to(n_pairs - n_culled + chunk, chunk)


def fit_contrib(n_contrib: int) -> int:
    """bench.py:241: the composited rows rounded up to 512, plus 512."""
    return ceil_to(n_contrib, CONTRIB_UNIT) + CONTRIB_UNIT


def fit_sat(n_sat: int, n_kept: int, chunk: int) -> Optional[int]:
    """tools/serving_bench.py's: chunk_fit of the survivors where they are
    under half the kept pairs (the training loop's AUTO rule), else None."""
    return chunk_fit(n_sat, chunk) if 2 * n_sat < n_kept else None


def fit_sat_bench(n_sat: int, n_dropped: int, kept: int, chunk: int) -> Optional[int]:
    """tools/bench.py's (bench.py:284-285): chunk_fit of the survivors, or
    None where the probe dropped pairs or they are not a chunk short of kept."""
    if n_dropped != 0 or n_sat + chunk >= kept:
        return None
    return chunk_fit(n_sat, chunk)


def with_headroom(pair: int, kept: int, contrib: int, pair_budget: int,
                  chunk: int) -> Tuple[int, int, int]:
    """chip_smoke.py's train budgets: fitted budgets with the training loop's
    headroom (KEPT_REGROW on pair and kept, FIT_HEADROOM on contrib), pair
    at most pair_budget, kept at most pair."""
    pair = min(pair_budget, ceil_to(pair * KEPT_REGROW, chunk))
    return (pair, min(pair, ceil_to(kept * KEPT_REGROW, chunk)),
            ceil_to(contrib * FIT_HEADROOM, CONTRIB_UNIT))
