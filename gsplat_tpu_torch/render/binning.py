"""Tile binning: (Gaussian, tile) pair expansion, tight tile cull, pair sort,
per-tile segments over a fixed pair budget, and the saturation bound cull.

Port of gsplat_tpu/render/binning.py::bin_gaussians. Steps:

1. Per-Gaussian tile rectangles (upstream getRect) -> pair counts.
2. A live-compacted per-Gaussian column table (live rows first, each with its
   exclusive pair offset) and ONE pass over the `pair_budget` slots that
   finds each slot's owning row, decomposes the rectangle into its tile,
   applies the tight cull and packs the (tile, depth) sort key: the
   `expand_pairs` kernel (render/expand.py). Culled and invalid slots carry
   the invalid key and the null gid N. Under the saturation bound cull each
   gid carries its 6-bit saturation quantum q in its low bits (gid << 6 | q,
   null N << 6), so q rides the sort.
3. One sort of the int64 (key << 32 | gid): the reference's two-key
   `lax.sort((key, gid), num_keys=2)`, gid breaking (tile, depth) ties.
4. Per-tile segments [tile_start, +tile_count) on the sorted keys, clamped
   to `kept_budget`: the sort moves culled/invalid pairs to the tail, so the
   kept prefix is exactly what the compositor reads.
5. With `sat_budget`, the saturation bound cull (`saturation_cull`): the
   running sum of q over the kept prefix (the `prefix_sum_small` kernel,
   render/scan.py) lower-bounds -log2(T) of every pixel of a tile, so each
   tile is cut at the first chunk boundary where it proves the compositor's
   whole-tile exit; the surviving chunk-aligned runs are packed into
   `sat_budget` rows (the `compact_runs` kernel, render/compact.py) with each
   tile's head offset kept, so every chunk the compositor sweeps holds the
   same rows: image, nproc and gradients are bit-identical.

The reference's `_rect_min_Q`, `_rect_max_Q`, `_sat_q` and `_expand_xla`
arithmetic live beside the kernel, in render/expand.py, as `rect_min_q`,
`rect_max_q`, `sat_q` and the kernel's plain version `expand_pairs_plain`;
`_expand_fused`'s table preparation is `expansion_table` below.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from gsplat_tpu_torch import spans
from gsplat_tpu_torch.render import compact, expand, scan


class Binning(NamedTuple):
    gid_s: torch.Tensor       # (pair_budget | sat_budget,) int32 sorted Gaussian
    #                           ids (sat cull: the packed survivors); N when empty
    tile_start: torch.Tensor  # (num_tiles,) int32 unaligned pair offset per tile
    tile_count: torch.Tensor  # (num_tiles,) int32 kept pairs per tile
    n_pairs: torch.Tensor     # () int32 expansion slots used (budget telemetry)
    n_dropped: torch.Tensor   # () int32 pairs dropped by pair/kept/sat budget overflow
    n_culled: torch.Tensor    # () int32 rect pairs removed by the tight tile cull
    n_sat: torch.Tensor       # () int32 rows the saturation bound cull's regions
    #                           need (0 with the cull off): what sizes sat_budget
    grad_ok: torch.Tensor     # () bool: False on kept- or sat-budget overflow


def tile_grid(width: int, height: int, tile_size: int) -> Tuple[int, int]:
    return -(-width // tile_size), -(-height // tile_size)


def depth_shift(num_tiles: int) -> int:
    """Bits of quantized depth in the packed non-negative int32
    (tile << db | dq) key: the top db bits of a positive f32's bit pattern
    order like the float itself."""
    tile_bits = max(1, (num_tiles + 1).bit_length())
    db = 31 - tile_bits
    if db < 8:
        raise ValueError(f"too many tiles ({num_tiles}) for a packed int32 sort key")
    return db


def depth_bits(depth: torch.Tensor, db: int) -> torch.Tensor:
    """f32 depth -> its top `db` bits (logical shift of the f32 bit pattern),
    clamped to db bits: negative depths and +inf land on the largest value."""
    bits = depth.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    dq = (bits & 0xFFFFFFFF) >> (32 - db)
    return torch.clamp(dq, max=(1 << db) - 1).to(torch.int32)


def pack_sort_key(tile: torch.Tensor, depth: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """(P,) int32 tile ids + (P,) f32 depths -> the packed int32 sort key
    tile << db | depth_bits: the key expand_pairs writes (the table carries
    depth_bits per Gaussian, the kernel ORs in the tile)."""
    db = depth_shift(num_tiles)
    return (tile.to(torch.int32) << db) | depth_bits(depth, db)


def out_budget(pair_budget: int, num_tiles: int, chunk: int) -> int:
    """Rows of the backward's d-table: each tile's chunk-aligned region can
    exceed its pair count by a head and a tail of less than a chunk each."""
    return pair_budget + 2 * chunk * num_tiles


def tile_rects(mean2d: torch.Tensor, radius: torch.Tensor, tw: int, th: int,
               tile_size: int):
    """Upstream getRect semantics: clamped [min, max) tile rectangle per Gaussian."""
    mx, my = mean2d[:, 0], mean2d[:, 1]
    x0 = torch.clamp(((mx - radius) / tile_size).to(torch.int32), 0, tw)
    y0 = torch.clamp(((my - radius) / tile_size).to(torch.int32), 0, th)
    x1 = torch.clamp(((mx + radius + tile_size - 1) // tile_size).to(torch.int32), 0, tw)
    y1 = torch.clamp(((my + radius + tile_size - 1) // tile_size).to(torch.int32), 0, th)
    return x0, y0, x1, y1


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def expansion_table(mean2d, radius, depth, cull_conic, cull_opacity, *,
                    tw: int, th: int, tile_size: int, db: int, do_cull: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile rectangles -> (table, total): the live-compacted per-Gaussian
    column table (5 or 11, n) int32, column-major, and the () int32 total
    pair count; the inputs of `expand.expand_pairs` (port of the table
    binning._expand_fused builds).

    Entries: live Gaussians first, in index order (a stable partition), then
    the dead ones. Columns (expand.COL_*): exclusive pair offset (strictly
    increasing over live entries; dead ones carry the live total, so the
    column is sorted for the kernel's binary search), x0 | y0 << 16,
    max(rect_w, 1), quantized depth, original gid, and with the cull the raw
    f32 bits of mean x/y, conic a/b/c and opacity."""
    x0, y0, x1, y1 = tile_rects(mean2d, radius, tw, th, tile_size)
    rect_w = torch.clamp(x1 - x0, min=0)
    rect_h = torch.clamp(y1 - y0, min=0)
    counts = torch.where(radius > 0, rect_w * rect_h, torch.zeros_like(rect_w))
    total = counts.sum(dtype=torch.int64).to(torch.int32)
    live = counts > 0
    order = torch.argsort((~live).to(torch.int8), stable=True)
    cols = [
        x0 | (y0 << 16),
        torch.clamp(rect_w, min=1),
        depth_bits(depth, db),
        torch.arange(counts.shape[0], dtype=torch.int32, device=counts.device),
    ]
    if do_cull:
        cols += [_f32_bits(mean2d[:, 0]), _f32_bits(mean2d[:, 1]),
                 _f32_bits(cull_conic[:, 0]), _f32_bits(cull_conic[:, 1]),
                 _f32_bits(cull_conic[:, 2]), _f32_bits(cull_opacity)]
    counts_l = counts[order]
    offs_l = torch.cumsum(counts_l, 0, dtype=torch.int64) - counts_l
    table = torch.stack([offs_l.to(torch.int32)] + [c[order] for c in cols], 0)
    return table, total


def sat_regions(C: torch.Tensor, starts: torch.Tensor, tile_count: torch.Tensor, *,
                chunk: int, sat_budget: int):
    """The saturation bound cull's per-tile cut and packed regions
    (binning.py:516-538 of the reference). C (kept,) int32 is the inclusive
    running sum of the sorted pairs' quanta; starts/tile_count the kept
    segments. Each tile is cut at the first chunk boundary (on the
    compositor's chunk grid) at or past its first pair whose running sum
    within the tile reaches SAT_CUT; its region is its chunk-aligned run from
    astart = starts rounded down to a chunk, packed in tile order at rbase.

    -> (astart, rbase, head, new_count, region, needed), the (T,) int32
    tables and () needed = the rows all regions take. On overflow (needed >
    sat_budget) rbase is clamped so each region starts inside the budget
    (regions may then overlap)."""
    c_prev = torch.where(starts > 0, C[torch.clamp(starts - 1, min=0)], 0)
    pos = torch.searchsorted(C, c_prev + expand.SAT_CUT, side="left").to(torch.int32)
    astart = starts // chunk * chunk
    head = starts - astart
    seg_end = starts + tile_count
    cut = torch.minimum(
        torch.where(pos < seg_end, astart + ((pos - astart) // chunk + 1) * chunk, seg_end),
        seg_end)
    new_count = torch.clamp(cut - starts, min=0)
    region = (head + new_count + chunk - 1) // chunk * chunk
    rend = torch.cumsum(region, 0, dtype=torch.int64)
    rbase = torch.minimum(rend - region, torch.clamp(sat_budget - region, min=0))
    return (astart, rbase.to(torch.int32), head, new_count, region.to(torch.int32),
            rend[-1].to(torch.int32))


def saturation_cull(gid_s: torch.Tensor, starts: torch.Tensor, tile_count: torch.Tensor,
                    *, chunk: int, kept_budget: int, sat_budget: int, gid_null: int):
    """Cut and pack the kept prefix of the sorted packed gids ->
    (gid_s (sat_budget,) int32 plain gids, tile_start, tile_count, needed).
    The prefix sum is K5, the copy K6; rows no region covers hold gid_null,
    which decodes to the null Gaussian N. On overflow the segments are
    clamped into [0, sat_budget]: the compositors read no row past the
    table (that step's content is garbage and its gradient zeroed)."""
    C = scan.prefix_sum_small(gid_s[:kept_budget] & ((1 << expand.SAT_Q_BITS) - 1))
    astart, rbase, head, new_count, region, needed = sat_regions(
        C, starts, tile_count, chunk=chunk, sat_budget=sat_budget)
    packed = compact.compact_runs(gid_s[:kept_budget], astart, rbase, region,
                                  sat_budget, gid_null)
    tile_start = torch.clamp(rbase + head, 0, sat_budget)
    tile_count = torch.clamp(torch.minimum(new_count, sat_budget - tile_start), min=0)
    return expand.unpack_gid(packed), tile_start.to(torch.int32), \
        tile_count.to(torch.int32), needed


def bin_gaussians(
    mean2d: torch.Tensor,
    radius: torch.Tensor,
    depth: torch.Tensor,
    *,
    width: int,
    height: int,
    tile_size: int,
    chunk: int,
    pair_budget: int,
    cull_conic: Optional[torch.Tensor] = None,
    cull_opacity: Optional[torch.Tensor] = None,
    kept_budget: Optional[int] = None,
    sat_budget: Optional[int] = None,
    key_tiles: Optional[int] = None,
    lead: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    on_stage: Optional[Callable[[str], None]] = None,
) -> Binning:
    """Build the sorted compact (Gaussian, tile) pair layout + per-tile tables.

    Inputs carry no gradient (binning is integer-valued). pair_budget must be
    a multiple of `chunk`. cull_conic (N,3) + cull_opacity (N,) enable the
    tight tile cull: rect pairs whose maximum alpha in the tile is provably
    below the compositing threshold (exact quadratic minimum over the tile
    box, 2% slack) are keyed invalid. As in the reference, the cull runs
    when pair_budget < 8*N, kept_budget < pair_budget, or with sat_budget.
    kept_budget (default pair_budget) sizes the post-sort stages; kept pairs
    beyond it are dropped and counted in n_dropped. sat_budget (a multiple
    of chunk; needs the cull inputs) turns on the saturation bound cull:
    gid_s then holds sat_budget rows, n_sat reports the rows the cull's
    regions need, and an overflow adds needed - sat_budget to n_dropped and
    clears grad_ok.

    key_tiles (default: this grid's tile count, at least it): the tile count
    whose key layout sets the depth bits of the sort key. A band of a frame
    passes the frame's tile count, so that its pairs sort in the frame's
    order (the band's own, finer, depth bits can break near-equal depths
    another way).

    lead(kept_total), if given, returns how many kept pairs the full frame
    sorts before this band's first tile (a () int tensor; the mesh step
    gathers it from the bands above). The sorted layout is then led by that
    many modulo `chunk` inert slots, so each tile's pairs lie on the full
    frame's chunk grid: the compositors sweep chunks of that grid and test
    the whole-tile exit at its boundaries, so a band composited on another
    grid can differ from the full render by up to T_EPS in a pixel. The
    lead slots count against kept_budget.

    on_stage(name), if given, is called after the expansion ("bin"), the
    sort ("sort") and the saturation cull ("sat") so a caller can time the
    stages."""
    if pair_budget % chunk:
        raise ValueError(f"pair_budget {pair_budget} is not a multiple of chunk {chunk}")
    if kept_budget is None:
        kept_budget = pair_budget
    kept_budget = min(kept_budget, pair_budget)
    n = mean2d.shape[0]
    dev = mean2d.device
    tw, th = tile_grid(width, height, tile_size)
    num_tiles = tw * th
    db = depth_shift(max(num_tiles, key_tiles or 0))
    do_sat = sat_budget is not None
    if do_sat:
        if cull_conic is None:
            raise ValueError("sat_budget needs cull_conic/cull_opacity")
        if n >= 1 << 24:
            raise ValueError(f"saturation bound cull packs 6 q-bits under the gid: "
                             f"n={n} must stay below 2^24")
        if sat_budget % chunk:
            raise ValueError(f"sat_budget {sat_budget} is not a multiple of chunk {chunk}")
        if kept_budget >= scan.MAX_LEN:
            raise ValueError(f"kept_budget {kept_budget} must stay below 2^25: "
                             "63 * kept must be an exact int32 sum")
    do_cull = cull_conic is not None and (
        pair_budget < 8 * n or kept_budget < pair_budget or do_sat
    )

    with spans.span("bin", on_stage):
        table, total = expansion_table(mean2d, radius, depth, cull_conic, cull_opacity,
                                       tw=tw, th=th, tile_size=tile_size, db=db,
                                       do_cull=do_cull)
        key, pair_gid = expand.expand_pairs(
            table, total, pair_budget, tw=tw, tile_size=tile_size, db=db,
            num_tiles=num_tiles, n_orig=n, do_cull=do_cull, sat_pack=do_sat,
        )

    with spans.span("sort", on_stage):
        # two-key sort as one int64 key: both halves are non-negative int32
        packed, _ = torch.sort((key.to(torch.int64) << 32) | pair_gid.to(torch.int64))
        key_s = (packed >> 32).to(torch.int32)
        gid_s = (packed & 0xFFFFFFFF).to(torch.int32)

    gid_null = n << expand.SAT_Q_BITS if do_sat else n
    if do_cull:
        kept_total = (pair_gid != gid_null).sum(dtype=torch.int32)
    else:
        kept_total = torch.clamp(total, max=pair_budget).to(torch.int32)
    pad = 0
    if lead is not None:
        pad = lead(kept_total).to(torch.int64) % chunk
        src = torch.arange(key_s.shape[0], device=dev) - pad
        before = src < 0
        src = torch.clamp(src, min=0)
        key_s = torch.where(before, -1, key_s[src])
        gid_s = torch.where(before, gid_null, gid_s[src])

    tids = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev) << db
    bounds = torch.clamp(torch.searchsorted(key_s, tids, side="left"), max=kept_budget)
    starts = bounds[:-1].to(torch.int32)
    tile_count = (bounds[1:] - bounds[:-1]).to(torch.int32)

    n_valid = torch.clamp(total, max=pair_budget)
    n_dropped = torch.clamp(total - pair_budget, min=0)
    if do_cull:
        n_culled = n_valid - kept_total
    else:
        n_culled = torch.zeros((), dtype=torch.int32, device=dev)
    n_dropped = n_dropped + torch.clamp(kept_total + pad - kept_budget, min=0)
    grad_ok = kept_total + pad <= kept_budget
    n_sat = torch.zeros((), dtype=torch.int32, device=dev)
    if do_sat:
        with spans.span("sat", on_stage):
            gid_s, starts, tile_count, n_sat = saturation_cull(
                gid_s, starts, tile_count, chunk=chunk, kept_budget=kept_budget,
                sat_budget=sat_budget, gid_null=gid_null)
            n_dropped = n_dropped + torch.clamp(n_sat - sat_budget, min=0)
            grad_ok = grad_ok & (n_sat <= sat_budget)
    return Binning(
        gid_s=gid_s,
        tile_start=starts,
        tile_count=tile_count,
        n_pairs=n_valid.to(torch.int32),
        n_dropped=n_dropped.to(torch.int32),
        n_culled=n_culled.to(torch.int32),
        n_sat=n_sat,
        grad_ok=grad_ok,
    )
