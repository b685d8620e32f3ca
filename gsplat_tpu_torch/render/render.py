"""Differentiable render: project -> bin -> gather -> composite -> image.

Port of gsplat_tpu/render/render.py::render/render_projected. The
projection (with SH) is, on CUDA, one autograd Function over its kernels
(`render/project.py::_Project`), elsewhere plain torch; the attribute
packing is plain torch; both are differentiated by autograd;
binning is integer-valued and carries no gradient. The gather, compositing
and per-Gaussian gradient reduction are one `torch.autograd.Function`,
`_Rasterize` (the reference's `_rasterize` custom VJP): its forward gathers
the pair table and runs composite_fwd (K2); its backward runs composite_bwd
(K3) into per-tile regions of a prefilled d-table whose rows carry their gid
keys, sorts the keys, finds each Gaussian's segment end (K4) and sums each
segment's rows in a fixed order (segment_sum). No scatter, no atomics: the
same inputs give the same gradient bits.
A render whose inputs need no gradient (or under torch.no_grad()) runs the
forward kernels alone and saves nothing. With attr_pack the pair table is
the packed (P, 8) layout of render/raster.py (rgb and opacity as bf16
pairs); the gradient passes straight through the rounding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from gsplat_tpu_torch import spans
from gsplat_tpu_torch.core.camera import Camera
from gsplat_tpu_torch.core.gaussians import Gaussians
from gsplat_tpu_torch.render.binning import Binning, bin_gaussians, out_budget, tile_grid
from gsplat_tpu_torch.render.bounds import segment_ends
from gsplat_tpu_torch.render.project import Projection, project_fwd, project_gaussians
from gsplat_tpu_torch.render.raster import (ATTR_DIM, KEY_COL, composite_bwd, composite_fwd,
                                            pack_attrs, pack_attrs8, resolve_attr_pack,
                                            untile_image)
from gsplat_tpu_torch.render.reduce import segment_sum


class RenderOutput(NamedTuple):
    image: torch.Tensor          # (H, W, 3) final (bg-composited) image
    transmittance: torch.Tensor  # (H, W) final per-pixel transmittance
    radii: torch.Tensor          # (N,) projected pixel radii
    visible: torch.Tensor        # (N,) bool visibility filter
    n_pairs: torch.Tensor        # () int32 expansion slots used (budget telemetry)
    n_dropped: torch.Tensor      # () int32 pairs dropped by budget overflow
    n_culled: torch.Tensor       # () int32 rect pairs removed by the tight tile cull
    n_contrib: torch.Tensor      # () int64 pair slots composited before the
    #                              per-tile early exit (chunk-granular)
    n_sat: torch.Tensor          # () int32 rows the saturation bound cull's
    #                              regions need (0 with the cull off)


def _attr_rows(proj: Projection) -> torch.Tensor:
    """(N+1, 16) per-Gaussian attribute rows, row N the inert null Gaussian
    the pair table's padding slots point at."""
    attrs = pack_attrs(proj.mean2d, proj.conic, proj.rgb, proj.opacity)
    return torch.cat([attrs, attrs.new_zeros((1, ATTR_DIM))], dim=0)


def _gather_with_gid(attrs: torch.Tensor, gid_s: torch.Tensor,
                     attr_pack: bool = False) -> torch.Tensor:
    """(N+1, 16) attribute rows + (P,) sorted gids -> (P, 16) pair table whose
    column 9 holds each pair's gid as an f32 value (render/raster.py layout;
    the reference's (16, P) table is its transpose), or with attr_pack the
    packed (P, 8) table, its gid in column 7. One row gather: the rows are
    packed and their gid column filled per Gaussian first."""
    gid = torch.arange(attrs.shape[0], dtype=torch.float32, device=attrs.device)
    if attr_pack:
        rows = torch.cat([pack_attrs8(attrs), gid[:, None]], dim=1)
    else:
        rows = attrs.clone()
        rows[:, KEY_COL] = gid
    return rows.index_select(0, gid_s)


def pair_table(proj: Projection, binning: Binning, kept_budget: int,
               attr_pack: bool = False) -> torch.Tensor:
    """The compositor's input: the first kept_budget sorted pairs of
    `binning` as a (kept_budget, 16) table of `proj`'s attributes (packed:
    (kept_budget, 8)), the padding slots (gid N) pointing at an appended
    inert null row."""
    return _gather_with_gid(_attr_rows(proj), binning.gid_s[:kept_budget], attr_pack)


def contrib_regions(nproc: torch.Tensor, chunk: int, c_budget: int):
    """Per-tile regions of the backward's d-table (render.py:109-117 of the
    reference): each tile's replayed chunks, capped at the budget, packed in
    tile order -> (np_c, comp_start, overflow). On overflow the regions are
    clamped into the table (they may then overlap; the step's gradient is
    zeroed)."""
    np_c = torch.clamp(nproc, max=c_budget // chunk)
    sizes = np_c.to(torch.int64) * chunk
    cum = torch.cumsum(sizes, 0)
    overflow = cum[-1] > c_budget
    comp_start = torch.minimum(cum - sizes, c_budget - sizes).to(torch.int32)
    return np_c.to(torch.int32), comp_start, overflow


def reduce_by_gid(d: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(c, 16) d-table -> (n_rows, 16) per-Gaussian sums of its rows' first
    nine columns by their gid keys (row n_rows - 1, the null Gaussian, and
    columns 9..15 zero): a stable sort of the key column, each gid's
    segment end in the sorted order (K4, segment_ends) and a fixed-order
    float64 sum of each segment's rows read through the permutation
    (segment_sum), rounded once.

    The reference sums by differences of a float32 cumsum table at the
    segment ends; each such sum loses the digits the running sum has grown
    past (1e-3 of the colour columns' max at the 1080p bench view). A
    float64 cumsum fixes the digits but not the bits: float torch.cumsum on
    CUDA adds in an order that changes from call to call. The direct sum
    has neither fault: two calls on one table give the same bits."""
    key_s, perm = torch.sort(d[:, KEY_COL], stable=True)
    ends = segment_ends(key_s, n_rows - 1)
    return segment_sum(d, perm, ends, n_rows)


class _Rasterize(torch.autograd.Function):
    """attrs (N+1, 16) differentiable attribute rows; gid_s (kept or sat,)
    sorted gids and the tile tables (no gradient); grad_ok () bool, False on
    kept- or sat-budget overflow -> (tiles (num_tiles, 4, npix), nproc (num_tiles,)
    int32). static: (tw, tile_size, chunk, contrib_budget, attr_pack). The
    backward's gradient of a packed table's rows is its d-table's, as if
    unrounded (the reference's straight-through _rasterize_bwd)."""

    @staticmethod
    def forward(ctx, attrs, gid_s, tile_start, tile_count, grad_ok, static, on_stage):
        tw, tile_size, chunk, _, attr_pack = static
        with spans.span("gather", on_stage) as sp:
            gathered = _gather_with_gid(attrs, gid_s, attr_pack)
            if sp is not None:
                # the rows the gather reads, and those that are a tile's pairs
                sp.count(rows=gid_s.shape[0], live=tile_count.sum())
        with spans.span("composite", on_stage):
            tiles, nproc = composite_fwd(gathered, tile_start, tile_count, tw=tw,
                                         tile_size=tile_size, chunk=chunk)
        ctx.save_for_backward(gathered, tile_start, tile_count, nproc, grad_ok, tiles)
        ctx.static = static
        ctx.n_rows = attrs.shape[0]
        ctx.mark_non_differentiable(nproc)
        return tiles, nproc

    @staticmethod
    def backward(ctx, g_tiles, _g_nproc):
        with spans.span("backward.raster"):
            gathered, tile_start, tile_count, nproc, grad_ok, tiles = ctx.saved_tensors
            tw, tile_size, chunk, c_budget, _ = ctx.static
            if g_tiles is None:
                g_tiles = torch.zeros_like(tiles)
            np_c, comp_start, overflow = contrib_regions(nproc, chunk, c_budget)
            d = composite_bwd(gathered, tile_start, tile_count, comp_start, np_c, tiles,
                              g_tiles.contiguous(), tw=tw, tile_size=tile_size,
                              chunk=chunk, p_out=c_budget)
            with spans.span("backward.raster.reduce"):
                d_attrs = reduce_by_gid(d, ctx.n_rows)
            # either overflow (kept pairs past the kept budget, or replayed rows
            # past the contrib budget) zeroes the whole step's gradient
            d_attrs = d_attrs * (grad_ok & ~overflow).to(d_attrs.dtype)
        return d_attrs, None, None, None, None, None, None


def render(
    cam: Camera,
    g: Gaussians,
    bg: torch.Tensor,
    *,
    tile_size: int = 32,
    chunk: int = 128,
    pair_budget: int = 1 << 18,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
    region: Optional[Tuple[int, int]] = None,
    band_lead: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tight_cull: bool = True,
    kept_budget: Optional[int] = None,
    contrib_budget: Optional[int] = None,
    sat_budget: Optional[int] = None,
    attr_pack: Optional[bool] = None,
    on_stage: Optional[Callable[[str], None]] = None,
) -> RenderOutput:
    """Render `g` through `cam` over background `bg` (3,), on the device the
    tensors live on (the kernels on CUDA, their plain versions on the CPU).
    attr_pack: the packed pair table (render_projected).

    mean2d_offset: optional zeros (N,2); differentiate w.r.t. it for the
    screen-space positional gradient densification reads.
    region: optional (y0, band_h) horizontal band to render, y0 a Python
    int: the projection uses the full camera, binning and compositing see
    band_h rows starting at image row y0; band_lead lays the band's pairs
    on the full frame's chunk grid (render_projected).
    on_stage(name), if given, is called after each forward stage ("project",
    "bin", "sort", "sat" with the saturation cull, "gather", "composite",
    "untile") so a caller can time them: each stage is a span of
    gsplat_tpu_torch.spans under the render's own ("render")."""
    with spans.span("render"):
        with spans.span("project", on_stage) as sp:
            launches = project_fwd.launches
            proj = project_gaussians(g, cam, scaling_modifier=scaling_modifier,
                                     override_color=override_color,
                                     mean2d_offset=mean2d_offset)
            if sp is not None:
                # the rows projected, and 1 where the CUDA kernel did it
                sp.count(rows=g.capacity, fused=project_fwd.launches - launches)
        return render_projected(
            proj, cam.width, cam.height, bg, tile_size=tile_size, chunk=chunk,
            pair_budget=pair_budget, region=region, band_lead=band_lead,
            tight_cull=tight_cull, kept_budget=kept_budget, contrib_budget=contrib_budget,
            sat_budget=sat_budget, attr_pack=attr_pack, on_stage=on_stage,
        )


def render_projected(
    proj: Projection,
    width: int,
    height: int,
    bg: torch.Tensor,
    *,
    tile_size: int = 32,
    chunk: int = 128,
    pair_budget: int = 1 << 18,
    region: Optional[Tuple[int, int]] = None,
    band_lead: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tight_cull: bool = True,
    kept_budget: Optional[int] = None,
    contrib_budget: Optional[int] = None,
    sat_budget: Optional[int] = None,
    attr_pack: Optional[bool] = None,
    on_stage: Optional[Callable[[str], None]] = None,
) -> RenderOutput:
    """Bin + composite a pre-computed `Projection`.

    region (y0, band_h), y0 a Python int: render the band of band_h rows
    from image row y0 (the unit of the mesh's tile-band parallelism). The
    means are shifted by (0, y0) inside the differentiable graph, as the
    reference shifts them (so y0 > 0 rounds them: a band agrees with the
    full render's rows within float error, not bit for bit); the image is
    (band_h, width, 3). The band's sort keys keep the full frame's depth
    bits (bin_gaussians' key_tiles), so its pairs composite in the full
    render's order; the reference's take the band's finer depth bits, and
    near-equal depths then composite in another order (2.4e-4 on an image
    of a 2x2 mesh on the CPU). band_lead(kept), given the band's kept-pair
    count, returns the count of kept pairs the full frame sorts before the
    band (the mesh steps gather it over the tile row): the band's pairs
    then lie on the full frame's chunk grid, as the compositors' chunk
    sweep and whole-tile exit see them in the full render (bin_gaussians'
    lead; without it a band's pixels can differ from the full render's by
    up to T_EPS: 5.9e-5 at the 1080p bench view, on an H100). A region (0,
    band_h), band_h the height rounded up to a tile, gives the full
    render's bits in its first `height` rows.

    tight_cull drops bounding-rect pairs whose max alpha in the tile is
    provably < 1/255 (the image is unchanged; fewer chunks to composite).
    kept_budget (< pair_budget) sizes the gather and the compositor by the
    cull's survivors instead of the expansion slots; kept overflow shows up
    in n_dropped like slot overflow. contrib_budget sizes the backward's
    d-table by the pairs composited before each tile's early exit
    (n_contrib); it defaults to a size that cannot overflow, and when the
    replayed rows exceed it the step's gradient is zeroed (the caller sees
    n_contrib > contrib_budget). sat_budget (needs tight_cull; at most
    pair_budget) turns on the saturation bound cull: each tile's pairs are
    cut at the first chunk boundary where a conservative transmittance bound
    proves the compositor's whole-tile exit, and the gather, the compositor
    and the backward run on the sat_budget packed survivors. Image, nproc
    and gradients are bit-identical to the render without it; n_sat reports
    the rows needed, and an overflow zeroes the gradient and shows in
    n_dropped. Budgets are rounded up to whole chunks.

    attr_pack gathers the packed (P, 8) pair table (render/raster.py):
    32-byte rows with rgb and opacity rounded to bfloat16, in the image and
    in the gradient chain (the parameters stay float32; the gradient
    passes straight through the rounding). None takes GSPLAT_PACK's
    default (raster.resolve_attr_pack). A projection whose rgb and opacity
    are already bf16 values renders the same bits either way."""
    attr_pack = resolve_attr_pack(attr_pack, proj.mean2d.device)
    key_tiles = None
    if region is not None:
        key_tiles = tile_grid(width, height, tile_size)
        key_tiles = key_tiles[0] * key_tiles[1]
        y0, height = int(region[0]), int(region[1])
        shift = torch.tensor([0.0, float(y0)], dtype=torch.float32,
                             device=proj.mean2d.device)
        proj = proj._replace(mean2d=proj.mean2d - shift[None, :])
    n = proj.mean2d.shape[0]
    if n + 1 > (1 << 24):
        # gids ride the pair table as f32 VALUES, exact only below 2^24
        raise ValueError(
            f"capacity {n} exceeds the 2^24 exact-f32-id limit of the pair table"
        )
    tw, th = tile_grid(width, height, tile_size)
    pair_budget = -(-pair_budget // chunk) * chunk
    if kept_budget is None:
        kept_budget = pair_budget
    kept_budget = min(-(-kept_budget // chunk) * chunk, pair_budget)
    if contrib_budget is None:
        contrib_budget = out_budget(kept_budget, tw * th, chunk)
    contrib_budget = -(-contrib_budget // chunk) * chunk
    if sat_budget is not None:
        if not tight_cull:
            raise ValueError("sat_budget requires tight_cull=True")
        sat_budget = min(-(-sat_budget // chunk) * chunk, pair_budget)

    binning = bin_gaussians(
        proj.mean2d.detach(), proj.radius, proj.depth.detach(),
        width=width, height=height, tile_size=tile_size, chunk=chunk,
        pair_budget=pair_budget,
        cull_conic=proj.conic.detach() if tight_cull else None,
        cull_opacity=proj.opacity.detach() if tight_cull else None,
        kept_budget=kept_budget, sat_budget=sat_budget, key_tiles=key_tiles,
        lead=band_lead, on_stage=on_stage,
    )

    # every post-sort stage reads the kept prefix of the sorted pairs or,
    # under the saturation cull, the packed survivors
    gid_post = binning.gid_s[:kept_budget] if sat_budget is None else binning.gid_s
    tiles, nproc = _Rasterize.apply(
        _attr_rows(proj), gid_post, binning.tile_start,
        binning.tile_count, binning.grad_ok,
        (tw, tile_size, chunk, contrib_budget, attr_pack), on_stage)
    with spans.span("untile", on_stage):
        rgb, transmittance = untile_image(tiles, tw, th, tile_size, width, height)
        image = rgb + transmittance[..., None] * bg.to(rgb.device)[None, None, :]
    return RenderOutput(
        image=image,
        transmittance=transmittance,
        radii=proj.radius,
        visible=proj.visible,
        n_pairs=binning.n_pairs,
        n_dropped=binning.n_dropped,
        n_culled=binning.n_culled,
        n_contrib=nproc.sum(dtype=torch.int64) * chunk,
        n_sat=binning.n_sat,
    )
