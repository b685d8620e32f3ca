"""The compositors read each sorted pair's attribute row through its gid: no
(P, 16) pair table is gathered. On the CPU, at the fixtures' scenes, the
plain compositors on the (N+1) rows and the gids give the bits they give on
the gathered table (image, nproc and d-table), for the f32 and the packed
rows, on the kept budget's prefix of the sorted gids and on the saturation
cull's survivors; and `render`'s image and gradients equal, bit for bit,
those of the same render whose `_Rasterize` gathers the table first (the
port before the gids were read in the compositors). No JAX render runs.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures as F
from gsplat_tpu_torch.render import raster as traster
from gsplat_tpu_torch.render import render as trender
from gsplat_tpu_torch.render.binning import bin_gaussians, out_budget, tile_grid
from gsplat_tpu_torch.render.project import project_gaussians

torch.set_num_threads(1)
KEPT_KW = dict(tile_size=F.TILE, chunk=F.CHUNK, pair_budget=F.BUDGET,
               kept_budget=F.BUDGET - F.CHUNK)
SAT_KW = dict(F.SAT_KW, sat_budget=F.SAT_KW["pair_budget"])
# case: (the saturation cull's scene and survivors, the packed rows)
CASES = {"kept": (False, False), "kept-packed": (False, True),
         "sat": (True, False), "sat-packed": (True, True)}


class _TableRasterize(torch.autograd.Function):
    """_Rasterize reading a gathered pair table: the rows gathered through
    the gids, K2 and K3 reading the table in order (through arange gids),
    the same reduction."""

    @staticmethod
    def forward(ctx, attrs, gid_s, tile_start, tile_count, grad_ok, static, on_stage):
        tw, tile_size, chunk, _, attr_pack = static
        table = trender._gid_rows(attrs, attr_pack).index_select(0, gid_s)
        tiles, nproc = traster.composite_fwd(table, tile_start, tile_count, tw=tw,
                                             tile_size=tile_size, chunk=chunk,
                                             gid=F.table_gids(table))
        ctx.save_for_backward(table, tile_start, tile_count, nproc, grad_ok, tiles)
        ctx.static, ctx.n_rows = static, attrs.shape[0]
        ctx.mark_non_differentiable(nproc)
        return tiles, nproc

    @staticmethod
    def backward(ctx, g_tiles, _g_nproc):
        table, tile_start, tile_count, nproc, grad_ok, tiles = ctx.saved_tensors
        tw, tile_size, chunk, c_budget, _ = ctx.static
        np_c, comp_start, overflow = trender.contrib_regions(nproc, chunk, c_budget)
        d = traster.composite_bwd(table, tile_start, tile_count, comp_start, np_c, tiles,
                                  g_tiles.contiguous(), tw=tw, tile_size=tile_size,
                                  chunk=chunk, p_out=c_budget, gid=F.table_gids(table))
        d_attrs = trender.reduce_by_gid(d, ctx.n_rows)
        return (d_attrs * (grad_ok & ~overflow).to(d_attrs.dtype),
                None, None, None, None, None, None)


def bits(x):
    return x.contiguous().view(torch.int32)


def render_grads(g, cam, bg, kw):
    params = {k: v.clone().requires_grad_() for k, v in g.params().items()}
    off = torch.zeros((g.capacity, 2), requires_grad=True)
    out = trender.render(cam, g.replace(**params), bg, mean2d_offset=off, **kw)
    loss = (out.image ** 2).sum()
    return out, torch.autograd.grad(loss, list(params.values()) + [off])


@pytest.mark.parametrize("case", list(CASES))
def test_compositors_by_gid_equal_the_gathered_table(case, monkeypatch):
    sat, pack = CASES[case]
    if sat:
        scene, w, h, kw = F.make_sat_scene()[0], F.SAT_W, F.SAT_H, SAT_KW
    else:
        scene, w, h, kw = F.make_scene(), F.W, F.H, KEPT_KW
    kw = dict(kw, attr_pack=pack)
    g, cam = F.torch_objects(scene, w, h)
    tile, chunk = kw["tile_size"], kw["chunk"]
    tw, th = tile_grid(w, h, tile)

    # K2 and K3's plain versions, by gid against the gathered table
    proj = project_gaussians(g, cam)
    b = bin_gaussians(proj.mean2d, proj.radius, proj.depth, width=w, height=h,
                      tile_size=tile, chunk=chunk, pair_budget=kw["pair_budget"],
                      cull_conic=proj.conic, cull_opacity=proj.opacity,
                      kept_budget=kw["kept_budget"], sat_budget=kw.get("sat_budget"))
    gid = b.gid_s if sat else b.gid_s[:kw["kept_budget"]]
    rows = trender._gid_rows(trender._attr_rows(proj), pack)
    table = rows.index_select(0, gid)
    assert rows.shape[0] == g.capacity + 1 < gid.shape[0] == table.shape[0]
    ts, tc = b.tile_start, b.tile_count
    fwd = dict(tw=tw, tile_size=tile, chunk=chunk)
    tiles, nproc = traster.composite_fwd(rows, ts, tc, gid=gid, **fwd)
    want_tiles, want_np = traster.composite_fwd(table, ts, tc, gid=F.table_gids(table), **fwd)
    assert torch.equal(bits(tiles), bits(want_tiles)) and torch.equal(nproc, want_np)
    assert int(nproc.sum()) > 0
    p_out = out_budget(gid.shape[0], tw * th, chunk)
    np_c, comp_start, _ = trender.contrib_regions(nproc, chunk, p_out)
    cot = torch.from_numpy(np.random.default_rng(3).normal(size=tiles.shape).astype(np.float32))
    args = (ts, tc, comp_start, np_c, tiles, cot)
    d = traster.composite_bwd(rows, *args, p_out=p_out, gid=gid, **fwd)
    want_d = traster.composite_bwd(table, *args, p_out=p_out, gid=F.table_gids(table), **fwd)
    assert torch.equal(bits(d), bits(want_d))

    # render and its gradients against the same render on a gathered table
    bg = torch.tensor([0.1, 0.2, 0.3])
    out, grads = render_grads(g, cam, bg, kw)
    monkeypatch.setattr(trender, "_Rasterize", _TableRasterize)
    want_out, want_grads = render_grads(g, cam, bg, kw)
    assert torch.equal(bits(out.image), bits(want_out.image))
    assert int(out.n_contrib) == int(want_out.n_contrib) > 0 and int(out.n_dropped) == 0
    for a, w_ in zip(grads, want_grads):
        assert torch.equal(bits(a), bits(w_))
    assert float(grads[0].abs().max()) > 0
