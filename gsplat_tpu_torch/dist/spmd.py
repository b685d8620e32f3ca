"""The mesh train steps (camera-batch x tile-band) and the band eval step.

Port of gsplat_tpu/dist/spmd.py on torch.distributed, one rank a mesh cell
(d, t). The three builders keep the JAX signatures and return tuples (less
`interpret`); each step runs on every rank of the mesh, in lockstep:

- make_spmd_train_step: the model and Adam replicated. Rank (d, t)
  renders band t of camera d (`render(region=...)`, its pairs laid on
  the full frame's chunk grid by `band_lead`, so each band's pixels are
  the full render's), the tile row all-gathers its bands
  (collectives.BandGather) and crops them to the height, and the rank
  takes the photometric loss of the full image. The parameter gradients
  are summed over the world; each view's screen-space gradient is summed
  over its tile row and, with its radii, gathered over `data`; Adam then
  runs on every rank.
- make_sharded_spmd_train_step: every (CAP, ...) leaf and the Adam
  moments sharded over `data` (data.shard_gaussians). Each rank projects
  its shard for every camera of the batch, one all-to-all over `data`
  (collectives.AllToAll) hands each rank the 11-float projected rows of
  its own camera in global-id order, and it renders its band of that
  table. The backward runs the inverse exchange, then each camera's
  projection in turn, adding its gradients into one buffer a parameter in
  camera order; the shard's gradients are summed over the tile row only,
  and Adam runs on the shard.
- make_spmd_eval_step: bands rendered, gathered and cropped; the loss,
  PSNR, image and dropped pairs of one camera.

Semantics as in the JAX package: the loss is the mean over the camera
batch of the upstream L1 + D-SSIM loss (its pmean over the mesh);
densification accumulates each view's own screen-space gradient (the
batch mean's, times n_data) and radii; n_pairs, n_contrib and n_sat are
reduced with MAX over the world, n_dropped and n_culled with SUM, so every
rank sizes its budgets alike. The gradients are summed in one fixed
order (collectives.reduce_sum_fixed): over the cameras, then over the
bands, in both steps; so every rank holds the same bits, a step run twice
gives the same bits, the two steps give the same bits, and on a 1x1 mesh
both give make_train_step's. (Adam turns float noise in a gradient near
zero into a full step: two runs that add in other orders parted by 0.65
in an opacity logit within 20 iterations at 1M Gaussians on an H100. The
one order is what lets the replicated and the sharded runs be held to
each other.)

Each step takes `on_stage(name)` (called after "render", "band_gather",
"loss", "backward", "grad_all_reduce", "adam", "densify_stats"; the sharded
step also after "project" and "all_to_all") and `grads_out`, a dict the
step fills with the reduced parameter gradients (the shard's in the
sharded step) and the per-view screen-space gradients ("mean2d"). Each
stage is a span of gsplat_tpu_torch.spans under the step's root ("step");
the replicated step's "render" is render's own span, its stage end a mark.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from gsplat_tpu_torch import spans
from gsplat_tpu_torch.config import MeshParams, OptimizationParams
from gsplat_tpu_torch.core.camera import Camera
from gsplat_tpu_torch.core.gaussians import Gaussians
from gsplat_tpu_torch.dist import collectives as C
from gsplat_tpu_torch.dist.mesh import Mesh
from gsplat_tpu_torch.render import budgets
from gsplat_tpu_torch.render.project import Projection, project_gaussians
from gsplat_tpu_torch.render.render import render, render_projected
from gsplat_tpu_torch.train.densify import add_densification_stats
from gsplat_tpu_torch.train.loss import photometric_loss, psnr
from gsplat_tpu_torch.train.optim import AdamState, adam_update, current_lrs, make_lr_fns

_CAM_LEAVES = ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")


def stack_cameras(cams: List[Camera], images: bool = True) -> Camera:
    """Same-resolution cameras -> one Camera whose leaves have a leading
    batch dim (the target images too, unless images=False)."""
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("mixed resolutions in a camera batch")
    img = None
    if images and cams[0].image is not None:
        img = torch.stack([c.image for c in cams])
    return Camera(**{k: torch.stack([getattr(c, k) for c in cams]) for k in _CAM_LEAVES},
                  image=img, width=cams[0].width, height=cams[0].height)


def _band_height(height: int, tile_axis: int, tile_size: int) -> int:
    """Rows a tile rank renders: the height split over the tile axis,
    rounded up to whole tiles."""
    per = -(-height // tile_axis)
    return -(-per // tile_size) * tile_size


def _unbatch(cam: Camera, i: int = 0) -> Camera:
    """Row i of a stacked camera batch (its matrices; no target image)."""
    return Camera(**{k: getattr(cam, k)[i] for k in _CAM_LEAVES}, image=None,
                  width=cam.width, height=cam.height, image_name=cam.image_name,
                  uid=cam.uid)


def own_image(cams: Camera, mesh: Mesh) -> torch.Tensor:
    """This rank's target: row d of the batch's images, or the one image of
    a data.global_camera_batch."""
    return cams.image[0] if cams.image.shape[0] == 1 else cams.image[mesh.d]


def _band_lead(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """render's band_lead on this rank: the kept pairs of the tile row's
    bands above this one (one all-gather of each band's count), which the
    full frame sorts before this band's first tile."""
    def lead(kept: torch.Tensor) -> torch.Tensor:
        counts = C.all_gather_rows(kept.reshape(1).to(torch.int64), mesh.tile_group,
                                   "band_lead")
        return counts[:mesh.t].sum()

    return lead


def _reduce_counts(mesh: Mesh, loss: torch.Tensor, out) -> tuple:
    """One all-gather of every rank's loss and counts -> (mean loss over the
    world, n_pairs MAX, n_dropped SUM, n_culled SUM, n_contrib MAX, n_sat
    MAX), the same values on every rank."""
    vec = torch.stack([loss.detach().to(torch.float64)] + [
        getattr(out, k).to(torch.float64)
        for k in ("n_pairs", "n_dropped", "n_culled", "n_contrib", "n_sat")])
    every = C.all_gather_rows(vec[None], mesh.world_group, "counts")
    total = torch.zeros((), dtype=torch.float32, device=loss.device)
    for r in range(every.shape[0]):   # rank order: the same bits on every rank
        total = total + every[r, 0].to(torch.float32)
    mean = total / every.shape[0]
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return (mean, i32(every[:, 1].max()), i32(every[:, 2].sum()), i32(every[:, 3].sum()),
            every[:, 4].max().to(torch.int64), i32(every[:, 5].max()))


def _world_fold(mesh: Mesh) -> Callable:
    """The replicated step's order of additions over the world's rows (rank
    d * tile + t): over the data axis within each band, then over the
    bands, the order in which the sharded step adds the same numbers (its
    cameras, then its tile row)."""
    def fold(rows: torch.Tensor) -> torch.Tensor:
        return C.fold_rows([C.fold_rows(rows[t::mesh.tile]) for t in range(mesh.tile)])

    return fold


def _finish(g_new, opt_state, params, pgrads, offs, radii, lr_fns, step, ema, mean_loss,
            counts, n_data, width, height, on_stage, grads_out):
    """Adam, each view's densification statistics, the EMA -> the step's
    nine outputs."""
    with spans.span("adam", on_stage):
        lrs = current_lrs(lr_fns, step)
        new_params, new_opt_state = adam_update(params, pgrads, opt_state, lrs)
    with spans.span("densify_stats", on_stage):
        g_new = g_new.replace(**new_params)
        for i in range(n_data):
            g_new = add_densification_stats(g_new, offs[i] * float(n_data), radii[i], width,
                                            height)
    if grads_out is not None:
        grads_out.update(pgrads)
        grads_out["mean2d"] = offs
    new_ema = mean_loss if step <= 1 else 0.4 * mean_loss + 0.6 * ema
    n_pairs, n_dropped, n_culled, n_contrib, n_sat = counts
    return (g_new, new_opt_state, mean_loss, new_ema, n_pairs, n_dropped, n_culled,
            n_contrib, n_sat)


def make_spmd_train_step(
    mesh: Mesh,
    opt: OptimizationParams,
    mp: MeshParams,
    spatial_lr_scale: float,
    width: int,
    height: int,
    pair_budget: Optional[int] = None,
    contrib_budget: Optional[int] = None,
    sat_budget: Optional[int] = None,
    kept_budget: Optional[int] = None,
) -> Callable:
    """The replicated mesh step: train_step(g, opt_state, cams, bg, step,
    ema, on_stage=None, grads_out=None) -> (g, opt_state, loss, ema,
    n_pairs, n_dropped, n_culled, n_contrib, n_sat), make_train_step's
    outputs. `cams` is a camera batch of mesh.data cameras
    (stack_cameras, or data.global_camera_batch); g and opt_state are the
    whole model, the same bits on every rank."""
    n_data, n_tile = mesh.data, mesh.tile
    band_h = _band_height(height, n_tile, mp.tile_size)
    region = (mesh.t * band_h, band_h)
    lr_fns = make_lr_fns(opt, spatial_lr_scale)
    kw = dict(tile_size=mp.tile_size, chunk=mp.chunk_size, **budgets.resolve(
        mp, pair_budget, kept_budget, contrib_budget, sat_budget).kwargs())

    def train_step(g: Gaussians, opt_state: AdamState, cams: Camera, bg: torch.Tensor,
                   step: int, ema, on_stage: Optional[Callable[[str], None]] = None,
                   grads_out: Optional[Dict[str, torch.Tensor]] = None):
        with spans.span("step", root=True):
            step = int(step)
            cap = g.capacity
            params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
            offset = torch.zeros((cap, 2), dtype=torch.float32, device=g.device,
                                 requires_grad=True)
            with torch.enable_grad():
                out = render(_unbatch(cams, mesh.d), g.replace(**params), bg, region=region,
                             band_lead=_band_lead(mesh), mean2d_offset=offset,
                             on_stage=on_stage, **kw)
                spans.stage(on_stage, "render")
                with spans.span("band_gather", on_stage):
                    full = C.BandGather.apply(out.image, mesh.tile_group, mesh.t,
                                              1.0 / n_data)[:height]
                with spans.span("loss", on_stage):
                    loss = photometric_loss(full, own_image(cams, mesh), opt.lambda_dssim)
                with spans.span("backward", on_stage, adopt=True):
                    grads = torch.autograd.grad(loss, list(params.values()) + [offset])
            with spans.span("grad_all_reduce", on_stage):
                # the parameter gradients summed over the world; this view's
                # screen-space gradient summed over its tile row, then gathered
                # over data beside its radii (the projection's, alike on every
                # band)
                flat = C.reduce_sum_fixed(torch.cat([x.reshape(-1) for x in grads[:-1]]),
                                          mesh.world_group, _world_fold(mesh),
                                          "grad_all_reduce")
                pgrads, o = {}, 0
                for k, v in params.items():
                    pgrads[k] = flat[o:o + v.numel()].view(v.shape)
                    o += v.numel()
                off = C.reduce_sum_fixed(grads[-1], mesh.tile_group, name="grad_all_reduce")
                view = C.all_gather_rows(torch.cat([off, out.radii[:, None]], 1)[None],
                                         mesh.data_group, "view_gather")
                mean_loss, *counts = _reduce_counts(mesh, loss, out)
            return _finish(g, opt_state, {k: v.detach() for k, v in params.items()},
                           pgrads, view[:, :, :2], view[:, :, 2], lr_fns, step, ema,
                           mean_loss, counts, n_data, width, height, on_stage, grads_out)

    return train_step


def make_sharded_spmd_train_step(
    mesh: Mesh,
    opt: OptimizationParams,
    mp: MeshParams,
    spatial_lr_scale: float,
    width: int,
    height: int,
    pair_budget: Optional[int] = None,
    contrib_budget: Optional[int] = None,
    sat_budget: Optional[int] = None,
    kept_budget: Optional[int] = None,
) -> Callable:
    """The ZeRO-sharded mesh step: the signature and outputs of
    make_spmd_train_step, with g and opt_state this rank's shard
    (data.shard_gaussians; capacity % n_data == 0) and the outputs the
    updated shard."""
    n_data, n_tile = mesh.data, mesh.tile
    band_h = _band_height(height, n_tile, mp.tile_size)
    region = (mesh.t * band_h, band_h)
    lr_fns = make_lr_fns(opt, spatial_lr_scale)
    kw = dict(tile_size=mp.tile_size, chunk=mp.chunk_size, **budgets.resolve(
        mp, pair_budget, kept_budget, contrib_budget, sat_budget).kwargs())

    def train_step(g: Gaussians, opt_state: AdamState, cams: Camera, bg: torch.Tensor,
                   step: int, ema, on_stage: Optional[Callable[[str], None]] = None,
                   grads_out: Optional[Dict[str, torch.Tensor]] = None):
        with spans.span("step", root=True):
            step = int(step)
            rows = g.capacity                      # this shard's rows
            live = torch.clamp(g.n_live - mesh.d * rows, 0, rows).to(g.n_live.dtype)
            params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
            offsets = [torch.zeros((rows, 2), dtype=torch.float32, device=g.device,
                                   requires_grad=True) for _ in range(n_data)]
            with torch.enable_grad():
                with spans.span("project", on_stage):
                    mine, radii = [], []
                    for c in range(n_data):
                        pr = project_gaussians(g.replace(**params, n_live=live),
                                               _unbatch(cams, c), mean2d_offset=offsets[c])
                        mine.append(torch.cat([pr.mean2d, pr.conic, pr.depth[:, None],
                                               pr.radius[:, None], pr.rgb,
                                               pr.opacity[:, None]], 1))
                        radii.append(pr.radius)
                with spans.span("all_to_all", on_stage):
                    # row c of `mine` goes to data rank c; the received blocks,
                    # in shard order, are the full table of this rank's camera
                    stacked = torch.stack(mine)
                    full = C.AllToAll.apply(stacked, mesh.data_group)
                with spans.span("render", on_stage):
                    radius = full[:, 6].detach()
                    proj = Projection(mean2d=full[:, 0:2], conic=full[:, 2:5],
                                      depth=full[:, 5], radius=radius, rgb=full[:, 7:10],
                                      opacity=full[:, 10], visible=radius > 0.0)
                    out = render_projected(proj, width, height, bg, region=region,
                                           band_lead=_band_lead(mesh), on_stage=on_stage,
                                           **kw)
                with spans.span("band_gather", on_stage):
                    img = C.BandGather.apply(out.image, mesh.tile_group, mesh.t,
                                             1.0 / n_data)[:height]
                with spans.span("loss", on_stage):
                    loss = photometric_loss(img, own_image(cams, mesh), opt.lambda_dssim)
                # the render's and the exchange's backward, then each camera's
                # projection in turn: its gradients added into one buffer a
                # parameter in camera order (the order the replicated step adds
                # them in), the screen-space gradients kept a view each. The
                # scalar root sum(rows * g) hands the projection g bit for bit
                # (its backward multiplies g by ones); passing g as grad_outputs
                # instead costs ~3 s on the first call (torch imports sympy for
                # that path).
                with spans.span("backward", on_stage, adopt=True):
                    (g_rows,) = torch.autograd.grad(loss, [stacked])
                    summed, views = None, []
                    for c in range(n_data):
                        *gc, g_off = torch.autograd.grad((mine[c] * g_rows[c]).sum(),
                                                         list(params.values()) + [offsets[c]])
                        views.append(g_off)
                        if summed is None:
                            summed = gc
                        else:
                            for acc, x in zip(summed, gc):
                                acc += x
                        del gc
            with spans.span("grad_all_reduce", on_stage):
                # the shard's gradients and its views' screen-space gradients,
                # summed over the tile row (each band's share); no reduction
                # over data
                flat = torch.cat([x.reshape(-1) for x in summed + views])
                flat = C.reduce_sum_fixed(flat, mesh.tile_group, name="grad_all_reduce")
                pgrads, o = {}, 0
                for k, v in params.items():
                    pgrads[k] = flat[o:o + v.numel()].view(v.shape)
                    o += v.numel()
                offs = flat[o:].view(n_data, rows, 2)
                mean_loss, *counts = _reduce_counts(mesh, loss, out)
            return _finish(g, opt_state, {k: v.detach() for k, v in params.items()},
                           pgrads, offs, radii, lr_fns, step, ema, mean_loss, counts, n_data,
                           width, height, on_stage, grads_out)

    return train_step


def make_spmd_eval_step(
    mesh: Mesh,
    mp: MeshParams,
    lambda_dssim: float,
    width: int,
    height: int,
    pair_budget: Optional[int] = None,
) -> Callable:
    """Tile-band eval of one camera: eval_step(g, cam, bg) -> (loss, psnr,
    image (height, width, 3), n_dropped summed over the bands), the same on
    every rank of a tile row. Pass the loop's current pair budget."""
    band_h = _band_height(height, mesh.tile, mp.tile_size)
    region = (mesh.t * band_h, band_h)
    budget = pair_budget if pair_budget is not None else mp.pair_budget

    @torch.no_grad()
    def eval_step(g: Gaussians, cam: Camera, bg: torch.Tensor):
        out = render(cam, g, bg, tile_size=mp.tile_size, chunk=mp.chunk_size,
                     pair_budget=budget, region=region, band_lead=_band_lead(mesh))
        full = C.all_gather_rows(out.image, mesh.tile_group, "band_gather")[:height]
        n_dropped = C.all_gather_rows(out.n_dropped.reshape(1), mesh.tile_group,
                                      "counts").sum(dtype=torch.int32)
        return (photometric_loss(full, cam.image, lambda_dssim), psnr(full, cam.image),
                full, n_dropped)

    return eval_step
