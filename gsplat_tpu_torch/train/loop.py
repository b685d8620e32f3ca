"""The training driver: the train step, and the loop around it.

Port of gsplat_tpu/train/loop.py. `make_train_step` is one step: render ->
L1 + D-SSIM loss -> gradients (autograd through the projection and
render._Rasterize: composite_bwd, segment_ends and segment_sum on CUDA) ->
per-group Adam -> densification statistics. `train` is the reference's
single-device driver, its events in the reference's order each iteration:
the network GUI's pending requests (and its pause); SH annealing every 1000
iterations; the camera pick from Python's global
`random`; the random background; the step; the adaptive budgets (read back
every 10 iterations only) and the saturation cull's AUTO probe and enable,
as render/budgets.py decides them; logging and metrics; evaluation; PLY saves;
densify/prune with capacity growth; the opacity reset; the checkpoint, last.
A KeyboardInterrupt saves an interrupt checkpoint; checkpoints carry the
loop's state for an exact resume.

With --mip_splatting (ModelParams.mip_splatting) the loop trains a
Mip-Splatting model (Yu et al. 2024) as the published code does: the 3D
filter (render/filter3d.py) over the training cameras at the start (after a
resume too), after every densify pass (after its capacity growth), and
every 100 iterations past densify_until_iter but the last 100; the opacity
reset clamps the filter-compensated opacity (densify.reset_opacity_mip).
The projection applies both filters wherever the model carries its filter.
A mesh of more than one device refuses the switch at the start.

Under a profiler each iteration is a root span ("iteration") whose
children are the densify pass ("densify": counters cloned, split, pruned,
live), the capacity growth ("grow": counter capacity) and the 3D filter
pass ("filter3d": counters rows, cameras); the train step is a root of its
own ("step"). The loop does not wait on the host for its next view: the
cameras' images are on the training device.

Where the port differs from the reference:
- randomness: the reference's JAX key chain (PRNGKey(0), split for each
  draw) is one torch.Generator on the training device, seeded 0; the
  random background (`draw_background`) and the split noise
  (`densify.split_noise`) draw from it in the loop's order, through
  module-level functions a test can replace. Its state is checkpointed as
  `extra_torch_rng` (the reference's `extra_rng_key`); a checkpoint of the
  JAX package resumes with everything but its key.
- --profile_dir captures a torch.profiler trace of steps 20 to
  20 + profile_steps (the reference: jax.profiler), the port's spans
  (gsplat_tpu_torch/spans.py) in it as `gsplat.*` annotations.
- a mesh (data_axis x tile_axis > 1) runs one process a mesh cell, one
  rank a device (gsplat_tpu_torch/dist/): the world must be exactly
  data_axis x tile_axis ranks, else it raises; data_axis -1 takes the
  world // tile_axis. Each step picks data_axis cameras alike on every
  rank and runs dist.spmd's replicated step or, with --shard_gaussians,
  its ZeRO-sharded one (capacity % data_axis == 0, else it raises); the
  sharded model is gathered for densify, the opacity reset, eval,
  checkpoints and PLYs, and sharded again. Every decision that sizes a
  buffer reads values reduced over the world, so the ranks decide alike;
  rank 0 alone prints, logs, evaluates and writes. --shard_gaussians on a
  1-cell mesh is ignored, as in the reference.
- the live viewer (without --quiet, and off on a mesh of more than one
  process, as in the reference: the browser preview and upstream's
  SIBR network GUI on --ip/--port, network_gui.py) writes its preview as a
  PNG, preview.png, where the reference writes a JPEG (viewer.py). A GUI
  render that raises is printed (one line) and counted on the server
  (`render_errors`) where the reference passes over it silently; either way
  the viewer gets no image and training goes on.
"""

from __future__ import annotations

import dataclasses
import pickle
import random
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from gsplat_tpu_torch import spans
from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.ckpt import (load_checkpoint, load_checkpoint_extras, save_checkpoint,
                                   save_ply)
from gsplat_tpu_torch.config import (MeshParams, ModelParams, OptimizationParams, OtherParams,
                                     PipelineParams, cfg_args_string, print_params)
from gsplat_tpu_torch.core.camera import Camera
from gsplat_tpu_torch.core.gaussians import Gaussians, grow_capacity
from gsplat_tpu_torch.dist import collectives
from gsplat_tpu_torch.dist.data import (gather_gaussians, global_camera_batch,
                                        replicate_gaussians, shard_gaussians)
from gsplat_tpu_torch.dist.mesh import backend_banner, make_mesh, world_info
from gsplat_tpu_torch.dist.spmd import make_sharded_spmd_train_step, make_spmd_train_step
from gsplat_tpu_torch.network_gui import (GuiRequest, NetworkGUIServer, camera_from_request,
                                          image_to_bytes)
from gsplat_tpu_torch.render import budgets
from gsplat_tpu_torch.render.filter3d import camera_table, filter3d
from gsplat_tpu_torch.render.render import render
from gsplat_tpu_torch.scene import Scene
from gsplat_tpu_torch.train.densify import (add_densification_stats, densify_and_prune,
                                            reset_opacity, reset_opacity_mip, split_noise)
from gsplat_tpu_torch.train.loss import photometric_loss, psnr
from gsplat_tpu_torch.train.metrics import MetricsLogger
from gsplat_tpu_torch.train.optim import (AdamState, adam_update, current_lrs, init_adam_state,
                                          make_lr_fns)


class Printer:
    """Timestamped logger (reference src/utils/train_utils.cpp:13-32, with the
    quiet logic un-inverted)."""

    def __init__(self, quiet: bool = False):
        self.quiet = quiet

    def print(self, msg: str) -> None:
        if not self.quiet:
            ts = time.strftime("%Y-%m-%d %H:%M:%S")
            print(f"[{ts}] {msg}", flush=True)


def initialize_random_seed(seed: int = 0) -> None:
    """Reference src/utils/train_utils.cpp:34-48: Python's and numpy's global
    generators (the loop's own torch.Generator is seeded in train)."""
    random.seed(seed)
    np.random.seed(seed)


def prepare_output_and_logger(model: ModelParams, all_params) -> Path:
    """Output dir + cfg_args persistence (reference train_utils.cpp:52-93)."""
    path = model.model_path
    if not path:
        path = time.strftime("./output/%Y-%m-%dT%H-%M-%S")
        model.model_path = path
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    (out / "cfg_args").write_text(cfg_args_string(model))
    with open(out / "params.txt", "w") as f:
        for p in all_params:
            print_params(p, out=f)
    return out


def make_train_step(
    opt: OptimizationParams,
    mesh: MeshParams,
    spatial_lr_scale: float,
    width: int,
    height: int,
    pair_budget: Optional[int] = None,
    contrib_budget: Optional[int] = None,
    sat_budget: Optional[int] = None,
    kept_budget: Optional[int] = None,
) -> Callable:
    """The train step for a fixed camera resolution. pair_budget overrides
    mesh.pair_budget; contrib_budget / kept_budget / sat_budget override
    what the mesh fractions give.

    train_step(g, opt_state, cam, bg, step, ema) -> (g_new, opt_state_new,
    loss, ema_new, n_pairs, n_dropped, n_culled, n_contrib, n_sat), the
    reference's nine outputs (n_sat is 0 with the saturation cull off). The
    target image is cam.image; step is the 1-based iteration (an int) the
    LR schedule reads; ema is the previous EMA of the loss (a tensor or a
    float; ignored at step 1). on_stage(name), if given, is called after
    each stage (render's forward stages, then "loss", "backward", "adam",
    "densify_stats") so a caller can time them: each stage is a span of
    gsplat_tpu_torch.spans under the step's root span ("step")."""
    lr_fns = make_lr_fns(opt, spatial_lr_scale)
    b = budgets.resolve(mesh, pair_budget, kept_budget, contrib_budget, sat_budget)

    def train_step(g: Gaussians, opt_state: AdamState, cam: Camera, bg: torch.Tensor,
                   step: int, ema, on_stage: Optional[Callable[[str], None]] = None):
        with spans.span("step", root=True):
            step = int(step)
            params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
            offset = torch.zeros((g.capacity, 2), dtype=torch.float32, device=g.device,
                                 requires_grad=True)
            with torch.enable_grad():
                out = render(cam, g.replace(**params), bg, tile_size=mesh.tile_size,
                             chunk=mesh.chunk_size, mean2d_offset=offset, on_stage=on_stage,
                             **b.kwargs())
                with spans.span("loss", on_stage):
                    loss = photometric_loss(out.image, cam.image, opt.lambda_dssim)
                with spans.span("backward", on_stage, adopt=True):
                    grads = torch.autograd.grad(loss, list(params.values()) + [offset])
            pgrads = dict(zip(params, grads[:-1]))
            loss = loss.detach()
            with spans.span("adam", on_stage):
                lrs = current_lrs(lr_fns, step)
                new_params, new_opt_state = adam_update(
                    {k: v.detach() for k, v in params.items()}, pgrads, opt_state, lrs)
            with spans.span("densify_stats", on_stage):
                g_new = add_densification_stats(g.replace(**new_params), grads[-1],
                                                out.radii, width, height)
            # the EMA stays on the device: no host sync per iteration
            new_ema = loss if step <= 1 else 0.4 * loss + 0.6 * ema
        return (g_new, new_opt_state, loss, new_ema, out.n_pairs, out.n_dropped,
                out.n_culled, out.n_contrib, out.n_sat)

    return train_step


@torch.no_grad()
def _sat_probe(g: Gaussians, cam: Camera, bg: torch.Tensor, *, tile_size: int, chunk: int,
               pair_budget: int):
    """One render with a sat budget that cannot overflow, for its telemetry
    only -> (n_sat, n_pairs, n_culled, n_dropped): n_sat is the chunk-aligned
    rows the saturation bound cull keeps (prefix_sum_small and compact_runs
    on CUDA)."""
    out = render(cam, g, bg, tile_size=tile_size, chunk=chunk, pair_budget=pair_budget,
                 sat_budget=pair_budget)
    return out.n_sat, out.n_pairs, out.n_culled, out.n_dropped


@torch.no_grad()
def _gui_render(g: Gaussians, cam: Camera, bg: torch.Tensor, scaling_modifier: float, *,
                tile_size: int, chunk: int, pair_budget: int) -> torch.Tensor:
    """A network-GUI view: the request's scaling_modifier at the loop's
    tile, chunk and pair budget (no kept, contrib or sat budget, as in the
    reference)."""
    return render(cam, g, bg, tile_size=tile_size, chunk=chunk, pair_budget=pair_budget,
                  scaling_modifier=scaling_modifier).image


def _serve_gui_request(viewer: NetworkGUIServer, req: GuiRequest, g: Gaussians,
                       bg: torch.Tensor, mesh: MeshParams, pair_budget: int) -> None:
    """Render one network-GUI view on the training thread and unblock its
    connection. Best-effort, as in the reference: a render that raises gets
    no image, and training goes on; the exception is printed (one line) and
    counted in viewer.render_errors. It draws from no generator and changes
    no budget, so a served request leaves training as it was. Under a
    profiler the request is a root span ("gui.request") over its camera,
    render and bytes, which counts its wait in the server's queue
    (queue_ms: from the connection thread's receipt to this call)."""
    img_bytes = None
    with spans.span("gui.request", root=True) as sp:
        if sp is not None and req.received_ns:
            sp.count(queue_ms=(sp.t0 - req.received_ns) * 1e-6)
        try:
            if req.world_view is not None:
                cam = camera_from_request(req, g.device)
                img = _gui_render(g, cam, bg, req.scaling_modifier,
                                  tile_size=mesh.tile_size, chunk=mesh.chunk_size,
                                  pair_budget=pair_budget)
                img_bytes = image_to_bytes(img)
        except Exception as e:  # a bad request must not end training
            viewer.render_errors += 1
            print(f"network GUI: render failed ({type(e).__name__}: {e}); no image sent",
                  flush=True)
    req.reply(img_bytes)


@torch.no_grad()
def eval_render(g: Gaussians, cam: Camera, bg: torch.Tensor, *, tile_size: int, chunk: int,
                pair_budget: int) -> torch.Tensor:
    return render(cam, g, bg, tile_size=tile_size, chunk=chunk,
                  pair_budget=pair_budget).image


@torch.no_grad()
def eval_step(g: Gaussians, cam: Camera, bg: torch.Tensor, *, lambda_dssim: float,
              tile_size: int, chunk: int, pair_budget: int):
    out = render(cam, g, bg, tile_size=tile_size, chunk=chunk, pair_budget=pair_budget)
    return (photometric_loss(out.image, cam.image, lambda_dssim),
            psnr(out.image, cam.image), out.n_dropped)


def mip_filter(g: Gaussians, cams: Tuple[torch.Tensor, float]) -> Gaussians:
    """g with its Mip-Splatting 3D filter computed over the cameras
    (`cams`: filter3d.camera_table's table and focal), a span "filter3d"
    under a profiler."""
    table, focal = cams
    with spans.span("filter3d") as sp:
        f, _ = filter3d(g.xyz, g.n_live.to(torch.int32), table, focal)
        if sp is not None:
            sp.count(rows=g.n_live, cameras=table.shape[0])
    return g.replace(filter_3d=f)


def draw_background(gen: torch.Generator) -> torch.Tensor:
    """A random background, (3,) float32 uniform in [0, 1) on the
    generator's device (the reference's jax.random.uniform(key, (3,)))."""
    return torch.rand(3, generator=gen, dtype=torch.float32, device=gen.device)


def resolve_mesh(mesh: MeshParams) -> MeshParams:
    """The mesh shape train() runs, one process a mesh cell: data_axis -1
    takes world // tile_axis, and the world (the process group's size, 1
    without one) must be exactly data_axis * tile_axis ranks."""
    world, _ = world_info()
    if mesh.num_processes > 1 and world != mesh.num_processes:
        raise ValueError(
            f"num_processes {mesh.num_processes} but a world of {world} rank(s): join the "
            "process group first (dist.mesh.initialize_distributed; the CLI does)")
    if mesh.data_axis == -1:
        if world % mesh.tile_axis:
            raise ValueError(f"world of {world} ranks is no multiple of tile_axis "
                             f"{mesh.tile_axis}")
        mesh = dataclasses.replace(mesh, data_axis=world // mesh.tile_axis)
    if mesh.data_axis * mesh.tile_axis != world:
        raise ValueError(
            f"mesh {mesh.data_axis}x{mesh.tile_axis} over {world} rank(s): the port runs "
            "one process a mesh cell, so the world size must equal data_axis * tile_axis")
    return mesh


def _agree(dev_mesh, device: torch.device, *values) -> List[int]:
    """The MAX over the world of each integer (one all-gather of a vector on
    the rank's device): a decision that sizes a buffer is taken alike on
    every rank."""
    if dev_mesh is None or not dev_mesh.distributed:
        return [int(v) for v in values]
    vec = torch.tensor([int(v) for v in values], dtype=torch.int64, device=device)
    every = collectives.all_gather_rows(vec[None], dev_mesh.world_group, "counts")
    return [int(x) for x in every.max(dim=0).values]


def train(
    model: ModelParams,
    opt: OptimizationParams,
    pipe: PipelineParams,
    other: OtherParams,
    mesh: MeshParams,
    *,
    progress_every: int = 100,
) -> Tuple[Gaussians, Scene]:
    """The full training entry point (reference train_utils.cpp:97-146,
    completed), on model.data_device (CUDA unless named). On a mesh every
    rank runs it (the same seeds give the same camera picks and draws);
    rank 0 alone prints and writes."""
    resolve_device(model.data_device)
    if model.mip_splatting and (mesh.data_axis, mesh.tile_axis) != (1, 1):
        raise ValueError("--mip_splatting runs on one device (data_axis 1, tile_axis 1): "
                         "the mesh's steps and gathers do not carry the 3D filter")
    mesh = resolve_mesh(mesh)
    world, rank = world_info()
    is_main = rank == 0
    printer = Printer(other.quiet or not is_main)
    if is_main:
        out_dir = prepare_output_and_logger(model, (model, opt, pipe, other, mesh))
    else:
        out_dir = Path(model.model_path or ".")
    printer.print(f"Output folder: {out_dir}")

    scene = Scene(model, capacity=mesh.capacity)
    g = scene.gaussians
    printer.print(
        f"Loaded scene: {len(scene.get_train_cameras())} train / "
        f"{len(scene.get_test_cameras())} test cameras, "
        f"{int(g.n_live)} initial Gaussians (capacity {g.capacity}), "
        f"extent {scene.cameras_extent:.3f}"
    )
    device = g.device

    opt_state = init_adam_state(g.params())
    first_iter = 0
    resume_extras: dict = {}
    if other.start_checkpoint:
        g, opt_state, first_iter = load_checkpoint(other.start_checkpoint, mesh.capacity,
                                                   device=device)
        resume_extras = load_checkpoint_extras(other.start_checkpoint)
        printer.print(f"Restored checkpoint {other.start_checkpoint} at iter {first_iter}")

    bg = torch.tensor([1.0, 1.0, 1.0] if model.white_background else [0.0, 0.0, 0.0],
                      dtype=torch.float32, device=device)

    train_cams = scene.get_train_cameras()
    w, h = train_cams[0].width, train_cams[0].height
    mip_cams = camera_table(train_cams, device) if model.mip_splatting else None
    if mip_cams is not None:
        g = mip_filter(g, mip_cams)
    policy = budgets.BudgetPolicy(mesh, resume_extras)
    spmd = mesh.data_axis * mesh.tile_axis > 1
    sharded = spmd and mesh.shard_gaussians
    if mesh.shard_gaussians and not spmd:
        printer.print("--shard_gaussians ignored on a 1-device mesh")
    dev_mesh = None
    if spmd:
        dev_mesh = make_mesh(data=mesh.data_axis, tile=mesh.tile_axis)
        printer.print(
            f"SPMD: {mesh.data_axis}-camera batches x {mesh.tile_axis} tile bands"
            + (" (ZeRO-sharded Gaussians)" if sharded else "")
            + f" over {world} processes, one a mesh cell; {backend_banner()}")
        if sharded and g.capacity % mesh.data_axis != 0:
            raise ValueError(
                f"--shard_gaussians needs capacity % data_axis == 0 "
                f"(got {g.capacity} % {mesh.data_axis})")
        if sharded:
            g, opt_state = shard_gaussians(dev_mesh, g, opt_state)
        else:
            g, opt_state = replicate_gaussians(dev_mesh, g, opt_state)

    # sharded: the step keeps every (CAP, ...) leaf sharded over `data`; the
    # infrequent whole-model operations (densify, the opacity reset, eval,
    # checkpoints, PLYs, the sat probe) gather it on every rank (a
    # collective), run the replicated path's code and shard it again
    def to_host_view(g_, opt_state_=None):
        if not sharded:
            return g_ if opt_state_ is None else (g_, opt_state_)
        return gather_gaussians(dev_mesh, g_, opt_state_)

    def to_step_view(g_, opt_state_):
        if not sharded:
            return g_, opt_state_
        return shard_gaussians(dev_mesh, g_, opt_state_)

    def capacity(g_) -> int:
        """The model's capacity (a shard holds 1 / data_axis of it)."""
        return g_.capacity * (mesh.data_axis if sharded else 1)

    def build_step(b: budgets.Budgets):
        if sharded:
            return make_sharded_spmd_train_step(dev_mesh, opt, mesh, g.spatial_lr_scale,
                                                w, h, **b.kwargs())
        if spmd:
            return make_spmd_train_step(dev_mesh, opt, mesh, g.spatial_lr_scale, w, h,
                                        **b.kwargs())
        return make_train_step(opt, mesh, g.spatial_lr_scale, w, h, **b.kwargs())

    train_step = built = None       # the step, and the budgets it was built at

    metrics = MetricsLogger(model.model_path if is_main else None)
    # the live viewer and the SIBR network GUI on --ip/--port: best-effort,
    # silent on a port conflict; one port, HTTP requests get the browser
    # preview, anything else speaks upstream's network_gui wire format. Off
    # on a mesh of more than one process, as in the reference.
    viewer = None
    if not other.quiet and world == 1:
        viewer = NetworkGUIServer(Path(out_dir), other.ip, other.port,
                                  verify=model.source_path)
        if viewer.url:
            printer.print(f"viewer: {viewer.url}")

    rng = torch.Generator(device=device)
    rng.manual_seed(0)
    cam_order: List[int] = []
    ema_loss = torch.zeros((), dtype=torch.float32, device=device)
    # exact resume: restore every loop-level generator and cursor the step
    # sequence depends on: the torch generator, Python's `random` state that
    # drives the camera shuffles, the unconsumed camera order, EMA (the
    # budgets and their streak: the policy)
    if resume_extras:
        if "torch_rng" in resume_extras:
            rng.set_state(torch.from_numpy(np.array(resume_extras["torch_rng"], np.uint8)))
        elif "rng_key" in resume_extras:
            printer.print(
                "checkpoint of the JAX package: parameters, moments, step, budgets, camera "
                "order, Python random state, EMA and streak restored; its JAX PRNG key has "
                "no torch counterpart, so the draws restart from seed 0")
        if "cam_order" in resume_extras:
            cam_order = [int(i) for i in resume_extras["cam_order"]]
        if "ema_loss" in resume_extras:
            ema_loss = torch.tensor(float(resume_extras["ema_loss"]), dtype=torch.float32,
                                    device=device)
        if "py_random" in resume_extras:
            random.setstate(pickle.loads(resume_extras["py_random"].tobytes()))

    def loop_extras() -> dict:
        extras = policy.extras()
        streak = extras.pop("low_usage_streak")
        return {
            "torch_rng": rng.get_state().numpy(),
            "ema_loss": np.asarray(float(ema_loss), np.float32),
            **extras,
            "cam_order": np.asarray(cam_order, np.int64),
            "low_usage_streak": streak,
            "py_random": np.frombuffer(pickle.dumps(random.getstate()), np.uint8).copy(),
        }

    profiler = None
    t0 = time.time()
    iteration = first_iter

    try:
        for iteration in range(first_iter + 1, opt.iterations + 1):
            with spans.span("iteration", root=True):
                # network-GUI round trips at the loop's top (upstream train.py's
                # order): render every pending viewer camera; while the viewer
                # has paused training (train=False, keep_alive), keep serving
                # until it resumes or disconnects
                if viewer is not None and viewer.url:
                    while True:
                        req = viewer.poll()
                        if req is None:
                            if viewer.training_paused and viewer.sibr_connected:
                                time.sleep(0.02)
                                continue
                            viewer.training_paused = False
                            break
                        _serve_gui_request(viewer, req, g, bg, mesh, policy.pair)
                        viewer.training_paused = not req.do_training and req.keep_alive

                # SH degree annealing every 1000 iters (reference gaussian_model.cpp:307-313)
                if iteration % 1000 == 0:
                    g = g.oneup_sh_degree()

                picks = []
                for _ in range(mesh.data_axis if spmd else 1):
                    if not cam_order:
                        cam_order = list(range(len(train_cams)))
                        random.shuffle(cam_order)
                    picks.append(train_cams[cam_order.pop()])
                cam = picks[0]

                step_bg = draw_background(rng) if opt.random_background else bg

                # --profile_dir: a torch.profiler trace of steady-state steps
                if mesh.profile_dir and is_main and iteration == 20:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
                    profiler = profile(activities=acts)
                    profiler.start()
                if profiler is not None and iteration == 20 + mesh.profile_steps:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profiler.stop()
                    Path(mesh.profile_dir).mkdir(parents=True, exist_ok=True)
                    trace = Path(mesh.profile_dir) / f"trace_iter20-{iteration}.json"
                    profiler.export_chrome_trace(str(trace))
                    profiler = None
                    printer.print(f"profiler trace written to {trace}")

                if policy.budgets != built:
                    built = policy.budgets
                    train_step = build_step(built)
                (g, opt_state, loss, ema_loss, n_pairs, n_dropped, n_culled,
                 n_contrib, n_sat) = train_step(
                    g, opt_state, global_camera_batch(dev_mesh, picks) if spmd else cam,
                    step_bg, iteration, ema_loss)

                # --- the adaptive budgets, checked every 10 iterations only:
                # the counters' one read is a host sync; a short lag of
                # dropped-pair steps is harmless. A change rebuilds the step ---
                lines = []
                if iteration % 10 == 0:
                    lines = policy.check(iteration, *torch.stack([c.to(torch.int64) for c in (
                        n_pairs, n_dropped, n_culled, n_contrib, n_sat)]).tolist())
                if (iteration % mesh.sat_probe_interval == 0
                        and policy.probes_sat(capacity(g))):
                    lines += policy.sat_probe(iteration, *_agree(dev_mesh, device, *_sat_probe(
                        to_host_view(g), cam, bg, tile_size=mesh.tile_size,
                        chunk=mesh.chunk_size, pair_budget=policy.pair)))
                for line in lines:
                    printer.print(line)

                # --- logging / eval / save before densify/reset (upstream order:
                # an eval or save on an opacity-reset iteration sees the
                # pre-reset model) ---
                if iteration % progress_every == 0:
                    rate = progress_every / max(time.time() - t0, 1e-9)
                    t0 = time.time()
                    if viewer is not None and viewer.url:
                        viewer.publish(eval_render(
                            g, train_cams[0], bg, tile_size=mesh.tile_size,
                            chunk=mesh.chunk_size, pair_budget=policy.pair))
                    printer.print(
                        f"iter {iteration}/{opt.iterations} loss {float(loss):.5f} "
                        f"ema {float(ema_loss):.5f} gaussians {int(g.n_live)} "
                        f"({rate:.1f} it/s)"
                    )
                    metrics.log(
                        iteration, loss=float(loss), ema_loss=float(ema_loss),
                        n_gaussians=int(g.n_live), capacity=capacity(g),
                        it_per_s=round(rate, 2), n_dropped_pairs=int(n_dropped),
                        n_culled_pairs=int(n_culled),
                        n_contrib_pairs=int(n_contrib),
                        n_sat_pairs=int(n_sat),
                    )

                if iteration in other.test_iterations:
                    g_eval = to_host_view(g)       # a collective: every rank gathers
                    if is_main:
                        evaluate(scene, g_eval, bg, opt, mesh, printer, iteration, metrics,
                                 pair_budget=policy.pair)
                    del g_eval

                if iteration in other.save_iterations:
                    g_save = to_host_view(g)
                    if is_main:
                        printer.print(f"[iter {iteration}] saving point cloud")
                        save_ply(Path(out_dir) / "point_cloud" / f"iteration_{iteration}"
                                 / "point_cloud.ply", g_save)
                    del g_save

                # --- densification (upstream schedule; reference params.h:50-91) ---
                if iteration < opt.densify_until_iter:
                    if (iteration > opt.densify_from_iter
                            and iteration % opt.densification_interval == 0):
                        max_screen = 20.0 if iteration > opt.opacity_reset_interval else 0.0
                        g, opt_state = to_host_view(g, opt_state)
                        with spans.span("densify") as sp:
                            stats = {} if sp is not None else None
                            g, opt_state, dropped = densify_and_prune(
                                g, opt_state, split_noise(rng, g.capacity),
                                max_grad=opt.densify_grad_threshold, min_opacity=0.005,
                                extent=scene.cameras_extent, max_screen_size=max_screen,
                                percent_dense=opt.percent_dense,
                                **({} if stats is None else {"stats": stats}),
                            )
                            if sp is not None:
                                sp.count(**stats, live=g.n_live)
                        dropped, n_live = _agree(dev_mesh, device, dropped, g.n_live)
                        if dropped > 0 or n_live > 0.9 * g.capacity:
                            new_cap = g.capacity * 2
                            printer.print(
                                f"[iter {iteration}] growing capacity {g.capacity} -> {new_cap} "
                                f"(live {n_live}, dropped {dropped})"
                            )
                            with spans.span("grow") as sp:
                                g = grow_capacity(g, new_cap)
                                opt_state = _grow_opt_state(opt_state, new_cap)
                                if sp is not None:
                                    sp.count(capacity=new_cap)
                        if mip_cams is not None:
                            g = mip_filter(g, mip_cams)
                        g, opt_state = to_step_view(g, opt_state)

                    if iteration % opt.opacity_reset_interval == 0 or (
                        model.white_background and iteration == opt.densify_from_iter
                    ):
                        reset = reset_opacity_mip if mip_cams is not None else reset_opacity
                        g, opt_state = to_step_view(*reset(*to_host_view(g, opt_state)))
                elif (mip_cams is not None and iteration % 100 == 0
                        and iteration > opt.densify_until_iter
                        and iteration < opt.iterations - 100):
                    # the published schedule: the filter follows the centres after
                    # densification ends, but not in the last 100 iterations
                    g = mip_filter(g, mip_cams)

                # checkpoint LAST within the iteration (after densify and the
                # optimizer step) so a resume at iteration + 1 is exact
                if iteration in other.checkpoint_iterations:
                    g_ck, opt_ck = to_host_view(g, opt_state)   # gathered on every rank
                    if is_main:
                        printer.print(f"[iter {iteration}] saving checkpoint")
                        save_checkpoint(Path(out_dir) / f"chkpnt{iteration}.npz", g_ck, opt_ck,
                                        iteration, extra=loop_extras())
                    del g_ck, opt_ck

    except KeyboardInterrupt:
        # interrupt recovery: persist an emergency checkpoint so
        # --start_checkpoint can resume exactly here
        # (on a mesh every rank is interrupted: the sharded gather is a
        # collective; rank 0 writes)
        path = Path(out_dir) / f"chkpnt_interrupt_{iteration}.npz"
        printer.print(f"interrupted at iter {iteration}; saving {path}")
        g_ck, opt_ck = to_host_view(g, opt_state)
        if is_main:
            save_checkpoint(path, g_ck, opt_ck, iteration, extra=loop_extras())
        raise
    finally:
        if profiler is not None:
            profiler.stop()
        metrics.close()
        if viewer is not None:
            viewer.close()
    return g, scene


def evaluate(scene: Scene, g: Gaussians, bg: torch.Tensor, opt: OptimizationParams,
             mesh: MeshParams, printer: Printer, iteration: int,
             metrics: Optional[MetricsLogger] = None,
             pair_budget: Optional[int] = None) -> None:
    """Test/train-sample PSNR report (upstream training_report) at the loop's
    current pair budget; dropped pairs are flagged, since they mean the
    reported PSNR understates the model."""
    budget = pair_budget if pair_budget is not None else mesh.pair_budget
    configs = [
        ("test", scene.get_test_cameras()),
        ("train", scene.get_train_cameras()[:5]),
    ]
    for name, cams in configs:
        if not cams:
            continue
        losses, psnrs, dropped = [], [], 0
        for cam in cams:
            l, p, nd = eval_step(g, cam, bg, lambda_dssim=opt.lambda_dssim,
                                 tile_size=mesh.tile_size, chunk=mesh.chunk_size,
                                 pair_budget=budget)
            losses.append(float(l))
            psnrs.append(float(p))
            dropped += int(nd)
        printer.print(
            f"[iter {iteration}] eval {name}: loss {np.mean(losses):.5f} "
            f"PSNR {np.mean(psnrs):.2f}"
            + (f" [WARNING: {dropped} pairs dropped — PSNR understated; "
               f"raise --pair_budget]" if dropped else "")
        )
        if metrics is not None:
            metrics.log(iteration, **{f"{name}_loss": float(np.mean(losses)),
                                      f"{name}_psnr": float(np.mean(psnrs))})


def _grow_opt_state(s: AdamState, new_cap: int) -> AdamState:
    """The Adam moments zero-padded to new_cap rows on their own device."""
    def zpad(a):
        return torch.cat([a, a.new_zeros((new_cap - a.shape[0],) + tuple(a.shape[1:]))])

    return AdamState(mu={k: zpad(v) for k, v in s.mu.items()},
                     nu={k: zpad(v) for k, v in s.nu.items()}, count=s.count)
