"""The `cli` traffic kind: the training CLI over a COLMAP capture.

A mix of this kind (`traffic/<mix>.json` with "kind": "cli") names the
capture's views and their spread, the CLI's flags (the schedule), the
learning rates and the loss's weight (passed as flags too), the budgets'
headroom, the checked steps, the warm-up steps, the window's length in
iterations and the profiled iterations. The configuration names the
scene, the checkpoint's iteration, the noise on its leaves and the seed
they and the capture's poses are drawn from (`scene_seed`); `--seed` draws
the view order and the split samples.

Set-up: the seeded scene and its 3D filter over the views' cameras; the
program's renders of it, both filters on, written as PNGs (stored deflate)
into a binary COLMAP capture with the scene's centres as points3D.bin; the
noisy start state, budgets fitted over every view, and a checkpoint at the
configuration's iteration whose loop state carries the budgets, a seeded
view order and split generator; a few program steps, a densify pass and a
saturation probe, so that every kernel the window runs is built and loaded.
Then `gsplat_tpu_torch.cli.main` resumes from the checkpoint. The window
is the fixed span of `window_iterations` iterations after it, timed by the
host's clock from the step of its first iteration to the step after its
last (where the run is stopped), whatever `--seconds` says.

Observation only, through module attributes the loop looks up at call
time: the train step (its first `checked_steps` inputs and outputs, every
step's dropped pairs and loss, the clock, the profiler's start and stop),
the first densify pass's accumulators and decisions, the 3D filter passes.
After the window the plain reference (`reference_mip.py`, imported only
then: it turns TF32 off) follows the checked steps from the same inputs,
computes the filter over the final centres and the same cameras, and
decides the first densify pass from the same accumulators.
"""

from __future__ import annotations

import json
import math
import pickle
import random
import shutil
import statistics
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from benchmark import faults_mip, scene, trace
from benchmark.harness import (ROUNDOFF, Cell, Reading, StageRecorder, annotate, fit_budgets,
                               leaf_gaps, load_reference, mesh_params, norm,
                               optimization_params, params_per_splat, program_camera,
                               program_gaussians, rel_gap, sync)

SALT_NOISE, SALT_ORDER, SALT_SPLIT = 7, 8, 9


class WindowEnd(Exception):
    """Raised from the step after the window's last iteration: the run ends."""


def ref_cam(cam) -> Dict:
    """The reference's camera dict over a program camera."""
    return {"world_view": cam.world_view, "full_proj": cam.full_proj,
            "cam_center": cam.cam_center, "tan_fovx": cam.tan_fovx, "tan_fovy": cam.tan_fovy,
            "width": cam.width, "height": cam.height}


def start_params(p0: Dict[str, torch.Tensor], cfg: Dict, seed: int) -> Dict[str, torch.Tensor]:
    """The checkpoint's leaves: the scene with the configuration's seeded noise
    on its live rows."""
    n, nz = cfg["n_gaussians"], cfg["start_noise"]
    gen = scene.generator(seed, SALT_NOISE, p0["xyz"].device)
    s0 = math.exp(scene.splat_log_scale(cfg))
    out = {k: v.clone() for k, v in p0.items()}
    for k, sd in (("xyz", nz["xyz"] * s0), ("f_dc", nz["f_dc"]), ("opacity", nz["opacity"]),
                  ("scaling", nz["scaling"]), ("rotation", nz["rotation"])):
        out[k][:n] += sd * torch.randn(out[k][:n].shape, generator=gen, device=out[k].device)
    return out


def write_capture(root: Path, cfg: Dict, views, g, cams, device, out) -> None:
    """A binary COLMAP model of the views under root/sparse/0 and the
    program's renders of g (both filters, black background) as PNGs under
    root/images."""
    from gsplat_tpu_torch.io import colmap, png
    from gsplat_tpu_torch.render.render import render

    w, h = cfg["width"], cfg["height"]
    sparse, images = root / "sparse" / "0", root / "images"
    sparse.mkdir(parents=True)
    images.mkdir(parents=True)
    fx = w / (2.0 * math.tan(cfg["fovx"] / 2.0))
    fy = h / (2.0 * math.tan(cfg["fovy"] / 2.0))
    colmap.write_intrinsics_binary(
        {1: colmap.Camera(id=1, model="PINHOLE", width=w, height=h,
                          params=np.array([fx, fy, w / 2.0, h / 2.0]))},
        sparse / "cameras.bin")
    imgs = {}
    for i, (yaw, pitch) in enumerate(views, start=1):
        imgs[i] = colmap.Image(
            id=i, qvec=colmap.rotmat2qvec(scene.view_rotation(yaw, pitch)),
            tvec=np.array([0.0, 0.0, cfg["z_mean"]]), camera_id=1, name=f"view_{i:03d}.png",
            xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64))
    colmap.write_extrinsics_binary(imgs, sparse / "images.bin")
    n = cfg["n_gaussians"]
    xyz = g.xyz[:n].double().cpu().numpy()
    rgb = (torch.clamp(0.5 + 0.28209479177387814 * g.f_dc[:n], 0.0, 1.0) * 255.0 + 0.5)
    colmap.write_points3D_binary(xyz, rgb.to(torch.uint8).cpu().numpy(), np.zeros(n),
                                 sparse / "points3D.bin")
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    dropped = 0

    def encode(arr, name):
        (images / name).write_bytes(png.encode_png(arr, filters=png.NONE, level=0))

    with ThreadPoolExecutor(4) as pool, torch.no_grad():
        jobs = []
        for i, cam in enumerate(cams, start=1):
            r = render(cam, g, bg, tile_size=cfg["tile_size"], chunk=cfg["chunk"],
                       pair_budget=cfg["pair_budget"])
            dropped += int(r.n_dropped)
            arr = (torch.clamp(r.image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
            jobs.append(pool.submit(encode, arr, imgs[i].name))
        for j in jobs:
            j.result()
    if dropped:
        raise RuntimeError(f"the capture's renders dropped {dropped} pairs")
    out(f"bench: capture of {len(cams)} views written under {root}")


def write_checkpoint(path: Path, g, budgets: Dict, seed: int, n_views: int, iteration: int,
                     device) -> None:
    """The start state with a fresh Adam state and the loop's resume state:
    the fitted budgets, a seeded view order (Python's random state and the
    unconsumed order) and a seeded split generator."""
    from gsplat_tpu_torch.ckpt import save_checkpoint
    from gsplat_tpu_torch.train.optim import init_adam_state

    rng = random.Random(int(scene.host_rng(seed, SALT_ORDER).integers(1 << 62)))
    order = list(range(n_views))
    rng.shuffle(order)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(scene.host_rng(seed, SALT_SPLIT).integers(1 << 62)))
    extra = {"torch_rng": gen.get_state().numpy(), "ema_loss": np.asarray(0.0, np.float32),
             "pair_budget": np.asarray(budgets["pair"], np.int64),
             "kept_budget": np.asarray(budgets["kept"], np.int64),
             "contrib_budget": np.asarray(budgets["contrib"], np.int64),
             "cam_order": np.asarray(order, np.int64),
             "low_usage_streak": np.asarray(0, np.int64),
             "py_random": np.frombuffer(pickle.dumps(rng.getstate()), np.uint8).copy()}
    save_checkpoint(path, g, init_adam_state(g.params()), iteration, extra=extra)


class Observer:
    """The window's clock and what the run observes of the loop (module
    attributes of gsplat_tpu_torch.train.loop, patched for the run)."""

    def __init__(self, tr: Dict, first: int, traced: bool, device):
        from gsplat_tpu_torch.train import loop

        self.loop, self.tr, self.device = loop, tr, device
        self.first, self.last = first, first + tr["window_iterations"] - 1
        self.prof_first, self.prof_last = tr["profile_iterations"]
        self.traced = traced
        self.rec = StageRecorder() if traced and device.type == "cuda" else None
        self.prof = self.ann = self.summary = None
        self.t0 = self.t1 = None
        self.paused = 0.0
        self.traced_s = self.traced_units = None
        self.checked, self.images = [], []
        self.losses, self.dropped = [], None
        self.densify, self.capacities, self.filter_rows = [], [], []
        self.filter_passes = 0
        self.final = self.scene = self.last_filter = None

    # -- the profiler over a span of iterations, its start and stop off the clock

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        sync(self.device)
        self.ann = torch.profiler.record_function(trace.WINDOW)
        self.ann.__enter__()
        self.paused += time.perf_counter() - t
        self.tp0 = time.perf_counter()

    def _stop_profile(self) -> None:
        sync(self.device)
        t = time.perf_counter()
        self.traced_s = t - self.tp0
        self.traced_units = self.prof_last - self.prof_first + 1
        self.ann.__exit__(None, None, None)
        self.prof.stop()
        self.summary = trace.export_and_summarize(self.prof)
        self.prof = None
        self.paused += time.perf_counter() - t

    def window_s(self) -> float:
        return self.t1 - self.t0 - self.paused

    # -- the patched attributes

    def make_train_step(self, orig):
        def make(*a, **k):
            step = orig(*a, **k)

            def observed(g, opt_state, cam, bg, it, ema, on_stage=None):
                return self.step(step, g, opt_state, cam, bg, int(it), ema)
            return observed
        return make

    def step(self, step, g, opt_state, cam, bg, it, ema):
        if it == self.first:
            sync(self.device)
            self.t0 = time.perf_counter()
            self.dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        if self.traced and it == self.prof_first:
            self._start_profile()
        if self.traced and it == self.prof_last + 1:
            self._stop_profile()
        if it == self.last + 1:
            sync(self.device)
            self.t1 = time.perf_counter()
            self.final = {"n_live": int(g.n_live), "capacity": g.capacity}
            raise WindowEnd()
        k = it - self.first
        checked = 0 <= k < self.tr["checked_steps"]
        if checked:
            self.checked.append({"cam": cam, "bg": bg.clone(), "it": it})
            if k == 0:
                self.checked[0].update(params={n: v.clone() for n, v in g.params().items()},
                                       n_live=int(g.n_live), deg=g.active_sh_degree,
                                       extent=float(g.spatial_lr_scale),
                                       filter=None if g.filter_3d is None
                                       else g.filter_3d.clone())
        rec = self.rec if (self.rec is not None and it >= self.first) else None
        spy = checked and k == 0
        if spy:
            orig_loss = self.loop.photometric_loss

            def loss_spy(pred, gt, lam=0.2):
                self.images.append(pred.detach().clone())
                return orig_loss(pred, gt, lam)
            self.loop.photometric_loss = loss_spy
        try:
            with annotate(self.traced, "bench.step"):
                if rec is not None:
                    rec.begin()
                out = step(g, opt_state, cam, bg, it, ema, on_stage=rec)
                if rec is not None:
                    rec.end()
        finally:
            if spy:
                self.loop.photometric_loss = orig_loss
        if it >= self.first:
            self.losses.append(out[2])
            self.dropped += out[5].to(torch.int64)
            self.capacities.append(g.capacity)
        if checked:
            self.checked[k]["loss"] = out[2]
            self.checked[k]["dropped"] = out[5]
            if k == 0:
                self.checked[0]["mu"] = {n: v.clone() for n, v in out[1].mu.items()}
            if k == self.tr["checked_steps"] - 1:
                self.checked[k]["params_after"] = {n: v.clone()
                                                   for n, v in out[0].params().items()}
        return out

    def densify_and_prune(self, orig):
        def densify(g, opt_state, noise, **kw):
            first = not self.densify
            if first:
                snap = {"accum": g.xyz_gradient_accum.clone(), "denom": g.denom.clone(),
                        "max_radii": g.max_radii2D.clone(), "scaling": g.scaling.clone(),
                        "opacity": g.opacity.clone(), "n_live": int(g.n_live),
                        "kw": {k: v for k, v in kw.items() if k != "stats"}}
                if kw.get("stats") is None:
                    kw["stats"] = {}
            out = orig(g, opt_state, noise, **kw)
            if first:
                snap["stats"] = kw["stats"]
                self.densify.append(snap)
            else:
                self.densify.append(None)
            return out
        return densify

    def mip_filter(self, orig):
        def mip_filter(g, cams):
            out = orig(g, cams)
            self.filter_passes += 1
            # the last pass's centres and filter (the loop replaces, never edits, a leaf)
            self.last_filter = (out.xyz, out.n_live, out.filter_3d)
            if self.prof is not None:
                self.filter_rows.append((g.n_live, cams[0].shape[0]))
            return out
        return mip_filter

    def scene_of(self, orig):
        def scene_of(*a, **k):
            self.scene = orig(*a, **k)
            return self.scene
        return scene_of

    @property
    def train_cameras(self):
        """The program's training cameras as the CLI loaded them."""
        return self.scene.get_train_cameras()

    def __enter__(self):
        self.saved = {n: getattr(self.loop, n) for n in ("make_train_step", "densify_and_prune",
                                                         "mip_filter", "Scene")}
        self.loop.Scene = self.scene_of(self.saved["Scene"])
        self.loop.make_train_step = self.make_train_step(self.saved["make_train_step"])
        self.loop.densify_and_prune = self.densify_and_prune(self.saved["densify_and_prune"])
        self.loop.mip_filter = self.mip_filter(self.saved["mip_filter"])
        return self

    def __exit__(self, *exc):
        for n, v in self.saved.items():
            setattr(self.loop, n, v)
        if self.prof is not None:
            self.prof.stop()
            self.prof = None
        return False


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        out: Callable[[str], None]) -> Dict:
    from gsplat_tpu_torch import cli
    from gsplat_tpu_torch.render.filter3d import camera_table, filter3d
    from gsplat_tpu_torch.train import loop
    from gsplat_tpu_torch.train.densify import densify_and_prune, split_noise
    from gsplat_tpu_torch.train.optim import init_adam_state

    cfg, tr = cell.config, cell.traffic
    w, h = cfg["width"], cfg["height"]
    first = cfg["start_iteration"] + 1
    # the capture (its poses, scene and start state) is the configuration's;
    # --seed draws the view order and the split samples
    views = scene.train_views(cfg["scene_seed"], tr["views"], tr["yaw_deg"], tr["pitch_deg"])
    mats = [scene.view_matrices(cfg, *v) for v in views]
    extent = scene.camera_extent(cfg, views)
    cams = [program_camera(m, cfg, device) for m in mats]
    table, focal = camera_table(cams, device)
    p0 = scene.build_params(cfg, cfg["scene_seed"], device)
    g = program_gaussians(p0, cfg, extent)
    g = g.replace(filter_3d=filter3d(g.xyz, g.n_live, table, focal)[0])
    work_dir = Path(tempfile.mkdtemp(prefix="bench_capture_"))
    try:
        write_capture(work_dir / "capture", cfg, views, g, cams, device, out)
        ps = start_params(p0, cfg, cfg["scene_seed"])
        del p0
        g = program_gaussians(ps, cfg, extent)
        g = g.replace(filter_3d=filter3d(g.xyz, g.n_live, table, focal)[0])
        t_fit = time.perf_counter()
        budgets = fit_budgets(g, cams, cfg, tr["slack"], device)
        out(f"bench: budgets pair {budgets['pair']} kept {budgets['kept']} contrib "
            f"{budgets['contrib']} (probe maxima {json.dumps(budgets['probe'])}) in "
            f"{time.perf_counter() - t_fit!r} s")
        write_checkpoint(work_dir / "start.npz", g.replace(filter_3d=None), budgets, seed,
                         len(views), cfg["start_iteration"], device)
        # what the window runs, built and loaded before it (the card loads a
        # kernel's module at its first launch): steps, a densify pass, the
        # saturation cull's probe
        step_fn = loop.make_train_step(optimization_params(tr), mesh_params(cfg), extent, w, h,
                                       pair_budget=budgets["pair"],
                                       contrib_budget=budgets["contrib"],
                                       kept_budget=budgets["kept"])
        opt_state = init_adam_state(g.params())
        target = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
        bg = torch.zeros(3, dtype=torch.float32, device=device)
        for i in range(tr["warmup_steps"]):
            cam = program_camera(mats[i], cfg, device, target)
            g, opt_state = step_fn(g, opt_state, cam, bg, first, 0.0)[:2]
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        densify_and_prune(g, opt_state, split_noise(gen, g.capacity), max_grad=2e-4,
                          min_opacity=0.005, extent=extent, max_screen_size=20.0,
                          percent_dense=0.01, stats={})
        loop._sat_probe(g, cam, bg, tile_size=cfg["tile_size"], chunk=cfg["chunk"],
                        pair_budget=budgets["pair"])
        sync(device)
        del g, opt_state, step_fn, target, cams, table, mats, cam
        start = {k: v.clone() for k, v in ps.items()}
        del ps
        out(f"bench: set-up before the CLI done at {time.perf_counter() - t_start!r} s")

        argv = ["-s", str(work_dir / "capture"), "-m", str(work_dir / "model"),
                "--start_checkpoint", str(work_dir / "start.npz"),
                "--capacity", str(cfg["capacity"]), "--pair_budget", str(cfg["pair_budget"]),
                "--tile_size", str(cfg["tile_size"]), "--chunk_size", str(cfg["chunk"]),
                "--sh_degree", str(cfg["sh_degree"]), "--lambda_dssim", str(tr["lambda_dssim"]),
                "--data_device", device.type,
                *[a for k, v in tr["lr"].items() for a in (f"--{k}", str(v))],
                *[a for a in tr["flags"]
                  if not (faults_mip.CONTROL["control"] and a == "--mip_splatting")]]
        obs = Observer(tr, first, traced, device)
        with obs:
            try:
                cli.main(argv)
            except WindowEnd:
                pass
            else:
                raise RuntimeError("the CLI ended before the window's last iteration")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    steps = tr["window_iterations"]
    window_s = obs.window_s()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    losses = torch.stack(obs.losses).double().tolist()
    dropped = int(obs.dropped)
    grew = sorted(set(obs.capacities))
    nonfinite = sum(not math.isfinite(x) for x in losses)
    out(f"bench: window {steps} iterations in {window_s!r} s; densify passes "
        f"{len(obs.densify)}, filter passes {obs.filter_passes}, capacities {grew} (final "
        f"{obs.final['capacity']}, live {obs.final['n_live']}); dropped pairs {dropped}; "
        f"losses first {losses[0]!r} last {losses[-1]!r}")
    # a step with dropped pairs is the loop's cue to regrow its budgets (its
    # gradient is zeroed): counted and printed, not failed
    result = {"attempted": steps, "failed": nonfinite, "peak": peak,
              "metrics": {"setup_s": obs.t0 - t_start,
                          "train_step_ms": window_s * 1e3 / steps}}
    del obs.losses
    if device.type == "cuda":
        torch.cuda.empty_cache()

    reference = load_reference(cfg)
    if traced:
        train_cams = obs.train_cameras
        sample = scene.host_rng(seed, scene.SALT_SAMPLE).choice(
            len(train_cams), size=min(tr["work_sample"], len(train_cams)), replace=False)
        rcams = [ref_cam(train_cams[i]) for i in sample]
        filt0, _ = reference.filter_3d(start["xyz"], cfg["n_gaussians"],
                                       [ref_cam(c) for c in train_cams])
        wk: Dict[str, float] = {}
        bg = torch.zeros(3, dtype=torch.float32, device=device)
        for rc in rcams:
            _, one = reference.render(start, rc, bg, n_live=cfg["n_gaussians"],
                                      sh_degree=cfg["sh_degree"], tile_size=cfg["tile_size"],
                                      chunk=cfg["chunk"], count_work=True, filt=filt0)
            for k, v in one.items():
                wk[k] = wk.get(k, 0) + v / len(rcams)
        fw = [reference.filter_work(int(rows), cams_n) for rows, cams_n in obs.filter_rows]
        wk["filter3d_ops"] = sum(x["ops"] for x in fw)
        wk["filter3d_bytes"] = sum(x["bytes"] for x in fw)
        out(f"bench: reference work a step (mean of {len(rcams)} views) and the profiled "
            f"filter passes: {json.dumps(wk)}")
        result["reading"] = Reading(
            stages=obs.rec.stages() if obs.rec else {}, trace=obs.summary,
            traced_units=obs.traced_units,
            unit_seconds=obs.traced_s / obs.traced_units if obs.traced_units else None,
            work=wk, pixels=w * h, live=cfg["n_gaussians"],
            params_per_splat=params_per_splat(cfg))
    result["checks"] = checks(obs, reference, start, cfg, tr, out)
    result["failed"] += int(sum(int(c["dropped"]) for c in obs.checked) > 0)
    result["checks"]["failed_steps"] = result["failed"]
    return result


def checks(obs: Observer, reference, start: Dict, cfg: Dict, tr: Dict, out) -> Dict:
    """The compared numbers: the checked steps against the reference's, the
    final filter against the reference's over the same centres and cameras,
    the first densify pass's decisions against the reference's."""
    device = start["xyz"].device
    c0 = obs.checked[0]
    cams = [ref_cam(c) for c in obs.train_cameras]
    n0 = c0["n_live"]
    filt0, _ = reference.filter_3d(start["xyz"], n0, cams)
    rp, state = {k: v.clone() for k, v in start.items()}, reference.adam_init(start)
    loss_gaps, rms = [], []
    g1_ref, mask = None, {}
    t_ref = time.perf_counter()
    for i, c in enumerate(obs.checked):
        rp, state, loss_r, img_r, grads = reference.train_step(
            rp, state, ref_cam(c["cam"]), c["cam"].image, c["bg"], c["it"], n_live=n0,
            sh_degree=c0["deg"], tile_size=cfg["tile_size"], lam=tr["lambda_dssim"],
            lr=tr["lr"], extent=c0["extent"], filt=filt0, chunk=cfg["chunk"])
        if i == 0:
            g1_ref = {k: norm(v) for k, v in grads.items()}
            mask = {k: v.abs() >= ROUNDOFF * v.abs().max() for k, v in grads.items()}
            rms.append(float((obs.images[0] - img_r).double().pow(2).mean().sqrt()))
        del grads
        loss_gaps.append(rel_gap(float(c["loss"]), loss_r, abs(loss_r)))
    g1_prog = {k: norm(v / (1.0 - tr["adam_b1"])) for k, v in c0["mu"].items()}
    med = statistics.median(g1_ref.values())
    moved = [k for k in g1_ref if g1_ref[k] >= 1e-3 * med]
    after = obs.checked[-1]["params_after"]
    ch_prog = {k: norm((after[k] - start[k])[mask[k]]) for k in moved}
    ch_ref = {k: norm((rp[k] - start[k])[mask[k]]) for k in moved}
    out(f"bench: reference {len(obs.checked)} steps in {time.perf_counter() - t_ref!r} s; "
        f"losses {[float(c['loss']) for c in obs.checked]}; image rms {rms}")
    out(f"bench: first-gradient norms program {json.dumps(g1_prog)} reference "
        f"{json.dumps(g1_ref)}; change norms program {json.dumps(ch_prog)} reference "
        f"{json.dumps(ch_ref)}")
    del rp, state
    # the window's last 3D filter pass, over the centres it saw
    if obs.last_filter is None:
        filter_gap, mismatch, n = math.inf, obs.final["n_live"], 0
    else:
        from gsplat_tpu_torch.render.filter3d import camera_table, filter3d

        xyz, n_live, filt = obs.last_filter
        n = int(n_live)
        rf, rvalid = reference.filter_3d(xyz, n, cams)
        filter_gap = float(((filt[:n] - rf[:n]).abs() / rf[:n]).max())
        # the program's validity flags: its pass again on the same centres
        table, focal = camera_table(obs.train_cameras, device)
        _, pvalid = filter3d(xyz, n_live.to(torch.int32), table, focal)
        mismatch = int((pvalid != rvalid).sum())
    out(f"bench: last filter pass over {n} rows: largest relative gap {filter_gap!r}, "
        f"validity mismatches {mismatch}")
    # the first densify pass's decisions
    d = obs.densify[0]
    kw = d["kw"]
    ref_d = reference.densify_decisions(
        d["accum"], d["denom"], d["max_radii"], d["scaling"], d["opacity"], d["n_live"],
        grad_threshold=kw["max_grad"], min_opacity=kw["min_opacity"], extent=kw["extent"],
        max_screen_size=kw["max_screen_size"], percent_dense=kw["percent_dense"])
    prog_d = {k: int(v) for k, v in d["stats"].items()}
    out(f"bench: first densify pass of {d['n_live']} rows: program {json.dumps(prog_d)} "
        f"reference {json.dumps(ref_d)}")
    return {
        "loss_gap": max(loss_gaps),
        "image_rms_gap": rms[0],
        "grad_gap": leaf_gaps(g1_prog, g1_ref, g1_ref),
        "change_gap": leaf_gaps(ch_prog, ch_ref, moved),
        "filter_gap": filter_gap,
        "filter_valid_mismatch": mismatch,
        "densify_count_gap": sum(abs(prog_d[k] - ref_d[k]) for k in ref_d),
    }

