"""The `train` traffic kind: closed-loop training steps.

A mix of this kind (`traffic/<mix>.json` with "kind": "train") names its
views, their spread, the step numbers, the loss's weight, the learning
rates, the budgets' headroom (`slack`), the readback cadence, the checked
steps and the warm-up. The run fits the budgets over every view, drives
`gsplat_tpu_torch.train.loop.make_train_step`'s step in blocks of
`readback_every` steps for the window, and then follows the set-up's
checked steps with the plain reference.
"""

from __future__ import annotations

import json
import math
import statistics
import time
from typing import Callable, Dict, List

import torch

from benchmark import scene
from benchmark.harness import (ROUNDOFF, Cell, Reading, StageRecorder, Window, annotate,
                               fit_budgets, leaf_gaps, load_reference, mean_work, mesh_params,
                               norm, optimization_params, params_per_splat, program_camera,
                               program_gaussians, rel_gap, sync)


class ImageSpy:
    """Keeps a copy of each image the train step's loss sees (observation
    only: the loss is the program's own), while the block runs."""

    def __init__(self):
        from gsplat_tpu_torch.train import loop

        self.loop = loop
        self.images: List[torch.Tensor] = []

    def __enter__(self):
        self.orig = self.loop.photometric_loss

        def spy(pred, gt, lam=0.2):
            self.images.append(pred.detach().clone())
            return self.orig(pred, gt, lam)

        self.loop.photometric_loss = spy
        return self

    def __exit__(self, *exc):
        self.loop.photometric_loss = self.orig


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        out: Callable[[str], None]) -> Dict:
    from gsplat_tpu_torch.train import loop
    from gsplat_tpu_torch.train.optim import init_adam_state

    cfg, tr = cell.config, cell.traffic
    w, h, chunk = cfg["width"], cfg["height"], cfg["chunk"]
    views = scene.train_views(seed, tr["views"], tr["yaw_deg"], tr["pitch_deg"])
    mats = [scene.view_matrices(cfg, *v) for v in views]
    extent = scene.camera_extent(cfg, views)
    g = program_gaussians(scene.build_params(cfg, seed, device), cfg, extent)
    targets = torch.rand((len(views), h, w, 3), dtype=torch.float32, device=device,
                         generator=scene.generator(seed, scene.SALT_TARGETS, device))
    cams = [program_camera(m, cfg, device, targets[i]) for i, m in enumerate(mats)]
    sync(device)
    t_fit = time.perf_counter()
    budgets = fit_budgets(g, cams, cfg, tr["slack"], device)
    out(f"bench: set-up: scene and targets at {t_fit - t_start!r} s, budgets fitted in "
        f"{time.perf_counter() - t_fit!r} s")
    out(f"bench: views {len(views)}, extent {extent!r}, budgets pair {budgets['pair']} "
        f"kept {budgets['kept']} contrib {budgets['contrib']} sat {budgets['sat']} "
        f"(probe maxima {json.dumps(budgets['probe'])})")
    step_fn = loop.make_train_step(optimization_params(tr), mesh_params(cfg), extent, w, h,
                                   pair_budget=budgets["pair"],
                                   contrib_budget=budgets["contrib"],
                                   sat_budget=budgets["sat"], kept_budget=budgets["kept"])
    opt_state = init_adam_state(g.params())
    order = scene.ViewOrder(seed, len(views))
    bg_gen = scene.generator(seed, scene.SALT_BG, device)
    zero_bg = torch.zeros(3, dtype=torch.float32, device=device)

    def draw_bg():
        if tr["random_background"]:
            return torch.rand(3, generator=bg_gen, dtype=torch.float32, device=device)
        return zero_bg

    ema = torch.zeros((), dtype=torch.float32, device=device)
    first = tr["first_step"]
    # the checked steps: the window's own call and feed, on views that differ
    checked, mu1 = [], None
    with ImageSpy() as spy:
        for i in range(tr["checked_steps"]):
            v, bg = order.next(), draw_bg()
            res = step_fn(g, opt_state, cams[v], bg, first + order.popped - 1, ema)
            g, opt_state, loss, ema = res[:4]
            checked.append({"view": v, "bg": bg, "loss": loss, "dropped": res[5]})
            if i == 0:
                mu1 = opt_state.mu
    params3 = g.params()
    images = spy.images
    sync(device)
    out(f"bench: set-up: {len(checked)} checked steps done at {time.perf_counter() - t_start!r} s")
    n_checked = len(checked)

    # the window: blocks of `readback_every` steps, each block's losses and
    # counts read back once, as the loop reads its budget counts
    every = tr["readback_every"]
    rec = StageRecorder() if traced else None
    drift = []      # (composited rows, pairs) a step, each block's mean
    steps = failed = 0

    def block(rec=None) -> int:
        """`every` steps, then their readback -> the failed steps."""
        nonlocal g, opt_state, ema
        res = []
        for _ in range(every):
            v, bg = order.next(), draw_bg()
            with annotate(traced, "bench.step"):
                if rec:
                    rec.begin()
                r = step_fn(g, opt_state, cams[v], bg, first + order.popped - 1,
                            ema, on_stage=rec)
                if rec:
                    rec.end()
            g, opt_state, _, ema = r[:4]
            res.append(r)
        with annotate(traced, "bench.readback"):
            rows = torch.cat([torch.stack([r[j] for r in res]).double()
                              for j in (2, 5, 7, 8, 4)]).tolist()
        k = len(res)
        drift.append((sum(rows[2 * k:3 * k]) / k, sum(rows[4 * k:5 * k]) / k))
        bad = 0
        for i in range(k):
            loss_i, dropped, contrib, sat = rows[i], rows[k + i], rows[2 * k + i], rows[3 * k + i]
            bad += int(not math.isfinite(loss_i) or dropped > 0 or contrib > budgets["contrib"]
                       or (budgets["sat"] is not None and sat > budgets["sat"]))
        return bad

    win = Window(seconds, traced, tr["profile_seconds"], device)
    # steps at the window's cadence for warmup_seconds, in the set-up: the
    # card's clocks (and in a traced run the profiler) settle before it
    t_warm, failed_setup = time.perf_counter(), 0
    while time.perf_counter() - t_warm < tr["warmup_seconds"]:
        failed_setup += block()
    drift.clear()
    win.start()
    while True:
        failed += block(rec)
        steps += every
        if win.done(steps):
            break
    window_s = win.elapsed()
    t0 = win.t0
    out(f"bench: steps {steps} in {window_s!r} s, failed {failed}; composited rows and pairs "
        f"a step, first block {drift[0]}, last block {drift[-1]}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = {"attempted": steps, "failed": failed, "peak": peak,
              "metrics": {"setup_s": t0 - t_start, "train_step_ms": per_step_ms(window_s, steps)}}
    stages = rec.stages() if rec else {}
    # the program's state is freed before the reference runs
    keep_targets = [targets[c["view"]].clone() for c in checked]
    prog_losses = [float(c["loss"]) for c in checked]
    dropped_checked = sum(int(c["dropped"]) for c in checked)
    del g, opt_state, cams, targets, step_fn, ema
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if traced:
        sample = scene.host_rng(seed, scene.SALT_SAMPLE).choice(
            len(views), size=min(tr["work_sample"], len(views)), replace=False)
        wk = mean_work(cfg, seed, [mats[i] for i in sample], device)
        out(f"bench: reference work a step (mean of {len(sample)} views): "
            f"{json.dumps(wk)}")
        result["reading"] = Reading(
            stages=stages, trace=win.summary, traced_units=win.traced_units,
            unit_seconds=win.traced_s / win.traced_units, work=wk, pixels=w * h,
            live=cfg["n_gaussians"], params_per_splat=params_per_splat(cfg))

    # the reference follows the checked steps from the same inputs
    reference = load_reference(cfg)
    reference.fp32_only()
    p0 = scene.build_params(cfg, seed, device)
    rp, state = {k: v.clone() for k, v in p0.items()}, reference.adam_init(p0)
    loss_gaps, rms, mx = [], [], []
    g1_ref, mask = None, {}
    t_ref = time.perf_counter()
    for i, c in enumerate(checked):
        cam = reference.camera(mats[c["view"]], cfg["fovx"], cfg["fovy"], w, h, device)
        rp, state, loss_r, img_r, grads = reference.train_step(
            rp, state, cam, keep_targets[i], c["bg"], first + i, n_live=cfg["n_gaussians"],
            sh_degree=cfg["sh_degree"], tile_size=cfg["tile_size"], lam=tr["lambda_dssim"],
            lr=tr["lr"], extent=extent, chunk=chunk)
        if i == 0:
            g1_ref = {k: norm(v) for k, v in grads.items()}
            # elements whose gradient is round-off (under 1e-6 of the leaf's
            # largest): Adam gives them full steps of either sign
            mask = {k: v.abs() >= ROUNDOFF * v.abs().max() for k, v in grads.items()}
        del grads
        loss_gaps.append(rel_gap(prog_losses[i], loss_r, abs(loss_r)))
        d = (images[i] - img_r).double()
        rms.append(float(d.pow(2).mean().sqrt()))
        mx.append(float(d.abs().max()))
    g1_prog = {k: norm(v / (1.0 - tr["adam_b1"])) for k, v in mu1.items()}
    med = statistics.median(g1_ref.values())
    moved = [k for k in g1_ref if g1_ref[k] >= 1e-3 * med]
    ch_prog = {k: norm((params3[k] - p0[k])[mask[k]]) for k in moved}
    ch_ref = {k: norm((rp[k] - p0[k])[mask[k]]) for k in moved}
    out(f"bench: reference {n_checked} steps in {time.perf_counter() - t_ref!r} s")
    # the image is compared at the first step: after it, Adam's full steps on
    # round-off gradients part the two states (PERF.md §6)
    out(f"bench: image gaps of the checked steps: rms {rms}, widest {mx}")
    out(f"bench: first-gradient norms program {json.dumps(g1_prog)} reference "
        f"{json.dumps(g1_ref)}; change norms after {n_checked} steps program "
        f"{json.dumps(ch_prog)} reference {json.dumps(ch_ref)} (leaves {moved})")
    result["checks"] = {
        "loss_gap": max(loss_gaps),
        "image_rms_gap": rms[0],
        "grad_gap": leaf_gaps(g1_prog, g1_ref, g1_ref),
        "change_gap": leaf_gaps(ch_prog, ch_ref, moved),
        "failed_steps": failed + failed_setup + int(dropped_checked > 0),
    }
    return result


def per_step_ms(window_s: float, steps: int) -> float:
    """The window's milliseconds over every step it completed."""
    return window_s * 1e3 / steps

