#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (gsplat_tpu_torch): the forward render
path and the training step at 1M Gaussians and 1920x1080 on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, and the final ok line is not printed):
  env      card name + power limit (nvidia-smi), torch / CUDA / nvcc versions
  build    nvcc builds gsplat_tpu_torch/csrc/*.cu into build/kernels/
  oracle   a tiny scene rendered on the GPU against the port's per-pixel
           oracle and its CPU render (plain kernel versions), 2e-5 abs
  then, for each of two cells, bench.py's scene re-made in numpy (1M
  Gaussians, numpy default_rng(0), geometry at tile 32, and its random
  target image) written as a 3DGS point_cloud.ply and loaded back onto the
  GPU (capacity 2^20), with the pair and kept budgets of its bench view
  fitted from a probe binning as scripts/serving_bench.py does:
  expand_pairs   the kernel against its plain version at the fitted pair
           budget: keys and gids bit-equal
  composite_fwd  the kernel against its plain version on the view's real
           pair table: tiles within 2e-5 abs, nproc equal in every tile but
           those whose max T at the deciding chunk boundary lies within 1e-6
           relative of T_EPS (the two multiply in another order); the share
           of kept pairs past each tile's saturation exit
  composite_bwd  the kernel against its plain version on the same table and
           the cotangent of the real photometric loss, at the contrib budget
           bench.py fits: keys bit-equal, each d column within 1e-4 of its
           max; the same bits from two launches
  segment_ends   the kernel against its plain version on the kernel's
           d-table keys after the gid-key sort: bit-equal
  serve    render() with per-view and per-stage ms: the sparse cell (2.25
           tile pairs per Gaussian) for 4 views, the bench camera + 3 yaw
           turns; the dense cell (33 tile pairs per Gaussian) for the bench
           camera
  train    make_train_step at OptimizationParams() defaults, bg 0, spatial
           LR scale 1, budgets fitted as bench.py fits them with the JAX
           training loop's headroom (1.2x pair and kept, 1.5x contrib; the
           saturation cull off): 10 steps in the sparse cell, 3 in the
           dense one. The sparse step-1 loss within 2e-4 of the JAX
           package's 0.4129 on this scene (BENCH_r05.json); every step
           n_dropped 0 and n_contrib within its budget; parameters and Adam
           moments finite; the loss falls; denom at most the step count and
           reaching it; the step-1 per-Gaussian gradient table (the output
           of _Rasterize.backward) finite and within 1e-3 of each column's
           max of a float64 index_add_ of the same d-table rows by their
           gid keys. Synced step ms, one step's stage ms (CUDA events), and
           the device busy share, operation count and top kernels of the
           last step (torch.profiler)
The launch counts of the four kernels are zeroed just before each serve and
each train phase (the main path) and must cover every render and step run
there; the kernels line sums them. The kernels JSON row holds the sparse
bench view's times and bound, and the larger error of the two cells.
Numbers are printed with the card they ran on; TF32 is switched off for
matmuls and cuDNN (the loss's blur pins full fp32 itself).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

W, H = 1920, 1080
N = 1_000_000
TILE, CHUNK = 32, 128
SPARSE_BUDGET, DENSE_BUDGET = 5 << 19, 5 << 23   # scripts/serving_bench.py
# the JAX package's counts on this same numpy scene (BENCH_r05.json)
REF_SPARSE_PAIRS, REF_SPARSE_CULLED = 2_105_855, 187_969
REF_DENSE_CULLED = 6_040_429
REF_SPARSE_LOSS = 0.4129     # BENCH_r05.json "loss", the step-1 loss
ATOL = 2e-5
BWD_RTOL = 1e-4       # composite_bwd vs plain, of each d column's max
GRAD_RTOL = 1e-3      # per-Gaussian gradient table vs float64, of each column's max
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12
PEAK_INT32 = 33.5e12   # 64 int32 operations a clock a SM, half the fp32 rate
# f32 operations per pair-pixel evaluation of composite_fwd: dx, dy (2),
# three products (3), the quadratic form (5: 3 mul, 2 add) and its negation
# (1), the power > 0 test and select (2), expf (~4: range reduction + ex2),
# op * G (1), the 1/255 test, clamp and select (3), w = alpha*t_exc*T (2),
# three colour multiply-adds (6), 1 - alpha and the running product (2)
K2_OPS_PER_EVAL = 31
# expand_pairs per live slot: ~20 binary-search steps of ~3 integer ops, ~10
# integer ops of rectangle decomposition, ~40 f32 ops and one expf of the cull
K1_OPS_PER_SLOT = 110
# f32 operations per pair-pixel evaluation of composite_bwd: the forward's
# replay (dx, dy, their three products, the quadratic form and its negation,
# the power test, expf, op * G, the alpha test/clamp/select: 21), t_i and w
# (2), cg (5), the running sum of w*cg (2), 1 - alpha and the running
# product (2); then pref (1), the chain test (2), dalpha (t_i*cg, two
# subtractions, 1 - alpha, the division ~4, the product: 9), gda and dpow
# (2), the ten summands (3 + 6), and one add each of the ten pixel sums (10)
K3_OPS_PER_EVAL = 65
FRAME_REPS = 10   # synced frames timed per view
TRAIN_STEPS = {"sparse": 10, "dense": 3}


def build_scene(n, width, height, seed=0, target_pairs_per_gaussian=4.0,
                tile_size=16):
    """bench.py::build_scene (aniso 0) in numpy, with the same draws in the
    same order -> (raw PLY arrays of the n live Gaussians, camera args, the
    (height, width, 3) target image)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 0.5
    fovx, fovy = 1.2, 0.8
    focal = 0.5 * width / math.tan(fovx / 2)
    z_mean = 4.0
    radius_px = tile_size * (math.sqrt(target_pairs_per_gaussian) - 1.0) / 2.0
    sigma = radius_px * z_mean / (3.0 * focal)
    rng.uniform(1.0, 1.0, n)          # bench draws the anisotropy even at 0
    f_dc = rng.random((n, 3)).astype(np.float32)
    img = rng.random((height, width, 3)).astype(np.float32)
    raw = {
        "xyz": pts,
        "features_dc": f_dc,
        "features_rest": np.zeros((n, 15, 3), np.float32),
        "opacity": np.zeros((n, 1), np.float32),
        "scaling": np.full((n, 3), np.log(sigma), np.float32),
        "rotation": np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
    }
    return raw, (np.eye(3), np.array([0.0, 0.0, z_mean]), fovx, fovy), img


def yaw_camera(cam_args, degrees):
    """The bench camera turned about its own vertical axis."""
    R, T, fovx, fovy = cam_args
    a = math.radians(degrees)
    Ry = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                   [-math.sin(a), 0, math.cos(a)]])
    center = -R @ T
    R2 = R @ Ry
    return R2, -R2.T @ center, fovx, fovy


class StageEvents:
    """on_stage hook of render(): one CUDA event after each stage."""

    def __init__(self):
        self.events = []
        self("start")

    def __call__(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((name, e))

    def ms(self):
        self.events[-1][1].synchronize()
        return {name: prev.elapsed_time(e)
                for (_, prev), (name, e) in zip(self.events, self.events[1:])}


def device_ms(fn, reps):
    """Device time of fn() per call: a sleep kernel holds the stream while
    the host queues every launch, so host overhead does not enter."""
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_busy(fn, top=6):
    """(device ms, device operations run, [(kernel, ms)] of the `top`
    longest kernels, fn's result) of one synced call of fn() under
    torch.profiler's CUDA tracing. The device ms are None
    where the profiler saw no device time (a tracer that does not work on
    the machine): a measurement, not a check."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()

    # device-side events only: a CPU op's row repeats its kernels' time
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    rows = sorted(((e.key[:60], e.self_device_time_total / 1e3) for e in dev),
                  key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in rows)
    return (busy if busy > 0 else None), sum(e.count for e in dev), rows[:top], out


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, ok, msg):
        print(("  ok    " if ok else "  FAIL  ") + msg, flush=True)
        if not ok:
            self.failures.append(msg)

    def phase(self, name):
        print(f"== {name}", flush=True)


def fit_budgets(g, cam, budget):
    """scripts/serving_bench.py's probe: bin with kept_budget = budget - 128
    (which turns the tight cull on), then fit both budgets to the counts."""
    from gsplat_tpu_torch.render.binning import bin_gaussians
    from gsplat_tpu_torch.render.project import project_gaussians

    p = project_gaussians(g, cam)
    b = bin_gaussians(p.mean2d, p.radius, p.depth, width=cam.width,
                      height=cam.height, tile_size=TILE, chunk=CHUNK,
                      pair_budget=budget, cull_conic=p.conic,
                      cull_opacity=p.opacity, kept_budget=budget - CHUNK)
    n_pairs, n_culled = int(b.n_pairs), int(b.n_culled)
    if n_pairs >= budget:
        raise RuntimeError(f"probe overflowed its budget {budget}")
    pair_fit = min(-(-n_pairs // CHUNK) * CHUNK + CHUNK, budget)
    kept = -(-(n_pairs - n_culled + CHUNK) // CHUNK) * CHUNK
    return pair_fit, kept, n_pairs, n_culled


def load_scene(raw, tmp, name):
    """Write the model as a 3DGS point_cloud.ply and load it onto the GPU."""
    from gsplat_tpu_torch.io.ply import load_gaussian_ply, save_gaussian_ply
    from gsplat_tpu_torch.scene import gaussians_from_raw

    path = Path(tmp) / name / "point_cloud.ply"
    save_gaussian_ply(path, raw["xyz"], raw["features_dc"], raw["features_rest"],
                      raw["opacity"], raw["scaling"], raw["rotation"])
    return gaussians_from_raw(load_gaussian_ply(path), capacity=1 << 20,
                              sh_degree=3, device="cuda")


def phase_oracle(s):
    """A tiny scene: the GPU render against the port's per-pixel oracle and
    against the CPU render (the kernels' plain versions)."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.interop import gaussians_from_numpy
    from gsplat_tpu_torch.render.project import project_gaussians
    from gsplat_tpu_torch.render.raster_ref import composite_reference
    from gsplat_tpu_torch.render.render import render

    rng = np.random.default_rng(7)
    n, cap, w, h = 60, 64, 96, 64
    params = {
        "xyz": rng.normal(size=(cap, 3)) * 0.6,
        "f_dc": rng.normal(size=(cap, 3)),
        "f_rest": rng.normal(size=(cap, 15, 3)) * 0.3,
        "opacity": rng.normal(0.0, 1.5, size=(cap, 1)),
        "scaling": rng.uniform(-2.8, -1.2, size=(cap, 3)),
        "rotation": rng.normal(size=(cap, 4)),
    }
    for k in ("max_radii2D", "xyz_gradient_accum", "denom"):
        params[k] = np.zeros(cap)
    bg = torch.tensor([0.1, 0.2, 0.3])
    out = {}
    for dev in ("cpu", "cuda"):
        g = gaussians_from_numpy(params, n, 3, 3, device=dev)
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.9, 0.7, w, h,
                          device=dev)
        out[dev] = render(cam, g, bg, tile_size=16, chunk=32, pair_budget=4096,
                          kept_budget=4064)
        if dev == "cpu":
            ref = composite_reference(project_gaussians(g, cam), width=w, height=h,
                                      tile_size=16, bg=bg)
    gpu = out["cuda"].image.cpu()
    d_ref = float((gpu - ref).abs().max())
    d_cpu = float((gpu - out["cpu"].image).abs().max())
    s.check(d_ref <= ATOL and d_cpu <= ATOL,
            f"tiny scene {w}x{h}: GPU image vs per-pixel oracle {d_ref:.3g}, "
            f"vs CPU render {d_cpu:.3g} (tol {ATOL})")
    same = all(int(getattr(out["cuda"], f)) == int(getattr(out["cpu"], f))
               for f in ("n_pairs", "n_culled", "n_contrib"))
    s.check(same and int(out["cuda"].n_culled) > 0,
            "tiny scene n_pairs/n_culled/n_contrib equal on GPU and CPU, cull active")


def phase_expand(s, label, g, cam, pair_fit, kept):
    from gsplat_tpu_torch.render import expand
    from gsplat_tpu_torch.render.binning import depth_shift, expansion_table, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians

    tw, th = tile_grid(W, H, TILE)
    db = depth_shift(tw * th)
    S = pair_fit
    do_cull = S < 8 * g.capacity or kept < S      # bin_gaussians' rule
    p = project_gaussians(g, cam)
    table, total = expansion_table(p.mean2d, p.radius, p.depth, p.conic, p.opacity,
                                   tw=tw, th=th, tile_size=TILE, db=db,
                                   do_cull=do_cull)
    kw = dict(tw=tw, tile_size=TILE, db=db, num_tiles=tw * th, n_orig=g.capacity,
              do_cull=do_cull)
    key_k, gid_k = expand.expand_pairs(table, total, S, **kw)
    key_p, gid_p = expand.expand_pairs_plain(table, total, S, **kw)
    torch.cuda.synchronize()
    bad = int(((key_k != key_p) | (gid_k != gid_p)).sum())
    s.check(bad == 0, f"{label} expand_pairs vs plain at S={S}, cull {do_cull}, "
            f"total {int(total)}: {bad} mismatching slots (want 0)")
    err = max(int((key_k - key_p).abs().max()), int((gid_k - gid_p).abs().max()))
    del key_k, gid_k, key_p, gid_p
    ms = device_ms(lambda: expand.expand_pairs(table, total, S, **kw), 20)
    plain_ms = device_ms(lambda: expand.expand_pairs_plain(table, total, S, **kw), 3)
    # the table and total read once, keys and gids written once; only the
    # slots below the live total search and cull, the rest write the
    # invalid pair
    nbytes = table.numel() * 4 + 4 + 2 * S * 4
    ops = int(total) * K1_OPS_PER_SLOT
    print(f"  {label} expand_pairs: {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(table {tuple(table.shape)}, {nbytes / 1e6:.1f} MB moved)")
    return dict(name="expand_pairs", route="cuda",
                source="gsplat_tpu_torch/csrc/expand_pairs.cu",
                replaces="gsplat_tpu/render/expand_pallas.py:133",
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bytes=nbytes, ops=ops, library_ms=None)


def phase_composite(s, label, g, cam, pair_fit, kept):
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.render.binning import bin_gaussians, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians
    from gsplat_tpu_torch.render.render import pair_table

    tw, _ = tile_grid(W, H, TILE)
    p = project_gaussians(g, cam)
    b = bin_gaussians(p.mean2d, p.radius, p.depth, width=W, height=H,
                      tile_size=TILE, chunk=CHUNK, pair_budget=pair_fit,
                      cull_conic=p.conic, cull_opacity=p.opacity, kept_budget=kept)
    gathered = pair_table(p, b, kept)
    del p
    ts, tc = b.tile_start, b.tile_count
    tiles_k, np_k = raster.composite_fwd(gathered, ts, tc, tw=tw, tile_size=TILE,
                                         chunk=CHUNK)
    tiles_p, np_p = raster.composite_fwd_plain(gathered, ts, tc, tw=tw,
                                               tile_size=TILE, chunk=CHUNK)
    torch.cuda.synchronize()
    allowed = torch.zeros(ts.shape[0], dtype=torch.bool, device=ts.device)
    bad_tiles = torch.nonzero(np_k != np_p).squeeze(1).tolist()
    for t in bad_tiles:
        # replay tile t through the plain version up to the deciding
        # boundary m: its segment cut at chunk m, every other tile empty
        m = min(int(np_k[t]), int(np_p[t]))
        counts = torch.zeros_like(tc)
        counts[t] = max(min(int(tc[t]), m * CHUNK - int(ts[t]) % CHUNK), 0)
        replay, _ = raster.composite_fwd_plain(gathered, ts, counts, tw=tw,
                                               tile_size=TILE, chunk=CHUNK)
        t_max = float(replay[t, 3].max())
        near = abs(t_max - raster.T_EPS) <= 1e-6 * raster.T_EPS
        print(f"  {label} tile {t}: nproc kernel {int(np_k[t])} plain {int(np_p[t])}, "
              f"max T at chunk {m} = {t_max!r} "
              f"({'at' if near else 'NOT at'} the T_EPS boundary)")
        allowed[t] = near
    diff = (tiles_k - tiles_p).abs().amax(dim=(1, 2))
    err = float(diff[~allowed].max()) if bool((~allowed).any()) else 0.0
    n_bad = len(bad_tiles) - int(allowed.sum())
    s.check(err <= ATOL, f"{label} composite_fwd vs plain on {ts.shape[0]} tiles, "
            f"{gathered.shape[0]} pairs: max |tiles diff| {err:.3g} (tol {ATOL})")
    s.check(n_bad == 0, f"{label} composite_fwd nproc: {len(bad_tiles)} tiles differ, "
            f"{n_bad} of them away from the T_EPS boundary (want 0)")
    # a tile's pairs past its exit: those beyond its nproc-th chunk of the
    # chunk-aligned grid its segment is swept on
    tc64 = tc.to(torch.int64)
    past = torch.minimum(torch.clamp(ts.to(torch.int64) % CHUNK + tc64
                                     - np_k.to(torch.int64) * CHUNK, min=0), tc64)
    n_past, n_kept = int(past.sum()), int(tc64.sum())
    ms = device_ms(lambda: raster.composite_fwd(gathered, ts, tc, tw=tw,
                                                tile_size=TILE, chunk=CHUNK), 10)
    plain_ms, _ = wall_ms(lambda: raster.composite_fwd_plain(
        gathered, ts, tc, tw=tw, tile_size=TILE, chunk=CHUNK))
    chunks = int(np_k.sum())
    evals = chunks * CHUNK * TILE * TILE
    nbytes = chunks * CHUNK * 64 + tiles_k.numel() * 4 + 3 * ts.numel() * 4
    print(f"  {label} composite_fwd: {ms:.4f} ms, plain {plain_ms:.2f} ms; "
          f"{chunks} chunks composited, {evals / 1e9:.3f} G pair-pixel evaluations; "
          f"kept pairs past their tile's saturation exit {n_past} of {n_kept} "
          f"({n_past / max(n_kept, 1):.2%})")
    return dict(name="composite_fwd", route="cuda",
                source="gsplat_tpu_torch/csrc/composite_fwd.cu",
                replaces="gsplat_tpu/render/raster_pallas.py:536",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                ops=evals * K2_OPS_PER_EVAL, library_ms=None)


def fit_contrib(n_contrib):
    """bench.py:241's contrib budget: the replayed rows, rounded up to 512,
    plus 512."""
    return -(-int(n_contrib) // 512) * 512 + 512


def loss_cotangent(gathered, ts, tc, tw, th, target):
    """The forward tiles of a pair table and the cotangent of the real
    photometric loss (bg 0) with respect to them."""
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.train.loss import photometric_loss

    tiles, nproc = raster.composite_fwd(gathered, ts, tc, tw=tw, tile_size=TILE,
                                        chunk=CHUNK)
    with torch.enable_grad():
        t = tiles.clone().requires_grad_()
        rgb, _ = raster.untile_image(t, tw, th, TILE, W, H)
        (g,) = torch.autograd.grad(photometric_loss(rgb, target), [t])
    return tiles, nproc, g.contiguous()


def phase_backward(s, label, g, cam, target, pair_fit, kept):
    """composite_bwd and segment_ends against their plain versions at the
    bench view's fitted budgets, on its real pair table and loss cotangent
    -> (K3 row, K4 row)."""
    from gsplat_tpu_torch.render import bounds, raster
    from gsplat_tpu_torch.render.binning import bin_gaussians, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians
    from gsplat_tpu_torch.render.render import contrib_regions, pair_table

    s.phase(f"kernel composite_bwd ({label})")
    tw, th = tile_grid(W, H, TILE)
    p = project_gaussians(g, cam)
    b = bin_gaussians(p.mean2d, p.radius, p.depth, width=W, height=H,
                      tile_size=TILE, chunk=CHUNK, pair_budget=pair_fit,
                      cull_conic=p.conic, cull_opacity=p.opacity, kept_budget=kept)
    gathered = pair_table(p, b, kept)
    del p
    ts, tc = b.tile_start, b.tile_count
    tiles, nproc, g_tiles = loss_cotangent(gathered, ts, tc, tw, th, target)
    contrib = fit_contrib(int(nproc.sum()) * CHUNK)
    np_c, comp_start, overflow = contrib_regions(nproc, CHUNK, contrib)
    args = (gathered, ts, tc, comp_start, np_c, tiles, g_tiles)
    kw = dict(tw=tw, tile_size=TILE, chunk=CHUNK, p_out=contrib)
    d_k = raster.composite_bwd(*args, **kw)
    d_k2 = raster.composite_bwd(*args, **kw)
    d_p = raster.composite_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    keys_equal = torch.equal(d_k[:, raster.KEY_COL], d_p[:, raster.KEY_COL])
    rel = [float((d_k[:, c] - d_p[:, c]).abs().max() / d_p[:, c].abs().max().clamp(min=1e-30))
           for c in range(raster.N_DCOLS)]
    err = float((d_k[:, :raster.N_DCOLS] - d_p[:, :raster.N_DCOLS]).abs().max())
    s.check(not bool(overflow) and keys_equal and max(rel) <= BWD_RTOL,
            f"{label} composite_bwd vs plain on {int(np_c.sum())} replayed chunks "
            f"(contrib budget {contrib}): keys equal {keys_equal}, d columns rel err "
            + " ".join(f"{r:.2g}" for r in rel) + f" (tol {BWD_RTOL} of each column's max)")
    s.check(torch.equal(d_k, d_k2), f"{label} composite_bwd: two launches give the same bits")
    del d_k2, d_p
    rows = int(np_c.sum()) * CHUNK
    evals = rows * TILE * TILE
    # the wrapper fills a fresh d-table before each launch: its time, less
    # that of the fill alone, is the kernel's
    ms = (device_ms(lambda: raster.composite_bwd(*args, **kw), 20)
          - device_ms(lambda: raster.d_table_prefilled(contrib, d_k.device), 20))
    plain_ms, _ = wall_ms(lambda: raster.composite_bwd_plain(*args, **kw))
    # the replayed pair rows read once, tiles and cotangent read once, the
    # four tile tables, the replayed d-rows written once
    nbytes = rows * 64 + 2 * tiles.numel() * 4 + 4 * ts.numel() * 4 + rows * 64
    print(f"  {label} composite_bwd: {ms:.4f} ms, plain {plain_ms:.2f} ms; {rows} rows "
          f"replayed, {evals / 1e9:.3f} G pair-pixel evaluations", flush=True)
    k3 = dict(name="composite_bwd", route="cuda",
              source="gsplat_tpu_torch/csrc/composite_bwd.cu",
              replaces="gsplat_tpu/render/raster_pallas.py:618",
              max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
              ops=evals * K3_OPS_PER_EVAL, library_ms=None)

    s.phase(f"kernel segment_ends ({label})")
    key_s, _ = torch.sort(d_k[:, raster.KEY_COL], stable=True)
    n = g.capacity
    e_k = bounds.segment_ends(key_s, n)
    e_p = bounds.segment_ends_plain(key_s, n)
    torch.cuda.synchronize()
    bad = int((e_k != e_p).sum())
    s.check(bad == 0, f"{label} segment_ends vs plain over {key_s.shape[0]} keys, "
            f"{n} Gaussians: {bad} mismatching ends (want 0)")
    q = torch.arange(1, n + 1, device=key_s.device).to(torch.float32)
    ms4 = device_ms(lambda: bounds.segment_ends(key_s, n), 20)
    plain4 = device_ms(lambda: bounds.segment_ends_plain(key_s, n), 20)
    lib4 = device_ms(lambda: torch.searchsorted(key_s, q, side="left"), 20)
    # ~log2(P) compares and index updates per Gaussian
    ops4 = n * 3 * max(1, key_s.shape[0].bit_length())
    print(f"  {label} segment_ends: {ms4:.4f} ms, plain {plain4:.4f} ms, "
          f"torch.searchsorted {lib4:.4f} ms", flush=True)
    k4 = dict(name="segment_ends", route="cuda",
              source="gsplat_tpu_torch/csrc/segment_ends.cu",
              replaces="gsplat_tpu/render/bounds_pallas.py:44",
              max_abs_err=float((e_k - e_p).abs().max()), ms=ms4, plain_ms=plain4,
              bytes=key_s.numel() * 4 + n * 4, ops=ops4, peak_ops=PEAK_INT32,
              library_ms=lib4)
    return k3, k4


def grad_table_check(s, label, d, table):
    """The per-Gaussian gradient table against a float64 index_add_ of the
    d-table's rows by their gid keys; also what a float32 cumsum would have
    given (the reference's reduction), as a measurement."""
    from gsplat_tpu_torch.render import bounds, raster

    n_rows = table.shape[0]
    key = d[:, raster.KEY_COL]
    valid = key != raster.KEY_INVALID
    ref = torch.zeros((n_rows, raster.N_DCOLS), dtype=torch.float64, device=d.device)
    ref.index_add_(0, key[valid].long(), d[valid, :raster.N_DCOLS].double())
    scale = ref.abs().amax(0).clamp(min=1e-300)
    rel = ((table[:, :raster.N_DCOLS].double() - ref).abs().amax(0) / scale).tolist()
    # the same reduction with a float32 cumsum table (the reference's)
    key_s, perm = torch.sort(key, stable=True)
    cols = d.index_select(0, perm)[:, :raster.N_DCOLS].t().contiguous()
    S = torch.cat([cols.new_zeros((raster.N_DCOLS, 1)),
                   torch.stack([torch.cumsum(c, 0) for c in cols])], dim=1)
    T_b = S.index_select(1, bounds.segment_ends_plain(key_s, n_rows - 1))
    f32 = (T_b - torch.cat([T_b.new_zeros((raster.N_DCOLS, 1)), T_b[:, :-1]], dim=1)).t()
    rel32 = ((f32.double() - ref[:-1]).abs().amax(0) / scale).tolist()
    s.check(max(rel) <= GRAD_RTOL and bool(torch.isfinite(table).all()),
            f"{label} step-1 per-Gaussian gradient table ({int(valid.sum())} d-rows) vs "
            "float64 index_add_, rel err per column " + " ".join(f"{r:.3g}" for r in rel)
            + f" (tol {GRAD_RTOL}); a float32 cumsum would give "
            + " ".join(f"{r:.3g}" for r in rel32))
    return rel, rel32


def train(s, label, g, cam_args, target, budget, steps):
    """make_train_step at the fitted budgets for `steps` steps with the
    launch counts from zero -> (launches, step results)."""
    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render import render as render_mod
    from gsplat_tpu_torch.train.loop import make_train_step
    from gsplat_tpu_torch.train.optim import init_adam_state

    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, image=target, device="cuda")
    bg = torch.zeros(3, device=g.device)
    pair_fit, kept, _, _ = fit_budgets(g, cam, budget)
    probe = render_mod.render(cam, g, bg, tile_size=TILE, chunk=CHUNK,
                              pair_budget=pair_fit, kept_budget=kept)
    contrib = fit_contrib(probe.n_contrib)
    del probe
    # the steps move the Gaussians, and with them the pair, kept and
    # composited counts (+4.4% composited rows over the 10 sparse steps on
    # an H100): the headroom the JAX training loop gives its fitted
    # budgets, 1.2x kept (loop.py:575) and 1.5x contrib (loop.py:641)
    pair_fit = min(budget, -(-int(pair_fit * 1.2) // CHUNK) * CHUNK)
    kept = min(pair_fit, -(-int(kept * 1.2) // CHUNK) * CHUNK)
    contrib = -(-int(contrib * 1.5) // 512) * 512
    step_fn = make_train_step(OptimizationParams(), MeshParams(
        tile_size=TILE, chunk_size=CHUNK, pair_budget=pair_fit), 1.0, W, H,
        kept_budget=kept, contrib_budget=contrib)
    opt_state = init_adam_state(g.params())
    print(f"  {label}: pair_budget {pair_fit}, kept {kept}, contrib {contrib}", flush=True)

    captured = {}
    reduce = render_mod.reduce_by_gid

    def capture(d, n_rows):
        out = reduce(d, n_rows)
        captured.setdefault("d", d)
        captured.setdefault("table", out)
        return out

    counts = kernel_counts()
    for f in counts.values():
        f.launches = 0
    losses, times, ema, ok = [], [], 0.0, True
    busy = None
    with torch.enable_grad():
        for step in range(1, steps + 1):
            render_mod.reduce_by_gid = capture if step == 1 else reduce
            try:
                if step == steps:
                    t0 = time.perf_counter()
                    busy = device_busy(lambda: step_fn(g, opt_state, cam, bg, step, ema),
                                       top=12)
                    out = busy[3]
                    step_ms = (time.perf_counter() - t0) * 1e3
                elif step == steps - 1:
                    stages = StageEvents()
                    step_ms, out = wall_ms(
                        lambda: step_fn(g, opt_state, cam, bg, step, ema, on_stage=stages))
                    stage_ms = stages.ms()
                else:
                    step_ms, out = wall_ms(lambda: step_fn(g, opt_state, cam, bg, step, ema))
            finally:
                render_mod.reduce_by_gid = reduce
            g, opt_state, loss, ema, n_pairs, n_dropped, n_culled, n_contrib, _ = out
            losses.append(float(loss))
            if 1 < step < steps:
                times.append(step_ms)
            good = int(n_dropped) == 0 and int(n_contrib) <= contrib
            ok &= good
            print(f"  {label} step {step}: loss {float(loss):.6f}, {step_ms:.3f} ms, pairs "
                  f"{int(n_pairs)} culled {int(n_culled)} contrib {int(n_contrib)} dropped "
                  f"{int(n_dropped)}", flush=True)
            if step == 1:
                rel, rel32 = grad_table_check(s, label, captured["d"], captured["table"])
                del captured["d"], captured["table"]
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counts.items()}
    s.check(ok, f"{label}: every step n_dropped 0 and n_contrib <= {contrib}")
    finite = all(bool(torch.isfinite(t).all()) for d in
                 (g.params(), opt_state.mu, opt_state.nu) for t in d.values())
    s.check(finite, f"{label}: parameters and Adam moments finite after {steps} steps")
    s.check(losses[-1] < losses[0], f"{label}: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
            f"over {steps} steps")
    dmax = float(g.denom.max())
    s.check(dmax == steps and bool((g.denom <= steps).all()),
            f"{label}: denom max {dmax:g} (want {steps}, at most {steps} everywhere)")
    s.check(launches["expand_pairs"] >= steps and all(v >= steps for v in launches.values()),
            f"{label} kernel launches {launches} cover its {steps} steps")
    busy_ms, n_ops, top = busy[:3]
    share = "not measured" if busy_ms is None else \
        f"{busy_ms:.3f} ms of device time"
    med = statistics.median(times) if times else float("nan")
    print(f"  {label} train step ms of {len(times)} synced (steps 2..{steps - 1}): "
          f"median {med:.3f} min {min(times, default=float('nan')):.3f} "
          f"max {max(times, default=float('nan')):.3f}; profiled step {steps}: device busy "
          f"{share} ({'' if busy_ms is None else f'{busy_ms / med:.1%} of the median step, '}"
          f"{n_ops} device operations); top kernels "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top), flush=True)
    print(f"  {label} train step {steps - 1} stages (ms): "
          + " ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()), flush=True)
    return launches, dict(losses=losses, ms=med, rel=rel, rel32=rel32, contrib=contrib,
                          stages=stage_ms)


def kernel_counts():
    from gsplat_tpu_torch.render import bounds, expand, raster

    return {"expand_pairs": expand.expand_pairs, "composite_fwd": raster.composite_fwd,
            "composite_bwd": raster.composite_bwd, "segment_ends": bounds.segment_ends}


def run_cell(s, label, g, cam_args, views, budget, target):
    """The kernels against their plain versions at the bench view's fitted
    budgets, then the serve and train phases, each with the launch counts
    from zero -> (kernel rows, launches of serve + train, renders run, view
    results, train results)."""
    from gsplat_tpu_torch.core.camera import make_camera

    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, device="cuda")
    pair_fit, kept, _, _ = fit_budgets(g, cam, budget)
    s.phase(f"kernel expand_pairs ({label})")
    k1 = phase_expand(s, label, g, cam, pair_fit, kept)
    s.phase(f"kernel composite_fwd ({label})")
    k2 = phase_composite(s, label, g, cam, pair_fit, kept)
    k3, k4 = phase_backward(s, label, g, cam, torch.from_numpy(target).to(g.device),
                            pair_fit, kept)
    torch.cuda.empty_cache()

    # ---- the main path: counts from zero before each phase ----
    counts = kernel_counts()
    for f in counts.values():
        f.launches = 0
    s.phase(f"serve {label}")
    renders, results = serve(s, g, cam_args, views, budget, label)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counts.items()}
    s.check(launches["composite_fwd"] >= renders and launches["expand_pairs"] >= renders,
            f"{label} serve kernel launches {launches} cover its {renders} renders")
    torch.cuda.empty_cache()
    s.phase(f"train {label}")
    t_launches, trained = train(s, label, g, cam_args, target, budget, TRAIN_STEPS[label])
    torch.cuda.empty_cache()
    launches = {k: launches[k] + t_launches[k] for k in launches}
    return (k1, k2, k3, k4), launches, renders, results, trained


def serve(s, g, cam_args, views, budget, label):
    """Fit budgets and render every view; returns renders run and stage ms."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render.render import render

    bg = torch.zeros(3, device=g.device)
    renders = 0
    results = []
    for deg in views:
        R, T, fovx, fovy = yaw_camera(cam_args, deg)
        cam = make_camera(R, T, fovx, fovy, W, H, device="cuda")
        pair_fit, kept, n_pairs, n_culled = fit_budgets(g, cam, budget)

        def run(on_stage=None):
            return render(cam, g, bg, tile_size=TILE, chunk=CHUNK,
                          pair_budget=pair_fit, kept_budget=kept, on_stage=on_stage)

        out = run()
        times = [wall_ms(run)[0] for _ in range(FRAME_REPS)]
        stages = StageEvents()
        run(on_stage=stages)
        renders += 2 + FRAME_REPS
        stage_ms = stages.ms()
        if deg == views[0]:
            busy_ms, n_ops, top, _ = device_busy(run)
            renders += 1
            share = "not measured" if busy_ms is None else \
                f"{busy_ms:.3f} ms, {busy_ms / statistics.median(times):.1%} of the median frame"
            print(f"  {label} yaw {deg:+g}: device busy (torch.profiler) {share}, "
                  f"{n_ops} device operations; top kernels "
                  + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out.image).all())
        s.check(int(out.n_dropped) == 0 and finite and out.image.shape == (H, W, 3),
                f"{label} yaw {deg:+g} deg: n_dropped {int(out.n_dropped)}, "
                f"finite {finite}, image {tuple(out.image.shape)}")
        print(f"  {label} yaw {deg:+g}: pairs {int(out.n_pairs)} culled "
              f"{int(out.n_culled)} contrib {int(out.n_contrib)} "
              f"(pair_budget {pair_fit}, kept {kept}); frame ms of {FRAME_REPS} "
              f"synced: median {statistics.median(times):.3f} min {min(times):.3f} "
              f"max {max(times):.3f}; stages "
              + " ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()), flush=True)
        results.append(dict(view=deg, out=out, n_pairs=n_pairs, n_culled=n_culled,
                            ms=statistics.median(times), stages=stage_ms))
    return renders, results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    try:
        from gsplat_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the gsplat_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    s = Smoke()
    torch.set_grad_enabled(False)

    s.phase("env")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc_v = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                            text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"  card: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, nvcc: {nvcc_v}", flush=True)

    s.phase("build")
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{k} {v:.1f}s" for k, v in built.items()), flush=True)

    s.phase("oracle")
    phase_oracle(s)

    with tempfile.TemporaryDirectory() as tmp:
        s.phase("scene sparse")
        t0 = time.perf_counter()
        raw, cam_args, target = build_scene(N, W, H, target_pairs_per_gaussian=2.25,
                                            tile_size=32)
        g = load_scene(raw, tmp, "sparse")
        del raw
        print(f"  sparse scene: {N} Gaussians, capacity {g.capacity}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        k_sparse, l_sparse, n_sparse, sparse, t_sparse = run_cell(
            s, "sparse", g, cam_args, (0.0, 2.0, -3.0, 5.0), SPARSE_BUDGET, target)
        bench = sparse[0]
        for what, got, ref in (("n_pairs", int(bench["out"].n_pairs), REF_SPARSE_PAIRS),
                               ("n_culled", int(bench["out"].n_culled),
                                REF_SPARSE_CULLED)):
            s.check(abs(got - ref) <= 1e-3 * ref,
                    f"sparse bench view {what} {got} vs JAX package {ref}: "
                    f"diff {got - ref:+d} ({(got - ref) / ref:+.5%}, tol 0.1%)")
        loss1 = t_sparse["losses"][0]
        s.check(abs(loss1 - REF_SPARSE_LOSS) <= 2e-4,
                f"sparse step-1 loss {loss1:.6f} vs JAX package {REF_SPARSE_LOSS} "
                f"(diff {loss1 - REF_SPARSE_LOSS:+.2e}, tol 2e-4)")
        del g, sparse, bench, target
        torch.cuda.empty_cache()

        s.phase("scene dense")
        raw, cam_args, target = build_scene(N, W, H, target_pairs_per_gaussian=33.0,
                                            tile_size=32)
        g = load_scene(raw, tmp, "dense")
        del raw
        k_dense, l_dense, n_dense, dense, t_dense = run_cell(
            s, "dense", g, cam_args, (0.0,), DENSE_BUDGET, target)
        got = int(dense[0]["out"].n_culled)
        s.check(abs(got - REF_DENSE_CULLED) <= 1e-3 * REF_DENSE_CULLED,
                f"dense n_culled {got} vs JAX package {REF_DENSE_CULLED}: diff "
                f"{got - REF_DENSE_CULLED:+d} "
                f"({(got - REF_DENSE_CULLED) / REF_DENSE_CULLED:+.5%}, tol 0.1%)")
    launches = {k: l_sparse[k] + l_dense[k] for k in l_sparse}
    print(f"  main path: {n_sparse + n_dense} renders, {TRAIN_STEPS['sparse']} + "
          f"{TRAIN_STEPS['dense']} train steps")
    print("kernels " + json.dumps(launches))

    for k in k_sparse + k_dense:
        t_bytes = k.pop("bytes") / PEAK_BYTES * 1e3
        t_ops = k.pop("ops") / k.pop("peak_ops", PEAK_FP32) * 1e3
        k.update(launches=launches[k["name"]], bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    for k in k_dense:
        print(f"  dense {k['name']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
    rows = []
    for k, kd in zip(k_sparse, k_dense):
        rows.append(dict(k, max_abs_err=max(k["max_abs_err"], kd["max_abs_err"])))
    print(json.dumps({"kernels": rows}))
    print(card)
    if s.failures:
        print(f"chip_smoke: {len(s.failures)} check(s) failed", file=sys.stderr)
        for f in s.failures:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
