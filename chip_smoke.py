#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (gsplat_tpu_torch): the forward render
path and the training step at 1M Gaussians and 1920x1080 on one NVIDIA GPU,
at tile 32 and at tile 64, the render CLI over a dataset on disk, and the
training CLI: from a checkpoint of the 1M scene, and 1000 iterations of the
repo's quality-proxy scene held to the JAX package's record.

    python3 chip_smoke.py

Phases (any failure exits nonzero, and the final ok line is not printed):
  env      card name + power limit (nvidia-smi), torch / CUDA / nvcc versions
  build    nvcc builds gsplat_tpu_torch/csrc/*.cu into build/kernels/; the
           registers and spills of every kernel (ptxas -v; each pixel-pass
           count of composite_fwd and composite_bwd): no spills
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
           of kept pairs past each tile's saturation exit; the share of
           (warp, pair) groups the kernel's exact skip passes over and the
           bound recounted from it (12 operations for a pair-pixel whose
           power lies below its pair's threshold, 31 for the rest)
  composite_bwd  the kernel against its plain version on the same table and
           the cotangent of the real photometric loss, at the contrib budget
           bench.py fits: keys bit-equal, each d column within 1e-4 of its
           max; the same bits from two launches; the share of (warp, pair)
           groups its exact skip passes over (composite_fwd's pixel layout,
           over the replayed chunks) and the bound recounted from it (12
           operations below the threshold, 65 for the rest) beside the
           bound at 65 everywhere
  segment_ends   the kernel against its plain version on the kernel's
           d-table keys after the gid-key sort, and on crafted key rows with
           long runs of gids that own no rows (gid 0 onwards, the middle,
           past the last key, every key KEY_INVALID, no keys, one gid):
           bit-equal; its ms beside torch.searchsorted's
  segment_sum    the per-Gaussian reduction on the same d-table: the same
           bits from two calls, within 1e-6 of each column's max of its
           plain version and one ulp of it of a float64 index_add_; its ms
           beside the float64 cumsum path it replaced (in turns) and the
           index_add_
  expand_pairs sat_pack (dense)  the kernel against its plain version with
           the saturation quanta packed under the gids: bit-equal; the
           count of nonzero quanta
  prefix_sum_small  the kernel against its plain version on the view's real
           sorted quanta (the kept prefix of the saturation cull's input;
           sparse at pair and sat budget 2,621,440, dense at the fitted
           budgets), on a length that is no multiple of its 8192-element
           tile, and with a bias and a clip: bit-equal; one call enqueues
           one kernel and at most one memset (a CUDA graph capture); its ms and
           torch.cumsum's, timed in turns
  compact_runs   the kernel against its plain version on the same view's
           real regions, into a buffer poisoned with a sentinel: bit-equal
           (region rows copied, the null gid elsewhere), no sentinel left;
           at a starved budget whose regions overlap and pass the end: it
           syncs without error, no sentinel is left, every row one region
           covers equals the plain version's and no row two cover holds the
           fill; one call enqueues one kernel and no memset
           (a CUDA graph capture); the ms of the reference's src-map gather
           (index_select with the map precomputed)
  serve    render() with per-view and per-stage ms: the sparse cell (2.25
           tile pairs per Gaussian) for 4 views, the bench camera + 3 yaw
           turns; the dense cell (33 tile pairs per Gaussian) for the bench
           camera
  serve sparse sat probe  one render at pair and sat budget 2,621,440:
           n_sat within 0.1% of the JAX package's 2,176,896, n_dropped 0,
           the image bit-equal to the render without the cull
  serve dense sat  the saturation cull probed as scripts/serving_bench.py
           does (sat_budget = kept): n_sat within 0.1% of the JAX package's
           1,823,232; then rendered at the fitted sat budget (n_sat rounded
           up to a chunk, plus a chunk): the image bit-equal and nproc equal
           in every tile to the same view's render without the cull,
           n_dropped 0; frame and stage ms and the device busy share
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
           gid keys (also printed: the float64 cumsum table's error and a
           float32 cumsum's). Synced step ms, one step's stage ms (CUDA
           events), and the device busy share, operation count and top
           kernels of the last step (torch.profiler)
  train dense sat  3 dense steps with the saturation cull on (its budget
           probed at the fitted budgets, with 1.2x headroom): the step-1
           loss, d-table and per-Gaussian gradient table bit-equal to the
           dense step 1 without the cull; every step n_sat within its budget
           and n_dropped 0; the checks of the train phase
  step gradients twice  two gradient passes of one train step at the bench
           view (render, loss, torch.autograd.grad): equal bits in every
           parameter group
  tile 64  composite_fwd and composite_bwd at tile 64 (four pixel passes)
           against their plain versions on the bench view's real pair table
           and loss cotangent (the checks above, the skip census and the
           bound recounted at that tile); then a served frame (timed) and one
           train step at tile 64, its loss within 2e-4 of the tile-32 step 1
  render_cli (sparse)  after the sparse cell: a COLMAP source written with
           the port's writers (a PINHOLE camera whose focal lengths give
           back fovx 1.2 and fovy 0.8; the bench view and the yaw +2, -3,
           +5 degree views, each with the target image as its PNG; the
           first 2^18 of the scene's xyz as points3D.bin, read back equal)
           and a model directory holding the sparse scene's PLY as
           iteration 30000 with a cfg_args naming the source; then
           render_cli.main(--resolution 1 --eval) in process: every render
           PNG bit-equal to the quantised render of the Scene's own camera,
           the gt PNGs to the quantised target; the bench view (the test
           camera) n_pairs within 0.1% of the JAX package's 2,105,855; the
           default budget of 2^20 regrown until n_dropped is 0; K1 against
           its plain version on the bench view at each budget the CLI
           rendered it at (2^20 and 2^21 truncate), bit-equal. Printed: a
           frame's render device ms, its copy to the host and PNG encode,
           the regrowth renders, the decode ms of a 1080p PNG, whether the
           native library loaded. Then render_cli at the default
           --resolution -1: 1600x900 frames (the 1.6K cap), each equal to
           the render at that camera; K1 there as at 1080p, and K2 against
           its plain version at the bench view's final budget. Then a fresh Scene on the same source:
           create_from_pcd over the 2^18 points on the card, parameters
           finite, its wall time and the 3-NN search's share
  train cli (sparse, full width)  after render_cli, on its COLMAP source
           (the bench view the test camera, the 3 yaw views trained on, at
           --resolution 1): the sparse scene saved with a fresh Adam state
           as start.npz (loads back bit-equal); cli.main in process from
           it: 40 iterations, densify at 15 and 30 (threshold
           TRAIN_GRAD_THRESHOLD), the opacity reset at 30, sat probes every
           10, eval and a checkpoint at 20, the default pair budget 2^20
           regrown by the loop, the capacity grown past 2^20 and the live
           rows past 2^20 (at most 2^22); losses finite, n_dropped 0 at the
           final budget (its steps, and the final state rendered at it on
           the 4 cameras: the last regrowth may fall on iteration 40),
           metrics.jsonl, TB events, the eval line and the final PLY. K1 (at the truncating budget and the final one),
           K2-K4, segment_sum, and K5 and K6 on one _sat_probe's inputs,
           against their plain versions on the state after the last
           densify (pairs with gids above 2^20). Then the CLI resumed from
           chkpnt20: the final checkpoint's arrays and PLY bit-equal to the
           straight run's. Then densify_and_prune on the card against the
           CPU on the loop's state at iteration 15 and its noise: the row
           choice, n_live and n_dropped bit-equal, floats within 1e-6.
           Printed: step ms (median, min, max), densify ms and n_live,
           regrowths, checkpoint seconds and bytes, eval ms, probes
  train quality (1k, tile 16)  after the dense cell: scripts/
           quality_proxy.py --iters 1000 at its defaults with the port (the
           120-camera textured scene of scripts/selfcheck_train.py rendered
           by the port at tile 16, 960x540, 60,000 Gaussians), cli.main;
           held to artifacts/qproxy_sat30/out/: cameras.json within 1e-6,
           the loss at 100 and 200 within 2%, n_gaussians at 700 within
           1%, the test PSNR at 1000 within 0.3 dB of 38.648; K2 and K3
           against their plain versions at tile 16 on one of its views.
           Printed: it/s, densify and eval events, the contrib budget fit,
           the scene build and training wall times
The launch counts of the seven kernels are zeroed just before each serve,
each train, the tile-64 serve-and-train phase, each render_cli run and each
train CLI run (the main paths) and must cover every render and step run
there (K5 and K6 in the sat phases and the loop's probes; K1 and K2 in
render_cli); the
kernels line sums them and must show every kernel. The kernels JSON rows
hold the sparse bench view's times and bound for K1-K4 and segment_sum, the
dense view's for K5 and K6 (the cell whose users run the cull), the other
view's beside them (`other_view`), the largest error of the two cells and
the train phases' checks, the launches of each cell's main path, of
render_cli and of the two train phases beside their total
(`launches_by_view`),
and for K2 and K3 their times and bounds at tile 64 (`tile_64`).
Numbers are printed with the card they ran on; TF32 is switched off for
matmuls and cuDNN (the loss's blur pins full fp32 itself).
"""

from __future__ import annotations

import json
import math
import shutil
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
# the saturation cull's survivor rows (BENCH_r05.json sat_kept, dense_sat_kept)
REF_SPARSE_SAT, REF_DENSE_SAT = 2_176_896, 1_823_232
# the train phases' headroom over a fitted budget: the JAX loop's kept
# regrowth factor (loop.py:575), here for the sat budget too (the JAX loop
# starts it at n_sat plus a chunk and doubles it on overflow, loop.py:558)
SAT_HEADROOM = 1.2
REF_SPARSE_LOSS = 0.4129     # BENCH_r05.json "loss", the step-1 loss
ATOL = 2e-5
BWD_RTOL = 1e-4       # composite_bwd vs plain, of each d column's max
GRAD_RTOL = 1e-3      # per-Gaussian gradient table vs float64, of each column's max
# segment_sum against its plain version (float64 index_add_, atomics on the
# card), of each column's max: both round a float64 sum to float32 once
SUM_RTOL = 1e-6
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12
PEAK_INT32 = 33.5e12   # 64 int32 operations a clock a SM, half the fp32 rate
PEAK_FP64 = 33.5e12    # fp64 outside the tensor cores (NVIDIA data sheet)
# f32 operations per pair-pixel evaluation of composite_fwd: dx, dy (2),
# three products (3), the quadratic form (5: 3 mul, 2 add) and its negation
# (1), the power > 0 test and select (2), expf (~4: range reduction + ex2),
# op * G (1), the 1/255 test, clamp and select (3), w = alpha*t_exc*T (2),
# three colour multiply-adds (6), 1 - alpha and the running product (2)
K2_OPS_PER_EVAL = 31
# ... and of one whose power lies below its pair's skip threshold, where
# alpha is 0 whatever follows: the power (11) and the test against the
# threshold (1)
K2_OPS_PER_SKIP = 12
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
TILE_WIDE = 64    # the widest tile the compositing kernels run, in four pixel passes
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


def in_turns(fns, reps):
    """device_ms of each of fns, measured in turns (a b b a for two) so that
    a drift of the card's clock or temperature falls on both -> [ms]."""
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    got = [[] for _ in fns]
    for i in order:
        got[i].append(device_ms(fns[i], reps))
    return [sum(v) / len(v) for v in got]


# CUgraphNodeType (cuda.h)
CU_GRAPH_NODE_KERNEL, CU_GRAPH_NODE_MEMSET = 0, 2


def enqueued(fn):
    """(kernels, memsets, a note) of what one call of fn() puts on the
    card: the call captured into a CUDA graph, its nodes counted through
    libcuda (cuGraphGetNodes, cuGraphNodeGetType). A capture holds every
    launch on the stream; a torch.profiler trace of a call of one short
    kernel came back empty now and then on an H100. The note
    counts the other nodes, or says why the capture failed (0, 0 then)."""
    import ctypes

    def cu(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    try:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            fn()
        libcuda = ctypes.CDLL("libcuda.so.1")
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        cu(libcuda.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        cu(libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        kinds = []
        for node in nodes[:n.value]:
            kind = ctypes.c_int(-1)
            cu(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
            kinds.append(kind.value)
        del graph
    except (RuntimeError, OSError, AttributeError, TypeError) as e:
        return 0, 0, f"capture failed: {e!r}"
    kernels, memsets = kinds.count(CU_GRAPH_NODE_KERNEL), kinds.count(CU_GRAPH_NODE_MEMSET)
    return kernels, memsets, f"{len(kinds) - kernels - memsets} other node(s)"


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


def fit_budgets(g, cam, budget, tile=TILE):
    """scripts/serving_bench.py's probe: bin with kept_budget = budget - 128
    (which turns the tight cull on), then fit both budgets to the counts."""
    from gsplat_tpu_torch.render.binning import bin_gaussians
    from gsplat_tpu_torch.render.project import project_gaussians

    p = project_gaussians(g, cam)
    b = bin_gaussians(p.mean2d, p.radius, p.depth, width=cam.width,
                      height=cam.height, tile_size=tile, chunk=CHUNK,
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


def expand_check(s, label, g, cam, S, kept, size=None, tile=TILE):
    """K1 against its plain version on the camera's expansion table at pair
    budget S and the tile size, every slot's key and gid bit-equal ->
    (table, total, kwargs, max |diff|)."""
    from gsplat_tpu_torch.render import expand
    from gsplat_tpu_torch.render.binning import depth_shift, expansion_table, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians

    tw, th = tile_grid(*(size or (W, H)), tile)
    db = depth_shift(tw * th)
    do_cull = S < 8 * g.capacity or kept < S      # bin_gaussians' rule
    p = project_gaussians(g, cam)
    table, total = expansion_table(p.mean2d, p.radius, p.depth, p.conic, p.opacity,
                                   tw=tw, th=th, tile_size=tile, db=db,
                                   do_cull=do_cull)
    kw = dict(tw=tw, tile_size=tile, db=db, num_tiles=tw * th, n_orig=g.capacity,
              do_cull=do_cull)
    key_k, gid_k = expand.expand_pairs(table, total, S, **kw)
    key_p, gid_p = expand.expand_pairs_plain(table, total, S, **kw)
    torch.cuda.synchronize()
    bad = int(((key_k != key_p) | (gid_k != gid_p)).sum())
    s.check(bad == 0, f"{label} expand_pairs vs plain at S={S}, tile {tile}, cull {do_cull}, "
            f"total {int(total)}: {bad} mismatching slots (want 0)")
    err = max(int((key_k - key_p).abs().max()), int((gid_k - gid_p).abs().max()))
    return table, total, kw, err


def phase_expand(s, label, g, cam, pair_fit, kept):
    from gsplat_tpu_torch.render import expand

    S = pair_fit
    table, total, kw, err = expand_check(s, label, g, cam, S, kept)
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


def composite_check(s, label, g, cam, pair_fit, kept, tile=TILE, size=None):
    """K2 against its plain version on the camera's pair table: tiles within
    ATOL, nproc equal but where a tile's transmittance sits at T_EPS ->
    (gathered, tile starts, tile counts, tw, K2's tiles, K2's nproc, max
    |tiles diff|)."""
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.render.binning import bin_gaussians, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians
    from gsplat_tpu_torch.render.render import pair_table

    w, h = size or (W, H)
    tw, _ = tile_grid(w, h, tile)
    p = project_gaussians(g, cam)
    b = bin_gaussians(p.mean2d, p.radius, p.depth, width=w, height=h,
                      tile_size=tile, chunk=CHUNK, pair_budget=pair_fit,
                      cull_conic=p.conic, cull_opacity=p.opacity, kept_budget=kept)
    gathered = pair_table(p, b, kept)
    del p
    ts, tc = b.tile_start, b.tile_count
    tiles_k, np_k = raster.composite_fwd(gathered, ts, tc, tw=tw, tile_size=tile,
                                         chunk=CHUNK)
    tiles_p, np_p = raster.composite_fwd_plain(gathered, ts, tc, tw=tw,
                                               tile_size=tile, chunk=CHUNK)
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
                                               tile_size=tile, chunk=CHUNK)
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
    return gathered, ts, tc, tw, tiles_k, np_k, err


def phase_composite(s, label, g, cam, pair_fit, kept, tile=TILE):
    from gsplat_tpu_torch.render import raster

    gathered, ts, tc, tw, tiles_k, np_k, err = composite_check(s, label, g, cam, pair_fit,
                                                                kept, tile)
    # a tile's pairs past its exit: those beyond its nproc-th chunk of the
    # chunk-aligned grid its segment is swept on
    tc64 = tc.to(torch.int64)
    past = torch.minimum(torch.clamp(ts.to(torch.int64) % CHUNK + tc64
                                     - np_k.to(torch.int64) * CHUNK, min=0), tc64)
    n_past, n_kept = int(past.sum()), int(tc64.sum())
    ms = device_ms(lambda: raster.composite_fwd(gathered, ts, tc, tw=tw,
                                                tile_size=tile, chunk=CHUNK), 10)
    plain_ms, _ = wall_ms(lambda: raster.composite_fwd_plain(
        gathered, ts, tc, tw=tw, tile_size=tile, chunk=CHUNK))
    chunks = int(np_k.sum())
    census = skip_census(gathered, ts, tc, np_k, tw, tile)
    nbytes = chunks * CHUNK * 64 + tiles_k.numel() * 4 + 3 * ts.numel() * 4
    print(f"  {label} composite_fwd: {ms:.4f} ms, plain {plain_ms:.2f} ms; "
          f"{chunks} chunks composited, {census[0] / 1e9:.3f} G pair-pixel evaluations; "
          f"kept pairs past their tile's saturation exit {n_past} of {n_kept} "
          f"({n_past / max(n_kept, 1):.2%})")
    ops = skip_bound(f"{label} composite_fwd", census, K2_OPS_PER_EVAL)
    return dict(name="composite_fwd", route="cuda",
                source="gsplat_tpu_torch/csrc/composite_fwd.cu",
                replaces="gsplat_tpu/render/raster_pallas.py:536",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
                library_ms=None)


def skip_bound(what, census, ops_per_eval):
    """Print a compositor's skip census and the bound recounted from it:
    K2_OPS_PER_SKIP operations a pair-pixel below its pair's threshold,
    ops_per_eval the others -> those operations."""
    evals, below, groups, skipped = census
    ops = below * K2_OPS_PER_SKIP + (evals - below) * ops_per_eval
    print(f"  {what} skip: {skipped} of {groups} (warp, pair) groups skip "
          f"({skipped / max(groups, 1):.2%}); {below} of {evals} pair-pixel evaluations "
          f"({below / max(evals, 1):.2%}) lie below their pair's threshold; bound "
          f"{below} x {K2_OPS_PER_SKIP} + {evals - below} x {ops_per_eval} operations = "
          f"{ops / PEAK_FP32 * 1e3:.4f} ms (all at {ops_per_eval}: "
          f"{evals * ops_per_eval / PEAK_FP32 * 1e3:.4f} ms)", flush=True)
    return ops


def skip_census(gathered, ts, tc, nproc, tw, tile=TILE):
    """What composite_fwd's (or composite_bwd's) inputs need, counted with
    plain torch over each tile's first nproc chunks (those composited, or
    replayed): the (pair, pixel) evaluations, those whose power lies below
    the pair's skip threshold (alpha 0 there whatever follows), the (warp,
    pair) groups at the kernels' pixel layout, and those whose every pixel
    lies below (the groups the kernels skip) -> (evals, below, groups,
    skipped)."""
    from gsplat_tpu_torch.render import raster

    dev = gathered.device
    npix, h = tile * tile, tile // 2
    blocks = raster.fwd_pixel_blocks(tile).to(dev)
    assert bool((blocks >= 0).all())
    # tile pixels in warp order: a warp's pixels are 128 in a row
    by_warp = blocks.reshape(-1, 32 * 4)
    pix = torch.arange(npix, device=dev)
    px = (pix % tile - h).to(torch.float32)
    py = (pix // tile - h).to(torch.float32)
    lane = torch.arange(CHUNK, device=dev)
    start, count, np64 = ts.to(torch.int64), tc.to(torch.int64), nproc.to(torch.int64)
    astart = start // CHUNK * CHUNK
    head = start - astart
    evals = below_n = groups = skipped = 0
    for j in range(int(np64.max()) if np64.numel() else 0):
        live = torch.nonzero(np64 > j).squeeze(1)
        for b0 in range(0, live.numel(), 256):
            t = live[b0:b0 + 256]
            idx = j * CHUNK + lane
            a = gathered[astart[t, None] + idx]                 # (B, chunk, 16)
            ok = (idx >= head[t, None]) & (idx < (head + count)[t, None])
            ox = ((t % tw) * tile + h).to(torch.float32)
            oy = ((t // tw) * tile + h).to(torch.float32)
            dx = px - (a[..., 0] - ox[:, None])[..., None]      # (B, chunk, npix)
            dy = py - (a[..., 1] - oy[:, None])[..., None]
            power = -((0.5 * a[..., 2:3]) * (dx * dx) + a[..., 3:4] * (dx * dy)
                      + (0.5 * a[..., 4:5]) * (dy * dy))
            below = power < raster.skip_threshold(a[..., 8] * ok)[..., None]
            evals += below.numel()
            below_n += int(below.sum())
            warp_all = below[..., by_warp].all(-1)              # (B, chunk, warps)
            groups += warp_all.numel()
            skipped += int(warp_all.sum())
    return evals, below_n, groups, skipped


def fit_contrib(n_contrib):
    """bench.py:241's contrib budget: the replayed rows, rounded up to 512,
    plus 512."""
    return -(-int(n_contrib) // 512) * 512 + 512


def loss_cotangent(gathered, ts, tc, tw, th, target, tile=TILE, size=None):
    """The forward tiles of a pair table and the cotangent of the real
    photometric loss (bg 0) with respect to them."""
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.train.loss import photometric_loss

    tiles, nproc = raster.composite_fwd(gathered, ts, tc, tw=tw, tile_size=tile,
                                        chunk=CHUNK)
    with torch.enable_grad():
        t = tiles.clone().requires_grad_()
        rgb, _ = raster.untile_image(t, tw, th, tile, *(size or (W, H)))
        (g,) = torch.autograd.grad(photometric_loss(rgb, target), [t])
    return tiles, nproc, g.contiguous()


def phase_backward(s, label, g, cam, target, pair_fit, kept, tile=TILE, size=None):
    """composite_bwd against its plain version at the bench view's fitted
    budgets, on its real pair table and loss cotangent -> (K3 row, the
    kernel's d-table)."""
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.render.binning import bin_gaussians, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians
    from gsplat_tpu_torch.render.render import contrib_regions, pair_table

    s.phase(f"kernel composite_bwd ({label})")
    w, h = size or (W, H)
    tw, th = tile_grid(w, h, tile)
    p = project_gaussians(g, cam)
    b = bin_gaussians(p.mean2d, p.radius, p.depth, width=w, height=h,
                      tile_size=tile, chunk=CHUNK, pair_budget=pair_fit,
                      cull_conic=p.conic, cull_opacity=p.opacity, kept_budget=kept)
    gathered = pair_table(p, b, kept)
    del p
    ts, tc = b.tile_start, b.tile_count
    tiles, nproc, g_tiles = loss_cotangent(gathered, ts, tc, tw, th, target, tile, size)
    contrib = fit_contrib(int(nproc.sum()) * CHUNK)
    np_c, comp_start, overflow = contrib_regions(nproc, CHUNK, contrib)
    args = (gathered, ts, tc, comp_start, np_c, tiles, g_tiles)
    kw = dict(tw=tw, tile_size=tile, chunk=CHUNK, p_out=contrib)
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
    census = skip_census(gathered, ts, tc, np_c, tw, tile)
    # the wrapper fills a fresh d-table before each launch: its time, less
    # that of the fill alone, is the kernel's
    ms = (device_ms(lambda: raster.composite_bwd(*args, **kw), 20)
          - device_ms(lambda: raster.d_table_prefilled(contrib, d_k.device), 20))
    plain_ms, _ = wall_ms(lambda: raster.composite_bwd_plain(*args, **kw))
    # the replayed pair rows read once, tiles and cotangent read once, the
    # four tile tables, the replayed d-rows written once
    nbytes = rows * 64 + 2 * tiles.numel() * 4 + 4 * ts.numel() * 4 + rows * 64
    print(f"  {label} composite_bwd: {ms:.4f} ms, plain {plain_ms:.2f} ms; {rows} rows "
          f"replayed, {census[0] / 1e9:.3f} G pair-pixel evaluations", flush=True)
    ops = skip_bound(f"{label} composite_bwd", census, K3_OPS_PER_EVAL)
    k3 = dict(name="composite_bwd", route="cuda",
              source="gsplat_tpu_torch/csrc/composite_bwd.cu",
              replaces="gsplat_tpu/render/raster_pallas.py:618",
              max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
              library_ms=None)
    return k3, d_k


def long_gap_rows(n, device):
    """Sorted f32 key rows over n gids with long runs of gids that own no
    rows -> {name: keys}: gid 0 and the n/10 after it empty, a run of n/10
    in the middle, every gid past n/1000 empty, every key KEY_INVALID, no
    keys, and every key one gid; each but the empty one with an inert tail."""
    from gsplat_tpu_torch.render.raster import KEY_INVALID

    rng = np.random.default_rng(11)
    rows = {
        "leading": np.sort(rng.integers(n // 10, n, n // 4)),
        "middle": np.sort(np.concatenate([rng.integers(0, n // 2, n // 5),
                                          rng.integers(n // 2 + n // 10, n, n // 5)])),
        "tail": np.sort(rng.integers(0, max(n // 1000, 1), n // 20)),
        "all invalid": np.full(n // 5, KEY_INVALID),
        "empty": np.zeros(0),
        "one gid": np.full(n // 10, n // 3),
    }
    out = {}
    for name, keys in rows.items():
        k = np.full(keys.shape[0] + (1000 if keys.size else 0), KEY_INVALID, np.float32)
        k[:keys.shape[0]] = keys
        out[name] = torch.from_numpy(k).to(device)
    return out


def phase_ends(s, label, d, n):
    """segment_ends against its plain version on the kernel's d-table keys
    after the gid-key sort, and on crafted rows with long gaps -> K4 row."""
    from gsplat_tpu_torch.render import bounds, raster

    s.phase(f"kernel segment_ends ({label})")
    key_s, _ = torch.sort(d[:, raster.KEY_COL], stable=True)
    e_k = bounds.segment_ends(key_s, n)
    e_p = bounds.segment_ends_plain(key_s, n)
    torch.cuda.synchronize()
    bad = int((e_k != e_p).sum())
    s.check(bad == 0, f"{label} segment_ends vs plain over {key_s.shape[0]} keys, "
            f"{n} Gaussians: {bad} mismatching ends (want 0)")
    crafted = {name: int((bounds.segment_ends(k, n) != bounds.segment_ends_plain(k, n)).sum())
               for name, k in long_gap_rows(n, d.device).items()}
    s.check(not any(crafted.values()), f"{label} segment_ends vs plain on crafted rows with "
            f"long gaps, {n} gids: mismatching ends {crafted} (want 0 each)")
    q = torch.arange(1, n + 1, device=key_s.device).to(torch.float32)
    ms4 = device_ms(lambda: bounds.segment_ends(key_s, n), 20)
    plain4 = device_ms(lambda: bounds.segment_ends_plain(key_s, n), 20)
    lib4 = device_ms(lambda: torch.searchsorted(key_s, q, side="left"), 20)
    live = int(e_k[-1])
    print(f"  {label} segment_ends: {ms4:.4f} ms, plain {plain4:.4f} ms, "
          f"torch.searchsorted {lib4:.4f} ms ({key_s.shape[0]} keys, {live} of them live)",
          flush=True)
    # one pass: a compare and a conversion per key, the gids' stores
    return dict(name="segment_ends", route="cuda",
                source="gsplat_tpu_torch/csrc/segment_ends.cu",
                replaces="gsplat_tpu/render/bounds_pallas.py:44",
                max_abs_err=float((e_k - e_p).abs().max()), ms=ms4, plain_ms=plain4,
                bytes=key_s.numel() * 4 + n * 4, ops=4 * key_s.numel() + n,
                peak_ops=PEAK_INT32, library_ms=lib4)


def cumsum_reduction(d, perm, ends, n_rows, dtype=torch.float64):
    """The per-Gaussian reduction segment_sum replaced (in float64), and the
    reference's (in float32): the sorted rows gathered, a column-major
    cumsum table with a leading zero, its entries at the segment ends and
    their adjacent difference."""
    from gsplat_tpu_torch.render.raster import ATTR_DIM, N_DCOLS

    cols = d.index_select(0, perm)[:, :N_DCOLS].t().to(dtype).contiguous()
    S = torch.zeros((N_DCOLS, d.shape[0] + 1), dtype=dtype, device=d.device)
    for i in range(N_DCOLS):
        torch.cumsum(cols[i], 0, out=S[i, 1:])
    T_b = S.index_select(1, ends)
    out = d.new_zeros((n_rows, ATTR_DIM))
    out[:n_rows - 1, :N_DCOLS] = (
        T_b - torch.cat([T_b.new_zeros((N_DCOLS, 1)), T_b[:, :-1]], dim=1)).t()
    return out


def phase_reduce(s, label, d, n_rows):
    """segment_sum on the view's real d-table: against its plain version, a
    float64 index_add_ and the float64 cumsum path it replaced; the same
    bits from two calls -> its row."""
    from gsplat_tpu_torch.render import bounds, raster, reduce

    s.phase(f"kernel segment_sum ({label})")
    key = d[:, raster.KEY_COL]
    key_s, perm = torch.sort(key, stable=True)
    ends = bounds.segment_ends(key_s, n_rows - 1)
    t_k = reduce.segment_sum(d, perm, ends, n_rows)
    t_k2 = reduce.segment_sum(d, perm, ends, n_rows)
    t_p = reduce.segment_sum_plain(d, perm, ends, n_rows)
    valid = key != raster.KEY_INVALID
    idx, rows64 = key[valid].long(), d[valid, :raster.N_DCOLS].double()
    ref = torch.zeros((n_rows, raster.N_DCOLS), dtype=torch.float64, device=d.device)
    ref.index_add_(0, idx, rows64)
    torch.cuda.synchronize()
    scale = ref.abs().amax(0).clamp(min=1e-300)
    rel_p = ((t_k[:, :raster.N_DCOLS] - t_p[:, :raster.N_DCOLS]).abs().amax(0).double()
             / scale).max().item()
    rel = ((t_k[:, :raster.N_DCOLS].double() - ref).abs().amax(0) / scale).tolist()
    live = int(ends[-1])
    same = torch.equal(t_k, t_k2)
    s.check(same and rel_p <= SUM_RTOL and max(rel) <= 2.0 ** -23
            and bool((t_k[:, raster.N_DCOLS:] == 0).all()),
            f"{label} segment_sum over {live} live rows of {d.shape[0]}, {n_rows} Gaussians: "
            f"the same bits twice {same}; vs plain {rel_p:.3g} of the column max (tol "
            f"{SUM_RTOL}); vs float64 index_add_ per column " + " ".join(f"{r:.3g}" for r in rel)
            + " (tol 2^-23, one ulp of the column max)")
    lengths = torch.diff(ends.long(), prepend=ends.new_zeros(1).long())
    print(f"  {label} segment_sum: segment lengths max {int(lengths.max())}, "
          f"{int((lengths > 8).sum())} of {n_rows - 1} Gaussians own more than 8 rows "
          f"(a warp sums those), {int((lengths == 0).sum())} own none", flush=True)
    del t_k2, t_p
    ms, old_ms = in_turns([lambda: reduce.segment_sum(d, perm, ends, n_rows),
                           lambda: cumsum_reduction(d, perm, ends, n_rows)], 10)
    plain_ms = device_ms(lambda: reduce.segment_sum_plain(d, perm, ends, n_rows), 5)
    lib_ms = device_ms(lambda: torch.zeros_like(ref).index_add_(0, idx, rows64), 10)
    sort_ms = device_ms(lambda: torch.sort(key, stable=True), 10)
    print(f"  {label} segment_sum: {ms:.4f} ms, plain {plain_ms:.4f} ms, float64 cumsum "
          f"path it replaced {old_ms:.4f} ms (in turns), float64 index_add_ {lib_ms:.4f} ms; "
          f"the key sort before both {sort_ms:.4f} ms", flush=True)
    # live rows read once through the permutation (64 bytes and 8 of perm),
    # each Gaussian's end read and its 64-byte row written once
    nbytes = live * (64 + 8) + (n_rows - 1) * 4 + n_rows * 64
    row = dict(name="segment_sum", route="cuda", source="gsplat_tpu_torch/csrc/segment_sum.cu",
               replaces="gsplat_tpu/render/render.py:137", max_abs_err=float(
                   (t_k[:, :raster.N_DCOLS].double() - ref).abs().max()),
               ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=live * raster.N_DCOLS,
               peak_ops=PEAK_FP64, library_ms=lib_ms, cumsum_path_ms=old_ms)
    return row


def phase_expand_sat(s, label, g, cam, pair_fit):
    """K1 with the saturation quanta packed under the gids, against its plain
    version at the view's fitted pair budget -> max |difference|."""
    from gsplat_tpu_torch.render import expand
    from gsplat_tpu_torch.render.binning import depth_shift, expansion_table, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians

    s.phase(f"kernel expand_pairs sat_pack ({label})")
    tw, th = tile_grid(W, H, TILE)
    db = depth_shift(tw * th)
    p = project_gaussians(g, cam)
    table, total = expansion_table(p.mean2d, p.radius, p.depth, p.conic, p.opacity,
                                   tw=tw, th=th, tile_size=TILE, db=db, do_cull=True)
    kw = dict(tw=tw, tile_size=TILE, db=db, num_tiles=tw * th, n_orig=g.capacity,
              do_cull=True, sat_pack=True)
    key_k, gid_k = expand.expand_pairs(table, total, pair_fit, **kw)
    key_p, gid_p = expand.expand_pairs_plain(table, total, pair_fit, **kw)
    torch.cuda.synchronize()
    bad = int(((key_k != key_p) | (gid_k != gid_p)).sum())
    kept = gid_k != g.capacity << expand.SAT_Q_BITS
    q = gid_k & ((1 << expand.SAT_Q_BITS) - 1)
    s.check(bad == 0, f"{label} expand_pairs sat_pack vs plain at S={pair_fit}: {bad} "
            f"mismatching slots (want 0); {int((q > 0).sum())} of {int(kept.sum())} kept "
            f"slots carry a nonzero quantum (max {int(q.max())})")
    return max(int((key_k - key_p).abs().max()), int((gid_k - gid_p).abs().max()))


def sat_kernel_inputs(g, cam, pair_budget, kept, sat, tile=TILE, size=None):
    """The view's real inputs of K5 and K6: bin with the saturation cull and
    capture what binning.saturation_cull receives -> (the sorted packed
    gids' kept prefix, the kept segments, the Binning)."""
    from gsplat_tpu_torch.render import binning
    from gsplat_tpu_torch.render.project import project_gaussians

    p = project_gaussians(g, cam)
    real, seen = binning.saturation_cull, {}

    def capture(gid_s, starts, tile_count, **kw):
        seen.update(src=gid_s[:kw["kept_budget"]], starts=starts, tile_count=tile_count)
        return real(gid_s, starts, tile_count, **kw)

    binning.saturation_cull = capture
    try:
        w, h = size or (W, H)
        b = binning.bin_gaussians(p.mean2d, p.radius, p.depth, width=w, height=h,
                                  tile_size=tile, chunk=CHUNK, pair_budget=pair_budget,
                                  cull_conic=p.conic, cull_opacity=p.opacity,
                                  kept_budget=kept, sat_budget=sat)
    finally:
        binning.saturation_cull = real
    return seen, b


def phase_scan(s, label, seen):
    """K5 against its plain version on the view's real sorted quanta -> (K5
    row, the prefix sums)."""
    from gsplat_tpu_torch.render import expand, scan

    s.phase(f"kernel prefix_sum_small ({label})")
    q = seen["src"] & ((1 << expand.SAT_Q_BITS) - 1)
    n = q.shape[0]
    c_k = scan.prefix_sum_small(q)
    c_p = scan.prefix_sum_small_plain(q)
    odd = n - 1001                      # no multiple of the 8192-element tile
    odd_eq = torch.equal(scan.prefix_sum_small(q[:odd]), c_p[:odd])
    hi = int(c_p[-1]) // 2
    clip_eq = torch.equal(scan.prefix_sum_small(q, bias=-7, clip_hi=hi),
                          scan.prefix_sum_small_plain(q, bias=-7, clip_hi=hi))
    torch.cuda.synchronize()
    bad = int((c_k != c_p).sum())
    s.check(bad == 0 and odd_eq and clip_eq,
            f"{label} prefix_sum_small vs plain over {n} sorted quanta (sum {int(c_p[-1])}): "
            f"{bad} mismatching sums (want 0); length {odd} equal {odd_eq}; bias -7 "
            f"clip {hi} equal {clip_eq}")
    kernels, memsets, note = enqueued(lambda: scan.prefix_sum_small(q))
    s.check(kernels == 1 and memsets <= 1,
            f"{label} prefix_sum_small: one call enqueues {kernels} kernel(s) and {memsets} "
            f"memset(s), {note} (a CUDA graph capture; want 1 kernel, at most 1 memset)")
    ms, lib_ms = in_turns([lambda: scan.prefix_sum_small(q),
                           lambda: torch.cumsum(q, 0, dtype=torch.int32)], 20)
    plain_ms = device_ms(lambda: scan.prefix_sum_small_plain(q), 20)
    print(f"  {label} prefix_sum_small: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.cumsum {lib_ms:.4f} ms ({n} elements); kernel / cumsum "
          f"{ms / lib_ms:.3f}, timed in turns; {8 * n / PEAK_BYTES * 1e3 / ms:.1%} of "
          "the 8-byte bound", flush=True)
    row = dict(name="prefix_sum_small", route="cuda",
               source="gsplat_tpu_torch/csrc/prefix_sum_small.cu",
               replaces="gsplat_tpu/render/scan_pallas.py:36",
               max_abs_err=float((c_k - c_p).abs().max()), ms=ms, plain_ms=plain_ms,
               bytes=8 * n, ops=n, peak_ops=PEAK_INT32, library_ms=lib_ms)
    return row, c_k


def covered_count(rbase, length, out_size):
    """(out_size,) int64: how many of the regions cover each row."""
    starts = torch.clamp(rbase.long(), 0, out_size)
    ends = torch.maximum(torch.clamp(rbase.long() + length.long(), 0, out_size), starts)
    cover = torch.zeros(out_size + 1, dtype=torch.int64, device=rbase.device)
    ones = torch.ones_like(starts)
    cover.index_add_(0, starts, ones).index_add_(0, ends, -ones)
    return torch.cumsum(cover, 0)[:out_size]


def phase_compact(s, label, seen, C, sat):
    """K6 against its plain version on the view's real regions, and on a
    starved budget, each into a buffer poisoned with a sentinel -> K6 row."""
    from gsplat_tpu_torch.render import compact
    from gsplat_tpu_torch.render.binning import sat_regions

    s.phase(f"kernel compact_runs ({label})")
    src, fill = seen["src"], 1 << 30   # packed gids (gid < 2^24) stay below 2^30
    sentinel = -(1 << 30)              # no gid, and not the fill
    astart, rbase, _, _, region, needed = sat_regions(
        C, seen["starts"], seen["tile_count"], chunk=CHUNK, sat_budget=sat)
    needed = int(needed)
    args = (src, astart, rbase, region, sat, fill)
    o_k = compact.compact_runs(*args, out=torch.full((sat,), sentinel, dtype=torch.int32,
                                                     device=src.device))
    o_p = compact.compact_runs_plain(*args)
    starved = max(-(-needed // 4 // CHUNK) * CHUNK, CHUNK)
    st = sat_regions(C, seen["starts"], seen["tile_count"], chunk=CHUNK,
                     sat_budget=starved)
    st_args = (src, st[0], st[1], st[4], starved, fill)
    o_s = compact.compact_runs(*st_args, out=torch.full((starved,), sentinel,
                                                        dtype=torch.int32, device=src.device))
    o_sp = compact.compact_runs_plain(*st_args)
    torch.cuda.synchronize()
    bad = int((o_k != o_p).sum())
    err = float((o_k - o_p).abs().max())
    n_fill = int((o_k == fill).sum())
    s.check(bad == 0 and needed <= sat and n_fill == sat - needed
            and int((o_k == sentinel).sum()) == 0,
            f"{label} compact_runs vs plain, into a poisoned buffer: {astart.shape[0]} regions, "
            f"{needed} region rows into {sat}: {bad} mismatching rows (want 0), {n_fill} fill "
            f"rows (want {sat - needed}), {int((o_k == sentinel).sum())} rows unwritten (want 0)")
    cover = covered_count(st[1], st[4], starved)
    once = cover == 1
    bad_once = int((o_s[once] != o_sp[once]).sum())
    left = int((o_s == sentinel).sum())
    s.check(o_s.shape == (starved,) and left == 0 and bad_once == 0
            and int((o_s[cover > 1] == fill).sum()) == 0,
            f"{label} compact_runs at a starved budget {starved} (regions overlap, the "
            f"largest is {int(region.max())} rows), into a poisoned buffer: synced without "
            f"error; {left} rows unwritten (want 0); of the {int(once.sum())} rows one region "
            f"covers, {bad_once} differ from the plain version (want 0); no fill in the "
            f"{int((cover > 1).sum())} rows two or more cover")
    del o_p, o_s, o_sp, cover, once
    kernels, memsets, note = enqueued(lambda: compact.compact_runs(*args))
    s.check(kernels == 1 and memsets == 0,
            f"{label} compact_runs: one call enqueues {kernels} kernel(s) and {memsets} "
            f"memset(s), {note} (a CUDA graph capture; want 1 kernel, no fill before it)")
    ms = device_ms(lambda: compact.compact_runs(*args), 20)
    plain_ms = device_ms(lambda: compact.compact_runs_plain(*args), 5)
    # the reference's src-map gather alone, its map precomputed
    off = (astart - rbase).long()
    delta = torch.zeros(sat + 1, dtype=torch.int64, device=src.device)
    delta.index_add_(0, rbase.long(), torch.cat([off[:1], off[1:] - off[:-1]]))
    idx = torch.clamp(torch.arange(sat, device=src.device) + torch.cumsum(delta, 0)[:sat],
                      0, src.shape[0] - 1)
    lib_ms = device_ms(lambda: src.index_select(0, idx), 20)
    print(f"  {label} compact_runs: {ms:.4f} ms (with the fill), plain {plain_ms:.4f} ms, "
          f"src-map index_select {lib_ms:.4f} ms ({needed} of {sat} rows)", flush=True)
    # each survivor row read once and written once, the rest of the output
    # filled, the three tile tables read
    nbytes = 4 * (needed + sat) + 3 * 4 * astart.shape[0]
    return dict(name="compact_runs", route="cuda",
                source="gsplat_tpu_torch/csrc/compact_runs.cu",
                replaces="gsplat_tpu/render/compact_pallas.py:40",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=0,
                library_ms=lib_ms)


def grad_table_check(s, label, d, table):
    """The per-Gaussian gradient table (segment_sum's) against a float64
    index_add_ of the d-table's rows by their gid keys, beside what the
    float64 cumsum path it replaced gives and what a float32 cumsum would
    give (the reference's reduction), as measurements."""
    from gsplat_tpu_torch.render import bounds, raster

    n_rows = table.shape[0]
    key = d[:, raster.KEY_COL]
    valid = key != raster.KEY_INVALID
    ref = torch.zeros((n_rows, raster.N_DCOLS), dtype=torch.float64, device=d.device)
    ref.index_add_(0, key[valid].long(), d[valid, :raster.N_DCOLS].double())
    scale = ref.abs().amax(0).clamp(min=1e-300)
    rel = ((table[:, :raster.N_DCOLS].double() - ref).abs().amax(0) / scale).tolist()
    key_s, perm = torch.sort(key, stable=True)
    ends = bounds.segment_ends_plain(key_s, n_rows - 1)
    rel64, rel32 = (
        ((cumsum_reduction(d, perm, ends, n_rows, dtype)[:, :raster.N_DCOLS].double() - ref)
         .abs().amax(0) / scale).tolist() for dtype in (torch.float64, torch.float32))
    s.check(max(rel) <= GRAD_RTOL and max(rel) <= max(max(rel64), 2.0 ** -23)
            and bool(torch.isfinite(table).all()),
            f"{label} step-1 per-Gaussian gradient table ({int(valid.sum())} d-rows) vs "
            "float64 index_add_, rel err per column: segment_sum "
            + " ".join(f"{r:.3g}" for r in rel) + f" (tol {GRAD_RTOL}, and no worse than the "
            "float64 cumsum table's or one ulp of the column max); the float64 cumsum table "
            "gives " + " ".join(f"{r:.3g}" for r in rel64) + "; a float32 cumsum would give "
            + " ".join(f"{r:.3g}" for r in rel32))
    return rel, rel32


def train_budgets(g, cam, bg, budget, tile=TILE):
    """The train phases' budgets at the view: fitted as bench.py fits them,
    with the headroom of the JAX training loop -> (pair, kept, contrib)."""
    from gsplat_tpu_torch.render.render import render

    pair_fit, kept, _, _ = fit_budgets(g, cam, budget, tile)
    probe = render(cam, g, bg, tile_size=tile, chunk=CHUNK, pair_budget=pair_fit,
                   kept_budget=kept)
    contrib = fit_contrib(probe.n_contrib)
    del probe
    # the steps move the Gaussians, and with them the pair, kept and
    # composited counts (+4.4% composited rows over the 10 sparse steps on
    # an H100): the headroom the JAX training loop gives its fitted
    # budgets, 1.2x kept (loop.py:575) and 1.5x contrib (loop.py:641)
    pair_fit = min(budget, -(-int(pair_fit * 1.2) // CHUNK) * CHUNK)
    kept = min(pair_fit, -(-int(kept * 1.2) // CHUNK) * CHUNK)
    contrib = -(-int(contrib * 1.5) // 512) * 512
    return pair_fit, kept, contrib


def step_gradients(g, cam, bg, tile, pair_fit, kept, contrib):
    """The gradients one make_train_step step takes (render, the
    photometric loss, torch.autograd.grad; the mean2d offset too) ->
    {group: gradient}."""
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loss import photometric_loss

    params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
    offset = torch.zeros((g.capacity, 2), device=g.device, requires_grad=True)
    with torch.enable_grad():
        out = render(cam, g.replace(**params), bg, tile_size=tile, chunk=CHUNK,
                     pair_budget=pair_fit, kept_budget=kept, contrib_budget=contrib,
                     mean2d_offset=offset)
        grads = torch.autograd.grad(photometric_loss(out.image, cam.image),
                                    list(params.values()) + [offset])
    return dict(zip(list(params) + ["mean2d_offset"], grads))


def grads_twice(s, label, g, cam_args, target, budget):
    """Two gradient passes of one train step on the same inputs at the bench
    view: equal bits in every parameter group."""
    from gsplat_tpu_torch.core.camera import make_camera

    s.phase(f"step gradients twice ({label})")
    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, image=target, device="cuda")
    bg = torch.zeros(3, device=g.device)
    fit = train_budgets(g, cam, bg, budget)
    a = step_gradients(g, cam, bg, TILE, *fit)
    b = step_gradients(g, cam, bg, TILE, *fit)
    torch.cuda.synchronize()
    differ = {k: int((a[k] != b[k]).sum()) for k in a}
    # the scene's splats are isotropic: their rotation gradient is 0
    zero = [k for k, v in a.items() if not bool((v != 0).any())]
    s.check(not any(differ.values()) and len(zero) < len(a),
            f"{label} bench view: two gradient passes of one train step, entries that "
            f"differ per group {differ} (want 0 each); groups that are all zero {zero}")


def train(s, label, g, cam_args, target, budget, steps, ref=None):
    """make_train_step at the fitted budgets for `steps` steps with the
    launch counts from zero -> (launches, step results). With `ref` (the
    results of the same cell's run without the cull) the saturation cull is
    on, and its step 1 must equal ref's bit for bit."""
    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render import render as render_mod
    from gsplat_tpu_torch.train.loop import make_train_step
    from gsplat_tpu_torch.train.optim import init_adam_state

    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, image=target, device="cuda")
    bg = torch.zeros(3, device=g.device)
    pair_fit, kept, contrib = train_budgets(g, cam, bg, budget)
    sat = None
    if ref is not None:
        probe = render_mod.render(cam, g, bg, tile_size=TILE, chunk=CHUNK,
                                  pair_budget=pair_fit, kept_budget=kept, sat_budget=kept)
        sat = min(kept, -(-int(int(probe.n_sat) * SAT_HEADROOM) // CHUNK) * CHUNK)
        del probe
    step_fn = make_train_step(OptimizationParams(), MeshParams(
        tile_size=TILE, chunk_size=CHUNK, pair_budget=pair_fit), 1.0, W, H,
        kept_budget=kept, contrib_budget=contrib, sat_budget=sat)
    opt_state = init_adam_state(g.params())
    print(f"  {label}: pair_budget {pair_fit}, kept {kept}, contrib {contrib}, sat {sat}",
          flush=True)

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
            g, opt_state, loss, ema, n_pairs, n_dropped, n_culled, n_contrib, n_sat = out
            losses.append(float(loss))
            if 1 < step < steps:
                times.append(step_ms)
            good = int(n_dropped) == 0 and int(n_contrib) <= contrib
            ok &= good and (sat is None or int(n_sat) <= sat)
            print(f"  {label} step {step}: loss {float(loss):.6f}, {step_ms:.3f} ms, pairs "
                  f"{int(n_pairs)} culled {int(n_culled)} contrib {int(n_contrib)} sat "
                  f"{int(n_sat)} dropped {int(n_dropped)}", flush=True)
            if step == 1:
                rel, rel32 = grad_table_check(s, label, captured["d"], captured["table"])
                step1 = dict(d=captured.pop("d"), table=captured.pop("table"))
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counts.items()}
    if ref is not None:
        same_cull_check(s, label, losses[0], step1, ref)
        step1 = None
    s.check(ok, f"{label}: every step n_dropped 0, n_contrib <= {contrib}"
            + ("" if sat is None else f" and n_sat <= {sat}"))
    finite = all(bool(torch.isfinite(t).all()) for d in
                 (g.params(), opt_state.mu, opt_state.nu) for t in d.values())
    s.check(finite, f"{label}: parameters and Adam moments finite after {steps} steps")
    s.check(losses[-1] < losses[0], f"{label}: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
            f"over {steps} steps")
    dmax = float(g.denom.max())
    s.check(dmax == steps and bool((g.denom <= steps).all()),
            f"{label}: denom max {dmax:g} (want {steps}, at most {steps} everywhere)")
    need = TRAIN_KERNELS + (SAT_KERNELS if sat is not None else ())
    s.check(all(launches[k] >= steps for k in need),
            f"{label} kernel launches {launches} cover its {steps} steps ({', '.join(need)})")
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
                          stages=stage_ms, step1=step1)


def same_cull_check(s, label, loss, step1, ref):
    """Step 1 with the saturation cull against step 1 without it: the loss,
    the d-table (K3's output, the reduction's input) and the per-Gaussian
    gradient table bit-equal (the reduction's order is fixed by the d-table
    alone)."""
    same_loss = loss == ref["losses"][0]
    d_ref, t_ref = ref["step1"]["d"], ref["step1"]["table"]
    same_d = torch.equal(step1["d"], d_ref)
    t = step1["table"]
    s.check(same_loss and same_d and torch.equal(t, t_ref),
            f"{label} step 1 vs without the cull: loss {loss!r} vs {ref['losses'][0]!r} "
            f"(bit-equal {same_loss}); d-table ({d_ref.shape[0]} rows) bit-equal {same_d}; "
            f"per-Gaussian gradient table: {int((t != t_ref).sum())} entries differ (want 0)")


def kernel_counts():
    from gsplat_tpu_torch.render import bounds, compact, expand, raster, reduce, scan

    return {"expand_pairs": expand.expand_pairs, "composite_fwd": raster.composite_fwd,
            "composite_bwd": raster.composite_bwd, "segment_ends": bounds.segment_ends,
            "segment_sum": reduce.segment_sum, "prefix_sum_small": scan.prefix_sum_small,
            "compact_runs": compact.compact_runs}


FWD_KERNELS = ("expand_pairs", "composite_fwd")
SAT_KERNELS = ("prefix_sum_small", "compact_runs")
TRAIN_KERNELS = ("expand_pairs", "composite_fwd", "composite_bwd", "segment_ends",
                 "segment_sum")


def run_cell(s, label, g, cam_args, views, budget, target):
    """The kernels against their plain versions at the bench view's fitted
    budgets, then the serve and train phases, with and without the
    saturation cull, each with the launch counts from zero -> ({kernel name:
    row}, launches of the main path, renders run, view results, train
    results)."""
    from gsplat_tpu_torch.core.camera import make_camera

    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, device="cuda")
    pair_fit, kept, _, _ = fit_budgets(g, cam, budget)
    s.phase(f"kernel expand_pairs ({label})")
    k1 = phase_expand(s, label, g, cam, pair_fit, kept)
    if label == "dense":
        k1["max_abs_err"] = max(k1["max_abs_err"], phase_expand_sat(s, label, g, cam, pair_fit))
    s.phase(f"kernel composite_fwd ({label})")
    k2 = phase_composite(s, label, g, cam, pair_fit, kept)
    target_t = torch.from_numpy(target).to(g.device)
    k3, d = phase_backward(s, label, g, cam, target_t, pair_fit, kept)
    k4 = phase_ends(s, label, d, g.capacity)
    k_sum = phase_reduce(s, label, d, g.capacity + 1)
    del d
    # K5 and K6 on the view's real cull inputs: the sparse view where its
    # regions fit (pair and sat budget SPARSE_BUDGET), the dense one at its
    # fitted budgets and the sat budget serve_sat fits
    if label == "sparse":
        seen, b = sat_kernel_inputs(g, cam, SPARSE_BUDGET, None, SPARSE_BUDGET)
        sat = SPARSE_BUDGET
    else:
        seen, b = sat_kernel_inputs(g, cam, pair_fit, kept, kept)
        sat = -(-int(b.n_sat) // CHUNK) * CHUNK + CHUNK
    del b
    k5, C = phase_scan(s, label, seen)
    k6 = phase_compact(s, label, seen, C, sat)
    del seen, C
    torch.cuda.empty_cache()

    # ---- the main path: counts from zero before each phase ----
    counts = kernel_counts()

    def zero():
        for f in counts.values():
            f.launches = 0

    def read(name, renders, sat_renders=0):
        """The counts, each forward kernel held to every render of the
        phase and each cull kernel to the renders that used the cull."""
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counts.items()}
        need = {**{k: renders for k in FWD_KERNELS}, **{k: sat_renders for k in SAT_KERNELS}}
        s.check(all(got[k] >= n for k, n in need.items()),
                f"{name} kernel launches {got} cover its {renders} renders "
                f"({', '.join(FWD_KERNELS)}), {sat_renders} with the cull "
                f"({', '.join(SAT_KERNELS)})")
        torch.cuda.empty_cache()
        return got

    zero()
    s.phase(f"serve {label}")
    renders, results = serve(s, g, cam_args, views, budget, label)
    launches = read(f"{label} serve", renders)
    zero()
    if label == "sparse":
        s.phase("serve sparse sat probe")
        n_renders, n_sat_renders = serve_sat_probe(s, g, cam_args, label)
    else:
        s.phase(f"serve {label} sat")
        n_renders, n_sat_renders, sat_result = serve_sat(s, g, cam_args, budget, label)
        results.append(dict(view="sat", **sat_result))
    renders += n_renders
    sat_launches = read(f"{label} sat serve", n_renders, n_sat_renders)
    s.phase(f"train {label}")
    t_launches, trained = train(s, label, g, cam_args, target, budget, TRAIN_STEPS[label])
    phases = [sat_launches, t_launches]
    if label == "dense":
        s.phase(f"train {label} sat")
        st_launches, trained["sat"] = train(s, f"{label} sat", g, cam_args, target, budget,
                                            TRAIN_STEPS[label], ref=trained)
        phases.append(st_launches)
    trained.pop("step1")
    torch.cuda.empty_cache()
    grads_twice(s, label, g, cam_args, target, budget)
    k2w, k3w, w_launches = wide_tile(s, label, g, cam_args, target, budget,
                                     trained["losses"][0], zero, counts)
    phases.append(w_launches)
    for more in phases:
        launches = {k: launches[k] + more[k] for k in launches}
    rows = {k["name"]: k for k in (k1, k2, k3, k4, k_sum, k5, k6)}
    rows["composite_fwd tile 64"], rows["composite_bwd tile 64"] = k2w, k3w
    return rows, launches, renders, results, trained


def wide_tile(s, label, g, cam_args, target, budget, loss1, zero, counts):
    """Tile 64, the widest the compositing kernels take (four pixel
    passes): K2 and K3 against their plain versions on the bench view's
    real pair table and loss cotangent, then, with the launch counts from
    zero, a served frame and one train step at tile 64, whose loss must
    stay within 2e-4 of the tile-32 step 1's `loss1` -> (K2 row, K3 row,
    launches)."""
    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loop import make_train_step
    from gsplat_tpu_torch.train.optim import init_adam_state

    wl = f"{label} tile {TILE_WIDE}"
    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, image=target, device="cuda")
    bg = torch.zeros(3, device=g.device)
    pair_fit, kept, _, _ = fit_budgets(g, cam, budget, TILE_WIDE)
    s.phase(f"kernel composite_fwd ({wl})")
    k2 = phase_composite(s, wl, g, cam, pair_fit, kept, TILE_WIDE)
    k3, d = phase_backward(s, wl, g, cam, cam.image, pair_fit, kept, TILE_WIDE)
    del d
    torch.cuda.empty_cache()
    pair_t, kept_t, contrib = train_budgets(g, cam, bg, budget, TILE_WIDE)
    step_fn = make_train_step(OptimizationParams(), MeshParams(
        tile_size=TILE_WIDE, chunk_size=CHUNK, pair_budget=pair_t), 1.0, W, H,
        kept_budget=kept_t, contrib_budget=contrib)
    opt_state = init_adam_state(g.params())

    def frame():
        return render(cam, g, bg, tile_size=TILE_WIDE, chunk=CHUNK, pair_budget=pair_fit,
                      kept_budget=kept)

    zero()
    s.phase(f"serve and train ({wl})")
    out = frame()
    times = [wall_ms(frame)[0] for _ in range(FRAME_REPS)]
    with torch.enable_grad():
        step_ms, res = wall_ms(lambda: step_fn(g, opt_state, cam, bg, 1, 0.0))
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counts.items()}
    g1, st1, loss, _, n_pairs, n_dropped, _, n_contrib, _ = res
    ok = int(out.n_dropped) == 0 and bool(torch.isfinite(out.image).all()) \
        and int(n_dropped) == 0 and int(n_contrib) <= contrib \
        and all(bool(torch.isfinite(t).all()) for t in g1.params().values())
    s.check(ok and abs(float(loss) - loss1) <= 2e-4,
            f"{wl}: frame n_dropped {int(out.n_dropped)}, finite; train step 1 loss "
            f"{float(loss):.6f} vs tile {TILE} {loss1:.6f} (diff {float(loss) - loss1:+.2e}, "
            f"tol 2e-4), n_dropped {int(n_dropped)}, contrib {int(n_contrib)} <= {contrib}, "
            "parameters finite")
    need = ("expand_pairs",) + TRAIN_KERNELS
    s.check(all(launches[k] >= 1 for k in need) and launches["composite_fwd"] >= 2 + FRAME_REPS,
            f"{wl} serve and train kernel launches {launches} cover its {2 + FRAME_REPS} "
            f"renders and 1 step ({', '.join(TRAIN_KERNELS)})")
    print(f"  {wl}: frame ms of {FRAME_REPS} synced: median {statistics.median(times):.3f} "
          f"min {min(times):.3f} max {max(times):.3f}; train step {step_ms:.3f} ms (step 1, "
          f"pair_budget {pair_t}, kept {kept_t}, contrib {contrib})", flush=True)
    del g1, st1, res, out
    torch.cuda.empty_cache()
    return k2, k3, launches

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


def serve_sat_probe(s, g, cam_args, label):
    """One render of the bench view at pair and sat budget SPARSE_BUDGET
    against the render without the cull -> (renders run, of them with the
    cull)."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render.render import render

    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, device="cuda")
    bg = torch.zeros(3, device=g.device)
    kw = dict(tile_size=TILE, chunk=CHUNK, pair_budget=SPARSE_BUDGET)
    # kept_budget < pair_budget turns the tight cull on, as the sat cull does
    base = render(cam, g, bg, **kw, kept_budget=SPARSE_BUDGET - CHUNK)
    out = render(cam, g, bg, **kw, sat_budget=SPARSE_BUDGET)
    torch.cuda.synchronize()
    n_sat, kept = int(out.n_sat), int(out.n_pairs) - int(out.n_culled)
    same = torch.equal(out.image, base.image)
    s.check(abs(n_sat - REF_SPARSE_SAT) <= 1e-3 * REF_SPARSE_SAT and int(out.n_dropped) == 0
            and same,
            f"{label} sat probe at pair and sat budget {SPARSE_BUDGET}: n_sat {n_sat} vs JAX "
            f"package {REF_SPARSE_SAT} (diff {n_sat - REF_SPARSE_SAT:+d}, tol 0.1%), "
            f"n_dropped {int(out.n_dropped)}, image bit-equal to the render without the "
            f"cull {same}; {kept} kept pairs (the regions outnumber them)")
    return 2, 1


def serve_sat(s, g, cam_args, budget, label):
    """The bench view with the saturation cull, fitted as
    scripts/serving_bench.py fits it, against the same view's render without
    the cull (image bit-equal, nproc equal in every tile) -> (renders run,
    of them with the cull, result)."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render import render as render_mod

    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, device="cuda")
    bg = torch.zeros(3, device=g.device)
    pair_fit, kept, _, _ = fit_budgets(g, cam, budget)

    def run(on_stage=None, sat=None):
        return render_mod.render(cam, g, bg, tile_size=TILE, chunk=CHUNK,
                                 pair_budget=pair_fit, kept_budget=kept, sat_budget=sat,
                                 on_stage=on_stage)

    n_sat = int(run(sat=kept).n_sat)
    sat = -(-n_sat // CHUNK) * CHUNK + CHUNK
    s.check(abs(n_sat - REF_DENSE_SAT) <= 1e-3 * REF_DENSE_SAT,
            f"{label} sat probe (sat_budget = kept {kept}): n_sat {n_sat} vs JAX package "
            f"{REF_DENSE_SAT} (diff {n_sat - REF_DENSE_SAT:+d}, "
            f"{(n_sat - REF_DENSE_SAT) / REF_DENSE_SAT:+.5%}, tol 0.1%)")
    nprocs, real = [], render_mod.composite_fwd

    def capture(*a, **kw):
        out = real(*a, **kw)
        nprocs.append(out[1])
        return out

    render_mod.composite_fwd = capture
    try:
        base = run()
        out = run(sat=sat)
    finally:
        render_mod.composite_fwd = real
    torch.cuda.synchronize()
    same = torch.equal(out.image, base.image)
    np_diff = int((nprocs[0] != nprocs[1]).sum())
    s.check(same and np_diff == 0 and int(out.n_dropped) == 0,
            f"{label} sat render at sat budget {sat}: image bit-equal to the render without "
            f"the cull {same}, nproc differs in {np_diff} of {nprocs[0].shape[0]} tiles "
            f"(want 0), n_dropped {int(out.n_dropped)}")
    del base, nprocs
    times = [wall_ms(lambda: run(sat=sat))[0] for _ in range(FRAME_REPS)]
    stages = StageEvents()
    run(on_stage=stages, sat=sat)
    stage_ms = stages.ms()
    busy_ms, n_ops, top, _ = device_busy(lambda: run(sat=sat))
    med = statistics.median(times)
    share = "not measured" if busy_ms is None else \
        f"{busy_ms:.3f} ms, {busy_ms / med:.1%} of the median frame"
    print(f"  {label} sat: pairs {int(out.n_pairs)} culled {int(out.n_culled)} sat "
          f"{n_sat} contrib {int(out.n_contrib)} (pair_budget {pair_fit}, kept {kept}, "
          f"sat {sat}); frame ms of {FRAME_REPS} synced: median {med:.3f} min "
          f"{min(times):.3f} max {max(times):.3f}; stages "
          + " ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()), flush=True)
    print(f"  {label} sat: device busy (torch.profiler) {share}, {n_ops} device "
          "operations; top kernels " + "; ".join(f"{k} {v:.3f} ms" for k, v in top),
          flush=True)
    return 5 + FRAME_REPS, 4 + FRAME_REPS, dict(n_sat=n_sat, sat=sat, ms=med,
                                                stages=stage_ms)


CLI_ITERATION = 30_000
CLI_POINTS = 1 << 18     # the source's sparse cloud: a real scene's holds 10^5-10^6
CLI_BUDGET = 1 << 20     # render_cli's default pair budget, below the bench view's pairs
# the source's views: (yaw degrees, shift of the camera centre along world x).
# The bench view is the test camera (llffhold 8); the three train views stand
# apart so that the cameras' extent (1.1 x the largest distance of a train
# centre from their mean) is CLI_SHIFT * 1.1 and densify's clone/split
# threshold percent_dense * extent (0.01 x 0.759) falls among the sparse
# scene's Gaussian scales (all 0.0076 at the start; Adam moves each): rows
# whose largest scale shrank clone, the others split
CLI_SHIFT = 0.69
CLI_VIEWS = ((0.0, 0.0), (2.0, CLI_SHIFT), (-3.0, -CLI_SHIFT), (5.0, 0.0))


def cli_view(cam_args, i):
    """View i of the CLI source (CLI_VIEWS): the bench camera turned by its
    yaw and its centre shifted along world x -> (R, T, fovx, fovy)."""
    deg, shift = CLI_VIEWS[i]
    R, T, fovx, fovy = yaw_camera(cam_args, deg)
    center = -R @ T + np.array([shift, 0.0, 0.0])
    return R, -R.T @ center, fovx, fovy


def write_cli_source(root, g, cam_args, target):
    """A COLMAP scene written with the port's own writers: one PINHOLE
    camera whose focal lengths give back fovx and fovy, the views of
    CLI_VIEWS as images 00000-00003 (llffhold 8 puts the bench view in the
    test set), the target image as each view's PNG,
    and the first CLI_POINTS of the scene's xyz as points3D.bin -> seconds
    of its parts."""
    from gsplat_tpu_torch.io import colmap, png

    R, T, fovx, fovy = cam_args
    sparse = Path(root) / "sparse" / "0"
    sparse.mkdir(parents=True)
    (Path(root) / "images").mkdir()
    colmap.write_intrinsics_binary({1: colmap.Camera(
        id=1, model="PINHOLE", width=W, height=H,
        params=np.array([W / (2 * math.tan(fovx / 2)), H / (2 * math.tan(fovy / 2)),
                         W / 2, H / 2]))}, sparse / "cameras.bin")
    images = {}
    for i in range(len(CLI_VIEWS)):
        Ri, Ti = cli_view(cam_args, i)[:2]
        images[i + 1] = colmap.Image(id=i + 1, qvec=colmap.rotmat2qvec(Ri.T), tvec=Ti,
                                     camera_id=1, name=f"{i:05d}.png")
    colmap.write_extrinsics_binary(images, sparse / "images.bin")
    t0 = time.perf_counter()
    data = png.encode_png((np.clip(target, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    t_encode = time.perf_counter() - t0
    for img in images.values():
        (Path(root) / "images" / img.name).write_bytes(data)
    xyz = g.xyz[:CLI_POINTS].double().cpu().numpy()
    rgb = (g.f_dc[:CLI_POINTS].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    t0 = time.perf_counter()
    colmap.write_points3D_binary(xyz, rgb, np.zeros(CLI_POINTS), sparse / "points3D.bin")
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = colmap.read_points3D_binary(sparse / "points3D.bin")
    t_read = time.perf_counter() - t0
    same = np.array_equal(back[0], xyz) and np.array_equal(back[1], rgb)
    return dict(encode=t_encode, points_write=t_write, points_read=t_read, points_same=same)


class CliTimer:
    """Wraps render_cli's render and save_png: per render, its device ms
    (CUDA events), wall ms, budget, n_pairs and n_dropped; per PNG, its
    encode ms and the host gap before it (the copy of the image to the
    host: render_set does nothing else between the render's end and
    save_png)."""

    def __init__(self, render_cli):
        self.mod, self.renders, self.saves = render_cli, [], []
        self.real = render_cli.render, render_cli.save_png
        self.last_end = None

    def __enter__(self):
        real_render, real_save = self.real

        def render(cam, g, bg, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            out = real_render(cam, g, bg, **kw)
            e1.record()
            torch.cuda.synchronize()
            self.last_end = time.perf_counter()
            self.renders.append(dict(
                cam=cam.image_name, width=cam.width, height=cam.height,
                budget=kw["pair_budget"], n_pairs=int(out.n_pairs),
                n_dropped=int(out.n_dropped), device_ms=e0.elapsed_time(e1),
                wall_ms=(self.last_end - t0) * 1e3))
            return out

        def save_png(path, img):
            t0 = time.perf_counter()
            real_save(path, img)
            self.saves.append(dict(path=Path(path), ms=(time.perf_counter() - t0) * 1e3,
                                   gap_ms=(t0 - self.last_end) * 1e3))
            self.last_end = time.perf_counter()

        self.mod.render, self.mod.save_png = render, save_png
        return self

    def __exit__(self, *exc):
        self.mod.render, self.mod.save_png = self.real


def run_cli(s, label, model, resolution, zero, counts):
    """render_cli.main over the model, the launch counts from zero ->
    (CliTimer, launches, wall seconds)."""
    from gsplat_tpu_torch import render_cli

    zero()
    t0 = time.perf_counter()
    with CliTimer(render_cli) as timer:
        rc = render_cli.main(["--model_path", str(model), "--resolution", str(resolution),
                              "--eval"])
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counts.items()}
    n = len(timer.renders)
    s.check(rc == 0 and all(launches[k] >= n for k in FWD_KERNELS),
            f"{label}: render_cli exit {rc}; kernel launches {launches} cover its {n} renders "
            f"({', '.join(FWD_KERNELS)})")
    return timer, launches, wall


def cli_frames(timer):
    """Each camera's written render: its last render (n_dropped 0), the
    renders before it (dropped pairs), and the two PNGs after it."""
    frames, pending = [], []
    saves = iter(timer.saves)
    for r in timer.renders:
        pending.append(r)
        if r["n_dropped"] == 0:
            frames.append(dict(final=r, regrown=pending[:-1], render_png=next(saves),
                               gt_png=next(saves)))
            pending = []
    return frames


def check_cli_pngs(s, label, model, scene, frames, split_of):
    """Every PNG the CLI wrote decodes bit-equal to the quantised render of
    the Scene's own camera (at the budget the CLI ended at) and, for gt, to
    its quantised target."""
    from gsplat_tpu_torch.io import png
    from gsplat_tpu_torch.render.render import render

    bg = torch.zeros(3, device=scene.gaussians.device)
    bad, n = [], 0
    for split, cams in (("train", scene.get_train_cameras()),
                        ("test", scene.get_test_cameras())):
        for idx, cam in enumerate(cams):
            budget = split_of[(split, idx)]["final"]["budget"]
            out = render(cam, scene.gaussians, bg, tile_size=TILE, chunk=CHUNK,
                         pair_budget=budget)
            want = (torch.clamp(out.image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
            gt = (torch.clamp(cam.image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
            base = Path(model) / split / f"ours_{CLI_ITERATION}"
            got = png.read_png(base / "renders" / f"{idx:05d}.png")
            got_gt = png.read_png(base / "gt" / f"{idx:05d}.png")
            n += 1
            if not (np.array_equal(got, want) and np.array_equal(got_gt, gt)
                    and got.shape == (cam.height, cam.width, 3)):
                bad.append(f"{split}/{idx:05d} ({int((got != want).sum())} render, "
                           f"{int((got_gt != gt).sum())} gt values differ)")
    s.check(n == 4 and not bad,
            f"{label}: {n} render PNGs (and their gt) decode bit-equal to the quantised render "
            f"of the Scene's own camera; mismatching: {bad or 'none'}")


def cli_kernel_checks(s, label, scene, split_of, composite=False):
    """K1 against its plain version on the bench view's camera at every
    budget the CLI rendered it at (the first ones truncate: its pairs
    exceed them), and, with `composite`, K2 against its plain version at
    the budget the CLI ended at, at the camera's own frame size."""
    cam, f = scene.get_test_cameras()[0], split_of[("test", 0)]
    size, budgets = (cam.width, cam.height), [r["budget"] for r in f["regrown"] + [f["final"]]]
    totals = [int(expand_check(s, f"{label} bench view {cam.width}x{cam.height}",
                               scene.gaussians, cam, S, S, size)[1]) for S in budgets]
    s.check(len(budgets) == 1 or totals[0] > budgets[0],
            f"{label}: K1 held to its plain version at the bench view's budgets {budgets} "
            f"(live slots {totals}), the truncating one among them when the CLI regrew")
    if composite:
        composite_check(s, f"{label} bench view {cam.width}x{cam.height}", scene.gaussians,
                        cam, budgets[-1], budgets[-1], size=size)
    torch.cuda.empty_cache()


def phase_render_cli(s, g, cam_args, target, tmp):
    """python -m gsplat_tpu_torch.render_cli over a COLMAP scene on disk
    rendering the bench model, at --resolution 1 and at the default -1
    (1600x900), then a fresh Scene on the same source -> launches."""
    from gsplat_tpu_torch.config import ModelParams
    from gsplat_tpu_torch.core import gaussians as gaussians_mod
    from gsplat_tpu_torch.io import native_loader, png
    from gsplat_tpu_torch.scene import Scene

    src, model = Path(tmp) / "cli_source", Path(tmp) / "cli_model"
    part = write_cli_source(src, g, cam_args, target)
    s.check(part["points_same"],
            f"points3D.bin of {CLI_POINTS} points reads back equal: written in "
            f"{part['points_write']:.3f} s, read in {part['points_read']:.3f} s")
    ply = model / "point_cloud" / f"iteration_{CLI_ITERATION}" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    shutil.copyfile(Path(tmp) / "sparse" / "point_cloud.ply", ply)
    (model / "cfg_args").write_text(
        f"Namespace(sh_degree=3, source_path='{src}', model_path='{model}', "
        "images='images', resolution=-1, white_background=False, data_device='cuda', "
        "eval=True)")
    counts = kernel_counts()

    def zero():
        for f in counts.values():
            f.launches = 0

    t0 = time.perf_counter()
    native = native_loader.available()
    t_native = time.perf_counter() - t0
    print(f"  native library (native/libgsplat_io.so): "
          + (f"loaded ({t_native:.1f} s, make included)" if native else
             f"not available ({native_loader.build_error}); images decode through "
             "io/png.py and resize with the port's LANCZOS"), flush=True)

    s.phase("render_cli (sparse)")
    timer, launches, wall = run_cli(s, "render_cli --resolution 1", model, 1, zero, counts)
    frames = cli_frames(timer)
    split_of = {}
    for split, n_cams in (("train", 3), ("test", 1)):    # render_cli's order
        for idx in range(n_cams):
            split_of[(split, idx)] = frames[len(split_of)]
    bench = split_of[("test", 0)]["final"]
    regrown = sum(len(f["regrown"]) for f in frames)
    s.check(len(frames) == 4 and bench["cam"] == "00000"
            and abs(bench["n_pairs"] - REF_SPARSE_PAIRS) <= 1e-3 * REF_SPARSE_PAIRS
            and regrown > 0 and all(f["final"]["n_dropped"] == 0 for f in frames),
            f"render_cli --resolution 1: {len(frames)} frames of {W}x{H}; the bench view's "
            f"n_pairs {bench['n_pairs']} vs JAX package {REF_SPARSE_PAIRS} (diff "
            f"{bench['n_pairs'] - REF_SPARSE_PAIRS:+d}, tol 0.1%); {regrown} renders dropped "
            f"pairs and regrew the budget from {CLI_BUDGET} (to "
            f"{sorted({f['final']['budget'] for f in frames})}); every written frame "
            "n_dropped 0")
    scene = Scene(ModelParams(source_path=str(src), model_path=str(model), resolution=1,
                              eval=True), load_iteration=-1, shuffle=False)
    check_cli_pngs(s, "render_cli --resolution 1", model, scene, frames, split_of)
    cli_kernel_checks(s, "render_cli --resolution 1", scene, split_of)
    del scene
    target_q = (np.clip(target, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    gts = sorted(model.glob(f"*/ours_{CLI_ITERATION}/gt/*.png"))
    s.check(len(gts) == 4 and all(np.array_equal(png.read_png(p), target_q) for p in gts),
            f"render_cli --resolution 1: its {len(gts)} gt PNGs equal the target image "
            "quantised as save_png quantises it")
    for f in frames:
        r = f["final"]
        print(f"  render_cli {r['cam']} {r['width']}x{r['height']}: render {r['device_ms']:.3f} "
              f"device ms ({r['wall_ms']:.3f} wall, budget {r['budget']}; "
              f"{len(f['regrown'])} regrowth renders before it, "
              f"{sum(x['wall_ms'] for x in f['regrown']):.3f} wall ms), copy to the host "
              f"{f['render_png']['gap_ms']:.3f} ms, PNG encode {f['render_png']['ms']:.3f} ms; "
              f"gt copy {f['gt_png']['gap_ms']:.3f} ms and encode {f['gt_png']['ms']:.3f} ms",
              flush=True)
    first = timer.renders[0]["wall_ms"]
    setup = wall * 1e3 - sum(r["wall_ms"] for r in timer.renders) \
        - sum(x["ms"] + x["gap_ms"] for x in timer.saves)
    print(f"  render_cli --resolution 1: {wall:.3f} s wall for {len(frames)} frames "
          f"({wall / len(frames) * 1e3:.1f} ms a frame); Scene set-up and the rest "
          f"{setup:.1f} ms; first render {first:.3f} wall ms", flush=True)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        png.read_png(src / "images" / "00000.png")
    t_dec = (time.perf_counter() - t0) / reps * 1e3
    paeth = Path(tmp) / "paeth.png"
    png.write_png(paeth, (np.clip(target, 0, 1) * 255 + 0.5).astype(np.uint8), png.PAETH)
    t0 = time.perf_counter()
    png.read_png(paeth)
    t_paeth = (time.perf_counter() - t0) * 1e3
    print(f"  PNG {W}x{H}: decode {t_dec:.1f} ms (Up rows, as the port writes them), "
          f"{t_paeth:.1f} ms (Paeth rows: the wavefront); encode of the target "
          f"{part['encode'] * 1e3:.1f} ms", flush=True)

    s.phase("render_cli (sparse, --resolution -1)")
    timer2, launches2, wall2 = run_cli(s, "render_cli --resolution -1", model, -1, zero,
                                       counts)
    frames2 = cli_frames(timer2)
    split_of2 = {}
    for split, n_cams in (("train", 3), ("test", 1)):
        for idx in range(n_cams):
            split_of2[(split, idx)] = frames2[len(split_of2)]
    s.check(len(frames2) == 4 and all(f["final"]["width"] == 1600 and f["final"]["height"] == 900
                                      and f["final"]["n_dropped"] == 0 for f in frames2),
            f"render_cli --resolution -1: {len(frames2)} frames of "
            f"{sorted({(f['final']['width'], f['final']['height']) for f in frames2})} (want "
            "1600x900, the 1.6K cap), n_dropped 0")
    t0 = time.perf_counter()
    scene = Scene(ModelParams(source_path=str(src), model_path=str(model), eval=True),
                  load_iteration=-1, shuffle=False)
    t_scene = time.perf_counter() - t0
    check_cli_pngs(s, "render_cli --resolution -1", model, scene, frames2, split_of2)
    cli_kernel_checks(s, "render_cli --resolution -1", scene, split_of2, composite=True)
    del scene
    print(f"  render_cli --resolution -1: {wall2:.3f} s wall for {len(frames2)} frames; its "
          f"ground truth resized by the {'native bilinear' if native else 'LANCZOS'} path "
          f"(a Scene at -1: {t_scene:.3f} s)", flush=True)

    s.phase("fresh Scene (sparse source)")
    real_knn, knn_s = gaussians_mod._mean_knn_dist2, []

    def knn(points):
        t = time.perf_counter()
        out = real_knn(points)
        knn_s.append(time.perf_counter() - t)
        return out

    gaussians_mod._mean_knn_dist2 = knn
    try:
        t0 = time.perf_counter()
        fresh = Scene(ModelParams(source_path=str(src), model_path=str(Path(tmp) / "fresh"),
                                  eval=True), shuffle=False)
        torch.cuda.synchronize()
        t_fresh = time.perf_counter() - t0
    finally:
        gaussians_mod._mean_knn_dist2 = real_knn
    fg = fresh.gaussians
    finite = all(bool(torch.isfinite(t).all()) for t in fg.params().values())
    s.check(finite and int(fg.n_live) == CLI_POINTS and fg.capacity == CLI_POINTS
            and fg.xyz.device.type == "cuda"
            and (Path(tmp) / "fresh" / "cameras.json").exists(),
            f"fresh Scene: create_from_pcd over {int(fg.n_live)} points on {fg.xyz.device} "
            f"(capacity {fg.capacity}), parameters finite {finite}, cameras.json written")
    print(f"  fresh Scene: {t_fresh:.3f} s wall, of it the 3-NN search (scipy cKDTree) "
          f"{knn_s[0]:.3f} s ({knn_s[0] / t_fresh:.1%})", flush=True)
    del fresh, fg
    torch.cuda.empty_cache()
    return {k: launches[k] + launches2[k] for k in launches}


# ---- the training loop and its CLI (train/loop.py, cli.py) ----

TRAIN_ITERS = 40
# the densify threshold of the train cli phase, lowered from the default
# 2e-4: against the bench scene's random target the mean view-space
# gradient at iteration 15 has quantiles 1.1e-6 (75%) and 6.1e-6 (90%), so
# 2e-4 splits 606 of 1M rows and the scene never passes 2^20 live rows;
# 5e-6 splits ~1 in 10 at 15 and again at 30, so the rows pass 2^20 and stay
# far below 2^22 (each densify can at most double them)
TRAIN_GRAD_THRESHOLD = 5e-6
TRAIN_FLAGS = ["--resolution", "1", "--eval", "--iterations", str(TRAIN_ITERS),
               "--densify_from_iter", "5", "--densification_interval", "15",
               "--densify_until_iter", "35", "--opacity_reset_interval", "30",
               "--sat_probe_interval", "10", "--test_iterations", "20"]
# scripts/quality_proxy.py --iters 1000 at its defaults, and the JAX
# package's record of that run (artifacts/qproxy_sat30/out/metrics.jsonl)
QP_W, QP_H, QP_CAMS, QP_GT, QP_ITERS = 960, 540, 120, 60_000, 1000
QP_BUDGET, QP_CAPACITY, QP_TILE = 1 << 21, 1 << 17, 16
QP_RECORD = Path(__file__).resolve().parent / "artifacts" / "qproxy_sat30" / "out"
QP_LOSS_RTOL, QP_COUNT_RTOL, QP_PSNR_TOL = 0.02, 0.01, 0.3


class LoopSpy:
    """Wraps the training loop's module-level functions for one CLI run and
    records what the loop did: each step's host ms (synced), loss, pair
    budget and dropped pairs; each densify (ms, n_live before and after, the
    rows it keeps, clones and splits, and the largest scales of the rows
    over the gradient threshold), capacity growth, sat probe, evaluation,
    checkpoint (s, bytes), PLY and opacity reset; the seconds of the Scene's
    set-up and of the start checkpoint's load; the Printer's lines; on the
    first densify, a host copy of its inputs (`stash`); the state after the
    last densify (`last`)."""

    def __init__(self, stash=False):
        from gsplat_tpu_torch import cli
        from gsplat_tpu_torch.train import loop

        self.loop, self.cli, self.want_stash = loop, cli, stash
        self.steps, self.densify, self.grow, self.probes = [], [], [], []
        self.evals, self.ckpts, self.plys, self.lines = [], [], [], []
        self.resets, self.stash, self.last, self.result = 0, None, None, None
        self.setup = {"Scene": 0.0, "load_checkpoint": 0.0, "save_ply": 0.0}

    def __enter__(self):
        from gsplat_tpu_torch.train.densify import densify_selection

        loop, spy = self.loop, self
        names = ("make_train_step", "densify_and_prune", "grow_capacity", "_sat_probe",
                 "evaluate", "save_checkpoint", "save_ply", "reset_opacity", "Printer",
                 "Scene", "load_checkpoint")
        self.real = {k: getattr(loop, k) for k in names}
        self.real_train = self.cli.train
        real = self.real

        def make_train_step(*a, **kw):
            step = real["make_train_step"](*a, **kw)

            def timed(g, opt_state, cam, bg, it, ema, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(g, opt_state, cam, bg, it, ema, **k)
                torch.cuda.synchronize()
                spy.steps.append(dict(it=it, ms=(time.perf_counter() - t0) * 1e3,
                                      loss=float(out[2]), budget=kw["pair_budget"],
                                      n_pairs=int(out[4]), n_dropped=int(out[5]),
                                      capacity=g.capacity))
                return out

            return timed

        def densify_and_prune(g, opt_state, noise, **kw):
            if spy.want_stash and spy.stash is None:
                spy.stash = dict(g=g.replace(**{k: v.cpu() for k, v in vars(g).items()
                                                if isinstance(v, torch.Tensor)}),
                                 mu={k: v.cpu() for k, v in opt_state.mu.items()},
                                 nu={k: v.cpu() for k, v in opt_state.nu.items()},
                                 count=opt_state.count.cpu(), noise=noise.cpu(), kw=kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real["densify_and_prune"](g, opt_state, noise, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            _, kind, valid, _ = densify_selection(g, **kw)
            kinds = [int(((kind == k) & valid).sum()) for k in range(4)]
            grads = g.xyz_gradient_accum / g.denom.clamp(min=1.0)
            over = g.live_mask & (g.denom > 0) & (grads >= kw["max_grad"])
            scale = torch.exp(g.scaling[over]).amax(dim=-1)
            qs = (torch.quantile(scale, torch.tensor([0.1, 0.5, 0.9], device=scale.device))
                  .tolist() if scale.numel() else [])
            spy.densify.append(dict(it=spy.steps[-1]["it"], ms=ms, before=int(g.n_live),
                                    after=int(out[0].n_live), dropped=int(out[2]),
                                    capacity=g.capacity, kinds=kinds, scale_q=qs,
                                    small=kw["percent_dense"] * kw["extent"]))
            spy.last = out[0]
            return out

        def grow_capacity(g, new_cap):
            spy.grow.append((spy.steps[-1]["it"], g.capacity, new_cap))
            spy.last = real["grow_capacity"](g, new_cap)
            return spy.last

        def _sat_probe(g, cam, bg, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real["_sat_probe"](g, cam, bg, **kw)
            spy.probes.append(dict(it=spy.steps[-1]["it"], counts=[int(v) for v in out],
                                   ms=(time.perf_counter() - t0) * 1e3))
            return out

        def evaluate(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real["evaluate"](*a, **kw)
            torch.cuda.synchronize()
            spy.evals.append(dict(it=spy.steps[-1]["it"], ms=(time.perf_counter() - t0) * 1e3))

        def save_checkpoint(path, *a, **kw):
            t0 = time.perf_counter()
            real["save_checkpoint"](path, *a, **kw)
            spy.ckpts.append(dict(path=Path(path), s=time.perf_counter() - t0,
                                  bytes=Path(path).stat().st_size))

        def save_ply(path, g):
            t0 = time.perf_counter()
            real["save_ply"](path, g)
            spy.setup["save_ply"] += time.perf_counter() - t0
            spy.plys.append(Path(path))

        def timed_setup(name):
            def f(*a, **kw):
                t0 = time.perf_counter()
                out = real[name](*a, **kw)
                torch.cuda.synchronize()
                spy.setup[name] += time.perf_counter() - t0
                return out
            return f

        def reset_opacity(g, opt_state):
            spy.resets += 1
            return real["reset_opacity"](g, opt_state)

        class Printer(real["Printer"]):
            def print(self, msg):
                spy.lines.append(msg)
                super().print(msg)

        def train(*a, **kw):
            spy.result = self.real_train(*a, **kw)
            return spy.result

        for k, f in (("make_train_step", make_train_step),
                     ("densify_and_prune", densify_and_prune),
                     ("grow_capacity", grow_capacity), ("_sat_probe", _sat_probe),
                     ("evaluate", evaluate), ("save_checkpoint", save_checkpoint),
                     ("save_ply", save_ply), ("reset_opacity", reset_opacity),
                     ("Printer", Printer), ("Scene", timed_setup("Scene")),
                     ("load_checkpoint", timed_setup("load_checkpoint"))):
            setattr(loop, k, f)
        self.cli.train = train
        return self

    def __exit__(self, *exc):
        for k, f in self.real.items():
            setattr(self.loop, k, f)
        self.cli.train = self.real_train

    def step_ms(self):
        ms = [st["ms"] for st in self.steps]
        return statistics.median(ms), min(ms), max(ms)

    def wall_split(self, wall):
        """The run's wall seconds by part, largest first, the rest (parsing,
        logging, the camera picks, the budget reads, cfg_args, cameras.json,
        metrics and TB records) by difference -> printable text."""
        parts = {"steps": sum(st["ms"] for st in self.steps) / 1e3,
                 "densify": sum(d["ms"] for d in self.densify) / 1e3,
                 "sat probes": sum(p["ms"] for p in self.probes) / 1e3,
                 "evaluation": sum(e["ms"] for e in self.evals) / 1e3,
                 "checkpoint saves": sum(c["s"] for c in self.ckpts),
                 "PLY saves": self.setup["save_ply"],
                 "Scene set-up": self.setup["Scene"],
                 "start checkpoint load": self.setup["load_checkpoint"]}
        parts["the rest"] = wall - sum(parts.values())
        return ", ".join(f"{k} {v:.3f} s ({v / wall:.1%})"
                         for k, v in sorted(parts.items(), key=lambda kv: -kv[1]))


def run_train_cli(s, label, argv, counts, stash=False):
    """cli.main(argv) in process, the launch counts from zero -> (LoopSpy,
    launches, wall seconds)."""
    from gsplat_tpu_torch import cli

    for f in counts.values():
        f.launches = 0
    t0 = time.perf_counter()
    with LoopSpy(stash) as spy:
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counts.items()}
    need = TRAIN_KERNELS + (SAT_KERNELS if spy.probes else ())
    s.check(rc == 0 and all(launches[k] >= len(spy.steps) for k in TRAIN_KERNELS)
            and all(launches[k] >= len(spy.probes) for k in need),
            f"{label}: cli.main exit {rc}; kernel launches {launches} cover its "
            f"{len(spy.steps)} steps ({', '.join(TRAIN_KERNELS)}) and {len(spy.probes)} sat "
            f"probes ({', '.join(SAT_KERNELS)})")
    return spy, launches, wall


def same_checkpoints(a, b):
    """The arrays of two .npz checkpoints bit-equal -> names that differ."""
    za, zb = np.load(a), np.load(b)
    if sorted(za.files) != sorted(zb.files):
        return ["(key sets differ)"]
    return [k for k in za.files if not np.array_equal(za[k], zb[k])]


def densify_card_vs_cpu(s, label, stash):
    """densify_and_prune on the card and on the CPU on the state the loop
    densified first, with its noise: row choice, n_live and n_dropped
    bit-equal, parameters and moments within 1e-6 of each leaf's max."""
    from gsplat_tpu_torch.train import densify as td
    from gsplat_tpu_torch.train.optim import AdamState

    out = {}
    for dev in ("cpu", "cuda"):
        g = stash["g"].replace(**{k: v.to(dev) for k, v in vars(stash["g"]).items()
                                  if isinstance(v, torch.Tensor)})
        opt = AdamState(mu={k: v.to(dev) for k, v in stash["mu"].items()},
                        nu={k: v.to(dev) for k, v in stash["nu"].items()},
                        count=stash["count"].to(dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sel = [t.cpu() for t in td.densify_selection(g, **stash["kw"])]
        res = td.densify_and_prune(g, opt, stash["noise"].to(dev), **stash["kw"])
        torch.cuda.synchronize()
        out[dev] = sel, res, (time.perf_counter() - t0) * 1e3
    (sel_c, (g_c, o_c, d_c), ms_c), (sel_g, (g_g, o_g, d_g), ms_g) = out["cpu"], out["cuda"]
    same_sel = all(torch.equal(a, b) for a, b in zip(sel_c, sel_g))
    kinds = [int(((sel_c[1] == k) & sel_c[2]).sum()) for k in range(4)]
    pairs = [(k, getattr(g_c, k), getattr(g_g, k)) for k in
             ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")]
    pairs += [(f"mu_{k}", o_c.mu[k], o_g.mu[k]) for k in o_c.mu]
    pairs += [(f"nu_{k}", o_c.nu[k], o_g.nu[k]) for k in o_c.nu]
    rel = {k: float((b.cpu() - a).abs().max()) / max(float(a.abs().max()), 1e-30)
           for k, a, b in pairs}
    s.check(same_sel and int(d_c) == int(d_g) and int(g_c.n_live) == int(g_g.n_live)
            and max(rel.values()) <= 1e-6 and kinds[1] > 0 and kinds[2] > 0,
            f"{label} densify_and_prune on the card vs the CPU at capacity "
            f"{stash['g'].capacity} ({int(stash['g'].n_live)} live; kept/clone/split0/split1 "
            f"{kinds}, clones and splits each above 0): row choice bit-equal {same_sel}, n_live {int(g_g.n_live)} vs "
            f"{int(g_c.n_live)}, n_dropped {int(d_g)} vs {int(d_c)}; largest relative "
            f"difference {max(rel, key=rel.get)} {max(rel.values()):.3g} (tol 1e-6); "
            f"{ms_g:.1f} ms on the card, {ms_c:.1f} ms on the CPU")
    return max(rel.values())


def loop_kernel_checks(s, label, g, cam, target, budgets, tile=TILE, size=None):
    """K1-K6 and segment_sum against their plain versions on a state of the
    loop, at its tile size and frame size: K1 at each of `budgets`, K2-K4
    and segment_sum at the last, K5 and K6 in one _sat_probe's inputs ->
    ({kernel: max |err|}, K1's live slots at each budget, the pairs whose
    gid is a live row at or above 2^20)."""
    from gsplat_tpu_torch.render import raster

    errs = {}
    totals = []
    for S in budgets:
        _, total, _, err = expand_check(s, f"{label} K1 at budget {S}", g, cam, S, S, size,
                                        tile)
        totals.append(int(total))
        errs["expand_pairs"] = max(errs.get("expand_pairs", 0.0), float(err))
    S = budgets[-1]
    res = composite_check(s, label, g, cam, S, S, tile, size)
    gid = res[0][:, raster.KEY_COL]
    high = int(((gid >= (1 << 20)) & (gid < g.capacity)).sum())    # the null gid is capacity
    errs["composite_fwd"] = res[-1]
    del res, gid
    k3, d = phase_backward(s, label, g, cam, target, S, S, tile, size)
    errs["composite_bwd"] = k3["max_abs_err"]
    errs["segment_ends"] = phase_ends(s, label, d, g.capacity)["max_abs_err"]
    errs["segment_sum"] = phase_reduce(s, label, d, g.capacity + 1)["max_abs_err"]
    del d
    seen, b = sat_kernel_inputs(g, cam, S, None, S, tile, size)   # what _sat_probe renders
    del b
    k5, C = phase_scan(s, label, seen)
    errs["prefix_sum_small"] = k5["max_abs_err"]
    errs["compact_runs"] = phase_compact(s, label, seen, C, S)["max_abs_err"]
    del seen, C
    torch.cuda.empty_cache()
    return errs, totals, high


def phase_train_cli(s, g, cam_args, target, tmp, counts):
    """python -m gsplat_tpu_torch.cli over render_cli's COLMAP source (the
    bench view the test camera, 3 yaw views to train on, 1920x1080), from
    a start checkpoint of the 1M-Gaussian sparse scene; then resumed from
    its iteration-20 checkpoint -> (launches, kernel errors)."""
    from gsplat_tpu_torch import ckpt
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.io.ply import load_gaussian_ply
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.optim import init_adam_state

    s.phase("train cli (sparse, full width)")
    src, tmp = Path(tmp) / "cli_source", Path(tmp)
    start = tmp / "start.npz"
    opt0 = init_adam_state(g.params())
    t0 = time.perf_counter()
    ckpt.save_checkpoint(start, g, opt0, 0)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    g0, o0, step0 = ckpt.load_checkpoint(start, 1 << 17, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    same = (step0 == 0 and g0.capacity == g.capacity
            and all(torch.equal(getattr(g0, k), getattr(g, k)) for k in vars(g)
                    if isinstance(getattr(g, k), torch.Tensor))
            and all(torch.equal(o0.mu[k], opt0.mu[k]) and torch.equal(o0.nu[k], opt0.nu[k])
                    for k in opt0.mu))
    s.check(same, f"start checkpoint ({int(g.n_live)} Gaussians, capacity {g.capacity}, "
            f"{start.stat().st_size / 1e6:.1f} MB) loads back bit-equal: saved in "
            f"{t_save:.2f} s, loaded in {t_load:.2f} s")
    del g0, o0, opt0
    torch.cuda.empty_cache()

    straight, resumed = tmp / "train_straight", tmp / "train_resumed"
    argv = ["-s", str(src), *TRAIN_FLAGS,
            "--densify_grad_threshold", str(TRAIN_GRAD_THRESHOLD)]
    spy, launches, wall = run_train_cli(
        s, "train cli", argv + ["-m", str(straight), "--start_checkpoint", str(start),
                                "--checkpoint_iterations", "20", str(TRAIN_ITERS)],
        counts, stash=True)
    lines = spy.lines
    regrow = [ln for ln in lines if "pair budget" in ln]
    losses = [st["loss"] for st in spy.steps]
    final_budget = int(ckpt.load_checkpoint_extras(
        straight / f"chkpnt{TRAIN_ITERS}.npz")["pair_budget"])
    after = [st for st in spy.steps if st["budget"] == final_budget]
    # the last regrowth may fall on the loop's last check (iteration 40): the
    # final state rendered at the final budget on every camera shows it holds
    g_end, scene_end = spy.result
    bg0 = torch.zeros(3, device="cuda")
    end_dropped = [int(render(c, g_end, bg0, tile_size=TILE, chunk=CHUNK,
                              pair_budget=final_budget).n_dropped)
                   for c in scene_end.get_train_cameras() + scene_end.get_test_cameras()]
    del g_end, scene_end
    final_cap = spy.steps[-1]["capacity"]
    s.check(len(spy.steps) == TRAIN_ITERS and all(math.isfinite(x) for x in losses)
            and regrow and all(st["n_dropped"] == 0 for st in after)
            and not any(end_dropped),
            f"train cli: {len(spy.steps)} steps, losses finite (first {losses[0]:.5f}, last "
            f"{losses[-1]:.5f}); pair budget regrown {len(regrow)} time(s) (budgets at "
            f"iterations 1, 11, 21, 31: {[st['budget'] for st in spy.steps][::10]}, final "
            f"{final_budget}); n_dropped of the {len(after)} steps at the final budget "
            f"{[st['n_dropped'] for st in after]}, of the final state rendered at it on the "
            f"4 cameras {end_dropped} (want 0 each)")
    ev = [d["it"] for d in spy.densify]
    s.check(ev == [15, 30] and any(c > (1 << 20) for _, _, c in spy.grow)
            and spy.resets == 1 and [p["it"] for p in spy.probes] == [10, 20, 30, 40]
            and [e["it"] for e in spy.evals] == [20]
            and [c["path"].name for c in spy.ckpts] == ["chkpnt20.npz", f"chkpnt{TRAIN_ITERS}.npz"]
            and any(p.parent.name == f"iteration_{TRAIN_ITERS}" for p in spy.plys),
            f"train cli events: densify at {ev} (want [15, 30]), capacity growth "
            f"{spy.grow} (past 2^20), opacity resets {spy.resets} (want 1, at 30), sat probes "
            f"at {[p['it'] for p in spy.probes]}, evaluations at {[e['it'] for e in spy.evals]}, "
            f"checkpoints {[c['path'].name for c in spy.ckpts]}, PLYs "
            f"{[p.parent.name for p in spy.plys]}")
    s.check(final_cap <= (1 << 22) and int(spy.last.n_live) > (1 << 20),
            f"train cli: {int(spy.last.n_live)} live rows after the last densify (want above "
            f"2^20 = {1 << 20}), capacity {final_cap} (want at most 2^22; gids stay below "
            f"the 2^24 the f32 gid and the sat probe's guard allow)")
    eval_lines = [ln for ln in lines if "eval test" in ln]
    metrics = straight / "metrics.jsonl"
    tb = list((straight / "tb").glob("events.out.tfevents.*"))
    recs = [json.loads(x) for x in metrics.read_text().splitlines()] if metrics.exists() else []
    ply = straight / "point_cloud" / f"iteration_{TRAIN_ITERS}" / "point_cloud.ply"
    raw = load_gaussian_ply(ply)
    s.check(eval_lines and any("test_psnr" in r for r in recs) and tb
            and len(raw["xyz"]) == int(spy.result[0].n_live)
            and all(np.isfinite(v).all() for v in raw.values()),
            f"train cli outputs: eval line {eval_lines}; metrics.jsonl {len(recs)} records; "
            f"TB event files {len(tb)}; final PLY {len(raw['xyz'])} Gaussians, finite, loads "
            "back through the port")
    med, lo, hi = spy.step_ms()
    print(f"  train cli: step {med:.1f} ms median (min {lo:.1f}, max {hi:.1f}; host clock, "
          f"synced, {len(spy.steps)} steps); wall {wall:.1f} s", flush=True)
    for d in spy.densify:
        print(f"  densify at {d['it']}: {d['ms']:.1f} ms, n_live {d['before']} -> "
              f"{d['after']} (capacity {d['capacity']}, dropped {d['dropped']}); rows "
              f"kept/clone/split0/split1 {d['kinds']}; largest scale of the rows over the "
              f"gradient threshold, quantiles 10/50/90% {d['scale_q']}, clone at or below "
              f"{d['small']:.6f}")
    print(f"  train cli wall: {spy.wall_split(wall)}", flush=True)
    for ln in lines:
        if "budget" in ln or "capacity" in ln or "AUTO" in ln or "eval" in ln:
            print(f"  loop: {ln}")
    for c in spy.ckpts:
        print(f"  checkpoint {c['path'].name}: {c['bytes'] / 1e6:.1f} MB saved in "
              f"{c['s']:.2f} s")
    for e in spy.evals:
        print(f"  eval at {e['it']}: {e['ms']:.1f} ms")
    for p in spy.probes:
        print(f"  sat probe at {p['it']}: n_sat, n_pairs, n_culled, n_dropped {p['counts']} "
              f"({p['ms']:.1f} ms)")
    if spy.stash is not None:
        st = spy.stash["g"]
        n = int(st.n_live)
        grads = (st.xyz_gradient_accum[:n] / st.denom[:n].clamp(min=1)).numpy()
        qs = np.quantile(grads, [0.1, 0.25, 0.5, 0.75, 0.9])
        print(f"  densify at 15 inputs: mean view-space gradient quantiles 10/25/50/75/90% "
              f"{qs.tolist()}; over the threshold {TRAIN_GRAD_THRESHOLD}: "
              f"{int((grads >= TRAIN_GRAD_THRESHOLD).sum())} of {n}", flush=True)

    # the state after the last densify: the kernels at the loop's shapes
    R, T, fovx, fovy = cli_view(cam_args, 1)
    target_q = (np.clip(target, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    target_t = torch.from_numpy(target_q.astype(np.float32) / 255.0).to("cuda")
    cam = make_camera(R, T, fovx, fovy, W, H, device="cuda")
    budgets = [spy.steps[0]["budget"], final_budget]
    errs, totals, high = loop_kernel_checks(s, "train cli state after densify 30", spy.last,
                                            cam, target_t, budgets)
    s.check(totals[0] > budgets[0] and high > 0,
            f"train cli: K1 held at the truncating budget {budgets[0]} (live slots {totals[0]}) "
            f"and at the loop's final one {budgets[-1]} ({totals[-1]}); {high} pairs carry a gid "
            f"of a live row at or above 2^20 (capacity {spy.last.capacity}, "
            f"{int(spy.last.n_live)} live)")
    last_state, stash = spy.last, spy.stash
    del spy
    torch.cuda.empty_cache()

    s.phase("train cli resumed from chkpnt20")
    t0 = time.perf_counter()
    ckpt.load_checkpoint(straight / "chkpnt20.npz", 1 << 17, device="cuda")
    torch.cuda.synchronize()
    t_load20 = time.perf_counter() - t0
    spy2, launches2, wall2 = run_train_cli(
        s, "train cli resumed", argv + ["-m", str(resumed), "--start_checkpoint",
                                        str(straight / "chkpnt20.npz"),
                                        "--checkpoint_iterations", str(TRAIN_ITERS)], counts)
    final = f"chkpnt{TRAIN_ITERS}.npz"
    differ = same_checkpoints(straight / final, resumed / final)
    ply2 = resumed / "point_cloud" / f"iteration_{TRAIN_ITERS}" / "point_cloud.ply"
    same_ply = ply2.read_bytes() == ply.read_bytes()
    s.check(len(spy2.steps) == TRAIN_ITERS - 20 and not differ and same_ply
            and [d["it"] for d in spy2.densify] == [30],
            f"train cli resumed at 21 (chkpnt20 loaded in {t_load20:.2f} s): "
            f"{len(spy2.steps)} steps, densify at {[d['it'] for d in spy2.densify]}; final "
            f"checkpoint arrays bit-equal to the straight run's (differing: {differ or 'none'}); "
            f"final PLY bytes equal {same_ply}")
    print(f"  train cli resumed wall: {spy2.wall_split(wall2)}", flush=True)
    del spy2, last_state
    torch.cuda.empty_cache()

    s.phase("densify on the card vs the CPU (the loop's state at iteration 15)")
    errs["densify"] = densify_card_vs_cpu(s, "train cli", stash)
    del stash
    return {k: launches[k] + launches2[k] for k in launches}, errs


def textured_scene(n, seed=0):
    """scripts/selfcheck_train.py::textured_scene in numpy: many small solid
    Gaussians on a ground plane, a sphere shell and a torus, with
    high-frequency procedural colours -> (points, colours)."""
    rng = np.random.default_rng(seed)
    n_pl, n_sh = n // 3, n // 3
    n_to = n - n_pl - n_sh
    pl = np.stack([
        rng.uniform(-1.2, 1.2, n_pl),
        np.full(n_pl, -1.05) + rng.normal(0, 0.003, n_pl),
        rng.uniform(-1.2, 1.2, n_pl),
    ], 1)
    sh = rng.normal(size=(n_sh, 3))
    sh /= np.linalg.norm(sh, axis=1, keepdims=True)
    sh *= 0.75
    phi = rng.uniform(0, 2 * np.pi, n_to)
    theta = rng.uniform(0, 2 * np.pi, n_to)
    to = np.stack([
        (1.0 + 0.28 * np.cos(theta)) * np.cos(phi),
        0.28 * np.sin(theta) - 0.3,
        (1.0 + 0.28 * np.cos(theta)) * np.sin(phi),
    ], 1)
    pts = np.concatenate([pl, sh, to])
    f = 9.0
    base = 0.5 + 0.5 * np.stack([
        np.sin(f * pts[:, 0]) * np.sin(f * 1.3 * pts[:, 2]),
        np.sin(f * 0.8 * pts[:, 1] + 2.1) * np.cos(f * pts[:, 0]),
        np.cos(f * 1.7 * pts[:, 2] + 0.7),
    ], 1)
    checker = ((np.floor(pts[:, 0] * 4) + np.floor(pts[:, 2] * 4)) % 2)[:, None]
    colors = np.clip(0.75 * base + 0.25 * checker, 0, 1)
    return pts, colors


def rig(n_cams, radius=3.5):
    """scripts/selfcheck_train.py::rig: cameras on a wavy circle looking at
    the origin -> [(R cam-to-world, T world-to-cam)]."""
    out = []
    for i in range(n_cams):
        ang = 2 * math.pi * i / n_cams
        el = 0.35 * math.sin(3 * ang)
        pos = np.array([
            radius * math.cos(el) * math.sin(ang),
            radius * math.sin(el),
            radius * math.cos(el) * math.cos(ang),
        ])
        fwd = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(fwd, right), fwd])
        out.append((R_w2c.T, -R_w2c @ pos))
    return out


def write_quality_scene(root):
    """scripts/make_synthetic_scene.py --textured at quality_proxy.py's
    defaults, with the port: the ground truth rendered at tile 16, chunk
    128, pair budget 2^21 -> seconds of its parts."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.core.gaussians import create_from_pcd
    from gsplat_tpu_torch.io import colmap, png
    from gsplat_tpu_torch.render.render import render

    t_all = time.perf_counter()
    pts, colors = textured_scene(QP_GT)
    cap = 1 << int(np.ceil(np.log2(QP_GT + 1)))
    g = create_from_pcd(pts, colors, capacity=cap, device="cuda")
    live = g.live_mask[:, None]
    g = g.replace(opacity=torch.where(live, torch.full_like(g.opacity, 2.5), g.opacity),
                  scaling=torch.where(live, torch.full_like(g.scaling, math.log(0.012)),
                                      g.scaling))
    sparse, images = Path(root) / "sparse" / "0", Path(root) / "images"
    sparse.mkdir(parents=True)
    images.mkdir()
    fovx = 0.9
    focal = 0.5 * QP_W / math.tan(fovx / 2)
    fovy = 2 * math.atan(0.5 * QP_H / focal)
    colmap.write_intrinsics_binary({1: colmap.Camera(
        id=1, model="PINHOLE", width=QP_W, height=QP_H,
        params=np.array([focal, focal, QP_W / 2, QP_H / 2]))}, sparse / "cameras.bin")
    bg = torch.zeros(3, device="cuda")
    imgs, t_render, t_encode = {}, 0.0, 0.0
    for i, (R, T) in enumerate(rig(QP_CAMS), start=1):
        cam = make_camera(R, T, fovx, fovy, QP_W, QP_H, device="cuda")
        t0 = time.perf_counter()
        img = render(cam, g, bg, tile_size=QP_TILE, chunk=CHUNK, pair_budget=QP_BUDGET).image
        arr = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
        t_render += time.perf_counter() - t0
        name = f"img_{i:03d}.png"
        t0 = time.perf_counter()
        png.write_png(images / name, arr)
        t_encode += time.perf_counter() - t0
        imgs[i] = colmap.Image(id=i, qvec=colmap.rotmat2qvec(R.T), tvec=T, camera_id=1,
                               name=name)
    colmap.write_extrinsics_binary(imgs, sparse / "images.bin")
    noisy = pts + np.random.default_rng(7).normal(size=pts.shape) * 0.03
    rgb8 = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    colmap.write_points3D_binary(noisy, rgb8, np.zeros(len(pts)), sparse / "points3D.bin")
    return dict(render=t_render, encode=t_encode, total=time.perf_counter() - t_all)


def record_at(records, step, key):
    return next(r[key] for r in records if r["step"] == step and key in r)


def phase_train_quality(s, tmp, counts):
    """scripts/quality_proxy.py --iters 1000 with the port: the repo's
    120-camera textured synthetic scene at 960x540, tile 16, held to the
    JAX package's record of the same run -> (launches, kernel errors)."""
    s.phase("train quality (1k, tile 16)")
    root = Path(tmp) / "qproxy"
    part = write_quality_scene(root / "scene")
    print(f"  quality scene: {QP_GT} Gaussians rendered to {QP_CAMS} PNGs of {QP_W}x{QP_H} "
          f"in {part['total']:.1f} s (renders {part['render']:.1f} s, PNG encodes "
          f"{part['encode']:.1f} s)", flush=True)
    argv = ["-s", str(root / "scene"), "-m", str(root / "out"), "--eval",
            "--iterations", str(QP_ITERS), "--capacity", str(QP_CAPACITY),
            "--pair_budget", str(QP_BUDGET), "--tile_size", str(QP_TILE),
            "--test_iterations", str(QP_ITERS), "--quiet"]
    spy, launches, wall = run_train_cli(s, "train quality", argv, counts)
    recs = [json.loads(x) for x in (root / "out" / "metrics.jsonl").read_text().splitlines()]
    ref = [json.loads(x) for x in (QP_RECORD / "metrics.jsonl").read_text().splitlines()]
    got_cams = json.loads((root / "out" / "cameras.json").read_text())
    ref_cams = json.loads((QP_RECORD / "cameras.json").read_text())

    def cam_equal(a, b):
        if {k: a[k] for k in ("id", "img_name", "width", "height")} != \
                {k: b[k] for k in ("id", "img_name", "width", "height")}:
            return False
        fa = np.array([a["fx"], a["fy"], *a["position"], *np.ravel(a["rotation"])])
        fb = np.array([b["fx"], b["fy"], *b["position"], *np.ravel(b["rotation"])])
        return bool((np.abs(fa - fb) <= 1e-6 * np.maximum(1.0, np.abs(fb))).all())

    bad = [i for i, (a, b) in enumerate(zip(got_cams, ref_cams)) if not cam_equal(a, b)]
    s.check(len(got_cams) == len(ref_cams) == QP_CAMS and not bad,
            f"quality cameras.json: {len(got_cams)} cameras equal to the committed record's "
            f"within 1e-6 (differing: {bad[:5] or 'none'})")
    for it in (100, 200):
        got, want = record_at(recs, it, "loss"), record_at(ref, it, "loss")
        s.check(abs(got - want) <= QP_LOSS_RTOL * want,
                f"quality loss at {it}: {got:.5f} vs the JAX record {want:.5f} "
                f"({(got - want) / want:+.2%}, tol {QP_LOSS_RTOL:.0%})")
    print("  quality loss at 300/400/500: " + ", ".join(
        f"{record_at(recs, it, 'loss'):.5f} (record {record_at(ref, it, 'loss'):.5f})"
        for it in (300, 400, 500)), flush=True)
    got, want = record_at(recs, 700, "n_gaussians"), record_at(ref, 700, "n_gaussians")
    s.check(abs(got - want) <= QP_COUNT_RTOL * want,
            f"quality n_gaussians at 700: {got} vs the JAX record {want} "
            f"({(got - want) / want:+.2%}, tol {QP_COUNT_RTOL:.0%})")
    got, want = record_at(recs, QP_ITERS, "test_psnr"), record_at(ref, QP_ITERS, "test_psnr")
    s.check(abs(got - want) <= QP_PSNR_TOL,
            f"quality test PSNR at {QP_ITERS}: {got:.3f} vs the JAX record {want:.3f} "
            f"({got - want:+.3f} dB, tol {QP_PSNR_TOL} dB)")
    print("  quality n_gaussians by 100: " + " ".join(
        f"{r['step']}:{r['n_gaussians']}" for r in recs if "n_gaussians" in r), flush=True)
    print(f"  quality train PSNR at {QP_ITERS}: {record_at(recs, QP_ITERS, 'train_psnr'):.3f} "
          f"(record {record_at(ref, QP_ITERS, 'train_psnr'):.3f})")
    med, lo, hi = spy.step_ms()
    rate = [r["it_per_s"] for r in recs if "it_per_s" in r]
    print(f"  quality: {len(spy.steps)} steps, {len(spy.steps) / wall:.2f} it/s over the "
          f"whole run ({wall:.1f} s wall with Scene set-up, evaluation and saves); step "
          f"{med:.2f} ms median (min {lo:.2f}, max {hi:.2f}; synced, host clock); it/s by "
          f"100 {rate}", flush=True)
    for d in spy.densify:
        print(f"  quality densify at {d['it']}: {d['ms']:.1f} ms, n_live {d['before']} -> "
              f"{d['after']}; rows kept/clone/split0/split1 {d['kinds']}")
    for ln in spy.lines:
        if "budget" in ln or "capacity" in ln or "AUTO" in ln or "eval" in ln:
            print(f"  quality loop: {ln}")
    for e in spy.evals:
        print(f"  quality eval at {e['it']}: {e['ms']:.1f} ms")
    print(f"  quality phase: scene build {part['total']:.1f} s, training {wall:.1f} s",
          flush=True)

    print(f"  quality wall: {spy.wall_split(wall)}", flush=True)

    # the final state on one of the run's views: every kernel the run
    # launched, at tile 16, 960x540 and the run's pair budgets
    g, scene = spy.result
    cam = scene.get_train_cameras()[0]
    budgets = list(dict.fromkeys([spy.steps[0]["budget"], spy.steps[-1]["budget"]]))
    errs, totals, _ = loop_kernel_checks(s, "quality tile 16", g, cam, cam.image, budgets,
                                         QP_TILE, (QP_W, QP_H))
    print(f"  quality kernels held at tile {QP_TILE}, {QP_W}x{QP_H}, capacity {g.capacity} "
          f"({int(g.n_live)} live), pair budgets {budgets} (K1's live slots {totals})",
          flush=True)
    del g, scene, spy
    torch.cuda.empty_cache()
    return launches, errs


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
    for name in _build.SOURCES:
        if name not in _build.logs:
            print(f"  {name}: loaded from an earlier build, no ptxas report")
            continue
        for fn, u in _build.ptxas_usage(_build.logs[name]).items():
            s.check(u.get("spill_stores", 0) == 0 and u.get("spill_loads", 0) == 0,
                    f"{name} {fn}: {u.get('registers')} registers, {u.get('stack')} bytes "
                    f"stack, spill stores {u.get('spill_stores')} loads "
                    f"{u.get('spill_loads')} (ptxas -v; want no spills)")

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
        del sparse, bench
        torch.cuda.empty_cache()
        l_cli = phase_render_cli(s, g, cam_args, target, tmp)
        l_train, e_train = phase_train_cli(s, g, cam_args, target, tmp, kernel_counts())
        del g, target
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
        del g, target, dense
        torch.cuda.empty_cache()
        l_quality, e_quality = phase_train_quality(s, tmp, kernel_counts())
    by_view = {"sparse": l_sparse, "dense": l_dense, "render_cli": l_cli,
               "train_cli": l_train, "train_quality": l_quality}
    launches = {k: sum(v[k] for v in by_view.values()) for k in l_sparse}
    print(f"  main path: {n_sparse + n_dense} renders at tile {TILE} and "
          f"{2 * (2 + FRAME_REPS)} at tile {TILE_WIDE}, {TRAIN_STEPS['sparse']} + "
          f"{2 * TRAIN_STEPS['dense']} train steps at tile {TILE} and 2 at tile {TILE_WIDE}; "
          f"render_cli's renders {l_cli['composite_fwd']}; the train CLI's steps and probes "
          f"(K1 {l_train['expand_pairs']}, K5 {l_train['prefix_sum_small']}) and the quality "
          f"run's (K1 {l_quality['expand_pairs']}, K5 {l_quality['prefix_sum_small']})")
    print("kernels " + json.dumps(launches))
    s.check(all(v > 0 for v in launches.values()),
            f"every kernel launched on the main path: {launches}")

    for cell in (k_sparse, k_dense):
        for k in cell.values():
            t_bytes = k.pop("bytes") / PEAK_BYTES * 1e3
            t_ops = k.pop("ops") / k.pop("peak_ops", PEAK_FP32) * 1e3
            k.update(launches=launches[k["name"]], bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
    for label, cell in (("dense", k_dense), ("sparse", k_sparse)):
        for key, k in cell.items():
            print(f"  {label} {key}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
                  f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), library "
                  f"{k['library_ms'] if k['library_ms'] is None else round(k['library_ms'], 4)}")
    rows = []
    for name in kernel_counts():
        views = [("sparse", k_sparse), ("dense", k_dense)]
        if name in SAT_KERNELS:
            views.reverse()
        (view, main_cell), (other, other_cell) = views
        o = other_cell[name]
        rows.append(dict(main_cell[name], view=view,
                         launches_by_view={v: c[name] for v, c in by_view.items()},
                         max_abs_err=max(k_sparse[name]["max_abs_err"],
                                         k_dense[name]["max_abs_err"],
                                         e_train.get(name, 0.0), e_quality.get(name, 0.0)),
                         other_view=dict(view=other, **{k: o[k] for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})))
        wide = f"{name} tile {TILE_WIDE}"
        if wide in k_sparse:
            # the same kernel at the widest tile, in pixel passes, on each view
            rows[-1][f"tile_{TILE_WIDE}"] = {view: {k: cell[wide][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                for view, cell in (("sparse", k_sparse), ("dense", k_dense))}
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
