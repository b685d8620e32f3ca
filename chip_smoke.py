#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (gsplat_tpu_torch): the forward render
path and the training step at 1M Gaussians and 1920x1080 on one NVIDIA GPU,
at tile 32, at tile 64 and at tile 128, on the f32 and the packed attribute
rows read through the sorted gids (attr_pack), serving_bench, the render CLI over a dataset on disk, the
training CLI over a JPEG dataset, the
training CLI (from a checkpoint of the 1M scene, and 1000 iterations of the
repo's quality-proxy scene held to the JAX package's record), a 200-view
COLMAP capture loaded through the port's IO runtime and trained on, the live
viewer (the SIBR network GUI serving the 1M model, and inside the training
loop), full_eval (train, render, metrics with LPIPS), the training
self-check, and multi-GPU training on meshes of ranks (one NCCL rank; four
gloo ranks sharing the card as a 2x2 mesh, its steps and its train CLI).

    python3 chip_smoke.py

Phases (any failure exits nonzero, and the final ok line is not printed):
  env      card name + power limit (nvidia-smi), torch / CUDA / nvcc versions
  build    nvcc builds gsplat_tpu_torch/csrc/*.cu into build/kernels/, the C
           compiler the IO runtime (csrc/io_runtime.c with jpeg_decode.c)
           into build/host/ (all started together; the runtime's build
           seconds printed); the registers and spills of every kernel
           (ptxas -v; each pixel-pass count and table layout of
           composite_fwd and composite_bwd): no spills
  oracle   a tiny scene rendered on the GPU against the port's per-pixel
           oracle and its CPU render (plain kernel versions), 2e-5 abs
  then, for each of two cells, bench.py's scene re-made in numpy
  (gsplat_tpu_torch/tools/bench_scene.py; 1M
  Gaussians, numpy default_rng(0), geometry at tile 32, and its random
  target image) written as a 3DGS point_cloud.ply and loaded back onto the
  GPU (capacity 2^20), with the pair and kept budgets of its bench view
  fitted from a probe binning as scripts/serving_bench.py does:
  expand_pairs   the kernel against its plain version at the fitted pair
           budget: keys and gids bit-equal
  composite_fwd  the kernel against its plain version on the view's real
           rows and sorted gids (each pair's row read through its gid):
           tiles within 2e-5 abs, nproc equal in every tile but
           those whose max T at the deciding chunk boundary lies within 1e-6
           relative of T_EPS (the two multiply in another order); the share
           of kept pairs past each tile's saturation exit; the share of
           (warp, pair) groups the kernel's exact skip passes over and the
           bound recounted from it (12 operations for a pair-pixel whose
           power lies below its pair's threshold, 31 for the rest)
  composite_fwd packed, composite_bwd packed  the two checks above on the
           view's packed (N+1, 8) rows (rgb and opacity as bf16 pairs),
           their bounds recounted for 32-byte rows
  composite_bwd  the kernel against its plain version on the same rows and
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
  project_fwd, project_bwd  the projection's kernels (through
           project_gaussians' autograd Function) against project_plain and
           project_bwd_plain on the cell's scene (SH degree 3): at modifier
           1 with a mean2d offset, at the GUI's modifier 0.7, and with an
           override colour (the no-SH branch): mean2d, depth, radius and
           visible bit-equal, conic, rgb and opacity within 1 ulp; random
           incoming gradients (mean2d, conic, rgb and opacity on the visible
           rows, depth on every row): each leaf's gradient within 1e-6 of
           its max, the offset's the mean2d gradient bit for bit; one launch
           of each; their ms beside the plain versions' and the bound by
           bytes (f_rest read backward only where the rgb gradient is not 0)
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
  serve packed  the bench view on the packed and the f32 pair table, the
           saturation cull off and on (sparse: pair and sat budget
           2,621,440; dense: the fitted budgets and sat budget): K2 on each
           packed table a render handed it against its plain version (2e-5,
           nproc equal but at the T_EPS boundary); each packed
           image within tests/test_attr_pack.py's 2e-2 max and 2e-3 mean of
           the f32 one, the packed image with the cull bit-equal to the
           packed image without it, n_dropped 0; frame ms and the gather
           and composite stages of each, packed beside f32
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
  step sparse packed  the train step's gradients on the packed table
           (render(..., attr_pack=True), the photometric loss, autograd):
           two passes the same bits; the image mean's gradients within 2e-2
           of each group's max of the f32 table's (test_attr_pack.py's
           objective); 2 make_train_step steps under GSPLAT_PACK=1's
           default: losses finite, n_dropped 0
  tile 64, tile 128  composite_fwd and composite_bwd at tile 64 (four
           pixel passes) and at tile 128 (four windows of 64x64) against
           their plain versions on the bench view's real pair table and loss
           cotangent (the checks above, K3's same bits twice, the skip
           census and the bound recounted at that tile); then a served frame
           (timed) and one train step at that tile, its loss within 2e-4 of
           the tile-32 step 1
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
           rendered it at (2^20 and 2^21 truncate), bit-equal; the port's
           IO runtime loaded (no fallback line). Printed: a
           frame's render device ms, its copy to the host and PNG encode,
           the regrowth renders, the decode ms of a 1080p PNG. Then
           render_cli at the default
           --resolution -1: 1600x900 frames (the 1.6K cap), each equal to
           the render at that camera; K1 there as at 1080p, and K2 against
           its plain version at the bench view's final budget; each Scene
           camera's 1600x900 image (the runtime's bilinear resize) bit-equal
           to the plain version's decode (native_loader.decode_image_plain).
           Then
           render_cli --tile_size 128 --skip_train at --resolution 1: the
           test frame's PNG bit-equal to the quantised render at tile 128
           (its largest difference from the tile-32 render printed). Then a
           fresh Scene on the same source:
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
  jpeg     after the train cli phase: every JPEG fixture under tests/data/
           jpeg/ (baseline, progressive, CMYK, YCCK) decoded by the port
           (io/jpeg.py), its sha256 equal to the manifest's (PIL's decode);
           the 1080p fixtures' decode ms (baseline and progressive, median
           of 10, host clock); render_cli's COLMAP source written again
           with those fixtures in turns as the views' .jpg, and cli.main 10
           iterations over it from start.npz (--pair_budget 2^22): losses
           finite, n_dropped 0, every camera's image its file's decode / 255
  capture load  a COLMAP source of CAPTURE_VIEWS (200) views at 1920x1080
           (Mip-NeRF 360's garden holds 185), the 1080p fixtures in turns as
           their .jpg, render_cli's points3D.bin: Scene at --resolution 2
           through the IO runtime (4 C workers, bilinear), then the
           per-camera path (the runtime held off: io/jpeg.py and the port's
           LANCZOS on this thread) on 20 of the views; each path's seconds
           and views/s, its decode share of the set-up, the images' bytes on
           the card, beside the card's name and power limit; the runtime's
           images 960x540, each fixture's views the same bits, the first of
           each equal to the plain version's decode; then cli.main
           CAPTURE_ITERS (10) iterations over the capture from start.npz
           (sat probes every 5): losses finite, n_dropped 0
  viewer serve (sparse, full width)  after the train cli phase: a
           NetworkGUIServer on a free local port over the 1M sparse model at
           one pair budget (the largest fitted one of the requests, 1.2x); a
           client thread sends SIBR requests (the bench camera and yaw +2,
           -3 at 1920x1080; the bench camera at scaling_modifier 0.5; yaw +5
           at 1237x691, no multiple of the tile; one with resolution_x 0),
           three rounds; the main thread polls and serves each through the
           loop's _serve_gui_request. Every reply bit-equal to image_to_bytes
           of the render of camera_from_request apart, the verify string,
           n_dropped 0, GUI render errors 0, an HTTP GET on the same port
           returns the page; K1 and K2 against their plain versions at
           1920x1080 and 1237x691. Printed: the round trip ms a request at
           each size (median, min, max), split into render device ms,
           image_to_bytes (quantise and the copy into pinned memory) and the
           socket; K1 and K2 launches a request
  train cli with the viewer (sparse, full width)  the train cli phase's run
           from start.npz without --quiet (the viewer on a free port,
           progress_every 10): a SIBR client renders a view before the
           first step and one after the tenth, pauses training (train=False,
           keep_alive) for two more round trips and resumes. No step while paused; every image reply bit-equal to the
           render apart of the model it was served from; 4 previews, each
           fetched over HTTP and decoding to the image handed to publish;
           the final PLY byte-equal to the train cli phase's (--quiet) run;
           a preview's publish (median) under 2% of the time of the steps
           between two previews at train()'s default progress_every 100
           (printed at 10 too). Printed:
           each preview's publish and encode ms and bytes (and the first at
           zlib levels 1 and 6), the round trips, the wall by part
  full_eval (sparse, full width)  full_eval.main over render_cli's source:
           trains 20 iterations from start.npz (--resolution 1, sat probes
           every 10), renders the 4 views, scores them with random LPIPS
           weights (.npz under build/lpips_random/); full_eval.json holds
           test/ours_20 and train/ours_20 with PSNR, SSIM, L1 and LPIPS
           finite; evaluate_model on the CPU over the same PNGs within 1e-5
           (PSNR, SSIM, L1); LPIPS on the card vs the CPU within 1e-4 on a
           512x512 crop of each pair (a 1080p pair takes tens of seconds on
           the CPU); K1-K6 and segment_sum on the final state. Printed:
           LPIPS ms a 1080p pair against its fp32 bound, SSIM, PNG decode,
           render_cli's parts and the wall by part
  bench    after the dense cell: bench_torch.py's measurement in process
           (tools/bench.py's main: both densities, the plain, kept and sat
           passes, each timed synced and pipelined): its JSON line printed
           (not as the last line); the metric, the card's name and power
           limit; every pass that ran has n_dropped 0 and its synced,
           pipelined and _device_ms times, and the kept and sat passes ran
           where the counts say they must; pairs, culled, contrib and
           sat_kept of each density equal to the cell's own counts on the
           same scene (the bench view rendered at the cell's pair budget,
           its fit probe's culled pairs, its sat probe's survivors), loss
           bit-equal to the sparse cell's train step 1; no host sync in one
           step of each pass (torch's sync debug mode); then K1 (at the
           plain pass's budget and the fitted one), K2-K4, segment_sum, K5
           and K6 against their plain versions at the budgets the bench
           fits (render/budgets.py's bench rules) on each density's scene.
           Printed: the phase's wall time and launches
  serving_bench  after the dense cell: tools/serving_bench.py in process,
           without and with --pack (1M Gaussians, 1080p, both scenes, its
           budgets fitted by the reference's probes): its JSON line printed,
           every time finite
  train quality (1k, tile 16)  after the dense cell: tools/quality_proxy.py
           --iters 1000 at its defaults (the 120-camera textured scene of
           tools/selfcheck_train.py, built by quality_proxy.make_scene at
           tile 16, 960x540, 60,000 Gaussians), cli.main;
           held to artifacts/qproxy_sat30/out/: cameras.json within 1e-6,
           the loss at 100 and 200 within 2%, n_gaussians at 700 within
           1%, the test PSNR at 1000 within 0.3 dB of 38.648; K2 and K3
           against their plain versions at tile 16 on one of its views.
           Printed: it/s, densify and eval events, the contrib budget fit,
           the scene build and training wall times
  selfcheck  tools/selfcheck_train.py at its defaults (600 iterations at
           256x256 from a perturbed start): it prints PASS (final PSNR at
           least 22); K1-K6 and segment_sum against their plain versions on
           its final state at tile 16, 256x256, pair budget 2^18
  mesh set-up  the train cli phase's start.npz and COLMAP source, the
           sparse target; the batch's budgets: the train phase's fit at the
           bench view and yaw +2 (MESH_VIEWS), the largest of each
  mesh nccl 1x1  one rank (a subprocess: `chip_smoke.py --mesh-rank`,
           torchrun's environment, world 1, NCCL): from start.npz, the
           replicated and the sharded mesh step (3 steps each) and
           make_train_step at the bench view: step 1's loss, parameters,
           Adam moments and densification accumulators bit-equal;
           make_spmd_eval_step against eval_step and the render: bit-equal
  mesh 2x2 (gloo, 4 ranks share the card)  the camera batch of the bench
           view and yaw +2, bands of 544 rows (the last ends 8 rows past
           1080), 3 replicated and 3 sharded steps from start.npz, step 1
           again and step 1 with the saturation cull (sat budget = the pair
           budget), the eval step; checks: step 1 (replicated and sharded)
           against the parent's single-device batch reference on the card
           (render + photometric loss of both cameras, mean, autograd): loss
           within 1e-5 relative, each gradient group (and each view's
           screen-space gradient) within 2e-4 of its max; sharded step 1
           bit-equal to replicated; step 1 twice and with the cull
           bit-equal; every step n_dropped 0, the state finite, every rank's
           replicated state the same bits (a checksum); the eval step's
           image within 2e-5 of the full render; K1-K6 and segment_sum
           against their plain versions on rank 0's band (the top) and rank
           3's (the last), binned with the lead slots the step laid before
           that band's pairs. Printed per rank: synced step ms, step 2's stages
           (synced), each collective's calls and bytes, state bytes
           replicated and sharded, peak memory
  train cli mesh 2x2  cli.main on 4 gloo ranks (the JAX flags) from
           start.npz over render_cli's COLMAP source: 20 iterations at the
           mesh budget, densify at 15, sat probes at 10 and 20, an eval at
           20; replicated, then --shard_gaussians, each under LoopSpy: every
           rank exits 0, 20 steps with n_dropped 0, rank 0 alone writes; the
           two final PLYs bit-equal; the wall by part
Wherever K1-K6 and segment_sum are held on a state of the loop (the
train CLI, full_eval, quality, self-check and bench phases), the
projection's two kernels are held too, as in the cells, at that state's SH
degree and frame; in the 2x2 mesh, ranks 0 and 3 hold them on their shard
of the rows with its live count (the sharded step's projection), before
their data rank's camera.
The launch counts of the nine kernels, and of K2 and K3 on the packed
table under keys of their own ("composite_fwd packed", "composite_bwd
packed"), are zeroed just before each serve, each train, the packed serve
and step phases, the tile-64 and tile-128 serve-and-train phases, each
render_cli run (the tile-128 one too),
each train CLI run (the JPEG and capture ones too), the viewer's requests,
full_eval,
each serving_bench run, the bench phase, the self-check and, in each rank
of the mesh phases, before its steps (the main paths), and must cover every render
and step run there (project_fwd in every render, project_bwd in every
step; K5 and K6 in the sat phases and the loop's probes; K1 and K2 in
render_cli; the packed K2 and K3 in the packed phases); the
kernels line sums them
(the mesh phases' over their ranks) and must show every kernel. The
kernels JSON rows hold the sparse bench view's times and bound for K1-K4,
segment_sum and the projection's two kernels, the dense view's for K5 and K6 (the cell whose users run
the cull), the other view's beside them (`other_view`), the largest error
of the two cells and the checks of the train, quality, viewer, full_eval,
self-check, bench and 2x2 mesh phases, the launches of each cell's main
path, of render_cli, of the train, quality, viewer, train-with-viewer,
full_eval, self-check, mesh, capture and bench phases beside their total
(`launches_by_view`), and
for K2 and K3 their times and bounds at tile 64 (`tile_64`) and at tile 128
(`tile_128`).
Numbers are printed with the card they ran on; TF32 is switched off for
matmuls and cuDNN (the loss's blur pins full fp32 itself).
"""

from __future__ import annotations

import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gsplat_tpu_torch.render import budgets

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
REF_SPARSE_LOSS = 0.4129     # BENCH_r05.json "loss", the step-1 loss
ATOL = 2e-5
BWD_RTOL = 1e-4       # composite_bwd vs plain, of each d column's max
GRAD_RTOL = 1e-3      # per-Gaussian gradient table vs float64, of each column's max
# segment_sum against its plain version (float64 index_add_, atomics on the
# card), of each column's max: both round a float64 sum to float32 once
SUM_RTOL = 1e-6
# project_bwd against project_bwd_plain (the same closed form as torch
# ops), of each leaf's max
PROJ_RTOL = 1e-6
PROJ_LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
# the GUI's scaling modifier in the checks (network_gui's slider)
GUI_MODIFIER = 0.7
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
TILE_WIDE = 64    # the widest tile the compositing kernels run in pixel passes (four)
TILE_WINDOWED = 128   # a tile the kernels run in windows of 64x64 (four)
WIDE_TILES = (TILE_WIDE, TILE_WINDOWED)
FRAME_REPS = 10   # synced frames timed per view
TRAIN_STEPS = {"sparse": 10, "dense": 3}


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


def probe_view(g, cam, budget, tile=TILE):
    """scripts/serving_bench.py's probe and fit (render/budgets.py) at the
    view -> (pair budget, kept budget, n_pairs, n_culled); a probe that
    fills its budget raises."""
    n_pairs, n_culled = budgets.probe_pairs(g, cam, budget, tile_size=tile, chunk=CHUNK)
    if n_pairs >= budget:
        raise RuntimeError(f"probe overflowed its budget {budget}")
    return (budgets.fit_pair(n_pairs, budget, CHUNK), budgets.fit_kept(n_pairs, n_culled, CHUNK),
            n_pairs, n_culled)


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


def gid_rows(p, b, kept, pack=False):
    """What K2 and K3 read for a binned view: (the (N+1, 16) attribute rows
    with their gid column, packed (N+1, 8) with `pack`; the kept prefix of
    the sorted gids)."""
    from gsplat_tpu_torch.render.render import _attr_rows, _gid_rows

    return _gid_rows(_attr_rows(p), pack), b.gid_s[:kept]


def composite_check(s, label, g, cam, pair_fit, kept, tile=TILE, size=None, pack=False):
    """K2 against its plain version on the camera's rows read through its
    sorted gids (the packed (N+1, 8) rows with `pack`): tiles within ATOL,
    nproc equal but where a tile's transmittance sits at T_EPS -> (rows,
    gids, tile starts, tile counts, tw, K2's tiles, K2's nproc, max |tiles
    diff|)."""
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.render.binning import bin_gaussians, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians

    w, h = size or (W, H)
    tw, _ = tile_grid(w, h, tile)
    p = project_gaussians(g, cam)
    b = bin_gaussians(p.mean2d, p.radius, p.depth, width=w, height=h,
                      tile_size=tile, chunk=CHUNK, pair_budget=pair_fit,
                      cull_conic=p.conic, cull_opacity=p.opacity, kept_budget=kept)
    rows, gid = gid_rows(p, b, kept, pack)
    del p
    ts, tc = b.tile_start, b.tile_count
    tiles_k, np_k = raster.composite_fwd(rows, ts, tc, tw=tw, tile_size=tile, chunk=CHUNK,
                                         gid=gid)
    err = fwd_against_plain(s, f"{label} packed" if pack else label, rows, ts, tc, tw,
                            tile, tiles_k, np_k, gid)
    return rows, gid, ts, tc, tw, tiles_k, np_k, err


def fwd_against_plain(s, label, rows, ts, tc, tw, tile, tiles_k, np_k, gid):
    """K2's output (tiles_k, np_k) on rows read through the gids against its
    plain version's: tiles within ATOL, nproc equal but where a tile's
    transmittance sits at T_EPS (the two multiply in another order) -> max
    |tiles diff|."""
    from gsplat_tpu_torch.render import raster

    tiles_p, np_p = raster.composite_fwd_plain(rows, ts, tc, tw=tw, tile_size=tile,
                                               chunk=CHUNK, gid=gid)
    torch.cuda.synchronize()
    allowed = torch.zeros(ts.shape[0], dtype=torch.bool, device=ts.device)
    bad_tiles = torch.nonzero(np_k != np_p).squeeze(1).tolist()
    for t in bad_tiles:
        # replay tile t through the plain version up to the deciding
        # boundary m: its segment cut at chunk m, every other tile empty
        m = min(int(np_k[t]), int(np_p[t]))
        counts = torch.zeros_like(tc)
        counts[t] = max(min(int(tc[t]), m * CHUNK - int(ts[t]) % CHUNK), 0)
        replay, _ = raster.composite_fwd_plain(rows, ts, counts, tw=tw, tile_size=tile,
                                               chunk=CHUNK, gid=gid)
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
            f"{gid.shape[0]} pairs: max |tiles diff| {err:.3g} (tol {ATOL})")
    s.check(n_bad == 0, f"{label} composite_fwd nproc: {len(bad_tiles)} tiles differ, "
            f"{n_bad} of them away from the T_EPS boundary (want 0)")
    return err


def phase_composite(s, label, g, cam, pair_fit, kept, tile=TILE, pack=False):
    """K2's check (composite_check), time, plain time, skip census and
    bound on the view's rows read through its gids (packed with `pack`: the
    row "composite_fwd packed", 32 bytes a pair) -> its kernels row."""
    from gsplat_tpu_torch.render import raster

    rows, gid, ts, tc, tw, tiles_k, np_k, err = composite_check(s, label, g, cam, pair_fit,
                                                                 kept, tile, pack=pack)
    # a tile's pairs past its exit: those beyond its nproc-th chunk of the
    # chunk-aligned grid its segment is swept on
    tc64 = tc.to(torch.int64)
    past = torch.minimum(torch.clamp(ts.to(torch.int64) % CHUNK + tc64
                                     - np_k.to(torch.int64) * CHUNK, min=0), tc64)
    n_past, n_kept = int(past.sum()), int(tc64.sum())
    ms = device_ms(lambda: raster.composite_fwd(rows, ts, tc, tw=tw, tile_size=tile,
                                                chunk=CHUNK, gid=gid), 10)
    plain_ms, _ = wall_ms(lambda: raster.composite_fwd_plain(
        rows, ts, tc, tw=tw, tile_size=tile, chunk=CHUNK, gid=gid))
    chunks = int(np_k.sum())
    census = skip_census(raster.unpack_rows(rows) if pack else rows, gid, ts, tc, np_k,
                         tw, tile)
    # each composited pair's gid and row read once (4 + 64 bytes, 4 + 32
    # packed), the tiles written once, the tile tables and nproc
    nbytes = (chunks * CHUNK * (rows.shape[1] * 4 + 4) + tiles_k.numel() * 4
              + 3 * ts.numel() * 4)
    name = "composite_fwd packed" if pack else "composite_fwd"
    print(f"  {label} {name}: {ms:.4f} ms, plain {plain_ms:.2f} ms; "
          f"{chunks} chunks composited, {census[0] / 1e9:.3f} G pair-pixel evaluations; "
          f"{nbytes / 1e6:.1f} MB moved ({nbytes / PEAK_BYTES * 1e3:.4f} ms at 3.35 TB/s); "
          f"kept pairs past their tile's saturation exit {n_past} of {n_kept} "
          f"({n_past / max(n_kept, 1):.2%})")
    ops = skip_bound(f"{label} {name}", census, K2_OPS_PER_EVAL)
    return dict(name=name, route="cuda",
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


def skip_census(rows, gid, ts, tc, nproc, tw, tile=TILE):
    """What composite_fwd's (or composite_bwd's) inputs need, counted with
    plain torch over each tile's first nproc chunks (those composited, or
    replayed): the (pair, pixel) evaluations, those whose power lies below
    the pair's skip threshold (alpha 0 there whatever follows), the (warp,
    pair) groups at the kernels' pixel layout, and those whose every pixel
    lies below (the groups the kernels skip) -> (evals, below, groups,
    skipped). Pair i's row is rows[gid[i]]."""
    from gsplat_tpu_torch.render import raster

    dev = rows.device
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
    # tiles a step: (tiles, chunk, pixels) temporaries of at most 2^27 elements
    step = min(256, (1 << 27) // (CHUNK * npix))
    for j in range(int(np64.max()) if np64.numel() else 0):
        live = torch.nonzero(np64 > j).squeeze(1)
        for b0 in range(0, live.numel(), step):
            t = live[b0:b0 + step]
            idx = j * CHUNK + lane
            a = rows[gid[astart[t, None] + idx]]                # (B, chunk, 16)
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


def loss_cotangent(rows, gid, ts, tc, tw, th, target, tile=TILE, size=None):
    """The forward tiles of rows read through the gids and the cotangent of
    the real photometric loss (bg 0) with respect to them."""
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.train.loss import photometric_loss

    tiles, nproc = raster.composite_fwd(rows, ts, tc, tw=tw, tile_size=tile, chunk=CHUNK,
                                        gid=gid)
    with torch.enable_grad():
        t = tiles.clone().requires_grad_()
        rgb, _ = raster.untile_image(t, tw, th, tile, *(size or (W, H)))
        (g,) = torch.autograd.grad(photometric_loss(rgb, target), [t])
    return tiles, nproc, g.contiguous()


def phase_backward(s, label, g, cam, target, pair_fit, kept, tile=TILE, size=None,
                   pack=False):
    """composite_bwd against its plain version at the bench view's fitted
    budgets, on its real rows read through its gids (packed with `pack`:
    the row "composite_bwd packed") and loss cotangent -> (K3 row, the
    kernel's d-table)."""
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.render.binning import bin_gaussians, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians
    from gsplat_tpu_torch.render.render import contrib_regions

    name = "composite_bwd packed" if pack else "composite_bwd"
    s.phase(f"kernel {name} ({label})")
    w, h = size or (W, H)
    tw, th = tile_grid(w, h, tile)
    p = project_gaussians(g, cam)
    b = bin_gaussians(p.mean2d, p.radius, p.depth, width=w, height=h,
                      tile_size=tile, chunk=CHUNK, pair_budget=pair_fit,
                      cull_conic=p.conic, cull_opacity=p.opacity, kept_budget=kept)
    rows, gid = gid_rows(p, b, kept, pack)
    del p
    ts, tc = b.tile_start, b.tile_count
    tiles, nproc, g_tiles = loss_cotangent(rows, gid, ts, tc, tw, th, target, tile, size)
    contrib = budgets.fit_contrib(int(nproc.sum()) * CHUNK)
    np_c, comp_start, overflow = contrib_regions(nproc, CHUNK, contrib)
    args = (rows, ts, tc, comp_start, np_c, tiles, g_tiles)
    kw = dict(tw=tw, tile_size=tile, chunk=CHUNK, p_out=contrib, gid=gid)
    d_k = raster.composite_bwd(*args, **kw)
    d_k2 = raster.composite_bwd(*args, **kw)
    d_p = raster.composite_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    keys_equal = torch.equal(d_k[:, raster.KEY_COL], d_p[:, raster.KEY_COL])
    rel = [float((d_k[:, c] - d_p[:, c]).abs().max() / d_p[:, c].abs().max().clamp(min=1e-30))
           for c in range(raster.N_DCOLS)]
    err = float((d_k[:, :raster.N_DCOLS] - d_p[:, :raster.N_DCOLS]).abs().max())
    s.check(not bool(overflow) and keys_equal and max(rel) <= BWD_RTOL,
            f"{label} {name} vs plain on {int(np_c.sum())} replayed chunks "
            f"(contrib budget {contrib}): keys equal {keys_equal}, d columns rel err "
            + " ".join(f"{r:.2g}" for r in rel) + f" (tol {BWD_RTOL} of each column's max)")
    s.check(torch.equal(d_k, d_k2), f"{label} {name}: two launches give the same bits")
    del d_k2, d_p
    replayed = int(np_c.sum()) * CHUNK
    census = skip_census(raster.unpack_rows(rows) if pack else rows, gid, ts, tc, np_c,
                         tw, tile)
    # the wrapper fills a fresh d-table before each launch: its time, less
    # that of the fill alone, is the kernel's
    ms = (device_ms(lambda: raster.composite_bwd(*args, **kw), 20)
          - device_ms(lambda: raster.d_table_prefilled(contrib, d_k.device), 20))
    plain_ms, _ = wall_ms(lambda: raster.composite_bwd_plain(*args, **kw))
    # the replayed pairs' gids and rows read once (4 + 64 bytes, 4 + 32
    # packed), tiles and cotangent read once, the four tile tables, the
    # replayed 64-byte d-rows written once
    nbytes = (replayed * (rows.shape[1] * 4 + 4) + 2 * tiles.numel() * 4
              + 4 * ts.numel() * 4 + replayed * 64)
    print(f"  {label} {name}: {ms:.4f} ms, plain {plain_ms:.2f} ms; {replayed} rows "
          f"replayed, {census[0] / 1e9:.3f} G pair-pixel evaluations; {nbytes / 1e6:.1f} MB "
          f"moved ({nbytes / PEAK_BYTES * 1e3:.4f} ms at 3.35 TB/s)", flush=True)
    ops = skip_bound(f"{label} {name}", census, K3_OPS_PER_EVAL)
    k3 = dict(name=name, route="cuda",
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


def ulps(a, b):
    """|a - b| in float32 units in the last place (same-sign values)."""
    ia, ib = a.view(torch.int32).to(torch.int64), b.view(torch.int32).to(torch.int64)
    return torch.where(a == b, 0, (ia - ib).abs())


def project_check(s, label, g, cam, seed, mod=1.0, override=False):
    """project_fwd and project_bwd, through project_gaussians' autograd
    Function, against project_plain and project_bwd_plain on all of g's
    rows (its n_live as given) before cam: mean2d, depth, radius and visible
    bit-equal, conic, rgb and opacity within 1 ulp; random incoming gradients
    of mean2d, conic, rgb and opacity on the visible rows (what the
    rasterizer hands back) and of depth on every row (the mesh's projected
    table carries it), a mean2d offset given: each leaf's gradient within
    PROJ_RTOL of its max, the offset's the mean2d gradient bit for bit; one
    launch of each kernel -> (max |forward diff|, max |leaf gradient diff|)."""
    from gsplat_tpu_torch.render import project as P

    dev = g.device
    n = g.capacity
    params = {k: getattr(g, k).detach().requires_grad_() for k in PROJ_LEAVES}
    off = torch.zeros((n, 2), device=dev, requires_grad=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    color = torch.rand((n, 3), generator=gen, device=dev) if override else None
    want = P.project_plain(g, cam, mod, override_color=color)
    vis = want.visible[:, None].to(torch.float32)
    gm, gc, grgb = (torch.randn((n, c), generator=gen, device=dev) * vis for c in (2, 3, 3))
    go = torch.randn(n, generator=gen, device=dev) * vis[:, 0]
    gd = torch.randn(n, generator=gen, device=dev)
    f0, b0 = P.project_fwd.launches, P.project_bwd.launches
    with torch.enable_grad():
        got = P.project_gaussians(g.replace(**params), cam, scaling_modifier=mod,
                                  override_color=color, mean2d_offset=off)
        outs = [got.mean2d, got.conic, got.depth, got.opacity] + ([] if override else [got.rgb])
        cots = [gm, gc, gd, go] + ([] if override else [grgb])
        wrt = [v for k, v in params.items() if not (override and k in ("f_dc", "f_rest"))]
        grads = torch.autograd.grad(outs, wrt + [off], cots)
    ref = [t for t in P.project_bwd_plain(g, cam, mod, not override, gm, gc, gd, grgb, go)
           if t is not None]
    torch.cuda.synchronize()
    same = {k: torch.equal(getattr(got, k), getattr(want, k))
            for k in ("mean2d", "depth", "radius", "visible")}
    ulp = {k: int(ulps(getattr(got, k), getattr(want, k)).max())
           for k in ("conic", "opacity") + (() if override else ("rgb",))}
    fwd_err = max(float((getattr(got, k) - getattr(want, k)).detach().abs().max())
                  for k in ("mean2d", "conic", "depth", "radius", "opacity", "rgb"))
    rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for a, b in zip(grads[:-1], ref)]
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(grads[:-1], ref))
    launched = (P.project_fwd.launches - f0, P.project_bwd.launches - b0)
    what = (f"{label} project (modifier {mod}{', override colour' if override else ''}; "
            f"{n} rows, {int(g.n_live)} live, {int(want.visible.sum())} visible)")
    s.check(all(same.values()) and max(ulp.values()) <= 1 and launched == (1, 1),
            f"{what}: project_fwd vs project_plain bit-equal {same}, ulps {ulp} (want <= 1); "
            f"launches (fwd, bwd) {launched} (want (1, 1))")
    s.check(max(rel) <= PROJ_RTOL and torch.equal(grads[-1], gm),
            f"{what}: project_bwd vs project_bwd_plain, of each leaf's max: "
            + " ".join(f"{k} {r:.2g}" for k, r in zip(
                [k for k in PROJ_LEAVES if not (override and k in ("f_dc", "f_rest"))], rel))
            + f" (tol {PROJ_RTOL}); the offset's gradient the mean2d's bit for bit "
            f"{torch.equal(grads[-1], gm)}")
    return fwd_err, bwd_err


def phase_project(s, label, g, cam):
    """The projection's kernels against their plain versions on the cell's
    scene: the train and render path (modifier 1, an offset), the GUI's
    scaling modifier and an override colour (the no-SH branch); then their
    device ms against the plain versions' at the cell's capacity -> the
    project_fwd and project_bwd rows."""
    from gsplat_tpu_torch.render import project as P

    s.phase(f"kernel project_fwd, project_bwd ({label})")
    errs = [project_check(s, label, g, cam, seed=1),
            project_check(s, label, g, cam, seed=2, mod=GUI_MODIFIER),
            project_check(s, label, g, cam, seed=3, override=True)]
    n = g.capacity
    leaves = tuple(getattr(g, k).contiguous() for k in PROJ_LEAVES)
    n_live = g.n_live.to(torch.int32)
    deg = g.active_sh_degree
    with torch.no_grad():
        vis = P.project_plain(g, cam).visible[:, None].to(torch.float32)
    gen = torch.Generator(device=g.device).manual_seed(4)
    # the incoming gradients as the render hands them back: column slices
    # of an (N + 1, 16) table, nonzero on the visible rows
    d = torch.randn((n + 1, 16), generator=gen, device=g.device) \
        * torch.cat([vis, vis.new_zeros((1, 1))])
    gin = (d[:n, 0:2], d[:n, 2:5], None, d[:n, 5:8], d[:n, 8])
    f0, b0 = P.project_fwd.launches, P.project_bwd.launches
    ms_f = device_ms(lambda: P.project_fwd(leaves, n_live, cam, 1.0, deg), 20)
    ms_b = device_ms(lambda: P.project_bwd(leaves, n_live, cam, 1.0, deg, *gin, True), 20)
    plain_f = device_ms(lambda: P.project_plain(g, cam), 5)
    plain_b = device_ms(lambda: P.project_bwd_plain(g, cam, 1.0, True, *gin), 5)
    P.project_fwd.launches, P.project_bwd.launches = f0, b0
    n_vis = int(vis.sum())
    m3 = 3 * g.f_rest.shape[1]
    # forward: every row's 59 parameter floats (236 B at SH 3) read, mean2d,
    # conic, depth, radius, rgb, opacity (44 B) and visible (1 B) written;
    # backward: every row's leaves but f_rest (56 B) and its incoming
    # gradients (mean2d, conic, rgb, opacity: 36 B) read, its f_rest (4 * m3
    # B) only where its rgb gradient is nonzero, every leaf's gradient (236
    # B) and the offset's (8 B) written; operations benchmark/work.py's 338
    # a splat, twice for the gradient
    leaf_b = 4 * (3 + 3 + m3 + 1 + 3 + 4)
    fwd_bytes = n * (leaf_b + 45)
    bwd_bytes = n * (leaf_b - 4 * m3 + 36 + leaf_b + 8) + n_vis * 4 * m3
    print(f"  {label} project_fwd {ms_f:.4f} ms (plain {plain_f:.4f}), project_bwd "
          f"{ms_b:.4f} ms (plain {plain_b:.4f}); {n} rows, {n_vis} with an incoming "
          f"gradient; bytes {fwd_bytes / 1e6:.1f} / {bwd_bytes / 1e6:.1f} MB", flush=True)
    common = dict(route="cuda", source="gsplat_tpu_torch/csrc/project.cu", library_ms=None)
    return (dict(common, name="project_fwd", replaces="gsplat_tpu/render/project.py:51 (XLA)",
                 max_abs_err=max(e[0] for e in errs), ms=ms_f, plain_ms=plain_f,
                 bytes=fwd_bytes, ops=338 * n),
            dict(common, name="project_bwd",
                 replaces="gsplat_tpu/render/project.py:51 (XLA's autodiff)",
                 max_abs_err=max(e[1] for e in errs), ms=ms_b, plain_ms=plain_b,
                 bytes=bwd_bytes, ops=2 * 338 * n))


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

    pair_fit, kept, _, _ = probe_view(g, cam, budget, tile)
    out = render(cam, g, bg, tile_size=tile, chunk=CHUNK, pair_budget=pair_fit,
                 kept_budget=kept)
    contrib = budgets.fit_contrib(out.n_contrib)
    del out
    # the steps move the Gaussians, and with them the pair, kept and
    # composited counts (+4.4% composited rows over the 10 sparse steps on
    # an H100): the headroom the training loop gives its fitted budgets
    return budgets.with_headroom(pair_fit, kept, contrib, budget, CHUNK)


def step_gradients(g, cam, bg, tile, pair_fit, kept, contrib, attr_pack=False,
                   image_mean=False):
    """The gradients one make_train_step step takes (render, the
    photometric loss, torch.autograd.grad; the mean2d offset too), on the
    packed pair table with attr_pack; of the image's mean in place of the
    loss with image_mean (tests/test_attr_pack.py's objective) -> {group:
    gradient}."""
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loss import photometric_loss

    params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
    offset = torch.zeros((g.capacity, 2), device=g.device, requires_grad=True)
    with torch.enable_grad():
        out = render(cam, g.replace(**params), bg, tile_size=tile, chunk=CHUNK,
                     pair_budget=pair_fit, kept_budget=kept, contrib_budget=contrib,
                     mean2d_offset=offset, attr_pack=attr_pack)
        loss = out.image.mean() if image_mean else photometric_loss(out.image, cam.image)
        grads = torch.autograd.grad(loss, list(params.values()) + [offset])
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
        # the loop's kept regrowth headroom, here for the sat budget too
        sat = min(kept, budgets.ceil_to(int(probe.n_sat) * budgets.KEPT_REGROW, CHUNK))
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
    from gsplat_tpu_torch.render import (bounds, compact, expand, filter3d, project, raster,
                                         reduce, scan)

    return {"expand_pairs": expand.expand_pairs, "composite_fwd": raster.composite_fwd,
            "composite_bwd": raster.composite_bwd, "segment_ends": bounds.segment_ends,
            "segment_sum": reduce.segment_sum, "prefix_sum_small": scan.prefix_sum_small,
            "compact_runs": compact.compact_runs, "project_fwd": project.project_fwd,
            "project_bwd": project.project_bwd, "filter3d": filter3d.filter3d,
            # K2 and K3 on the packed pair table, counted apart from the above
            "composite_fwd packed": raster.packed_fwd_count,
            "composite_bwd packed": raster.packed_bwd_count,
            # the projection's Mip-Splatting variants, counted apart too
            "project_fwd mip": project.mip_fwd_count,
            "project_bwd mip": project.mip_bwd_count}


FWD_KERNELS = ("project_fwd", "expand_pairs", "composite_fwd")
SAT_KERNELS = ("prefix_sum_small", "compact_runs")
TRAIN_KERNELS = ("project_fwd", "project_bwd", "expand_pairs", "composite_fwd",
                 "composite_bwd", "segment_ends", "segment_sum")


def run_cell(s, label, g, cam_args, views, budget, target):
    """The kernels against their plain versions at the bench view's fitted
    budgets, then the serve and train phases, with and without the
    saturation cull, each with the launch counts from zero -> ({kernel name:
    row}, launches of the main path, renders run, view results, train
    results, the counts bench.py reports for the cell's scene: pairs and
    contrib of the bench view at the cell's pair budget, culled of its fit
    probe, sat_kept of its sat probe)."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render.render import render

    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, device="cuda")
    pair_fit, kept, _, n_culled = probe_view(g, cam, budget)
    plain = render(cam, g, torch.zeros(3, device=g.device), tile_size=TILE, chunk=CHUNK,
                   pair_budget=budget)
    bench_counts = dict(pairs=int(plain.n_pairs), contrib=int(plain.n_contrib),
                        culled=n_culled)
    del plain
    s.phase(f"kernel expand_pairs ({label})")
    k1 = phase_expand(s, label, g, cam, pair_fit, kept)
    if label == "dense":
        k1["max_abs_err"] = max(k1["max_abs_err"], phase_expand_sat(s, label, g, cam, pair_fit))
    s.phase(f"kernel composite_fwd ({label})")
    k2 = phase_composite(s, label, g, cam, pair_fit, kept)
    s.phase(f"kernel composite_fwd packed ({label})")
    k2p = phase_composite(s, label, g, cam, pair_fit, kept, pack=True)
    target_t = torch.from_numpy(target).to(g.device)
    k3p, d = phase_backward(s, label, g, cam, target_t, pair_fit, kept, pack=True)
    del d
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
        sat = budgets.chunk_fit(b.n_sat, CHUNK)
    del b
    k5, C = phase_scan(s, label, seen)
    k6 = phase_compact(s, label, seen, C, sat)
    del seen, C
    kp_fwd, kp_bwd = phase_project(s, label, g, cam)
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
        n_renders, n_sat_renders, bench_counts["sat_kept"] = serve_sat_probe(s, g, cam_args,
                                                                             label)
    else:
        s.phase(f"serve {label} sat")
        n_renders, n_sat_renders, sat_result = serve_sat(s, g, cam_args, budget, label)
        results.append(dict(view="sat", **sat_result))
        bench_counts["sat_kept"] = sat_result["n_sat"]
    renders += n_renders
    sat_launches = read(f"{label} sat serve", n_renders, n_sat_renders)
    s.phase(f"serve {label} packed")
    pk_launches, _ = serve_packed(s, label, g, cam_args, budget, zero, counts)
    torch.cuda.empty_cache()
    s.phase(f"train {label}")
    t_launches, trained = train(s, label, g, cam_args, target, budget, TRAIN_STEPS[label])
    phases = [sat_launches, pk_launches, t_launches]
    if label == "dense":
        s.phase(f"train {label} sat")
        st_launches, trained["sat"] = train(s, f"{label} sat", g, cam_args, target, budget,
                                            TRAIN_STEPS[label], ref=trained)
        phases.append(st_launches)
    trained.pop("step1")
    torch.cuda.empty_cache()
    grads_twice(s, label, g, cam_args, target, budget)
    if label == "sparse":
        s.phase(f"step {label} packed")
        phases.append(step_packed(s, label, g, cam_args, target, budget, zero, counts,
                                  trained["losses"][0]))
    rows = {k["name"]: k for k in (k1, k2, k3, k4, k_sum, k5, k6, k2p, k3p, kp_fwd, kp_bwd)}
    for tile in WIDE_TILES:
        k2w, k3w, w_launches = wide_tile(s, label, g, cam_args, target, budget,
                                         trained["losses"][0], zero, counts, tile)
        phases.append(w_launches)
        rows[f"composite_fwd tile {tile}"], rows[f"composite_bwd tile {tile}"] = k2w, k3w
    for more in phases:
        launches = {k: launches[k] + more[k] for k in launches}
    return rows, launches, renders, results, trained, bench_counts


def wide_tile(s, label, g, cam_args, target, budget, loss1, zero, counts, tile):
    """A tile above 32: 64, the widest the compositing kernels run in pixel
    passes (four), or 128, which they run in windows of 64x64. K2 and K3
    against their plain versions on the bench view's real pair table and
    loss cotangent, then, with the launch counts from zero, a served frame
    and one train step at that tile, whose loss must stay within 2e-4 of the
    tile-32 step 1's `loss1` -> (K2 row, K3 row, launches)."""
    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loop import make_train_step
    from gsplat_tpu_torch.train.optim import init_adam_state

    wl = f"{label} tile {tile}"
    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, image=target, device="cuda")
    bg = torch.zeros(3, device=g.device)
    pair_fit, kept, _, _ = probe_view(g, cam, budget, tile)
    s.phase(f"kernel composite_fwd ({wl})")
    k2 = phase_composite(s, wl, g, cam, pair_fit, kept, tile)
    k3, d = phase_backward(s, wl, g, cam, cam.image, pair_fit, kept, tile)
    del d
    torch.cuda.empty_cache()
    pair_t, kept_t, contrib = train_budgets(g, cam, bg, budget, tile)
    step_fn = make_train_step(OptimizationParams(), MeshParams(
        tile_size=tile, chunk_size=CHUNK, pair_budget=pair_t), 1.0, W, H,
        kept_budget=kept_t, contrib_budget=contrib)
    opt_state = init_adam_state(g.params())

    def frame():
        return render(cam, g, bg, tile_size=tile, chunk=CHUNK, pair_budget=pair_fit,
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
        pair_fit, kept, n_pairs, n_culled = probe_view(g, cam, budget)

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
    cull, n_sat)."""
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
    return 2, 1, n_sat


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
    pair_fit, kept, _, _ = probe_view(g, cam, budget)

    def run(on_stage=None, sat=None):
        return render_mod.render(cam, g, bg, tile_size=TILE, chunk=CHUNK,
                                 pair_budget=pair_fit, kept_budget=kept, sat_budget=sat,
                                 on_stage=on_stage)

    n_sat = int(run(sat=kept).n_sat)
    sat = budgets.chunk_fit(n_sat, CHUNK)
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


# the packed pair table against the f32 one: tests/test_attr_pack.py's
# bounds (bf16 rounding of rgb and opacity, ~2^-9 relative)
PACK_IMAGE_MAX, PACK_IMAGE_MEAN = 2e-2, 2e-3
PACK_GRAD_RTOL = 2e-2    # each gradient group, of that group's max
PACK_STEPS = 2           # make_train_step steps under GSPLAT_PACK=1's default


def serve_packed(s, label, g, cam_args, budget, zero, counts):
    """The bench view served on the packed pair table, the saturation cull
    off and on, beside the f32 table: K2 on each packed table the render
    handed it against its plain version (fwd_against_plain), each packed
    image within PACK_IMAGE_MAX / PACK_IMAGE_MEAN of the f32 one, the
    packed image with the cull bit-equal to the packed image without it,
    n_dropped 0; frame ms (FRAME_REPS synced), the gather and composite
    stages (CUDA events) of each; the launch counts from zero ->
    (launches, results)."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.render import render as render_mod
    from gsplat_tpu_torch.render.binning import tile_grid
    from gsplat_tpu_torch.render.render import render

    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, device="cuda")
    bg = torch.zeros(3, device=g.device)
    if label == "sparse":
        # the sparse view's cull regions outnumber its kept pairs: pair and
        # sat budget SPARSE_BUDGET, as the sat probe phase renders it
        base = dict(pair_budget=SPARSE_BUDGET, kept_budget=SPARSE_BUDGET - CHUNK)
        culled = dict(pair_budget=SPARSE_BUDGET, sat_budget=SPARSE_BUDGET)
    else:
        pair_fit, kept, _, _ = probe_view(g, cam, budget)
        base = dict(pair_budget=pair_fit, kept_budget=kept)
        n_sat = int(render(cam, g, bg, tile_size=TILE, chunk=CHUNK, **base,
                           sat_budget=kept).n_sat)
        culled = dict(base, sat_budget=budgets.chunk_fit(n_sat, CHUNK))
    zero()
    renders = {False: 0, True: 0}
    results, images, k2_inputs = {}, {}, {}
    real = render_mod.composite_fwd

    def capture(attrs, ts, tc, **k):
        out = real(attrs, ts, tc, **k)
        if attrs.shape[1] == raster.PACKED_IN_DIM:
            k2_inputs.setdefault(cull, (attrs, k["gid"], ts, tc, out))
        return out

    for cull, kw in (("off", base), ("on", culled)):
        for pack in (False, True):
            def run(on_stage=None):
                renders[pack] += 1
                return render(cam, g, bg, tile_size=TILE, chunk=CHUNK, attr_pack=pack,
                              on_stage=on_stage, **kw)

            render_mod.composite_fwd = capture
            try:
                out = run()
            finally:
                render_mod.composite_fwd = real
            times = [wall_ms(run)[0] for _ in range(FRAME_REPS)]
            stages = StageEvents()
            run(on_stage=stages)
            st = stages.ms()
            images[cull, pack] = out.image
            results[cull, pack] = dict(ms=statistics.median(times), min=min(times),
                                       max=max(times), gather=st["gather"],
                                       composite=st["composite"], n_dropped=int(out.n_dropped),
                                       n_sat=int(out.n_sat))
        err = (images[cull, True] - images[cull, False]).abs()
        mx, mean = float(err.max()), float(err.mean())
        drops = [results[cull, p]["n_dropped"] for p in (False, True)]
        s.check(mx <= PACK_IMAGE_MAX and mean <= PACK_IMAGE_MEAN and not any(drops),
                f"{label} packed vs f32 table, cull {cull} ({kw}): image max |diff| {mx:.3g} "
                f"(tol {PACK_IMAGE_MAX}), mean {mean:.3g} (tol {PACK_IMAGE_MEAN}); n_dropped "
                f"{drops}")
        for pack in (False, True):
            r = results[cull, pack]
            print(f"  {label} cull {cull}, {'packed' if pack else 'f32'} table: frame ms "
                  f"median {r['ms']:.3f} min {r['min']:.3f} max {r['max']:.3f}; gather "
                  f"{r['gather']:.3f} ms, composite (K2) {r['composite']:.3f} ms; n_sat "
                  f"{r['n_sat']}", flush=True)
    same = torch.equal(images["on", True], images["off", True])
    s.check(same, f"{label} packed table: the image with the saturation cull bit-equal to "
            f"the image without it {same}")
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counts.items()}
    tw = tile_grid(W, H, TILE)[0]
    for cull, (attrs, gid, ts, tc, (tiles_k, np_k)) in k2_inputs.items():
        fwd_against_plain(s, f"{label} cull {cull} packed", attrs, ts, tc, tw, TILE, tiles_k,
                          np_k, gid)
    del k2_inputs
    total = renders[False] + renders[True]
    s.check(launches["expand_pairs"] >= total and launches["composite_fwd"] >= renders[False]
            and launches["composite_fwd packed"] >= renders[True]
            and all(launches[k] >= 2 + FRAME_REPS for k in SAT_KERNELS),
            f"{label} serve packed kernel launches {launches} cover its {renders[True]} "
            f"packed and {renders[False]} f32 renders, {2 * (2 + FRAME_REPS)} with the cull")
    return launches, results


def step_packed(s, label, g, cam_args, target, budget, zero, counts, loss1):
    """One train step's gradients on the packed pair table (render(...,
    attr_pack=True), the photometric loss, autograd) at the bench view:
    the same bits from two passes; the gradients of the image's mean
    (tests/test_attr_pack.py's objective: the L1 term's sign flips wherever
    the rounding moves a pixel across the random target, which no
    tolerance of the rounding bounds) on the packed table, each group
    within PACK_GRAD_RTOL of its max of the f32 table's; then PACK_STEPS
    make_train_step steps with
    render's default packed (GSPLAT_PACK=1): losses finite, n_dropped 0,
    step 1's loss printed beside the f32 step 1's `loss1`; the launch
    counts from zero -> launches."""
    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.train.loop import make_train_step
    from gsplat_tpu_torch.train.optim import init_adam_state

    R, T, fovx, fovy = cam_args
    cam = make_camera(R, T, fovx, fovy, W, H, image=target, device="cuda")
    bg = torch.zeros(3, device=g.device)
    pair_fit, kept, contrib = train_budgets(g, cam, bg, budget)
    zero()
    a = step_gradients(g, cam, bg, TILE, pair_fit, kept, contrib, attr_pack=True)
    b = step_gradients(g, cam, bg, TILE, pair_fit, kept, contrib, attr_pack=True)
    torch.cuda.synchronize()
    differ = {k: int((a[k] != b[k]).sum()) for k in a}
    s.check(not any(differ.values()),
            f"{label} packed table: two gradient passes of one train step, entries that "
            f"differ per group {differ} (want 0 each)")
    a = step_gradients(g, cam, bg, TILE, pair_fit, kept, contrib, attr_pack=True,
                       image_mean=True)
    f = step_gradients(g, cam, bg, TILE, pair_fit, kept, contrib, image_mean=True)
    rel = {k: float((a[k] - f[k]).abs().max() / f[k].abs().max().clamp(min=1e-30))
           for k in a}
    s.check(all(v <= PACK_GRAD_RTOL for v in rel.values()),
            f"{label} packed vs f32 table gradients of the image mean, max |diff| of each "
            f"group's max: "
            + " ".join(f"{k} {v:.3g}" for k, v in rel.items()) + f" (tol {PACK_GRAD_RTOL})")
    del a, b, f
    step_fn = make_train_step(OptimizationParams(), MeshParams(
        tile_size=TILE, chunk_size=CHUNK, pair_budget=pair_fit), 1.0, W, H,
        kept_budget=kept, contrib_budget=contrib)
    opt_state, ema, losses, ok, times = init_adam_state(g.params()), 0.0, [], True, []
    real = raster.PACK_DEFAULT
    raster.PACK_DEFAULT = True     # what GSPLAT_PACK=1 sets at import
    try:
        with torch.enable_grad():
            g1 = g
            for step in range(1, PACK_STEPS + 1):
                ms, out = wall_ms(lambda: step_fn(g1, opt_state, cam, bg, step, ema))
                g1, opt_state, loss, ema, _, n_dropped, _, n_contrib, _ = out
                losses.append(float(loss))
                times.append(ms)
                ok &= int(n_dropped) == 0 and int(n_contrib) <= contrib
    finally:
        raster.PACK_DEFAULT = real
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counts.items()}
    s.check(ok and all(math.isfinite(x) for x in losses),
            f"{label} {PACK_STEPS} train steps on the packed table (GSPLAT_PACK=1): losses "
            f"{losses} finite, n_dropped 0, contrib within {contrib}; step 1 loss vs the f32 "
            f"step 1 {loss1:.6f}: diff {losses[0] - loss1:+.3e}; step ms {times}")
    need = 3 + PACK_STEPS
    s.check(all(launches[k] >= need for k in ("composite_fwd packed", "composite_bwd packed",
                                              "expand_pairs", "segment_ends", "segment_sum"))
            and launches["composite_fwd"] >= 1 and launches["composite_bwd"] >= 1,
            f"{label} step packed kernel launches {launches} cover its 3 packed gradient "
            f"passes and {PACK_STEPS} packed steps, and the f32 pass")
    del g1, opt_state
    torch.cuda.empty_cache()
    return launches


def phase_serving_bench(s, counts):
    """tools/serving_bench.py in process, as a user runs it (1M Gaussians,
    1080p, both scenes), without and with --pack, each with the launch
    counts from zero: its JSON line printed, every time finite -> launches
    summed."""
    import contextlib
    import io

    from gsplat_tpu_torch.tools import serving_bench

    total = {k: 0 for k in counts}
    for argv in ([], ["--pack"]):
        s.phase("serving_bench " + " ".join(argv))
        for f in counts.values():
            f.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serving_bench.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        line = buf.getvalue().strip().splitlines()[-1]
        print("  " + line)
        got = json.loads(line)
        launches = {k: f.launches for k, f in counts.items()}
        key = "composite_fwd packed" if argv else "composite_fwd"
        times = [got[f"{c}_{m}"] for c in ("sparse", "dense")
                 for m in ("ms", "pipelined_ms")]
        # each scene: one frame checked, 8 synced, 10 pipelined
        s.check(rc == 0 and got["attr_pack"] == bool(argv)
                and all(math.isfinite(t) and t > 0 for t in times)
                and launches[key] >= 2 * 19 and launches["expand_pairs"] >= 2 * 19,
                f"serving_bench {' '.join(argv)}: exit {rc}, frame ms {times} finite; "
                f"launches {launches} cover its 2 x 19 frames ({key}); {wall:.1f} s wall")
        total = {k: total[k] + launches[k] for k in total}
        torch.cuda.empty_cache()
    return total


def sync_census(fn):
    """The synchronising CUDA calls one call of fn() makes, as torch's sync
    debug mode reports them (a prototype that, in its own words, does not
    detect all of them; the kernels' C wrappers make none) -> ["file:line"]
    of each, with the port's innermost frame above it ("from file:line")."""
    import traceback
    import warnings

    found = []

    def record(message, category, filename, lineno, file=None, line=None):
        # not the mode's one-time notice that it is a prototype
        if "called a synchronizing" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]
                    if "gsplat_tpu_torch" in f.filename]
            found.append(f"{Path(filename).name}:{lineno}" + (
                f" from {Path(ours[-1].filename).name}:{ours[-1].lineno}" if ours else ""))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return found


def phase_bench(s, card, cells, loss1, counts):
    """bench_torch.py's measurement in process (tools/bench.py's main at its
    card defaults: both densities, every pass), the launch counts from
    zero: its JSON line printed; the counts of each density equal to its
    cell's (`cells`: {"sparse", "dense"} -> run_cell's bench counts), loss
    the sparse cell's train step 1 (`loss1`) bit for bit; every pass that
    ran with n_dropped 0 and its times; then, on each density's scene, no
    host sync in one step of each pass (sync_census) and the kernels
    against their plain versions at the budgets the bench fits ->
    (launches, {kernel: max |err|})."""
    import contextlib
    import io

    from gsplat_tpu_torch.tools import bench
    from gsplat_tpu_torch.tools.bench_scene import fwd_bwd, scene_on_device

    s.phase("bench")
    for f in counts.values():
        f.launches = 0
    buf = io.StringIO()
    t_phase = t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counts.items()}
    line = buf.getvalue().strip().splitlines()[-1]
    print("  " + line, flush=True)
    got = json.loads(line)
    name, limit = (part.strip() for part in card.split(",", 1))
    s.check(rc == 0 and got["metric"] == bench.METRIC and got["backend"] == "cuda"
            and got["device"] == torch.cuda.get_device_name(0) == name
            and got["power_limit"] == limit,
            f"bench: exit {rc}, metric {got['metric']}, device {got['device']!r}, power limit "
            f"{got['power_limit']!r} (the card: {card!r}); {wall:.1f} s wall")

    passes = {"plain": ("plain_step_ms", "pipelined_step_ms"),
              "kept": ("kept_step_ms", "kept_pipelined_ms"),
              "sat": ("sat_step_ms", "sat_pipelined_ms")}
    steps, sat_steps, fits = 0, 0, {}
    for label, _, budget, iters in bench.CARD_CONFIGS:
        pre, cell = "" if label == "sparse" else "dense_", cells[label]
        same = {"pairs_per_pixel": got[pre + "pairs_per_pixel"] == cell["pairs"] / (W * H)}
        same.update({k: got[pre + k] == cell[k] for k in ("culled", "contrib", "sat_kept")})
        s.check(all(same.values()) and (pre or got["pairs"] == cell["pairs"]),
                f"bench {label}: pairs per pixel {got[pre + 'pairs_per_pixel']!r}, culled "
                f"{got[pre + 'culled']}, contrib {got[pre + 'contrib']}, sat_kept "
                f"{got[pre + 'sat_kept']} vs the {label} cell's {cell}: equal {same}")
        # the passes bench.py's fits run: kept where the probe culled, sat
        # where the survivors fall a chunk short of the kept budget
        pair_fit = budgets.fit_pair_bench(cell["pairs"], budget, CHUNK)
        kept = budgets.fit_kept(cell["pairs"], cell["culled"], CHUNK)
        contrib = budgets.fit_contrib(cell["contrib"])
        sat = (budgets.fit_sat_bench(cell["sat_kept"], 0, kept, CHUNK) if cell["culled"]
               else None)
        fitted = dict(pair_budget=pair_fit, kept_budget=kept, contrib_budget=contrib)
        runs = {"plain": dict(pair_budget=budget)}      # each pass's render budgets
        if cell["culled"]:
            runs["kept"] = fitted
        if sat is not None:
            runs["sat"] = dict(fitted, sat_budget=sat)
        fits[label] = budget, pair_fit, kept, sat, runs
        ran = {p: p in runs for p in passes}
        good = got[pre + "n_dropped"] == 0
        for p, keys in passes.items():
            for k in keys:
                t = (got[pre + k], got[pre + bench.device_key(k)])
                good &= all(v is not None and math.isfinite(v) and v > 0 for v in t) \
                    if ran[p] else t == (None, None)
        s.check(good, f"bench {label}: plain pass n_dropped {got[pre + 'n_dropped']} (the "
                f"fitted passes raise on a drop); passes run {ran}, each with its synced, "
                f"pipelined and device ms: " + ", ".join(
                    f"{k} {got[pre + k]} ({got[pre + bench.device_key(k)]} device)"
                    for keys in passes.values() for k in keys)
                + f"; peak memory {got[pre + 'peak_memory_bytes']} bytes")
        per_pass = 1 + iters + bench.PIPELINE
        steps += per_pass * sum(ran.values())
        sat_steps += per_pass * ran["sat"]
    s.check(got["loss"] == loss1,
            f"bench loss {got['loss']!r} vs the sparse cell's train step 1 {loss1!r}: "
            f"bit-equal {got['loss'] == loss1}")
    need = {**{k: steps for k in TRAIN_KERNELS}, **{k: sat_steps for k in SAT_KERNELS}}
    s.check(all(launches[k] >= n for k, n in need.items()),
            f"bench kernel launches {launches} cover its {steps} steps "
            f"({', '.join(TRAIN_KERNELS)}), {sat_steps} with the sat cull "
            f"({', '.join(SAT_KERNELS)}); {wall:.1f} s wall")

    errs = {}
    for label, ppg, _, _ in bench.CARD_CONFIGS:
        budget, pair_fit, kept, sat, runs = fits[label]
        g, cam = scene_on_device(N, W, H, target_pairs_per_gaussian=ppg,
                                 tile_size=bench.SCENE_TILE, device="cuda")
        bg = torch.zeros(3, device="cuda")
        for name, kw in runs.items():
            syncs = sync_census(lambda: fwd_bwd(g, cam, bg, tile_size=TILE, chunk=CHUNK, **kw))
            s.check(not syncs, f"bench {label} {name} pass: {len(syncs)} host syncs in one "
                    f"step (torch's sync debug mode; want 0, or its pipelined time is not "
                    f"pipelined){': ' + ', '.join(syncs) if syncs else ''}")
        # K5 and K6 on the sat pass's inputs; where it is skipped, on the
        # probe's kept prefix at the plain pass's budget, which holds its regions
        sat_inputs = (pair_fit, kept, sat) if sat is not None else (budget, kept, budget)
        print(f"  bench {label}: the kernels at pair budget {budget} and {pair_fit}, kept "
              f"{kept}, sat inputs {sat_inputs}", flush=True)
        e, _, _ = loop_kernel_checks(s, f"bench {label}", g, cam, cam.image, (budget, pair_fit),
                                     kept=kept, sat_inputs=sat_inputs)
        errs = {k: max(errs.get(k, 0.0), v) for k, v in e.items()}
        del g, cam
        torch.cuda.empty_cache()
    print(f"  bench phase: {time.perf_counter() - t_phase:.1f} s wall, the kernel checks "
          "included", flush=True)
    return launches, errs


JPEG_DIR = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
# the 1080p fixtures, baseline and progressive (both 4:2:0)
JPEG_1080P = ("smooth_1080p_420.jpg", "smooth_1080p_prog420.jpg")
JPEG_ITERS = 10


def phase_jpeg(s, tmp, counts):
    """The port's JPEG decoder on the committed fixtures (sha256 of each
    decode against the manifest's, PIL's: baseline, progressive, CMYK and
    YCCK), the 1080p fixtures' decode ms; then render_cli's COLMAP source
    written again with .jpg images (the baseline and the progressive 1080p
    fixture in turns as the views') and cli.main JPEG_ITERS iterations over
    it from the sparse scene's start.npz: losses finite, n_dropped 0, each
    Scene camera's image its file's decode / 255 -> launches."""
    import hashlib

    from gsplat_tpu_torch.io import colmap, jpeg, native_loader

    s.phase("jpeg")
    manifest = json.loads((JPEG_DIR / "manifest.json").read_text())
    bad = []
    for name, want in sorted(manifest.items()):
        arr = jpeg.read_jpeg(JPEG_DIR / name)
        if list(arr.shape) != want["shape"] or \
                hashlib.sha256(arr.tobytes()).hexdigest() != want["sha256"]:
            bad.append(name)
    s.check(not bad, f"the port's JPEG decode of {len(manifest)} committed fixtures: sha256 "
            f"equal to the manifest's (PIL's decode) but {bad} (want none)")
    data, decoded = {}, {}
    for name in JPEG_1080P:
        data[name] = (JPEG_DIR / name).read_bytes()
        ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            decoded[name] = jpeg.decode_jpeg(data[name], name)
            ms.append((time.perf_counter() - t0) * 1e3)
        rt = []
        for _ in range(10):
            t0 = time.perf_counter()
            native_loader.decode_image(JPEG_DIR / name, W, H)
            rt.append((time.perf_counter() - t0) * 1e3)
        print(f"  {name} ({len(data[name])} bytes, {decoded[name].shape}): decode ms median "
              f"{statistics.median(ms):.3f} min {min(ms):.3f} max {max(ms):.3f} (host clock, "
              f"10); the IO runtime's decode to float32 at its own size {statistics.median(rt):.3f} "
              "ms (median of 10)", flush=True)

    src, jsrc = Path(tmp) / "cli_source", Path(tmp) / "cli_source_jpg"
    shutil.copytree(src / "sparse", jsrc / "sparse")
    (jsrc / "images").mkdir()
    sparse = jsrc / "sparse" / "0"
    images = colmap.read_extrinsics_binary(sparse / "images.bin")
    file_of = {}
    for i, im in enumerate(sorted(images.values(), key=lambda im: im.name)):
        im.name = Path(im.name).with_suffix(".jpg").name
        file_of[Path(im.name).stem] = JPEG_1080P[i % 2]
        (jsrc / "images" / im.name).write_bytes(data[JPEG_1080P[i % 2]])
    colmap.write_extrinsics_binary(images, sparse / "images.bin")
    argv = ["-s", str(jsrc), "-m", str(Path(tmp) / "train_jpg"), "--resolution", "1",
            "--eval", "--iterations", str(JPEG_ITERS), "--quiet", "--pair_budget",
            str(1 << 22), "--start_checkpoint", str(Path(tmp) / "start.npz")]
    spy, launches, wall = run_train_cli(s, "jpeg cli", argv, counts)
    g_end, scene = spy.result
    cams = scene.get_train_cameras() + scene.get_test_cameras()
    kinds = [file_of[Path(c.image_name).stem] for c in cams]
    same = [torch.equal(c.image.cpu(), torch.from_numpy(decoded[k].astype(np.float32) / 255.0))
            for c, k in zip(cams, kinds)]
    losses = [st["loss"] for st in spy.steps]
    s.check(len(spy.steps) == JPEG_ITERS and all(math.isfinite(x) for x in losses)
            and all(st["n_dropped"] == 0 for st in spy.steps) and all(same)
            and len(same) == len(CLI_VIEWS) and set(kinds) == set(JPEG_1080P),
            f"jpeg cli over {len(cams)} JPEG views of 1920x1080 4:2:0 ({kinds}): "
            f"{len(spy.steps)} "
            f"steps, losses finite ({losses[0]:.5f} -> {losses[-1]:.5f}), n_dropped "
            f"{[st['n_dropped'] for st in spy.steps]}; each camera's image the decode / 255 "
            f"{same}; {wall:.1f} s wall: {spy.wall_split(wall)}")
    del g_end, scene
    torch.cuda.empty_cache()
    return launches


# ---- capture load: a COLMAP capture of a real size through Scene ----

CAPTURE_VIEWS = 200          # Mip-NeRF 360's garden capture holds 185 views
CAPTURE_SLOW_VIEWS = 20      # the per-camera path's views (its LANCZOS is slow)
CAPTURE_RES = 2              # --resolution 2: 960x540 from 1920x1080
CAPTURE_ITERS = 10


def write_capture_source(root, cam_args, n_views, data, points):
    """A COLMAP source of n_views views at W x H: one PINHOLE camera (the
    bench camera's focal lengths), the bench camera turned from -5 to +5
    degrees of yaw and moved along world x from -CLI_SHIFT to +CLI_SHIFT,
    the 1080p JPEG fixtures (`data`) in turns as the views' .jpg, and the
    points3D.bin at `points` -> {image name: fixture}."""
    from gsplat_tpu_torch.io import colmap

    R, T, fovx, fovy = cam_args
    sparse = Path(root) / "sparse" / "0"
    sparse.mkdir(parents=True)
    (Path(root) / "images").mkdir()
    colmap.write_intrinsics_binary({1: colmap.Camera(
        id=1, model="PINHOLE", width=W, height=H,
        params=np.array([W / (2 * math.tan(fovx / 2)), H / (2 * math.tan(fovy / 2)),
                         W / 2, H / 2]))}, sparse / "cameras.bin")
    images, kinds = {}, {}
    for i in range(n_views):
        t = i / max(n_views - 1, 1)
        Ri, Ti = shifted_view(cam_args, 10.0 * t - 5.0, CLI_SHIFT * (2.0 * t - 1.0))[:2]
        kind = JPEG_1080P[i % 2]
        images[i + 1] = colmap.Image(id=i + 1, qvec=colmap.rotmat2qvec(Ri.T), tvec=Ti,
                                     camera_id=1, name=f"{i:05d}.jpg")
        kinds[f"{i:05d}"] = kind
        (Path(root) / "images" / f"{i:05d}.jpg").write_bytes(data[kind])
    colmap.write_extrinsics_binary(images, sparse / "images.bin")
    shutil.copyfile(points, sparse / "points3D.bin")
    return kinds


def load_capture(source, model, native):
    """Scene over `source` at --resolution CAPTURE_RES (its images on the
    card), through the IO runtime or, with `native` False, the per-camera
    path (the runtime held off) -> (Scene, wall seconds, {part: seconds}:
    the runtime's predecode, and the per-camera decodes and resizes)."""
    import gsplat_tpu_torch.scene as scene_mod
    from gsplat_tpu_torch.config import ModelParams
    from gsplat_tpu_torch.core import camera as camera_mod
    from gsplat_tpu_torch.io import dataset, native_loader

    clock = {"predecode": 0.0, "decode": 0.0, "resize": 0.0}
    patched = [(scene_mod, "_predecode_images_native", "predecode"),
               (dataset, "load_image_rgb", "decode"), (camera_mod, "_resize_image", "resize")]
    real = {(m, n): getattr(m, n) for m, n, _ in patched}
    real_available = native_loader.available

    def timed(fn, key):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                clock[key] += time.perf_counter() - t
        return wrapper

    for m, n, key in patched:
        setattr(m, n, timed(real[(m, n)], key))
    if not native:
        native_loader.available = lambda: False
    try:
        t0 = time.perf_counter()
        scene = scene_mod.Scene(ModelParams(source_path=str(source), model_path=str(model),
                                            resolution=CAPTURE_RES, eval=True), shuffle=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for (m, n), fn in real.items():
            setattr(m, n, fn)
        native_loader.available = real_available
    return scene, wall, clock


def phase_capture_load(s, tmp, cam_args, counts, card):
    """A capture of CAPTURE_VIEWS 1080p JPEG views: Scene through the IO
    runtime and through the per-camera path (CAPTURE_SLOW_VIEWS views), then
    cli.main CAPTURE_ITERS iterations over it from start.npz -> launches."""
    from gsplat_tpu_torch.io import native_loader

    s.phase("capture load")
    data = {name: (JPEG_DIR / name).read_bytes() for name in JPEG_1080P}
    points = Path(tmp) / "cli_source" / "sparse" / "0" / "points3D.bin"
    src, few = Path(tmp) / "capture_source", Path(tmp) / "capture_source_slow"
    t0 = time.perf_counter()
    kinds = write_capture_source(src, cam_args, CAPTURE_VIEWS, data, points)
    t_write = time.perf_counter() - t0
    write_capture_source(few, cam_args, CAPTURE_SLOW_VIEWS, data, points)

    runs = {}
    for label, source, native in (("runtime", src, True), ("per-camera", few, False)):
        scene, wall, clock = load_capture(source, Path(tmp) / f"capture_{label}", native)
        cams = scene.get_train_cameras() + scene.get_test_cameras()
        decode = clock["predecode"] if native else clock["decode"] + clock["resize"]
        nbytes = sum(c.image.numel() * c.image.element_size() for c in cams)
        runs[label] = dict(scene=scene, cams=cams, wall=wall, decode=decode)
        print(f"  capture load, {label} path: {len(cams)} views of {W}x{H} JPEG at "
              f"--resolution {CAPTURE_RES}: Scene {wall:.3f} s wall ({len(cams) / wall:.2f} "
              f"views/s); decode{' and resize' if native else ' (io/jpeg.py) and resize'} "
              f"{decode:.3f} s = {decode / wall:.1%} of the set-up"
              + ("" if native else f" (decode {clock['decode']:.3f} s, LANCZOS "
                 f"{clock['resize']:.3f} s)")
              + f"; images on the card {nbytes} bytes ({nbytes / 2**20:.1f} MiB); {card}",
              flush=True)
    rt, slow = runs["runtime"], runs["per-camera"]
    first = {}
    for c in rt["cams"]:
        first.setdefault(kinds[c.image_name], c)
    same_kind = all(torch.equal(c.image, first[kinds[c.image_name]].image) for c in rt["cams"])
    plain = {k: np.array_equal(c.image.cpu().numpy(), native_loader.decode_image_plain(
        src / "images" / f"{c.image_name}.jpg", c.width, c.height)) for k, c in first.items()}
    shapes = {(c.height, c.width, c.image.device.type) for c in rt["cams"] + slow["cams"]}
    by_name = {c.image_name: c for c in rt["cams"]}
    diff = max(float((c.image - by_name[c.image_name].image).abs().max()) for c in slow["cams"])
    s.check(len(rt["cams"]) == CAPTURE_VIEWS and len(slow["cams"]) == CAPTURE_SLOW_VIEWS
            and shapes == {(H // CAPTURE_RES, W // CAPTURE_RES, "cuda")} and same_kind
            and all(plain.values()) and set(plain) == set(JPEG_1080P),
            f"capture load: {len(rt['cams'])} + {len(slow['cams'])} cameras, images "
            f"{sorted(shapes)}; the runtime's views of one fixture the same bits "
            f"{same_kind}; the first of each bit-equal to the plain version's decode "
            f"{plain}; per-camera (LANCZOS) against the runtime (bilinear): largest "
            f"difference {diff:.4f} on the same views (two ground truths); the source "
            f"written in {t_write:.3f} s")
    print(f"  capture load: the runtime path {rt['wall'] / len(rt['cams']) * 1e3:.2f} ms a view, "
          f"the per-camera path {slow['wall'] / len(slow['cams']) * 1e3:.2f} ms a view "
          f"({slow['wall'] / len(slow['cams']) / (rt['wall'] / len(rt['cams'])):.2f}x); "
          f"{card}", flush=True)
    del runs, rt, slow, first, by_name
    torch.cuda.empty_cache()

    argv = ["-s", str(src), "-m", str(Path(tmp) / "capture_train"), "--resolution",
            str(CAPTURE_RES), "--eval", "--iterations", str(CAPTURE_ITERS), "--quiet",
            "--pair_budget", str(1 << 22), "--sat_probe_interval", "5",
            "--start_checkpoint", str(Path(tmp) / "start.npz")]
    spy, launches, wall = run_train_cli(s, "capture cli", argv, counts)
    g_end, scene = spy.result
    cams = scene.get_train_cameras() + scene.get_test_cameras()
    losses = [st["loss"] for st in spy.steps]
    s.check(len(spy.steps) == CAPTURE_ITERS and all(math.isfinite(x) for x in losses)
            and all(st["n_dropped"] == 0 for st in spy.steps) and len(cams) == CAPTURE_VIEWS
            and spy.probes and all(launches[k] > 0 for k in TRAIN_KERNELS + SAT_KERNELS),
            f"capture cli over {len(cams)} views at --resolution {CAPTURE_RES}: "
            f"{len(spy.steps)} steps, losses finite ({losses[0]:.5f} -> {losses[-1]:.5f}), "
            f"n_dropped {[st['n_dropped'] for st in spy.steps]}, {len(spy.probes)} sat "
            f"probes; launches {launches}; {wall:.1f} s wall: {spy.wall_split(wall)}")
    del g_end, scene, cams
    torch.cuda.empty_cache()
    return launches


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
    """View i of the CLI source (CLI_VIEWS) -> (R, T, fovx, fovy)."""
    return shifted_view(cam_args, *CLI_VIEWS[i])


def shifted_view(cam_args, deg, shift):
    """The bench camera turned by `deg` of yaw and its centre shifted along
    world x by `shift` -> (R, T, fovx, fovy)."""
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


def run_cli(s, label, model, resolution, zero, counts, extra=()):
    """render_cli.main over the model (with the flags `extra`), the launch
    counts from zero -> (CliTimer, launches, wall seconds)."""
    from gsplat_tpu_torch import render_cli

    zero()
    t0 = time.perf_counter()
    with CliTimer(render_cli) as timer:
        rc = render_cli.main(["--model_path", str(model), "--resolution", str(resolution),
                              "--eval", *extra])
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
    try:
        native = native_loader.available()
    except RuntimeError as e:
        native = False
        print(f"  the IO runtime did not build: {e}", flush=True)
    s.check(native, f"the port's IO runtime (csrc/io_runtime.c) loaded in "
            f"{time.perf_counter() - t0:.3f} s (built in the build phase): Scene's images "
            "predecode in its worker pool (bilinear), no fallback")

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
    runtime_ms = {}
    for name, path in (("Up", src / "images" / "00000.png"), ("Paeth", paeth)):
        t0 = time.perf_counter()
        for _ in range(reps):
            native_loader.decode_image(path, W, H)
        runtime_ms[name] = (time.perf_counter() - t0) / reps * 1e3
    print(f"  PNG {W}x{H}: decode {t_dec:.1f} ms (Up rows, as the port writes them), "
          f"{t_paeth:.1f} ms (Paeth rows: the wavefront); encode of the target "
          f"{part['encode'] * 1e3:.1f} ms; the IO runtime's decode to float32 at its own "
          f"size {runtime_ms['Up']:.1f} ms (Up), {runtime_ms['Paeth']:.1f} ms (Paeth; "
          f"host clock, one thread)", flush=True)

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
    cams = scene.get_train_cameras() + scene.get_test_cameras()
    t0 = time.perf_counter()
    plain = {c.image_name: native_loader.decode_image_plain(
        src / "images" / f"{c.image_name}.png", c.width, c.height) for c in cams}
    t_plain = time.perf_counter() - t0
    same = [np.array_equal(c.image.cpu().numpy(), plain[c.image_name]) for c in cams]
    s.check(len(cams) == 4 and all(same)
            and all((c.width, c.height) == (1600, 900) for c in cams),
            f"Scene at --resolution -1: each camera's 1600x900 ground truth (the runtime's "
            f"bilinear resize) bit-equal to the plain version's decode: {same} (the plain "
            f"version {t_plain:.3f} s on the host for the {len(cams)})")
    del scene, cams, plain
    print(f"  render_cli --resolution -1: {wall2:.3f} s wall for {len(frames2)} frames; its "
          f"ground truth resized bilinearly by the IO runtime (a Scene at -1: "
          f"{t_scene:.3f} s)", flush=True)

    s.phase(f"render_cli (sparse, --tile_size {TILE_WINDOWED})")
    launches3 = cli_tile_frame(s, model, src, zero, counts)

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
    return {k: launches[k] + launches2[k] + launches3[k] for k in launches}


def cli_tile_frame(s, model, src, zero, counts, tile=TILE_WINDOWED):
    """render_cli at --tile_size `tile` (--resolution 1, --skip_train): the
    test camera's frame, n_dropped 0, its PNG bit-equal to the quantised
    render at that tile and the budget the CLI ended at; its largest
    difference from the tile-32 render (at a budget of 2^22, which drops no
    pair there) printed -> launches."""
    from gsplat_tpu_torch.config import ModelParams
    from gsplat_tpu_torch.io import png
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.scene import Scene

    label = f"render_cli --tile_size {tile}"
    timer, launches, wall = run_cli(s, label, model, 1, zero, counts,
                                    ("--tile_size", str(tile), "--skip_train"))
    frames = cli_frames(timer)
    final = frames[-1]["final"] if frames else {}
    scene = Scene(ModelParams(source_path=str(src), model_path=str(model), resolution=1,
                              eval=True), load_iteration=-1, shuffle=False)
    cam = scene.get_test_cameras()[0]
    bg = torch.zeros(3, device=scene.gaussians.device)
    out = render(cam, scene.gaussians, bg, tile_size=tile, chunk=CHUNK,
                 pair_budget=final.get("budget", CLI_BUDGET))
    ref = render(cam, scene.gaussians, bg, tile_size=TILE, chunk=CHUNK,
                 pair_budget=CLI_BUDGET << 2)
    want = (torch.clamp(out.image, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
    got = png.read_png(Path(model) / "test" / f"ours_{CLI_ITERATION}" / "renders" / "00000.png")
    s.check(len(frames) == 1 and final["n_dropped"] == 0 and int(out.n_dropped) == 0
            and (final["width"], final["height"]) == (W, H) and np.array_equal(got, want),
            f"{label}: {len(frames)} frame(s) (want 1, the test camera), "
            f"{final.get('width')}x{final.get('height')}, n_dropped {final.get('n_dropped')}; "
            f"its PNG bit-equal to the quantised render at tile {tile}: "
            f"{got.shape == want.shape and np.array_equal(got, want)}")
    diff = float((out.image - ref.image).abs().max())
    print(f"  {label}: {wall:.3f} s wall, render {final.get('device_ms', 0.0):.3f} device ms "
          f"(budget {final.get('budget')}, {len(frames[-1]['regrown']) if frames else 0} "
          f"regrowth renders before it); max |image - tile {TILE} image| {diff:.3g} (the "
          f"tile-{TILE} render's n_dropped {int(ref.n_dropped)})", flush=True)
    del scene, out, ref
    torch.cuda.empty_cache()
    return launches


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
QP_W, QP_H, QP_CAMS, QP_GT, QP_ITERS = 960, 540, 120, 60_000, 1000   # quality_proxy's
QP_BUDGET, QP_CAPACITY, QP_TILE = 1 << 21, 1 << 17, 16
QP_RECORD = Path(__file__).resolve().parent / "artifacts" / "qproxy_sat30" / "out"
QP_LOSS_RTOL, QP_COUNT_RTOL, QP_PSNR_TOL = 0.02, 0.01, 0.3


def _sync_cuda():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class LoopSpy:
    """Wraps the training loop's module-level functions for one CLI run and
    records what the loop did: each step's host ms (synced), loss, pair
    budget and dropped pairs; each densify (ms, n_live before and after, the
    rows it keeps, clones and splits, and the largest scales of the rows
    over the gradient threshold), capacity growth, sat probe, evaluation,
    checkpoint (s, bytes), PLY and opacity reset; the seconds of the Scene's
    set-up and of the start checkpoint's load; the Printer's lines; on the
    first densify, a host copy of its inputs (`stash`); the state after the
    last densify (`last`); train()'s wall seconds (`train_s`). `train_kw`
    goes to train() (progress_every). With `viewer`: the network GUI server
    the loop starts (`server`; its constructor holds train() until
    `hold` is set, so that a client's requests land inside the run), each
    preview it publishes (host ms, the encode's ms and bytes, and whether
    preview.png fetched over HTTP decodes to the image handed to publish),
    and each GUI request the loop serves (host ms, the model, background
    and budget it was served from, for a render apart after the run)."""

    def __init__(self, stash=False, train_kw=None, viewer=False):
        import threading

        from gsplat_tpu_torch import cli
        from gsplat_tpu_torch.train import loop

        self.loop, self.cli, self.want_stash = loop, cli, stash
        self.train_kw, self.want_viewer = dict(train_kw or {}), viewer
        self.steps, self.densify, self.grow, self.probes = [], [], [], []
        self.evals, self.ckpts, self.plys, self.lines = [], [], [], []
        self.resets, self.stash, self.last, self.result = 0, None, None, None
        self.setup = {"Scene": 0.0, "load_checkpoint": 0.0, "save_ply": 0.0, "reshard": 0.0}
        self.train_s, self.server, self.hold = 0.0, None, threading.Event()
        self.previews, self.encodes, self.gui = [], [], []

    def __enter__(self):
        from gsplat_tpu_torch.train.densify import densify_selection

        loop, spy = self.loop, self
        names = ("make_train_step", "make_spmd_train_step", "make_sharded_spmd_train_step",
                 "densify_and_prune", "grow_capacity", "_sat_probe", "evaluate",
                 "save_checkpoint", "save_ply", "reset_opacity", "Printer", "Scene",
                 "load_checkpoint", "gather_gaussians", "shard_gaussians")
        self.real = {k: getattr(loop, k) for k in names}
        self.real_train = self.cli.train
        real = self.real

        def make_train_step(*a, _builder="make_train_step", **kw):
            step = real[_builder](*a, **kw)

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
            t0 = time.perf_counter()
            spy.result = self.real_train(*a, **{**kw, **spy.train_kw})
            spy.train_s = time.perf_counter() - t0
            return spy.result

        if self.want_viewer:
            self._viewer_hooks()

        def reshard(name):      # the sharded loop's gather and shard
            def f(*a, **kw):
                _sync_cuda()
                t0 = time.perf_counter()
                out = real[name](*a, **kw)
                _sync_cuda()
                spy.setup["reshard"] += time.perf_counter() - t0
                return out
            return f

        for k, f in (("make_train_step", make_train_step),
                     ("make_spmd_train_step", functools.partial(
                         make_train_step, _builder="make_spmd_train_step")),
                     ("make_sharded_spmd_train_step", functools.partial(
                         make_train_step, _builder="make_sharded_spmd_train_step")),
                     ("gather_gaussians", reshard("gather_gaussians")),
                     ("shard_gaussians", reshard("shard_gaussians")),
                     ("densify_and_prune", densify_and_prune),
                     ("grow_capacity", grow_capacity), ("_sat_probe", _sat_probe),
                     ("evaluate", evaluate), ("save_checkpoint", save_checkpoint),
                     ("save_ply", save_ply), ("reset_opacity", reset_opacity),
                     ("Printer", Printer), ("Scene", timed_setup("Scene")),
                     ("load_checkpoint", timed_setup("load_checkpoint"))):
            setattr(loop, k, f)
        self.cli.train = train
        return self

    def _viewer_hooks(self):
        import urllib.request

        from gsplat_tpu_torch.io import png

        loop, spy = self.loop, self
        self.png = png
        self.real_viewer = (loop.NetworkGUIServer, loop._serve_gui_request, png.encode_png)
        real_server, real_serve, real_encode = self.real_viewer

        def encode_png(*a, **kw):
            t0 = time.perf_counter()
            data = real_encode(*a, **kw)
            level = kw.get("level", a[2] if len(a) > 2 else 6)
            spy.encodes.append(dict(ms=(time.perf_counter() - t0) * 1e3, bytes=len(data),
                                    level=level))
            return data

        class Server(real_server):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                spy.server = self
                spy.hold.wait(120)

            def publish(self, image):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                super().publish(image)
                ms = (time.perf_counter() - t0) * 1e3
                t1 = time.perf_counter()
                want = (torch.clamp(image, 0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
                with urllib.request.urlopen(f"{self.url}preview.png", timeout=30) as r:
                    data = r.read()
                got = png.decode_png(data)
                spy.previews.append(dict(it=spy.steps[-1]["it"], ms=ms, bytes=len(data),
                                         encode=spy.encodes[-1], equal=bool(
                                             got.shape == want.shape and (got == want).all()),
                                         check_s=time.perf_counter() - t1, image=want))

        def serve(viewer, req, g, bg, mesh, pair_budget):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_serve(viewer, req, g, bg, mesh, pair_budget)
            ms = (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            snap = None
            if req.world_view is not None:     # for the render apart, after the run
                snap = g.replace(**{k: v.clone() for k, v in vars(g).items()
                                    if isinstance(v, torch.Tensor)})
            spy.gui.append(dict(req=req, it=len(spy.steps) + 1, ms=ms, g=snap, bg=bg.clone(),
                                budget=pair_budget, tile=mesh.tile_size, chunk=mesh.chunk_size,
                                check_s=time.perf_counter() - t1))

        loop.NetworkGUIServer, loop._serve_gui_request, png.encode_png = (Server, serve,
                                                                           encode_png)

    def __exit__(self, *exc):
        for k, f in self.real.items():
            setattr(self.loop, k, f)
        self.cli.train = self.real_train
        if self.want_viewer:
            (self.loop.NetworkGUIServer, self.loop._serve_gui_request,
             self.png.encode_png) = self.real_viewer

    def step_ms(self):
        ms = [st["ms"] for st in self.steps]
        return statistics.median(ms), min(ms), max(ms)

    def wall_split(self, wall, extra=None):
        """The run's wall seconds by part, largest first, the rest (parsing,
        logging, the camera picks, the budget reads, cfg_args, cameras.json,
        metrics and TB records) by difference -> printable text. `extra`:
        more parts measured outside the spy."""
        parts = {"steps": sum(st["ms"] for st in self.steps) / 1e3,
                 "densify": sum(d["ms"] for d in self.densify) / 1e3,
                 "sat probes": sum(p["ms"] for p in self.probes) / 1e3,
                 "evaluation": sum(e["ms"] for e in self.evals) / 1e3,
                 "checkpoint saves": sum(c["s"] for c in self.ckpts),
                 "PLY saves": self.setup["save_ply"],
                 "Scene set-up": self.setup["Scene"],
                 "start checkpoint load": self.setup["load_checkpoint"]}
        if self.setup["reshard"]:
            parts["gather and reshard (mesh)"] = self.setup["reshard"]
        if self.want_viewer:
            parts.update({
                "preview publishes": sum(v["ms"] for v in self.previews) / 1e3,
                "preview fetches (the check)": sum(v["check_s"] for v in self.previews),
                "GUI requests served": sum(v["ms"] for v in self.gui) / 1e3,
                "GUI snapshots (the check)": sum(v["check_s"] for v in self.gui)})
        parts.update(extra or {})
        parts["the rest"] = wall - sum(parts.values())
        return ", ".join(f"{k} {v:.3f} s ({v / wall:.1%})"
                         for k, v in sorted(parts.items(), key=lambda kv: -kv[1]))


def run_train_cli(s, label, argv, counts, stash=False, during=None, **spy_kw):
    """cli.main(argv) in process, the launch counts from zero -> (LoopSpy,
    launches, wall seconds). `during(spy)`, if given, starts beside the run
    (a client thread)."""
    from gsplat_tpu_torch import cli

    for f in counts.values():
        f.launches = 0
    t0 = time.perf_counter()
    with LoopSpy(stash, **spy_kw) as spy:
        if during is not None:
            during(spy)
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


def loop_kernel_checks(s, label, g, cam, target, budgets, tile=TILE, size=None,
                       kept=None, sat_inputs=None, project=True):
    """K1-K6 and segment_sum against their plain versions on a state of the
    loop, at its tile size and frame size: K1 at each of `budgets` (the
    last with the kept budget `kept`, if given), K2-K4 and segment_sum at
    the last and `kept`, K5 and K6 in one _sat_probe's inputs (or those of
    a render at `sat_inputs`: pair, kept and sat budgets), and with
    `project` the projection's kernels (project_check, the state's own SH
    degree) -> ({kernel: max |err|}, K1's live slots at each budget, the
    pairs whose gid is a live row at or above 2^20)."""
    errs = {}
    if project:
        errs["project_fwd"], errs["project_bwd"] = project_check(
            s, f"{label} (SH degree {g.active_sh_degree})", g, cam, seed=5)
    totals = []
    S = budgets[-1]
    for B in budgets:
        k = kept if kept is not None and B == S else B
        _, total, _, err = expand_check(s, f"{label} K1 at budget {B}" + (
            f", kept {k}" if k != B else ""), g, cam, B, k, size, tile)
        totals.append(int(total))
        errs["expand_pairs"] = max(errs.get("expand_pairs", 0.0), float(err))
    k = S if kept is None else kept
    res = composite_check(s, label, g, cam, S, k, tile, size)
    gid = res[1]
    high = int(((gid >= (1 << 20)) & (gid < g.capacity)).sum())    # the null gid is capacity
    errs["composite_fwd"] = res[-1]
    del res, gid
    k3, d = phase_backward(s, label, g, cam, target, S, k, tile, size)
    errs["composite_bwd"] = k3["max_abs_err"]
    errs["segment_ends"] = phase_ends(s, label, d, g.capacity)["max_abs_err"]
    errs["segment_sum"] = phase_reduce(s, label, d, g.capacity + 1)["max_abs_err"]
    del d
    sat_pairs, sat_kept, sat = sat_inputs or (S, None, S)    # what _sat_probe renders
    seen, b = sat_kernel_inputs(g, cam, sat_pairs, sat_kept, sat, tile, size)
    del b
    k5, C = phase_scan(s, label, seen)
    errs["prefix_sum_small"] = k5["max_abs_err"]
    errs["compact_runs"] = phase_compact(s, label, seen, C, sat)["max_abs_err"]
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
    # --quiet: no live viewer (the "train cli with the viewer" phase runs
    # the same training with it and must end on the same bits)
    argv = ["-s", str(src), *TRAIN_FLAGS, "--quiet",
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


# ---- the live viewer and the eval tools (network_gui.py, viewer.py,
# full_eval.py, metrics_cli.py, lpips.py, tools/) ----

# the viewer serve phase's requests: (label, yaw degrees, width, height,
# scaling_modifier); a window that is no multiple of the tile, and the
# handshake that asks for no image
VIEWER_VIEWS = (("1920x1080", 0.0, W, H, 1.0), ("1920x1080", 2.0, W, H, 1.0),
                ("1920x1080", -3.0, W, H, 1.0), ("1920x1080 scaling 0.5", 0.0, W, H, 0.5),
                ("1237x691", 5.0, 1237, 691, 1.0), ("no image", 0.0, 0, 0, 1.0))
VIEWER_ROUNDS = 3
VIEWER_VERIFY = "chip-smoke-viewer"
PREVIEW_SHARE_MAX = 0.02     # a preview's publish, of the steps and the publish between two
VIEWER_PROGRESS_EVERY = 10   # this phase's progress_every: previews at 10, 20, 30, 40
DEFAULT_PROGRESS_EVERY = 100  # train()'s default, where the share is held
FE_ITERS = 20                # full_eval's training iterations from start.npz
FE_CROP = 512                # the CPU's LPIPS runs on a 512x512 crop of each pair
METRIC_RTOL, LPIPS_RTOL = 1e-5, 1e-4


MIP_ITERS = 20


def phase_mip(s, tmp, counts):
    """The train CLI with --mip_splatting over render_cli's COLMAP source,
    from the train cli phase's start checkpoint (densify at 5 and 15): the
    3D filter at the start and after each densify, every step's projection
    the Mip variant; then the Mip model's kernels against their plain
    versions on the final state (project_check; filter3d bit for bit, its
    validity too, over the final centres) and render_cli over the saved model (its PLY's filter: every
    render the Mip variant) -> launches."""
    from gsplat_tpu_torch import render_cli
    from gsplat_tpu_torch.render import filter3d as FL
    from gsplat_tpu_torch.render import project as P

    s.phase("train cli mip (sparse, full width)")
    src, tmp = Path(tmp) / "cli_source", Path(tmp)
    model = tmp / "train_mip"
    argv = ["-s", str(src), "--resolution", "1", "--eval", "--iterations", str(MIP_ITERS),
            "--densify_from_iter", "4", "--densification_interval", "5",
            "--densify_until_iter", "16", "--opacity_reset_interval", "30",
            "--densify_grad_threshold", str(TRAIN_GRAD_THRESHOLD), "--quiet",
            "--mip_splatting", "-m", str(model), "--start_checkpoint", str(tmp / "start.npz")]
    spy, launches, wall = run_train_cli(s, "train cli mip", argv, counts)
    g_end, scene_end = spy.result
    n_densify = len(spy.densify)
    s.check(launches["filter3d"] == 1 + n_densify and n_densify == 3
            and launches["project_fwd mip"] == launches["project_fwd"] == len(spy.steps)
            and launches["project_bwd mip"] == launches["project_bwd"] == len(spy.steps)
            and g_end.mip,
            f"train cli mip: {len(spy.steps)} steps in {wall:.1f} s, {n_densify} densify "
            f"passes (want 3: 5, 10, 15); launches filter3d {launches['filter3d']} (want 1 + "
            f"{n_densify}), project_fwd {launches['project_fwd']} of them Mip "
            f"{launches['project_fwd mip']}, project_bwd {launches['project_bwd']} of them Mip "
            f"{launches['project_bwd mip']} (want one each a step)")
    cams = scene_end.get_train_cameras()
    table, focal = FL.camera_table(cams, g_end.device)
    f, v = FL.filter3d(g_end.xyz, g_end.n_live.to(torch.int32), table, focal)
    fp, vp = FL.filter3d_plain(g_end.xyz, g_end.n_live.to(torch.int32), table, focal)
    torch.cuda.synchronize()
    n = int(g_end.n_live)
    s.check(torch.equal(f, fp) and torch.equal(v, vp),
            f"train cli mip: filter3d vs filter3d_plain over the final {n} live rows and "
            f"{len(cams)} cameras bit-equal {torch.equal(f, fp)}, validity equal "
            f"{torch.equal(v, vp)} ({int(v.sum())} valid); filter {float(f[:n].min()):.3g} to "
            f"{float(f[:n].max()):.3g}")
    err = [project_check(s, "train cli mip", g_end, cams[0], seed=5),
           project_check(s, "train cli mip", g_end, cams[0], seed=6, mod=GUI_MODIFIER)]
    del g_end, scene_end, spy
    torch.cuda.empty_cache()
    before = {k: f.launches for k, f in counts.items()}
    rc = render_cli.main(["--model_path", str(model), "--iteration", "-1", "--skip_train",
                          "--resolution", "1"])
    rendered = {k: f.launches - before[k] for k, f in counts.items()}
    s.check(rc == 0 and rendered["project_fwd"] > 0
            and rendered["project_fwd mip"] == rendered["project_fwd"],
            f"render_cli over the Mip model: exit {rc}, project_fwd {rendered['project_fwd']} "
            f"launches, of them Mip {rendered['project_fwd mip']} (want all)")
    # every launch of the phase (run_train_cli set the counts to zero)
    launches = {k: f.launches for k, f in counts.items()}
    print(f"  train cli mip: projection errors (fwd, bwd) {err}", flush=True)
    return launches


def viewer_message(cam_args, deg, width, height, scaling_modifier, train=True,
                   keep_alive=True):
    """A SIBR request for the bench camera turned by `deg`, at the window
    size given (the camera's fovs), as the viewer sends it."""
    from gsplat_tpu_torch.core.camera import make_camera

    R, T, fovx, fovy = yaw_camera(cam_args, deg)
    cam = make_camera(R, T, fovx, fovy, max(width, 1), max(height, 1), device="cpu")
    return {"resolution_x": width, "resolution_y": height, "train": train,
            "keep_alive": keep_alive, "fov_x": fovx, "fov_y": fovy, "z_near": 0.01,
            "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
            "scaling_modifier": scaling_modifier,
            "view_matrix": cam.world_view.reshape(-1).tolist(),
            "view_projection_matrix": cam.full_proj.reshape(-1).tolist()}


class SibrClient:
    """The SIBR remote viewer's side of the wire: [u32-LE length][JSON] out,
    [H*W*3 bytes][u32-LE length][verify] back."""

    def __init__(self, port, deadline_s=300.0):
        import socket

        t_end = time.perf_counter() + deadline_s
        while True:
            try:
                self.conn = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                if time.perf_counter() > t_end:
                    raise
                time.sleep(0.01)
        self.conn.settimeout(300)

    def _recv(self, n):
        buf = bytearray()
        while len(buf) < n:
            part = self.conn.recv(min(n - len(buf), 1 << 20))
            if not part:
                raise ConnectionError("the trainer closed the connection")
            buf += part
        return bytes(buf)

    def send(self, msg):
        import struct

        payload = json.dumps(msg).encode("utf-8")
        self.conn.sendall(struct.pack("<I", len(payload)) + payload)

    def reply(self, msg):
        import struct

        img = self._recv(msg["resolution_x"] * msg["resolution_y"] * 3) \
            if msg["resolution_x"] > 0 else b""
        (n,) = struct.unpack("<I", self._recv(4))
        return img, self._recv(n).decode("ascii")

    def round_trip(self, msg):
        """-> (image bytes, verify, round-trip ms)."""
        t0 = time.perf_counter()
        self.send(msg)
        img, verify = self.reply(msg)
        return img, verify, (time.perf_counter() - t0) * 1e3

    def close(self):
        self.conn.close()


def http_page(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.headers.get("Content-Type"), r.read()


def ms_stats(xs):
    return (f"{statistics.median(xs):.3f} (min {min(xs):.3f}, max {max(xs):.3f}, "
            f"n {len(xs)})")


def phase_viewer_serve(s, g, cam_args, tmp, counts):
    """A NetworkGUIServer on a free local port over the 1M sparse model; a
    client thread sends VIEWER_VIEWS VIEWER_ROUNDS times, the main thread
    polls and serves each through the loop's _serve_gui_request; every
    reply against image_to_bytes of a render of the same camera apart, K1
    and K2 against their plain versions at the viewer's window sizes ->
    (launches, kernel errors)."""
    import threading

    from gsplat_tpu_torch import network_gui
    from gsplat_tpu_torch.config import MeshParams
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train import loop

    s.phase("viewer serve (sparse, full width)")
    msgs = [viewer_message(cam_args, deg, w, h, sm) for _, deg, w, h, sm in VIEWER_VIEWS]
    cams = [network_gui.camera_from_request(network_gui.parse_message(m), "cuda")
            if m["resolution_x"] else None for m in msgs]
    # one pair budget for every request, as the loop has: the largest of
    # their fitted budgets with the JAX loop's 1.2x headroom
    n_pairs = [probe_view(g, c, SPARSE_BUDGET)[2] for c in cams if c is not None]
    budget = budgets.ceil_to(max(n_pairs) * budgets.KEPT_REGROW, CHUNK)
    mesh = MeshParams(tile_size=TILE, chunk_size=CHUNK, pair_budget=budget)
    bg = torch.zeros(3, device="cuda")
    root = Path(tmp) / "viewer_serve"
    root.mkdir()
    server = network_gui.NetworkGUIServer(root, "127.0.0.1", 0, verify=VIEWER_VERIFY)
    s.check(server.url is not None, f"viewer: NetworkGUIServer listening at {server.url}")
    got, errors = {}, []

    def client():
        try:
            c = SibrClient(server.port)
            for r in range(VIEWER_ROUNDS):
                for i, m in enumerate(msgs):
                    got[(r, i)] = c.round_trip(m)
            c.close()
        except Exception as e:   # reported by the checks below
            errors.append(repr(e))

    for f in counts.values():
        f.launches = 0
    t = threading.Thread(target=client, daemon=True)
    t.start()
    served, t_end = [], time.perf_counter() + 300
    while len(served) < VIEWER_ROUNDS * len(msgs) and time.perf_counter() < t_end \
            and not errors:
        req = server.poll()
        if req is None:
            time.sleep(0.0005)
            continue
        k1, k2 = counts["expand_pairs"].launches, counts["composite_fwd"].launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop._serve_gui_request(server, req, g, bg, mesh, budget)
        served.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                           k1=counts["expand_pairs"].launches - k1,
                           k2=counts["composite_fwd"].launches - k2))
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counts.items()}
    t.join(timeout=60)
    ctype, page = http_page(server.url)
    n_errors = server.render_errors
    server.close()
    s.check(not errors and not t.is_alive() and len(got) == len(served)
            == VIEWER_ROUNDS * len(msgs) and n_errors == 0,
            f"viewer: {len(served)} requests served and {len(got)} replies received "
            f"({VIEWER_ROUNDS} rounds of {len(msgs)}); client errors {errors or 'none'}; GUI "
            f"render errors {n_errors} (want 0); pair budget {budget} (fitted pairs {n_pairs})")
    s.check(ctype == "text/html" and b"gsplat-tpu" in page,
            f"viewer: an HTTP GET on the SIBR port returns the page ({ctype}, {len(page)} B)")

    # each reply against the render of its camera apart
    by_size = {}
    for i, ((label, _, w, h, sm), m, cam) in enumerate(zip(VIEWER_VIEWS, msgs, cams)):
        rows = by_size.setdefault(label, dict(rtt=[], server=[], socket=[], render=[],
                                              to_bytes=[], k1=[], k2=[], equal=[],
                                              verify=[], dropped=[]))
        ref, dropped = b"", 0
        if cam is not None:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = render(cam, g, bg, tile_size=TILE, chunk=CHUNK, pair_budget=budget,
                         scaling_modifier=sm)
            e1.record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = network_gui.image_to_bytes(out.image)
            rows["to_bytes"].append((time.perf_counter() - t0) * 1e3)
            dropped = int(out.n_dropped)
            rows["render"].append(e0.elapsed_time(e1))
            del out
        for r in range(VIEWER_ROUNDS):
            img, verify, rtt = got.get((r, i), (None, None, float("nan")))
            sv = served[r * len(msgs) + i] if r * len(msgs) + i < len(served) else {}
            rows["rtt"].append(rtt)
            rows["server"].append(sv.get("ms", float("nan")))
            rows["socket"].append(rtt - sv.get("ms", float("nan")))
            rows["k1"].append(sv.get("k1"))
            rows["k2"].append(sv.get("k2"))
            rows["equal"].append(img == ref)
            rows["verify"].append(verify == VIEWER_VERIFY)
            rows["dropped"].append(dropped)
    for label, rows in by_size.items():
        s.check(all(rows["equal"]) and all(rows["verify"]) and not any(rows["dropped"]),
                f"viewer {label}: {len(rows['equal'])} replies bit-equal to image_to_bytes of "
                f"the render apart {sum(rows['equal'])}, verify string {sum(rows['verify'])}, "
                f"n_dropped {rows['dropped']}")
        split = (f"render device ms {ms_stats(rows['render'])}, image_to_bytes ms "
                 f"{ms_stats(rows['to_bytes'])}, " if rows["render"] else "")
        print(f"  viewer {label}: round trip ms {ms_stats(rows['rtt'])}; the loop's serve ms "
              f"{ms_stats(rows['server'])}; {split}socket and queue ms "
              f"{ms_stats(rows['socket'])}; K1, K2 launches a request {rows['k1']}, "
              f"{rows['k2']}", flush=True)
    # K1 and K2 at the viewer's window sizes, the odd one included
    errs = {"expand_pairs": 0.0, "composite_fwd": 0.0}
    for cam in (cams[0], cams[4]):
        size = (cam.width, cam.height)
        label = f"viewer {cam.width}x{cam.height}"
        err = float(expand_check(s, label, g, cam, budget, budget, size)[-1])
        errs["expand_pairs"] = max(errs["expand_pairs"], err)
        err = float(composite_check(s, label, g, cam, budget, budget, TILE, size)[-1])
        errs["composite_fwd"] = max(errs["composite_fwd"], err)
    torch.cuda.empty_cache()
    return launches, errs


def phase_train_viewer(s, cam_args, tmp, counts):
    """The train cli phase's run from start.npz without --quiet: the live
    viewer on a free port, previews every VIEWER_PROGRESS_EVERY iterations,
    a SIBR client rendering, pausing and resuming training -> launches."""
    import threading

    from gsplat_tpu_torch import network_gui
    from gsplat_tpu_torch.io import png
    from gsplat_tpu_torch.render.render import render

    s.phase("train cli with the viewer (sparse, full width)")
    tmp = Path(tmp)
    src, out = tmp / "cli_source", tmp / "train_viewer"
    # --port 0: the server takes a free port, and the client reads it there
    argv = ["-s", str(src), *TRAIN_FLAGS, "--densify_grad_threshold", str(TRAIN_GRAD_THRESHOLD),
            "-m", str(out), "--start_checkpoint", str(tmp / "start.npz"),
            "--ip", "127.0.0.1", "--port", "0"]
    bench = viewer_message(cam_args, 0.0, W, H, 1.0)
    script = [("render", bench), ("render", viewer_message(cam_args, 2.0, 1237, 691, 0.5)),
              ("pause", dict(bench, train=False)),
              ("paused", viewer_message(cam_args, -3.0, W, H, 1.0, train=False)),
              ("paused", dict(viewer_message(cam_args, 0.0, 0, 0, 1.0), train=False)),
              ("resume", dict(bench, keep_alive=False))]
    log, errors = [], []

    def client(spy):
        try:
            t_end = time.perf_counter() + 300
            while spy.server is None and time.perf_counter() < t_end:
                time.sleep(0.01)
            c = SibrClient(spy.server.port)
            for i, (kind, m) in enumerate(script):
                if kind == "paused":
                    time.sleep(0.2)
                if i == 1:      # the rest at a model trained some steps
                    t_end = time.perf_counter() + 300
                    while len(spy.steps) < 10 and time.perf_counter() < t_end:
                        time.sleep(0.005)
                t0 = time.perf_counter()
                c.send(m)
                if i == 0:          # the loop starts once the first request is out
                    spy.hold.set()
                img, verify = c.reply(m)
                rtt = (time.perf_counter() - t0) * 1e3
                log.append(dict(kind=kind, img=img, verify=verify, rtt=rtt, at=time.perf_counter(),
                                steps=len(spy.steps)))
            c.close()
        except Exception as e:   # reported by the checks below
            errors.append(repr(e))
        finally:
            spy.hold.set()

    threads = []

    def during(spy):
        threads.append(threading.Thread(target=client, args=(spy,), daemon=True))
        threads[0].start()

    spy, launches, wall = run_train_cli(
        s, "train cli with the viewer", argv, counts, during=during,
        train_kw=dict(progress_every=VIEWER_PROGRESS_EVERY), viewer=True)
    threads[0].join(timeout=60)
    paused_s = (log[-1]["at"] - log[2]["at"]) if len(log) == len(script) else 0.0
    s.check(not errors and len(log) == len(script) and spy.server is not None
            and spy.server.render_errors == 0
            and all(e["verify"] == str(src) for e in log),
            f"train cli with the viewer: {len(log)} of {len(script)} round trips; client errors "
            f"{errors or 'none'}; GUI render errors "
            f"{None if spy.server is None else spy.server.render_errors} (want 0); verify "
            f"strings {sorted({e['verify'] for e in log})}")
    paused = [e["steps"] for e in log if e["kind"] in ("pause", "paused")]
    s.check(len(set(paused)) == 1 and paused[0] < TRAIN_ITERS and len(spy.steps) == TRAIN_ITERS,
            f"train cli with the viewer: steps at the paused replies {paused} (want one value "
            f"below {TRAIN_ITERS}: no step while paused, {paused_s:.2f} s), {len(spy.steps)} "
            f"steps in all")
    # each image reply against the render, apart, of the model it was served from
    # (at the loop's pair budget of that iteration, as the reference renders
    # them: before the loop's first regrowth the bench view truncates)
    bad, dropped = [], []
    for v, e in zip([v for v in spy.gui if v["g"] is not None],
                    [e for e in log if e["img"]]):
        req = v["req"]
        o = render(network_gui.camera_from_request(req, "cuda"), v["g"], v["bg"],
                   tile_size=v["tile"], chunk=v["chunk"], pair_budget=v["budget"],
                   scaling_modifier=req.scaling_modifier)
        dropped.append((v["it"], v["budget"], int(o.n_dropped)))
        if not e["img"] == req._image == network_gui.image_to_bytes(o.image):
            bad.append((v["it"], req.width, req.height))
    n_img = sum(1 for v in spy.gui if v["g"] is not None)
    s.check(n_img == sum(1 for e in log if e["img"]) == 5 and not bad,
            f"train cli with the viewer: {n_img} image replies (at iterations "
            f"{[v['it'] for v in spy.gui]}) bit-equal to the render apart of the model served; "
            f"differing {bad or 'none'}; (iteration, pair budget, n_dropped) {dropped}")
    for v in spy.gui:
        v.pop("g")
    pv = spy.previews
    s.check(len(pv) >= 2 and all(v["equal"] for v in pv),
            f"train cli with the viewer: {len(pv)} previews at iterations {[v['it'] for v in pv]} "
            f"fetched over HTTP, each decoding to the image handed to publish: "
            f"{[v['equal'] for v in pv]}")
    ply = f"point_cloud/iteration_{TRAIN_ITERS}/point_cloud.ply"
    same = (out / ply).read_bytes() == (tmp / "train_straight" / ply).read_bytes()
    s.check(same, f"train cli with the viewer: final PLY byte-equal to the train cli phase's "
            f"run without the viewer: {same}")
    # the preview's cost against the steps it comes between: one publish
    # (the host copy, the encode and the file) a progress_every steps
    pub_ms = statistics.median([v["ms"] for v in pv]) if pv else float("inf")
    enc_ms = statistics.median([v["encode"]["ms"] for v in pv]) if pv else float("inf")
    step_ms = spy.step_ms()[0]
    share = {every: pub_ms / (pub_ms + every * step_ms)
             for every in (VIEWER_PROGRESS_EVERY, DEFAULT_PROGRESS_EVERY)}
    s.check(share[DEFAULT_PROGRESS_EVERY] < PREVIEW_SHARE_MAX,
            f"train cli with the viewer: a preview's publish {pub_ms:.2f} ms median (its PNG "
            f"encode {enc_ms:.2f} ms) against {step_ms:.2f} ms a step (median, synced): "
            f"{share[DEFAULT_PROGRESS_EVERY]:.2%} of the step time at train()'s default "
            f"progress_every {DEFAULT_PROGRESS_EVERY} (want < {PREVIEW_SHARE_MAX:.0%}), "
            f"{share[VIEWER_PROGRESS_EVERY]:.2%} at this run's {VIEWER_PROGRESS_EVERY}")
    for v in pv:
        print(f"  preview at {v['it']}: publish {v['ms']:.1f} ms (of it the PNG encode "
              f"{v['encode']['ms']:.1f} ms at zlib level {v['encode']['level']}, "
              f"{v['bytes'] / 1e6:.2f} MB)")
    if pv:
        for level in (1, 6):
            t0 = time.perf_counter()
            n = len(png.encode_png(pv[0]["image"], level=level))
            print(f"  the first preview at zlib level {level}: "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms, {n / 1e6:.2f} MB")
    for e in log:
        print(f"  viewer client {e['kind']}: {e['rtt']:.1f} ms round trip, steps {e['steps']}")
    print("  the loop's GUI serves (ms): " + ", ".join(
        f"{v['req'].width}x{v['req'].height} at {v['it']} {v['ms']:.1f}" for v in spy.gui))
    print(f"  train cli with the viewer wall: "
          f"{spy.wall_split(wall, {'paused by the viewer': paused_s})}", flush=True)
    del spy
    torch.cuda.empty_cache()
    return launches


def write_lpips_weights(root, seed=7):
    """Random VGG16-shaped LPIPS weights (tests/test_lpips.py's shapes and
    scales) as the two .npz files metrics_cli reads -> (vgg path, lin path)."""
    from gsplat_tpu_torch.lpips import TAP_CHANNELS

    rng = np.random.default_rng(seed)
    out_ch = {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256, 17: 512, 19: 512,
              21: 512, 24: 512, 26: 512, 28: 512}
    vgg, in_ch = {}, 3
    for i in sorted(out_ch):
        vgg[f"features.{i}.weight"] = rng.normal(0, 0.08, (out_ch[i], in_ch, 3, 3)).astype(
            np.float32)
        vgg[f"features.{i}.bias"] = rng.normal(0, 0.02, (out_ch[i],)).astype(np.float32)
        in_ch = out_ch[i]
    lin = {f"lin{k}.model.1.weight": rng.uniform(0, 0.1, (1, ch, 1, 1)).astype(np.float32)
           for k, ch in enumerate(TAP_CHANNELS)}
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    np.savez(root / "vgg16.npz", **vgg)
    np.savez(root / "lin.npz", **lin)
    return root / "vgg16.npz", root / "lin.npz"


def lpips_flops(width, height):
    """The multiply-adds of LPIPS's 13 convolutions on two images, times 2
    (VGG16's channels; each 2x2 pool in floor mode)."""
    from gsplat_tpu_torch.lpips import TAP_CHANNELS, VGG16_SLICES

    macs, c_in, w, h = 0, 3, width, height
    for si, (sl, c) in enumerate(zip(VGG16_SLICES, TAP_CHANNELS)):
        if si > 0:
            w, h = w // 2, h // 2
        for _ in sl:
            macs += c_in * c * 9 * w * h
            c_in = c
    return 2 * 2 * macs


class StageClock:
    """Wraps a module's functions for a context: per name, a list of host
    seconds of each call (synced)."""

    def __init__(self, module, names):
        self.mod, self.names, self.s = module, names, {n: [] for n in names}

    def __enter__(self):
        self.real = {n: getattr(self.mod, n) for n in self.names}
        for n in self.names:
            def timed(*a, _n=n, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = self.real[_n](*a, **kw)
                torch.cuda.synchronize()
                self.s[_n].append(time.perf_counter() - t0)
                return out
            setattr(self.mod, n, timed)
        return self

    def __exit__(self, *exc):
        for n, f in self.real.items():
            setattr(self.mod, n, f)

    def total(self, name):
        return sum(self.s[name])


def phase_full_eval(s, tmp, counts):
    """python -m gsplat_tpu_torch.full_eval over render_cli's COLMAP source:
    train FE_ITERS iterations from start.npz at --resolution 1 with the sat
    probe, render the sets, score them with random LPIPS weights; the
    metrics against the CPU's; the kernels on the final state ->
    (launches, kernel errors)."""
    from gsplat_tpu_torch import cli, full_eval, metrics_cli, render_cli
    from gsplat_tpu_torch.io import png
    from gsplat_tpu_torch.lpips import load_lpips_weights, lpips, lpips_to_device

    s.phase("full_eval (sparse, full width)")
    tmp = Path(tmp)
    src, out = tmp / "cli_source", tmp / "full_eval"
    vgg, lin = write_lpips_weights(Path(__file__).resolve().parent / "build" / "lpips_random")
    argv = ["--scenes", str(src), "-o", str(out), "--lpips_vgg", str(vgg), "--lpips_lin",
            str(lin), "--start_checkpoint", str(tmp / "start.npz"), "--resolution", "1",
            "--iterations", str(FE_ITERS), "--sat_probe_interval", "10"]
    for f in counts.values():
        f.launches = 0
    t0 = time.perf_counter()
    with LoopSpy() as spy, CliTimer(render_cli) as timer, \
            StageClock(metrics_cli, ("main", "_load_dir", "ssim", "lpips")) as mclock, \
            StageClock(cli, ("main",)) as tclock, \
            StageClock(render_cli, ("main",)) as rclock:
        rc = full_eval.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counts.items()}
    need = TRAIN_KERNELS + (SAT_KERNELS if spy.probes else ())
    s.check(rc == 0 and all(launches[k] > 0 for k in need) and spy.probes,
            f"full_eval: exit {rc}; kernel launches {launches} ({len(spy.steps)} steps, "
            f"{len(spy.probes)} sat probes, {len(timer.renders)} renders)")
    key_t, key_tr = f"test/ours_{FE_ITERS}", f"train/ours_{FE_ITERS}"
    res = json.loads((out / "full_eval.json").read_text()).get(src.name, {}) \
        if (out / "full_eval.json").exists() else {}
    finite = all(isinstance(res.get(k, {}).get(m), float) and math.isfinite(res[k][m])
                 for k in (key_t, key_tr) for m in ("PSNR", "SSIM", "L1", "LPIPS"))
    s.check(sorted(res) == [key_t, key_tr] and finite
            and [res[k]["n_images"] for k in (key_t, key_tr)] == [1, 3],
            f"full_eval.json {src.name}: {json.dumps(res)}")
    model = out / src.name
    t0 = time.perf_counter()
    cpu = metrics_cli.evaluate_model(model, None, device="cpu")
    t_cpu = time.perf_counter() - t0
    rel = {f"{k} {m}": abs(res[k][m] - cpu[k][m]) / max(abs(cpu[k][m]), 1e-30)
           for k in cpu if k in res for m in ("PSNR", "SSIM", "L1")}
    s.check(len(rel) == 6 and max(rel.values()) <= METRIC_RTOL,
            f"full_eval metrics on the card vs evaluate_model on the CPU over the same PNGs "
            f"({t_cpu:.1f} s): largest relative difference "
            f"{max(rel, key=rel.get) if rel else '-'} "
            f"{max(rel.values()) if rel else float('nan'):.3g} (tol {METRIC_RTOL})")
    # LPIPS, card vs CPU: one 1080p pair takes tens of seconds on the CPU,
    # so both score a 512x512 crop of each pair
    params = load_lpips_weights(vgg, lin)
    on_card = lpips_to_device(params, "cuda")
    lp_rel, t0 = [], time.perf_counter()
    pairs = sorted(model.glob("*/ours_*/renders/*.png"))
    y0, x0 = (H - FE_CROP) // 2, (W - FE_CROP) // 2
    for p in pairs:
        r = png.read_png(p).astype(np.float32) / 255.0
        gt = png.read_png(p.parent.parent / "gt" / p.name).astype(np.float32) / 255.0
        rc_, gc_ = (np.ascontiguousarray(a[y0:y0 + FE_CROP, x0:x0 + FE_CROP]) for a in (r, gt))
        a = float(lpips(on_card, torch.from_numpy(rc_).cuda(), torch.from_numpy(gc_).cuda()))
        b = float(lpips(params, rc_, gc_, device="cpu"))
        lp_rel.append(abs(a - b) / max(abs(b), 1e-30))
        print(f"  LPIPS {p.parent.parent.parent.name}/{p.name} crop: card {a!r}, CPU {b!r}")
    t_lp = time.perf_counter() - t0
    s.check(len(lp_rel) == 4 and max(lp_rel) <= LPIPS_RTOL,
            f"full_eval LPIPS on the card vs the CPU on a {FE_CROP}x{FE_CROP} crop of each of "
            f"the {len(lp_rel)} pairs ({t_lp:.1f} s): relative differences "
            f"{[f'{x:.2e}' for x in lp_rel]} (tol {LPIPS_RTOL})")
    # LPIPS at 1080p on the card against its bound
    r = torch.from_numpy(png.read_png(pairs[0]).astype(np.float32) / 255.0).cuda()
    gt = torch.from_numpy(png.read_png(pairs[0].parent.parent / "gt" / pairs[0].name)
                          .astype(np.float32) / 255.0).cuda()
    lp_ms = device_ms(lambda: lpips(on_card, r, gt), 5)
    flops = lpips_flops(W, H)
    bound = flops / PEAK_FP32 * 1e3
    print(f"  LPIPS a {W}x{H} pair on the card: {lp_ms:.2f} ms (CUDA events, 5 calls); "
          f"bound {bound:.2f} ms ({flops / 1e12:.3f} TFLOP of fp32 convolutions at 67 "
          f"TFLOP/s, {bound / lp_ms:.1%} of it)", flush=True)
    del r, gt, on_card
    decode = mclock.s["_load_dir"]
    n_png = sum(res.get(k, {}).get("n_images", 0) for k in (key_t, key_tr)) * 2
    print(f"  full_eval metrics: PNG decode {sum(decode):.3f} s for {n_png} {W}x{H} PNGs "
          f"({sum(decode) / max(n_png, 1) * 1e3:.1f} ms each), SSIM "
          f"{ms_stats([x * 1e3 for x in mclock.s['ssim']])} ms, LPIPS "
          f"{ms_stats([x * 1e3 for x in mclock.s['lpips']])} ms a pair (host clock, synced)")
    frames = cli_frames(timer)
    print(f"  full_eval render_cli: {len(timer.renders)} renders, device ms "
          f"{ms_stats([x['device_ms'] for x in timer.renders])}; copy ms "
          f"{ms_stats([x['gap_ms'] for x in timer.saves])}; PNG encode ms "
          f"{ms_stats([x['ms'] for x in timer.saves])}; {len(frames)} frames")
    t_train, t_render = tclock.total("main"), rclock.total("main")
    t_metrics = mclock.total("main")
    parts = {"train (cli.main)": t_train, "render_cli": t_render, "metrics_cli": t_metrics}
    parts["the rest"] = wall - sum(parts.values())
    print("  full_eval wall {:.1f} s: ".format(wall) + ", ".join(
        f"{k} {v:.3f} s ({v / wall:.1%})" for k, v in parts.items()))
    print(f"  full_eval train wall: {spy.wall_split(spy.train_s)}")
    print(f"  full_eval render_cli wall {t_render:.3f} s: renders "
          f"{sum(x['wall_ms'] for x in timer.renders) / 1e3:.3f} s, copies and PNG encodes "
          f"{sum(x['ms'] + x['gap_ms'] for x in timer.saves) / 1e3:.3f} s, the rest (Scene "
          "set-up and the PLY load)")
    print(f"  full_eval metrics_cli wall {t_metrics:.3f} s: PNG decode "
          f"{mclock.total('_load_dir'):.3f} s, SSIM {mclock.total('ssim'):.3f} s, LPIPS "
          f"{mclock.total('lpips'):.3f} s, the rest (the weights, PSNR, L1, JSON)", flush=True)
    # at a train view: the loop's final budget is fitted to those (the bench
    # view, the test camera, has more pairs than the 2^21 it may end at)
    g_end, scene_end = spy.result
    cam = scene_end.get_train_cameras()[0]
    budgets = list(dict.fromkeys([spy.steps[0]["budget"], spy.steps[-1]["budget"]]))
    errs, totals, _ = loop_kernel_checks(s, "full_eval final state", g_end, cam, cam.image,
                                         budgets)
    print(f"  full_eval kernels held on the final state ({int(g_end.n_live)} live, "
          f"capacity {g_end.capacity}) at train view {cam.image_name}, budgets {budgets} "
          f"(K1's live slots {totals})", flush=True)
    del spy, g_end, scene_end
    torch.cuda.empty_cache()
    return launches, errs


def phase_selfcheck(s, counts):
    """python -m gsplat_tpu_torch.tools.selfcheck_train at its defaults
    (600 iterations, 256x256, 2000 ground-truth Gaussians): PASS, then
    K1-K6 and segment_sum against their plain versions on its final state at
    its tile, frame size and pair budget -> (launches, kernel errors)."""
    import contextlib
    import io

    from gsplat_tpu_torch.tools import selfcheck_train

    s.phase("selfcheck")
    for f in counts.values():
        f.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, state = selfcheck_train.run([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counts.items()}
    lines = buf.getvalue().strip().splitlines()
    for ln in lines:
        if "PSNR" in ln or ln.startswith("iter 600") or ln in ("PASS",) or "FAIL" in ln:
            print(f"  selfcheck: {ln}")
    s.check(rc == 0 and lines and lines[-1] == "PASS"
            and all(launches[k] >= 600 for k in TRAIN_KERNELS),
            f"selfcheck_train at its defaults: exit {rc}, last line {lines[-1:]} (want PASS), "
            f"{wall:.1f} s wall; kernel launches {launches}")
    # the final state on the run's first view, at the run's tile, chunk,
    # frame size and pair budget
    g, cam, mesh = state["g"], state["cams"][0], state["mesh"]
    s.check(mesh.chunk_size == CHUNK,
            f"selfcheck chunk {mesh.chunk_size}: the kernel checks run at chunk {CHUNK}")
    errs, totals, _ = loop_kernel_checks(s, f"selfcheck tile {mesh.tile_size}", g, cam,
                                         cam.image, [mesh.pair_budget], mesh.tile_size,
                                         (cam.width, cam.height))
    print(f"  selfcheck kernels held at tile {mesh.tile_size}, {cam.width}x{cam.height}, "
          f"capacity {g.capacity} ({int(g.n_live)} live), pair budget {mesh.pair_budget} "
          f"(K1's live slots {totals})", flush=True)
    del g, cam, state
    torch.cuda.empty_cache()
    return launches, errs


def record_at(records, step, key):
    return next(r[key] for r in records if r["step"] == step and key in r)


def phase_train_quality(s, tmp, counts):
    """scripts/quality_proxy.py --iters 1000 with the port: the repo's
    120-camera textured synthetic scene at 960x540, tile 16, held to the
    JAX package's record of the same run -> (launches, kernel errors)."""
    from gsplat_tpu_torch.tools import quality_proxy

    s.phase("train quality (1k, tile 16)")
    root = Path(tmp) / "qproxy"
    part = quality_proxy.make_scene(root / "scene", device="cuda")
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



# ---------------------------------------------------------------- the mesh phases
#
# Each rank is a subprocess of this script (`chip_smoke.py --mesh-rank <job>
# <rank> <world> <port>`, started by gsplat_tpu_torch.dist.launch.run_ranks,
# which kills every rank when one fails or the time runs out). The parent
# writes the job (a JSON file), each rank prints its check lines and, last,
# one "MESHRESULT {...}" line; a rank with a failed check exits 1.

MESH_VIEWS = (0.0, 2.0)      # the 2x2 mesh's camera batch: the bench view, yaw +2
MESH_STEPS = 3               # steps of each mesh step kind from the same state
MESH_TIMEOUT = 300           # seconds the ranks of one mesh phase may run
MESH_LOSS_RTOL = 1e-5        # mesh step 1 vs the single-device batch reference
MESH_GRAD_RTOL = 2e-4        # each gradient group, of that group's max
MESH_CLI_ITERS = 20
MESH_CLI_FLAGS = ["--resolution", "1", "--eval", "--iterations", str(MESH_CLI_ITERS),
                  "--densify_from_iter", "14", "--densification_interval", "15",
                  "--densify_until_iter", "19", "--sat_probe_interval", "10",
                  "--test_iterations", str(MESH_CLI_ITERS), "--quiet",
                  "--densify_grad_threshold", str(TRAIN_GRAD_THRESHOLD)]
MESH_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "max_radii2D",
             "xyz_gradient_accum", "denom")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def state_bytes(g, opt_state):
    leaves = [getattr(g, k) for k in MESH_KEYS] + list(opt_state.mu.values()) + list(
        opt_state.nu.values())
    return sum(x.numel() * x.element_size() for x in leaves)


def finite_state(g, opt_state):
    return all(bool(torch.isfinite(getattr(g, k)).all()) for k in MESH_KEYS) and all(
        bool(torch.isfinite(v).all()) for v in list(opt_state.mu.values())
        + list(opt_state.nu.values()))


def same_state(a, b):
    """(g, opt_state, loss, ...) outputs of two steps -> names that differ
    in bits (loss, each leaf, each moment)."""
    bad = [] if torch.equal(a[2], b[2]) else ["loss"]
    bad += [k for k in MESH_KEYS if not torch.equal(getattr(a[0], k), getattr(b[0], k))]
    bad += [f"mu_{k}" for k in a[1].mu if not torch.equal(a[1].mu[k], b[1].mu[k])]
    bad += [f"nu_{k}" for k in a[1].nu if not torch.equal(a[1].nu[k], b[1].nu[k])]
    return bad


def mesh_cameras(job, dev):
    from gsplat_tpu_torch.core.camera import make_camera

    target = np.load(job["target"])
    cams = []
    for deg in job["views"]:
        R, T, fovx, fovy = yaw_camera([np.asarray(x) if isinstance(x, list) else x
                                       for x in job["cam_args"]], deg)
        cams.append(make_camera(R, T, fovx, fovy, job["W"], job["H"], image=target,
                                device=dev))
    return cams


class SyncedStages:
    """on_stage hook of the mesh steps: the host clock after a device sync
    at each stage (the gloo collectives run on the host)."""

    def __init__(self, dev):
        self.dev, self.t = dev, [("start", time.perf_counter())]

    def __call__(self, name):
        _sync(self.dev)
        self.t.append((name, time.perf_counter()))

    def ms(self):
        out = {}
        for (_, a), (name, b) in zip(self.t, self.t[1:]):
            out[name] = out.get(name, 0.0) + (b - a) * 1e3
        return out


def band_kernel_checks(s, label, g, cam, target, job, y0, band_h, lead):
    """K1-K6 and segment_sum against their plain versions at a band's shapes:
    the means shifted by (0, y0) and the full frame's depth bits in the sort
    key, as render(region=...) bins a band, a frame of band_h rows, the
    band's rows of the target (zero past the image), and the sorted pairs
    led by `lead` (the kept pairs of the bands above, as the mesh step
    gathered them) modulo the chunk inert slots, as band_lead lays them."""
    from gsplat_tpu_torch.render import binning, project

    real, real_ds = project.project_gaussians, binning.depth_shift
    real_bin = binning.bin_gaussians

    def led(*a, **kw):
        kw.setdefault("lead", lambda kept: torch.tensor(lead, device=g.device))
        return real_bin(*a, **kw)

    shift = torch.tensor([0.0, float(y0)], device=g.device)
    tw, th = binning.tile_grid(job["W"], job["H"], TILE)

    def shifted(*a, **kw):
        p = real(*a, **kw)
        return p._replace(mean2d=p.mean2d - shift)

    band = torch.zeros((band_h, job["W"], 3), device=g.device)
    rows = target[y0:y0 + band_h]
    band[:rows.shape[0]] = rows
    project.project_gaussians, binning.bin_gaussians = shifted, led
    binning.depth_shift = lambda n: real_ds(max(n, tw * th))
    try:
        errs, totals, _ = loop_kernel_checks(s, label, g, cam, band, [job["pair"]], TILE,
                                             (job["W"], band_h), project=False)
    finally:
        project.project_gaussians, binning.depth_shift = real, real_ds
        binning.bin_gaussians = real_bin
    print(f"  {label}: kernels held at rows {y0}..{y0 + band_h} of camera "
          f"{job['W']}x{job['H']}, budget {job['pair']}, led by {lead} % {CHUNK} = "
          f"{lead % CHUNK} inert slots (K1's live slots {totals})", flush=True)
    return errs


def mesh_steps_rank(s, job, rank, dev):
    """One rank of the mesh step phases: the replicated and the sharded step
    (and, on a 1x1 mesh, make_train_step) from the start checkpoint, on the
    camera batch of job["views"] -> the rank's results."""
    import torch.distributed as dist

    from gsplat_tpu_torch import ckpt
    from gsplat_tpu_torch.config import MeshParams, OptimizationParams
    from gsplat_tpu_torch.dist import collectives, spmd
    from gsplat_tpu_torch.dist.data import (global_camera_batch, replicate_gaussians,
                                            shard_gaussians)
    from gsplat_tpu_torch.dist.mesh import backend_banner, make_mesh
    from gsplat_tpu_torch.dist.spmd import (_band_height, make_sharded_spmd_train_step,
                                            make_spmd_eval_step, make_spmd_train_step)
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loop import eval_step, make_train_step

    data, tile = job["data"], job["tile"]
    mesh = make_mesh(data, tile)
    W_, H_ = job["W"], job["H"]
    res = dict(rank=rank, d=mesh.d, t=mesh.t, backend=dist.get_backend(),
               banner=backend_banner())
    t0 = time.perf_counter()
    g0, opt0, _ = ckpt.load_checkpoint(job["start"], 1 << 17, device=dev)
    cams = mesh_cameras(job, dev)[:data]
    _sync(dev)
    res["load_s"] = time.perf_counter() - t0
    mp = MeshParams(tile_size=TILE, chunk_size=CHUNK, pair_budget=job["pair"])
    opt = OptimizationParams()
    bg = torch.zeros(3, device=dev)
    budgets = dict(pair_budget=job["pair"], kept_budget=job["kept"],
                   contrib_budget=job["contrib"])
    batch = global_camera_batch(mesh, cams)
    zero = torch.zeros((), device=dev)
    counts = kernel_counts()
    band_h = _band_height(H_, tile, TILE)
    res["band"] = [mesh.t * band_h, band_h]

    def timed(fn, *a, **kw):
        _sync(dev)
        t = time.perf_counter()
        out = fn(*a, **kw)
        _sync(dev)
        return out, (time.perf_counter() - t) * 1e3

    step_rep = make_spmd_train_step(mesh, opt, mp, 1.0, W_, H_, **budgets)
    step_sha = make_sharded_spmd_train_step(mesh, opt, mp, 1.0, W_, H_, **budgets)
    evaluate = make_spmd_eval_step(mesh, mp, opt.lambda_dssim, W_, H_,
                                   pair_budget=job["pair"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the lead each band render of the step took (the band checks bin with
    # replicated step 1's)
    leads, real_lead = [], spmd._band_lead

    def recording_lead(m):
        fn = real_lead(m)

        def lead(kept):
            out = fn(kept)
            leads.append(out)          # read after the step: no sync inside it
            return out

        return lead

    spmd._band_lead = recording_lead

    # ---- the main path: counts from zero, read after the last step ----
    for f in counts.values():
        f.launches = 0
    runs = {"rep": [], "sha": []}
    grads = {"rep": {}, "sha": {}}
    stages, comm = {}, {}
    state = {"rep": (g0, opt0), "sha": shard_gaussians(mesh, g0, opt0)}
    res["state_bytes"] = {k: state_bytes(*v) for k, v in state.items()}
    for kind, step in (("rep", step_rep), ("sha", step_sha)):
        g, st = state[kind]
        ema = zero
        for i in range(1, MESH_STEPS + 1):
            kw = {"grads_out": grads[kind]} if i == 1 else {}
            if i == 2:
                kw["on_stage"] = SyncedStages(dev)
                collectives.reset_comm()
            out, ms = timed(step, g, st, batch, bg, i, ema, **kw)
            if i == 2:
                stages[kind] = kw["on_stage"].ms()
                comm[kind] = {k: dict(v) for k, v in collectives.comm.items()}
            runs[kind].append(dict(ms=ms, loss=float(out[2]), n_pairs=int(out[4]),
                                   n_dropped=int(out[5]), n_contrib=int(out[7]),
                                   n_sat=int(out[8])))
            if i == 1:
                state[kind + "1"] = out
                if kind == "rep":
                    res["lead"] = int(leads[0])
            g, st, ema = out[0], out[1], out[3]
        state[kind + "_end"] = (g, st)
    spmd._band_lead = real_lead
    if mesh.size == 1:
        ref, ms = timed(make_train_step(opt, mp, 1.0, W_, H_, **budgets), g0, opt0, cams[0],
                        bg, 1, zero)
        runs["make_train_step"] = [dict(ms=ms, loss=float(ref[2]))]
    else:
        # step 1 again, and step 1 with the saturation cull on (K5, K6)
        again_grads, sat_grads = {}, {}
        again, ms_again = timed(step_rep, g0, opt0, batch, bg, 1, zero,
                                grads_out=again_grads)
        step_sat = make_spmd_train_step(mesh, opt, mp, 1.0, W_, H_, sat_budget=job["pair"],
                                        **budgets)
        sat, ms_sat = timed(step_sat, g0, opt0, batch, bg, 1, zero, grads_out=sat_grads)
        runs["rep_again"] = [dict(ms=ms_again, loss=float(again[2]))]
        runs["sat"] = [dict(ms=ms_sat, loss=float(sat[2]), n_sat=int(sat[8]),
                            n_dropped=int(sat[5]))]
    ev, ms_eval = timed(evaluate, g0, cams[0], bg)
    _sync(dev)
    res["launches"] = {k: f.launches for k, f in counts.items()}
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    res.update(runs=runs, stages=stages, comm=comm, eval_ms=ms_eval)
    # ---- the checks ----
    tag = f"rank {rank} (d {mesh.d}, t {mesh.t})"
    steps_ok = all(r["n_dropped"] == 0 for v in runs.values() for r in v if "n_dropped" in r)
    fin = all(finite_state(*state[k]) for k in ("rep_end", "sha_end"))
    s.check(steps_ok and fin and all(math.isfinite(r["loss"]) for v in runs.values()
                                     for r in v),
            f"{tag}: every step n_dropped 0 ({[r['n_dropped'] for r in runs['rep']]} "
            f"replicated, {[r['n_dropped'] for r in runs['sha']]} sharded), losses finite, "
            f"parameters and moments finite after step {MESH_STEPS} of each")
    try:
        replicate_gaussians(mesh, *state["rep_end"])
        same_ranks = True
    except RuntimeError:
        same_ranks = False
    s.check(same_ranks, f"{tag}: after {MESH_STEPS} replicated steps every rank holds the "
            "same model and Adam state, bit for bit (a checksum of every leaf)")
    full_sha = state["sha1"]
    from gsplat_tpu_torch.dist.data import gather_gaussians

    g_s, st_s = gather_gaussians(mesh, full_sha[0], full_sha[1])
    diff = same_state(state["rep1"], (g_s, st_s, full_sha[2]))
    s.check(not diff, f"{tag}: sharded step 1 (gathered) vs replicated step 1: bits differ "
            f"in {diff} (want none: both add the same gradients in one order)")
    del g_s, st_s, full_sha
    if mesh.size == 1:
        diff = same_state(ref, state["rep1"])
        s.check(not diff, f"{tag}: the 1x1 mesh's replicated step 1 vs make_train_step from "
                f"the same state over {res['backend']}: loss, parameters, Adam moments and "
                f"densification accumulators bit-equal (differ: {diff})")
        loss_e, psnr_e, nd_e = eval_step(g0, cams[0], bg, lambda_dssim=opt.lambda_dssim,
                                         tile_size=TILE, chunk=CHUNK, pair_budget=job["pair"])
        img = render(cams[0], g0, bg, tile_size=TILE, chunk=CHUNK,
                     pair_budget=job["pair"]).image
        s.check(torch.equal(ev[0], loss_e) and torch.equal(ev[1], psnr_e)
                and torch.equal(ev[2], img) and int(ev[3]) == int(nd_e) == 0,
                f"{tag}: make_spmd_eval_step vs eval_step: loss {float(ev[0])!r} vs "
                f"{float(loss_e)!r}, PSNR {float(ev[1])!r} vs {float(psnr_e)!r}, image "
                f"bit-equal {torch.equal(ev[2], img)}, n_dropped {int(ev[3])}")
    else:
        same_again = not same_state(state["rep1"], again) and all(
            torch.equal(grads["rep"][k], again_grads[k]) for k in again_grads)
        s.check(same_again, f"{tag}: replicated step 1 run twice: the same bits (loss, "
                "gradients, parameters, moments)")
        same_sat = torch.equal(sat[2], state["rep1"][2]) and all(
            torch.equal(grads["rep"][k], sat_grads[k]) for k in sat_grads)
        s.check(same_sat and runs["sat"][0]["n_sat"] > 0,
                f"{tag}: step 1 with the saturation cull (sat budget {job['pair']}, n_sat "
                f"{runs['sat'][0]['n_sat']}): loss and every gradient group bit-equal to "
                f"the step without it {same_sat}")
        del again, sat, again_grads, sat_grads
        if rank == 0:
            img = render(cams[0], g0, bg, tile_size=TILE, chunk=CHUNK,
                         pair_budget=job["pair"]).image
            err = float((ev[2] - img).abs().max())
            s.check(err <= ATOL and int(ev[3]) == 0 and ev[2].shape == img.shape,
                    f"{tag}: the eval step's gathered bands vs the full render: max |diff| "
                    f"{err:.3g} (tol {ATOL}), n_dropped {int(ev[3])}")
    # what the parent holds to its reference
    out_dir = Path(job["out"])
    if mesh.t == 0:
        torch.save({k: v.cpu() for k, v in grads["sha"].items()},
                   out_dir / f"sha_grads_d{mesh.d}.pt")
    if rank == 0:
        torch.save({k: v.cpu() for k, v in grads["rep"].items()}, out_dir / "rep_grads.pt")
    del grads, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the kernels at this rank's band: the top band (rank 0) and the last
    # band of the last camera (past the image's last row)
    if rank in job["kernel_ranks"]:
        res["kernel_errs"] = band_kernel_checks(
            s, f"mesh {data}x{tile} rank {rank}", g0, cams[mesh.d], cams[mesh.d].image, job,
            mesh.t * band_h, band_h, res["lead"])
        if dev.type == "cuda":
            # the sharded step's projection: this rank's rows of the model
            # and their live count, before its data rank's camera
            g_sh = shard_gaussians(mesh, g0, opt0)[0]
            rows = g_sh.capacity
            live = torch.clamp(g_sh.n_live - mesh.d * rows, 0, rows).to(g_sh.n_live.dtype)
            res["kernel_errs"]["project_fwd"], res["kernel_errs"]["project_bwd"] = project_check(
                s, f"mesh {data}x{tile} rank {rank} shard", g_sh.replace(n_live=live),
                cams[mesh.d], seed=rank)
            del g_sh
    return res


def mesh_cli_rank(s, job, rank, dev):
    """One rank of the train CLI on the mesh: cli.main under LoopSpy."""
    from gsplat_tpu_torch import cli

    counts = kernel_counts()
    for f in counts.values():
        f.launches = 0
    t0 = time.perf_counter()
    with LoopSpy() as spy:
        rc = cli.main(job["argv"] + ["-m", str(Path(job["out"]) / f"out{rank}"),
                                     "--process_id", str(rank)])
    _sync(dev)
    wall = time.perf_counter() - t0
    res = dict(rank=rank, rc=rc, wall=wall, launches={k: f.launches for k, f in
                                                      counts.items()},
               steps=[dict(it=st["it"], ms=st["ms"], loss=st["loss"], budget=st["budget"],
                           n_dropped=st["n_dropped"]) for st in spy.steps],
               densify=[{k: d[k] for k in ("it", "ms", "before", "after", "kinds")}
                        for d in spy.densify],
               probes=len(spy.probes), evals=len(spy.evals), lines=spy.lines,
               reshard_s=spy.setup.get("reshard", 0.0))
    if spy.steps:
        res["step_ms"] = spy.step_ms()
    res["wall_split"] = spy.wall_split(wall)
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return res


def mesh_rank(argv) -> int:
    """`chip_smoke.py --mesh-rank <job.json> <rank> <world> <port>`: one rank
    of a mesh phase."""
    job_path, rank, world, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    job = json.loads(Path(job_path).read_text())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import os

    import torch.distributed as dist

    from gsplat_tpu_torch.dist.mesh import initialize_distributed

    if job["device"] == "cpu":     # a rehearsal of the phase on the CPU
        for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
            setattr(torch.cuda, name, lambda *a, **k: None)
    s = Smoke()
    if job["task"] == "cli":       # cli.main joins the group itself (the three flags)
        dev = torch.device("cuda", 0) if job["device"] == "cuda" else torch.device("cpu")
        res = mesh_cli_rank(s, job, rank, dev)
    else:
        if world == 1:             # torchrun's environment: a world of one rank
            os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                              MASTER_PORT=str(port), LOCAL_RANK="0")
            dev = initialize_distributed(device=job["device"])
        else:
            dev = initialize_distributed(f"localhost:{port}", world, rank,
                                         device=job["device"])
        try:
            res = mesh_steps_rank(s, job, rank, dev)
        finally:
            dist.destroy_process_group()
    res["failures"] = s.failures
    print("MESHRESULT " + json.dumps(res), flush=True)
    return 1 if s.failures else 0


def launch_mesh(s, label, job, world, tmp):
    """Write the job, run its ranks -> [rank results]; every rank's lines
    printed with its rank, any nonzero exit a failed check."""
    from gsplat_tpu_torch.dist.launch import free_port, run_ranks

    path = Path(tmp) / f"{label.replace(' ', '_')}.json"
    path.write_text(json.dumps(job))
    port = free_port()
    if job["task"] == "cli":
        job["argv"] += ["--coordinator_address", f"localhost:{port}"]
        path.write_text(json.dumps(job))
    t0 = time.perf_counter()
    got = run_ranks(lambda r: [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
                               str(path), str(r), str(world), str(port)], world,
                    MESH_TIMEOUT, cwd=str(Path(__file__).resolve().parent))
    wall = time.perf_counter() - t0
    results = []
    for r, (rc, out) in enumerate(got):
        lines = out.strip().splitlines()
        for ln in lines:
            # check lines, the kernel checks' prints and errors; not the
            # parameter groups print_params writes
            if (ln.startswith("  ") and not re.match(r"^  \w+: ", ln)) or "Error" in ln:
                print(f"  [rank {r}] {ln.strip()[:400]}")
        res = next((json.loads(ln[len("MESHRESULT "):]) for ln in reversed(lines)
                    if ln.startswith("MESHRESULT ")), None)
        if res is None or rc != 0:
            print("\n".join(f"  [rank {r}] " + ln[:400] for ln in lines[-30:]))
        results.append(res)
    s.check(all(rc == 0 for rc, _ in got) and all(r is not None for r in results),
            f"{label}: {world} rank(s) exit {[rc for rc, _ in got]} (want 0 each) in "
            f"{wall:.1f} s wall")
    return results, wall


def sum_launches(results):
    names = list(kernel_counts())
    return {k: sum(r["launches"][k] for r in results if r) for k in names}


def phase_mesh_nccl(s, tmp, base):
    """mesh nccl 1x1: one rank, NCCL at world 1, on the sparse scene."""
    s.phase("mesh nccl 1x1 (sparse, full width)")
    results, wall = launch_mesh(s, "mesh nccl 1x1", dict(base, task="steps", data=1, tile=1,
                                                         kernel_ranks=[]), 1, tmp)
    (r,) = results
    if r is None:
        return {k: 0 for k in kernel_counts()}
    s.check(r["backend"] == "nccl", f"mesh 1x1 backend {r['backend']} (want nccl: one rank, "
            f"a card of its own); banner: {r['banner']}")
    print(f"  1x1: make_train_step {r['runs']['make_train_step'][0]['ms']:.1f} ms; mesh "
          f"steps (ms) replicated {[round(x['ms'], 1) for x in r['runs']['rep']]}, sharded "
          f"{[round(x['ms'], 1) for x in r['runs']['sha']]}; eval {r['eval_ms']:.1f} ms; "
          f"start load {r['load_s']:.2f} s; phase wall {wall:.1f} s", flush=True)
    for kind in ("rep", "sha"):
        st = r["stages"].get(kind, {})
        print(f"  1x1 {kind} step 2 stages (synced, ms): "
              + ", ".join(f"{k} {v:.2f}" for k, v in st.items()))
    return r["launches"]


def mesh_reference(job, dev):
    """The single-device batch reference on the card: render + photometric
    loss of each camera of the batch (the full frame, the job's budgets),
    their mean, autograd -> (loss, {group: gradient} on the host, each
    view's screen-space gradient of the mean loss)."""
    from gsplat_tpu_torch import ckpt
    from gsplat_tpu_torch.render.render import render
    from gsplat_tpu_torch.train.loss import photometric_loss

    g, _, _ = ckpt.load_checkpoint(job["start"], 1 << 17, device=dev)
    cams = mesh_cameras(job, dev)[:job["data"]]
    params = {k: v.detach().requires_grad_() for k, v in g.params().items()}
    offs = [torch.zeros((g.capacity, 2), device=dev, requires_grad=True) for _ in cams]
    bg = torch.zeros(3, device=dev)
    with torch.enable_grad():
        losses = [photometric_loss(render(c, g.replace(**params), bg, tile_size=TILE,
                                          chunk=CHUNK, pair_budget=job["pair"],
                                          kept_budget=job["kept"],
                                          contrib_budget=job["contrib"],
                                          mean2d_offset=o).image, c.image)
                  for c, o in zip(cams, offs)]
        loss = torch.stack(losses).mean()
        grads = torch.autograd.grad(loss, list(params.values()) + offs)
    out = {k: v.cpu() for k, v in zip(params, grads)}
    out["mean2d"] = torch.stack([x.cpu() for x in grads[len(params):]])
    return float(loss), out


def grad_errors(got, ref):
    """{group: max |got - ref| / max |ref|}."""
    return {k: float((got[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
            for k in ref}


def phase_mesh_2x2(s, tmp, base):
    """mesh 2x2 (gloo, 4 ranks share the card) at full width."""
    s.phase("mesh 2x2 (gloo, 4 ranks share the card; sparse, full width)")
    job = dict(base, task="steps", data=2, tile=2, kernel_ranks=[0, 3])
    dev = torch.device("cuda") if base["device"] == "cuda" else torch.device("cpu")
    t0 = time.perf_counter()
    ref_loss, ref = mesh_reference(job, dev)
    ref_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    results, wall = launch_mesh(s, "mesh 2x2", job, 4, tmp)
    if any(r is None for r in results):
        return {k: 0 for k in kernel_counts()}, {}
    r0 = results[0]
    print(f"  2x2: {r0['banner']}; reference {ref_s:.1f} s; phase wall {wall:.1f} s",
          flush=True)
    out = Path(job["out"])
    rep = torch.load(out / "rep_grads.pt")
    sha_parts = [torch.load(out / f"sha_grads_d{d}.pt") for d in range(2)]
    sha = {k: torch.cat([p[k] for p in sha_parts], dim=1 if k == "mean2d" else 0)
           for k in sha_parts[0]}
    for name, got, loss in (("replicated", rep, r0["runs"]["rep"][0]["loss"]),
                            ("sharded", sha, r0["runs"]["sha"][0]["loss"])):
        errs = grad_errors(got, ref)
        rel = abs(loss - ref_loss) / abs(ref_loss)
        s.check(rel <= MESH_LOSS_RTOL and max(errs.values()) <= MESH_GRAD_RTOL,
                f"2x2 {name} step 1 vs the single-device batch reference: loss {loss!r} vs "
                f"{ref_loss!r} (rel {rel:.2g}, tol {MESH_LOSS_RTOL}); gradients, of each "
                f"group's max: " + " ".join(f"{k} {v:.2g}" for k, v in errs.items())
                + f" (tol {MESH_GRAD_RTOL})")
    diff = grad_errors(sha, rep)
    s.check(max(diff.values()) <= MESH_GRAD_RTOL
            and r0["runs"]["sha"][0]["loss"] == r0["runs"]["rep"][0]["loss"],
            f"2x2 sharded step 1 vs replicated step 1: loss {r0['runs']['sha'][0]['loss']!r} "
            f"vs {r0['runs']['rep'][0]['loss']!r}; gradients of each group's max "
            + " ".join(f"{k} {v:.2g}" for k, v in diff.items())
            + f" (tol {MESH_GRAD_RTOL}; bit-equal: {all(v == 0 for v in diff.values())})")
    for r in results:
        sb = r["state_bytes"]
        print(f"  rank {r['rank']} (d {r['d']}, t {r['t']}, rows {r['band'][0]}.."
              f"{r['band'][0] + r['band'][1]}): steps (ms) replicated "
              f"{[round(x['ms'], 1) for x in r['runs']['rep']]}, sharded "
              f"{[round(x['ms'], 1) for x in r['runs']['sha']]}, again "
              f"{r['runs']['rep_again'][0]['ms']:.1f}, sat {r['runs']['sat'][0]['ms']:.1f}; "
              f"eval {r['eval_ms']:.1f} ms; state {sb['rep'] / 1e6:.1f} MB replicated, "
              f"{sb['sha'] / 1e6:.1f} MB sharded ({sb['sha'] / sb['rep']:.3f}); peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB; start load {r['load_s']:.2f} s", flush=True)
        for kind in ("rep", "sha"):
            st, cm = r["stages"][kind], r["comm"][kind]
            print(f"    {kind} step 2 stages (synced, ms): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in st.items())
                  + "; collectives (calls, MB): "
                  + ", ".join(f"{k} {v['calls']}, {v['bytes'] / 1e6:.2f}"
                              for k, v in cm.items()))
    s.check(all(abs(r["state_bytes"]["sha"] * 2 - r["state_bytes"]["rep"]) <= 16
                for r in results),
            "2x2: each rank's sharded state is half its replicated state: "
            + ", ".join(f"{r['state_bytes']['sha']} of {r['state_bytes']['rep']}"
                        for r in results))
    errs = {}
    for r in results:
        for k, v in r.get("kernel_errs", {}).items():
            errs[k] = max(errs.get(k, 0.0), v)
    return sum_launches(results), errs


def phase_train_cli_mesh(s, tmp, base):
    """train cli mesh (2x2): cli.main on 4 ranks from start.npz over
    render_cli's COLMAP source, replicated and with --shard_gaussians."""
    from gsplat_tpu_torch.io.ply import load_gaussian_ply

    s.phase("train cli mesh 2x2 (gloo, 4 ranks share the card; sparse, full width)")
    launches = {k: 0 for k in kernel_counts()}
    plys = {}
    for kind, extra in (("replicated", []), ("sharded", ["--shard_gaussians"])):
        out = Path(tmp) / f"cli_mesh_{kind}"
        argv = ["-s", base["source"], *MESH_CLI_FLAGS, "--start_checkpoint", base["start"],
                "--pair_budget", str(base["pair"]), "--data_device", base["device"],
                "--data_axis", "2", "--tile_axis", "2", "--num_processes", "4", *extra]
        results, wall = launch_mesh(s, f"train cli mesh {kind}", dict(
            base, task="cli", argv=argv, out=str(out)), 4, tmp)
        if any(r is None for r in results):
            continue
        r0 = results[0]
        launches = {k: launches[k] + v for k, v in sum_launches(results).items()}
        ply = out / "out0" / "point_cloud" / f"iteration_{MESH_CLI_ITERS}" / "point_cloud.ply"
        others = [r for r in range(1, 4) if (out / f"out{r}").exists()]
        after = [st for st in r0["steps"] if st["budget"] == r0["steps"][-1]["budget"]]
        s.check(all(r["rc"] == 0 for r in results) and len(r0["steps"]) == MESH_CLI_ITERS
                and all(math.isfinite(st["loss"]) for st in r0["steps"])
                and all(st["n_dropped"] == 0 for st in after) and r0["densify"]
                and r0["evals"] == 1 and ply.exists() and not others,
                f"train cli mesh {kind}: {len(r0['steps'])} steps, losses finite (first "
                f"{r0['steps'][0]['loss']:.5f}, last {r0['steps'][-1]['loss']:.5f}), "
                f"n_dropped 0 at the final budget {r0['steps'][-1]['budget']}; densify "
                f"{r0['densify']}; {r0['probes']} sat probes, {r0['evals']} eval(s) on rank "
                f"0; the final PLY written by rank 0 alone (others wrote: {others})")
        print(f"  {kind}: step ms (median, min, max) {r0.get('step_ms')}; wall {wall:.1f} s "
              f"(rank 0's run {r0['wall']:.1f} s: {r0['wall_split']}); peak "
              f"{[round(r['peak_bytes'] / 1e9, 2) for r in results]} GB", flush=True)
        for ln in r0["lines"]:
            if "SPMD" in ln or "budget" in ln or "capacity" in ln or "eval" in ln:
                print(f"    rank 0: {ln}")
        if ply.exists():
            plys[kind] = load_gaussian_ply(ply)
    if len(plys) == 2:
        a, b = plys["replicated"], plys["sharded"]
        differ = [k for k in a if not np.array_equal(a[k], b[k])]
        gap = {k: float(np.abs(np.asarray(a[k], np.float64) - b[k]).max()) for k in a
               if a[k].shape == b[k].shape}
        s.check(not differ and a["xyz"].shape == b["xyz"].shape,
                f"train cli mesh: the replicated and the sharded runs' final PLYs "
                f"({a['xyz'].shape[0]} rows each) bit-equal: fields that differ {differ}; "
                f"largest |diff| {gap}")
    return launches


def mesh_base(s, tmp, cam_args):
    """What every mesh phase reads: the start checkpoint and COLMAP source of
    the train cli phase, the sparse scene's target and bench camera, and the
    batch's budgets: the train phase's fit (train_budgets) at each view of
    MESH_VIEWS on the full frame, the largest of each."""
    from gsplat_tpu_torch import ckpt
    from gsplat_tpu_torch.core.camera import make_camera

    tmp = Path(tmp)
    g, _, _ = ckpt.load_checkpoint(tmp / "start.npz", 1 << 17, device="cuda")
    target = np.load(tmp / "mesh_target.npy")
    bg = torch.zeros(3, device=g.device)
    fits = []
    for deg in MESH_VIEWS:
        R, T, fovx, fovy = yaw_camera(cam_args, deg)
        cam = make_camera(R, T, fovx, fovy, W, H, image=target, device="cuda")
        fits.append(train_budgets(g, cam, bg, SPARSE_BUDGET))
    del g
    torch.cuda.empty_cache()
    pair, kept, contrib = (max(f[i] for f in fits) for i in range(3))
    print(f"  mesh budgets (the train phase's fit at the views {MESH_VIEWS}, the largest): "
          f"pair {pair}, kept {kept}, contrib {contrib}", flush=True)
    (tmp / "mesh").mkdir(exist_ok=True)
    R, T, fovx, fovy = cam_args
    return dict(device="cuda", W=W, H=H, start=str(tmp / "start.npz"),
                target=str(tmp / "mesh_target.npy"),
                cam_args=[np.asarray(R).tolist(), np.asarray(T).tolist(), float(fovx),
                          float(fovy)], views=list(MESH_VIEWS), pair=pair, kept=kept,
                contrib=contrib, out=str(tmp / "mesh"), source=str(tmp / "cli_source"))


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
    from gsplat_tpu_torch.tools.bench_scene import build_scene

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

    cc_v = subprocess.run([_build._cc(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    for name in _build.HOST_SOURCES:
        _build.load_host(name)
    print(f"  host libraries {list(_build.HOST_SOURCES)} built and loaded ({cc_v}, "
          f"{' '.join(_build.HOST_CFLAGS)}); the IO runtime (csrc/io_runtime.c, "
          f"jpeg_decode.c) built in " + (f"{built['io_runtime']:.2f} s" if "io_runtime" in built
                                         else "an earlier run (loaded from build/host/)"),
          flush=True)

    s.phase("oracle")
    phase_oracle(s)

    with tempfile.TemporaryDirectory() as tmp:
        s.phase("scene sparse")
        t0 = time.perf_counter()
        raw, cam_args, target = build_scene(N, W, H, target_pairs_per_gaussian=2.25,
                                            tile_size=32)
        np.save(Path(tmp) / "mesh_target.npy", target)
        sparse_cam_args = cam_args
        g = load_scene(raw, tmp, "sparse")
        del raw
        print(f"  sparse scene: {N} Gaussians, capacity {g.capacity}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        k_sparse, l_sparse, n_sparse, sparse, t_sparse, c_sparse = run_cell(
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
        l_mip = phase_mip(s, tmp, kernel_counts())
        l_jpeg = phase_jpeg(s, tmp, kernel_counts())
        l_capture = phase_capture_load(s, tmp, sparse_cam_args, kernel_counts(), card)
        l_viewer, e_viewer = phase_viewer_serve(s, g, cam_args, tmp, kernel_counts())
        l_train_viewer = phase_train_viewer(s, cam_args, tmp, kernel_counts())
        l_full_eval, e_full_eval = phase_full_eval(s, tmp, kernel_counts())
        del g, target
        torch.cuda.empty_cache()

        s.phase("scene dense")
        raw, cam_args, target = build_scene(N, W, H, target_pairs_per_gaussian=33.0,
                                            tile_size=32)
        g = load_scene(raw, tmp, "dense")
        del raw
        k_dense, l_dense, n_dense, dense, t_dense, c_dense = run_cell(
            s, "dense", g, cam_args, (0.0,), DENSE_BUDGET, target)
        got = int(dense[0]["out"].n_culled)
        s.check(abs(got - REF_DENSE_CULLED) <= 1e-3 * REF_DENSE_CULLED,
                f"dense n_culled {got} vs JAX package {REF_DENSE_CULLED}: diff "
                f"{got - REF_DENSE_CULLED:+d} "
                f"({(got - REF_DENSE_CULLED) / REF_DENSE_CULLED:+.5%}, tol 0.1%)")
        del g, target, dense
        torch.cuda.empty_cache()
        l_headline, e_headline = phase_bench(s, card, {"sparse": c_sparse, "dense": c_dense},
                                             loss1, kernel_counts())
        l_bench = phase_serving_bench(s, kernel_counts())
        l_quality, e_quality = phase_train_quality(s, tmp, kernel_counts())
        l_selfcheck, e_selfcheck = phase_selfcheck(s, kernel_counts())

        s.phase("mesh set-up")
        base = mesh_base(s, tmp, sparse_cam_args)
        l_mesh_nccl = phase_mesh_nccl(s, tmp, base)
        l_mesh, e_mesh = phase_mesh_2x2(s, tmp, base)
        l_cli_mesh = phase_train_cli_mesh(s, tmp, base)
    by_view = {"sparse": l_sparse, "dense": l_dense, "render_cli": l_cli,
               "train_cli": l_train, "train_quality": l_quality, "viewer": l_viewer,
               "train_cli_viewer": l_train_viewer, "full_eval": l_full_eval,
               "selfcheck": l_selfcheck, "mesh_nccl_1x1": l_mesh_nccl, "mesh_2x2": l_mesh,
               "train_cli_mesh_2x2": l_cli_mesh, "jpeg_cli": l_jpeg, "serving_bench": l_bench,
               "capture_cli": l_capture, "bench": l_headline, "train_cli_mip": l_mip}
    launches = {k: sum(v[k] for v in by_view.values()) for k in l_sparse}
    print(f"  main path: {n_sparse + n_dense} renders at tile {TILE} and "
          f"{2 * (2 + FRAME_REPS)} at each of tiles {WIDE_TILES}, {TRAIN_STEPS['sparse']} + "
          f"{2 * TRAIN_STEPS['dense']} train steps at tile {TILE} and 2 at each of tiles "
          f"{WIDE_TILES}; "
          f"render_cli's renders {l_cli['composite_fwd']}; the train CLI's steps and probes "
          f"(K1 {l_train['expand_pairs']}, K5 {l_train['prefix_sum_small']}) and the quality "
          f"run's (K1 {l_quality['expand_pairs']}, K5 {l_quality['prefix_sum_small']}); the "
          f"viewer's requests (K1 {l_viewer['expand_pairs']}, K2 {l_viewer['composite_fwd']}), "
          f"the train CLI with the viewer (K1 {l_train_viewer['expand_pairs']}), full_eval "
          f"(K1 {l_full_eval['expand_pairs']}, K5 {l_full_eval['prefix_sum_small']}) and the "
          f"self-check (K1 {l_selfcheck['expand_pairs']}); the mesh phases' steps, summed over "
          f"ranks (1x1 K1 {l_mesh_nccl['expand_pairs']}, 2x2 K1 {l_mesh['expand_pairs']}, "
          f"K5 {l_mesh['prefix_sum_small']}; the 2x2 train CLI K1 "
          f"{l_cli_mesh['expand_pairs']}, K5 {l_cli_mesh['prefix_sum_small']}); the packed "
          f"table's serve and step phases (K2 packed {l_sparse['composite_fwd packed']} "
          f"sparse, {l_dense['composite_fwd packed']} dense; K3 packed "
          f"{l_sparse['composite_bwd packed']}), serving_bench (K2 {l_bench['composite_fwd']}, "
          f"K2 packed {l_bench['composite_fwd packed']}), the JPEG train CLI (K1 "
          f"{l_jpeg['expand_pairs']}) and the capture's (K1 {l_capture['expand_pairs']}, K5 "
          f"{l_capture['prefix_sum_small']}); the bench phase's passes (K1 "
          f"{l_headline['expand_pairs']}, K3 {l_headline['composite_bwd']}, K5 "
          f"{l_headline['prefix_sum_small']})")
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
        if name not in k_sparse:
            # the Mip-Splatting kernels run on the train cli mip phase alone:
            # their launches are on the kernels line, their checks in that phase
            continue
        views = [("sparse", k_sparse), ("dense", k_dense)]
        if name in SAT_KERNELS:
            views.reverse()
        (view, main_cell), (other, other_cell) = views
        o = other_cell[name]
        rows.append(dict(main_cell[name], view=view,
                         launches_by_view={v: c[name] for v, c in by_view.items()},
                         max_abs_err=max(k_sparse[name]["max_abs_err"],
                                         k_dense[name]["max_abs_err"],
                                         e_train.get(name, 0.0), e_quality.get(name, 0.0),
                                         e_viewer.get(name, 0.0),
                                         e_full_eval.get(name, 0.0),
                                         e_selfcheck.get(name, 0.0),
                                         e_headline.get(name, 0.0),
                                         e_mesh.get(name, 0.0)),
                         other_view=dict(view=other, **{k: o[k] for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})))
        for tile in WIDE_TILES:
            wide = f"{name} tile {tile}"
            if wide in k_sparse:
                # the same kernel at tile 64 (pixel passes) and 128 (windows), each view
                rows[-1][f"tile_{tile}"] = {view: {k: cell[wide][k] for k in (
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2:]))
    sys.exit(main())
