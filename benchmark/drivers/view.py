"""The `view` traffic kind: closed-loop viewer frames.

A mix of this kind (`traffic/<mix>.json` with "kind": "view") names the
orbit, the request's scaling modifier, the background, the budgets
(`"budgets": "gui"`, the training loop's pair budget alone as its network
GUI renders, or `"fitted"`, kept, contrib and saturation budgets fitted over
the orbit with the mix's `slack`), the pair table (`attr_pack`: true, false,
or null for the program's default), the checked frames and the warm-up.
Each frame is parsed from the SIBR viewer's request, rendered and turned
into bytes on the host, as `train/loop.py::_serve_gui_request` does without
the socket; the next request goes out when they arrive.
"""

from __future__ import annotations

import json
import random
import statistics
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark import scene
from benchmark.harness import (Cell, Reading, StageRecorder, Window, annotate, fit_budgets,
                               load_reference, log, mean_work, params_per_splat,
                               program_camera, program_gaussians)


def orbit_message(cfg: Dict, tr: Dict, frame: int, phase: float, direction: float):
    """(yaw, the SIBR viewer's request) of a frame of the orbit."""
    yaw = scene.orbit_yaw(frame, phase, direction, tr["yaw_deg"], tr["sweep_frames"])
    m = scene.view_matrices(cfg, yaw, 0.0)
    return yaw, {"resolution_x": cfg["width"], "resolution_y": cfg["height"], "train": True,
                 "fov_x": cfg["fovx"], "fov_y": cfg["fovy"],
                 "scaling_modifier": tr["scaling_modifier"], "keep_alive": True,
                 "view_matrix": m["world_view"].reshape(-1).tolist(),
                 "view_projection_matrix": m["full_proj"].reshape(-1).tolist()}


def latency_ms(seconds: List[float]) -> Dict[str, float]:
    """frame_ms_p50 and frame_ms_p95 over every frame of the window: the
    median and the 95th percentile (statistics.quantiles' default, exclusive
    method; the largest value where there are fewer than two)."""
    p95 = statistics.quantiles(seconds, n=20)[-1] if len(seconds) > 1 else max(seconds)
    return {"frame_ms_p50": statistics.median(seconds) * 1e3, "frame_ms_p95": p95 * 1e3}


class Sample:
    """A seeded uniform sample of k frames of a stream of unknown length
    (reservoir sampling), and the slowest frame beside it. A kept frame's
    bytes are copied into buffers made before the window, so the sample
    holds none of the program's memory and allocates nothing while it
    runs; the copy follows the frame's latency reading."""

    def __init__(self, seed: int, k: int, nbytes: int):
        self.rng = random.Random(seed * 7919 + scene.SALT_SAMPLE)
        self.k, self.seen = k, 0
        self.bufs = [np.empty(nbytes, np.uint8) for _ in range(k + 1)]
        self.kept: List = []      # (frame, yaw, buffer index)
        self.slowest = None       # (latency, frame, yaw, stored)

    def _store(self, j: int, data) -> bool:
        src = np.frombuffer(data, np.uint8)
        if src.shape != self.bufs[j].shape:
            return False
        np.copyto(self.bufs[j], src)
        return True

    def offer(self, latency: float, frame: int, yaw: float, data) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            j = len(self.kept)
            self.kept.append((frame, yaw, j if self._store(j, data) else None))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = (frame, yaw, j if self._store(j, data) else None)
        if self.slowest is None or latency > self.slowest[0]:
            self.slowest = (latency, frame, yaw, self._store(self.k, data))

    def items(self) -> List:
        """(frame, yaw, bytes or None where the reply had the wrong size)."""
        out = [(f, y, None if j is None else self.bufs[j]) for f, y, j in self.kept]
        if self.slowest and self.slowest[1] not in {it[0] for it in self.kept}:
            _, f, y, ok = self.slowest
            out.append((f, y, self.bufs[self.k] if ok else None))
        return out


def frame_budgets(g, cfg: Dict, tr: Dict, phase: float, direction: float, device) -> Dict:
    """render's budget arguments for the mix's `budgets`: "gui", the pair
    budget alone; "fitted", fit_budgets over one sweep of the orbit."""
    if tr["budgets"] == "gui":
        return {"pair_budget": cfg["pair_budget"]}
    cams = [program_camera(scene.view_matrices(cfg, scene.orbit_yaw(
        f, phase, direction, tr["yaw_deg"], tr["sweep_frames"]), 0.0), cfg, device)
        for f in range(tr["sweep_frames"])]
    b = fit_budgets(g, cams, cfg, tr["slack"], device)
    return {"pair_budget": b["pair"], "kept_budget": b["kept"],
            "contrib_budget": b["contrib"], "sat_budget": b["sat"]}


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        out: Callable[[str], None]) -> Dict:
    from gsplat_tpu_torch import network_gui
    from gsplat_tpu_torch.render import render as render_mod

    cfg, tr = cell.config, cell.traffic
    w, h = cfg["width"], cfg["height"]
    g = program_gaussians(scene.build_params(cfg, seed, device), cfg, 1.0)
    bg = torch.tensor(tr["background"], dtype=torch.float32, device=device)
    phase, direction = scene.orbit_start(seed)
    rec = StageRecorder() if traced else None
    budgets = frame_budgets(g, cfg, tr, phase, direction, device)

    def frame(i: int, on_stage=None):
        """One request of the orbit -> (yaw, bytes, n_dropped, latency s)."""
        yaw, msg = orbit_message(cfg, tr, i, phase, direction)
        t = time.perf_counter()
        with annotate(traced, "bench.frame"):
            req = network_gui.parse_message(msg)
            cam = network_gui.camera_from_request(req, device)
            if on_stage:
                on_stage.begin()
            res = render_mod.render(cam, g, bg, tile_size=cfg["tile_size"],
                                    chunk=cfg["chunk"], scaling_modifier=req.scaling_modifier,
                                    attr_pack=tr["attr_pack"], on_stage=on_stage, **budgets)
            data = network_gui.image_to_bytes(res.image)
            if on_stage:
                on_stage("readback")
                on_stage.end()
        return yaw, data, res.n_dropped, time.perf_counter() - t

    out(f"bench: orbit phase {phase!r} direction {direction:+.0f}, "
        f"{tr['sweep_frames']} frames a sweep of +-{tr['yaw_deg']} deg, "
        f"budgets {json.dumps(budgets)}, attr_pack {tr['attr_pack']}")
    win = Window(seconds, traced, tr["profile_seconds"], device)
    with torch.no_grad():
        # frames for warmup_seconds, in the set-up: the shapes, the card's
        # clocks and in a traced run the profiler settle before the window
        t_warm, i = time.perf_counter(), 0
        while time.perf_counter() - t_warm < tr["warmup_seconds"]:
            i += 1
            frame(-i)
        sample = Sample(seed, tr["checked_frames"], w * h * 3)
        lat, dropped, failed = [], [], 0
        win.start()
        i = 0
        while True:
            try:
                yaw, data, nd, dt = frame(i, rec)
            except (RuntimeError, ValueError) as e:   # a frame that raises gets no image
                log(f"bench: frame {i} raised {type(e).__name__}: {e}")
                failed += 1
            else:
                lat.append(dt)
                dropped.append(nd)
                sample.offer(dt, i, yaw, data)
            i += 1
            if win.done(len(lat)):
                break
        window_s, t0 = win.elapsed(), win.t0
        dropped = torch.stack(dropped).tolist() if dropped else []
    failed += sum(1 for d in dropped if d > 0)
    out(f"bench: frames {i} in {window_s!r} s, failed {failed}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = {"attempted": i, "failed": failed, "peak": peak,
              "metrics": {"setup_s": t0 - t_start, **latency_ms(lat)}}
    stages = rec.stages() if rec else {}
    items = sample.items()
    del g, frame
    if device.type == "cuda":
        torch.cuda.empty_cache()
    p = scene.build_params(cfg, seed, device)
    if traced:
        rng = scene.host_rng(seed, scene.SALT_SAMPLE)
        frames = rng.integers(0, tr["sweep_frames"], size=tr["work_sample"])
        wk = mean_work(cfg, seed, [scene.view_matrices(
            cfg, scene.orbit_yaw(int(f), phase, direction, tr["yaw_deg"], tr["sweep_frames"]),
            0.0) for f in frames], device)
        out(f"bench: reference work a frame (mean of {len(frames)} orbit positions): "
            f"{json.dumps(wk)}")
        result["reading"] = Reading(
            stages=stages, trace=win.summary, traced_units=win.traced_units,
            unit_seconds=statistics.median(lat[:win.traced_units]), work=wk, pixels=w * h,
            live=cfg["n_gaussians"], params_per_splat=params_per_splat(cfg))
    # the reference renders the sampled frames' views; the bytes are compared
    reference = load_reference(cfg)
    reference.fp32_only()
    share, gap = [], []
    for _, yaw, data in items:
        cam = reference.camera(scene.view_matrices(cfg, yaw, 0.0), cfg["fovx"], cfg["fovy"],
                               w, h, device)
        img, _ = reference.render(p, cam, bg, n_live=cfg["n_gaussians"],
                                  sh_degree=cfg["sh_degree"], tile_size=cfg["tile_size"],
                                  chunk=cfg["chunk"])
        ref = (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy().reshape(-1)
        if data is None:                 # a reply of the wrong size
            share.append(1.0)
            gap.append(255)
            continue
        diff = np.abs(data.astype(np.int16) - ref.astype(np.int16))
        share.append(float((diff > 0).mean()))
        gap.append(int(diff.max()))
    out(f"bench: {len(items)} frames compared (frames {[it[0] for it in items]}): "
        f"mismatch shares {share}, widest gaps {gap}")
    result["checks"] = {"byte_mismatch_share": max(share), "byte_max_gap": float(max(gap)),
                        "failed_frames": float(failed)}
    return result

