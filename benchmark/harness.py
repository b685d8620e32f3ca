"""One run of one cell of BENCHMARK.json: set-up, the measured window, the
per-layer reading, the comparison with the plain reference, the result line.

Everything that belongs to one cell is found by name: the configuration's
file (named in BENCHMARK.json), the traffic mix `traffic/<mix>.json`, its
kind's driver `drivers/<kind>.py` (a module with `run`), the limits of the
comparison `checks/<cell>.json`, and each per-layer metric's reader
(`load_reader`). A metric's unit, layer, source and the metric it moves are
BENCHMARK.json's alone.

The program under test is `gsplat_tpu_torch`; the reference
(`reference.py`) imports nothing of it. Module attributes of the program that
a run calls (`loop.photometric_loss` through the train step,
`network_gui.image_to_bytes`, `render_mod.render`) are looked up at call
time, so a test can break the timed path underneath.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import fits, scene, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")
# a gradient element under this share of its leaf's largest is round-off
ROUNDOFF = 1e-6


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- the cell


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]      # BENCHMARK.json entries, each with its "reader"
    driver: object             # drivers/<kind>.py


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """The Python file at `path` as a module of its own."""
    name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench: Path = BENCH) -> Callable:
    """A per-layer metric's reader, read(Reading) -> value or None: the
    `read` of metrics/<name>.py, else of metrics/<base>.py (base: the name
    before its first dot, one reader for `.train` and `.view`), else, for
    a base `<stage>_ms`, the median of that on_stage stage."""
    base = name.split(".")[0]
    for stem in (name, base):
        path = bench / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path, "bench_metric_").read
    if base.endswith("_ms"):
        stage = base[:-len("_ms")]
        return lambda run: run.stage_median(stage)
    raise FileNotFoundError(f"no reader for {name!r}: metrics/{name}.py, metrics/{base}.py "
                            f"or a stage's <stage>_ms")


def load_driver(kind: str, bench: Path = BENCH):
    """drivers/<kind>.py, the driver of a traffic mix's kind."""
    return load_module(bench / "drivers" / f"{kind}.py", "bench_driver_")


def load_reference(cfg: Dict):
    """The configuration's plain reference: the module of the benchmark its
    `reference` key names (a file beside the harness)."""
    return importlib.import_module("benchmark." + Path(cfg["reference"]).stem)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files."""
    spec = load_json(root / "BENCHMARK.json")
    bench = root / "benchmark"
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = []
    for m in spec["per_layer"]:
        if name in m.get("workloads", [name] if m["moves"] in e2e_names else []):
            per_layer.append(dict(m, reader=load_reader(m["name"], bench)))
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, config=load_json(root / cfg["file"]), traffic=traffic,
                limits=load_json(bench / "checks" / f"{name}.json"),
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                driver=load_driver(traffic["kind"], bench))


# ------------------------------------------------------------ the program


def program_gaussians(params: Dict[str, torch.Tensor], cfg: Dict, extent: float):
    """The program's model state over the benchmark's parameter leaves."""
    from gsplat_tpu_torch.core.gaussians import Gaussians

    dev = params["xyz"].device
    zeros = torch.zeros(cfg["capacity"], dtype=torch.float32, device=dev)
    return Gaussians(**params, max_radii2D=zeros, xyz_gradient_accum=zeros.clone(),
                     denom=zeros.clone(),
                     n_live=torch.tensor(cfg["n_gaussians"], dtype=torch.int32, device=dev),
                     active_sh_degree=cfg["sh_degree"], max_sh_degree=cfg["sh_degree"],
                     spatial_lr_scale=extent)


def program_camera(mats: Dict, cfg: Dict, device, image=None):
    """The program's camera over the benchmark's matrices."""
    from gsplat_tpu_torch.core.camera import Camera

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(world_view=t(mats["world_view"]), full_proj=t(mats["full_proj"]),
                  cam_center=t(mats["cam_center"]), tan_fovx=t(math.tan(cfg["fovx"] * 0.5)),
                  tan_fovy=t(math.tan(cfg["fovy"] * 0.5)), image=image,
                  width=cfg["width"], height=cfg["height"])


def optimization_params(tr: Dict):
    from gsplat_tpu_torch.config import OptimizationParams

    return OptimizationParams(lambda_dssim=tr["lambda_dssim"], **tr["lr"])


def mesh_params(cfg: Dict):
    from gsplat_tpu_torch.config import MeshParams

    return MeshParams(tile_size=cfg["tile_size"], chunk_size=cfg["chunk"],
                      capacity=cfg["capacity"], pair_budget=cfg["pair_budget"])


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageRecorder:
    """on_stage for render and the train step: a CUDA event at each stage's
    end, one row a step or frame; `stages()` (after a synchronise) ->
    {stage: [ms, ...]}, each stage from the previous event (or the row's
    start)."""

    def __init__(self):
        self.rows: List[List] = []
        self.row: List = []

    @staticmethod
    def _event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def begin(self) -> None:
        self.row = [("start", self._event())]

    def __call__(self, name: str) -> None:
        self.row.append((name, self._event()))

    def end(self) -> None:
        self.rows.append(self.row)

    def stages(self) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {}
        for row in self.rows:
            for (_, a), (name, b) in zip(row, row[1:]):
                out.setdefault(name, []).append(a.elapsed_time(b))
        return out


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads."""
    stages: Dict[str, List[float]]            # stage ms a step or frame
    trace: Optional[Dict]                     # trace.summarize of the profiled window
    traced_units: int                         # steps or frames inside it
    unit_seconds: Optional[float]             # a step (window / steps) or the median frame
    work: Optional[Dict]                      # the reference's mean work a step or frame
    pixels: int
    live: int
    params_per_splat: int

    def stage_median(self, name: str) -> Optional[float]:
        v = self.stages.get(name)
        return statistics.median(v) if v else None

    def kernel_seconds(self, part: str) -> Optional[float]:
        """Device seconds a step or frame of the kernels whose name holds
        `part`, over the profiled window; None where none ran."""
        if not self.trace or not self.traced_units:
            return None
        s = sum(v for k, v in self.trace["kernels"].items() if part in k)
        return s / self.traced_units if s > 0 else None

    def idle_share(self) -> Optional[float]:
        if not self.trace or not self.trace["window_s"] or not self.trace["busy_s"]:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["window_s"])


class Window:
    """The measured window's clock. A traced run starts the profiler in its
    set-up (its first units there warm it up); the window's first
    `profile_seconds` run under it, inside a `bench.window` annotation, and
    its stop and the trace's export pause the clock. `done(units)` closes
    the profiled part when due and says whether the window is over."""

    def __init__(self, seconds: float, traced: bool, profile_seconds: float, device):
        self.seconds, self.profile_seconds = seconds, profile_seconds
        self.device, self.prof, self.summary = device, None, None
        self.traced_units, self.traced_s = 0, None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if device.type == "cuda" else [])
            self.prof = profile(activities=acts)
            self.prof.start()

    def start(self) -> None:
        sync(self.device)
        self.paused = 0.0
        self.t0 = time.perf_counter()
        if self.prof is not None:
            self.ann = torch.profiler.record_function(trace.WINDOW)
            self.ann.__enter__()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0 - self.paused

    def _stop_profile(self, units: int) -> None:
        t = time.perf_counter()
        self.traced_units, self.traced_s = units, self.elapsed()
        self.ann.__exit__(None, None, None)
        self.prof.stop()
        self.summary = trace.export_and_summarize(self.prof)
        self.prof = None
        self.paused += time.perf_counter() - t

    def done(self, units: int) -> bool:
        if self.prof is not None and self.elapsed() >= self.profile_seconds:
            self._stop_profile(units)
        if self.elapsed() < self.seconds:
            return False
        if self.prof is not None:
            self._stop_profile(units)
        return True


def annotate(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def rel_gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    that leaf's reference norm and the median leaf's."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return max(rel_gap(prog[k], ref[k], max(ref[k], med)) for k in keys)


# ----------------------------------------------------------- shared parts


def fit_budgets(g, cams, cfg: Dict, slack: Dict[str, float], device) -> Dict:
    """The budgets the loop would reach, fitted once over every view: one
    probe render a view at the configured pair budget with the tight cull
    on, for the pairs, the kept pairs, the composited rows and the
    saturation cull's survivors. The probes run with the saturation cull
    on (which leaves the composited rows as they are) where the loop's AUTO
    rule may take it, a pair budget under `fits.SAT_KEPT_LIMIT`, until a
    view's probe drops pairs: that view and the rest are probed without the
    cull, which then stays off. Then the `slack` headroom (fits.py)."""
    from gsplat_tpu_torch.render import render as render_mod

    chunk, budget, ts = cfg["chunk"], cfg["pair_budget"], cfg["tile_size"]
    bg = torch.zeros(3, dtype=torch.float32, device=device)

    def probe(cam, sat):
        kept = budget - chunk
        out = render_mod.render(cam, g, bg, tile_size=ts, chunk=chunk, pair_budget=budget,
                                kept_budget=kept, sat_budget=kept if sat else None)
        return torch.stack([out.n_pairs.long(), (out.n_pairs - out.n_culled).long(),
                            out.n_contrib, out.n_sat.long(), out.n_dropped.long()]).tolist()

    counts, sat_ok = [], budget < fits.SAT_KEPT_LIMIT
    with torch.no_grad():
        for cam in cams:
            c = probe(cam, sat_ok)
            if sat_ok and c[4]:
                sat_ok = False
                c = probe(cam, False)
            counts.append(c)
    if max(c[0] for c in counts) >= budget or max(c[4] for c in counts):
        raise RuntimeError(f"a view's pairs overflow the configured budget {budget}")
    top = [max(c[j] for c in counts) for j in range(4)]
    pair, kept = fits.fit_pairs(top[0], top[1], budget, chunk)
    fitted = {"configured": budget, "pair": pair, "kept": kept,
              "contrib": fits.fit_contrib(top[2]),
              "sat": fits.fit_sat(top[3], min(c[1] for c in counts), chunk)
              if sat_ok else None}
    out = fits.with_headroom(fitted, slack, chunk)
    out["probe"] = {"pairs_max": top[0], "kept_max": top[1], "contrib_max": top[2],
                    "sat_max": top[3] if sat_ok else None}
    return out


def params_per_splat(cfg: Dict) -> int:
    """xyz 3, f_dc 3, f_rest 3 (K - 1), opacity 1, scaling 3, rotation 4."""
    return 3 + 3 * (cfg["sh_degree"] + 1) ** 2 + 1 + 3 + 4


def mean_work(cfg: Dict, seed: int, mats: List[Dict], device) -> Dict:
    """The reference's work counts (work.py) averaged over views of the
    seed's initial scene."""
    reference = load_reference(cfg)
    p = scene.build_params(cfg, seed, device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    tot: Dict[str, float] = {}
    for m in mats:
        cam = reference.camera(m, cfg["fovx"], cfg["fovy"], cfg["width"], cfg["height"],
                               device)
        _, wk = reference.render(p, cam, bg, n_live=cfg["n_gaussians"],
                                 sh_degree=cfg["sh_degree"], tile_size=cfg["tile_size"],
                                 chunk=cfg["chunk"], count_work=True)
        for k, v in wk.items():
            tot[k] = tot.get(k, 0) + v / len(mats)
    return tot


# ---------------------------------------------------------------- the run


def run_cell(cell: Cell, *, seed: int, seconds: float, traced: bool, device,
             t_start: float, out: Callable[[str], None] = print) -> Dict:
    """One run of `cell` on `device` -> the result line's object (its
    metrics the cell's end-to-end metrics, or with `traced` its per-layer
    ones), without the import check, which the entry makes."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        out(f"bench: card {torch.cuda.get_device_name(device)}; imports and the card's "
            f"context at {time.perf_counter() - t_start!r} s")
    res = cell.driver.run(cell, seed, seconds, traced, device, t_start, out)
    if device.type == "cuda":   # after the window: nvidia-smi is no part of the set-up
        out(f"bench: nvidia-smi: {power_limit()}")
    if traced:
        reading = res["reading"]
        metrics = {}
        for m in cell.per_layer:
            v = m["reader"](reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in res["checks"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": res["peak"]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if traced and res["reading"].trace:
        tr = res["reading"].trace
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    return line


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv: List[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)
    cell = load_cell(ns.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"bench: {ns.workload} needs {cell.chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    importlib.import_module("gsplat_tpu_torch")   # the program, before any output
    line = run_cell(cell, seed=ns.seed, seconds=ns.seconds, traced=bool(ns.trace),
                    device=torch.device("cuda"), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"bench: the run loaded {', '.join(bad)}; no result")
        return 3
    for k, c in line["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
