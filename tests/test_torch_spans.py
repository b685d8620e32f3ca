"""The port's spans (gsplat_tpu_torch/spans.py) on the CPU, under
torch.profiler's CPU tracing, at the fixtures' 64x48 scene.

- a train step and a render give the span tree: `step` the root of every
  span of its step, `render` under it with the forward stages, `loss`,
  `backward`, `adam` and `densify_stats` under the step, `backward.raster`
  under `backward` and `backward.raster.reduce` under it; the backward's
  three parts (up to the raster's start, the raster, after it) tile it;
- the gather's counters: the rows of the gid table the compositors read
  (the kept or the sat budget) and the live ones (the RenderOutput's
  n_pairs - n_culled, or the cull's survivors); the rows K2 and K3 staged
  through their gids (`staged`: K2's n_contrib, K3's the same);
- the exported Chrome trace holds `gsplat.*` annotations inside the step;
- without a profiler nothing records and no record_function is entered;
- the ring keeps its bound; parents across threads (the autograd engine's
  device threads on CUDA); the viewer's spans, a host frame's copy
  counting pinned == 0;
- on_stage receives the stage names it received before spans, pinned.
"""

import contextlib
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_port_fixtures as F
from gsplat_tpu_torch import network_gui, spans
from gsplat_tpu_torch.config import MeshParams, OptimizationParams
from gsplat_tpu_torch.render.binning import bin_gaussians
from gsplat_tpu_torch.render.project import project_gaussians
from gsplat_tpu_torch.render.render import render
from gsplat_tpu_torch.train.loop import make_train_step
from gsplat_tpu_torch.train.optim import init_adam_state

torch.set_num_threads(1)
BUDGET, CHUNK = 1 << 12, 32
KEPT = BUDGET - CHUNK
FORWARD = ["project", "bin", "sort", "gather", "composite", "untile"]
FORWARD_SAT = ["project", "bin", "sort", "sat", "gather", "composite", "untile"]
STEP_TAIL = ["loss", "backward", "adam", "densify_stats"]


@pytest.fixture(scope="module")
def scene():
    g, cam = F.torch_objects(F.make_scene())
    target = torch.from_numpy(np.random.default_rng(3).random((F.H, F.W, 3), np.float32))
    return g, dataclasses.replace(cam, image=target), torch.tensor([0.1, 0.2, 0.3])


def train_step(scene, sat_budget=None):
    g, cam, bg = scene
    step = make_train_step(OptimizationParams(), MeshParams(tile_size=F.TILE, chunk_size=CHUNK,
                                                            pair_budget=BUDGET),
                           1.0, F.W, F.H, sat_budget=sat_budget)
    return lambda on_stage=None: step(g, init_adam_state(g.params()), cam, bg, 1, 0.0,
                                      on_stage=on_stage)


def do_render(scene, on_stage=None, **kw):
    g, cam, bg = scene
    kw = dict(dict(pair_budget=BUDGET), **kw)
    return render(cam, g, bg, tile_size=F.TILE, chunk=CHUNK, on_stage=on_stage, **kw)


def recorded(fn):
    """fn() under the CPU profiler -> (its result, the spans it recorded,
    the profiler)."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans.records(), prof


def by_name(recs):
    got = {}
    for r in recs:
        assert r.name not in got, f"two spans named {r.name}"
        got[r.name] = r
    return got


def test_train_step_tree(scene):
    _, recs, _ = recorded(train_step(scene))
    s = by_name(recs)
    assert set(s) == {"step", "render", *FORWARD, *STEP_TAIL, "backward.raster",
                      "backward.raster.reduce"}
    parent = {r.name: (None if r.parent is None else next(p.name for p in recs
                                                           if p.id == r.parent))
              for r in recs}
    assert parent["step"] is None and parent["render"] == "step"
    assert all(parent[n] == "render" for n in FORWARD)
    assert all(parent[n] == "step" for n in STEP_TAIL)
    assert parent["backward.raster"] == "backward"
    assert parent["backward.raster.reduce"] == "backward.raster"
    assert {r.root for r in recs} == {s["step"].id}
    # K3 staged the rows of the chunks K2 composited (no contrib overflow)
    staged = int(s["composite"].counters["staged"])
    assert int(s["backward.raster"].counters["staged"]) == staged > 0
    for r in recs:   # a child lies inside its parent on the host's clock
        if r.parent is not None:
            p = next(q for q in recs if q.id == r.parent)
            assert p.t0 <= r.t0 <= r.t1 <= p.t1
        assert r.device_ms() is None   # no CUDA here: host times alone


def test_two_steps_two_roots(scene):
    fn = train_step(scene)
    _, recs, _ = recorded(lambda: (fn(), fn()))
    steps = [r for r in recs if r.name == "step"]
    assert len(steps) == 2
    for st in steps:
        assert sum(r.root == st.id for r in recs) == len(recs) // 2


def test_backward_parts_cover_the_backward(scene):
    _, recs, _ = recorded(train_step(scene))
    s = by_name(recs)
    bwd, raster = s["backward"], s["backward.raster"]
    loss_bwd = raster.t0 - bwd.t0
    project_bwd = bwd.t1 - raster.t1
    parts = loss_bwd + (raster.t1 - raster.t0) + project_bwd
    assert min(loss_bwd, project_bwd) >= 0
    assert abs(parts - (bwd.t1 - bwd.t0)) <= 0.01 * (bwd.t1 - bwd.t0)
    assert s["backward.raster.reduce"].host_ms() <= raster.host_ms()


@pytest.mark.parametrize("kw", [dict(), dict(kept_budget=KEPT)], ids=["gui", "kept"])
def test_gather_counts_rows_and_live_pairs(scene, kw):
    out, recs, _ = recorded(lambda: do_render(scene, **kw))
    gather = by_name(recs)["gather"]
    assert gather.counters["rows"] == kw.get("kept_budget", BUDGET)
    live = int(gather.counters["live"])
    assert live == int(out.n_pairs - out.n_culled) > 0
    # the rows K2 staged through their gids: its chunks composited
    assert int(by_name(recs)["composite"].counters["staged"]) == int(out.n_contrib) > 0


def test_gather_counts_the_sat_survivors(scene):
    kw = dict(kept_budget=KEPT, sat_budget=KEPT)
    out, recs, _ = recorded(lambda: do_render(scene, **kw))
    gather = by_name(recs)["gather"]
    assert gather.counters["rows"] == KEPT
    g, cam, _ = scene
    proj = project_gaussians(g, cam)
    b = bin_gaussians(proj.mean2d, proj.radius, proj.depth, width=F.W, height=F.H,
                      tile_size=F.TILE, chunk=CHUNK, pair_budget=BUDGET,
                      cull_conic=proj.conic, cull_opacity=proj.opacity, **kw)
    live = int(gather.counters["live"])
    assert live == int(b.tile_count.sum()) > 0
    assert live <= int(out.n_pairs - out.n_culled)


def test_chrome_trace_holds_the_spans_inside_the_step(scene, tmp_path):
    _, _, prof = recorded(train_step(scene))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and str(e.get("name", "")).startswith(spans.PREFIX)]
    names = {e["name"] for e in ann}
    assert {"gsplat.step", "gsplat.render", "gsplat.gather", "gsplat.backward",
            "gsplat.backward.raster", "gsplat.backward.raster.reduce"} <= names
    (step,) = [e for e in ann if e["name"] == "gsplat.step"]
    t0, t1 = step["ts"], step["ts"] + step["dur"]
    assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for e in ann)


def test_nothing_records_without_a_profiler(scene, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        entered.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    spans.clear()
    assert not torch.autograd.profiler._is_profiler_enabled
    train_step(scene)()
    do_render(scene, kept_budget=KEPT, sat_budget=KEPT)
    network_gui.image_to_bytes(torch.rand(4, 5, 3))
    assert spans.records() == [] and entered == []
    with spans.span("x") as sp:
        assert sp is None


def test_ring_keeps_its_bound():
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(spans.RING + 5):
            with spans.span("tick"):
                pass
        with spans.span("last"):
            pass
    recs = spans.records()
    assert len(recs) == spans.RING and recs[-1].name == "last"
    spans.clear()


def test_parents_across_threads():
    """The autograd engine's device threads run the backward's functions:
    their spans take the adopting span as parent; a root opened there (a
    network-GUI connection thread's parse) takes none."""
    seen = {}

    def worker():
        with spans.span("inner") as sp:
            seen["inner"] = (sp.parent, sp.root)
        with spans.span("gui.parse", root=True) as sp:
            seen["root"] = (sp.parent, sp.root, sp.id)

    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("step", root=True) as st:
            with spans.span("backward", adopt=True) as bwd:
                t = threading.Thread(target=worker)
                t.start()
                t.join()
            with spans.span("adam") as adam:
                pass
    assert seen["inner"] == (bwd.id, st.id)
    assert seen["root"][:2] == (None, seen["root"][2])
    assert adam.parent == st.id


def test_threads_record_apart():
    """Threads opening spans at once, with switches forced often: every span
    recorded once, with an id of its own and its own thread's parent."""
    import sys

    n_threads, n_spans = 16, 200
    errors = []

    def worker(k):
        try:
            for _ in range(n_spans):
                with spans.span(f"outer{k}", root=True) as outer:
                    with spans.span(f"inner{k}") as inner:
                        assert inner.parent == outer.id and inner.root == outer.id
        except AssertionError as e:
            errors.append(e)

    spans.clear()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    recs = spans.records()
    assert len(recs) == 2 * n_threads * n_spans == len({r.id for r in recs})
    spans.clear()


def test_listener_only_on_a_clean_exit():
    names = []
    for on in (False, True):
        with profile(activities=[ProfilerActivity.CPU]) if on else contextlib.nullcontext():
            with pytest.raises(ValueError):
                with spans.span("a", names.append):
                    raise ValueError
            with spans.span("b", names.append):
                pass
    assert names == ["b", "b"]


def test_viewer_spans():
    msg = {"resolution_x": 5, "resolution_y": 4, "view_matrix": np.eye(4).ravel().tolist(),
           "view_projection_matrix": np.eye(4).ravel().tolist()}

    def frame():
        req = network_gui.parse_message(msg)
        network_gui.camera_from_request(req, "cpu")
        return network_gui.image_to_bytes(torch.rand(4, 5, 3))

    data, recs, _ = recorded(frame)
    s = by_name(recs)
    assert len(data) == 60
    assert set(s) == {"gui.parse", "gui.camera", "gui.to_bytes", "gui.to_bytes.quantize",
                      "gui.to_bytes.copy"}
    for n in ("gui.parse", "gui.camera", "gui.to_bytes"):
        assert s[n].parent is None and s[n].root == s[n].id
    for n in ("gui.to_bytes.quantize", "gui.to_bytes.copy"):
        assert s[n].parent == s["gui.to_bytes"].id


def test_viewer_copy_not_pinned_on_host(monkeypatch):
    """A host tensor's copy span counts pinned == 0 and makes no CUDA call;
    a numpy frame has no copy span."""
    def no_card(*a, **kw):
        raise AssertionError("a host frame reached for the card")

    monkeypatch.setattr(torch.cuda, "current_stream", no_card)
    x = torch.rand(4, 5, 3)
    want = (x * 255).to(torch.uint8).numpy().tobytes()
    data, recs, _ = recorded(lambda: network_gui.image_to_bytes(x))
    s = by_name(recs)
    assert data == want
    assert s["gui.to_bytes.copy"].counters == {"pinned": 0}
    data, recs, _ = recorded(lambda: network_gui.image_to_bytes(x.numpy()))
    assert data == want and {r.name for r in recs} == {"gui.to_bytes"}


# the stage names every on_stage caller received before the spans
PINNED = {
    "render": FORWARD,
    "render kept": FORWARD,
    "render sat": FORWARD_SAT,
    "train_step": FORWARD + STEP_TAIL,
    "train_step sat": FORWARD_SAT + STEP_TAIL,
}


@pytest.mark.parametrize("traced", [False, True], ids=["off", "recording"])
@pytest.mark.parametrize("case", sorted(PINNED))
def test_on_stage_names_pinned(scene, case, traced):
    calls = {
        "render": lambda st: do_render(scene, st),
        "render kept": lambda st: do_render(scene, st, kept_budget=KEPT),
        "render sat": lambda st: do_render(scene, st, kept_budget=KEPT, sat_budget=KEPT),
        "train_step": lambda st: train_step(scene)(st),
        "train_step sat": lambda st: train_step(scene, sat_budget=BUDGET)(st),
    }
    names = []
    if traced:
        recorded(lambda: calls[case](names.append))
    else:
        calls[case](names.append)
    assert names == PINNED[case]
