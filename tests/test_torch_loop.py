"""Port parity, the training loop: gsplat_tpu_torch's config surface,
checkpoints, PLY export, metrics stream, train() and CLI on the CPU, against
the JAX package's on the same inputs.

- config: every default field by field (ModelParams.data_device is the
  one stated difference: "cuda"), the reference flags and short aliases
  parsed to equal values, print_params and cfg_args text equal.
- checkpoints: a round trip, and cross-loading in both directions (the
  arrays equal); save_ply bytes equal; metrics.jsonl and the TensorBoard
  event files byte-equal with the clock fixed.
- train(): the port's against the JAX package's on one make_colmap_scene
  scene with random backgrounds, densification, capacity growth and a pair
  budget regrowth, progress every iteration, the port's background and
  split-noise draws replaced by the JAX key chain: each iteration's loss
  and EMA within 1e-4 relative, the Gaussian counts, capacities and dropped
  pairs equal, every budget and capacity event equal, the final parameters
  within 1e-4 relative of each leaf's max. Each densify accumulator, scale
  and opacity is asserted at least 1e-3 relative away from its threshold,
  so that the count comparison means something.
- the port alone: exact resume on its own generator, the saturation cull's
  AUTO probe and enable, the kept/contrib budget fit, the interrupt
  checkpoint, a mesh of more than one device raising, and
  `python -m gsplat_tpu_torch.cli --data_device cpu` as a subprocess.
"""

import dataclasses
import io
import json
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu.train.loop as jloop
from gsplat_tpu import ckpt as jckpt
from gsplat_tpu import config as jconfig
from gsplat_tpu.core.gaussians import create_from_pcd as j_create_from_pcd
from gsplat_tpu.io.synthetic import make_colmap_scene
from gsplat_tpu.train import metrics as jmetrics
from gsplat_tpu.train import tb as jtb
from gsplat_tpu.train.optim import init_adam_state as j_init_adam
import gsplat_tpu_torch.train.loop as tloop
from gsplat_tpu_torch import ckpt, config
from gsplat_tpu_torch.interop import (adam_state_from_numpy, adam_state_to_numpy,
                                      gaussians_from_numpy, gaussians_to_numpy)
from gsplat_tpu_torch.train import metrics as tmetrics
from gsplat_tpu_torch.train import tb as ttb

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "max_radii2D",
          "xyz_gradient_accum", "denom")
GROUPS = ("ModelParams", "OptimizationParams", "PipelineParams", "OtherParams", "MeshParams")
LOOP_RTOL = 1e-4
MARGIN = 1e-3


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("group", GROUPS)
def test_config_defaults_match_jax(group):
    got, want = getattr(config, group)(), getattr(jconfig, group)()
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for name in names:
        if (group, name) == ("ModelParams", "data_device"):
            assert got.data_device == "cuda"   # the one stated difference
            continue
        assert getattr(got, name) == getattr(want, name), name


REFERENCE_FLAGS = [
    "--source_path", "/x", "--model_path", "/y", "--white_background",
    "--eval", "--sh_degree", "2", "--iterations", "7000",
    "--position_lr_init", "0.0002", "--lambda_dssim", "0.3",
    "--densify_grad_threshold", "0.0005",
    "--test_iterations", "100", "200",
    "--save_iterations", "100",
    "--ip", "0.0.0.0", "--port", "6010", "--quiet",
]
ALIASES = ["-s", "/data/garden", "-m", "/out", "-r", "2", "-i", "images_4", "-w",
           "--tile_axis", "4", "--checkpoint_iterations", "5", "9",
           "--start_checkpoint", "/c.npz", "--sat_probe_interval", "7",
           "--shard_gaussians", "--data_device", "cpu", "--detect_anomaly"]


@pytest.mark.parametrize("argv", [REFERENCE_FLAGS, ALIASES], ids=["reference", "aliases"])
def test_cli_flags_parse_as_jax(argv):
    got, want = config.parse_parameters(argv), jconfig.parse_parameters(argv)
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        if "data_device" in gd and "--data_device" not in argv:
            assert gd.pop("data_device") == "cuda" and wd.pop("data_device") == "tpu"
        assert gd == wd, type(g).__name__
    model, opt, pipe, other, mesh = got
    if argv is REFERENCE_FLAGS:
        assert model.white_background and model.eval and model.sh_degree == 2
        assert other.test_iterations == [100, 200] and other.quiet
        assert opt.opacity_reset_interval == 3000 and opt.densify_until_iter == 15000


def test_print_params_and_cfg_args_match_jax():
    argv = ALIASES
    for g, w in zip(config.parse_parameters(argv), jconfig.parse_parameters(argv)):
        assert config.print_params(g) == jconfig.print_params(w)
        buf = io.StringIO()
        config.print_params(g, out=buf)
        assert buf.getvalue() == jconfig.print_params(w)
    model = config.ModelParams(source_path="/x", data_device="tpu")
    assert config.cfg_args_string(model) == jconfig.cfg_args_string(
        jconfig.ModelParams(source_path="/x"))


# ---------------------------------------------------------------- checkpoints


def j_state(n=10, capacity=16, seed=1):
    rng = np.random.default_rng(seed)
    g = j_create_from_pcd(rng.normal(size=(n, 3)), rng.random((n, 3)), capacity=capacity)
    live = g.live_mask  # the live rows only: a checkpoint holds those
    g = g.replace(denom=jnp.where(live, jnp.arange(capacity, dtype=jnp.float32), 0.0),
                  xyz_gradient_accum=jnp.where(live, jnp.linspace(0, 1, capacity), 0.0),
                  max_radii2D=jnp.where(live, 2.5, 0.0))

    def moved(tree, by):
        return {k: jnp.where(live.reshape((-1,) + (1,) * (v.ndim - 1)), v + by, v)
                for k, v in tree.items()}

    opt = j_init_adam(g.params())
    opt = opt.replace(mu=moved(opt.mu, 1.5), nu=moved(opt.nu, 0.25),
                      count=jnp.asarray(42, jnp.int32))
    return g, opt


def to_port(g, opt):
    tg = gaussians_from_numpy({k: np.asarray(getattr(g, k)) for k in FIELDS}, int(g.n_live),
                              g.active_sh_degree, g.max_sh_degree, device="cpu",
                              spatial_lr_scale=g.spatial_lr_scale)
    tops = adam_state_from_numpy({k: np.asarray(v) for k, v in opt.mu.items()},
                                 {k: np.asarray(v) for k, v in opt.nu.items()},
                                 int(opt.count), device="cpu")
    return tg, tops


def assert_same_state(tg, tops, g, opt):
    got = gaussians_to_numpy(tg)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(g, k)), err_msg=k)
    assert int(got["n_live"]) == int(g.n_live)
    assert (tg.active_sh_degree, tg.max_sh_degree, tg.spatial_lr_scale) == (
        g.active_sh_degree, g.max_sh_degree, g.spatial_lr_scale)
    mu, nu, count = adam_state_to_numpy(tops)
    for k in opt.mu:
        np.testing.assert_array_equal(mu[k], np.asarray(opt.mu[k]), err_msg=k)
        np.testing.assert_array_equal(nu[k], np.asarray(opt.nu[k]), err_msg=k)
    assert count == int(opt.count)


def test_checkpoint_round_trip(tmp_path):
    g, opt = j_state()
    tg, tops = to_port(g, opt)
    p = tmp_path / "chk.npz"
    extra = {"torch_rng": torch.Generator().manual_seed(3).get_state().numpy(),
             "pair_budget": np.asarray(4096, np.int64)}
    ckpt.save_checkpoint(p, tg, tops, step=123, extra=extra)
    tg2, tops2, step = ckpt.load_checkpoint(p, capacity=16, device="cpu")
    assert step == 123
    assert_same_state(tg2, tops2, g, opt)
    got = ckpt.load_checkpoint_extras(p)
    assert set(got) == set(extra) and all(np.array_equal(got[k], extra[k]) for k in extra)
    tg3, tops3, _ = ckpt.load_checkpoint(p, capacity=64, device="cpu")
    assert tg3.capacity == 64 and int(tg3.n_live) == 10
    assert tops3.mu["xyz"].shape == (64, 3) and float(tops3.mu["xyz"][10:].abs().max()) == 0


def test_checkpoint_cross_loads(tmp_path):
    """A JAX-written checkpoint loads in the port, and the reverse; the
    files hold the same keys, dtypes and values."""
    g, opt = j_state()
    jp, tp = tmp_path / "jax.npz", tmp_path / "port.npz"
    jckpt.save_checkpoint(jp, g, opt, step=7, extra={"ema_loss": np.float32(0.5)})
    tg, tops = to_port(g, opt)
    ckpt.save_checkpoint(tp, tg, tops, step=7, extra={"ema_loss": np.float32(0.5)})
    zj, zt = np.load(jp), np.load(tp)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape, k
        np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    tg2, tops2, step = ckpt.load_checkpoint(jp, capacity=16, device="cpu")
    assert step == 7
    assert_same_state(tg2, tops2, g, opt)
    g3, opt3, step3 = jckpt.load_checkpoint(tp, capacity=16)
    assert step3 == 7
    assert_same_state(tg, tops, g3, opt3)


def test_save_ply_bytes_match_jax(tmp_path):
    g, opt = j_state()
    jckpt.save_ply(tmp_path / "j.ply", g)
    ckpt.save_ply(tmp_path / "t.ply", to_port(g, opt)[0])
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


class _Clock:
    @staticmethod
    def time():
        return 1.75e9 + 0.125


def test_metrics_and_tb_match_jax(tmp_path, monkeypatch):
    for mod in (jtb, ttb, jmetrics, tmetrics):
        monkeypatch.setattr(mod, "time", _Clock)
    records = [(1, dict(loss=0.5, ema_loss=0.25, n_gaussians=10, capacity=16)),
               (2, dict(test_loss=0.125, test_psnr=31.5)),
               (300, dict(loss=1e-3, note="text is skipped by TB", n_sat_pairs=0))]
    for mod, out in ((jmetrics, tmp_path / "j"), (tmetrics, tmp_path / "t")):
        m = mod.MetricsLogger(str(out))
        for step, values in records:
            m.log(step, **values)
        m.close()
    assert (tmp_path / "t" / "metrics.jsonl").read_bytes() == \
        (tmp_path / "j" / "metrics.jsonl").read_bytes()
    (jev,), (tev,) = sorted((tmp_path / "j" / "tb").iterdir()), sorted(
        (tmp_path / "t" / "tb").iterdir())
    assert tev.name == jev.name and tev.read_bytes() == jev.read_bytes()


# ---------------------------------------------------------------- train()

LOOP_ITERS = 16


class _Recorder:
    """Printer stand-in: records every message, quiet or not."""
    messages = None

    def __init__(self, quiet=False):
        pass

    def print(self, msg):
        self.messages.append(msg)


def _loop_configs(mod, root, out):
    model = mod.ModelParams(source_path=str(root), model_path=str(out), data_device="cpu")
    opt = mod.OptimizationParams(iterations=LOOP_ITERS, random_background=True,
                                 densify_from_iter=2, densification_interval=5,
                                 densify_until_iter=LOOP_ITERS, opacity_reset_interval=12)
    other = mod.OtherParams(test_iterations=[LOOP_ITERS], save_iterations=[], quiet=True)
    mesh = mod.MeshParams(tile_size=16, chunk_size=32, pair_budget=128, capacity=64,
                          sat_probe_interval=10 ** 9)
    return model, opt, mod.PipelineParams(), other, mesh


def _events(messages):
    keep = ("budget", "capacity", "AUTO", "eval")
    return [m for m in messages if any(k in m for k in keep)]


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """One JAX train() and one port train() on the same scene, the port's
    draws taken from the JAX key chain."""
    root = tmp_path_factory.mktemp("loop")
    make_colmap_scene(root / "scene", n_cams=5, width=48, height=32, n_points=30)
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        for name, mod, cfg in (("jax", jloop, jconfig), ("port", tloop, config)):
            msgs, densify_inputs = [], []
            rec = type("Rec", (_Recorder,), {"messages": msgs})
            mp.setattr(mod, "Printer", rec)
            if name == "jax":
                real = jloop.densify_and_prune_jit

                def spy(g, *a, _real=real, **kw):
                    densify_inputs.append({k: np.asarray(getattr(g, k)) for k in FIELDS}
                                          | {"n_live": int(g.n_live)})
                    return _real(g, *a, **kw)

                mp.setattr(jloop, "densify_and_prune_jit", spy)
            else:
                key = [jax.random.PRNGKey(0)]

                def draw(shape, fn):
                    key[0], sub = jax.random.split(key[0])
                    return torch.from_numpy(np.array(fn(sub, shape, jnp.float32)))

                real = tloop.densify_and_prune

                def spy(g, *a, _real=real, **kw):
                    densify_inputs.append(gaussians_to_numpy(g) | {"n_live": int(g.n_live)})
                    return _real(g, *a, **kw)

                mp.setattr(tloop, "draw_background", lambda gen: draw((3,), jax.random.uniform))
                mp.setattr(tloop, "split_noise", lambda gen, cap: draw((cap, 3), jax.random.normal))
                mp.setattr(tloop, "densify_and_prune", spy)
            random.seed(0)
            g, scene = mod.train(*_loop_configs(cfg, root / "scene", root / name),
                                 progress_every=1)
            recs = [json.loads(line) for line in open(root / name / "metrics.jsonl")]
            arrays = ({k: np.asarray(getattr(g, k)) for k in FIELDS} if name == "jax"
                      else gaussians_to_numpy(g))
            runs[name] = dict(g=arrays, n_live=int(g.n_live), records=recs,
                              events=_events(msgs), densify=densify_inputs,
                              extent=scene.cameras_extent)
    finally:
        mp.undo()
    return runs


def test_loop_follows_jax_each_iteration(loop_runs):
    j, t = loop_runs["jax"], loop_runs["port"]
    steps = [r for r in j["records"] if "loss" in r]
    got = [r for r in t["records"] if "loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in steps] == list(
        range(1, LOOP_ITERS + 1))
    for a, b in zip(got, steps):
        for k in ("loss", "ema_loss"):
            assert abs(a[k] - b[k]) <= LOOP_RTOL * abs(b[k]), (a["step"], k, a[k], b[k])
        for k in ("n_gaussians", "capacity", "n_dropped_pairs", "n_sat_pairs"):
            assert a[k] == b[k], (a["step"], k, a[k], b[k])
    evals = [(r["step"], sorted(r)) for r in t["records"] if "loss" not in r]
    assert evals == [(r["step"], sorted(r)) for r in j["records"] if "loss" not in r]


def test_loop_events_match_jax(loop_runs):
    j, t = loop_runs["jax"], loop_runs["port"]
    strip = [m.split(" PSNR")[0].rsplit(" loss", 1)[0] for m in t["events"]]
    assert strip == [m.split(" PSNR")[0].rsplit(" loss", 1)[0] for m in j["events"]]
    assert any("pair budget" in m for m in t["events"]), t["events"]
    assert any("growing capacity" in m for m in t["events"]), t["events"]


def test_loop_final_parameters_match_jax(loop_runs):
    j, t = loop_runs["jax"], loop_runs["port"]
    assert t["n_live"] == j["n_live"]
    for k in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"):
        want = j["g"][k]
        assert t["g"][k].shape == want.shape, k
        np.testing.assert_allclose(t["g"][k], want, rtol=LOOP_RTOL,
                                   atol=LOOP_RTOL * max(float(np.abs(want).max()), 1e-30),
                                   err_msg=k)


def test_loop_densify_decisions_have_margin(loop_runs):
    """Each densify input's accumulators, scales and opacities lie at least
    1e-3 relative away from their thresholds in both runs, so equal counts
    are not a coincidence of rounding."""
    j, t = loop_runs["jax"], loop_runs["port"]
    assert len(t["densify"]) == len(j["densify"]) >= 3
    opt = tloop.OptimizationParams()
    thr = {"grad": opt.densify_grad_threshold,
           "scale": opt.percent_dense * t["extent"], "opacity": 0.005}
    for run in (j, t):
        for d in run["densify"]:
            n = d["n_live"]
            denom = d["denom"][:n]
            grads = d["xyz_gradient_accum"][:n][denom > 0] / denom[denom > 0]
            vals = {"grad": grads, "scale": np.exp(d["scaling"][:n]).max(-1),
                    "opacity": 1.0 / (1.0 + np.exp(-d["opacity"][:n, 0]))}
            for k, v in vals.items():
                gap = np.abs(v.astype(np.float64) - thr[k]) / thr[k]
                assert gap.size == 0 or gap.min() >= MARGIN, (k, gap.min())


# ---------------------------------------------------------------- the port alone


def _port_run(root, out, iters, **kw):
    mesh_kw = dict(tile_size=16, chunk_size=32, pair_budget=1 << 12, capacity=64)
    mesh_kw.update(kw.pop("mesh", {}))
    model = config.ModelParams(source_path=str(root), model_path=str(out), data_device="cpu")
    opt_kw = dict(iterations=iters)
    opt_kw.update(kw.pop("opt", {}))
    other_kw = dict(test_iterations=[], save_iterations=[], quiet=True)
    other_kw.update(kw.pop("other", {}))
    random.seed(0)
    return tloop.train(model, config.OptimizationParams(**opt_kw), config.PipelineParams(),
                       config.OtherParams(**other_kw), config.MeshParams(**mesh_kw), **kw)


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("small")
    make_colmap_scene(root / "scene", n_cams=5, width=48, height=32, n_points=30)
    return root / "scene"


def test_exact_resume(small_scene, tmp_path):
    """Interrupt -> resume reproduces the straight run bit for bit: the
    checkpoint carries the torch generator's state, Python's random state,
    the camera-order cursor, the EMA and the pair budget."""
    opt = dict(random_background=True, densify_from_iter=2, densification_interval=5,
               densify_until_iter=14, opacity_reset_interval=10 ** 9)
    g_full, _ = _port_run(small_scene, tmp_path / "full", 14, opt=opt,
                          other=dict(checkpoint_iterations=[7, 14]))
    g_res, _ = _port_run(small_scene, tmp_path / "resumed", 14, opt=opt,
                         other=dict(checkpoint_iterations=[14],
                                    start_checkpoint=str(tmp_path / "full" / "chkpnt7.npz")))
    assert "torch_rng" in ckpt.load_checkpoint_extras(tmp_path / "full" / "chkpnt7.npz")
    a, b = gaussians_to_numpy(g_full), gaussians_to_numpy(g_res)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    za, zb = np.load(tmp_path / "full" / "chkpnt14.npz"), np.load(
        tmp_path / "resumed" / "chkpnt14.npz")
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_jax_checkpoint_resumes_in_port(small_scene, tmp_path, capsys):
    """A checkpoint of the JAX loop's layout (extra_rng_key, no torch state)
    resumes: everything but the key is taken, and one line says so."""
    g, opt = j_state(n=30, capacity=64)
    jckpt.save_checkpoint(tmp_path / "j.npz", g, opt, step=3, extra={
        "rng_key": np.asarray(jax.random.PRNGKey(0)), "pair_budget": np.asarray(8192, np.int64),
        "cam_order": np.asarray([2, 0], np.int64), "ema_loss": np.asarray(0.5, np.float32)})
    g2, _ = _port_run(small_scene, tmp_path / "out", 5,
                      other=dict(start_checkpoint=str(tmp_path / "j.npz"), quiet=False))
    out = capsys.readouterr().out
    assert "Restored checkpoint" in out and out.count("JAX PRNG key") == 1
    assert g2.capacity == 64 and int(g2.n_live) == 30


def test_sat_auto_probe_and_enable(small_scene, tmp_path, monkeypatch):
    """AUTO saturation cull: the probe on the sparse scene keeps the cull
    off; a faked saturating probe enables it, the real render then
    overflows the fitted budget and the adaptive regrowth recovers."""
    opt = dict(densify_from_iter=10 ** 9, densify_until_iter=0,
               opacity_reset_interval=10 ** 9)
    mesh = dict(sat_probe_interval=4)
    _port_run(small_scene, tmp_path / "auto_off", 12, opt=opt, mesh=mesh, progress_every=2)
    steps = [json.loads(line) for line in open(tmp_path / "auto_off" / "metrics.jsonl")]
    assert steps and all(s["n_sat_pairs"] == 0 for s in steps)

    real_probe = tloop._sat_probe

    def fake_probe(g, cam, bg, **kw):
        ns, npair, ncull, ndrop = real_probe(g, cam, bg, **kw)
        return torch.tensor(32, dtype=torch.int32), npair, ncull, ndrop

    monkeypatch.setattr(tloop, "_sat_probe", fake_probe)
    _port_run(small_scene, tmp_path / "auto_on", 30, opt=opt, mesh=mesh, progress_every=2)
    steps = [json.loads(line) for line in open(tmp_path / "auto_on" / "metrics.jsonl")]
    assert steps and steps[-1]["n_sat_pairs"] > 0, steps


def test_auto_kept_contrib_budget_fit(small_scene, tmp_path):
    """After 20 low-usage checks the loop fits the kept and contrib budgets;
    they persist into the checkpoint and a resumed run takes them."""
    opt = dict(densify_from_iter=10 ** 9, densify_until_iter=0,
               opacity_reset_interval=10 ** 9)
    mesh = dict(sat_probe_interval=10 ** 9)
    out = tmp_path / "model"
    _port_run(small_scene, out, 210, opt=opt, mesh=mesh,
              other=dict(checkpoint_iterations=[210]))
    extras = ckpt.load_checkpoint_extras(out / "chkpnt210.npz")
    assert "kept_budget" in extras and "contrib_budget" in extras, extras.keys()
    assert 32 <= int(extras["kept_budget"]) < (1 << 12)
    assert 512 <= int(extras["contrib_budget"])
    g2, _ = _port_run(small_scene, out, 215, opt=opt, mesh=mesh,
                      other=dict(start_checkpoint=str(out / "chkpnt210.npz")))
    assert int(g2.n_live) > 0


def test_interrupt_checkpoint(small_scene, tmp_path, monkeypatch):
    real = tloop.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def interrupted(g, opt_state, cam, bg, it, ema, **k):
            if it == 4:
                raise KeyboardInterrupt
            return step(g, opt_state, cam, bg, it, ema, **k)

        return interrupted

    monkeypatch.setattr(tloop, "make_train_step", make)
    with pytest.raises(KeyboardInterrupt):
        _port_run(small_scene, tmp_path / "out", 10)
    path = tmp_path / "out" / "chkpnt_interrupt_4.npz"
    g, _, step = ckpt.load_checkpoint(path, capacity=64, device="cpu")
    assert step == 4 and int(g.n_live) == 30
    assert "torch_rng" in ckpt.load_checkpoint_extras(path)


@pytest.mark.parametrize("mesh,rule", [
    (dict(data_axis=2), "one process a mesh cell"),
    (dict(tile_axis=2), "one process a mesh cell"),
    (dict(num_processes=2), "join the process group")],
    ids=["data_axis", "tile_axis", "processes"])
def test_multi_device_mesh_raises(small_scene, tmp_path, mesh, rule):
    """One process holds one mesh cell: a larger mesh, or num_processes > 1,
    without a process group of that size raises the rule (tests of the mesh
    itself: test_torch_dist.py, test_torch_multihost.py)."""
    with pytest.raises(ValueError, match=rule):
        _port_run(small_scene, tmp_path / "out", 2, mesh=mesh)


def test_cli_subprocess(small_scene, tmp_path):
    import socket

    out = tmp_path / "out"
    with socket.socket() as sock:      # a free port for the live viewer
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    p = subprocess.run(
        [sys.executable, "-m", "gsplat_tpu_torch.cli", "-s", str(small_scene), "-m", str(out),
         "--data_device", "cpu", "--iterations", "6", "--capacity", "64",
         "--pair_budget", "4096", "--tile_size", "16", "--chunk_size", "32",
         "--densify_from_iter", "2", "--densification_interval", "3",
         "--test_iterations", "6", "--shard_gaussians", "--eval",
         "--ip", "127.0.0.1", "--port", str(port)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.rstrip().endswith("Training complete.")
    assert "> Mesh parameters:" in p.stdout and "eval test" in p.stdout
    # without --quiet the live viewer serves on --ip/--port
    assert "--shard_gaussians ignored" in p.stdout
    assert f"viewer: http://127.0.0.1:{port}/" in p.stdout
    ply = out / "point_cloud" / "iteration_6" / "point_cloud.ply"
    assert ply.exists() and (out / "cfg_args").exists()
