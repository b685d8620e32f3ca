"""Nothing a run executes loads JAX or the JAX package, and the reference
loads nothing of the program. Top-level module names are compared whole:
the port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys

from benchmark import harness

RUN_MODULES = ("benchmark.harness", "benchmark.drivers.train", "benchmark.drivers.view",
               "benchmark.reference", "gsplat_tpu_torch.train.loop",
               "gsplat_tpu_torch.network_gui", "gsplat_tpu_torch.render.render",
               "gsplat_tpu_torch.render.binning", "gsplat_tpu_torch.render.project",
               "gsplat_tpu_torch.core.gaussians", "gsplat_tpu_torch.core.camera")
YARDSTICK = ("benchmark.reference", "benchmark.scene", "benchmark.work", "benchmark.fits",
             "benchmark.trace")


def loaded_after(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    tops = loaded_after(RUN_MODULES)
    assert "gsplat_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "gsplat_tpu"}


def test_yardstick_loads_nothing_of_the_program():
    tops = loaded_after(YARDSTICK)
    assert not tops & {"gsplat_tpu_torch", "gsplat_tpu", "jax", "jaxlib", "flax"}


def test_reference_source_imports():
    tree = ast.parse((harness.BENCH / "reference.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert {n.split(".")[0] for n in names} <= {"__future__", "math", "typing", "torch"}


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gsplat_tpu_torchx", sys)
    assert "gsplat_tpu_torchx" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gsplat_tpu.render", sys)
    assert "gsplat_tpu.render" in harness.forbidden_modules()
