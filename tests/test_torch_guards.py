"""The port stands alone: gsplat_tpu_torch, chip_smoke.py, bench_torch.py
and the mesh tests' rank worker import no jax, no gsplat_tpu module and no
PIL (the machine with the GPU has none of them), and they import in a
process where jax cannot be imported. No file of the port names the JAX package's native
IO library or its build, and the port's own runtime builds and decodes
where jax, PIL and gsplat_tpu cannot be imported."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "gsplat_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "bench_torch.py", REPO / "tests" / "torch_dist_worker.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|PIL)\b|from\s+(jax|flax|PIL)\b"
    r"|import\s+gsplat_tpu(\.|\s|$)|from\s+gsplat_tpu(\.|\s))",
    re.MULTILINE,
)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_or_pil_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.name} imports {hits}"


NATIVE_NAMES = re.compile(r"native/|libgsplat_io|make -C")


@pytest.mark.parametrize("path", sorted(p for p in (REPO / "gsplat_tpu_torch").rglob("*")
                                        if p.suffix in (".py", ".c", ".cu", ".cuh")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_native_library(path):
    hits = NATIVE_NAMES.findall(path.read_text())
    assert not hits, f"{path.name} names {hits}"


def test_native_runtime_with_jax_blocked(tmp_path):
    """io/native_loader.py imports, builds the runtime from csrc/ and
    decodes a PNG it wrote itself, with jax, PIL and gsplat_tpu blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'PIL', 'gsplat_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from gsplat_tpu_torch.io import native_loader, png\n"
        "img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)\n"
        f"png.write_png({str(tmp_path / 'a.png')!r}, img)\n"
        "assert native_loader.available()\n"
        f"out = native_loader.decode_image({str(tmp_path / 'a.png')!r}, 7, 5)\n"
        "assert np.array_equal(out, img.astype(np.float32) / np.float32(255))\n"
        "print('ok')\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-3000:]


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'PIL', 'gsplat_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import gsplat_tpu_torch, gsplat_tpu_torch.interop, gsplat_tpu_torch.scene\n"
        "import gsplat_tpu_torch.io.ply, gsplat_tpu_torch.render.render\n"
        "import gsplat_tpu_torch.render.raster_ref, gsplat_tpu_torch._build\n"
        "import gsplat_tpu_torch.render.bounds, gsplat_tpu_torch.config\n"
        "import gsplat_tpu_torch.render.scan, gsplat_tpu_torch.render.compact\n"
        "import gsplat_tpu_torch.train.loss, gsplat_tpu_torch.train.optim\n"
        "import gsplat_tpu_torch.train.densify, gsplat_tpu_torch.train.loop\n"
        "import gsplat_tpu_torch.io.png, gsplat_tpu_torch.io.colmap\n"
        "import gsplat_tpu_torch.io.dataset, gsplat_tpu_torch.io.synthetic\n"
        "import gsplat_tpu_torch.io.native_loader, gsplat_tpu_torch.render_cli\n"
        "import gsplat_tpu_torch.ckpt, gsplat_tpu_torch.cli\n"
        "import gsplat_tpu_torch.train.metrics, gsplat_tpu_torch.train.tb\n"
        "import gsplat_tpu_torch.lpips, gsplat_tpu_torch.metrics_cli\n"
        "import gsplat_tpu_torch.full_eval, gsplat_tpu_torch.viewer\n"
        "import gsplat_tpu_torch.network_gui\n"
        "import gsplat_tpu_torch.tools.bench_scene, gsplat_tpu_torch.tools.ab_step\n"
        "import gsplat_tpu_torch.tools.make_synthetic_scene\n"
        "import gsplat_tpu_torch.tools.selfcheck_train\n"
        "import gsplat_tpu_torch.tools.quality_proxy, gsplat_tpu_torch.tools.gpu_parity\n"
        "import gsplat_tpu_torch.tools.profile_step\n"
        "import gsplat_tpu_torch.dist, gsplat_tpu_torch.dist.mesh, gsplat_tpu_torch.dist.data\n"
        "import gsplat_tpu_torch.dist.spmd, gsplat_tpu_torch.dist.collectives\n"
        "import gsplat_tpu_torch.dist.launch, gsplat_tpu_torch.tools.multihost_smoke\n"
        "import gsplat_tpu_torch.tools.sharded_scale_demo, gsplat_tpu_torch.tools.bench\n"

        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "spec = importlib.util.spec_from_file_location('bench_torch', 'bench_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "spec = importlib.util.spec_from_file_location('w', 'tests/torch_dist_worker.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok')\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-3000:]
