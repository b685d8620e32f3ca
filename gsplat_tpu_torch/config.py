"""Configuration surface: the port's copy of gsplat_tpu/config.py.

The reference's four parameter groups (names, defaults and CLI flags;
reference src/arguments/params.h:25-133, params.cpp:9-66) plus the
`MeshParams` group, with the JAX package's flags, short aliases and
defaults. Two differences: `ModelParams.data_device` defaults to
"cuda" (upstream's default; the device `Scene` and the training loop put
their tensors on), and `ModelParams.mip_splatting` (`--mip_splatting`, off
by default) trains and renders a Mip-Splatting model (Yu et al. 2024), a
field the JAX package lacks: `print_params` and `cfg_args_string` leave it
out while it is off, so with it off they write the JAX package's text. The
JAX package's config module imports no jax, but the port imports nothing
of that package, so the module is copied here.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class ModelParams:
    """Upstream `ModelParams` (reference src/arguments/params.h:25-48).
    data_device is the device `Scene` puts the cameras' target images and
    the Gaussians on: upstream's default "cuda" (the JAX package's "tpu" is
    informational there)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    mip_splatting: bool = False   # Mip-Splatting's 3D and 2D filters (the port's own)


# the port's own fields and their defaults: printed and recorded only when set
PORT_ONLY = {"mip_splatting": False}


@dataclass
class OptimizationParams:
    """Upstream 3DGS optimisation hyperparameters (reference
    src/arguments/params.h:50-91)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False


@dataclass
class PipelineParams:
    """Reference `PipelineParams` (src/arguments/params.h:93-106).

    convert_SHs_python / compute_cov3D_python toggle WHERE upstream computes
    SH colors and 3D covariances (Python vs inside the CUDA rasterizer). In the
    port both always happen in torch ahead of the compositing kernels, so the
    flags are accepted for CLI compatibility and are semantically no-ops;
    `debug` turns on autograd's anomaly mode (like --detect_anomaly)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class OtherParams:
    """Reference `OtherParams` (src/arguments/params.h:108-133)."""

    ip: str = "127.0.0.1"
    port: int = 6009
    debug_from: int = -1
    detect_anomaly: bool = False
    save_iterations: List[int] = field(default_factory=lambda: [7_000, 30_000])
    test_iterations: List[int] = field(default_factory=lambda: [7_000, 30_000])
    quiet: bool = False
    checkpoint_iterations: List[int] = field(default_factory=list)
    start_checkpoint: str = ""


@dataclass
class MeshParams:
    """Execution parameters, the JAX package's fields and defaults: the
    Gaussian set lives in tensors of size ``capacity`` with a live count, and
    tile binning writes into a fixed ``pair_budget``-sized buffer (grown by
    the training loop). A mesh of data_axis x tile_axis cells runs one
    process a cell, one rank a device (gsplat_tpu_torch/dist/): each step
    trains on data_axis cameras, each image split into tile_axis bands; the
    world must be exactly data_axis x tile_axis ranks (data_axis -1 takes
    world // tile_axis), else the training loop raises. The ranks join with
    the JAX package's three flags (coordinator_address host:port,
    num_processes, process_id) or torchrun's environment; the backend
    follows dist/mesh.py's rule (nccl, a card a rank; gloo on the CPU or
    where ranks share a card). shard_gaussians shards the model over the
    data axis (capacity % data_axis == 0) and is ignored on a 1-cell mesh,
    as in the JAX package; precision is a no-op in both packages.
    profile_dir captures a torch.profiler trace (rank 0).
    """

    data_axis: int = 1           # camera-batch shards (-1: world // tile_axis)
    tile_axis: int = 1           # intra-image tile shards (horizontal bands)
    # multi-process bootstrap, the JAX package's flags: the tcp:// rendezvous
    # host:port, the world size and this process's rank (cli.py; torchrun's
    # environment works without them)
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    profile_dir: str = ""        # capture a torch.profiler trace into this dir
    profile_steps: int = 10      # steps to trace (starting at iteration 20)
    tile_size: int = 32          # pixels per tile side (32x32: ~45% fewer pairs than 16)
    chunk_size: int = 128        # pairs per compositing chunk
    capacity: int = 1 << 17      # initial Gaussian capacity (padded, static)
    pair_budget: int = 1 << 20   # max (Gaussian, tile) pairs per render (static)
    # the post-sort budgets' modes, whose rules render/budgets.py holds (sat:
    # the saturation bound cull, bit-identical image and gradients)
    kept_frac: float = -1.0      # -1 AUTO (fitted), 1 unsplit, (0, 1) of pair_budget
    sat_frac: float = -1.0       # -1 AUTO (probed), 0 off, > 0 on, of pair_budget
    sat_probe_interval: int = 500  # iterations between the AUTO cull's probes
    contrib_frac: float = -1.0   # -1 AUTO (fitted), 1 worst case, (0, 1) of pair_budget
    shard_gaussians: bool = False  # ZeRO-style layout: Gaussian params, Adam
                                 # moments and densify accumulators sharded over
                                 # the data axis (large-N memory scaling); the
                                 # infrequent densify/reset/checkpoint steps
                                 # gather->run->reshard (transiently replicated)
    precision: str = "f32"       # rasterizer accumulation precision


PARAM_GROUPS = (ModelParams, OptimizationParams, PipelineParams, OtherParams, MeshParams)

Params = Tuple[ModelParams, OptimizationParams, PipelineParams, OtherParams, MeshParams]


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI mirroring the reference's boost::program_options registration
    (src/arguments/params.cpp:9-66): every field becomes ``--<name>``; bools are
    store_true flags; int lists are multitoken."""
    p = argparse.ArgumentParser(prog="gsplat-tpu-torch", description=__doc__)
    # upstream short aliases (arguments/__init__.py in upstream 3DGS)
    shorts = {"source_path": "-s", "model_path": "-m", "resolution": "-r",
              "images": "-i", "white_background": "-w"}
    for group_cls in PARAM_GROUPS:
        grp = p.add_argument_group(group_cls.__name__)
        for f in dataclasses.fields(group_cls):
            name = f"--{f.name}"
            extra = [shorts[f.name]] if f.name in shorts else []
            default = f.default if f.default is not dataclasses.MISSING else f.default_factory()  # type: ignore[misc]
            if f.type in ("bool", bool):
                grp.add_argument(name, *extra, action="store_true", default=default)
            elif f.type in ("List[int]", List[int]):
                grp.add_argument(name, *extra, nargs="*", type=int, default=default)
            elif f.type in ("int", int):
                grp.add_argument(name, *extra, type=int, default=default)
            elif f.type in ("float", float):
                grp.add_argument(name, *extra, type=float, default=default)
            else:
                grp.add_argument(name, *extra, type=str, default=default)
    return p


def parse_parameters(argv: Optional[List[str]] = None) -> Params:
    """Reference `parse_parameters` (src/arguments/params.cpp:322-341)."""
    ns = build_arg_parser().parse_args(argv)
    out = []
    for group_cls in PARAM_GROUPS:
        kwargs = {f.name: getattr(ns, f.name) for f in dataclasses.fields(group_cls)}
        out.append(group_cls(**kwargs))
    return tuple(out)  # type: ignore[return-value]


def print_params(params, out=None) -> str:
    """Reference `print_params` (src/arguments/params.h:36-132): used for both console
    output and `cfg_args` persistence (src/utils/train_utils.cpp:69-74)."""
    buf = io.StringIO()
    title = {
        "ModelParams": "Model",
        "OptimizationParams": "Optimization",
        "PipelineParams": "Pipeline",
        "OtherParams": "Other",
        "MeshParams": "Mesh",
    }[type(params).__name__]
    buf.write(f"> {title} parameters:\n")
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if f.name in PORT_ONLY and v == PORT_ONLY[f.name]:
            continue
        if isinstance(v, bool):
            v = "true" if v else "false"
        elif isinstance(v, list):
            v = " ".join(str(x) for x in v) + " "
        buf.write(f"  {f.name}: {v}\n")
    s = buf.getvalue()
    if out is not None:
        out.write(s)
    return s


def cfg_args_string(model: ModelParams) -> str:
    """The `cfg_args` file content upstream viewers expect: a python-repr Namespace
    with the ModelParams fields (reference persists print_params instead,
    src/utils/train_utils.cpp:69-74; we write the upstream-compatible form)."""
    fields = {k: v for k, v in dataclasses.asdict(model).items()
              if not (k in PORT_ONLY and v == PORT_ONLY[k])}
    inner = ", ".join(f"{k}={v!r}" for k, v in fields.items())
    return f"Namespace({inner})"
