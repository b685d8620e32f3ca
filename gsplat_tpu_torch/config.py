"""The port's configuration: its own copy of gsplat_tpu/config.py's
`ModelParams` and `OptimizationParams` (upstream 3DGS names and defaults,
verbatim) and of the `MeshParams` fields the training step and the render
CLI read.

The JAX package's config module imports no jax, but the port imports nothing
of that package, so the dataclasses are copied here.
"""

from __future__ import annotations

from dataclasses import dataclass


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
class MeshParams:
    """The render budgets and tiling of gsplat_tpu's `MeshParams` (the fields
    the training step reads; the mesh axes, profiling and sharding fields
    belong to slices not yet ported)."""

    tile_size: int = 32          # pixels per tile side
    chunk_size: int = 128        # pairs per compositing chunk
    pair_budget: int = 1 << 20   # max (Gaussian, tile) pairs per render
    kept_frac: float = -1.0      # post-sort sizing: -1 AUTO (fitted by the
                                 # training loop; the step starts unsplit), 1 = no
                                 # split, (0, 1) = fraction of pair_budget
    sat_frac: float = -1.0       # saturation bound cull: -1 AUTO (the step
                                 # starts with it off; the training loop that
                                 # turns it on is not ported yet), 0 off, > 0
                                 # on, sizing the packed survivors as a
                                 # fraction of pair_budget
    contrib_frac: float = -1.0   # backward d-table sizing: -1 AUTO (starts at
                                 # the never-overflowing worst case), 1 =
                                 # worst case, (0, 1) = fraction of pair_budget
