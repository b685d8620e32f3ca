"""The Gaussian model state: a capacity-padded dataclass of tensors.

Port of gsplat_tpu/core/gaussians.py (Gaussians with its SH-degree
annealing, inverse_sigmoid, the fresh-scene init create_from_pcd with its
3-NN distances, and grow_capacity). Arrays are padded to a fixed capacity
with a live count, as in the reference, so states compare array for array;
padded rows are inert by construction (opacity logit -30, log-scale -30,
identity quaternion).

A Mip-Splatting model (Yu et al. 2024) carries one more per-row buffer,
`filter_3d`: each Gaussian's 3D smoothing filter, a world-space standard
deviation taken from the training cameras (render/filter3d.py), not
optimized. It is None for a 3DGS model, and its presence is what makes
the projection apply both Mip filters (render/project.py).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.core.sh import num_sh_coeffs, rgb2sh

PAD_OPACITY_LOGIT = -30.0
PAD_LOG_SCALE = -30.0

# the six optimized leaves, in upstream's parameter-group order
PARAM_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


@dataclass
class Gaussians:
    """Raw (pre-activation) parameters + densification accumulators.

    Shapes (CAP = capacity, M = (max_sh_degree+1)^2 - 1):
      xyz (CAP,3) | f_dc (CAP,3) | f_rest (CAP,M,3) | opacity (CAP,1)
      scaling (CAP,3) log | rotation (CAP,4)
      max_radii2D (CAP,) | xyz_gradient_accum (CAP,) | denom (CAP,)
      n_live () int32
      filter_3d (CAP,) or None: the Mip-Splatting 3D filter (0 on dead rows)
    """

    xyz: torch.Tensor
    f_dc: torch.Tensor
    f_rest: torch.Tensor
    opacity: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    max_radii2D: torch.Tensor
    xyz_gradient_accum: torch.Tensor
    denom: torch.Tensor
    n_live: torch.Tensor
    active_sh_degree: int = 0
    max_sh_degree: int = 3
    spatial_lr_scale: float = 1.0
    filter_3d: Optional[torch.Tensor] = None

    @property
    def mip(self) -> bool:
        """A Mip-Splatting model: the projection applies both filters."""
        return self.filter_3d is not None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def live_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.n_live

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        # clamped rsqrt, not a norm: an all-zero quaternion row stays finite
        sq = (self.rotation * self.rotation).sum(-1, keepdim=True)
        return self.rotation * torch.rsqrt(torch.clamp(sq, min=1e-12))

    def get_xyz(self) -> torch.Tensor:
        return self.xyz

    def get_features(self) -> torch.Tensor:
        """cat(dc, rest) along the SH-coefficient dim -> (CAP, K, 3)."""
        return torch.cat([self.f_dc[:, None, :], self.f_rest], dim=1)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in PARAM_KEYS}

    def replace(self, **changes) -> "Gaussians":
        return replace(self, **changes)

    def oneup_sh_degree(self) -> "Gaussians":
        """Reference gaussian_model.cpp:307-313: one more SH band, up to the
        model's maximum."""
        if self.active_sh_degree < self.max_sh_degree:
            return self.replace(active_sh_degree=self.active_sh_degree + 1)
        return self


def pad_fill(name: str, shape, device: Union[str, torch.device]) -> torch.Tensor:
    """The inert rows of leaf `name`, (shape) float32 on `device`: opacity
    logit -30, log-scale -30, the identity quaternion, zeros elsewhere."""
    if name == "opacity":
        return torch.full(shape, PAD_OPACITY_LOGIT, dtype=torch.float32, device=device)
    if name == "scaling":
        return torch.full(shape, PAD_LOG_SCALE, dtype=torch.float32, device=device)
    fill = torch.zeros(shape, dtype=torch.float32, device=device)
    if name == "rotation":
        fill[..., 0] = 1.0
    return fill


def _pad_rows(cap: int, device: Union[str, torch.device]) -> Callable:
    """pad(name, arr) -> (cap, ...) float32 tensor on `device`: the host
    array padded in numpy with the inert row template of leaf `name`, then
    moved in one copy."""

    def pad(name: str, arr: np.ndarray) -> torch.Tensor:
        arr = np.asarray(arr, np.float32)
        fill = pad_fill(name, (cap - arr.shape[0],) + arr.shape[1:], "cpu").numpy()
        return torch.from_numpy(np.concatenate([arr, fill], axis=0)).to(device)

    return pad


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    max_sh_degree: int = 3,
    spatial_lr_scale: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Gaussians:
    """Point-cloud initialization (upstream create_from_pcd) on `device`
    (CUDA unless named): SH dc from RGB, isotropic log-scale from the mean
    3-NN distance, identity rotations, opacity = logit(0.1). Built in numpy
    on the host, as the reference builds it, then moved in one copy a leaf."""
    device = resolve_device(device)
    n = len(points)
    if n > capacity:
        raise ValueError(f"{n} init points exceed capacity {capacity}")
    pts = np.asarray(points, np.float32)
    f_dc = np.asarray(rgb2sh(np.asarray(colors, np.float64)), np.float32)
    m = num_sh_coeffs(max_sh_degree) - 1
    f_rest = np.zeros((n, m, 3), np.float32)

    dist2 = np.maximum(np.asarray(_mean_knn_dist2(np.asarray(points, np.float64))), 1e-7)
    scaling = np.repeat(
        np.log(np.sqrt(dist2))[:, None], 3, axis=1
    ).astype(np.float32)
    rotation = np.zeros((n, 4), np.float32)
    rotation[:, 0] = 1.0
    opacity = np.full((n, 1), np.log(0.1 / 0.9), np.float32)  # logit(0.1)

    pad = _pad_rows(capacity, device)
    zeros = torch.zeros(capacity, dtype=torch.float32, device=device)
    return Gaussians(
        xyz=pad("xyz", pts),
        f_dc=pad("f_dc", f_dc),
        f_rest=pad("f_rest", f_rest),
        opacity=pad("opacity", opacity),
        scaling=pad("scaling", scaling),
        rotation=pad("rotation", rotation),
        max_radii2D=zeros,
        xyz_gradient_accum=zeros.clone(),
        denom=zeros.clone(),
        n_live=torch.tensor(n, dtype=torch.int32, device=device),
        active_sh_degree=0,
        max_sh_degree=max_sh_degree,
        spatial_lr_scale=float(spatial_lr_scale),
    )


def _mean_knn_dist2(points: np.ndarray) -> np.ndarray:
    """Mean squared distance to the 3 nearest neighbors (upstream simple-knn
    `distCUDA2` semantics), via scipy cKDTree on the host."""
    if len(points) <= 3:
        return np.full(len(points), 1e-4, np.float32)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    dists, _ = tree.query(points, k=4)  # first col is self (0)
    return ((dists[:, 1:] ** 2).mean(axis=1)).astype(np.float32)


def grow_capacity(g: Gaussians, new_capacity: int) -> Gaussians:
    """Re-pad every leaf to a larger capacity on the tensors' own device:
    the parameters with the inert rows, the accumulators with zeros. Nothing
    goes through the host."""
    assert new_capacity >= g.capacity
    extra = new_capacity - g.capacity

    def pad(name: str, a: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, pad_fill(name, (extra,) + tuple(a.shape[1:]), a.device)])

    out = g.replace(**{k: pad(k, getattr(g, k)) for k in PARAM_KEYS + (
        "max_radii2D", "xyz_gradient_accum", "denom")})
    if g.mip:
        out = out.replace(filter_3d=pad("filter_3d", g.filter_3d))
    return out
