"""Checkpoint / resume and PLY export.

Port of gsplat_tpu/ckpt.py: one .npz a checkpoint, with the JAX package's
keys and layout (the Gaussian leaves and the Adam moments cropped to the
live rows, the step, the SH degrees, spatial_lr_scale, capacity and the Adam
count, and the training loop's resume state under `extra_*` keys), so a
checkpoint written by either package loads in the other; and the standard
3DGS `point_cloud.ply` layout.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.core.gaussians import PARAM_KEYS, Gaussians, _pad_rows
from gsplat_tpu_torch.io.ply import save_gaussian_ply
from gsplat_tpu_torch.scene import _next_pow2
from gsplat_tpu_torch.train.optim import AdamState


def _host(a: torch.Tensor, n: int) -> np.ndarray:
    return a[:n].detach().cpu().numpy()


def save_checkpoint(path: Union[str, Path], g: Gaussians, opt_state: AdamState,
                    step: int, extra: Optional[dict] = None) -> None:
    """`extra`: the training loop's state for an exact resume (generator
    state, camera-order cursor, EMA loss, budgets, ...) stored under
    `extra_*` keys; read back with load_checkpoint_extras."""
    n = int(g.n_live)
    arrays = {
        "step": np.asarray(step, np.int64),
        "active_sh_degree": np.asarray(g.active_sh_degree, np.int64),
        "max_sh_degree": np.asarray(g.max_sh_degree, np.int64),
        "spatial_lr_scale": np.asarray(g.spatial_lr_scale, np.float64),
        "capacity": np.asarray(g.capacity, np.int64),
        **{k: _host(getattr(g, k), n) for k in PARAM_KEYS},
        "max_radii2D": _host(g.max_radii2D, n),
        "xyz_gradient_accum": _host(g.xyz_gradient_accum, n),
        "denom": _host(g.denom, n),
        "adam_count": np.asarray(int(opt_state.count), np.int32),
    }
    for k, v in opt_state.mu.items():
        arrays[f"mu_{k}"] = _host(v, n)
    for k, v in opt_state.nu.items():
        arrays[f"nu_{k}"] = _host(v, n)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, **arrays)


def load_checkpoint_extras(path: Union[str, Path]) -> dict:
    """The training loop's resume state saved with save_checkpoint(extra=...);
    {} for checkpoints written without it."""
    z = np.load(path)
    return {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}


def load_checkpoint(path: Union[str, Path], capacity: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[Gaussians, AdamState, int]:
    """Restore (gaussians, opt_state, step) on `device` (CUDA unless named),
    padded to max(capacity, the saved capacity, next_pow2(n)): the capacity
    the run had grown to, since densify's overflow depends on it."""
    device = resolve_device(device)
    z = np.load(path)
    n = len(z["xyz"])
    saved_cap = int(z["capacity"]) if "capacity" in z.files else 0
    cap = max(capacity, saved_cap, _next_pow2(n))
    pad = _pad_rows(cap, device)

    def zpad(a):
        out = torch.zeros((cap,) + a.shape[1:], dtype=torch.float32, device=device)
        out[:n] = torch.from_numpy(np.asarray(a, np.float32)).to(device)
        return out

    g = Gaussians(
        **{k: pad(k, z[k]) for k in PARAM_KEYS},
        max_radii2D=zpad(z["max_radii2D"]),
        xyz_gradient_accum=zpad(z["xyz_gradient_accum"]),
        denom=zpad(z["denom"]),
        n_live=torch.tensor(n, dtype=torch.int32, device=device),
        active_sh_degree=int(z["active_sh_degree"]),
        max_sh_degree=int(z["max_sh_degree"]),
        spatial_lr_scale=float(z["spatial_lr_scale"]),
    )
    opt = AdamState(
        mu={k: zpad(z[f"mu_{k}"]) for k in PARAM_KEYS},
        nu={k: zpad(z[f"nu_{k}"]) for k in PARAM_KEYS},
        count=torch.tensor(int(z["adam_count"]), dtype=torch.int32, device=device),
    )
    return g, opt, int(z["step"])


def save_ply(path: Union[str, Path], g: Gaussians) -> None:
    """Standard 3DGS point_cloud.ply of the live rows (upstream save_ply),
    with a Mip-Splatting model's 3D filter."""
    n = int(g.n_live)
    save_gaussian_ply(path, xyz=_host(g.xyz, n), features_dc=_host(g.f_dc, n),
                      features_rest=_host(g.f_rest, n), opacity=_host(g.opacity, n),
                      scaling=_host(g.scaling, n), rotation=_host(g.rotation, n),
                      filter_3d=_host(g.filter_3d, n) if g.mip else None)
