"""The model and the camera batch placed over the mesh.

Port of gsplat_tpu/dist/data.py, one process a mesh cell: a rank feeds the
camera of its own data row, holds the whole model (replicated) or its row
block of every (CAP, ...) leaf (sharded over `data`, the ZeRO layout of
spmd.make_sharded_spmd_train_step), and `gather_gaussians` undoes the
sharding (the JAX loop's to_host_view; `shard_gaussians` its
to_step_view).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from gsplat_tpu_torch.core.camera import Camera
from gsplat_tpu_torch.core.gaussians import Gaussians
from gsplat_tpu_torch.dist import collectives as C
from gsplat_tpu_torch.dist.mesh import Mesh
from gsplat_tpu_torch.train.optim import AdamState

# every (CAP, ...) leaf of Gaussians
ROW_LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
              "max_radii2D", "xyz_gradient_accum", "denom")


def global_camera_batch(mesh: Mesh, picks: List[Camera]) -> Camera:
    """The step's camera batch from the data-axis picks every rank drew
    alike: every row's matrices (the sharded step projects its shard for
    each camera) and this rank's own target image, picks[d], as a (1, H, W,
    3) image leaf (spmd.own_image reads it)."""
    from gsplat_tpu_torch.dist.spmd import stack_cameras

    if len(picks) != mesh.data:
        raise ValueError(f"{len(picks)} cameras for a data axis of {mesh.data}")
    batch = stack_cameras(picks, images=False)
    own = picks[mesh.d].image
    return batch.__class__(**{**vars(batch), "image": None if own is None else own[None]})


def _checksum(tensors) -> torch.Tensor:
    """(2,) int64 checksum of the tensors' bits, on their device."""
    total = None
    for x in tensors:
        bits = x.detach().contiguous().view(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(1, bits.numel() + 1, dtype=torch.int64, device=bits.device) % 65521
        s = torch.stack([bits.sum(), (bits * (w + 1)).sum()])
        total = s if total is None else total * 31 + s
    return total


def _leaves(g: Gaussians, opt_state: Optional[AdamState]):
    out = [getattr(g, k) for k in ROW_LEAVES] + [g.n_live]
    if opt_state is not None:
        out += [opt_state.mu[k] for k in sorted(opt_state.mu)]
        out += [opt_state.nu[k] for k in sorted(opt_state.nu)]
        out += [opt_state.count]
    return out


def replicate_gaussians(mesh: Mesh, g: Gaussians, opt_state: Optional[AdamState] = None):
    """Check that every rank holds the same model (and Adam state) bit for
    bit: one all-gather of a checksum of every leaf; raises on a mismatch.
    Returns its inputs (each rank already holds the whole model)."""
    ck = _checksum(_leaves(g, opt_state))
    every = C.all_gather_rows(ck[None], mesh.world_group)
    bad = [r for r in range(every.shape[0]) if not torch.equal(every[r], every[0])]
    if bad:
        raise RuntimeError(f"replicated model differs from rank 0's on rank(s) {bad}")
    return g if opt_state is None else (g, opt_state)


def shard_rows(mesh: Mesh, capacity: int) -> slice:
    """Rank d's rows of a sharded (capacity, ...) leaf."""
    if capacity % mesh.data:
        raise ValueError(f"sharded Gaussians need capacity % data_axis == 0 "
                         f"(got {capacity} % {mesh.data})")
    n = capacity // mesh.data
    return slice(mesh.d * n, (mesh.d + 1) * n)


def shard_gaussians(mesh: Mesh, g: Gaussians, opt_state: Optional[AdamState] = None):
    """Keep rows [d*cap/n_data, (d+1)*cap/n_data) of every (CAP, ...) leaf
    of the model (and of each Adam moment); n_live and the step count stay
    whole. Rows are copied, so the full tensors can be freed."""
    sl = shard_rows(mesh, g.capacity)
    gs = g.replace(**{k: getattr(g, k)[sl].clone() for k in ROW_LEAVES})
    if opt_state is None:
        return gs
    return gs, AdamState(mu={k: v[sl].clone() for k, v in opt_state.mu.items()},
                         nu={k: v[sl].clone() for k, v in opt_state.nu.items()},
                         count=opt_state.count)


def gather_gaussians(mesh: Mesh, g: Gaussians, opt_state: Optional[AdamState] = None):
    """Undo shard_gaussians on every rank: each leaf's row blocks gathered
    over the data axis in row order (a collective: every rank calls it)."""
    full = g.replace(**{k: C.all_gather_rows(getattr(g, k), mesh.data_group)
                        for k in ROW_LEAVES})
    if opt_state is None:
        return full
    return full, AdamState(
        mu={k: C.all_gather_rows(v, mesh.data_group) for k, v in opt_state.mu.items()},
        nu={k: C.all_gather_rows(v, mesh.data_group) for k, v in opt_state.nu.items()},
        count=opt_state.count)
