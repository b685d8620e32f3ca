"""The mesh's collectives, and the two the steps differentiate through.

Each helper runs one torch.distributed collective over a process group of
the mesh (the identity where the group is None: no process group). The
tensor goes where the group's backend takes it (`wire_device`) and the
result comes back to the caller's device: under gloo (the CPU, or ranks
sharing one card, mesh.py's rule) a CUDA tensor is copied to a host tensor,
under nccl a host tensor to this rank's card. `comm` counts the calls and
the payload bytes of each named collective (a rank's input tensor), for
the steps' accounting.

`reduce_sum_fixed` is the steps' gradient reduction: a sum whose order of
additions the caller fixes, so that every rank, every run and both steps
(replicated and sharded) add the same numbers in the same order, whatever
the backend's algorithm.

`BandGather` and `AllToAll` are autograd Functions of the port's own (not
torch.distributed.nn, whose all-gather backward is a reduce_scatter):
- BandGather: forward all-gathers the tile row's bands into the full
  image; backward hands each rank its own band of the cotangent, times
  `scale`. The steps pass scale = 1 / n_data, so that the parameter
  gradients summed over the world equal the gradient of the mean loss over
  the camera batch (the JAX step's pmean over the mesh and the psum_scatter
  its all_gather transposes to).
- AllToAll: forward sends block c of a (n, rows, ...) tensor to rank c of
  the group and concatenates what it receives in rank order; backward is
  the inverse exchange of the cotangent.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable

import torch
import torch.distributed as dist

comm = defaultdict(lambda: {"calls": 0, "bytes": 0})


def reset_comm() -> None:
    comm.clear()


def _count(name: str, t: torch.Tensor) -> None:
    comm[name]["calls"] += 1
    comm[name]["bytes"] += t.numel() * t.element_size()


def wire_device(group) -> torch.device:
    """Where the group's backend takes its tensors: this rank's card (the
    current CUDA device) under nccl, host memory under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def fold_rows(x) -> torch.Tensor:
    """x[0] + x[1] + ... + x[n-1] (a tensor's rows or a list), added left
    to right."""
    acc = x[0].clone()
    for i in range(1, len(x)):
        acc += x[i]
    return acc


def reduce_sum_fixed(t: torch.Tensor, group, fold: Callable = fold_rows,
                     name: str = "reduce_sum") -> torch.Tensor:
    """Sum of t over the group, added in an order `fold` fixes (default:
    group rank order): an all-to-all hands rank j block j of every rank's
    flattened t, (n, block) rows in group rank order; fold(rows) sums them;
    an all-gather puts the summed blocks back together. Every rank gets the
    same bits, in all_reduce's traffic (each rank sends and receives
    (n - 1) / n of t twice)."""
    if group is None:
        _count(name, t)
        return t.detach().clone()
    n = dist.get_world_size(group)
    flat = t.detach().reshape(-1)
    per = -(-flat.numel() // n)
    if per * n != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(per * n - flat.numel())])
    rows = all_to_all_rows(flat.view(n, per, 1), group, name).view(n, per)
    summed = all_gather_rows(fold(rows), group, name)
    return summed[:t.numel()].view(t.shape)


def all_gather_rows(t: torch.Tensor, group, name: str = "all_gather") -> torch.Tensor:
    """Every rank's t concatenated along dim 0 in group rank order."""
    _count(name, t)
    if group is None:
        return t.detach().clone()
    n = dist.get_world_size(group)
    src = t.detach().contiguous().to(wire_device(group))
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0).to(t.device)


def all_to_all_rows(t: torch.Tensor, group, name: str = "all_to_all") -> torch.Tensor:
    """t (n, rows, ...): block c goes to group rank c; the blocks received
    from ranks 0..n-1, concatenated along dim 0 -> (n * rows, ...)."""
    _count(name, t)
    if group is None:
        return t.detach().reshape((-1,) + tuple(t.shape[2:])).clone()
    n = dist.get_world_size(group)
    if t.shape[0] != n:
        raise ValueError(f"all_to_all of {t.shape[0]} blocks over {n} ranks")
    src = t.detach().contiguous().to(wire_device(group))
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.reshape((-1,) + tuple(t.shape[2:])).to(t.device)


class BandGather(torch.autograd.Function):
    """(band_h, W, C) band of tile rank t -> (n_tile * band_h, W, C) image."""

    @staticmethod
    def forward(ctx, band, group, t, scale):
        ctx.band_h, ctx.t, ctx.scale = band.shape[0], t, scale
        return all_gather_rows(band, group, "band_gather")

    @staticmethod
    def backward(ctx, g_full):
        h = ctx.band_h
        g = g_full[ctx.t * h:(ctx.t + 1) * h]
        if ctx.scale != 1.0:
            g = g * ctx.scale
        return g.contiguous(), None, None, None


class AllToAll(torch.autograd.Function):
    """(n, rows, k) -> (n * rows, k) over the group; backward: the inverse
    exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n, ctx.rows = group, x.shape[0], x.shape[1]
        return all_to_all_rows(x, group, "all_to_all")

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().reshape((ctx.n, ctx.rows) + tuple(g.shape[1:]))
        back = all_to_all_rows(g, ctx.group, "all_to_all_backward")
        return back.reshape((ctx.n, ctx.rows) + tuple(g.shape[2:])), None
