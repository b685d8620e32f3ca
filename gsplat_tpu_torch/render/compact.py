"""Run compaction: copy each tile's run of the sorted pair array into its
packed region, the null value everywhere else.

The wrapper of the CUDA kernel csrc/compact_runs.cu, which replaces the TPU
kernel gsplat_tpu/render/compact_pallas.py::_compact_kernel, beside its
plain PyTorch version. `compact_runs` launches the kernel for CUDA tensors
(or raises) and runs the plain version only for CPU tensors. Starts and
lengths are in pairs (the reference's kernel took 128-pair rows), so the
same kernel serves any chunk size.

The plain version is the reference's XLA form (binning.py:556-570): a
source map over the output rows, src(o) = o + astart_t - rbase_t for the
region t that holds o, telescoped as deltas scattered at the region starts
and one cumsum, then one index_select. Rows no region covers (and rows
whose source lies outside src) hold `fill`; the reference's src map left
its own rows there instead, which nothing reads. On the binning's overflow
the regions past the budget are clamped to end at it and overlap: the
first of them covers every row past the packed prefix, so a row that one
region covers still maps to that region's source, and a row several cover
holds what the reference's telescope gives it (the kernel writes either
region's value there; nothing reads it).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gsplat_tpu_torch import _build


def compact_runs_plain(src: torch.Tensor, astart: torch.Tensor, rbase: torch.Tensor,
                       length: torch.Tensor, out_size: int, fill: int) -> torch.Tensor:
    """src (S,) int32; astart, rbase, length (T,) int32 with the regions
    [rbase_t, rbase_t + length_t) in ascending order and disjoint, or
    clamped as the binning clamps them on overflow ->
    (out_size,) int32 out[rbase_t + j] = src[astart_t + j] in every row one
    region covers, `fill` in every row none covers."""
    dev = src.device
    starts = torch.clamp(rbase.to(torch.int64), 0, out_size)
    ends = torch.clamp(rbase.to(torch.int64) + length.to(torch.int64), 0, out_size)
    ones = torch.ones_like(starts)
    cover = torch.zeros(out_size + 1, dtype=torch.int64, device=dev)
    cover.index_add_(0, starts, ones).index_add_(0, ends, -ones)
    covered = torch.cumsum(cover, 0)[:out_size] > 0
    offs = astart.to(torch.int64) - rbase.to(torch.int64)
    delta = torch.cat([offs[:1], offs[1:] - offs[:-1]])
    src_off = torch.zeros(out_size + 1, dtype=torch.int64, device=dev)
    src_off.index_add_(0, starts, delta)
    idx = torch.arange(out_size, dtype=torch.int64, device=dev) \
        + torch.cumsum(src_off, 0)[:out_size]
    valid = covered & (idx >= 0) & (idx < src.shape[0])
    gathered = src.index_select(0, torch.clamp(idx, 0, src.shape[0] - 1))
    return torch.where(valid, gathered, torch.full_like(gathered, fill))


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)


def compact_runs(src: torch.Tensor, astart: torch.Tensor, rbase: torch.Tensor,
                 length: torch.Tensor, out_size: int, fill: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """compact_runs_plain's function. On the card one launch writes every
    row of the output once: each block copies its region and fills the gap
    to the next, all blocks the rows before the first region and after the
    last. Where regions overlap (a clamped budget overflow) those rows hold
    either region's value. `out`, a contiguous (out_size,) int32 tensor on
    src's device, is written in place of a new one (the tests poison it to
    show that no row is left unwritten)."""
    if src.device.type == "cpu":
        got = compact_runs_plain(src, astart, rbase, length, out_size, fill)
        return got if out is None else out.copy_(got)
    if src.device.type != "cuda":
        raise ValueError(f"compact_runs runs on cuda or cpu, not {src.device}")
    if src.dtype != torch.int32 or src.dim() != 1 or not src.is_contiguous():
        raise ValueError("compact_runs needs a contiguous int32 (S,) source")
    tables = [t.to(device=src.device, dtype=torch.int32).contiguous()
              for t in (astart, rbase, length)]
    num_tiles = tables[0].shape[0]
    if any(t.shape != (num_tiles,) for t in tables):
        raise ValueError("astart, rbase and length must be (T,) each")
    if out is None:
        out = torch.empty((out_size,), dtype=torch.int32, device=src.device)
    elif (out.dtype != torch.int32 or out.shape != (out_size,) or not out.is_contiguous()
          or out.device != src.device):
        raise ValueError(f"out must be a contiguous int32 ({out_size},) tensor on {src.device}")
    if out_size == 0:
        return out
    aligned = src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    lib = _build.load("compact_runs")
    fn = lib.compact_runs_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), src.shape[0], *(t.data_ptr() for t in tables),
                 num_tiles, out_size, int(fill), int(aligned), out.data_ptr(),
                 torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(lib, err, "compact_runs launch")
    compact_runs.launches += 1
    return out


compact_runs.launches = 0
