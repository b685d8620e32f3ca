"""The backward's per-Gaussian gradient reduction over the gid-sorted d-table.

The wrapper of the CUDA kernel csrc/segment_sum.cu, beside its plain
PyTorch version. `segment_sum` launches the kernel for CUDA tensors (or
raises) and runs the plain version only for CPU tensors. It replaces the
reference's float32 cumsum table and adjacent difference
(gsplat_tpu/render/render.py::_rasterize_bwd): each Gaussian's rows are
summed directly, in float64, in an order that depends on the data alone,
and rounded to float32 once, so the card gives the same bits on every call.
"""

from __future__ import annotations

import ctypes

import torch

from gsplat_tpu_torch import _build
from gsplat_tpu_torch.render.raster import ATTR_DIM, N_DCOLS


def segment_sum_plain(d: torch.Tensor, perm: torch.Tensor, ends: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """(c, 16) float32 d-table, (c,) int64 permutation that sorts its key
    column, (n,) int32 segment ends in that order (n < n_rows) -> (n_rows,
    16) float32: row g < n holds the float64 sum, rounded once, of the first
    nine columns of the rows at sorted positions [ends[g - 1], ends[g]);
    the other rows and columns are zero. A float64 index_add_, which on the
    CPU adds each Gaussian's rows in sorted order."""
    n = ends.shape[0]
    e = ends.to(torch.int64)
    live = int(e[-1]) if n else 0
    lengths = torch.diff(e, prepend=e.new_zeros(1))
    seg = torch.repeat_interleave(torch.arange(n, device=d.device), lengths)
    rows = d.index_select(0, perm[:live])[:, :N_DCOLS].to(torch.float64)
    acc = torch.zeros((n_rows, N_DCOLS), dtype=torch.float64, device=d.device)
    acc.index_add_(0, seg, rows)
    out = d.new_zeros((n_rows, ATTR_DIM))
    out[:, :N_DCOLS] = acc.to(torch.float32)
    return out


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


def segment_sum(d: torch.Tensor, perm: torch.Tensor, ends: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """segment_sum_plain's function: (c, 16) d-table, (c,) int64 sort
    permutation, (n,) int32 ends -> (n_rows, 16) per-Gaussian sums."""
    if d.device.type == "cpu":
        return segment_sum_plain(d, perm, ends, n_rows)
    if d.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {d.device}")
    if d.dtype != torch.float32 or d.dim() != 2 or d.shape[1] != ATTR_DIM \
            or not d.is_contiguous() or d.data_ptr() % 16:
        raise ValueError("segment_sum needs a contiguous, 16-byte aligned float32 "
                         "(c, 16) d-table")
    if perm.dtype != torch.int64 or perm.shape != (d.shape[0],) \
            or not perm.is_contiguous() or perm.device != d.device:
        raise ValueError("segment_sum needs the contiguous int64 (c,) sort permutation "
                         "on the table's device")
    if ends.dtype != torch.int32 or ends.dim() != 1 or not ends.is_contiguous() \
            or ends.device != d.device or ends.shape[0] >= n_rows:
        raise ValueError("segment_sum needs contiguous int32 (n,) ends on the table's "
                         "device, n < n_rows")
    if d.shape[0] >= 1 << 31 or n_rows >= 1 << 31:
        raise ValueError("segment_sum counts rows in int32")
    out = torch.empty((n_rows, ATTR_DIM), dtype=torch.float32, device=d.device)
    lib = _build.load("segment_sum")
    fn = lib.segment_sum_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(d.device):
        err = fn(d.data_ptr(), perm.data_ptr(), ends.data_ptr(), ends.shape[0], n_rows,
                 out.data_ptr(), torch.cuda.current_stream(d.device).cuda_stream)
    _build.check(lib, err, "segment_sum launch")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
