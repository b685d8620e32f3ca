"""Per-Gaussian segment ends in the gid-sorted key row of the d-table.

The wrapper of the CUDA kernel csrc/segment_ends.cu, which replaces the TPU
kernel gsplat_tpu/render/bounds_pallas.py::_ends_kernel, beside its plain
PyTorch version. `segment_ends` launches the kernel for CUDA tensors (or
raises) and runs the plain version only for CPU tensors. The TPU kernel's
n % 1024 == 0 restriction was a tiling rule of that machine and is gone.
"""

from __future__ import annotations

import ctypes

import torch

from gsplat_tpu_torch import _build


def segment_ends_plain(key_s: torch.Tensor, n: int) -> torch.Tensor:
    """(P,) float32 sorted integer-valued gid keys -> (n,) int32
    ends[g] = #{key_s < g + 1}."""
    q = torch.arange(1, n + 1, device=key_s.device).to(torch.float32)
    return torch.searchsorted(key_s, q, side="left").to(torch.int32)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]


def segment_ends(key_s: torch.Tensor, n: int) -> torch.Tensor:
    """(P,) float32 sorted keys -> (n,) int32 ends (segment_ends_plain's
    function)."""
    if key_s.device.type == "cpu":
        return segment_ends_plain(key_s, n)
    if key_s.device.type != "cuda":
        raise ValueError(f"segment_ends runs on cuda or cpu, not {key_s.device}")
    if key_s.dtype != torch.float32 or key_s.dim() != 1 or not key_s.is_contiguous():
        raise ValueError("segment_ends needs a contiguous float32 (P,) key row")
    if key_s.shape[0] >= 1 << 31:
        raise ValueError("segment_ends counts rows in int32")
    ends = torch.empty(n, dtype=torch.int32, device=key_s.device)
    lib = _build.load("segment_ends")
    fn = lib.segment_ends_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(key_s.device):
        err = fn(key_s.data_ptr(), key_s.shape[0], n, ends.data_ptr(),
                 torch.cuda.current_stream(key_s.device).cuda_stream)
    _build.check(lib, err, "segment_ends launch")
    segment_ends.launches += 1
    return ends


segment_ends.launches = 0
