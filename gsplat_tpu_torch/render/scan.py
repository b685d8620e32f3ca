"""Inclusive prefix sum of small non-negative int32 values.

The wrapper of the CUDA kernel csrc/prefix_sum_small.cu, which replaces the
TPU kernel gsplat_tpu/render/scan_pallas.py::_scan_kernel, beside its plain
PyTorch version. `prefix_sum_small` launches the kernel for CUDA tensors (or
raises) and runs the plain version only for CPU tensors. The reference's
fallback to `jnp.cumsum` for short or non-128-multiple inputs was a TPU
launch-cost and tiling shortcut: the kernel takes any length, and any
start address (a slice not 16-byte aligned takes its scalar loads). A call
is one memset of the kernel's scratch (a status word a tile and a tile
counter) and one kernel launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gsplat_tpu_torch import _build

# The binning's 6-bit quanta sum exactly in int32 while n < 2^25:
# 63 * 2^25 < 2^31 (binning.py:427-428 of the reference)
MAX_LEN = 1 << 25


def prefix_sum_small_plain(x: torch.Tensor, bias: int = 0,
                           clip_hi: Optional[int] = None) -> torch.Tensor:
    """(n,) int32 values in [0, 255] -> (n,) int32 inclusive cumsum + bias,
    clipped to [0, clip_hi] when clip_hi is given."""
    out = torch.cumsum(x, 0, dtype=torch.int32) + bias
    if clip_hi is not None:
        out = torch.clamp(out, 0, clip_hi)
    return out.to(torch.int32)


_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 3)


def prefix_sum_small(x: torch.Tensor, bias: int = 0,
                     clip_hi: Optional[int] = None) -> torch.Tensor:
    """prefix_sum_small_plain's function; bit-equal to it."""
    n = x.shape[0]
    if n >= MAX_LEN:
        raise ValueError(f"prefix_sum_small takes n < 2^25 (63 * 2^25 < 2^31 keeps "
                         f"a sum of 6-bit quanta exact in int32), got {n}")
    if x.device.type == "cpu":
        return prefix_sum_small_plain(x, bias, clip_hi)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_sum_small runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("prefix_sum_small needs a contiguous int32 (n,) tensor")
    lib = _build.load("prefix_sum_small")
    lib.prefix_sum_small_scratch_bytes.argtypes = [ctypes.c_int]
    lib.prefix_sum_small_scratch_bytes.restype = ctypes.c_longlong
    # the tile status words and the tile counter, zeroed by the launch itself
    scratch = torch.empty(lib.prefix_sum_small_scratch_bytes(n) // 8, dtype=torch.int64,
                          device=x.device)
    out = torch.empty_like(x)
    fn = lib.prefix_sum_small_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), n, int(bias), int(clip_hi is not None),
                 int(clip_hi) if clip_hi is not None else 0, scratch.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "prefix_sum_small launch")
    prefix_sum_small.launches += 1
    return out


prefix_sum_small.launches = 0
