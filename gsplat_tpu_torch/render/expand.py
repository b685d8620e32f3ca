"""Pair expansion: per-Gaussian column table -> per-slot (sort key, gid).

The wrapper of the CUDA kernel csrc/expand_pairs.cu, which replaces the TPU
kernel gsplat_tpu/render/expand_pallas.py::_expand_kernel, beside its plain
PyTorch version. `expand_pairs` launches the kernel for CUDA tensors (or
raises) and runs the plain version only for CPU tensors.

The plain version is binning._expand_xla's arithmetic, in the same order,
applied to the kernel's input: the live-compacted table built by
binning.expansion_table. Its row lookup (a searchsorted of the offset
column) finds the row the kernel finds by its merge-path partition: the
last row whose pair offset is at most the slot.

With `sat_pack` (the saturation bound cull, which needs the cull columns)
every kept slot's gid carries its 6-bit saturation quantum in the low bits,
gid << 6 | q, and null slots carry n << 6: the quantum rides the pair sort
with gid still the leading tie-break (binning.py:264-277 of the reference).
"""

from __future__ import annotations

import ctypes

import torch

from gsplat_tpu_torch import _build
from gsplat_tpu_torch.render.raster import ALPHA_MIN

# tight-cull threshold: 2% slack keeps any pair f32 rounding could misprice
ALPHA_THRESH = ALPHA_MIN * 0.98

# columns of the (NC, n) table (binning.expansion_table)
COL_OFF, COL_X0Y0, COL_W, COL_DQ, COL_GID = range(5)
COL_MX, COL_MY, COL_CA, COL_CB, COL_CC, COL_OP = range(5, 11)

# saturation bound cull: q counts -log2(1 - alpha_min) in units of
# SAT_Q_SCALE, 6 bits under the gid; cum_q * SAT_Q_SCALE > -log2(T_EPS =
# 1e-4) = 13.2877 proves the whole-tile exit, i.e. cum_q >= SAT_CUT
SAT_Q_SCALE = 0.25
SAT_Q_BITS = 6
SAT_CUT = 54
_LOG2E = 1.4426950408889634


def key_invalid(num_tiles: int, db: int) -> int:
    """Sort key of an invalid or culled slot: tile num_tiles (past every real
    tile) with the quantized depth of +inf, as binning.pack_sort_key makes it."""
    return (num_tiles << db) | min(0x7F800000 >> (32 - db), (1 << db) - 1)


def rect_min_q(a, b, c, lx, hx, ly, hy):
    """Exact min over the box [lx,hx]x[ly,hy] of the PSD quadratic
    Q(d) = 0.5*a*dx^2 + b*dx*dy + 0.5*c*dy^2 (box relative to the splat
    mean): 0 when the mean lies inside, else the least of the four edges'
    clamped 1-D minima. The pair's max alpha in the tile is op*exp(-minQ)."""
    inside = (lx <= 0.0) & (hx >= 0.0) & (ly <= 0.0) & (hy >= 0.0)
    a_s = torch.clamp(a, min=1e-12)
    c_s = torch.clamp(c, min=1e-12)

    def edge_x(e):
        dy = torch.minimum(torch.maximum(-b * e / c_s, ly), hy)
        return 0.5 * a * e * e + b * e * dy + 0.5 * c * dy * dy

    def edge_y(e):
        dx = torch.minimum(torch.maximum(-b * e / a_s, lx), hx)
        return 0.5 * a * dx * dx + b * dx * e + 0.5 * c * e * e

    m = torch.minimum(
        torch.minimum(edge_x(lx), edge_x(hx)), torch.minimum(edge_y(ly), edge_y(hy))
    )
    return torch.where(inside, torch.zeros_like(m), torch.clamp(m, min=0.0))


def rect_max_q(a, b, c, lx, hx, ly, hy):
    """Exact max over the box [lx,hx]x[ly,hy] of the PSD quadratic Q (convex:
    the largest of the four corners). alpha_min = op * exp(-maxQ) bounds
    every pixel's alpha in the tile from below."""
    def q(dx, dy):
        return 0.5 * a * dx * dx + b * dx * dy + 0.5 * c * dy * dy

    return torch.maximum(torch.maximum(q(lx, ly), q(lx, hy)),
                         torch.maximum(q(hx, ly), q(hx, hy)))


def sat_q(op, max_q):
    """6-bit quantized -log2(1 - alpha_min), rounded down (conservative).
    The 2% slack absorbs f32 rounding against the compositor's per-pixel
    alpha; alpha_min below the 1/255 skip threshold counts 0."""
    raw_min = op * torch.exp(-max_q) * 0.98
    alpha_min = torch.where(raw_min >= 1.0 / 255.0, torch.clamp(raw_min, max=0.99),
                            torch.zeros_like(raw_min))
    lb = -torch.log1p(-alpha_min) * _LOG2E
    q = torch.floor(lb * (1.0 / SAT_Q_SCALE)).to(torch.int32)
    return torch.clamp(q, 0, (1 << SAT_Q_BITS) - 1)


def pack_gid(gid, q):
    """gid << 6 | q: gid < 2^24 keeps the packed value a non-negative int32."""
    return (gid << SAT_Q_BITS) | q


def unpack_gid(packed):
    """The gid of a packed value: a LOGICAL shift right by 6 (the reference's
    shift_right_logical; torch's >> on int32 is arithmetic, so the copied
    sign bits are masked off)."""
    return (packed >> SAT_Q_BITS) & ((1 << (32 - SAT_Q_BITS)) - 1)


def expand_pairs_plain(table, total, S, *, tw, tile_size, db, num_tiles,
                       n_orig, do_cull, sat_pack=False):
    """Plain PyTorch version of the expand_pairs kernel (same signature)."""
    if sat_pack and not do_cull:
        raise ValueError("sat_pack needs the cull columns (do_cull)")
    dev = table.device
    p = torch.arange(S, dtype=torch.int32, device=dev)
    row = torch.searchsorted(table[COL_OFF].contiguous(), p, right=True) - 1
    pc = table[:, torch.clamp(row, min=0)]       # (NC, S) row gather
    local = p - pc[COL_OFF]
    w = pc[COL_W]
    tx = (pc[COL_X0Y0] & 0xFFFF) + local % w
    ty = (pc[COL_X0Y0] >> 16) + local // w
    valid = p < total
    if do_cull:
        def f32(c):
            return pc[c].contiguous().view(torch.float32)

        ts = float(tile_size)
        lx = tx.to(torch.float32) * ts - f32(COL_MX)
        ly = ty.to(torch.float32) * ts - f32(COL_MY)
        min_q = rect_min_q(f32(COL_CA), f32(COL_CB), f32(COL_CC),
                           lx, lx + (ts - 1.0), ly, ly + (ts - 1.0))
        valid = valid & (f32(COL_OP) * torch.exp(-min_q) >= ALPHA_THRESH)
    gid = pc[COL_GID]
    if sat_pack:
        max_q = rect_max_q(f32(COL_CA), f32(COL_CB), f32(COL_CC),
                           lx, lx + (ts - 1.0), ly, ly + (ts - 1.0))
        gid = pack_gid(gid, sat_q(f32(COL_OP), max_q))
    key = torch.where(valid, ((ty * tw + tx) << db) | pc[COL_DQ],
                      key_invalid(num_tiles, db))
    gid = torch.where(valid, gid, n_orig << SAT_Q_BITS if sat_pack else n_orig)
    return key.to(torch.int32), gid.to(torch.int32)


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3)


def expand_pairs(table, total, S, *, tw, tile_size, db, num_tiles, n_orig,
                 do_cull, sat_pack=False):
    """table (NC, n) int32 (binning.expansion_table), total () int32 live
    pair count -> (key, gid), each (S,) int32, in slot order; with sat_pack
    the gids carry their saturation quantum (gid << 6 | q)."""
    if table.device.type == "cpu":
        return expand_pairs_plain(
            table, total, S, tw=tw, tile_size=tile_size, db=db,
            num_tiles=num_tiles, n_orig=n_orig, do_cull=do_cull, sat_pack=sat_pack)
    if table.device.type != "cuda":
        raise ValueError(f"expand_pairs runs on cuda or cpu, not {table.device}")
    if sat_pack and not do_cull:
        raise ValueError("sat_pack needs the cull columns (do_cull)")
    nc, n = table.shape
    if table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError("expand_pairs needs a contiguous int32 (NC, n) table")
    if nc != (11 if do_cull else 5):
        raise ValueError(f"table has {nc} columns, want {11 if do_cull else 5}")
    if S + n >= 1 << 31:
        raise ValueError(f"{S} slots and {n} rows: the kernel's merged sequence "
                         "must stay below 2^31 items")
    total = total.to(device=table.device, dtype=torch.int32).reshape(())
    key = torch.empty(S, dtype=torch.int32, device=table.device)
    gid = torch.empty(S, dtype=torch.int32, device=table.device)
    lib = _build.load("expand_pairs")
    fn = lib.expand_pairs_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), n, total.data_ptr(), S, tw, tile_size, db,
                 n_orig, int(do_cull), int(sat_pack), ALPHA_THRESH, key_invalid(num_tiles, db),
                 key.data_ptr(), gid.data_ptr(),
                 torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, err, "expand_pairs launch")
    expand_pairs.launches += 1
    return key, gid


expand_pairs.launches = 0
