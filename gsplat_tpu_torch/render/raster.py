"""Tile compositing over the compact sorted pair layout, forward and backward.

The wrappers of the CUDA kernels csrc/composite_fwd.cu and
csrc/composite_bwd.cu, which replace the TPU kernels
gsplat_tpu/render/raster_pallas.py::_fwd_kernel and ::_bwd_kernel, beside
their plain PyTorch versions. `composite_fwd` and `composite_bwd` launch the
kernel for CUDA tensors (or raise) and run the plain version only for CPU
tensors.

Attribute row layout: (N+1, 16) float32, ROW-major, one 64-byte row per
Gaussian (row N the inert null Gaussian the padding slots point at; the
reference's (16, P) pair table transposed, so a pair's attributes are
contiguous for the kernel's staging load):
  0 mean_x | 1 mean_y | 2 conic_a | 3 conic_b | 4 conic_c | 5..7 rgb |
  8 opacity | 9 the row's gid as an f32 value | 10..15 zero.
The compositors take the rows and the (P,) int32 sorted gids and read pair
i's attributes as row gid[i]: no (P, 16) pair table is gathered. The
backward's d-table has the same row layout: d{mean x, mean y, conic a, b,
c, r, g, b, opacity} | the gid key | zero.

The packed rows (`attr_pack`, raster_pallas.py:238-304 of the reference):
(N+1, 8) float32, one 32-byte row per Gaussian:
  0 mean_x | 1 mean_y | 2 conic_a | 3 conic_b | 4 conic_c |
  5 (bf16(r) << 16) | bf16(g) | 6 (bf16(b) << 16) | bf16(opacity) |
  7 gid as an f32 value,
rgb and opacity rounded to bfloat16 (to nearest even). Both compositors
take either width, as the reference's _fwd_call does; the d-table keeps
its 16 columns, and the gradient passes straight through the rounding.
`GSPLAT_PACK` sets render's default, read at import: "0" (the default)
off, "1" on, "auto" packed for CUDA tensors and f32 on the CPU (the
reference's "packed unless interpret").
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from gsplat_tpu_torch import _build

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
ATTR_DIM = 16
# the gid rides row 9 as an f32 VALUE (exact below 2^24); the backward's
# invalid key sorts after every real id
KEY_INVALID = float(1 << 30)
KEY_COL = 9   # the gid column of the attribute rows and the key column of the d-table
N_DCOLS = 9   # d-table columns carrying gradients: mean2d(2) conic(3) rgb(3) opacity(1)
# the compositors' skip: a pair whose power lies below log(ALPHA_MIN / op)
# less this margin has alpha 0 at that pixel (skip_threshold)
SKIP_MARGIN = 1e-3
# tiles per step of the plain compositor at tiles up to 32 (fewer above):
# bounds its (tiles, chunk, pixels) temporaries to a few hundred MB at chunk 128
_PLAIN_TILE_BATCH = 256
# the kernels run a tile up to WINDOW in pixel passes (256 threads, each a
# 2x2 pixel block in each of up to four passes), a larger one in windows of
# at most WINDOW x WINDOW pixels (tile_windows)
WINDOW = 64
# the packed rows' width and their gid column
PACKED_IN_DIM = 8
PACKED_GID_COL = 7


def pack_default(env: str) -> Optional[bool]:
    """A GSPLAT_PACK value -> render's attr_pack default: "1" True, "auto"
    None (packed on CUDA tensors), anything else False (raster_pallas.py:
    258-259 of the reference)."""
    return None if env == "auto" else env == "1"


PACK_DEFAULT = pack_default(os.environ.get("GSPLAT_PACK", "0"))


def resolve_attr_pack(attr_pack: Optional[bool], device) -> bool:
    """render's attr_pack: as given, else GSPLAT_PACK's default, "auto"
    meaning packed on CUDA tensors and f32 on the CPU."""
    if attr_pack is None:
        attr_pack = PACK_DEFAULT
    if attr_pack is None:
        return torch.device(device).type == "cuda"
    return bool(attr_pack)


class LaunchCount:
    """A count of launches kept apart from its wrapper's own `launches`:
    the packed table's launches of composite_fwd and composite_bwd."""

    def __init__(self):
        self.launches = 0


packed_fwd_count = LaunchCount()
packed_bwd_count = LaunchCount()


def _plain_tile_batch(npix: int) -> int:
    return max(1, _PLAIN_TILE_BATCH * 1024 // max(npix, 1024))


def pack_attrs(mean2d, conic, rgb, opacity) -> torch.Tensor:
    """(N,2),(N,3),(N,3),(N,) -> (N,16) attribute rows; row 9 (gid) and the
    padding are zero here, the gid filled by render._gid_rows."""
    n = mean2d.shape[0]
    pad = torch.zeros((n, ATTR_DIM - 9), dtype=torch.float32, device=mean2d.device)
    return torch.cat([mean2d, conic, rgb, opacity[:, None], pad], dim=1).to(torch.float32)


def _u32_to_f32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the float32s with those bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def _pack_pair_cols(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two f32 columns -> one f32 column holding (bf16(hi) << 16) | bf16(lo),
    each rounded to the nearest bfloat16 (ties to even)."""
    def bits(x):
        return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF

    return _u32_to_f32((bits(hi) << 16) | bits(lo))


def _unpack_hi(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the bf16 in its upper 16 bits, as f32 (a bf16 is a truncated
    f32, so masking the low half is the value)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _unpack_lo(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the bf16 in its lower 16 bits, as f32."""
    return _u32_to_f32((x.view(torch.int32).to(torch.int64) & 0xFFFF) << 16)


def pack_attrs8(attrs: torch.Tensor) -> torch.Tensor:
    """(N, 16) attribute rows -> (N, 7) packed columns (the packed layout
    without its gid column): geometry f32, rgb and opacity as bf16 pairs."""
    rg = _pack_pair_cols(attrs[:, 5], attrs[:, 6])
    bo = _pack_pair_cols(attrs[:, 7], attrs[:, 8])
    return torch.cat([attrs[:, :5], rg[:, None], bo[:, None]], dim=1)


def unpack_rows(attrs: torch.Tensor) -> torch.Tensor:
    """Packed (R, 8) rows -> the (R, 16) rows of their values (rgb and
    opacity unpacked, the gid in column 9): what the compositors see."""
    rg, bo = attrs[:, 5], attrs[:, 6]
    out = attrs.new_zeros((attrs.shape[0], ATTR_DIM))
    out[:, :5] = attrs[:, :5]
    out[:, 5], out[:, 6] = _unpack_hi(rg), _unpack_lo(rg)
    out[:, 7], out[:, 8] = _unpack_hi(bo), _unpack_lo(bo)
    out[:, KEY_COL] = attrs[:, PACKED_GID_COL]
    return out


def _table_width(attrs: torch.Tensor, what: str) -> bool:
    """Check attribute rows for a kernel -> whether they are packed."""
    if attrs.dtype != torch.float32 or attrs.dim() != 2 \
            or attrs.shape[1] not in (ATTR_DIM, PACKED_IN_DIM) \
            or not attrs.is_contiguous() or attrs.data_ptr() % 16:
        raise ValueError(f"{what} needs contiguous, 16-byte aligned float32 (N+1, 16) "
                         f"or packed (N+1, 8) rows")
    return attrs.shape[1] == PACKED_IN_DIM


def _check_gids(gid: torch.Tensor, attrs: torch.Tensor, chunk: int, what: str) -> None:
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous() \
            or gid.device != attrs.device:
        raise ValueError(f"{what} needs contiguous (P,) int32 gids on the rows' device")
    if gid.shape[0] % chunk:
        raise ValueError(f"gids {gid.shape[0]} are not a multiple of chunk {chunk}")


def composite_fwd_plain(attrs, tile_start, tile_count, *, tw, tile_size, chunk, gid):
    """Plain PyTorch version of the composite_fwd kernel (same signature),
    over _PLAIN_TILE_BATCH tiles at a time, pair i's row read as
    attrs[gid[i]]. Within a chunk the exclusive transmittance is a cumprod
    of (1 - alpha) against the chunk's entry T, as in the reference. Packed
    (N+1, 8) rows composite their unpacked values."""
    if attrs.shape[1] == PACKED_IN_DIM:
        attrs = unpack_rows(attrs)
    dev = attrs.device
    num_tiles = tile_start.shape[0]
    npix = tile_size * tile_size
    h = tile_size // 2
    pix = torch.arange(npix, device=dev)
    px = (pix % tile_size - h).to(torch.float32)
    py = (pix // tile_size - h).to(torch.float32)
    lane = torch.arange(chunk, device=dev)
    tiles = torch.empty((num_tiles, 4, npix), dtype=torch.float32, device=dev)
    nproc = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    batch = _plain_tile_batch(npix)
    for b0 in range(0, num_tiles, batch):
        t = torch.arange(b0, min(b0 + batch, num_tiles), device=dev)
        start = tile_start[t].to(torch.int64)
        count = tile_count[t].to(torch.int64)
        astart = (start // chunk) * chunk
        head = start - astart
        nch = (head + count + chunk - 1) // chunk
        ox = ((t % tw) * tile_size + h).to(torch.float32)
        oy = ((t // tw) * tile_size + h).to(torch.float32)
        T = torch.ones((t.shape[0], npix), dtype=torch.float32, device=dev)
        acc = torch.zeros((t.shape[0], 3, npix), dtype=torch.float32, device=dev)
        np_b = torch.zeros(t.shape[0], dtype=torch.int32, device=dev)
        for j in range(int(nch.max()) if t.shape[0] else 0):
            run = torch.nonzero((j < nch) & (T.amax(1) >= T_EPS)).squeeze(1)
            if run.numel() == 0:
                break
            idx = j * chunk + lane                         # (chunk,)
            a = attrs[gid[astart[run, None] + idx]]        # (B, chunk, 16)
            ok = (idx >= head[run, None]) & (idx < (head + count)[run, None])
            mxl = (a[..., 0] - ox[run, None])[..., None]   # (B, chunk, 1)
            myl = (a[..., 1] - oy[run, None])[..., None]
            dx = px - mxl                                  # (B, chunk, npix)
            dy = py - myl
            power = -((0.5 * a[..., 2:3]) * (dx * dx) + a[..., 3:4] * (dx * dy)
                      + (0.5 * a[..., 4:5]) * (dy * dy))
            G = torch.exp(torch.where(power > 0.0, -100.0, power))
            raw = (a[..., 8] * ok)[..., None] * G
            alpha = torch.where(raw >= ALPHA_MIN, torch.clamp(raw, max=ALPHA_MAX), 0.0)
            cp = torch.cumprod(1.0 - alpha, dim=1)
            t_exc = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
            w = alpha * t_exc * T[run, None, :]
            acc[run] += torch.einsum("bkc,bkp->bcp", a[..., 5:8], w)
            T[run] = T[run] * cp[:, -1]
            np_b[run] += 1
        tiles[t, :3] = acc
        tiles[t, 3] = T
        nproc[t] = np_b
    return tiles, nproc


def skip_threshold(op: torch.Tensor) -> torch.Tensor:
    """Per-pair threshold of composite_fwd's and composite_bwd's skip, as
    the kernels compute it in float32: log(ALPHA_MIN / op) - SKIP_MARGIN,
    +inf where op is not positive. At a pixel whose power lies below it,
    op * exp(power) < ALPHA_MIN * exp(-SKIP_MARGIN), so alpha is 0 with a
    margin far above the few-ulp errors of exp and log."""
    op = op.to(torch.float32)
    thr = torch.log(torch.tensor(ALPHA_MIN, dtype=torch.float32, device=op.device) / op)
    return torch.where(op > 0, thr - SKIP_MARGIN, torch.inf)


def tile_windows(tile_size: int):
    """The windows the kernels cut a tile into: [(x, y, w, h)] in pixels,
    row-major; the whole tile up to WINDOW, else windows of WINDOW x WINDOW
    and narrower ones at the right and bottom (tile 96: 64 + 32 each way)."""
    if tile_size <= WINDOW:
        return [(0, 0, tile_size, tile_size)]
    return [(x, y, min(WINDOW, tile_size - x), min(WINDOW, tile_size - y))
            for y in range(0, tile_size, WINDOW) for x in range(0, tile_size, WINDOW)]


def _block_map(w: int, h: int) -> torch.Tensor:
    """The map of a w x h rectangle (a tile, or a window): (threads, 4)
    int64 pixels (y * w + x) of each map thread's 2x2 block, -1 past the
    rectangle or the block count (rounded up to whole warps)."""
    nbx, nby = (w + 1) // 2, (h + 1) // 2
    threads = -(-nbx * nby // 32) * 32
    tid = torch.arange(threads)
    if w % 16 == 0 and h % 8 == 0:
        warp, lane, wpr = tid // 32, tid % 32, w // 16
        x0 = (warp % wpr) * 16 + (lane % 8) * 2
        y0 = (warp // wpr) * 8 + (lane // 8) * 2
    else:
        x0, y0 = (tid % nbx) * 2, (tid // nbx) * 2
    x = x0[:, None] + torch.tensor([0, 1, 0, 1])
    y = y0[:, None] + torch.tensor([0, 0, 1, 1])
    ok = (tid[:, None] < nbx * nby) & (x < w) & (y < h)
    return torch.where(ok, y * w + x, -1)


def fwd_pixel_blocks(tile_size: int) -> torch.Tensor:
    """composite_fwd's and composite_bwd's launch geometry: (threads, 4)
    int64, the tile pixels (y * tile_size + x) of each map thread's 2x2
    block in the order (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 +
    1); -1 where a block passes the tile or a thread rounds the block count
    up to whole warps. Each window of tile_windows is mapped as a tile of
    its size: a width that is a multiple of 16 and a height that is a
    multiple of 8 give each warp a 16x8-pixel rectangle, others go
    row-major over blocks (csrc/composite_fwd.cu::block_origin); the
    windows' maps follow one another. Map thread t's warp is t // 32. Up to
    tile 64 the kernels launch min(threads, 256) threads and run map thread
    t as thread t % 256 in pixel pass t // 256 (one pass up to tile 32,
    four at tile 64); above it 256 threads run each window's map threads in
    units of 256, window after window."""
    maps = []
    for x, y, w, h in tile_windows(tile_size):
        m = _block_map(w, h)
        maps.append(torch.where(m >= 0, (m // w + y) * tile_size + m % w + x, -1))
    return torch.cat(maps)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
             + [ctypes.c_void_p] * 3)


def composite_fwd(attrs, tile_start, tile_count, *, tw, tile_size, chunk, gid
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """attrs (N+1, 16) attribute rows, or (N+1, 8) packed, read through gid
    (P,) int32 sorted gids; tile_start/tile_count (num_tiles,) int32 segments
    of the P pairs -> (tiles (num_tiles, 4, tile_size^2) rgb accumulation +
    final T, nproc (num_tiles,) int32 chunks composited before the
    whole-tile early exit). A tile with no pairs comes out (0, 0, 0, T=1);
    its nproc is 0 unless its (empty) segment starts mid-chunk, where the
    reference too sweeps that one masked chunk. A launch on packed rows
    counts in packed_fwd_count, not in composite_fwd.launches."""
    if attrs.device.type == "cpu":
        return composite_fwd_plain(attrs, tile_start, tile_count, tw=tw,
                                   tile_size=tile_size, chunk=chunk, gid=gid)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_fwd runs on cuda or cpu, not {attrs.device}")
    packed = _table_width(attrs, "composite_fwd")
    _check_gids(gid, attrs, chunk, "composite_fwd")
    npix = tile_size * tile_size
    for tab in (tile_start, tile_count):
        if tab.dtype != torch.int32 or not tab.is_contiguous() or tab.device != attrs.device:
            raise ValueError("tile tables must be contiguous int32 on the rows' device")
    num_tiles = tile_start.shape[0]
    tiles = torch.empty((num_tiles, 4, npix), dtype=torch.float32, device=attrs.device)
    nproc = torch.empty(num_tiles, dtype=torch.int32, device=attrs.device)
    lib = _build.load("composite_fwd")
    fn = lib.composite_fwd_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), gid.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
                 num_tiles, tw, tile_size, chunk, int(packed), ALPHA_MIN, ALPHA_MAX, T_EPS,
                 tiles.data_ptr(), nproc.data_ptr(),
                 torch.cuda.current_stream(attrs.device).cuda_stream)
    _build.check(lib, err, "composite_fwd launch")
    (packed_fwd_count if packed else composite_fwd).launches += 1
    return tiles, nproc


composite_fwd.launches = 0


def d_table_prefilled(p_out: int, device) -> torch.Tensor:
    """(p_out, 16) d-table of inert rows: zeros, key KEY_INVALID. The rows
    no tile writes (the tail past the last region) must sort after every
    real gid and carry nothing; `torch.empty` on the card holds garbage."""
    d = torch.zeros((p_out, ATTR_DIM), dtype=torch.float32, device=device)
    d[:, KEY_COL] = KEY_INVALID
    return d


def _conic_mean_grads(dU, mxl, myl, ca, cb, cc):
    """The basis sums dU (..., 6) about an origin, and the pair's mean
    relative to it -> [d mean x, d mean y, d conic a, b, c]: the
    reference's algebra."""
    du0, du1, du2, du3, du4, du5 = dU.unbind(-1)
    d_a = -0.5 * du0 + mxl * du3 - 0.5 * mxl * mxl * du5
    d_c = -0.5 * du1 + myl * du4 - 0.5 * myl * myl * du5
    d_b = -du2 + myl * du3 + mxl * du4 - mxl * myl * du5
    d_mx = ca * du3 + cb * du4 - (ca * mxl + cb * myl) * du5
    d_my = cb * du3 + cc * du4 - (cc * myl + cb * mxl) * du5
    return [d_mx, d_my, d_a, d_b, d_c]


def composite_bwd_plain(attrs, tile_start, tile_count, comp_start, nproc, tiles,
                        g_tiles, *, tw, tile_size, chunk, p_out, gid):
    """Plain PyTorch version of the composite_bwd kernel (same signature),
    over _PLAIN_TILE_BATCH tiles at a time: the reference's per-chunk
    backward (raster_pallas.py::_bwd_kernel) with exact-f32 sums over the
    pixels. Association: t_i = t_exc * t_run with t_exc the in-chunk
    exclusive cumprod; pref = in-chunk inclusive cumsum of w*cg + the carried
    prefix; total_cg from the forward's saved tile colour. The six basis
    sums of d conic and d mean are taken about the tile's centre, above
    WINDOW about each window's (tile_windows), whose d-values are then
    added window by window: the kernel's basis (csrc/composite_bwd.cu),
    which keeps the algebra's cancellation at tile 64's. Pair i's row is
    attrs[gid[i]]; packed (N+1, 8) rows replay their unpacked values (the
    d-table is the same)."""
    if attrs.shape[1] == PACKED_IN_DIM:
        attrs = unpack_rows(attrs)
    dev = attrs.device
    d = d_table_prefilled(p_out, dev)
    num_tiles = tile_start.shape[0]
    npix = tile_size * tile_size
    h = tile_size // 2
    pix = torch.arange(npix, device=dev)
    px = (pix % tile_size - h).to(torch.float32)
    py = (pix // tile_size - h).to(torch.float32)
    # pixel basis of the power's gradient about each window's centre (the
    # tile's up to WINDOW): [bx^2, by^2, bx*by, bx, by, 1], bx = px - cx
    bases = []
    for x, y, w, wh in tile_windows(tile_size):
        cx, cy = float(x + w // 2 - h), float(y + wh // 2 - h)
        idx = None
        if tile_size > WINDOW:
            idx = torch.nonzero((pix % tile_size >= x) & (pix % tile_size < x + w)
                                & (pix // tile_size >= y)
                                & (pix // tile_size < y + wh)).squeeze(1)
        bx, by = (px if idx is None else px[idx]) - cx, (py if idx is None else py[idx]) - cy
        bases.append((idx, torch.stack([bx * bx, by * by, bx * by, bx, by,
                                        torch.ones_like(bx)]), cx, cy))
    lane = torch.arange(chunk, device=dev)
    batch = _plain_tile_batch(npix)
    for b0 in range(0, num_tiles, batch):
        t = torch.arange(b0, min(b0 + batch, num_tiles), device=dev)
        start = tile_start[t].to(torch.int64)
        count = tile_count[t].to(torch.int64)
        astart = (start // chunk) * chunk
        head = start - astart
        np_t = nproc[t].to(torch.int64)
        cs = comp_start[t].to(torch.int64)
        ox = ((t % tw) * tile_size + h).to(torch.float32)
        oy = ((t // tw) * tile_size + h).to(torch.float32)
        g_rgb = g_tiles[t, :3]                              # (B, 3, npix)
        res = tiles[t]
        total_cg = (res[:, 0] * g_rgb[:, 0] + res[:, 1] * g_rgb[:, 1]
                    + res[:, 2] * g_rgb[:, 2])              # (B, npix)
        tf_gt = res[:, 3] * g_tiles[t, 3]                   # t_final * g_t
        t_run = torch.ones((t.shape[0], npix), dtype=torch.float32, device=dev)
        prefix = torch.zeros_like(t_run)
        for j in range(int(np_t.max()) if t.shape[0] else 0):
            run = torch.nonzero(j < np_t).squeeze(1)
            if run.numel() == 0:
                break
            idx = j * chunk + lane
            a = attrs[gid[astart[run, None] + idx]]        # (R, chunk, 16)
            ok = (idx >= head[run, None]) & (idx < (head + count)[run, None])
            op = a[..., 8] * ok                            # (R, chunk)
            mxl = a[..., 0] - ox[run, None]
            myl = a[..., 1] - oy[run, None]
            ca, cb, cc = a[..., 2], a[..., 3], a[..., 4]
            dx = px - mxl[..., None]                       # (R, chunk, npix)
            dy = py - myl[..., None]
            power = -((0.5 * ca[..., None]) * (dx * dx) + cb[..., None] * (dx * dy)
                      + (0.5 * cc[..., None]) * (dy * dy))
            G = torch.exp(torch.where(power > 0.0, -100.0, power))
            raw = op[..., None] * G
            keep = raw >= ALPHA_MIN
            alpha = torch.where(keep, torch.clamp(raw, max=ALPHA_MAX), 0.0)
            chain = (keep & (raw <= ALPHA_MAX)).to(torch.float32)
            cp = torch.cumprod(1.0 - alpha, dim=1)
            t_exc = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
            t_i = t_exc * t_run[run, None, :]
            w = alpha * t_i
            gr = g_rgb[run]                                # (R, 3, npix)
            cg = (a[..., 5, None] * gr[:, None, 0] + a[..., 6, None] * gr[:, None, 1]
                  + a[..., 7, None] * gr[:, None, 2])
            pref = torch.cumsum(w * cg, dim=1) + prefix[run, None, :]
            dalpha = t_i * cg - (total_cg[run, None, :] - pref
                                 + tf_gt[run, None, :]) / (1.0 - alpha)
            dalpha = dalpha * chain
            d_rgb = torch.einsum("rcp,rkp->rkc", gr, w)    # (R, chunk, 3)
            gda = G * dalpha
            d_op = gda.sum(-1)
            dpow = op[..., None] * gda
            geo = None
            for idx, V, cx, cy in bases:
                dU = torch.einsum("vp,rkp->rkv", V,
                                  dpow if idx is None else dpow[..., idx])  # (R, chunk, 6)
                part = _conic_mean_grads(dU, mxl - cx, myl - cy, ca, cb, cc)
                geo = part if geo is None else [a + b for a, b in zip(geo, part)]
            d_mx, d_my, d_a, d_b, d_c = geo
            key = torch.where(ok, a[..., KEY_COL], KEY_INVALID)
            rows = torch.stack([d_mx, d_my, d_a, d_b, d_c, d_rgb[..., 0], d_rgb[..., 1],
                                d_rgb[..., 2], d_op, key], dim=-1)
            dst = (cs[run, None] + j * chunk + lane).reshape(-1)
            d[dst, :N_DCOLS + 1] = rows.reshape(-1, N_DCOLS + 1)
            t_run[run] = t_run[run] * cp[:, -1]
            prefix[run] = pref[:, -1]
    return d


_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 3
                 + [ctypes.c_void_p] * 2)


def composite_bwd(attrs, tile_start, tile_count, comp_start, nproc, tiles, g_tiles,
                  *, tw, tile_size, chunk, p_out, gid) -> torch.Tensor:
    """The backward sweep of composite_fwd: attrs (N+1, 16) attribute rows
    (or (N+1, 8) packed: launches counted in packed_bwd_count) read through
    gid (P,) int32 sorted gids, as composite_fwd reads them,
    tile_start/tile_count (num_tiles,) int32, comp_start/nproc (num_tiles,)
    int32 (each tile's region offset and its chunks to replay), tiles (the
    forward's output) and g_tiles (their cotangent), both (num_tiles, 4,
    tile_size^2) f32 -> (p_out, 16) d-table: each replayed chunk's rows at
    [comp_start[t] + j*chunk, +chunk) hold d{mean x, mean y, conic a, b, c,
    r, g, b, opacity} and the pair's gid as the key (KEY_INVALID on rows
    outside the segment); every other row is inert (zeros, KEY_INVALID).
    The kernel runs composite_fwd's launch geometry (fwd_pixel_blocks: one
    thread per 2x2 pixel block, a warp a 16x8 rectangle where the tile is a
    multiple of 16, pixel passes above tile 32, windows above 64) and its
    warp skip (skip_threshold)."""
    if attrs.device.type == "cpu":
        return composite_bwd_plain(attrs, tile_start, tile_count, comp_start, nproc,
                                   tiles, g_tiles, tw=tw, tile_size=tile_size,
                                   chunk=chunk, p_out=p_out, gid=gid)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_bwd runs on cuda or cpu, not {attrs.device}")
    packed = _table_width(attrs, "composite_bwd")
    if p_out % chunk:
        raise ValueError(f"p_out {p_out} is not a multiple of chunk {chunk}")
    npix = tile_size * tile_size
    num_tiles = tile_start.shape[0]
    for tab in (tile_start, tile_count, comp_start, nproc):
        if tab.dtype != torch.int32 or not tab.is_contiguous() \
                or tab.device != attrs.device or tab.shape != (num_tiles,):
            raise ValueError("tile tables must be contiguous (num_tiles,) int32 on "
                             "the table's device")
    for tab in (tiles, g_tiles):
        if tab.dtype != torch.float32 or not tab.is_contiguous() \
                or tab.device != attrs.device or tab.shape != (num_tiles, 4, npix):
            raise ValueError("tiles and their cotangent must be contiguous float32 "
                             "(num_tiles, 4, tile_size^2) on the rows' device")
    d = d_table_prefilled(p_out, attrs.device)
    _check_gids(gid, attrs, chunk, "composite_bwd")
    lib = _build.load("composite_bwd")
    fn = lib.composite_bwd_launch
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), gid.data_ptr(), tile_start.data_ptr(),
                 tile_count.data_ptr(), comp_start.data_ptr(), nproc.data_ptr(), tiles.data_ptr(),
                 g_tiles.data_ptr(), num_tiles, tw, tile_size, chunk, p_out, int(packed),
                 ALPHA_MIN, ALPHA_MAX, KEY_INVALID, d.data_ptr(),
                 torch.cuda.current_stream(attrs.device).cuda_stream)
    _build.check(lib, err, "composite_bwd launch")
    (packed_bwd_count if packed else composite_bwd).launches += 1
    return d


composite_bwd.launches = 0


def untile_image(tiles: torch.Tensor, tw: int, th: int, tile_size: int,
                 width: int, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(num_tiles, 4, npix) -> (H, W, 3) rgb accumulation and (H, W) T."""
    t = tiles.reshape(th, tw, 4, tile_size, tile_size)
    img = t.permute(2, 0, 3, 1, 4).reshape(4, th * tile_size, tw * tile_size)
    img = img[:, :height, :width]
    return img[:3].permute(1, 2, 0), img[3]
