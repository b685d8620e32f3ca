"""One tiny seeded scene, built in numpy and handed to both packages.

Every tests/test_torch_*.py file compares the PyTorch port
(gsplat_tpu_torch) with the JAX reference (gsplat_tpu) on these same arrays:
a 63-Gaussian scene in a 64-row capacity (one dead padded row), SH degree 3
with nonzero rest coefficients, a few Gaussians at or behind the near plane,
seen by a 64x48 camera; renders use tile 16 and chunk 32. The saturation
bound cull's tests use `make_sat_scene` (big near-opaque splats that
saturate their tiles) and `saturating_projection`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.render.raster import ATTR_DIM, KEY_COL, KEY_INVALID, N_DCOLS

W, H = 64, 48
TILE = 16
CHUNK = 32
BUDGET = 1 << 12
FOVX, FOVY = 0.9, 0.7


class Scene(NamedTuple):
    params: Dict[str, np.ndarray]   # the nine capacity-padded array fields
    n_live: int
    sh_degree: int
    R: np.ndarray
    T: np.ndarray
    fovx: float = FOVX
    fovy: float = FOVY


def _padded(capacity, xyz, f_dc, f_rest, opacity, scaling, rotation):
    """The nine array fields, live rows first, dead rows padded as
    gsplat_tpu pads them (opacity and scaling -30, identity rotation)."""
    def pad(a, fill=0.0):
        out = np.full((capacity,) + a.shape[1:], fill, np.float32)
        out[:len(a)] = a
        return out

    rot = pad(rotation)
    rot[len(rotation):, 0] = 1.0
    return {
        "xyz": pad(xyz), "f_dc": pad(f_dc), "f_rest": pad(f_rest),
        "opacity": pad(opacity, -30.0), "scaling": pad(scaling, -30.0),
        "rotation": rot,
        "max_radii2D": np.zeros(capacity, np.float32),
        "xyz_gradient_accum": np.zeros(capacity, np.float32),
        "denom": np.zeros(capacity, np.float32),
    }


def make_scene(seed: int = 0, n: int = 63, capacity: int = 64, sh_degree: int = 3,
               log_scale=(-2.8, -1.2), opacity_logit=(0.0, 1.5)) -> Scene:
    """Capacity-padded raw parameters (padding as gsplat_tpu pads) and a
    look-at camera from (0, 0, 4) towards the origin."""
    rng = np.random.default_rng(seed)
    m = (sh_degree + 1) ** 2 - 1
    xyz = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    # view depth = 4 - z: at the near plane, just inside it, behind the camera
    xyz[:3] = [[0.1, 0.0, 3.85], [-0.2, 0.1, 3.79], [0.0, -0.1, 5.0]]
    f_dc = rng.normal(size=(n, 3)).astype(np.float32)
    f_rest = (rng.normal(size=(n, m, 3)) * 0.3).astype(np.float32)
    opacity = rng.normal(*opacity_logit, size=(n, 1)).astype(np.float32)
    scaling = rng.uniform(*log_scale, size=(n, 3)).astype(np.float32)
    rotation = rng.normal(size=(n, 4)).astype(np.float32)
    params = _padded(capacity, xyz, f_dc, f_rest, opacity, scaling, rotation)
    return Scene(params, n, sh_degree, *_look_at())


def _look_at():
    """gsplat_tpu.io.synthetic.look_at_rig(1)'s camera, spelled out: this
    module imports nothing of gsplat_tpu at import time, so the GPU tests
    run where jax is not installed."""
    return np.diag([-1.0, 1.0, -1.0]), np.array([0.0, 0.0, 4.0])


# tests/test_binning.py::test_saturation_bound_cull's render settings:
# kept_budget < pair_budget turns the tight cull on in the render without
# the saturation cull too, so the two are comparable bit for bit
SAT_W, SAT_H = 96, 64
SAT_KW = dict(tile_size=16, chunk=8, pair_budget=1 << 12, kept_budget=(1 << 12) - 8)


def make_sat_scene():
    """tests/test_binning.py::test_saturation_bound_cull's scene in numpy
    (the port has no create_from_pcd yet): 80 big near-opaque splats stacked
    in depth (log-scale -0.2, opacity sigmoid(4) = 0.982) in a 128-row
    capacity, colours as create_from_pcd turns them into SH dc, seen at
    96x64 -> (Scene, the (64, 96, 3) target image the test draws next)."""
    rng = np.random.default_rng(13)
    n = 80
    xyz = (rng.normal(size=(n, 3)) * 0.35).astype(np.float32)
    f_dc = ((rng.random((n, 3)) - 0.5) / 0.28209479177387814).astype(np.float32)
    target = rng.random((SAT_H, SAT_W, 3)).astype(np.float32)
    rotation = np.zeros((n, 4), np.float32)
    rotation[:, 0] = 1.0
    params = _padded(128, xyz, f_dc, np.zeros((n, 15, 3), np.float32),
                     np.full((n, 1), 4.0, np.float32), np.full((n, 3), -0.2, np.float32),
                     rotation)
    return Scene(params, n, 3, *_look_at(), fovx=1.0, fovy=0.8), target


def jax_objects(s: Scene, width: int = W, height: int = H):
    """(gsplat_tpu Gaussians, gsplat_tpu Camera)."""
    import jax.numpy as jnp

    from gsplat_tpu.core.camera import make_camera
    from gsplat_tpu.core.gaussians import Gaussians

    g = Gaussians(**{k: jnp.asarray(v) for k, v in s.params.items()},
                  n_live=jnp.asarray(s.n_live, jnp.int32),
                  active_sh_degree=s.sh_degree, max_sh_degree=s.sh_degree)
    cam = make_camera(s.R, s.T, fovx=s.fovx, fovy=s.fovy, width=width, height=height)
    return g, cam


def torch_objects(s: Scene, width: int = W, height: int = H):
    """(gsplat_tpu_torch Gaussians, gsplat_tpu_torch Camera) on the CPU."""
    from gsplat_tpu_torch.interop import camera_from_numpy, gaussians_from_numpy

    g = gaussians_from_numpy(s.params, s.n_live, s.sh_degree, s.sh_degree,
                             device="cpu")
    cam = camera_from_numpy(s.R, s.T, s.fovx, s.fovy, width, height, device="cpu")
    return g, cam


# scenes of the compositing tests: make_scene keyword arguments
SCENES = {
    "sparse": dict(seed=0),
    # large near-opaque splats: tiles saturate inside their first chunk
    "dense": dict(seed=1, log_scale=(-1.0, -0.6), opacity_logit=(5.0, 0.5)),
}


def gid_tables(scene, width=W, height=H, tile=TILE, chunk=CHUNK, attr_pack=False):
    """The port's own project -> bin of `scene` on the CPU, as the
    compositors read it: (the (N+1, 16) attribute rows with their gid
    column, packed (N+1, 8) with attr_pack; the kept prefix of the sorted
    gids; tile_start; tile_count)."""
    from gsplat_tpu_torch.render.binning import bin_gaussians
    from gsplat_tpu_torch.render.project import project_gaussians
    from gsplat_tpu_torch.render.render import _attr_rows, _gid_rows

    g, cam = torch_objects(scene, width, height)
    proj = project_gaussians(g, cam)
    b = bin_gaussians(proj.mean2d, proj.radius, proj.depth, width=width,
                      height=height, tile_size=tile, chunk=chunk,
                      pair_budget=BUDGET, cull_conic=proj.conic,
                      cull_opacity=proj.opacity, kept_budget=BUDGET - chunk)
    return (_gid_rows(_attr_rows(proj), attr_pack), b.gid_s[:BUDGET - chunk],
            b.tile_start, b.tile_count)


def pair_tables(scene, width=W, height=H, tile=TILE, chunk=CHUNK):
    """gid_tables' rows gathered through its gids: (the (P, 16) pair table
    the compositors read in order, tile_start, tile_count)."""
    rows, gid, ts, tc = gid_tables(scene, width, height, tile, chunk)
    return rows.index_select(0, gid), ts, tc


def table_gids(table):
    """The gids through which the compositors read a gathered (P, 16) or
    (P, 8) pair table in order: arange(P), int32 on the table's device."""
    return torch.arange(table.shape[0], dtype=torch.int32, device=table.device)


def crafted_tiles(tw, th, tile, chunk, seed=0):
    """A gathered pair table and its tile tables, made directly: tiles in
    turn empty, sparse (1 to 3 chunks of small splats) and saturating (three
    chunks and more of wide opaque splats, which exit at a chunk boundary
    before their last chunk), their segments packed one after the other from
    row 3, so most start mid-chunk -> (attrs (P, 16) float32 with P a
    multiple of chunk, tile_start, tile_count) as numpy arrays."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(tw * th, np.int64)
    rows = []
    for t in range(tw * th):
        kind = t % 3
        if kind == 0:
            continue
        n = int(rng.integers(1, 3 * chunk + 1)) if kind == 1 else 3 * chunk + 5
        sigma = rng.uniform(1.0, 6.0, n) if kind == 1 else rng.uniform(3.0, 4.0, n) * tile
        ox, oy = (t % tw) * tile, (t // tw) * tile
        r = np.zeros((n, 16), np.float32)
        r[:, 0] = ox + rng.uniform(-4, tile + 4, n)
        r[:, 1] = oy + rng.uniform(-4, tile + 4, n)
        r[:, 2] = r[:, 4] = 1.0 / sigma ** 2
        r[:, 3] = rng.uniform(-0.3, 0.3, n) / sigma ** 2
        r[:, 5:8] = rng.random((n, 3))
        r[:, 8] = rng.uniform(0.05, 1.0, n) if kind == 1 else 0.99
        r[:, 9] = rng.integers(0, 1000, n)
        counts[t] = n
        rows.append(r)
    starts = 3 + np.concatenate([[0], np.cumsum(counts)[:-1]])
    p = -(-(3 + int(counts.sum())) // chunk) * chunk + chunk
    attrs = np.zeros((p, 16), np.float32)
    if rows:
        attrs[3:3 + int(counts.sum())] = np.concatenate(rows)
    return attrs, starts.astype(np.int32), counts.astype(np.int32)


def skip_edge_tile(tile, chunk):
    """One tile (tw 1) of pairs at the edges of composite_fwd's skip, each
    centred off the tile at (-3, -4) so that its highest power in the tile
    is at pixel (0, 0), 25 px^2 away: op 0; op < 1/255; op 1; a conic whose
    power is > 0 where |dx| > |dy| (the -100 branch; centred at x -3.3, so
    that no pixel has |dx| = |dy|); and op 0.5 with that highest power at
    its threshold (raster.skip_threshold) -2e-3, -1e-3, -1e-6, 0, +1e-6,
    +5e-4 and +2e-3 (the 1/255 boundary lies at +1e-3; no pair sits on it,
    where the JAX kernel's transport of the table through bf16 terms could
    flip the decision); then a wide visible splat. The segment starts at
    row 3 -> (attrs, tile_start, tile_count) as numpy."""
    amin = np.float32(1.0 / 255.0)
    thr = float(np.log(amin / np.float32(0.5)) - np.float32(1e-3))
    # (op, conic a, b, c); power at distance^2 25 is -0.5 * a * 25 for a = c
    iso = [(0.5, -2.0 * (thr + d) / 25.0) for d in (-2e-3, -1e-3, -1e-6, 0.0, 1e-6,
                                                    5e-4, 2e-3)]
    pairs = [(0.0, 0.02, 0.0, 0.02), (0.003, 0.02, 0.0, 0.02), (1.0, 0.02, 0.0, 0.02),
             (0.8, -0.05, 0.0, 0.05)] + [(op, a, 0.0, a) for op, a in iso]
    n = len(pairs)
    p = -(-(3 + n) // chunk) * chunk + chunk
    attrs = np.zeros((p, 16), np.float32)
    for i, (op, a, b, c) in enumerate(pairs):
        mx = -3.3 if a < 0 else -3.0
        attrs[3 + i, :9] = [mx, -4.0, a, b, c, 0.2 + 0.05 * i, 0.9 - 0.05 * i, 0.5, op]
    wide = np.array([tile / 2, tile / 2, 1e-3, 0.0, 1e-3, 0.3, 0.6, 0.9, 0.7], np.float32)
    attrs[3 + n, :9] = wide
    return attrs, np.array([3], np.int32), np.array([n + 1], np.int32)


def banded_tile(tile, chunk, axis=0):
    """One tile (tw 1) whose horizontal bands saturate at different chunks:
    four groups of whole chunks, at least 16 pairs each, of opaque splats
    wide in x and tile / 8 px tall, group b centred on band b of four (rows
    [b * tile / 4, (b + 1) * tile / 4)), so the top band's pixels fall below
    T_EPS after the first group and the bottom band's after the last; then a
    chunk of faint splats over the whole tile, past the whole-tile exit. At
    tile 64 the bands are the kernels' pixel passes; above 64 the windows
    of the top half saturate before those below. `axis` 1 turns the bands
    into columns (x and y swapped), so that the left windows saturate
    first. The segment starts at row 3 -> (attrs, tile_start, tile_count,
    pairs per group) with the arrays in numpy."""
    rng = np.random.default_rng(tile + chunk)
    m = -(-16 // chunk) * chunk
    n = 4 * m + chunk
    band = np.minimum(np.arange(n) // m, 4)
    sx, sy = 3.0 * tile, tile / 8.0
    attrs = np.zeros((-(-(3 + n) // chunk) * chunk + chunk, 16), np.float32)
    r = attrs[3:3 + n]
    r[:, 0] = rng.uniform(0, tile, n)
    r[:, 1] = (np.minimum(band, 3) + 0.5) * tile / 4 + rng.uniform(-1, 1, n)
    r[:, 2], r[:, 3], r[:, 4] = 1 / sx ** 2, 0.0, 1 / sy ** 2
    r[:, 5:8] = rng.random((n, 3))
    r[:, 8] = np.where(band < 4, 0.99, 0.05)
    r[band == 4, 1] = tile / 2
    r[band == 4, 4] = 1 / (3.0 * tile) ** 2
    r[:, 9] = np.arange(n)
    if axis:
        r[:, [0, 1, 2, 4]] = r[:, [1, 0, 4, 2]]
    return attrs, np.array([3], np.int32), np.array([n], np.int32), m


# gid-sorted key rows of the d-table, as the backward's key sort leaves
# them (segment_ends)
GAP_CASES = ("leading", "middle", "tail", "one_gid")


def gap_row(case, p=512, n=4096):
    """(p,) sorted f32 keys with long runs of gids that have no rows."""
    rng = np.random.default_rng(len(case))
    keys = np.full(p, KEY_INVALID, np.float32)
    if case == "leading":        # gid 0 and the 2999 after it own nothing
        keys[:300] = np.sort(rng.integers(3000, n, 300))
    elif case == "middle":       # gids 10..2999 own nothing
        keys[:400] = np.sort(np.concatenate([rng.integers(0, 10, 200),
                                             rng.integers(3000, 3010, 200)]))
    elif case == "tail":         # every gid past 99 owns nothing
        keys[:128] = np.sort(rng.integers(0, 100, 128))
    elif case == "one_gid":      # every row is gid 1234
        keys[:] = 1234.0
    return keys


# crafted d-tables of the per-Gaussian reduction (render.reduce_by_gid)
D_TABLE_CASES = ("gid0_empty", "trailing_empty", "one_gid", "all_invalid", "long_segment")


def crafted_d_table(case, n_rows=40, c=256, seed=0):
    """A (c, 16) d-table in no gid order: `case` says which gids own rows."""
    rng = np.random.default_rng(seed)
    d = np.zeros((c, ATTR_DIM), np.float32)
    d[:, :N_DCOLS] = rng.normal(size=(c, N_DCOLS)) * \
        10.0 ** rng.uniform(-3, 3, N_DCOLS)
    n = n_rows - 1
    if case == "gid0_empty":
        key = rng.integers(1, n, c)
    elif case == "trailing_empty":
        key = rng.integers(0, n // 3, c)
    elif case == "one_gid":
        key = np.full(c, 7)
    elif case == "all_invalid":
        key = np.full(c, -1)
    elif case == "long_segment":     # gid 5 owns 100 rows, more than a warp's 32
        key = np.concatenate([np.full(100, 5), rng.integers(0, n, c - 100)])
    key = key.astype(np.float32)
    key[rng.random(c) < 0.2] = -1                     # inert rows among them
    key[key < 0] = KEY_INVALID
    d[key == KEY_INVALID, :N_DCOLS] = 0.0
    d[:, KEY_COL] = key
    return d[rng.permutation(c)], n_rows


# crafted expansion tables (expand_pairs): a 640x416 image at tile 16, 40 x 26
# = 1040 tiles, so a Gaussian over every tile owns more slots than one block
# of the kernel's merged sequence (1024 slots and rows) holds; EXP_S slots,
# no multiple of that block
EXP_W, EXP_H, EXP_TILE, EXP_S = 640, 416, 16, 3200
# case: (Gaussians over every tile, one-tile Gaussians, dead rows)
EXPANSION_CASES = {
    "wide": (2, 300, 100),        # 2 x 1040 + 300 = 2380 live slots
    "ones": (0, 3000, 200),       # runs of one-slot rows
    "empty": (0, 0, 300),         # total 0
    "full": (3, 80, 0),           # total = EXP_S
    "overflow": (4, 80, 20),      # total 4240 > EXP_S
}


def crafted_projection(case, seed=0):
    """A projection whose expansion table has the shape EXPANSION_CASES
    names (its Gaussians shuffled, so live and dead rows interleave before
    the table's live-first partition) -> mean2d, radius, depth, conic,
    opacity. The wide splats (sigma 60-200 px) and the small ones (sigma
    1-4 px, opacity down to 0.001) leave the tight cull some pairs to cut."""
    n_wide, n_one, n_dead = EXPANSION_CASES[case]
    rng = np.random.default_rng(seed)
    n = n_wide + n_one + n_dead
    tw, th = EXP_W // EXP_TILE, EXP_H // EXP_TILE
    mean2d = np.zeros((n, 2), np.float32)
    radius = np.zeros(n, np.float32)
    sigma = np.ones(n, np.float32)
    mean2d[:n_wide] = [EXP_W / 2, EXP_H / 2]
    radius[:n_wide] = 2000.0
    sigma[:n_wide] = rng.uniform(60, 200, n_wide)
    t = rng.integers(0, tw * th, n_one)
    one = slice(n_wide, n_wide + n_one)
    mean2d[one, 0] = (t % tw) * EXP_TILE + 8 + rng.uniform(-3, 3, n_one)
    mean2d[one, 1] = (t // tw) * EXP_TILE + 8 + rng.uniform(-3, 3, n_one)
    radius[one] = 2.0
    sigma[one] = rng.uniform(1, 4, n_one)
    mean2d[n_wide + n_one:] = rng.uniform(0, EXP_W, (n_dead, 2))
    depth = rng.uniform(-5, 50, n).astype(np.float32)
    conic = np.stack([1 / sigma ** 2, rng.uniform(-0.2, 0.2, n) / sigma ** 2,
                      1 / sigma ** 2], axis=1).astype(np.float32)
    opacity = rng.uniform(0.001, 1.0, n).astype(np.float32)
    perm = rng.permutation(n)
    return mean2d[perm], radius[perm], depth[perm], conic[perm], opacity[perm]


def random_projection(n, seed, width=256, height=192, dead_frac=0.3,
                      clustered_dead=False):
    """A random projection for binning (tests/test_expand_pallas.py's scene,
    with some negative depths on live Gaussians: the key's depth bits are a
    LOGICAL shift of the f32) -> mean2d, radius, depth, conic, opacity."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform(-40, max(width, height) + 40, (n, 2)).astype(np.float32)
    radius = rng.uniform(1, 60, n).astype(np.float32)
    dead = rng.random(n) < dead_frac
    if clustered_dead:
        dead[: n // 2] = True
    radius[dead] = 0.0
    depth = rng.uniform(-5, 50, n).astype(np.float32)
    conic = np.abs(rng.normal(0.02, 0.05, (n, 3))).astype(np.float32)
    conic[:, 1] *= 0.1
    opacity = rng.uniform(0.001, 1.0, n).astype(np.float32)
    return mean2d, radius, depth, conic, opacity


def saturating_projection(n, seed, width=64, height=64):
    """A random projection whose tiles saturate: wide, nearly round splats
    (sigma 12-40 px, radius 3 sigma) of opacity 0.4-1 over a small image
    -> mean2d, radius, depth, conic, opacity."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform(-10, max(width, height) + 10, (n, 2)).astype(np.float32)
    sigma = rng.uniform(12, 40, n).astype(np.float32)
    radius = np.ceil(3 * sigma).astype(np.float32)
    depth = rng.uniform(1, 50, n).astype(np.float32)
    conic = np.stack([1 / sigma ** 2, rng.uniform(-0.1, 0.1, n) / sigma ** 2,
                      1 / sigma ** 2], axis=1).astype(np.float32)
    opacity = rng.uniform(0.4, 1.0, n).astype(np.float32)
    return mean2d, radius, depth, conic, opacity


# niceness of the processes the mesh tests start: they run beside
# tests/test_multihost.py on another worker, whose two JAX processes give up
# on each other's gloo context after 30 s, and a mesh of busy ranks at the
# same priority can starve one of them that long
RANK_NICE = 10


def niced(cmd):
    """`cmd` run at RANK_NICE above the caller's niceness, through nice(1)
    (a preexec_fn would fork a threaded parent, which may deadlock)."""
    return ["nice", "-n", str(RANK_NICE), *cmd]


@pytest.fixture
def cuda_device():
    """The CUDA device, for tests marked `cuda`; skips where there is none
    (decided when the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


# ---- JPEG fixtures (tests/data/jpeg/) ----

JPEG_DIR = __import__("pathlib").Path(__file__).resolve().parent / "data" / "jpeg"


def _jpeg_block_bits(diff, blk, dc_codes, ac_codes):
    """The Huffman bits of one quantised block (zigzag order) whose DC is
    coded as `diff` -> [(code, length)]."""
    s = abs(diff).bit_length()
    out = [dc_codes[s]] + ([(diff if diff > 0 else diff + (1 << s) - 1, s)] if s else [])
    run = 0
    for k in range(1, 64):
        v = int(blk[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            out.append(ac_codes[0xF0])
            run -= 16
        s = abs(v).bit_length()
        out.append(ac_codes[(run << 4) | s])
        out.append((v if v > 0 else v + (1 << s) - 1, s))
        run = 0
    if run:
        out.append(ac_codes[0x00])
    return out


def _jpeg_pack(bits):
    """[(code, length)] -> entropy-coded bytes: 1-bit padding, FF stuffed."""
    acc, n, out = 0, 0, bytearray()
    for code, length in bits:
        acc = (acc << length) | code
        n += length
        while n >= 8:
            n -= 8
            byte = (acc >> n) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << n) - 1
    if n:
        byte = ((acc << (8 - n)) | ((1 << (8 - n)) - 1)) & 0xFF
        out.append(byte)
        if byte == 0xFF:
            out.append(0)
    return bytes(out)


def encode_jpeg(img, sampling=((1, 1), (1, 1), (1, 1)), restart=0, interleaved=True,
                colour="jfif") -> bytes:
    """A baseline JPEG of uint8 (H, W, 3), (H, W, 4) or (H, W) `img`, written
    in numpy for the layouts PIL does not write: any sampling factors (4:4:0
    is ((1, 2), (1, 1), (1, 1)); a fourth component samples 1x1 unless
    named), one scan a component (interleaved=False), restart intervals of
    `restart` MCUs, and colour "jfif" (YCbCr, a JFIF APP0), "adobe-rgb" (RGB
    under an Adobe APP14, transform 0) or "rgb-ids" (RGB named by component
    ids 'R', 'G', 'B', no APPn); for 4 channels "cmyk" (an Adobe APP14,
    transform 0, the channels stored inverted as Adobe's CMYK is) or "ycck"
    (transform 2: YCbCr of the first three, the fourth inverted). A float
    DCT and fixed-length Huffman codes (any valid stream will do: PIL's
    decode of it is the reference)."""
    import struct

    img = np.asarray(img, np.uint8)
    gray = img.ndim == 2
    h_img, w_img = img.shape[:2]
    x = img.astype(np.float64)

    def ycc(r, g, b):
        return [0.299 * r + 0.587 * g + 0.114 * b,
                -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                0.5 * r - 0.418688 * g - 0.081312 * b + 128]

    if gray:
        planes, sampling, ids = [x], sampling[:1], [1]
    elif img.shape[2] == 4:
        if colour == "ycck":
            planes = ycc(x[..., 0], x[..., 1], x[..., 2]) + [255 - x[..., 3]]
        else:
            planes = [255 - x[..., c] for c in range(4)]
        sampling = tuple(sampling) + ((1, 1),) * (4 - len(sampling))
        ids = [1, 2, 3, 4]
    elif colour == "jfif":
        planes = ycc(x[..., 0], x[..., 1], x[..., 2])
        ids = [1, 2, 3]
    else:
        planes = [x[..., 0], x[..., 1], x[..., 2]]
        ids = [82, 71, 66] if colour == "rgb-ids" else [1, 2, 3]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    qt = [np.array([[2 + 2 * (i + j) for j in range(8)] for i in range(8)], np.float64),
          np.array([[3 + 3 * (i + j) for j in range(8)] for i in range(8)], np.float64)]
    k = np.arange(8)
    dct = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.where(
        k[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    zz = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
                   40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                   36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
                   60, 61, 54, 47, 55, 62, 63])
    comps = []
    for c, (plane, (hc, vc)) in enumerate(zip(planes, sampling)):
        fx, fy = hmax // hc, vmax // vc
        dw, dh = -(-w_img * hc // hmax), -(-h_img * vc // vmax)
        bw, bh = mcux * hc, mcuy * vc
        p = np.pad(plane, ((0, bh * 8 * fy - h_img), (0, bw * 8 * fx - w_img)), mode="edge")
        p = p.reshape(bh * 8, fy, bw * 8, fx).mean(axis=(1, 3)) - 128.0
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = dct @ blocks @ dct.T
        q = np.round(coef / qt[min(c, 1)]).astype(np.int64)
        comps.append(dict(q=q.reshape(bh, bw, 64)[..., zz], hc=hc, vc=vc,
                          nbx=-(-dw // 8), nby=-(-dh // 8)))
    # fixed-length codes: 4 bits for the 12 DC categories, 8 bits for the AC symbols
    dc_syms, ac_syms = list(range(12)), [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                                                        for s in range(1, 11)]
    dc_codes = {s: (i, 4) for i, s in enumerate(dc_syms)}
    ac_codes = {s: (i, 8) for i, s in enumerate(ac_syms)}

    def seg(marker, body):
        return struct.pack(">HH", marker, len(body) + 2) + body

    out = bytearray(b"\xff\xd8")
    if colour == "jfif" or gray:
        out += seg(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif colour in ("adobe-rgb", "cmyk", "ycck"):
        out += seg(0xFFEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([2 * (colour == "ycck")]))
    for t in range(2):
        out += seg(0xFFDB, bytes([t]) + bytes(int(v) for v in qt[t].reshape(64)[zz]))
    out += seg(0xFFC0, struct.pack(">BHHB", 8, h_img, w_img, len(comps)) + b"".join(
        bytes([ids[c], (cp["hc"] << 4) | cp["vc"], min(c, 1)]) for c, cp in enumerate(comps)))
    dc_counts = [0] * 16
    dc_counts[3] = len(dc_syms)
    ac_counts = [0] * 16
    ac_counts[7] = len(ac_syms)
    out += seg(0xFFC4, bytes([0x00] + dc_counts + dc_syms) + bytes([0x10] + ac_counts + ac_syms))
    if restart:
        out += seg(0xFFDD, struct.pack(">H", restart))
    scans = [list(range(len(comps)))] if interleaved else [[c] for c in range(len(comps))]
    for scan in scans:
        out += seg(0xFFDA, bytes([len(scan)]) + b"".join(bytes([ids[c], 0x00])
                                                         for c in scan) + b"\x00\x3f\x00")
        if len(scan) == 1:
            cp = comps[scan[0]]
            units = [[(scan[0], cp["q"][by, bx])] for by in range(cp["nby"])
                     for bx in range(cp["nbx"])]
        else:
            units = []
            for my in range(mcuy):
                for mx in range(mcux):
                    units.append([(c, comps[c]["q"][my * comps[c]["vc"] + by,
                                                     mx * comps[c]["hc"] + bx])
                                  for c in scan for by in range(comps[c]["vc"])
                                  for bx in range(comps[c]["hc"])])
        step = restart or len(units)
        for i0 in range(0, len(units), step):
            if i0:
                out += bytes([0xFF, 0xD0 + (i0 // step - 1) % 8])
            bits, preds = [], {}
            for unit in units[i0:i0 + step]:
                for c, blk in unit:
                    bits += _jpeg_block_bits(int(blk[0]) - preds.get(c, 0), blk, dc_codes,
                                             ac_codes)
                    preds[c] = int(blk[0])
            out += _jpeg_pack(bits)
    out += b"\xff\xd9"
    return bytes(out)


def jpeg_fixture_image(height, width, seed, channels=3, noise=2.0):
    """A seeded uint8 image of waves and gradients plus Gaussian noise of
    std `noise` (smooth, as a capture is, at the default): (H, W) for one
    channel, (H, W, 3), or (H, W, 4) with a fourth wave drawn after the
    others (so the first three are the 3-channel image's)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    ph = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([128 + 100 * np.sin(xx / 97 + yy / 53 + ph[0]),
                    128 + 90 * np.cos(xx / 41 - yy / 77 + ph[1]),
                    128 + 80 * np.sin((xx + yy) / 150 + ph[2])], axis=-1)
    img = np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)
    if channels == 4:
        k = 128 + 60 * np.cos(xx / 67 + yy / 31 + rng.uniform(0, 2 * np.pi))
        k = np.clip(k + rng.normal(0, noise, k.shape), 0, 255).astype(np.uint8)
        return np.concatenate([img, k[..., None]], axis=-1)
    return img[..., 0] if channels == 1 else img


# name -> (height, width, seed, how it is written): "pil" with PIL's save
# options, "numpy" with encode_jpeg's (PIL writes neither 4:4:0 nor YCCK).
# Names starting "gray" hold one channel, "cmyk" and "ycck" four (PIL's
# CMYK), the others three.
JPEG_FIXTURES = {
    "rgb444.jpg": (48, 64, 1, "pil", dict(quality=90, subsampling=0)),
    "rgb422.jpg": (48, 64, 2, "pil", dict(quality=90, subsampling=1)),
    "rgb420.jpg": (48, 64, 3, "pil", dict(quality=90, subsampling=2)),
    "rgb440.jpg": (48, 64, 4, "numpy", dict(sampling=((1, 2), (1, 1), (1, 1)))),
    "gray.jpg": (48, 64, 5, "pil", dict(quality=90)),
    "restart.jpg": (40, 72, 6, "pil", dict(quality=85, subsampling=2,
                                            restart_marker_blocks=3)),
    "odd_23x37.jpg": (23, 37, 7, "pil", dict(quality=95, subsampling=2)),
    "smooth_1080p_420.jpg": (1080, 1920, 8, "pil", dict(quality=85, subsampling=2)),
    "prog420.jpg": (48, 64, 9, "pil", dict(quality=90, subsampling=2, progressive=True)),
    "prog444.jpg": (48, 64, 10, "pil", dict(quality=90, subsampling=0, progressive=True)),
    "gray_prog.jpg": (48, 64, 11, "pil", dict(quality=90, progressive=True)),
    "prog_restart.jpg": (40, 72, 12, "pil", dict(quality=85, subsampling=2, progressive=True,
                                                  restart_marker_blocks=3)),
    "smooth_1080p_prog420.jpg": (1080, 1920, 13, "pil", dict(quality=90, subsampling=2,
                                                             progressive=True)),
    "cmyk.jpg": (40, 56, 14, "pil", dict(quality=90)),
    "ycck.jpg": (40, 56, 15, "numpy", dict(sampling=((2, 2), (1, 1), (1, 1), (2, 2)),
                                           colour="ycck")),
}


def jpeg_fixture_channels(name):
    """The channels of fixture `name`'s image (see JPEG_FIXTURES)."""
    return 1 if name.startswith("gray") else 4 if name.startswith(("cmyk", "ycck")) else 3


def write_jpeg_fixtures(root=JPEG_DIR):
    """Write JPEG_FIXTURES under `root` and manifest.json beside them: each
    file's shape and the sha256 of PIL's decode of it (np.asarray(
    PIL.Image.open(path)).tobytes()). Needs PIL, which the tests have."""
    import hashlib
    import io
    import json
    from pathlib import Path

    from PIL import Image

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, (h, w, seed, how, kw) in JPEG_FIXTURES.items():
        img = jpeg_fixture_image(h, w, seed, jpeg_fixture_channels(name),
                                 noise=2.0 if h * w > 1 << 20 else 24.0)
        if how == "pil":
            buf = io.BytesIO()
            Image.fromarray(img, "CMYK" if img.ndim == 3 and img.shape[2] == 4 else None).save(
                buf, "JPEG", **kw)
            data = buf.getvalue()
        else:
            data = encode_jpeg(img, **kw)
        (root / name).write_bytes(data)
        with Image.open(root / name) as im:
            ref = np.asarray(im)
        manifest[name] = {"shape": list(ref.shape),
                          "sha256": hashlib.sha256(ref.tobytes()).hexdigest()}
    (root / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    return manifest
