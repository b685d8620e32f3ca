#!/usr/bin/env python3
"""The compositing kernels (K2 composite_fwd, K3 composite_bwd) of two
checkouts of the PyTorch/CUDA port, on one card: the same bits and their
times at each tile size.

    git archive HEAD | (mkdir -p build/parent && tar -x -C build/parent)
    python scripts/composite_ab.py build/parent .

Runs the trees in turns A, B, B, A, each in a process of its own that
imports that tree's gsplat_tpu_torch (so each builds and loads its own
kernels into its own build/kernels/). A run builds bench.py's scene in
numpy (gsplat_tpu_torch/tools/bench_scene.py: 1M Gaussians, 1920x1080; the
sparse view at 2.25 tile pairs a Gaussian, the dense one at 33), bins the
bench view at each tile size with the pair and kept budgets fitted as
scripts/serving_bench.py fits them, and launches K2 on the view's
attribute rows and sorted gids and K3 on K2's output with a seeded normal
cotangent: a tree whose compositors read a gathered pair table (its
render module has `pair_table`) is handed that table, one whose compositors
read each pair's row through its gid is handed the rows and the gids. It
records the sha256 of the inputs (the attribute rows and the kept gids,
the same for both kinds of tree), of K2's tiles and nproc and of K3's
d-table, and each
kernel's median device ms of 10 launches (CUDA events; K3's less the
d-table fill its wrapper runs before each launch). A tile a tree refuses
is recorded as refused.

Prints, for each tile and view: whether the inputs and each kernel's bits
agree between every run, and each tree's mean ms and B's ratio to A; then
the card's name and power limit, and one JSON line of it all. The runs'
JSON goes to --out (default build/composite_ab/). Exits nonzero if an input
or a kernel's bits differ where both trees ran the tile.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
W, H, N, CHUNK = 1920, 1080, 1_000_000, 128
# view -> (tile pairs per Gaussian at tile 32, the probe's pair budget):
# chip_smoke.py's cells
VIEWS = {"sparse": (2.25, 5 << 19), "dense": (33.0, 5 << 23)}
REPS = 10


def sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def device_ms(fn, reps=REPS) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run(tree: Path, tiles, out: Path) -> None:
    """One tree's run (see the module docstring) -> JSON at `out`."""
    sys.path.insert(0, str(tree.resolve()))
    import numpy as np
    import torch

    from gsplat_tpu_torch.render import raster
    from gsplat_tpu_torch.render import render as render_mod
    from gsplat_tpu_torch.render.binning import bin_gaussians, tile_grid
    from gsplat_tpu_torch.render.project import project_gaussians
    from gsplat_tpu_torch.render.render import _attr_rows, contrib_regions
    from gsplat_tpu_torch.tools.bench_scene import scene_on_device

    assert Path(raster.__file__).resolve().is_relative_to(tree.resolve()), raster.__file__
    torch.set_grad_enabled(False)
    res = {}
    for view, (ppg, budget) in VIEWS.items():
        g, cam = scene_on_device(N, W, H, ppg, tile_size=32, device="cuda")
        p = project_gaussians(g, cam)
        for tile in tiles:
            tw, th = tile_grid(W, H, tile)
            kw = dict(width=W, height=H, tile_size=tile, chunk=CHUNK, cull_conic=p.conic,
                      cull_opacity=p.opacity)
            probe = bin_gaussians(p.mean2d, p.radius, p.depth, pair_budget=budget,
                                  kept_budget=budget - CHUNK, **kw)
            n_pairs, n_culled = int(probe.n_pairs), int(probe.n_culled)
            del probe
            pair_fit = min(-(-n_pairs // CHUNK) * CHUNK + CHUNK, budget)
            kept = -(-(n_pairs - n_culled + CHUNK) // CHUNK) * CHUNK
            b = bin_gaussians(p.mean2d, p.radius, p.depth, pair_budget=pair_fit,
                              kept_budget=kept, **kw)
            ts, tc = b.tile_start, b.tile_count
            attrs, gid = _attr_rows(p), b.gid_s[:kept]
            r = res.setdefault(str(tile), {})[view] = {"input": sha(attrs, gid, ts, tc)}
            fwd = dict(tw=tw, tile_size=tile, chunk=CHUNK)
            if hasattr(render_mod, "pair_table"):     # a tree with a gathered table
                rows = render_mod.pair_table(p, b, kept)
            else:
                rows = render_mod._gid_rows(attrs)
                fwd["gid"] = gid
            del b, attrs
            try:
                tiles_k, np_k = raster.composite_fwd(rows, ts, tc, **fwd)
            except ValueError as e:
                r["refused"] = str(e)
                continue
            cot = np.random.default_rng(tile).normal(size=tuple(tiles_k.shape))
            g_tiles = torch.from_numpy(cot.astype(np.float32)).to(tiles_k.device)
            contrib = -(-int(np_k.sum()) * CHUNK // 512) * 512 + 512
            np_c, comp_start, _ = contrib_regions(np_k, CHUNK, contrib)
            args = (rows, ts, tc, comp_start, np_c, tiles_k, g_tiles)
            bwd = dict(fwd, p_out=contrib)
            d = raster.composite_bwd(*args, **bwd)
            r.update(k2=sha(tiles_k, np_k), k3=sha(d), chunks=int(np_k.sum()),
                     k2_ms=device_ms(lambda: raster.composite_fwd(rows, ts, tc, **fwd)),
                     k3_ms=device_ms(lambda: raster.composite_bwd(*args, **bwd))
                     - device_ms(lambda: raster.d_table_prefilled(contrib, d.device)))
            print(f"  {tree} tile {tile} {view}: {r}", flush=True)
            del tiles_k, np_k, g_tiles, d, args, rows, gid
            torch.cuda.empty_cache()
        del g, cam, p
        torch.cuda.empty_cache()
    out.write_text(json.dumps(res, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs=2, type=Path, help="tree A (the parent), tree B")
    ap.add_argument("--tiles", type=int, nargs="+", default=[16, 32, 48, 64, 96, 128])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "composite_ab")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--json", type=Path, help=argparse.SUPPRESS)
    ns = ap.parse_args()
    if ns.run is not None:
        run(ns.run, ns.tiles, ns.json)
        return 0
    out = ns.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    a, b = (t.resolve() for t in ns.trees)
    runs = []
    for i, tree in enumerate((a, b, b, a)):
        path = out / f"run{i}.json"
        cmd = [sys.executable, str(Path(__file__).resolve()), "x", "x", "--run", str(tree),
               "--json", str(path), "--tiles", *map(str, ns.tiles)]
        print(f"run {i}: {tree}", flush=True)
        subprocess.run(cmd, check=True, cwd=tree)
        runs.append((tree, json.loads(path.read_text())))
    summary, bad = {}, []
    for tile in map(str, ns.tiles):
        for view in VIEWS:
            rs = [(tree, r[tile][view]) for tree, r in runs]
            ran = [(tree, x) for tree, x in rs if "k2" in x]
            same = {k: len({x[k] for _, x in ran}) == 1 for k in ("k2", "k3")}
            same["input"] = len({x["input"] for _, x in rs}) == 1
            ms = {}
            for name, tree in (("A", a), ("B", b)):
                xs = [x for t, x in ran if t == tree]
                if xs:
                    ms[name] = {k: statistics.mean(x[k] for x in xs) for k in ("k2_ms", "k3_ms")}
            row = dict(same_bits=same, ms=ms, ran={n: any(t == tr for t, _ in ran)
                                                   for n, tr in (("A", a), ("B", b))})
            if "A" in ms and "B" in ms:
                row["ratio_b_a"] = {k: ms["B"][k] / ms["A"][k] for k in ("k2_ms", "k3_ms")}
            summary[f"{tile} {view}"] = row
            if not all(same.values()):
                bad.append(f"tile {tile} {view}: {same}")
            print(f"tile {tile} {view}: {row}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    print(json.dumps({"card": card, "tiles": summary}))
    (out / "summary.json").write_text(json.dumps({"card": card, "tiles": summary}, indent=1))
    if bad:
        print("bits differ: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
