"""PLY IO for point clouds and the standard 3DGS `point_cloud.ply` layout.

The port's own numpy copy of gsplat_tpu/io/ply.py (BasicPointCloud,
read_ply, write_ply, fetch_ply, store_ply, save_gaussian_ply,
load_gaussian_ply): a self-contained binary_little_endian codec, so a
trained upstream or gsplat_tpu model loads without plyfile.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1",
    "uchar": "u1",
    "short": "i2",
    "ushort": "u2",
    "int": "i4",
    "uint": "u4",
    "float": "f4",
    "double": "f8",
}


@dataclass
class BasicPointCloud:
    """Mirrors upstream 3DGS's BasicPointCloud (points/colors/normals)."""

    points: np.ndarray  # (N,3) float
    colors: np.ndarray  # (N,3) float in [0,1]
    normals: np.ndarray  # (N,3) float


def read_ply(path: str | Path) -> Dict[str, np.ndarray]:
    """Read a binary/ascii PLY 'vertex' element into a dict of columns."""
    raw = Path(path).read_bytes()
    header_end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:header_end].decode("ascii").splitlines()
    fmt = None
    n_vertex = 0
    props: List[Tuple[str, str]] = []
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n_vertex = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((parts[2], _PLY_DTYPES[parts[1]]))
    if fmt == "ascii":
        body = raw[header_end:].decode("ascii").split()
        arr = np.array(body, dtype=np.float64).reshape(n_vertex, len(props))
        return {name: arr[:, i].astype(dt) for i, (name, dt) in enumerate(props)}
    endian = "<" if fmt == "binary_little_endian" else ">"
    dtype = np.dtype([(name, endian + dt) for name, dt in props])
    rec = np.frombuffer(raw, dtype=dtype, count=n_vertex, offset=header_end)
    return {name: np.ascontiguousarray(rec[name]) for name, _ in props}


def write_ply(path: str | Path, columns: Dict[str, np.ndarray]) -> None:
    """Write named equal-length 1-D columns as one binary_little_endian vertex element."""
    names = list(columns)
    n = len(columns[names[0]])
    inv = {v: k for k, v in _PLY_DTYPES.items()}
    cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
    hdr = io.StringIO()
    hdr.write("ply\nformat binary_little_endian 1.0\n")
    hdr.write(f"element vertex {n}\n")
    for name in names:
        hdr.write(f"property {inv[cols[name].dtype.str[1:]]} {name}\n")
    hdr.write("end_header\n")
    rec = np.empty(n, dtype=[(name, cols[name].dtype.str) for name in names])
    for name in names:
        rec[name] = cols[name]
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        f.write(hdr.getvalue().encode("ascii"))
        f.write(rec.tobytes())


def fetch_ply(path: str | Path) -> BasicPointCloud:
    """Upstream `fetchPly`: read xyz/rgb/normals point cloud (colors /255)."""
    cols = read_ply(path)
    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float64)
    if "red" in cols:
        colors = (
            np.stack([cols["red"], cols["green"], cols["blue"]], axis=-1).astype(np.float64)
            / 255.0
        )
    else:
        colors = np.zeros_like(pts)
    if "nx" in cols:
        normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=-1).astype(np.float64)
    else:
        normals = np.zeros_like(pts)
    return BasicPointCloud(points=pts, colors=colors, normals=normals)


def store_ply(path: str | Path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Upstream `storePly`: xyz float + rgb uchar + zero normals."""
    xyz = np.asarray(xyz, dtype=np.float32)
    rgb = np.asarray(rgb, dtype=np.uint8)
    zeros = np.zeros(len(xyz), dtype=np.float32)
    write_ply(
        path,
        {
            "x": xyz[:, 0],
            "y": xyz[:, 1],
            "z": xyz[:, 2],
            "nx": zeros,
            "ny": zeros,
            "nz": zeros,
            "red": rgb[:, 0],
            "green": rgb[:, 1],
            "blue": rgb[:, 2],
        },
    )


def save_gaussian_ply(
    path: str | Path,
    xyz: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    opacity: np.ndarray,
    scaling: np.ndarray,
    rotation: np.ndarray,
) -> None:
    """Standard 3DGS `point_cloud.ply` layout (raw/pre-activation values).

    features_dc: (N,3); features_rest: (N,M,3) SH rest coeffs; opacity: (N,1)
    logit; scaling: (N,3) log; rotation: (N,4).
    """
    n = len(xyz)
    cols: Dict[str, np.ndarray] = {}
    for i, ax in enumerate("xyz"):
        cols[ax] = np.asarray(xyz[:, i], np.float32)
    for ax in ("nx", "ny", "nz"):
        cols[ax] = np.zeros(n, np.float32)
    for i in range(3):
        cols[f"f_dc_{i}"] = np.asarray(features_dc[:, i], np.float32)
    # upstream flattens (N, M, 3) transposed to (N, 3, M) then C-order
    rest = np.transpose(np.asarray(features_rest, np.float32), (0, 2, 1)).reshape(n, -1)
    for i in range(rest.shape[1]):
        cols[f"f_rest_{i}"] = rest[:, i]
    cols["opacity"] = np.asarray(opacity, np.float32).reshape(n)
    for i in range(scaling.shape[1]):
        cols[f"scale_{i}"] = np.asarray(scaling[:, i], np.float32)
    for i in range(rotation.shape[1]):
        cols[f"rot_{i}"] = np.asarray(rotation[:, i], np.float32)
    write_ply(path, cols)


def load_gaussian_ply(path: str | Path) -> Dict[str, np.ndarray]:
    """Inverse of `save_gaussian_ply` -> dict of raw parameter arrays."""
    cols = read_ply(path)
    n = len(cols["x"])
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], -1)
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], -1)
    rest_names = sorted(
        (k for k in cols if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    m = len(rest_names) // 3
    rest = np.stack([cols[k] for k in rest_names], -1).reshape(n, 3, m).transpose(0, 2, 1)
    scale_names = sorted(
        (k for k in cols if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1])
    )
    rot_names = sorted(
        (k for k in cols if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1])
    )
    return {
        "xyz": xyz,
        "features_dc": f_dc,
        "features_rest": rest,
        "opacity": cols["opacity"].reshape(n, 1),
        "scaling": np.stack([cols[k] for k in scale_names], -1),
        "rotation": np.stack([cols[k] for k in rot_names], -1),
    }
