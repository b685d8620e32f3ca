"""Synthetic scene builders: tiny on-disk COLMAP scenes and circular camera
rigs.

The port's own copy of gsplat_tpu/io/synthetic.py. It makes the same random
draws in the same order, so one seed gives the JAX writer's scene; its PNGs
are written by the port's codec (io/png.py), and decode to the same pixels.
"""

import math

import numpy as np

from gsplat_tpu_torch.io import colmap, png


def look_at_rig(n_cams: int, radius: float = 4.0, target=(0.0, 0.0, 0.0)):
    """Cameras on a circle looking at the origin. Returns list of (R, T) with
    R = cam->world rotation (CameraInfo convention), T = world->cam translation."""
    rigs = []
    target = np.asarray(target, np.float64)
    for i in range(n_cams):
        ang = 2 * math.pi * i / max(n_cams, 1)
        pos = np.array([radius * math.sin(ang), 0.4 * math.sin(2 * ang), radius * math.cos(ang)])
        fwd = target - pos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        # world->cam rotation rows = (right, up2, fwd); COLMAP: x_cam = R_w2c x + t
        R_w2c = np.stack([right, up2, fwd])
        t = -R_w2c @ pos
        rigs.append((R_w2c.T, t))  # CameraInfo.R = R_w2c.T
    return rigs


def make_colmap_scene(root, n_cams=9, width=64, height=48, n_points=100, seed=0):
    """Write a complete tiny binary COLMAP scene (images + sparse/0) to `root`."""
    rng = np.random.default_rng(seed)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)

    focal = 0.8 * width
    cams = {
        1: colmap.Camera(
            id=1, model="PINHOLE", width=width, height=height,
            params=np.array([focal, focal, width / 2, height / 2]),
        )
    }
    colmap.write_intrinsics_binary(cams, sparse / "cameras.bin")

    imgs = {}
    for i, (R, T) in enumerate(look_at_rig(n_cams), start=1):
        # colmap stores qvec of world->cam rotation = R.T
        q = colmap.rotmat2qvec(R.T)
        name = f"img_{i:03d}.png"
        arr = (rng.random((height, width, 3)) * 255).astype(np.uint8)
        png.write_png(img_dir / name, arr)
        imgs[i] = colmap.Image(
            id=i, qvec=q, tvec=T, camera_id=1, name=name,
            xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64),
        )
    colmap.write_extrinsics_binary(imgs, sparse / "images.bin")

    xyz = rng.normal(size=(n_points, 3)) * 0.8
    rgb = rng.integers(0, 256, size=(n_points, 3)).astype(np.uint8)
    colmap.write_points3D_binary(xyz, rgb, np.zeros(n_points), sparse / "points3D.bin")
    return root
