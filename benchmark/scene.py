"""The benchmark's inputs: a scene, its cameras and targets, made from the seed.

The scene is a frozen copy of the draws of the port's
`tools/bench_scene.py::build_scene` (itself `bench.py`'s): n Gaussians on a
normal cloud flattened along z in front of the camera, scales sized so that
a splat covers a target count of tiles at the scene tile, opacity logits 0
and SH rest coefficients 0. With the configuration's `aniso` > 0, as with
build_scene's, each splat's first axis is stretched by U[1, 1 + aniso] and
its second shrunk by the same factor, under a random (unnormalised)
quaternion. Here the draws are made on the device with one
`torch.Generator` seeded from `--seed`, in a few large calls, and the DC
colour range comes from the configuration.

Cameras orbit the cloud's centre: a view is a yaw about y and a pitch about
x of the bench camera (identity rotation, the cloud `z_mean` ahead). The
matrices are built here, in float64 numpy as 3DGS builds them (row-vector
convention: world_view = W2V^T, full_proj = world_view @ P^T), and handed
alike to the program and to the plain reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0
PAD_LOGIT = -30.0       # the inert padding rows' opacity logit and log-scale
# salts that give each seeded stream its own generator
SALT_SCENE, SALT_TARGETS, SALT_BG, SALT_VIEWS, SALT_SAMPLE = 1, 2, 3, 4, 5


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A torch.Generator on `device` for one stream of the run's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))
    return gen


def host_rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), salt])


def splat_log_scale(cfg: Dict) -> float:
    """The log of the isotropic scale that gives a splat at depth z_mean a
    3-sigma radius of scene_tile * (sqrt(tile pairs) - 1) / 2 pixels."""
    focal = 0.5 * cfg["width"] / math.tan(cfg["fovx"] / 2)
    radius_px = cfg["scene_tile"] * (math.sqrt(cfg["tile_pairs_per_gaussian"]) - 1.0) / 2.0
    return math.log(radius_px * cfg["z_mean"] / (3.0 * focal))


def build_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The scene's six parameter leaves, padded to the capacity with inert
    rows, float32 on `device`: xyz, f_dc, f_rest, opacity, scaling, rotation
    (the 3DGS names and shapes)."""
    n, cap = cfg["n_gaussians"], cfg["capacity"]
    k = (cfg["sh_degree"] + 1) ** 2 - 1
    gen = generator(seed, SALT_SCENE, device)
    f32 = dict(dtype=torch.float32, device=device)
    xyz = torch.zeros((cap, 3), **f32)
    xyz[:n] = torch.randn((n, 3), generator=gen, **f32)
    xyz[:n, 2] *= cfg["depth_squash"]
    lo, hi = cfg["f_dc_range"]
    f_dc = torch.zeros((cap, 3), **f32)
    f_dc[:n] = lo + (hi - lo) * torch.rand((n, 3), generator=gen, **f32)
    opacity = torch.full((cap, 1), PAD_LOGIT, **f32)
    opacity[:n] = 0.0
    scaling = torch.full((cap, 3), PAD_LOGIT, **f32)
    scaling[:n] = splat_log_scale(cfg)
    rotation = torch.zeros((cap, 4), **f32)
    rotation[:, 0] = 1.0
    aniso = cfg.get("aniso", 0.0)
    if aniso > 0:
        stretch = torch.log1p(aniso * torch.rand(n, generator=gen, **f32))
        scaling[:n, 0] += stretch
        scaling[:n, 1] -= stretch
        rotation[:n] = torch.randn((n, 4), generator=gen, **f32)
    return {"xyz": xyz, "f_dc": f_dc, "f_rest": torch.zeros((cap, k, 3), **f32),
            "opacity": opacity, "scaling": scaling, "rotation": rotation}


def view_rotation(yaw_deg: float, pitch_deg: float) -> np.ndarray:
    """Q = Rx(pitch) Ry(yaw): world -> view rotation of an orbit view."""
    a, b = math.radians(yaw_deg), math.radians(pitch_deg)
    ry = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                   [-math.sin(a), 0.0, math.cos(a)]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, math.cos(b), -math.sin(b)],
                   [0.0, math.sin(b), math.cos(b)]])
    return rx @ ry


def projection_matrix(fovx: float, fovy: float) -> np.ndarray:
    """3DGS's getProjectionMatrix (OpenGL-style, z_sign +1), float64."""
    top, right = math.tan(fovy / 2) * ZNEAR, math.tan(fovx / 2) * ZNEAR
    p = np.zeros((4, 4))
    p[0, 0] = ZNEAR / right
    p[1, 1] = ZNEAR / top
    p[3, 2] = 1.0
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return p


def view_matrices(cfg: Dict, yaw_deg: float, pitch_deg: float) -> Dict[str, np.ndarray]:
    """An orbit view's float32 matrices in the row-vector convention:
    world_view (4, 4), full_proj (4, 4), cam_center (3,)."""
    w2v = np.eye(4)
    w2v[:3, :3] = view_rotation(yaw_deg, pitch_deg)
    w2v[:3, 3] = (0.0, 0.0, cfg["z_mean"])
    world_view = w2v.T
    full_proj = world_view @ projection_matrix(cfg["fovx"], cfg["fovy"]).T
    cam_center = np.linalg.inv(world_view)[3, :3]
    return {"world_view": world_view.astype(np.float32),
            "full_proj": full_proj.astype(np.float32),
            "cam_center": cam_center.astype(np.float32)}


def train_views(seed: int, count: int, yaw_deg: float, pitch_deg: float
                ) -> List[Tuple[float, float]]:
    """`count` (yaw, pitch) pairs, each uniform in +-yaw_deg, +-pitch_deg."""
    rng = host_rng(seed, SALT_VIEWS)
    yaw = rng.uniform(-yaw_deg, yaw_deg, count)
    pitch = rng.uniform(-pitch_deg, pitch_deg, count)
    return [(float(a), float(b)) for a, b in zip(yaw, pitch)]


def camera_extent(cfg: Dict, views: Sequence[Tuple[float, float]]) -> float:
    """3DGS's getNerfppNorm radius of the views' centres: 1.1 times the
    largest distance from their mean (the xyz learning rate's scale)."""
    centres = np.stack([view_matrices(cfg, *v)["cam_center"].astype(np.float64)
                        for v in views])
    return float(1.1 * np.linalg.norm(centres - centres.mean(0), axis=1).max())


class ViewOrder:
    """Train views in a seeded random order without replacement, one epoch
    after another, as the training loop pops its view stack."""

    def __init__(self, seed: int, count: int):
        self.rng = host_rng(seed, SALT_VIEWS + 100)
        self.count = count
        self.stack: List[int] = []
        self.popped = 0

    def next(self) -> int:
        self.popped += 1
        if not self.stack:
            self.stack = [int(i) for i in self.rng.permutation(self.count)]
        return self.stack.pop()


def orbit_yaw(frame: int, phase: float, direction: float, yaw_deg: float,
              sweep_frames: int) -> float:
    """The viewer's yaw at a frame: a sine sweep across +-yaw_deg and back
    every sweep_frames frames, from a seeded phase in a seeded direction."""
    return yaw_deg * math.sin(2.0 * math.pi * (phase + direction * frame / sweep_frames))


def orbit_start(seed: int) -> Tuple[float, float]:
    """(phase in [0, 1), direction +-1) of a run's orbit."""
    rng = host_rng(seed, SALT_VIEWS + 200)
    return float(rng.uniform()), float(rng.choice([-1.0, 1.0]))
