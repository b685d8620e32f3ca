"""The work a step or a frame needs, and the card's peaks: the roofline yardstick.

Every count here comes from the cell's inputs through the plain reference
(`reference.composite(..., count_work=True)`), never from a counter of the
program: a change to the program's culls moves its time, not this work.

Counted units:
- `pair_pixels`: the pair-pixels with alpha >= 1/255 in front of which the
  pixel's transmittance is still >= 1e-4 (upstream 3DGS's early stop): the
  blends any front-to-back compositor has to make.
- `pairs`: the pairs with at least one such pixel: the splat rows a
  compositor has to read.
- `visible`: the splats the projection keeps (radius > 0).

Float32 operations, an FMA counted as two, exp as one, a compare or min as
one; nothing that a pair's row can hold ahead of the pixel loop is counted.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM5 data sheet: dense fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
FLOAT = 4

# K2, a blend: dx, dy (2); the quadratic form a dx^2 + b dx dy + c dy^2
# with the halves folded into the row: 3 squares and products, 3
# multiplies, 2 adds (8); exp (1); opacity * G, the 0.99 clamp and the 1/255
# test (3); the weight alpha * T (1); three colour FMAs (6); T * (1 - alpha)
# (2)
BLEND_OPS = 2 + 8 + 1 + 3 + 1 + 6 + 2
# K3, a blend's gradient (3DGS's backward, back to front): the alpha again
# (2 + 8 + 1 + 3 = 14); T before it, T / (1 - alpha) (2); the colour
# gradients, weight and three FMAs (1 + 6); dL/dalpha: three (colour -
# behind) FMAs, times T, less the background's share (3 * 3 + 1 + 2); the
# colour behind, three lerps (3 * 3); dL/dopacity and dL/dpower (2 + 1 + 1);
# dL/dmean: two FMAs a coordinate and the accumulation (2 * 3 + 4); dL/dconic:
# three products and three FMAs (3 + 6)
BLEND_GRAD_OPS = 14 + 2 + 7 + 12 + 9 + 4 + 10 + 9
# a row a compositor reads (mean 2, conic 3, colour 3, opacity 1) and a
# gradient row K3 writes (the same nine)
ROW_BYTES = 9 * FLOAT
# K2 writes colour and transmittance a pixel; K3 reads them and the
# colour's cotangent
FWD_PIXEL_BYTES = 4 * FLOAT
BWD_PIXEL_BYTES = (4 + 3) * FLOAT
# the projection of a splat at SH degree 3: the view and clip transforms
# (2 * 12 + 12); the quaternion's rotation (4 + 2 + 18); the 3D covariance,
# six entries of three products and two adds (6 * 8); the Jacobian with its
# clamps (12); A = J W (6 * 3); A Sigma A^T (6 * 5 + 3 * 5); the inverse and
# the radius (12 + 8); ndc2pix (6); the view direction (9); the SH basis
# (20) and 16 coefficients x 3 FMAs (96); sigmoid and exp (4)
PROJECT_OPS = 36 + 24 + 48 + 12 + 18 + 45 + 20 + 6 + 9 + 20 + 96 + 4
# autograd's backward of it: at least the forward's operations twice
PROJECT_GRAD_OPS = 2 * PROJECT_OPS
# the loss a pixel: L1 (3 a channel); SSIM's five maps (3 products a
# channel) blurred by 11 + 11 taps (44 FMA flops each) and its formula (16
# a channel); the backward: the blur of the five cotangents and the
# formula's gradient (44 * 5 + 24 a channel)
LOSS_OPS = 3 * (3 + 3 + 5 * 44 + 16)
LOSS_GRAD_OPS = 3 * (5 * 44 + 24 + 3)
# Adam a parameter: two moment FMAs and a square (5), the bias corrections
# (2), sqrt, eps, divide, learning rate, subtract (5)
ADAM_OPS = 12
# image_to_bytes a channel: clamp (2), scale (1), convert (1)
BYTES_OPS = 4


def roofline_share(ops: float, nbytes: float, seconds: Optional[float]) -> Optional[float]:
    """The least time the card needs (ops at the fp32 peak or bytes at the
    HBM peak, whichever is longer) as a percent of `seconds`; None without
    a time."""
    if not seconds:
        return None
    return 100.0 * max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) / seconds


def k2(work: Dict, pixels: int):
    """(operations, bytes) of one forward compositing of the image."""
    return BLEND_OPS * work["pair_pixels"], ROW_BYTES * work["pairs"] + FWD_PIXEL_BYTES * pixels


def k3(work: Dict, pixels: int):
    """(operations, bytes) of one backward compositing: rows in, gradient
    rows out."""
    return (BLEND_GRAD_OPS * work["pair_pixels"],
            2 * ROW_BYTES * work["pairs"] + BWD_PIXEL_BYTES * pixels)


def step_ops(work: Dict, pixels: int, params: int, live: int) -> float:
    """Operations of one training step: projection and its gradient, the
    compositing both ways, the loss both ways, Adam over the live splats'
    parameters (`params` a splat)."""
    return ((PROJECT_OPS + PROJECT_GRAD_OPS) * work["visible"]
            + (BLEND_OPS + BLEND_GRAD_OPS) * work["pair_pixels"]
            + (LOSS_OPS + LOSS_GRAD_OPS) * pixels + ADAM_OPS * params * live)


def frame_ops(work: Dict, pixels: int) -> float:
    """Operations of one viewer frame: projection, compositing, the bytes."""
    return (PROJECT_OPS * work["visible"] + BLEND_OPS * work["pair_pixels"]
            + BYTES_OPS * 3 * pixels)


def mfu(ops: float, seconds: Optional[float]) -> Optional[float]:
    """ops over `seconds` as a percent of the fp32 peak."""
    if not seconds:
        return None
    return 100.0 * ops / seconds / PEAK_FP32_FLOPS
