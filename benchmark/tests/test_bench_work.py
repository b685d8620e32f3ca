"""The roofline yardstick on hand-worked cases: the reference's work counts on
scenes whose blends can be counted by hand, and the operation, byte, share
and mfu arithmetic."""

import math

import torch

from benchmark import reference, work


def splats(rows):
    """(N, 9) rows from (x, y, conic a, b, c, r, g, b, opacity) tuples and a
    projection dict for bin_splats (radius 30, depth by index)."""
    r = torch.tensor(rows, dtype=torch.float32)
    n = r.shape[0]
    proj = {"mean2d": r[:, :2], "radius": torch.full((n,), 30.0),
            "depth": 1.0 + torch.arange(n, dtype=torch.float32)}
    return r, proj


def count(rows, width=16, height=16, ts=16):
    r, proj = splats(rows)
    bins = reference.bin_splats(proj, width, height, ts)
    _, _, wk = reference.composite(r, bins, width, height, ts, torch.zeros(3), chunk=4,
                                   count_work=True)
    return wk


def test_one_flat_splat_blends_every_pixel():
    # conic ~0: alpha = opacity everywhere in the 16x16 tile
    wk = count([(8, 8, 1e-9, 0, 1e-9, 1, 1, 1, 0.5)])
    assert wk == {"pair_pixels": 256, "pairs": 1}


def test_blends_stop_once_the_pixel_saturates():
    # twenty flat splats at alpha 0.5: T in front of the k-th is 0.5^(k-1),
    # >= 1e-4 for k <= 14; the last six blend nothing a compositor needs
    wk = count([(8, 8, 1e-9, 0, 1e-9, 1, 1, 1, 0.5)] * 20)
    assert wk == {"pair_pixels": 14 * 256, "pairs": 14}
    # alpha is clamped at 0.99: T is 0.0099999905^(k-1), so two blend
    wk = count([(8, 8, 1e-9, 0, 1e-9, 1, 1, 1, 1.0)] * 4)
    assert wk == {"pair_pixels": 2 * 256, "pairs": 2}


def test_faint_pixels_are_not_work():
    # a round splat of conic 1 / 4: alpha = 0.5 exp(-r^2 / 8) >= 1/255 for
    # r^2 <= 8 ln(127.5): count the pixels by hand
    wk = count([(8, 8, 0.25, 0, 0.25, 1, 1, 1, 0.5)])
    lim = 8 * math.log(0.5 * 255)
    want = sum(1 for y in range(16) for x in range(16) if (x - 8) ** 2 + (y - 8) ** 2 <= lim)
    assert wk == {"pair_pixels": want, "pairs": 1}


def test_pixels_outside_the_image_are_not_work():
    wk = count([(8, 8, 1e-9, 0, 1e-9, 1, 1, 1, 0.5)], width=10, height=12)
    assert wk["pair_pixels"] == 120


def test_operation_and_byte_counts():
    wk = {"pair_pixels": 1000, "pairs": 10, "visible": 7}
    assert work.k2(wk, 100) == (23 * 1000, 36 * 10 + 16 * 100)
    assert work.k3(wk, 100) == (67 * 1000, 72 * 10 + 28 * 100)
    assert work.step_ops(wk, 100, 59, 5) == (
        3 * work.PROJECT_OPS * 7 + 90 * 1000 + (work.LOSS_OPS + work.LOSS_GRAD_OPS) * 100
        + 12 * 59 * 5)
    assert work.frame_ops(wk, 100) == work.PROJECT_OPS * 7 + 23 * 1000 + 12 * 100


def test_shares_of_the_peaks():
    # 67 GFLOP in 10 ms is 10% of 67 TFLOP/s; 3.35 GB in 10 ms is 10% of HBM
    assert abs(work.roofline_share(67e9, 0, 0.01) - 10.0) < 1e-9
    assert abs(work.roofline_share(0, 3.35e9, 0.01) - 10.0) < 1e-9
    assert abs(work.roofline_share(67e9, 6.7e9, 0.01) - 20.0) < 1e-9
    assert work.roofline_share(1.0, 1.0, None) is None
    assert abs(work.mfu(6.7e12, 1.0) - 10.0) < 1e-9
