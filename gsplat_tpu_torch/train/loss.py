"""Training losses: L1 + D-SSIM (lambda_dssim weighting) and PSNR.

Port of gsplat_tpu/train/loss.py. Upstream 3DGS semantics (pytorch-ssim):
11x11 Gaussian window, sigma 1.5, C1 = 0.01^2, C2 = 0.03^2, zero SAME
padding; loss = (1 - lambda) * L1 + lambda * (1 - SSIM), lambda 0.2.

The reference blurs in full float32 (banded matmuls at HIGHEST precision).
Here the separable blur is two depthwise convolutions that run with cuDNN's
TF32 switched off, in the forward and in the backward alike, whatever the
global flags say: PyTorch turns TF32 on for cuDNN convolutions by default,
and TF32's 10-bit mantissa would put the loss ~1e-4 off. The blur is its own
adjoint (a symmetric window, zero padding), so its backward is the same
blur of the cotangent.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse(pred, gt), min=1e-12))


def _gaussian_window(size: int, sigma: float, dtype, device) -> torch.Tensor:
    x = torch.arange(size, dtype=dtype, device=device) - size // 2
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / g.sum()


@contextlib.contextmanager
def _cudnn_fp32():
    """cuDNN convolutions in full fp32 inside the block, the flag restored."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _blur_nchw(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> separable zero-padded SAME blur, rows then columns."""
    c, half = x.shape[1], window.shape[0] // 2
    with _cudnn_fp32():
        x = F.conv2d(x, window.view(1, 1, -1, 1).expand(c, 1, -1, 1),
                     padding=(half, 0), groups=c)
        return F.conv2d(x, window.view(1, 1, 1, -1).expand(c, 1, 1, -1),
                        padding=(0, half), groups=c)


class _Blur(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window):
        ctx.save_for_backward(window)
        return _blur_nchw(x, window)

    @staticmethod
    def backward(ctx, g):
        (window,) = ctx.saved_tensors
        return _blur_nchw(g.contiguous(), window), None


def _blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, C) separable depthwise Gaussian blur, zero SAME
    padding, full fp32."""
    x = img.permute(2, 0, 1).unsqueeze(0).contiguous()
    return _Blur.apply(x, window)[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2
         ) -> torch.Tensor:
    """Mean SSIM over (H, W, 3) images in [0, 1]. The five blurred images
    run as one 15-channel blur."""
    w = _gaussian_window(window_size, sigma, img1.dtype, img1.device)
    c = img1.shape[-1]
    blurred = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                              dim=-1), w)
    mu1, mu2, b11, b22, b12 = torch.split(blurred, c, dim=-1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = b11 - mu1_sq
    sigma2_sq = b22 - mu2_sq
    sigma12 = b12 - mu1_mu2
    num = (2 * mu1_mu2 + c1) * (2 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return (num / den).mean()


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - l) * L1 + l * (1 - SSIM), the upstream 3DGS training objective."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt))
