"""LPIPS (Learned Perceptual Image Patch Similarity), VGG16 variant, in torch.

Port of gsplat_tpu/lpips.py: the scoring function of upstream 3DGS's
`metrics.py` (the `lpips` package, net='vgg', eval mode). Real scores need
the two standard weight files, which the user supplies:

  1. torchvision's VGG16 state_dict (`vgg16-397923af.pth`), the backbone;
  2. the lpips package's `vgg.pth`, the five learned 1x1 channel weightings.

`load_lpips_weights(vgg_path, lin_path)` reads both (`.pth` through
`torch.load(weights_only=True)`, or `.npz` copies of the same tensors) into
the JAX package's layout of numpy arrays; `lpips_to_device` moves them to a
device once; `lpips(params, img0, img1)` scores two (H, W, 3) images in
[0, 1] on the images' device (numpy images: the card, unless
`device='cpu'`).

Architecture: scale inputs to [-1, 1], normalise by the fixed shift/scale
layer, run the VGG16 features, tap relu1_2/relu2_2/relu3_3/relu4_3/relu5_3,
unit-normalise each tap along channels, squared difference, the learned 1x1
weighting per tap, spatial mean, sum over taps. The pools are 2x2, stride
2, floor mode: an odd side drops its last row or column, as the
reference's VALID window does (1080 rows: 540, 270, 135, then 67).

The reference convolves at full fp32 (`Precision.HIGHEST`). PyTorch lets
cuDNN run convolutions in TF32 by default (`torch.backends.cudnn.allow_tf32`),
whose 10-bit mantissa compounds through 13 layers, so the whole forward runs
inside train/loss.py's `_cudnn_fp32()`, whatever the global flag says.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from gsplat_tpu_torch._device import resolve_device
from gsplat_tpu_torch.train.loss import _cudnn_fp32

# torchvision vgg16 `features.<i>` indices of the conv layers, grouped by the
# slice they belong to; each tap point is the ReLU after the group's last conv.
VGG16_SLICES: Tuple[Tuple[int, ...], ...] = (
    (0, 2),            # conv1_1 conv1_2 -> relu1_2   (64 ch)
    (5, 7),            # conv2_1 conv2_2 -> relu2_2   (128 ch)
    (10, 12, 14),      # conv3_*         -> relu3_3   (256 ch)
    (17, 19, 21),      # conv4_*         -> relu4_3   (512 ch)
    (24, 26, 28),      # conv5_*         -> relu5_3   (512 ch)
)
TAP_CHANNELS = (64, 128, 256, 512, 512)

# lpips.ScalingLayer constants (inputs already mapped to [-1, 1])
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

Array = Union[np.ndarray, torch.Tensor]


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return np.asarray(t, np.float32)
    return np.asarray(t.detach().cpu().numpy(), np.float32)


def _load_state_dict(path: Path) -> Dict[str, np.ndarray]:
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: np.asarray(z[k], np.float32) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: _to_numpy(v) for k, v in sd.items()}


def load_lpips_weights(vgg_path, lin_path) -> Dict[str, List]:
    """-> params dict: conv kernels/biases per slice + the five lin weights,
    numpy float32 (the JAX package's layout).

    `vgg_path`: torchvision vgg16 state_dict (keys `features.<i>.weight/bias`)
    or an .npz with the same keys. `lin_path`: lpips vgg.pth (keys
    `lin<k>.model.1.weight`, 1x1 convs, no bias) or an .npz with those keys.
    """
    vgg = _load_state_dict(vgg_path)
    lin = _load_state_dict(lin_path)
    convs = [[(vgg[f"features.{i}.weight"], vgg[f"features.{i}.bias"]) for i in sl]
             for sl in VGG16_SLICES]
    lins = [lin[f"lin{k}.model.1.weight"].reshape(1, ch, 1, 1)
            for k, ch in enumerate(TAP_CHANNELS)]
    return {"convs": convs, "lins": lins}


def lpips_to_device(params: dict, device: Union[str, torch.device]) -> dict:
    """The params dict with every array a float32 tensor on `device` (one
    copy each, so that repeated scoring does not copy the weights again)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32) if isinstance(a, np.ndarray) else a,
                               dtype=torch.float32, device=device)

    return {"convs": [[(t(w), t(b)) for w, b in layers] for layers in params["convs"]],
            "lins": [t(w) for w in params["lins"]]}


def lpips(params: dict, img0: Array, img1: Array,
          device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) images in [0, 1] -> a 0-d float32
    tensor, on the first image's device when it is a tensor, else on
    `device` (default: the CUDA card; it raises without one unless 'cpu' is
    named). Weights held elsewhere are copied there on each call: see
    `lpips_to_device`."""
    if isinstance(img0, torch.Tensor):
        device = img0.device
    else:
        device = resolve_device(device)
    x0 = torch.as_tensor(img0, dtype=torch.float32, device=device)
    x1 = torch.as_tensor(img1, dtype=torch.float32, device=device)
    p = lpips_to_device(params, device)
    shift = torch.from_numpy(_SHIFT).to(device).view(1, 3, 1, 1)
    scale = torch.from_numpy(_SCALE).to(device).view(1, 3, 1, 1)

    def prep(im):
        x = im.permute(2, 0, 1)[None] * 2.0 - 1.0          # [-1, 1]
        return (x - shift) / scale

    def taps(x):
        out = []
        for si, layers in enumerate(p["convs"]):
            if si > 0:
                x = F.max_pool2d(x, 2, 2)
            for w, b in layers:
                x = torch.clamp(F.conv2d(x, w, b, padding=1), min=0.0)
            out.append(x)
        return out

    def unit_norm(f):
        return f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)

    with torch.no_grad(), _cudnn_fp32():
        f0, f1 = taps(prep(x0)), taps(prep(x1))
        total = torch.zeros((), dtype=torch.float32, device=device)
        for t0, t1, lw in zip(f0, f1, p["lins"]):
            d = (unit_norm(t0) - unit_norm(t1)) ** 2            # (1, ch, h, w)
            total = total + torch.mean(torch.sum(lw * d, dim=1, keepdim=True))
    return total
