"""Evaluation metrics: PSNR, SSIM (skimage's defaults), depth errors and
LPIPS (VGG16), in PyTorch (counterpart of mvsnerf_tpu/eval/metrics.py).

The reference computes PSNR from the MSE (utils.py:12-16), SSIM with
skimage.metrics.structural_similarity's defaults (7x7 uniform window,
K1=0.01, K2=0.03, sample covariance N/(N-1), reflect padding, the window
radius cropped before the mean, channels averaged) and LPIPS with the lpips
VGG network on inputs in [-1, 1] (renderer.ipynb cells 11/16/23). LPIPS
reads its weights from a user-supplied .npz and never downloads them.
Inputs are numpy arrays or tensors; every function works in float32 on the
inputs' device and returns a 0-d tensor.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def _t(x, device=None):
    if torch.is_tensor(x):
        return x.to(device or x.device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def mse2psnr(mse):
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def psnr(img, gt, mask=None):
    """PSNR of [0, 1] images; with an (H, W) `mask`, over the masked
    pixels only (all channels)."""
    img = _t(img)
    gt = _t(gt, img.device)
    if mask is None:
        return mse2psnr(torch.mean((img - gt) ** 2))
    m = _t(mask, img.device)
    if m.dim() == img.dim() - 1:
        m = m[..., None].expand_as(img)
    err = torch.where(m > 0, (img - gt) ** 2, torch.zeros_like(img))
    return mse2psnr(err.sum() / (m > 0).sum())


def abs_error(depth_pred, depth_gt, mask=None):
    """Per-pixel depth abs error, zero outside `mask` (utils.py:67-74)."""
    err = torch.abs(_t(depth_pred) - _t(depth_gt))
    return err if mask is None else err * _t(mask, err.device)


def acc_threshold(depth_pred, depth_gt, mask, threshold):
    """Share of the masked pixels whose depth abs error is below
    `threshold` (utils.py:76-82)."""
    err = torch.abs(_t(depth_pred) - _t(depth_gt))
    m = _t(mask, err.device) > 0
    return ((err < threshold) & m).sum() / torch.clamp(m.sum(), min=1)


def _uniform_filter(x, size):
    """(C, H, W) mean filter of `size` with reflect padding."""
    pad = size // 2
    x = F.pad(x[None], (pad, pad, pad, pad), mode="reflect")
    return F.avg_pool2d(x, size, stride=1)[0]


def ssim(img, gt, data_range: float = 1.0, win_size: int = 7):
    """Structural similarity of (H, W) or (H, W, C) images, channels
    averaged, with skimage's defaults."""
    x = _t(img)
    y = _t(gt, x.device)
    if x.dim() == 2:
        x, y = x[..., None], y[..., None]
    x, y = x.permute(2, 0, 1), y.permute(2, 0, 1)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cov_norm = win_size ** 2 / (win_size ** 2 - 1)
    ux, uy = _uniform_filter(x, win_size), _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / \
        ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    r = (win_size - 1) // 2
    return s[:, r:-r, r:-r].mean(dim=(1, 2)).mean()


# ---------------------------------------------------------------- LPIPS -----

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512]
# tap indices into the per-op activation list: relu1_2, relu2_2, relu3_3,
# relu4_3, relu5_3
LPIPS_TAPS = (1, 4, 8, 12, 16)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS:
    """VGG16 LPIPS distance on `F.conv2d`. The weights file is the JAX
    package's .npz layout: 'conv{i}_kernel' (HWIO) and 'conv{i}_bias' for
    the 13 convolutions, 'lin{j}' (C_j,) for the 5 heads. Raises when the
    file is absent: nothing is downloaded."""

    def __init__(self, weights_path: str, device=None):
        if not os.path.exists(weights_path):
            raise FileNotFoundError(
                f"LPIPS weights not found at {weights_path}; convert the "
                "official lpips VGG weights to npz")
        data = np.load(weights_path)
        self.device = torch.device(device or "cpu")
        self.convs = [
            (_t(np.transpose(data[f"conv{i}_kernel"], (3, 2, 0, 1)),
                self.device),
             _t(data[f"conv{i}_bias"], self.device)) for i in range(13)]
        self.lins = [_t(data[f"lin{j}"], self.device) for j in range(5)]
        self.shift = torch.tensor(_SHIFT, device=self.device)[:, None, None]
        self.scale = torch.tensor(_SCALE, device=self.device)[:, None, None]

    def _features(self, x):
        """(H, W, 3) in [-1, 1] -> the activation after each VGG op."""
        x = ((x.permute(2, 0, 1) - self.shift) / self.scale)[None]
        feats, ci = [], 0
        for v in VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                w, b = self.convs[ci]
                x = F.relu(F.conv2d(x, w, b, padding=1))
                ci += 1
            feats.append(x)
        return feats

    @torch.no_grad()
    def __call__(self, img, gt):
        """img, gt: (H, W, 3) in [-1, 1] -> 0-d LPIPS distance."""
        fa = self._features(_t(img, self.device))
        fb = self._features(_t(gt, self.device))
        total = torch.zeros((), device=self.device)
        for lin, tap in zip(self.lins, LPIPS_TAPS):
            # lpips.normalize_tensor: eps outside the sqrt
            a = fa[tap] / (torch.sqrt((fa[tap] ** 2).sum(1, keepdim=True))
                           + 1e-10)
            b = fb[tap] / (torch.sqrt((fb[tap] ** 2).sum(1, keepdim=True))
                           + 1e-10)
            total = total + ((a - b) ** 2 * lin[:, None, None]).sum(1).mean()
        return total
