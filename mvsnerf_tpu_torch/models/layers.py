"""ABN and conv blocks (counterpart of mvsnerf_tpu/models/layers.py).

ABN replicates `inplace_abn.InPlaceABN` as the reference runs it: the
reference keeps MVSNet in train mode even at inference, so normalisation
always uses BATCH statistics (biased variance, eps 1e-5), followed by
LeakyReLU(0.01). The running statistics are stored for checkpoint parity
and never read; `BatchNorm.eval()` semantics are deliberately absent.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


EPS, SLOPE = 1e-5, 0.01


class ABN(nn.Module):
    """Batch-statistics BatchNorm + LeakyReLU(0.01) over dim 1."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long, device=device))

    def forward(self, x):
        y = F.batch_norm(x, None, None, self.weight, self.bias,
                         training=True, eps=EPS)
        return F.leaky_relu(y, SLOPE)


class ConvBnReLU(nn.Module):
    """Conv2d (no bias) + ABN; keys `conv.weight`, `bn.*`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, pad: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=pad, bias=False, device=device)
        self.bn = ABN(cout, device=device)

    def forward(self, x):
        return self.bn(self.conv(x))


class ConvBnReLU3D(nn.Module):
    """Conv3d (no bias) + ABN; keys `conv.weight`, `bn.*`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, pad: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel_size, stride=stride,
                              padding=pad, bias=False, device=device)
        self.bn = ABN(cout, device=device)

    def forward(self, x):
        return self.bn(self.conv(x))
