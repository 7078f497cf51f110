"""ABN, conv blocks and multi-head attention (counterpart of
mvsnerf_tpu/models/layers.py).

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


class MultiHeadAttention(nn.Module):
    """Residual + LayerNorm multi-head attention over the few source-view
    tokens of a sample (reference models.py:70-141, JAX
    `layers.multi_head_attention` :152-186). q, k, v are (B, L, d_model);
    `w_qs`, `w_ks`, `w_vs` and `fc` carry no bias, as in the reference. A
    `mask` (B, L, 1) sets the scores of its zero rows to -1e9 (JAX
    :163-166: the mask broadcasts as (B, 1, L, 1), over the queries).
    Returns (out (B, L, d_model), attention (B, n_head, L, L))."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 device=None):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False,
                              device=device)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False,
                              device=device)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False,
                              device=device)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False, device=device)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6, device=device)

    def forward(self, q, k, v, mask=None):
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        residual = q
        qh = self.w_qs(q).view(B, Lq, self.n_head, self.d_k).transpose(1, 2)
        kh = self.w_ks(k).view(B, Lk, self.n_head, self.d_k).transpose(1, 2)
        vh = self.w_vs(v).view(B, Lk, self.n_head, self.d_v).transpose(1, 2)
        attn = (qh / self.d_k ** 0.5) @ kh.transpose(2, 3)
        if mask is not None:
            attn = attn.masked_fill(mask[:, None] == 0, -1e9)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ vh).transpose(1, 2).reshape(B, Lq, -1)
        return self.layer_norm(self.fc(out) + residual), attn
