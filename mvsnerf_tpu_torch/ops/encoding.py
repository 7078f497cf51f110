"""NeRF positional encoding (counterpart of mvsnerf_tpu/ops/encoding.py).

Channel order is [x, sin(x f_0), ..., sin(x f_{K-1}), cos(x f_0), ...,
cos(x f_{K-1})]: all sines, frequency-major, then all cosines. The
mvsnerf-v0 checkpoint's pts_linears.0 expects exactly that order.
"""

from __future__ import annotations

import torch


def positional_encoding(x, num_freqs: int):
    """(..., d) -> (..., d * (1 + 2 * num_freqs)), frequencies
    2**linspace(0, num_freqs - 1, num_freqs), input included."""
    if num_freqs == 0:
        return x
    freqs = 2.0 ** torch.linspace(0.0, num_freqs - 1, num_freqs,
                                  device=x.device)
    scaled = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(scaled), torch.cos(scaled)], dim=-1)
