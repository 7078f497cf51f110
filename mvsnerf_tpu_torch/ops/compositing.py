"""Alpha compositing (counterpart of mvsnerf_tpu/ops/compositing.py).

The reference's quirks are kept: alpha = 1 - exp(-sigma) with NO
inter-sample distance, and a 1e-10 epsilon in the transmittance product.
"""

from __future__ import annotations

import torch


def raw2alpha(sigma):
    """(N, S) density -> (alpha, weights), each (N, S)."""
    alpha = 1.0 - torch.exp(-sigma)
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(
        torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1)[..., :-1]
    return alpha, alpha * trans


def raw2outputs(raw, z_vals, white_bkgd: bool = False):
    """Composite raw RGBA along rays.

    Args:
        raw: (N, S, 4+) with rgb in [..., :3] and sigma at [..., 3].
        z_vals: (N, S).
    Returns:
        dict of rgb (N, 3), disp, acc, depth (N,), weights, alpha (N, S).
    """
    rgb = raw[..., :3]
    alpha, weights = raw2alpha(raw[..., 3])
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb": rgb_map, "disp": disp_map, "acc": acc_map,
            "weights": weights, "depth": depth_map, "alpha": alpha}
