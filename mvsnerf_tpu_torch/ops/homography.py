"""Plane-sweep cost volume (counterpart of mvsnerf_tpu/ops/homography.py).

Geometry: for reference pixel (x, y) on depth plane d, the source pixel is
p_src ~ R @ [x, y, 1] + T / d with [R | T] = src_proj @ ref_proj_inv at the
stride-4 feature scale, sampled bilinearly with zeros padding,
align_corners=True. The sweep itself is kernel K1 (ops/sweep.py).
"""

from __future__ import annotations

import torch

from .interp import interpolate_bilinear_resize
from .sweep import plane_sweep_pix_coords, sweep_cost_volume

__all__ = ["build_cost_volume", "plane_sweep_pix_coords"]


def build_cost_volume(imgs, feats, proj_mats, depth_values, pad: int = 0):
    """Cross-view variance cost volume with warped source RGB
    (models.py:839-893, `build_volume_costvar_img`), dense layout.

    Args:
        imgs: (V, H, W, 3) source images at full resolution (view 0 = ref).
        feats: (V, h, w, C) stride-4 feature maps.
        proj_mats: (V, 3, 4) relative projections (only views 1: are used).
        depth_values: (D,).
        pad: feature-grid padding.
    Returns:
        cost (D, hp, wp, 3V + C) channel-last, channels [ref RGB, warped src
        RGB x (V-1), variance(C)], the mask count normalised per view. It is
        a view of the sweep's channels_last_3d (1, 3V + C, D, hp, wp)
        tensor: `cost.permute(3, 0, 1, 2)[None]` is that tensor, no copy.
    """
    _, h, w, C = feats.shape
    # images to feature resolution (models.py:859, align_corners=False)
    imgs_l = torch.stack([interpolate_bilinear_resize(im, h, w)
                          for im in imgs])
    srcs = torch.cat([feats, imgs_l], dim=-1).contiguous()
    cost = sweep_cost_volume(srcs, proj_mats.contiguous(),
                             depth_values.contiguous(), pad, C)
    return cost[0].permute(1, 2, 3, 0)
