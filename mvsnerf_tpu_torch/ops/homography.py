"""Plane-sweep cost volume (counterpart of mvsnerf_tpu/ops/homography.py).

Geometry: for reference pixel (x, y) on depth plane d, the source pixel is
p_src ~ R @ [x, y, 1] + T / d with [R | T] = src_proj @ ref_proj_inv at the
stride-4 feature scale, sampled bilinearly with zeros padding,
align_corners=True. The sweep itself is kernel K1 (ops/sweep.py).

The reference helpers beside it (`plane_sweep_grid`, `homo_warp`,
`in_bounds_mask`, `build_cost_volume_feat`, and `sweep_side_outputs`,
`build_cost_volume`'s in-bounds masks and warped colours) are what JAX
computes in XLA, outside any Pallas kernel: here `F.grid_sample`. No
trainer calls them; `build_cost_volume` returns the cost volume alone, so
the main path never pays for the side outputs (225 MB at DTU width).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .interp import grid_sample_2d, interpolate_bilinear_resize
from .sweep import plane_sweep_pix_coords, sweep_cost_volume

__all__ = ["build_cost_volume", "build_cost_volume_feat", "homo_warp",
           "in_bounds_mask", "plane_sweep_grid", "plane_sweep_pix_coords",
           "sweep_side_outputs"]


def build_cost_volume(imgs, feats, proj_mats, depth_values, pad: int = 0):
    """Cross-view variance cost volume with warped source RGB
    (models.py:839-893, `build_volume_costvar_img`), dense layout,
    differentiable in `feats` and `imgs` (through K2 on a card).

    Args:
        imgs: (V, H, W, 3) source images at full resolution (view 0 = ref).
        feats: (V, h, w, C) stride-4 feature maps.
        proj_mats: (V, 3, 4) relative projections (only views 1: are used).
        depth_values: (D,).
        pad: feature-grid padding.
    Returns:
        cost (D, hp, wp, 3V + C) channel-last, channels [ref RGB, warped src
        RGB x (V-1), variance(C)], the mask count normalised per view. It is
        a view of the sweep's contiguous (1, 3V + C, D, hp, wp) tensor:
        `cost.permute(3, 0, 1, 2)[None]` is that tensor, no copy.
    """
    _, h, w, C = feats.shape
    # images to feature resolution (models.py:859, align_corners=False)
    imgs_l = torch.stack([interpolate_bilinear_resize(im, h, w)
                          for im in imgs])
    srcs = torch.cat([feats, imgs_l], dim=-1).contiguous()
    cost = sweep_cost_volume(srcs, proj_mats.contiguous(),
                             depth_values.contiguous(), pad, C)
    return cost.squeeze(0).permute(1, 2, 3, 0)


def plane_sweep_grid(proj_mat, depth_values, h: int, w: int, pad: int = 0):
    """The normalised source-view sampling grid of every (depth, reference
    pixel), (D, h + 2 pad, w + 2 pad, 2) (x, y) in [-1, 1] by the unpadded
    feature extent (mvsnerf_tpu/ops/homography.py:25).

    Args:
        proj_mat: (3, 4) src_proj @ ref_proj_inv at feature scale.
        depth_values: (D,) the planes' depths.
    """
    dev = proj_mat.device
    hp, wp = h + 2 * pad, w + 2 * pad
    dt = proj_mat.dtype
    gy, gx = torch.meshgrid(torch.arange(hp, dtype=dt, device=dev) - pad,
                            torch.arange(wp, dtype=dt, device=dev) - pad,
                            indexing="ij")
    ref = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
    rot = proj_mat[:, :3] @ ref                        # (3, hp * wp)
    src = rot[None] + proj_mat[:, 3:][None] / depth_values[:, None, None]
    xy = src[:, :2] / src[:, 2:3]
    gx = xy[:, 0] / ((w - 1) / 2.0) - 1.0
    gy = xy[:, 1] / ((h - 1) / 2.0) - 1.0
    return torch.stack([gx, gy], -1).reshape(-1, hp, wp, 2)


def homo_warp(src_feat, proj_mat, depth_values, pad: int = 0, grid=None):
    """One (h, w, C) source map warped onto the D planes, zeros outside
    (mvsnerf_tpu/ops/homography.py:83, reference utils.py:580-630): returns
    (warped (D, hp, wp, C), grid (D, hp, wp, 2)); `grid` may be given."""
    h, w = src_feat.shape[:2]
    if grid is None:
        grid = plane_sweep_grid(proj_mat, depth_values, h, w, pad)
    return grid_sample_2d(src_feat, grid, padding_mode="zeros"), grid


def in_bounds_mask(grid):
    """1 where both grid coordinates lie strictly inside (-1, 1), else 0
    (models.py:874-877)."""
    ok = (grid > -1.0) & (grid < 1.0)
    return (ok[..., 0] & ok[..., 1]).to(grid.dtype)


def build_cost_volume_feat(feats, proj_mats, depth_values, pad: int = 0):
    """The feature-only variance volume (mvsnerf_tpu/ops/homography.py:512,
    models.py:787-837 `build_volume_costvar`): (variance (D, hp, wp, C),
    in_masks (D, hp, wp)). As there, the mask count starts from ones
    (models.py:814): the variance divides by 1 + the source views' masks,
    the reference view counting whether or not it is in bounds."""
    _, h, w, _ = feats.shape
    ref = F.pad(feats[0], (0, 0, pad, pad, pad, pad))
    warped, masks = [], []
    for feat, pm in zip(feats[1:], proj_mats[1:]):
        wf, grid = homo_warp(feat, pm, depth_values, pad)
        warped.append(wf)
        masks.append(in_bounds_mask(grid))
    warped = torch.stack(warped)
    volume_sum = ref[None] + warped.sum(0)
    volume_sq_sum = (ref ** 2)[None] + (warped ** 2).sum(0)
    in_masks = 1.0 + torch.stack(masks).sum(0)
    count = (1.0 / in_masks)[..., None]
    return volume_sq_sum * count - (volume_sum * count) ** 2, in_masks


def sweep_side_outputs(imgs, proj_mats, depth_values, pad: int = 0):
    """`build_cost_volume`'s side outputs in JAX (homography.py:491-500,
    models.py:925-926): (in_masks (V, D, hp, wp), 1 for the reference view;
    colors (V, D, hp, wp, 4), each view's RGB at feature resolution on the
    planes, the reference's zero-padded and unwarped, with its mask).

    Args:
        imgs: (V, H, W, 3) source images, resized to FeatureNet's
            (ceil(H / 4), ceil(W / 4)).
    """
    _, H, W, _ = imgs.shape
    h, w = -(-H // 4), -(-W // 4)
    D = depth_values.shape[0]
    imgs_l = [interpolate_bilinear_resize(im, h, w) for im in imgs]
    ref = F.pad(imgs_l[0], (0, 0, pad, pad, pad, pad))
    rgbs = [ref.expand(D, *ref.shape)]
    masks = [torch.ones(D, h + 2 * pad, w + 2 * pad, dtype=imgs.dtype,
                        device=imgs.device)]
    for img, pm in zip(imgs_l[1:], proj_mats[1:]):
        warped, grid = homo_warp(img, pm, depth_values, pad)
        rgbs.append(warped)
        masks.append(in_bounds_mask(grid))
    in_masks = torch.stack(masks)
    colors = torch.cat([torch.stack(rgbs), in_masks[..., None]], -1)
    return in_masks, colors
