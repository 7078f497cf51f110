"""Bilinear / trilinear sampling on `F.grid_sample` and `F.interpolate`.

Counterpart of mvsnerf_tpu/ops/interp.py. Every grid_sample call site of
the reference uses align_corners=True, with border padding for the colour
gather and zeros padding elsewhere; the image pyramid resize uses
align_corners=False. Inputs and outputs keep the JAX channel-last layouts.
"""

from __future__ import annotations

import torch.nn.functional as F


def grid_sample_2d(img, grid, padding_mode: str = "zeros"):
    """Bilinear sample (H, W, C) `img` at normalised (..., 2) (x, y) grid
    coordinates in [-1, 1]; returns (..., C)."""
    C = img.shape[-1]
    out = F.grid_sample(img.permute(2, 0, 1)[None],
                        grid.reshape(1, -1, 1, 2), mode="bilinear",
                        padding_mode=padding_mode, align_corners=True)
    return out[0, :, :, 0].T.reshape(*grid.shape[:-1], C)


def grid_sample_3d(vol, grid, padding_mode: str = "zeros"):
    """Trilinear sample (D, H, W, C) `vol` at normalised (..., 3) (x, y, z)
    grid coordinates (x indexes W, y H, z D); returns (..., C)."""
    C = vol.shape[-1]
    out = F.grid_sample(vol.permute(3, 0, 1, 2)[None],
                        grid.reshape(1, -1, 1, 1, 3), mode="bilinear",
                        padding_mode=padding_mode, align_corners=True)
    return out[0, :, :, 0, 0].T.reshape(*grid.shape[:-1], C)


def index_point_feature(volume, xyz_ndc):
    """Trilinear zeros-padded lookup of the (D, H, W, C) encoding volume at
    NDC coordinates in [0, 1] ordered (x, y, z)."""
    return grid_sample_3d(volume, xyz_ndc * 2.0 - 1.0, padding_mode="zeros")


def interpolate_bilinear_resize(img, out_h: int, out_w: int,
                                align_corners: bool = False):
    """Bilinear resize of an (H, W, C) image to (out_h, out_w, C) with
    `F.interpolate` semantics."""
    out = F.interpolate(img.permute(2, 0, 1)[None], size=(out_h, out_w),
                        mode="bilinear", align_corners=align_corners)
    return out[0].permute(1, 2, 0)
