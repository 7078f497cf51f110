"""Camera/ray geometry: ray generation and reference-view NDC.

Counterpart of mvsnerf_tpu/ops/geometry.py. Conventions follow the
reference (OpenCV camera: x right, y down, z forward; pixel grids are NOT
half-pixel centred).
"""

from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, device=None):
    """(h, w, 2) grid of (x, y) pixel coordinates, not centred."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def get_ray_directions(h: int, w: int, focal, center=None, device=None):
    """Per-pixel ray directions in the camera frame, (h, w, 3)."""
    grid = pixel_grid(h, w, device)
    cx, cy = (w / 2, h / 2) if center is None else (center[0], center[1])
    return torch.stack([(grid[..., 0] - cx) / focal[0],
                        (grid[..., 1] - cy) / focal[1],
                        torch.ones((h, w), device=device)], dim=-1)


def get_rays(directions, c2w):
    """World-frame rays from camera-frame directions.

    Returns:
        rays_o, rays_d: each (N, 3). rays_d is NOT normalised.
    """
    rays_d = (directions @ c2w[:3, :3].T).reshape(-1, 3)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def rays_from_pixels(xs, ys, intrinsic, c2w):
    """Rays through given pixel coordinates.

    Args:
        xs, ys: (N,) float pixel coordinates.
    Returns:
        rays_o (3,), rays_d (N, 3) un-normalised, +z forward.
    """
    dirs = torch.stack([(xs - intrinsic[0, 2]) / intrinsic[0, 0],
                        (ys - intrinsic[1, 2]) / intrinsic[1, 1],
                        torch.ones_like(xs)], dim=-1)
    return c2w[:3, 3], dirs @ c2w[:3, :3].T


def get_ndc_coordinate(w2c_ref, intrinsic_ref, point_samples, inv_scale,
                       near, far, pad: int = 0, lindisp: bool = False):
    """World points -> reference-view NDC in [0, 1].

    xy is the projected pixel coordinate normalised by (W-1, H-1); z is
    (depth - near) / (far - near). With `pad > 0`, xy is remapped into the
    padded feature grid of size ((dim+1)/4 + 2*pad), the reference's pad
    correction (mvsnerf_tpu/ops/geometry.py:141-143).

    Args:
        point_samples: (..., 3) world points.
        inv_scale: (2,) tensor = (W-1, H-1).
    Returns:
        (..., 3) NDC coordinates ordered (x, y, z).
    """
    shape = point_samples.shape
    pts = point_samples.reshape(-1, 3)
    if w2c_ref is not None:
        pts = pts @ w2c_ref[:3, :3].T + w2c_ref[:3, 3]
    pix = pts @ intrinsic_ref.T
    xy = pix[:, :2] / pix[:, 2:3] / inv_scale.reshape(1, 2)
    if lindisp:
        z = (1.0 / pix[:, 2] - 1.0 / near) / (1.0 / far - 1.0 / near)
    else:
        z = (pix[:, 2] - near) / (far - near)
    if pad > 0:
        wh_feat = (inv_scale + 1.0) / 4.0
        xy = xy * wh_feat / (wh_feat + pad * 2) + pad / (wh_feat + pad * 2)
    return torch.cat([xy, z[:, None]], dim=-1).reshape(shape)
