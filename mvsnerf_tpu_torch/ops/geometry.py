"""Camera/ray geometry: ray generation and reference-view NDC.

Counterpart of mvsnerf_tpu/ops/geometry.py. Conventions follow the
reference (OpenCV camera: x right, y down, z forward; pixel grids are NOT
half-pixel centred).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def get_ndc_rays(h: int, w: int, focal, near, rays_o, rays_d):
    """NeRF's NDC reparameterisation of (..., 3) rays for forward-facing
    scenes (mvsnerf_tpu/ops/geometry.py:54, reference ray_utils.py:56-94):
    each origin moved to the plane z = -near, then origins and directions
    mapped into the [-1, 1] cube. `focal` is (fx, fy). Takes tensors,
    which keep their device, or numpy arrays (LLFF's loader, JAX
    data/llff.py:20), which promote float32 rays to float64 with a float64
    focal as JAX's loader does. Returns (rays_o, rays_d)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -1.0 / (w / (2.0 * focal[0])) * ox_oz
    o1 = -1.0 / (h / (2.0 * focal[1])) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (w / (2.0 * focal[0])) * (rays_d[..., 0] / rays_d[..., 2]
                                          - ox_oz)
    d1 = -1.0 / (h / (2.0 * focal[1])) * (rays_d[..., 1] / rays_d[..., 2]
                                          - oy_oz)
    d2 = 1.0 - o2
    stack = torch.stack if isinstance(rays_o, torch.Tensor) else np.stack
    return stack([o0, o1, o2], -1), stack([d0, d1, d2], -1)


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


def sample_random_pixels(h: int, w: int, n: int,
                         generator: torch.Generator | None = None,
                         device=None, precrop: bool = False):
    """(xs, ys), each (n,): uniform random INTEGER pixel coordinates as
    float32 (utils.py:89-93, mvsnerf_tpu/ops/geometry.py:90-105), drawn
    from `generator` (x first, then y). With `precrop`, then x and y in
    the centre 2/3 and one uniform: above 0.3 (probability 0.7) the
    centre draws are taken."""
    if generator is not None:
        device = generator.device
    xs = torch.randint(0, w, (n,), generator=generator, device=device)
    ys = torch.randint(0, h, (n,), generator=generator, device=device)
    if precrop:
        xc = torch.randint(w // 6, w - w // 6, (n,), generator=generator,
                           device=device)
        yc = torch.randint(h // 6, h - h // 6, (n,), generator=generator,
                           device=device)
        if torch.rand((), generator=generator, device=device) > 0.3:
            xs, ys = xc, yc
    return xs.float(), ys.float()


def full_image_pixels(h: int, w: int, device=None):
    """All pixel coordinates (xs, ys), each (h*w,), row-major
    (utils.py:94-99)."""
    grid = pixel_grid(h, w, device)
    return grid[..., 0].reshape(-1), grid[..., 1].reshape(-1)


def get_ndc_coordinate(w2c_ref, intrinsic_ref, point_samples, inv_scale,
                       near, far, pad: float = 0, lindisp: bool = False):
    """World points -> reference-view NDC in [0, 1].

    xy is the projected pixel coordinate normalised by (W-1, H-1); z is
    (depth - near) / (far - near). With `pad > 0`, xy is remapped into the
    padded feature grid of size ((dim+1)/4 + 2*pad), the reference's pad
    correction (mvsnerf_tpu/ops/geometry.py:141-143). `pad` may be
    fractional: the fusion trainer's quarter-scale local renders pass
    pad / 4 with a quarter-scale `inv_scale`.

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


def get_ndc_coordinate_bbox(bbox_min, bbox_max, point_samples):
    """The bounding-box normalisation of world points, (p - min) / (max -
    min), the fusion trainer's volume coordinates
    (mvsnerf_tpu/ops/geometry.py:148, reference utils.py:134-137)."""
    return (point_samples - bbox_min) / (bbox_max - bbox_min)


class RayBatch(NamedTuple):
    """A batch of rays through a target view with reference-view NDC
    samples (mvsnerf_tpu/ops/geometry.py:154, the reference's build_rays /
    build_rays_test tuple, utils.py:148-297)."""
    pts_world: torch.Tensor      # (N_rays, N_samples, 3)
    dirs_world: torch.Tensor     # (N_rays, 3), not normalised
    pts_ndc: torch.Tensor        # (N_rays, N_samples, 3) in [0, 1]
    z_vals: torch.Tensor         # (N_rays, N_samples)
    rays_o: torch.Tensor         # (N_rays, 3)
    colors: torch.Tensor | None  # (N_rays, 3) target colours (train only)
    depths: torch.Tensor | None  # (N_rays,) target depths (train only)
    pixel_xy: torch.Tensor       # (N_rays, 2) the pixels' (x, y)


def _ray_batch(xs, ys, h, w, intrinsic, c2w, w2c_ref, intrinsic_ref,
               near_far_target, near_far_ref, n_samples, pad, u=None):
    """Rays through pixels (xs, ys), depths from the target's near to its
    far (stratified by `u` when given), world points and their NDC."""
    dev = intrinsic.device
    rays_o, rays_d = rays_from_pixels(xs, ys, intrinsic, c2w)
    n_rays = xs.shape[0]
    near, far = near_far_target[0], near_far_target[1]
    t = torch.linspace(0.0, 1.0, n_samples, device=dev)
    z_vals = (near * (1.0 - t) + far * t).expand(n_rays, n_samples)
    if u is not None:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        z_vals = lower + (upper - lower) * u
    rays_o = rays_o.expand(n_rays, 3)
    pts_world = rays_o[:, None] + z_vals[..., None] * rays_d[:, None]
    inv_scale = torch.tensor([w - 1.0, h - 1.0], device=dev)
    pts_ndc = get_ndc_coordinate(w2c_ref, intrinsic_ref, pts_world,
                                 inv_scale, near=near_far_ref[0],
                                 far=near_far_ref[1], pad=pad)
    return pts_world, rays_d, pts_ndc, z_vals, rays_o


def build_rays_train(generator, img, depth, target_intrinsic, target_c2w,
                     w2c_ref, intrinsic_ref, near_far_target, near_far_ref,
                     n_rays: int, n_samples: int, pad: int = 0,
                     precrop: bool = False,
                     perturb: float = 1.0) -> RayBatch:
    """Training rays (mvsnerf_tpu/ops/geometry.py:169, utils.py:148-241):
    `n_rays` random pixels of the target view, depths stratified between
    its near and far, world and reference-NDC sample points, and the
    target's colour and depth at the integer pixels. The pixels, then
    with `perturb` > 0 the (n_rays, n_samples) depth jitter, are drawn
    from `generator` (on its own device; the results are on `img`'s).

    Args:
        img: (H, W, 3) target image; depth: (H, W) target depth or None.
    """
    h, w = img.shape[:2]
    xs, ys = sample_random_pixels(h, w, n_rays, generator, precrop=precrop)
    u = None
    if perturb > 0:
        u = torch.rand((n_rays, n_samples), generator=generator,
                       device=generator.device if generator is not None
                       else None).to(img.device)
    xs, ys = xs.to(img.device), ys.to(img.device)
    xi, yi = xs.long(), ys.long()
    rays = _ray_batch(xs, ys, h, w, target_intrinsic, target_c2w, w2c_ref,
                      intrinsic_ref, near_far_target, near_far_ref,
                      n_samples, pad, u)
    return RayBatch(*rays, img[yi, xi],
                    None if depth is None else depth[yi, xi],
                    torch.stack([xs, ys], -1))


def build_rays_test(h: int, w: int, tgt_to_world, world_to_ref, intrinsic,
                    near_far_ref, near_far_target, n_samples: int,
                    pad: int = 0) -> RayBatch:
    """Every pixel's ray, depths unjittered (mvsnerf_tpu/ops/geometry.py:
    211, utils.py:243-297); as there, `intrinsic` serves both the rays and
    the reference view's NDC."""
    xs, ys = full_image_pixels(h, w, intrinsic.device)
    rays = _ray_batch(xs, ys, h, w, intrinsic, tgt_to_world, world_to_ref,
                      intrinsic, near_far_target, near_far_ref, n_samples,
                      pad)
    return RayBatch(*rays, None, None, torch.stack([xs, ys], -1))


def get_nearest_pose_ids(tgt_position, ref_positions, num_select: int):
    """The `num_select` source views nearest the target by camera centre
    (utils.py:698-711), ties in index order as `jnp.argsort`'s stable
    sort leaves them."""
    dists = torch.linalg.norm(ref_positions - tgt_position[None], dim=-1)
    return torch.argsort(dists, stable=True)[:num_select]
