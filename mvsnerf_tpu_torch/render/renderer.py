"""The chunked volume-rendering pipeline (counterpart of
mvsnerf_tpu/render/renderer.py, v0 MLP).

Per sample: trilinear fetch from the encoding volume (`grid_sample`),
per-view colours + masks (kernel K4 on the card), positional encoding, the
MLP, and alpha compositing. Full images are rendered by a Python loop over
fixed-size ray chunks (`render_image_chunked`).
"""

from __future__ import annotations

import torch

from ..ops.color_warp import color_warp
from ..ops.compositing import raw2outputs
from ..ops.encoding import positional_encoding
from ..ops.geometry import get_ndc_coordinate
from ..ops.interp import index_point_feature
from ..ops.sampling import ray_marcher


def build_color_volume(pts_world, w2cs, intrinsics, imgs):
    """Per-sample source-view colours + in-bounds masks, (N, S, 4V) in
    per-view blocks [RGB (border padding), mask] (utils.py:300-332)."""
    return color_warp(pts_world.contiguous(), w2cs.contiguous(),
                      intrinsics.contiguous(), imgs.contiguous())


def gen_dir_feature(w2c_ref, rays_dir):
    """View dirs rotated into the reference camera frame."""
    return rays_dir @ w2c_ref[:3, :3].T


def gen_pts_feats(volume, pts_ndc, pts_world, w2cs, intrinsics, imgs):
    """Per-sample MLP feature: 8 volume channels + 12 colour channels."""
    colors = build_color_volume(pts_world, w2cs, intrinsics, imgs)
    return torch.cat([index_point_feature(volume, pts_ndc), colors], dim=-1)


def run_network(mlp, pts_ndc, viewdirs, feats):
    """PE (10 frequencies) + concat + MLP: x = [PE(ndc) | feats | viewdirs]
    -> (N, S, 4)."""
    if viewdirs.dim() != pts_ndc.dim():
        viewdirs = viewdirs[:, None].expand(*pts_ndc.shape[:-1],
                                            viewdirs.shape[-1])
    x = torch.cat([positional_encoding(pts_ndc, 10), feats, viewdirs],
                  dim=-1)
    return mlp(x)


def render_rays(mlp, volume, pts_world, pts_ndc, z_vals, rays_dir, w2c_ref,
                w2cs, intrinsics, imgs, white_bkgd: bool = False):
    """The render entry (renderer.py:138-165).

    Args:
        mlp: the v0 `MVSNeRF` module.
        volume: (D, hp, wp, 8) encoding volume.
        pts_world / pts_ndc: (N, S, 3); z_vals: (N, S); rays_dir: (N, 3).
        w2c_ref: reference world-to-camera (view-direction feature).
        w2cs / intrinsics / imgs: source views for the colours.
    Returns:
        dict rgb, depth, acc, disp, weights, alpha.
    """
    unit_dirs = rays_dir / torch.linalg.norm(rays_dir, dim=-1,
                                             keepdim=True)
    angle = gen_dir_feature(w2c_ref, unit_dirs)
    feats = gen_pts_feats(volume, pts_ndc, pts_world, w2cs, intrinsics, imgs)
    raw = run_network(mlp, pts_ndc, angle, feats)
    return raw2outputs(raw, z_vals, white_bkgd=white_bkgd)


def sample_rays(rays, n_samples: int, w2c_ref, intrinsic_ref, src_hw,
                near_far, pad: int):
    """Deterministic samples of a (N, 8) ray buffer and their reference
    NDC: (pts (N, S, 3), rays_d (N, 3), z_vals (N, S), pts_ndc (N, S, 3)).
    NDC is normalised by the SOURCE views' extent `src_hw`: the volume's
    feature grid is sized by them (the pad remap)."""
    pts, _, rays_d, z_vals = ray_marcher(rays, n_samples)
    inv_scale = torch.tensor([src_hw[1] - 1.0, src_hw[0] - 1.0],
                             device=rays.device)
    pts_ndc = get_ndc_coordinate(w2c_ref, intrinsic_ref, pts, inv_scale,
                                 near=near_far[0], far=near_far[1], pad=pad)
    return pts, rays_d, z_vals, pts_ndc


def make_chunked_renderer(mlp, volume, imgs, near_far, pose_source,
                          n_samples: int, pad: int, white_bkgd: bool = False,
                          chunk: int = 16384):
    """The chunked full-image renderer (mvsnerf_tpu/eval/evaluate.py:77
    `render_rays_buffer`): K4 colours, then the plain fetch, MLP and
    compositing, chunk by chunk. Arguments as `make_hybrid_renderer`.
    Returns fn(rays (N, 8), H, W) -> dict rgb (N, 3), depth, acc (N,)."""
    w2cs, intrinsics = pose_source["w2cs"], pose_source["intrinsics"]

    def chunk_fn(rays):
        pts, rays_d, z_vals, pts_ndc = sample_rays(
            rays, n_samples, w2cs[0], intrinsics[0], imgs.shape[1:3],
            near_far, pad)
        out = render_rays(mlp, volume, pts, pts_ndc, z_vals, rays_d, w2cs[0],
                          w2cs, intrinsics, imgs, white_bkgd=white_bkgd)
        return {k: out[k] for k in ("rgb", "depth", "acc")}

    return image_renderer(chunk_fn, chunk)


def image_renderer(chunk_fn, chunk: int):
    """fn(rays (H*W, 8), H, W) -> dict that renders a full image through
    `chunk_fn` in chunks of `chunk` rays."""
    def render(rays, H: int, W: int):
        if rays.shape[0] != H * W:
            raise ValueError(f"{rays.shape[0]} rays for a {H}x{W} image")
        return render_image_chunked(chunk_fn, (rays,), rays.shape[0], chunk)

    return render


def render_image_chunked(render_chunk_fn, ray_args, n_rays: int,
                         chunk: int = 16384):
    """Render a full image by a loop over fixed-size ray chunks.

    Args:
        render_chunk_fn: fn(*chunk_args) -> dict of (chunk, ...) tensors.
        ray_args: tuple of tensors with leading dim n_rays.
    Returns:
        dict of (n_rays, ...) tensors.
    """
    outs = [render_chunk_fn(*(a[i:i + chunk] for a in ray_args))
            for i in range(0, n_rays, chunk)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
