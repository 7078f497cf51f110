"""The chunked volume-rendering pipeline (counterpart of
mvsnerf_tpu/render/renderer.py).

Per sample: trilinear fetch from the encoding volume, per-view colours +
masks (kernel K4 on the card), positional encoding, the MLP, and alpha
compositing. With the colour-baked 20-channel volume (`use_color_volume`,
render/tiled.py:`bake_color_volume`) the fetch alone gives all 20
features and no colours are warped. Full images are rendered by a Python
loop over fixed-size ray chunks (`render_image_chunked`).

The eval route fetches with `grid_sample`. The training route
(`training=True`, the fine-tune step) differentiates with respect to the
volume: the fetch goes through K5 (`sample_volume`) and the MLP through
K7 (`mlp_v0_train`). Where no gradient is asked for (`torch.no_grad`,
every full-image render), the gathered features go to K8
(`render_v0_feats`) for PE, MLP and compositing in one kernel; otherwise
the eval route runs the module's MLP and `raw2outputs`. `twins=True` runs
the kernels' plain twins instead, to hold one against the other.

K7 and K8 take the v0 MLP at D=6, W=128 alone (`MVSNeRF.runs_v0_kernels`),
as JAX's Pallas MLP does. Every other `--net_type` (v1, v2, fusion) or
shape runs the module's MLP and `raw2outputs` on both routes, as JAX's
`run_network` does (renderer.py:254-263); the route follows the
configuration, and K4 and K5 serve every type. v1's fused colours fold
into the returned `feats` (JAX renderer.py:307-309).

`render_density` evaluates the MLP's alpha head alone over the volume's
voxels, the density volume's refresh (`--use_density_volume`), and
`sample_rays` with a density volume adds importance samples drawn from it
(`--N_importance`). `sample_rays` with a world box (`bbox`) takes each
ray's near and far where it crosses the box and puts its samples in the
box's [0, 1] coordinates, the fusion trainer's canonical volume.
"""

from __future__ import annotations

import torch

from ..ops.color_warp import color_warp, color_warp_plain
from ..ops.compositing import raw2outputs
from ..ops.encoding import positional_encoding
from ..ops.geometry import get_ndc_coordinate, get_ndc_coordinate_bbox
from ..ops.interp import index_point_feature
from ..ops.mlp_train import mlp_v0_train, mlp_v0_train_plain
from ..ops.render_fused import render_v0_feats, render_v0_feats_plain
from ..ops.sampling import ray_marcher, ray_marcher_fine
from ..ops.volume_gather import sample_volume, sample_volume_plain
from ..utils.profiling import trace_context


def build_color_volume(pts_world, w2cs, intrinsics, imgs,
                       twins: bool = False):
    """Per-sample source-view colours + in-bounds masks, (N, S, 4V) in
    per-view blocks [RGB (border padding), mask] (utils.py:300-332)."""
    warp = color_warp_plain if twins else color_warp
    return warp(pts_world.contiguous(), w2cs.contiguous(),
                intrinsics.contiguous(), imgs.contiguous())


def gen_dir_feature(w2c_ref, rays_dir):
    """View dirs rotated into the reference camera frame."""
    return rays_dir @ w2c_ref[:3, :3].T


def gen_angle_feature(c2ws, rays_pts, rays_dir):
    """Per-source-view angle cosines (mvsnerf_tpu/render/renderer.py:121,
    reference renderer.py:96-109; no path of either package calls it).

    Args:
        c2ws: (V, 4, 4); rays_pts: (N, S, 3); rays_dir: (N, 3).
    Returns:
        (N, S, V) cosines between each sample-to-camera direction and the
        ray's direction.
    """
    n_rays, n_samples = rays_pts.shape[:2]
    dirs = rays_pts[:, :, None] - c2ws[:, :3, 3][None, None]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-7)
    return (dirs * rays_dir.reshape(n_rays, 1, 1, 3)).sum(-1).reshape(
        n_rays, n_samples, -1)


def gen_pts_feats(volume, pts_ndc, pts_world, w2cs, intrinsics, imgs,
                  training: bool = False, twins: bool = False,
                  use_color_volume: bool = False):
    """Per-sample MLP feature: 8 volume channels + 12 colour channels, or
    with `use_color_volume` the 20 channels of the baked volume alone.
    `training` fetches through K5 (or its twin), differentiably in the
    volume."""
    colors = None if use_color_volume else \
        build_color_volume(pts_world, w2cs, intrinsics, imgs, twins)
    if training:
        fetch = sample_volume_plain if twins else sample_volume
        ray_feats = fetch(volume, pts_ndc.contiguous())
    else:
        ray_feats = index_point_feature(volume, pts_ndc)
    if colors is None:
        return ray_feats
    return torch.cat([ray_feats, colors], dim=-1)


def network_input(pts_ndc, viewdirs, feats):
    """The MLP's input x = [PE(ndc) (10 frequencies) | feats | viewdirs],
    (N, S, 86)."""
    if viewdirs.dim() != pts_ndc.dim():
        viewdirs = viewdirs[:, None].expand(*pts_ndc.shape[:-1],
                                            viewdirs.shape[-1])
    return torch.cat([positional_encoding(pts_ndc, 10), feats, viewdirs],
                     dim=-1)


def run_network(mlp, pts_ndc, viewdirs, feats, training: bool = False,
                twins: bool = False):
    """PE + concat + MLP -> (N, S, 4), (N, S, 10) for v1. `training` runs
    the v0 MLP at D=6, W=128 through K7 (or its twin); every other MLP is
    the module's forward."""
    x = network_input(pts_ndc, viewdirs, feats)
    if training and mlp.runs_v0_kernels:
        return (mlp_v0_train_plain if twins else mlp_v0_train)(mlp, x)
    return mlp(x)


def render_rays(mlp, volume, pts_world, pts_ndc, z_vals, rays_dir, w2c_ref,
                w2cs, intrinsics, imgs, white_bkgd: bool = False,
                training: bool = False, twins: bool = False,
                use_color_volume: bool = False, with_alpha: bool = False):
    """The render entry (renderer.py:138-165, 266-313). With gradients
    off, PE, MLP and compositing of the v0 MLP run in K8 (or its twin with
    `twins`); any other MLP runs the module and `raw2outputs`.

    Args:
        mlp: an `MVSNeRF` module of any net type.
        volume: (D, hp, wp, 8) encoding volume, or (D, hp, wp, 20) baked
            with `use_color_volume`.
        pts_world / pts_ndc: (N, S, 3); z_vals: (N, S); rays_dir: (N, 3).
        w2c_ref: reference world-to-camera (view-direction feature).
        w2cs / intrinsics / imgs: source views for the colours (unused
            with `use_color_volume`).
        training: the trainers' route (K5 fetch, and K7 for the v0 MLP).
        twins: the kernels' plain twins instead.
        with_alpha: K8 also returns each sample's alpha (the fusion
            trainer's local renders; JAX's `render_rays` returns it always).
    Returns:
        dict rgb, depth, acc, weights, the gathered (N, S, 20) `feats`
        (v1: the volume's 8 channels and its 6 fused-colour outputs), and
        disp and alpha on the module's route, alpha on K8's with
        `with_alpha`.
    """
    with trace_context("render.features"):
        unit_dirs = rays_dir / torch.linalg.norm(rays_dir, dim=-1,
                                                 keepdim=True)
        angle = gen_dir_feature(w2c_ref, unit_dirs)
        feats = gen_pts_feats(volume, pts_ndc, pts_world, w2cs, intrinsics,
                              imgs, training, twins, use_color_volume)
    with trace_context("render.mlp"):
        if not torch.is_grad_enabled() and mlp.runs_v0_kernels:
            fused = render_v0_feats_plain if twins else render_v0_feats
            out = fused(pts_ndc.contiguous(), feats.contiguous(),
                        angle.contiguous(), z_vals.contiguous(), mlp,
                        with_alpha)
            if white_bkgd:
                out["rgb"] = out["rgb"] + (1.0 - out["acc"][:, None])
        else:
            raw = run_network(mlp, pts_ndc, angle, feats, training, twins)
            if raw.shape[-1] > 4:
                feats = torch.cat([feats[..., :8], raw[..., 4:]], dim=-1)
            out = raw2outputs(raw, z_vals, white_bkgd=white_bkgd)
    out["feats"] = feats
    return out


# voxels a chunk of `render_density`: its widest activation, [PE | h]
# after the skip, is 191 floats a voxel, 200 MB at 2**18 voxels (the whole
# 128 x 176 x 208 DTU volume, 4.69M voxels, would take 3.6 GB a layer)
DENSITY_CHUNK = 2 ** 18


@torch.no_grad()
def render_density(mlp, pts, feats, chunk: int = DENSITY_CHUNK):
    """The MLP's density at (M, 3) points with (M, 20) features: its alpha
    head over [PE(pts) (10 frequencies) | feats], (M, 1) (JAX
    renderer.py:316 `render_density`): relu of it for v0 and fusion, the
    head alone for v2; v1 has no alpha head and raises. Runs `chunk`
    points at a time, in plain f32 layers (JAX computes it in XLA, outside
    any kernel)."""
    return torch.cat([
        mlp.forward_alpha(torch.cat([positional_encoding(p, 10), f], -1))
        for p, f in zip(pts.split(chunk), feats.split(chunk))])


def sample_rays(rays, n_samples: int, w2c_ref, intrinsic_ref, src_hw,
                near_far, pad: int, perturb: float = 0.0,
                generator: torch.Generator | None = None,
                lindisp: bool = False, density_volume=None,
                n_importance: int = 0, bbox=None):
    """Samples of a (N, 8) ray buffer and their reference NDC: (pts
    (N, S, 3), rays_d (N, 3), z_vals (N, S), pts_ndc (N, S, 3)). Depths
    are jittered by `perturb` with draws from `generator` (on the rays'
    device), and with `lindisp` spaced, and mapped to NDC z, linearly in
    disparity (`--use_disp`). NDC is normalised by the SOURCE views'
    extent `src_hw`: the volume's feature grid is sized by them (the pad
    remap). With a (D, hp, wp, 1) `density_volume` and `n_importance` > 0,
    `n_importance` more depths a ray are drawn from it after the jitter,
    from the same generator, and S = n_samples + n_importance (JAX
    finetune.py:166-175). With a (2, 3) world box `bbox` [min; max] the
    depths run from where each ray enters the box to where it leaves it
    (`ray_marcher(bbox_3d=...)`), and the coordinates are the box's
    (p - min) / (max - min), before and after the importance step (JAX
    fusion.py:224-232); the reference-view arguments are then unused and
    may be None."""
    pts, _, rays_d, z_vals = ray_marcher(rays, n_samples, perturb=perturb,
                                         lindisp=lindisp,
                                         generator=generator, bbox_3d=bbox)
    if bbox is not None:
        def ndc(p):
            return get_ndc_coordinate_bbox(bbox[0], bbox[1], p)
    else:
        # staged copy: a blocking one would wait for the device every batch
        inv_scale = torch.tensor([src_hw[1] - 1.0, src_hw[0] - 1.0]).to(
            rays.device, non_blocking=True)

        def ndc(p):
            return get_ndc_coordinate(w2c_ref, intrinsic_ref, p, inv_scale,
                                      near=near_far[0], far=near_far[1],
                                      pad=pad, lindisp=lindisp)

    pts_ndc = ndc(pts)
    if density_volume is not None and n_importance > 0:
        pts, _, rays_d, z_vals = ray_marcher_fine(
            rays, density_volume, z_vals, pts_ndc, n_importance,
            generator=generator)
        pts_ndc = ndc(pts)
    return pts, rays_d, z_vals, pts_ndc


def make_chunked_renderer(mlp, volume, imgs, near_far, pose_source,
                          n_samples: int, pad: int, white_bkgd: bool = False,
                          chunk: int = 16384, lindisp: bool = False):
    """The chunked full-image renderer (mvsnerf_tpu/eval/evaluate.py:77
    `render_rays_buffer`): K4 colours and the `grid_sample` fetch, then K8
    for PE, MLP and compositing, chunk by chunk. Arguments as
    `make_hybrid_renderer`. Returns fn(rays (N, 8), H, W) -> dict rgb
    (N, 3), depth, acc (N,)."""
    w2cs, intrinsics = pose_source["w2cs"], pose_source["intrinsics"]

    def chunk_fn(rays):
        with trace_context("render.sample"):
            pts, rays_d, z_vals, pts_ndc = sample_rays(
                rays, n_samples, w2cs[0], intrinsics[0], imgs.shape[1:3],
                near_far, pad, lindisp=lindisp)
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
