"""The hybrid full-image renderer: exact per-sample colours (kernel K4)
streamed into the fused fetch + MLP + compositing kernel (K6).

Counterpart of mvsnerf_tpu/render/tiled.py:83
`make_tiled_renderer(exact_colors=True)` (the eval CLI's
`--render_mode hybrid`). On the GPU a ray needs no image tile, window plan
or locality check: every image renders, so there is no `_reject` fallback
and no `pick_tile`. Rays go through in fixed-size chunks, which bounds the
per-sample colour tensor (12 floats a sample). K6 computes the v0 MLP at
D=6, W=128 alone: any other MLP raises, as in render/tiled.py.
"""

from __future__ import annotations

import torch

from ..ops.render_fused import render_v0, require_v0_mlp
from .renderer import build_color_volume, gen_dir_feature, \
    image_renderer, sample_rays


def make_hybrid_renderer(mlp, volume, imgs, near_far, pose_source,
                         n_samples: int, pad: int, white_bkgd: bool = False,
                         chunk: int = 16384, lindisp: bool = False):
    """Return fn(rays (N, 8), H, W) -> dict rgb (N, 3), depth, acc (N,).

    Args:
        mlp: the v0 `MVSNeRF` module at D=6, W=128 (others raise).
        volume: (D, hp, wp, 8) encoding volume.
        imgs: (V, H, W, 3) source images in [0, 1] (not normalised).
        near_far: (2,) float32 tensor, the reference-view depth range.
        pose_source: dict of (V, 4, 4) `w2cs` and (V, 3, 3) `intrinsics`.
        lindisp: samples linear in disparity (`--use_disp`).
    """
    require_v0_mlp(mlp, "hybrid render")
    w2cs = pose_source["w2cs"].contiguous()
    intrinsics = pose_source["intrinsics"].contiguous()
    volume = volume.contiguous()

    def chunk_fn(rays):
        pts, rays_d, z_vals, pts_ndc = sample_rays(
            rays, n_samples, w2cs[0], intrinsics[0], imgs.shape[1:3],
            near_far, pad, lindisp=lindisp)
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        colors = build_color_volume(pts, w2cs, intrinsics, imgs)
        out = render_v0(pts_ndc.contiguous(), z_vals.contiguous(), colors,
                        gen_dir_feature(w2cs[0], unit).contiguous(), volume,
                        mlp)
        if white_bkgd:
            out["rgb"] = out["rgb"] + (1.0 - out["acc"][:, None])
        return out

    return image_renderer(chunk_fn, chunk)
