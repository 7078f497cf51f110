"""The colour-baked (`tiled`) full-image renderer: per-view colours baked
into the encoding volume once, then the fused fetch + MLP + compositing
kernel K6b over the 20-channel volume.

Counterpart of mvsnerf_tpu/render/tiled.py (`bake_color_volume` :44,
`make_tiled_renderer` :83 in its baked mode, `cached_tiled_renderer`
:248), the eval CLI's `--render_mode tiled` and the fine-tune and video
render. JAX's `make_tiled_renderer(exact_colors=True)` (the `hybrid`
mode) is render/hybrid.py's `make_hybrid_renderer`. On the GPU a ray needs no image tile, window plan or
locality check, so there is no `pick_tile`, `plan_tiles` or `_reject`:
every image renders, and a volume the kernel cannot take raises instead
of falling back to the chunked path.
"""

from __future__ import annotations

import weakref

import torch

from ..ops.render_fused import N_FEATS, render_v0
from .renderer import build_color_volume, gen_dir_feature, \
    image_renderer, sample_rays


@torch.no_grad()
def bake_color_volume(volume, imgs, pose_source, near_far, pad):
    """Append the per-view reprojected colours and masks at every voxel
    centre to the encoding volume (the reference's use_color_volume
    layout, train_mvs_nerf_finetuning_pl.py:72-80): (D, hp, wp, 8) ->
    (D, hp, wp, 8 + 4V) as [8 encoding | per view (RGB, mask)], the
    colours by K4. The reference camera is
    `pose_source["c2ws"][0]`, or the inverse of `w2cs[0]` when the pose
    dict carries no c2ws (the Evaluator's)."""
    from ..train.finetune import frustum_point_volume
    d, hp, wp, _ = volume.shape
    intr_ref = pose_source["intrinsics"][0]
    intrinsic_s4 = intr_ref / torch.tensor([[4.0], [4.0], [1.0]],
                                           device=intr_ref.device)
    c2ws = pose_source.get("c2ws")
    c2w_ref = c2ws[0] if c2ws is not None else \
        torch.linalg.inv(pose_source["w2cs"][0])
    vox = frustum_point_volume(hp - 2 * pad, wp - 2 * pad, d, pad, near_far,
                               intrinsic_s4, c2w_ref)
    color = build_color_volume(vox.reshape(d, -1, 3), pose_source["w2cs"],
                               pose_source["intrinsics"], imgs)
    return torch.cat([volume, color.reshape(d, hp, wp, -1)], -1) \
        .contiguous()


def make_tiled_renderer(mlp, volume, imgs, near_far, pose_source,
                        n_samples: int, pad: int, white_bkgd: bool = False,
                        chunk: int = 16384, lindisp: bool = False):
    """Return fn(rays (N, 8), H, W) -> dict rgb (N, 3), depth, acc (N,).

    Args:
        mlp: the v0 `MVSNeRF` module (read at each call).
        volume: (D, hp, wp, 8) encoding volume, baked here, or a
            (D, hp, wp, 20) volume baked already (the fine-tune trainer's
            `--use_color_volume`).
        imgs: (V, H, W, 3) source images in [0, 1]; their size sets the NDC
            scale, whatever the render target's.
        near_far: (2,) float32 tensor; pose_source: dict of (V, 4, 4)
            `w2cs` and (V, 3, 3) `intrinsics` (and optionally `c2ws`).
        lindisp: samples linear in disparity (`--use_disp`); the bake stays
            at the voxel centres of `frustum_point_volume`, linear in depth,
            as JAX's does (mvsnerf_tpu/render/tiled.py:61, 169, 176).
    The returned function carries the baked volume as `.volume`.
    """
    if volume.shape[-1] == 8:
        volume = bake_color_volume(volume, imgs, pose_source, near_far, pad)
    if volume.shape[-1] != N_FEATS:
        raise ValueError(f"tiled render: volume {tuple(volume.shape)}; the "
                         f"kernel takes 8 channels to bake or {N_FEATS} "
                         "baked")
    volume = volume.detach().contiguous()
    w2cs = pose_source["w2cs"].contiguous()
    intrinsics = pose_source["intrinsics"].contiguous()

    def chunk_fn(rays):
        _, rays_d, z_vals, pts_ndc = sample_rays(
            rays, n_samples, w2cs[0], intrinsics[0], imgs.shape[1:3],
            near_far, pad, lindisp=lindisp)
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        out = render_v0(pts_ndc.contiguous(), z_vals.contiguous(), None,
                        gen_dir_feature(w2cs[0], unit).contiguous(), volume,
                        mlp)
        if white_bkgd:
            out["rgb"] = out["rgb"] + (1.0 - out["acc"][:, None])
        return out

    render = image_renderer(chunk_fn, chunk)
    render.volume = volume
    return render


def cached_tiled_renderer(system, volume, imgs, near_far, pose_source,
                          **kw):
    """`make_tiled_renderer` memoised on `system` until `volume` or the
    keyword arguments change: per-frame video and validation renders reuse
    one bake. The key is the volume's identity (a weak reference), its
    `_version`, which every in-place update bumps (Adam's step,
    `load_state`'s copy), and `kw` (`chunk`, `n_samples`, ...): the
    trainer updates the volume in place, so identity alone would keep a
    stale bake. The MLP is read live at each call and needs no key."""
    key = (volume._version, tuple(sorted(kw.items())))
    cached = getattr(system, "_tiled_cache", None)
    if cached is not None:
        ref, cached_key, fn = cached
        if ref() is volume and cached_key == key:
            return fn
    fn = make_tiled_renderer(system.mlp, volume, imgs, near_far, pose_source,
                             **kw)
    system._tiled_cache = (weakref.ref(volume), key, fn)
    return fn
