"""The colour-baked (`tiled`) full-image renderer: per-view colours baked
into the encoding volume once, then the fused fetch + MLP + compositing
kernel K6b over the 20-channel volume.

Counterpart of mvsnerf_tpu/render/tiled.py (`bake_color_volume` :44,
`make_tiled_renderer` :83 in its baked mode and its bbox mode,
`cached_tiled_renderer` :248), the eval CLI's `--render_mode tiled` and
the fine-tune, fusion and video render. JAX's
`make_tiled_renderer(exact_colors=True)` (the `hybrid` mode) is
render/hybrid.py's `make_hybrid_renderer`. On the GPU a ray needs no
image tile, window plan or locality check, so there is no `pick_tile`,
`plan_tiles` or `_reject`:
every image renders, and a volume or an MLP the kernel cannot take raises
instead of falling back to the chunked path: K6b computes the v0 MLP at
D=6, W=128 alone. JAX's tiled renderer rejects other MLPs too
(tiled.py:112-113), through `_reject`, after which its evaluator renders
chunked without a word (eval/evaluate.py:150-180); the port raises.
"""

from __future__ import annotations

import weakref

import torch

from ..ops.render_fused import N_FEATS, render_v0, require_v0_mlp
from .renderer import build_color_volume, gen_dir_feature, \
    image_renderer, sample_rays


@torch.no_grad()
def color_feature_volume(volume_shape, imgs, pose_source, near_far, pad):
    """The world-space voxel centres of a (D, hp, wp, C) volume,
    (D, hp, wp, 3) (`frustum_point_volume`), and the per-view reprojected
    colours and masks there, (D, hp, wp, 4V) as per view (RGB, mask), the
    colours by K4 (JAX finetune.py:116-128). The reference camera is
    `pose_source["c2ws"][0]`, or the inverse of `w2cs[0]` when the pose
    dict carries no c2ws (the Evaluator's)."""
    from ..train.finetune import frustum_point_volume
    d, hp, wp = volume_shape[:3]
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
    return vox, color.reshape(d, hp, wp, -1)


def bake_color_volume(volume, imgs, pose_source, near_far, pad):
    """Append the per-view reprojected colours and masks at every voxel
    centre to the encoding volume (the reference's use_color_volume
    layout, train_mvs_nerf_finetuning_pl.py:72-80): (D, hp, wp, 8) ->
    (D, hp, wp, 8 + 4V) as [8 encoding | per view (RGB, mask)]
    (`color_feature_volume`)."""
    color = color_feature_volume(volume.shape, imgs, pose_source, near_far,
                                 pad)[1]
    return torch.cat([volume.detach(), color], -1).contiguous()


def make_tiled_renderer(mlp, volume, imgs, near_far, pose_source,
                        n_samples: int, pad: int, white_bkgd: bool = False,
                        chunk: int = 16384, lindisp: bool = False,
                        density_volume=None, n_importance: int = 0,
                        color_feature=None, bbox=None):
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
        density_volume: (D, hp, wp, 1) sigma volume; with `n_importance`
            > 0 each ray adds that many depths drawn from it, S =
            n_samples + n_importance, the uniforms from a generator seeded
            1 at each call (JAX tiled.py:179-183, `PRNGKey(1)`).
        color_feature: the (D, hp, wp, 12) colours of
            `color_feature_volume`, baked already: an 8-channel volume is
            joined to them instead of baked again (JAX tiled.py:100-102).
        bbox: a (2, 3) world box [min; max]: the fusion trainer's
            canonical volume, in the box's [0, 1] coordinates
            (`sample_rays(bbox=...)`; JAX tiled.py:97-100, 120-122,
            157-173). The volume must be baked already (20 channels);
            `imgs`, `near_far` and `pad` are then unused and may be None.
    The returned function carries the baked volume as `.volume`. Raises
    for an MLP other than v0 at D=6, W=128.
    """
    require_v0_mlp(mlp, "tiled render")
    if bbox is not None and volume.shape[-1] != N_FEATS:
        raise ValueError(f"tiled render in a bbox: volume "
                         f"{tuple(volume.shape)} is not the baked "
                         f"{N_FEATS}-channel one")
    if volume.shape[-1] == 8 and color_feature is not None:
        volume = torch.cat([volume.detach(), color_feature], -1)
    elif volume.shape[-1] == 8:
        volume = bake_color_volume(volume, imgs, pose_source, near_far, pad)
    if volume.shape[-1] != N_FEATS:
        raise ValueError(f"tiled render: volume {tuple(volume.shape)}; the "
                         f"kernel takes 8 channels to bake or {N_FEATS} "
                         "baked")
    volume = volume.detach().contiguous()
    w2cs = pose_source["w2cs"].contiguous()
    intrinsics = pose_source["intrinsics"].contiguous()

    src_hw = None if bbox is not None else imgs.shape[1:3]

    def chunk_fn(rays, gen):
        _, rays_d, z_vals, pts_ndc = sample_rays(
            rays, n_samples, w2cs[0], intrinsics[0], src_hw, near_far, pad,
            generator=gen, lindisp=lindisp, density_volume=density_volume,
            n_importance=n_importance, bbox=bbox)
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        out = render_v0(pts_ndc.contiguous(), z_vals.contiguous(), None,
                        gen_dir_feature(w2cs[0], unit).contiguous(), volume,
                        mlp)
        if white_bkgd:
            out["rgb"] = out["rgb"] + (1.0 - out["acc"][:, None])
        return out

    def render(rays, H: int, W: int):
        gen = torch.Generator(device=rays.device).manual_seed(1)
        return image_renderer(lambda r: chunk_fn(r, gen), chunk)(rays, H, W)

    render.volume = volume
    return render


def cached_tiled_renderer(system, volume, imgs, near_far, pose_source,
                          **kw):
    """`make_tiled_renderer` memoised on `system` until `volume`, a tensor
    among the keyword arguments or another keyword argument changes:
    per-frame video and validation renders reuse one bake. Each tensor is
    keyed by its identity (a weak reference) and its `_version`, which
    every in-place update bumps (Adam's step, `load_state`'s copy): the
    trainer updates the volume in place, so identity alone would keep a
    stale bake, and it replaces the density volume at each refresh, so the
    renderer must follow it. Other keyword arguments (`chunk`,
    `n_samples`, ...) and the `bbox` are keyed by value. The MLP is read
    live at each call and needs no key."""
    tensors = {"volume": volume,
               **{k: v for k, v in kw.items()
                  if torch.is_tensor(v) and k != "bbox"}}
    values = {k: tuple(v.reshape(-1).tolist()) if torch.is_tensor(v) else v
              for k, v in kw.items() if k not in tensors}
    key = (tuple(sorted(values.items())),
           tuple(sorted((k, t._version) for k, t in tensors.items())))
    cached = getattr(system, "_tiled_cache", None)
    if cached is not None:
        refs, cached_key, fn = cached
        if cached_key == key and refs.keys() == tensors.keys() and \
                all(refs[k]() is t for k, t in tensors.items()):
            return fn
    fn = make_tiled_renderer(system.mlp, volume, imgs, near_far, pose_source,
                             **kw)
    system._tiled_cache = ({k: weakref.ref(t) for k, t in tensors.items()},
                           key, fn)
    return fn
