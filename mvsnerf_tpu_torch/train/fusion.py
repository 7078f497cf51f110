"""Multi-volume fusion fine-tuning (counterpart of
mvsnerf_tpu/train/fusion.py, reference
train_mvs_nerf_fusion_finetuning_pl.py).

For each training view, an encoding volume is built from its 3 nearest
training views (MVSNet: K1, and K10 on a card unless `--costreg_impl
plain`), all its rays are rendered at 1/4 resolution with 128 samples (K4
colours, the volume's `grid_sample` fetch, K8 for PE, MLP and compositing,
which also hands back each sample's alpha), and each sample's weighted
(features, alpha) and its trilinear weight are splatted into a canonical
(128, 128, 128) grid (K5's splat, `splat_trilinear`). The grid,
normalised by the splatted weight, becomes the trainable 20-channel
volume: the step fetches it through K5 in the [0, 1] coordinates of the
scene's box and runs the MLP through K7, with no colour warp; Adam holds
{mlp, volume} only.

Kept from the JAX package, on purpose (its fusion.py:7-20,
docs/parity.md:31-38): the standard trilinear splat weights on aligned
axes; the density volume evaluated at the [0, 1] box coordinates training
uses; importance sampling through `ray_marcher_fine`. Also kept: the local
renders' NDC at quarter scale with JAX's own arguments (the intrinsic x
0.25, `inv_scale` (W/4 - 1, H/4 - 1), pad / 4), whose x scale differs from
the image-scale one by (W/4 - 1) against (W - 1) / 4 (ROADMAP.md).

`--net_type` picks the MLP as in `FinetuneSystem`: v0 at D=6, W=128
renders the local views on K8 and trains on K7; v2 and fusion run the
module's forward in both (their alpha from `raw2outputs`). v1 is refused:
it folds its colours into 14 feature channels, not the fused volume's 20
(JAX's fuse reshapes them to 20 and fails, fusion.py:193).

On the CPU every kernel runs its plain twin: the splat is JAX's
eight-corner scatter, written with `index_add_`.

`restore` reads the port's `.pt` snapshots and JAX's fusion `.msgpack`
ones (`{mlp, volume}` and their Adam moments, io/jax_snapshot.py). A
`.msgpack` `--ckpt` is refused: JAX's constructor hands `--ckpt` to
`load_reference_checkpoint` (fusion.py:94-97), which cannot read one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.geometry import get_ndc_coordinate, get_ndc_coordinate_bbox
from ..ops.sampling import ray_marcher
from ..ops.volume_gather import volume_splat_kernel
from ..render.renderer import render_density, render_rays, sample_rays
from ..render.tiled import cached_tiled_renderer
from ..data.dtu_ft import rays_for_pose
from .common import unpreprocess_images
from .finetune import FinetuneSystem

FUSE_SAMPLES = 128   # samples a ray of the local renders (JAX fusion.py:120)
N_FEATS = 20         # the fused volume's channels: 8 encoding + 12 colour
# the splat's channels a sample: [weighted features (20) | weighted alpha |
# the trilinear weight's 1 | 0 | 0], padded to K5's float4 groups
SPLAT_CHANNELS = 24
ALPHA, WEIGHT = N_FEATS, N_FEATS + 1


def splat_keep(pts_ndc, volume_shape):
    """(...,) bool: the samples JAX's splat keeps, those whose trilinear
    base voxel floor(p * (dim - 1)) lies in [0, dim - 1) on every axis
    (JAX fusion.py:68-69); its 8 corners then all lie inside."""
    D, H, W = volume_shape[:3]
    dims = torch.tensor([W - 1, H - 1, D - 1], device=pts_ndc.device)
    base = torch.floor(pts_ndc * dims.float())
    return ((base >= 0) & (base < dims)).all(-1)


def splat_trilinear_plain(acc, pts_ndc, vals):
    """Plain twin of `splat_trilinear`: JAX's eight-corner scatter-add
    (fusion.py:47-82) with `index_add_`, in place; returns `acc`."""
    D, H, W, C = acc.shape
    p, v = pts_ndc.reshape(-1, 3), vals.reshape(-1, C)
    dims = torch.tensor([W - 1.0, H - 1.0, D - 1.0], device=p.device)
    vox = p * dims
    base = torch.floor(vox)
    frac = vox - base
    base = base.long()
    keep = splat_keep(p, acc.shape)
    flat = acc.view(-1, C)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                w = torch.where(keep, w, torch.zeros_like(w))
                xi = (base[:, 0] + dx).clamp(0, W - 1)
                yi = (base[:, 1] + dy).clamp(0, H - 1)
                zi = (base[:, 2] + dz).clamp(0, D - 1)
                flat.index_add_(0, (zi * H + yi) * W + xi, w[:, None] * v)
    return acc


def splat_trilinear(acc, pts_ndc, vals, twins: bool = False):
    """Scatter-add per-sample values into a voxel grid with trilinear
    weights, in place (JAX fusion.py:47 `splat_trilinear`, its volume and
    weight accumulators side by side as channels).

    Args:
        acc: (D, H, W, C) accumulator, C % 4 == 0 on a card.
        pts_ndc: (N, S, 3) sample coordinates in [0, 1], ordered (x, y, z)
            (x indexes W, y H, z D).
        vals: (N, S, C) per-sample values; a channel of ones accumulates
            the trilinear weights.
        twins: the plain twin on a card too.
    Returns:
        `acc`. On a card, K5's splat (ops/volume_gather.py), the adjoint of
        its trilinear align-corners fetch on the same axes: the rows of the
        samples JAX's rule drops (`splat_keep`; K5 would add their corners
        inside the grid) are zeroed first. Its float32 atomics add in an
        order that changes from run to run.
    """
    if acc.device.type == "cpu" or twins:
        return splat_trilinear_plain(acc, pts_ndc, vals)
    if acc.device.type != "cuda":
        raise ValueError(f"splat_trilinear: no kernel for {acc.device}")
    g = (vals * splat_keep(pts_ndc, acc.shape)[..., None]).contiguous()
    volume_splat_kernel(g, pts_ndc.contiguous(), acc.shape, out=acc)
    splat_trilinear.launches += 1
    return acc


splat_trilinear.launches = 0


def voxel_grid(volume_shape, device=None):
    """The (D * H * W, 3) [0, 1] coordinates (x, y, z) of a (D, H, W, ...)
    volume's voxel centres, z slowest (JAX fusion.py:270-275): each axis
    `jnp.linspace(0, 1, n)` as JAX computes it, i * float32(1 / (n - 1))."""
    def axis(n):
        return torch.arange(n, device=device) * (1.0 / (n - 1))

    gz, gy, gx = torch.meshgrid(*(axis(n) for n in volume_shape[:3]),
                                indexing="ij")
    return torch.stack([gx, gy, gz], -1).reshape(-1, 3)


class FusionFinetuneSystem(FinetuneSystem):
    """Fusion fine-tuning system (the JAX package's `FusionFinetuneSystem`,
    BASELINE config 5). Builds like `FinetuneSystem` from args and a
    dataset with `pair_idx`, `load_poses_all()`, `focal`, `img_wh`,
    `near_far`, `bbox_3d` and `read_source_views(pair_idx=...)`; the fused
    volume is built in the constructor. Runs on the card unless
    `device="cpu"`.
    """

    VOLUME_DIM = (128, 128, 128)  # reference fusion :101
    # steps between refreshes of the density volume (JAX fusion.py:302)
    DENSITY_EVERY = 500
    SNAPSHOT_KIND = "fusion"

    # ------------------------------------------------------------ fusion ---

    def _refuse_unported(self):
        ckpt = self.args.ckpt
        if ckpt and ckpt.endswith(".msgpack") and os.path.exists(ckpt):
            raise ValueError(
                f"--ckpt {ckpt}: a snapshot is resumed from the run's ckpts/ "
                f"directory or through restore(path); JAX's fusion trainer "
                f"reads --ckpt as a reference checkpoint and cannot read a "
                f".msgpack (mvsnerf_tpu/train/fusion.py:94-97)")
        if self.args.net_type == "v1":
            raise NotImplementedError(
                "fusion with the v1 MLP: its render folds 6 fused-colour "
                "channels into 14 features, and the fused volume holds the "
                "20 of the volume and the source colours (JAX's fuse "
                "reshapes them to 20, mvsnerf_tpu/train/fusion.py:193)")
        super()._refuse_unported()

    def _init_volume(self, ckpt_volume):
        """The fused volume (a checkpoint's volume is not read, as in
        JAX); the colour-baked semantics throughout."""
        ds = self.train_dataset
        self.use_color_volume = True
        self.vox_pts = self.color_feature = None
        self.near_far = self._tensor(ds.near_far)
        self.bbox = self._tensor(ds.bbox_3d)
        self.fuse_local_volumes()

    def _local_render_chunk(self, volume, pose_source, imgs, near_far, rays,
                            twins: bool = False):
        """Per-sample (feats (N, 128, 20), alpha, weights (N, 128), pts
        (N, 128, 3)) of a chunk of 1/4-resolution rays over a local volume
        (JAX fusion.py:111-137): 128 unjittered samples, NDC at quarter
        scale with JAX's arguments, K4 colours, the `grid_sample` fetch,
        then K8 with alpha for the v0 MLP, the module and `raw2outputs`
        for the others (`twins`: the kernels' plain twins)."""
        pts, _, rays_d, z_vals = ray_marcher(rays, FUSE_SAMPLES)
        w2cs, intrinsics = pose_source["w2cs"], pose_source["intrinsics"]
        h4, w4 = imgs.shape[1] // 4, imgs.shape[2] // 4
        quarter = torch.tensor([[0.25], [0.25], [1.0]], device=rays.device)
        pts_ndc = get_ndc_coordinate(
            w2cs[0], intrinsics[0] * quarter, pts,
            torch.tensor([w4 - 1.0, h4 - 1.0], device=rays.device),
            near=near_far[0], far=near_far[1], pad=self.args.pad * 0.25)
        out = render_rays(self.mlp, volume, pts, pts_ndc, z_vals, rays_d,
                          w2cs[0], w2cs, intrinsics, imgs, twins=twins,
                          with_alpha=True)
        return {"feats": out["feats"], "alpha": out["alpha"],
                "weights": out["weights"], "pts": pts}

    def _local_volume(self, imgs_norm, proj_mats, near_far):
        """One view's (D, hp, wp, 8) encoding volume (MVSNet)."""
        return self.mvsnet(imgs_norm, proj_mats, near_far,
                           pad=self.args.pad)[0]

    def _splat_view(self, acc, out, twins: bool = False):
        """Splat one view's local render `out` (`_local_render_chunk`'s
        fields, all its rays) into the (D, H, W, 24) accumulator: features
        and alpha times the render weight, and 1 for the trilinear weight
        (JAX fusion.py:192-200)."""
        w = out["weights"][..., None]
        vals = torch.cat([out["feats"] * w, out["alpha"][..., None] * w,
                          torch.ones_like(w), torch.zeros_like(w),
                          torch.zeros_like(w)], -1)
        pts_ndc = get_ndc_coordinate_bbox(self.bbox[0], self.bbox[1],
                                          out["pts"])
        splat_trilinear(acc, pts_ndc, vals, twins)

    @torch.no_grad()
    def fuse_local_volumes(self, chunk: int = 16384, n_views=None,
                           twins: bool = False):
        """Build the canonical fused volume (JAX fusion.py:139-203,
        reference fusion :117-203), view by view over the training views
        (`pair_idx[0]`; the first `n_views` of them when given): the 3
        nearest training poses by L1 distance of their centres, MVSNet over
        them, the view's rays at 1/4 resolution through
        `_local_render_chunk` in chunks of `chunk` rays (a ray's result
        does not depend on the chunk), and their splat. Sets `volume` (a
        parameter: copied into in place once it exists), `density_volume`
        (the fused sigma), `fuse_acc` (the (D, H, W, 24) accumulator:
        weighted features, weighted alpha, trilinear weight, 0, 0), and the
        first view's sources as `pose_source` and `imgs`. `twins` runs the
        render's and the splat's plain twins (MVSNet's routes are the
        module's)."""
        ds = self.train_dataset
        D, H, W = self.VOLUME_DIM
        acc = torch.zeros((D, H, W, SPLAT_CHANNELS), device=self.device)
        pairs = np.asarray(ds.pair_idx[0])
        c2w_render = np.asarray(ds.load_poses_all())[pairs]
        w_img, h_img = ds.img_wh
        h4, w4 = h_img // 4, w_img // 4
        focal4 = [f / 4.0 for f in ds.focal]
        positions = c2w_render[:, :3, 3]
        for i, c2w in enumerate(c2w_render[:n_views]):
            dis = np.sum(np.abs(positions - c2w[:3, 3:].T), axis=-1)
            imgs_np, proj_mats, nf_np, pose_np = ds.read_source_views(
                pair_idx=pairs[np.argsort(dis)[:3]])
            # the rays from the host's near and far: reading the device's
            # would wait for the MVSNet build queued before them
            rays = self._tensor(rays_for_pose(
                h4, w4, focal4, [w4 / 2, h4 / 2], c2w, nf_np[0], nf_np[1]))
            imgs_norm = self._tensor(imgs_np)
            pose_source = {k: self._tensor(v) for k, v in pose_np.items()}
            near_far = self._tensor(nf_np)
            volume = self._local_volume(imgs_norm, self._tensor(proj_mats),
                                        near_far)
            imgs = unpreprocess_images(imgs_norm).contiguous()
            if i == 0:
                self.pose_source, self.imgs = pose_source, imgs
            outs = [self._local_render_chunk(volume, pose_source, imgs,
                                             near_far, rays[j:j + chunk],
                                             twins)
                    for j in range(0, len(rays), chunk)]
            self._splat_view(acc, {k: torch.cat([o[k] for o in outs])
                                   for k in outs[0]}, twins)
            del volume, outs
        inv_w = 1.0 / (acc[..., WEIGHT:WEIGHT + 1] + 1e-6)
        fused = (acc[..., :N_FEATS] * inv_w).contiguous()
        self.fuse_acc = acc
        self.density_volume = acc[..., ALPHA:ALPHA + 1] * inv_w
        if isinstance(getattr(self, "volume", None), torch.nn.Parameter):
            self.volume.copy_(fused)
        else:
            self.volume = torch.nn.Parameter(fused)

    # ------------------------------------------------------------- train ---

    def _build_optimizer(self):
        """Adam over {mlp, volume} only, the schedule at its default length
        of 10000 steps (JAX fusion.py:212-213)."""
        self._make_adam([*self.mlp.parameters(), self.volume], 10000)

    def _samples(self, rays, generator):
        """(pts, rays_d, z_vals, pts_ndc) of a (N, 8) ray batch in the
        box's coordinates (JAX fusion.py:223-232): depths between where
        each ray enters and leaves the box, jittered from `generator`, then
        with `--N_importance` that many more drawn from the density volume
        (`ray_marcher_fine`), from the same generator."""
        args = self.args
        return sample_rays(
            rays, args.N_samples, None, None, None, None, None,
            perturb=args.perturb, generator=generator, lindisp=args.use_disp,
            density_volume=self.density_volume,
            n_importance=args.N_importance, bbox=self.bbox)

    @torch.no_grad()
    def update_density_volume(self):
        """The MLP's density at the voxel centres of the fused volume, in
        the [0, 1] box coordinates training uses, from the volume's own 20
        channels (JAX fusion.py:264-276): (D, H, W, 1)."""
        vol = self.volume.detach()
        d, h, w, c = vol.shape
        sigma = render_density(self.mlp, voxel_grid(vol.shape, vol.device),
                               vol.reshape(-1, c))
        self.density_volume = sigma.reshape(d, h, w, 1)

    def _refreshes_density(self) -> bool:
        """`fit` refreshes the density volume every DENSITY_EVERY steps
        with `--N_importance`, `--use_density_volume` or not (JAX
        fusion.py:301-302)."""
        return bool(self.args.N_importance)

    # --------------------------------------------------------- rendering ---

    def _tiled_renderer(self, chunk: int):
        """K6b over the fused volume in the box's coordinates (JAX
        fusion.py:367-376); the density volume with `--N_importance`."""
        args = self.args
        return cached_tiled_renderer(
            self, self.volume, None, None, self.pose_source,
            n_samples=args.N_samples, pad=args.pad,
            white_bkgd=args.white_bkgd, chunk=chunk, lindisp=args.use_disp,
            density_volume=self.density_volume if args.N_importance
            else None, n_importance=args.N_importance, bbox=self.bbox)
