"""Per-scene fine-tuning (counterpart of mvsnerf_tpu/train/finetune.py,
reference train_mvs_nerf_finetuning_pl.py).

The encoding volume is built once by MVSNet from 3 source views (or taken
from a reference checkpoint that holds one) and becomes an `nn.Parameter`
trained beside the MLP. Each step samples a batch of rays, renders them
on the training route (K4 colours, K5 volume fetch, K7 MLP on a card;
their plain versions on the CPU), takes the MSE against the pixels and
updates with Adam under the step schedule.

With `--use_color_volume` the per-view colours are baked once into the
volume (render/tiled.py:`bake_color_volume`), which becomes a trainable
20-channel volume: the step fetches all 20 features through K5 and warps
no colours, and Adam holds {mlp, volume} only.

With `--use_density_volume` the MLP's density at the voxel centres is
baked into a (D, hp, wp, 1) density volume every 200 steps
(`update_density_volume`), and with `--N_importance` > 0 each ray adds
that many depths drawn from it (inverse CDF) to its `N_samples`;
validation then runs 100 steps off the refresh. `--use_disp` spaces the
sweep planes, the samples and NDC z linearly in disparity. Validation
logs the held-out view's PSNR and its [gt | pred | depth] panel.

train/fusion.py's `FusionFinetuneSystem` is a subclass: it overrides the
volume, the optimizer, the samples, the density refresh and its cadence,
and the tiled render, and shares the step, `fit`, validation and
snapshots.

`--net_type`, `--netdepth` and `--netwidth` pick the MLP
(models/nerf_mlp.py): the v0 MLP at D=6, W=128 runs on K7 in the step and
K8 in the chunked render; every other one runs the module's forward, K4
and K5 serving all; `--render_mode tiled` raises ValueError at the render for
any other (K6b is v0-only). Refused with NotImplementedError: the density
volume with v1 (it has no alpha head).

Snapshots are the port's `.pt` files; `restore` also reads the JAX
package's `.msgpack` snapshots (io/jax_snapshot.py), a file by its suffix
or a directory's newest (`.pt` first). A `.msgpack` `--ckpt` is skipped at
construction, which builds seeded modules as JAX does
(finetune.py:66-70); the caller restores it (`render_video`).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import resolve_device, set_precision_policy
from ..io.checkpoint import read_snapshot, save_checkpoint, snapshot_path
from ..io.torch_ckpt import load_reference_checkpoint
from ..models.mvsnet import MVSNet
from ..models.nerf_mlp import MVSNeRF
from ..render.renderer import gen_dir_feature, gen_pts_feats, \
    network_input, render_density, render_image_chunked, render_rays, \
    sample_rays
from ..render.tiled import cached_tiled_renderer, color_feature_volume
from ..utils.profiling import trace_context
from ..utils.schedulers import make_lr_schedule
from ..utils.vis import panel, visualize_depth
from .common import Prefetcher, RayBatchIterator, unpreprocess_images


def frustum_point_volume(h, w, d, pad, near_far, intrinsic_s4, c2w):
    """World-space centres of the volume's voxels, (D, h + 2 pad,
    w + 2 pad, 3) channel-last (reference utils.py:338-355
    `get_ptsvolume`, JAX train/finetune.py:35). `intrinsic_s4` is the
    stride-4 (feature-scale) intrinsic; h, w are the unpadded feature
    dims. Plane 0 is at `near`, the last at `far` (the reference's
    linspace(1, 0)), the volume's plane order."""
    dev = intrinsic_s4.device

    def linspace(a, b, n):
        return a + (b - a) / (n - 1) * torch.arange(n, device=dev)

    corners = torch.tensor([[-pad, -pad, 1.0], [w + pad, -pad, 1.0],
                            [-pad, h + pad, 1.0]], device=dev)
    corners = corners @ torch.linalg.inv(intrinsic_s4).T
    xs = linspace(corners[0, 0], corners[1, 0], w + 2 * pad)
    ys = linspace(corners[0, 1], corners[2, 1], h + 2 * pad)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    plane = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    t = linspace(torch.tensor(1.0, device=dev), torch.tensor(0.0, device=dev),
                 d).reshape(d, 1, 1, 1)
    pts = t * plane * near_far[0] + (1 - t) * plane * near_far[1]
    pts = pts.reshape(-1, 3) @ c2w[:3, :3].T + c2w[:3, 3]
    return pts.reshape(d, h + 2 * pad, w + 2 * pad, 3)


# `--ckpt` suffixes that name a snapshot, not a reference checkpoint
SNAPSHOT_SUFFIXES = (".pt", ".msgpack")

# the offset of validation from the density refreshes (JAX
# finetune.py:266, fusion.py:313)
VAL_PHASE = 100


def seeded_modules(args, device):
    """The MLP of `--net_type` / `--netdepth` / `--netwidth` and MVSNet (its
    U-Net on `--costreg_impl`'s route), initialised from torch seed 0 on
    the CPU and moved to `device`: every process builds the same weights."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        mlp = MVSNeRF(args.net_type, args.netdepth, args.netwidth)
        mvsnet = MVSNet(costreg_impl=args.costreg_impl)
    return mlp.to(device), mvsnet.to(device)


def reference_modules(args, device):
    """`load_reference_checkpoint` of `--ckpt` with the MLP the flags name
    (the checkpoint's keys do not tell v0 from v2)."""
    return load_reference_checkpoint(args.ckpt, device, args.costreg_impl,
                                     args.net_type, args.netdepth,
                                     args.netwidth)


def psnr(pred, gt):
    """PSNR of [0, 1] images from their mean squared error."""
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    return -10.0 * math.log10(max(mse, 1e-10))


class FinetuneSystem:
    """Fine-tuning system: build with args (config.config_parser) and a
    dataset, then call .fit(steps). Any object with `read_source_views()`,
    `all_rays` and `all_rgbs` serves as the training dataset; a validation
    dataset also needs `len()` and items with `rays` and `rgbs` images.

    It runs on the CUDA card unless `device="cpu"` is passed (and raises
    with no card). On the card the step runs the hand-written kernels; on
    the CPU their plain PyTorch versions.
    """

    # steps between refreshes of the density volume (JAX finetune.py:245)
    DENSITY_EVERY = 200
    # the JAX trainer whose `.msgpack` snapshots `restore` reads
    SNAPSHOT_KIND = "finetune"

    def __init__(self, args, dataset_train, dataset_val=None, device=None):
        set_precision_policy()
        self.args = args
        self._refuse_unported()
        self.train_dataset = dataset_train
        self.val_dataset = dataset_val
        self.device = resolve_device(device)

        ckpt_volume = None
        # a snapshot (the port's `.pt`, JAX's `.msgpack`) is not a
        # reference checkpoint: the caller restores it after construction
        # (`restore`), as JAX finetune.py:66-70 skips `.msgpack`
        if args.ckpt and os.path.exists(args.ckpt) and \
                not args.ckpt.endswith(SNAPSHOT_SUFFIXES):
            self.mlp, self.mvsnet, ckpt_volume = reference_modules(
                args, self.device)
        else:
            self.mlp, self.mvsnet = seeded_modules(args, self.device)
        self.use_color_volume = args.use_color_volume
        self._init_volume(ckpt_volume)
        self._build_optimizer()

    # ------------------------------------------------------------- setup ---

    def _refuse_unported(self):
        """The density refresh runs the MLP's alpha head, which v1 lacks
        (JAX's `_ALPHA` has no v1 and fails at its first refresh)."""
        if self._refreshes_density() and self.args.net_type == "v1":
            raise NotImplementedError(
                "the density volume needs the MLP's alpha head, and the v1 "
                "MLP has none (mvsnerf_tpu/models/nerf_mlp.py:222)")

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _init_volume(self, ckpt_volume):
        """Build the encoding volume once (reference finetuning:57-89)."""
        imgs, proj_mats, near_far, pose_source = \
            self.train_dataset.read_source_views()
        self.imgs_norm = self._tensor(imgs)
        self.near_far = self._tensor(near_far)
        self.pose_source = {k: self._tensor(v)
                            for k, v in pose_source.items()}
        self.imgs = unpreprocess_images(self.imgs_norm).contiguous()
        args = self.args
        if ckpt_volume is not None:
            volume = ckpt_volume.to(self.device, torch.float32)
        else:
            with torch.no_grad():
                volume, _ = self.mvsnet(self.imgs_norm,
                                        self._tensor(proj_mats),
                                        self.near_far, pad=args.pad,
                                        lindisp=args.use_disp)
        # the voxel centres and their colours (JAX finetune.py:113-130): the
        # colour volume's 12 channels, and the density refresh's points and
        # features
        self.density_volume = self.vox_pts = self.color_feature = None
        if args.use_color_volume or args.use_density_volume:
            self.vox_pts, self.color_feature = color_feature_volume(
                volume.shape, self.imgs, self.pose_source, self.near_far,
                args.pad)
        if args.use_color_volume and volume.shape[-1] == 8:
            volume = torch.cat([volume, self.color_feature], -1)
        self.volume = torch.nn.Parameter(volume.detach().clone()
                                         .contiguous())

    def _build_optimizer(self):
        """Adam over the MLP, the volume and, without the colour volume,
        the MVSNet (JAX finetune.py:132-136). The MVSNet never runs in the
        step, so its gradients stay None and Adam leaves it as it is. On a
        card Adam is PyTorch's fused kernel (one pass over the volume, 37.5M
        values or 93.7M with the colour volume, and its moments instead of
        several)."""
        args = self.args
        mvsnet = [] if args.use_color_volume else [*self.mvsnet.parameters()]
        self._make_adam([*self.mlp.parameters(), self.volume, *mvsnet],
                        args.num_epochs * 10000 or 10000)

    def _make_adam(self, params, num_steps: int):
        """Adam over `params` and a LambdaLR of the step schedule over
        `num_steps` (only the cosine and poly schedules read it)."""
        args = self.args
        schedule = make_lr_schedule(
            args.lrate, args.lr_scheduler, args.decay_step, args.decay_gamma,
            num_steps=num_steps)
        self.optimizer = torch.optim.Adam(
            params, lr=args.lrate, betas=(0.9, 0.999),
            fused=self.device.type == "cuda")
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda s: schedule(s) / args.lrate)

    # -------------------------------------------------------------- train --

    def _samples(self, rays, generator):
        """(pts, rays_d, z_vals, pts_ndc) of a (N, 8) ray batch, the depth
        jitter drawn from `generator`, then, with a density volume and
        `--N_importance`, the importance samples' uniforms."""
        args = self.args
        return sample_rays(
            rays, args.N_samples, self.pose_source["w2cs"][0],
            self.pose_source["intrinsics"][0], self.imgs.shape[1:3],
            self.near_far, args.pad, perturb=args.perturb,
            generator=generator, lindisp=args.use_disp,
            density_volume=self.density_volume,
            n_importance=args.N_importance)

    def render_rays(self, rays, training: bool, generator=None,
                    twins: bool = False):
        """Render a (N, 8) ray batch over the trainable volume; dict rgb,
        depth, acc, ... (render.renderer.render_rays: K8 with gradients
        off)."""
        with trace_context("render.sample"):
            pts, rays_d, z_vals, pts_ndc = self._samples(rays, generator)
        w2cs = self.pose_source["w2cs"]
        return render_rays(self.mlp, self.volume, pts, pts_ndc, z_vals,
                           rays_d, w2cs[0], w2cs,
                           self.pose_source["intrinsics"], self.imgs,
                           white_bkgd=self.args.white_bkgd,
                           training=training, twins=twins,
                           use_color_volume=self.use_color_volume)

    @torch.no_grad()
    def mlp_input(self, rays, generator=None):
        """The MLP's (N, S, 86) input for a ray batch at the current state,
        with the depth jitter drawn from `generator` as `_step` draws it."""
        pts, rays_d, _, pts_ndc = self._samples(rays, generator)
        w2cs = self.pose_source["w2cs"]
        feats = gen_pts_feats(self.volume, pts_ndc, pts, w2cs,
                              self.pose_source["intrinsics"], self.imgs,
                              use_color_volume=self.use_color_volume)
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        return network_input(pts_ndc, gen_dir_feature(w2cs[0], unit), feats)

    @torch.no_grad()
    def update_density_volume(self):
        """Bake the MLP's density at the voxel centres into
        `self.density_volume`, (D, hp, wp, 1) (JAX finetune.py:208-220,
        reference finetuning:91-99). The features are the volume's,
        joined to the baked colours when it has 8 channels. The points are
        the WORLD voxel centres, where the render feeds NDC: the
        reference's quirk, kept (ROADMAP.md)."""
        vol = self.volume.detach()
        d, hp, wp, c = vol.shape
        if c == 8:
            vol = torch.cat([vol, self.color_feature], -1)
        sigma = render_density(self.mlp, self.vox_pts.reshape(-1, 3),
                               vol.reshape(d * hp * wp, -1))
        self.density_volume = sigma.reshape(d, hp, wp, 1)

    def _refreshes_density(self) -> bool:
        """Whether `fit` refreshes the density volume (every
        DENSITY_EVERY steps) and offsets validation from the refreshes."""
        return self.args.use_density_volume

    def _step(self, rays, rgbs, generator=None, twins: bool = False):
        """One step on a (N, 8) ray batch and its (N, 3) colours: MSE, its
        gradients, an Adam update and a schedule tick. Returns the loss as
        a 0-d tensor on the device (reading it synchronises). `twins` runs
        the kernels' plain versions, to hold one step against the other."""
        out = self.render_rays(rays, training=True, generator=generator,
                               twins=twins)
        loss = torch.mean((out["rgb"] - rgbs) ** 2)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return loss.detach()

    def fit(self, num_steps: int = 10000, log_every: int = 100,
            logger=None, ckpt_dir: str | None = None, seed: int = 0,
            start_step: int = 0, val_every: int = 500):
        """Train for steps [start_step, num_steps) (JAX
        finetune.py:229-277): batches from `RayBatchIterator(seed)`, depth
        jitter from a generator on the device seeded from (seed, step).
        With `--use_density_volume` the density volume is baked again
        before every step that is a multiple of DENSITY_EVERY
        (`_refreshes_density`). Every
        `val_every` steps (offset by VAL_PHASE with the density volume) a
        held-out view is rendered and its PSNR logged; snapshots every 5000
        steps and at the end when `ckpt_dir` is given. Returns the losses
        as floats."""
        args = self.args
        refresh = self._refreshes_density()
        val_phase = VAL_PHASE if refresh else 0
        it = Prefetcher(RayBatchIterator(
            {"rays": self.train_dataset.all_rays,
             "rgbs": self.train_dataset.all_rgbs}, args.batch_size,
            seed=seed))
        gen = torch.Generator(device=self.device)
        losses = []
        try:
            for step_i in range(start_step, num_steps):
                if refresh and step_i % self.DENSITY_EVERY == 0:
                    self.update_density_volume()
                batch = next(it)
                gen.manual_seed(seed * 2 ** 32 + step_i)
                # non-blocking: the host stages the batch and goes on
                # launching while the device finishes the previous step
                rays, rgbs = (torch.from_numpy(batch[k]).to(
                    self.device, non_blocking=True) for k in ("rays", "rgbs"))
                loss = self._step(rays, rgbs, gen)
                losses.append(loss)
                if logger is not None and step_i % log_every == 0:
                    mse = float(loss)
                    logger.log_scalars(step_i, {
                        "train/loss": mse,
                        "train/PSNR": -10 * math.log10(max(mse, 1e-10))})
                if val_every and logger is not None and \
                        step_i > start_step and \
                        (step_i - val_phase) % val_every == 0:
                    self.validate(step_i, logger)
                if ckpt_dir and (step_i + 1) % 5000 == 0:
                    self.save(ckpt_dir, step_i + 1)
        finally:
            it.close()
        if ckpt_dir:
            self.save(ckpt_dir, num_steps)
        return torch.stack(losses).cpu().tolist() if losses else []

    def validate(self, step_i: int, logger, chunk: int | None = None):
        """Render one held-out view (cycling through the val split), log
        val/PSNR and save its [gt | pred | depth] panel (JAX
        finetune.py:279-299). Returns the PSNR, or None without a val
        dataset."""
        if self.val_dataset is None or len(self.val_dataset) == 0:
            return None
        self._val_counter = getattr(self, "_val_counter", -1) + 1
        idx = self._val_counter % len(self.val_dataset)
        sample = self.val_dataset[idx]
        gt = np.asarray(sample["rgbs"])
        h, w = gt.shape[:2]
        out = self.render_image(sample["rays"],
                                chunk=chunk or self.args.chunk * 8)
        pred = np.clip(out["rgb"].cpu().numpy().reshape(h, w, 3), 0, 1)
        val_psnr = psnr(pred, gt)
        logger.log_scalars(step_i, {"val/PSNR": val_psnr})
        dvis, _ = visualize_depth(out["depth"].cpu().numpy().reshape(h, w))
        logger.save_panel(step_i, f"val_{idx:02d}", panel([gt, pred, dvis]))
        return val_psnr

    # --------------------------------------------------------- rendering ---

    @torch.no_grad()
    def render_image(self, rays, chunk: int = 8192):
        """Full-image render from a flat (N, 8) ray buffer over the trained
        volume.

        With `--render_mode tiled` the colour-baked volume goes through K6b
        (render/tiled.py), at unjittered depths (and importance depths
        drawn from a generator seeded 1); the bake is cached until the
        volume or the density volume changes, joins the colours baked at
        set-up, or is the volume itself with `--use_color_volume`.
        Otherwise chunk by chunk: the K5 fetch (and K4 colours), then K8
        for PE, MLP and compositing, with depths jittered as in training
        and importance depths drawn after them, all from one generator
        seeded 0 (the JAX trainer renders with PRNGKey(0) and its
        fold_in(1))."""
        with trace_context("upload"):
            rays = torch.as_tensor(np.asarray(rays, np.float32),
                                   device=self.device)
        if self.args.render_mode == "tiled":
            # rays render one by one: a (1, N) "image" is the whole buffer
            return self._tiled_renderer(chunk)(rays, 1, rays.shape[0])
        gen = torch.Generator(device=self.device).manual_seed(0)

        def chunk_fn(r):
            out = self.render_rays(r, training=True, generator=gen)
            return {"rgb": out["rgb"], "depth": out["depth"]}

        return render_image_chunked(chunk_fn, (rays,), rays.shape[0], chunk)

    def _tiled_renderer(self, chunk: int):
        """`render_image`'s tiled renderer (`cached_tiled_renderer`)."""
        args = self.args
        return cached_tiled_renderer(
            self, self.volume, self.imgs, self.near_far, self.pose_source,
            n_samples=args.N_samples, pad=args.pad,
            white_bkgd=args.white_bkgd, chunk=chunk, lindisp=args.use_disp,
            density_volume=self.density_volume,
            n_importance=args.N_importance, color_feature=self.color_feature)

    # ------------------------------------------------------------- state ---

    def state(self, step: int):
        """Everything a resume needs: params, optimizer and scheduler state
        and the global step."""
        return {"params": {"mlp": self.mlp.state_dict(),
                           "volume": self.volume.detach(),
                           "mvsnet": self.mvsnet.state_dict()},
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "global_step": step}

    def save(self, ckpt_dir: str, step: int) -> str:
        return save_checkpoint(ckpt_dir, self.state(step), step)

    def restore(self, ckpt_path_or_dir: str, strict: bool = False) -> int:
        """Load a snapshot: a file path loads that file (a JAX `.msgpack`
        or a port `.pt`), a directory its newest `ckpt_*.pt`, else its
        newest `ckpt_*.msgpack`. Returns the restored global step; 0 when
        nothing was found (raises instead when `strict`)."""
        path = snapshot_path(ckpt_path_or_dir, strict)
        if path is None:
            return 0
        return self.load_state(read_snapshot(path, self.SNAPSHOT_KIND, self))

    def load_state(self, state) -> int:
        """Take over a `state()` dict; returns its global step."""
        params = state["params"]
        self.mlp.load_state_dict(params["mlp"])
        self.mvsnet.load_state_dict(params["mvsnet"])
        with torch.no_grad():
            self.volume.copy_(params["volume"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        return int(state["global_step"])
