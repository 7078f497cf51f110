"""Per-scene fine-tuning (counterpart of mvsnerf_tpu/train/finetune.py,
reference train_mvs_nerf_finetuning_pl.py).

The encoding volume is built once by MVSNet from 3 source views (or taken
from a reference checkpoint that holds one) and becomes an `nn.Parameter`
trained beside the v0 MLP. Each step samples a batch of rays, renders them
on the training route (K4 colours, K5 volume fetch, K7 MLP on a card;
their plain versions on the CPU), takes the MSE against the pixels and
updates with Adam under the step schedule.

With `--use_color_volume` the per-view colours are baked once into the
volume (render/tiled.py:`bake_color_volume`), which becomes a trainable
20-channel volume: the step fetches all 20 features through K5 and warps
no colours, and Adam holds {mlp, volume} only.

Refused with NotImplementedError (ROADMAP.md): the density volume and
`N_importance > 0`, `use_disp`, MLPs other than v0 at D=6, W=128, and
reading the JAX package's `.msgpack` snapshots.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import resolve_device, set_precision_policy
from ..io.checkpoint import latest_checkpoint, load_checkpoint, \
    save_checkpoint
from ..io.torch_ckpt import load_reference_checkpoint
from ..models.mvsnet import MVSNet
from ..models.nerf_mlp import MVSNeRF
from ..render.renderer import gen_dir_feature, gen_pts_feats, \
    network_input, render_image_chunked, render_rays, sample_rays
from ..render.tiled import bake_color_volume, cached_tiled_renderer
from ..utils.schedulers import make_lr_schedule
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


def _refuse_unported(args):
    for flag, what in (
            ("use_density_volume", "the density volume (ray_marcher_fine, "
             "sample_pdf, render_density, the 200-step refresh)"),
            ("use_disp", "sampling linear in disparity")):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag}: {what} is not ported yet")
    if args.N_importance > 0:
        raise NotImplementedError("--N_importance > 0 is not ported yet")
    if args.net_type != "v0" or args.netdepth != 6 or args.netwidth != 128:
        raise NotImplementedError(
            f"only the v0 MLP at D=6, W=128 is ported, got --net_type "
            f"{args.net_type} --netdepth {args.netdepth} --netwidth "
            f"{args.netwidth}")


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

    def __init__(self, args, dataset_train, dataset_val=None, device=None):
        _refuse_unported(args)
        set_precision_policy()
        self.args = args
        self.train_dataset = dataset_train
        self.val_dataset = dataset_val
        self.device = resolve_device(device)

        ckpt_volume = None
        # a port snapshot (`.pt`) is not a reference checkpoint: the caller
        # restores it after construction (`restore`)
        if args.ckpt and os.path.exists(args.ckpt) and \
                not args.ckpt.endswith(".pt"):
            if args.ckpt.endswith(".msgpack"):
                raise NotImplementedError(
                    "reading the JAX package's .msgpack snapshots is not "
                    "ported yet")
            self.mlp, self.mvsnet, ckpt_volume = load_reference_checkpoint(
                args.ckpt, self.device, args.costreg_impl)
        else:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                mlp, mvsnet = MVSNeRF(), MVSNet(
                    costreg_impl=args.costreg_impl)
            self.mlp, self.mvsnet = mlp.to(self.device), \
                mvsnet.to(self.device)
        self._init_volume(ckpt_volume)
        self._build_optimizer()

    # ------------------------------------------------------------- setup ---

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
        if ckpt_volume is not None:
            volume = ckpt_volume.to(self.device, torch.float32)
        else:
            with torch.no_grad():
                volume, _ = self.mvsnet(self.imgs_norm,
                                        self._tensor(proj_mats),
                                        self.near_far, pad=self.args.pad)
        if self.args.use_color_volume and volume.shape[-1] == 8:
            volume = bake_color_volume(volume, self.imgs, self.pose_source,
                                       self.near_far, self.args.pad)
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
        schedule = make_lr_schedule(
            args.lrate, args.lr_scheduler, args.decay_step, args.decay_gamma,
            num_steps=args.num_epochs * 10000 or 10000)
        mvsnet = [] if args.use_color_volume else [*self.mvsnet.parameters()]
        self.optimizer = torch.optim.Adam(
            [*self.mlp.parameters(), self.volume, *mvsnet],
            lr=args.lrate, betas=(0.9, 0.999),
            fused=self.device.type == "cuda")
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda s: schedule(s) / args.lrate)

    # -------------------------------------------------------------- train --

    def _samples(self, rays, generator):
        """(pts, rays_d, z_vals, pts_ndc) of a (N, 8) ray batch, the depth
        jitter drawn from `generator`."""
        return sample_rays(
            rays, self.args.N_samples, self.pose_source["w2cs"][0],
            self.pose_source["intrinsics"][0], self.imgs.shape[1:3],
            self.near_far, self.args.pad, perturb=self.args.perturb,
            generator=generator)

    def render_rays(self, rays, training: bool, generator=None,
                    twins: bool = False):
        """Render a (N, 8) ray batch over the trainable volume; dict rgb,
        depth, acc, ... (render.renderer.render_rays: K8 with gradients
        off)."""
        pts, rays_d, z_vals, pts_ndc = self._samples(rays, generator)
        w2cs = self.pose_source["w2cs"]
        return render_rays(self.mlp, self.volume, pts, pts_ndc, z_vals,
                           rays_d, w2cs[0], w2cs,
                           self.pose_source["intrinsics"], self.imgs,
                           white_bkgd=self.args.white_bkgd,
                           training=training, twins=twins,
                           use_color_volume=self.args.use_color_volume)

    @torch.no_grad()
    def mlp_input(self, rays, generator=None):
        """The MLP's (N, S, 86) input for a ray batch at the current state,
        with the depth jitter drawn from `generator` as `_step` draws it."""
        pts, rays_d, _, pts_ndc = self._samples(rays, generator)
        w2cs = self.pose_source["w2cs"]
        feats = gen_pts_feats(self.volume, pts_ndc, pts, w2cs,
                              self.pose_source["intrinsics"], self.imgs,
                              use_color_volume=self.args.use_color_volume)
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        return network_input(pts_ndc, gen_dir_feature(w2cs[0], unit), feats)

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
        Every `val_every` steps a held-out view is rendered and its PSNR
        logged; snapshots every 5000 steps and at the end when `ckpt_dir`
        is given. Returns the losses as floats."""
        args = self.args
        it = Prefetcher(RayBatchIterator(
            {"rays": self.train_dataset.all_rays,
             "rgbs": self.train_dataset.all_rgbs}, args.batch_size,
            seed=seed))
        gen = torch.Generator(device=self.device)
        losses = []
        try:
            for step_i in range(start_step, num_steps):
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
                        step_i > start_step and step_i % val_every == 0:
                    self.validate(step_i, logger)
                if ckpt_dir and (step_i + 1) % 5000 == 0:
                    self.save(ckpt_dir, step_i + 1)
        finally:
            it.close()
        if ckpt_dir:
            self.save(ckpt_dir, num_steps)
        return torch.stack(losses).cpu().tolist() if losses else []

    def validate(self, step_i: int, logger, chunk: int | None = None):
        """Render one held-out view (cycling through the val split) and log
        val/PSNR. Returns the PSNR, or None without a val dataset."""
        if self.val_dataset is None or len(self.val_dataset) == 0:
            return None
        self._val_counter = getattr(self, "_val_counter", -1) + 1
        sample = self.val_dataset[self._val_counter % len(self.val_dataset)]
        gt = np.asarray(sample["rgbs"])
        h, w = gt.shape[:2]
        out = self.render_image(sample["rays"],
                                chunk=chunk or self.args.chunk * 8)
        pred = np.clip(out["rgb"].cpu().numpy().reshape(h, w, 3), 0, 1)
        val_psnr = psnr(pred, gt)
        logger.log_scalars(step_i, {"val/PSNR": val_psnr})
        return val_psnr

    # --------------------------------------------------------- rendering ---

    @torch.no_grad()
    def render_image(self, rays, chunk: int = 8192):
        """Full-image render from a flat (N, 8) ray buffer over the trained
        volume.

        With `--render_mode tiled` the colour-baked volume goes through K6b
        (render/tiled.py), at unjittered depths; the bake is cached until
        the volume changes, or is the volume itself with
        `--use_color_volume`. Otherwise chunk by chunk: the K5 fetch (and
        K4 colours), then K8 for PE, MLP and compositing, with depths
        jittered as in training by a generator seeded 0 (the JAX trainer
        renders with PRNGKey(0))."""
        rays = torch.as_tensor(np.asarray(rays, np.float32),
                               device=self.device)
        if self.args.render_mode == "tiled":
            fn = cached_tiled_renderer(
                self, self.volume, self.imgs, self.near_far,
                self.pose_source, n_samples=self.args.N_samples,
                pad=self.args.pad, white_bkgd=self.args.white_bkgd,
                chunk=chunk)
            # rays render one by one: a (1, N) "image" is the whole buffer
            return fn(rays, 1, rays.shape[0])
        gen = torch.Generator(device=self.device).manual_seed(0)

        def chunk_fn(r):
            out = self.render_rays(r, training=True, generator=gen)
            return {"rgb": out["rgb"], "depth": out["depth"]}

        return render_image_chunked(chunk_fn, (rays,), rays.shape[0], chunk)

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
        """Load a snapshot: a file path loads that file, a directory its
        newest `ckpt_*.pt`. Returns the restored global step; 0 when nothing
        was found (raises instead when `strict`)."""
        if os.path.isfile(ckpt_path_or_dir):
            path = ckpt_path_or_dir
        else:
            latest = latest_checkpoint(ckpt_path_or_dir)
            if latest is None:
                if strict:
                    raise FileNotFoundError(
                        f"no ckpt_*.pt snapshot in {ckpt_path_or_dir!r}")
                return 0
            path = latest[1]
        return self.load_state(load_checkpoint(path, self.device))

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
