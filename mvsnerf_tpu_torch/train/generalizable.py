"""Generalizable training across scenes (counterpart of
mvsnerf_tpu/train/generalizable.py, reference train_mvs_nerf_pl.py).

Each step: MVSNet builds the encoding volume from the 3 source views
(FeatureNet, the K1 sweep, the CostRegNet U-Net), random rays are drawn
in the target view (the last view), rendered on the training route (K4
colours, K5 volume fetch, K7 MLP), and supervised with the RGB MSE plus,
with `--with_depth_loss`, half a SmoothL1 depth loss. The backward runs
through K7, the K5 splat, the U-Net, K2 (the sweep backward) and
FeatureNet; Adam (fused on a card) updates the MLP and the MVSNet under
the cosine schedule. On the CPU every kernel is its plain twin.

Refused with NotImplementedError: MLPs other than v0 at D=6, W=128, and
reading the JAX package's `.msgpack` snapshots. The JAX trainer's mesh
(data parallelism) is not ported (ROADMAP Queue 1 item 10).
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
from ..ops.geometry import full_image_pixels, get_ndc_coordinate, \
    rays_from_pixels, sample_random_pixels
from ..render.renderer import gen_dir_feature, gen_pts_feats, \
    network_input, render_image_chunked, render_rays
from ..utils.schedulers import make_lr_schedule
from .common import unpreprocess_images

# the sample's arrays the step reads (the rest are ids and the scan name)
BATCH_KEYS = ("images", "proj_mats", "near_fars", "w2cs", "c2ws",
              "intrinsics", "depths_h")


def smooth_l1(pred, target, beta: float = 1.0):
    """torch SmoothL1Loss, unreduced (reference train_mvs_nerf_pl.py:22-32)."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


class GeneralizableSystem:
    """Cross-scene training system (BASELINE config 4): build with args
    (config.config_parser), then call `.fit(dataset)`. A dataset is any
    sequence of `MVSDatasetDTU`-style sample dicts.

    It runs on the CUDA card unless `device="cpu"` is passed (and raises
    with no card). A reference `--ckpt` loads the MLP and the MVSNet and
    training starts at step 0 (JAX generalizable.py:45-48); otherwise the
    modules are initialised from torch seed 0.
    """

    def __init__(self, args, device=None):
        if args.net_type != "v0" or args.netdepth != 6 or args.netwidth != 128:
            raise NotImplementedError(
                f"only the v0 MLP at D=6, W=128 is ported, got --net_type "
                f"{args.net_type} --netdepth {args.netdepth} --netwidth "
                f"{args.netwidth}")
        set_precision_policy()
        self.args = args
        self.device = resolve_device(device)
        if args.ckpt and os.path.exists(args.ckpt):
            if args.ckpt.endswith(".msgpack"):
                raise NotImplementedError(
                    "reading the JAX package's .msgpack snapshots is not "
                    "ported yet")
            self.mlp, self.mvsnet, _ = load_reference_checkpoint(
                args.ckpt, self.device)
        else:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                mlp, mvsnet = MVSNeRF(), MVSNet()
            self.mlp, self.mvsnet = mlp.to(self.device), \
                mvsnet.to(self.device)
        self.global_step = 0
        # the cosine schedule's length; the first `fit` fixes it, as the
        # JAX trainer fixes it when it builds its step
        self.schedule_steps = None
        self.optimizer = torch.optim.Adam(
            [*self.mlp.parameters(), *self.mvsnet.parameters()],
            lr=args.lrate, betas=(0.9, 0.999),
            fused=self.device.type == "cuda")
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda s: self._lr(s) / args.lrate)

    def _lr(self, count: int) -> float:
        """The learning rate of update `count` (train_mvs_nerf_pl.py:84-88:
        cosine to 1e-7 over the run's steps)."""
        return make_lr_schedule(self.args.lrate, "cosine",
                                num_steps=max(self.schedule_steps or 1, 1),
                                eta_min=1e-7)(count)

    # -------------------------------------------------------------- train --

    def batch(self, sample):
        """A dataset sample's arrays as float32 tensors on the device."""
        return {k: torch.from_numpy(np.asarray(sample[k], np.float32)).to(
                    self.device, non_blocking=True)
                for k in BATCH_KEYS if k in sample}

    def draw(self, batch, generator=None):
        """The step's random draws: `batch_size` integer pixels of the
        target view and the (batch_size, N_samples) uniform depth jitter,
        in that order from `generator`."""
        _, H, W, _ = batch["images"].shape
        xs, ys = sample_random_pixels(H, W, self.args.batch_size, generator,
                                      self.device)
        u = torch.rand((self.args.batch_size, self.args.N_samples),
                       generator=generator, device=self.device)
        return xs, ys, u

    def _samples(self, batch, xs, ys, u):
        """The rays of the target view (= the last view, utils.py:177) at
        pixels (xs, ys), z stratified in its near/far with jitter `u`, and
        their reference-view NDC: (pts, pts_ndc, z_vals, rays_d)."""
        near_fars, intrinsics = batch["near_fars"], batch["intrinsics"]
        _, H, W, _ = batch["images"].shape
        tgt = len(near_fars) - 1
        rays_o, rays_d = rays_from_pixels(xs, ys, intrinsics[tgt],
                                          batch["c2ws"][tgt])
        near, far = near_fars[tgt, 0], near_fars[tgt, 1]
        t = torch.linspace(0.0, 1.0, u.shape[1], device=self.device)
        z_vals = (near * (1 - t) + far * t).expand(u.shape)
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        z_vals = lower + (upper - lower) * u

        pts = rays_o + z_vals[..., None] * rays_d[:, None]
        inv_scale = torch.tensor([W - 1.0, H - 1.0]).to(self.device,
                                                        non_blocking=True)
        pts_ndc = get_ndc_coordinate(batch["w2cs"][0], intrinsics[0], pts,
                                     inv_scale, near=near_fars[0, 0],
                                     far=near_fars[0, 1], pad=self.args.pad)
        return pts, pts_ndc, z_vals, rays_d

    def _volume(self, batch):
        return self.mvsnet(batch["images"][:3], batch["proj_mats"][:3],
                           batch["near_fars"][0], pad=self.args.pad,
                           lindisp=self.args.use_disp)[0]

    @torch.no_grad()
    def mlp_input(self, batch, xs, ys, u):
        """The MLP's (N, S, 86) input for given draws at the current
        state (for the ReLU-kink checks of the parity tests)."""
        volume = self._volume(batch)
        pts, pts_ndc, _, rays_d = self._samples(batch, xs, ys, u)
        w2cs, intrinsics = batch["w2cs"], batch["intrinsics"]
        feats = gen_pts_feats(volume, pts_ndc, pts, w2cs[:3], intrinsics[:3],
                              unpreprocess_images(batch["images"][:3]))
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        return network_input(pts_ndc, gen_dir_feature(w2cs[0], unit), feats)

    def loss(self, batch, xs, ys, u, twins: bool = False):
        """The step's loss and its parts for given draws (JAX
        generalizable.py:100-170): (loss, {"img_mse", "depth_loss"}).
        `twins` runs the render's kernels' plain twins instead (K4, K5,
        K7), as in `FinetuneSystem`."""
        args = self.args
        w2cs, intrinsics = batch["w2cs"], batch["intrinsics"]
        volume = self._volume(batch)
        imgs = unpreprocess_images(batch["images"])
        tgt = len(imgs) - 1  # the target is the last view (utils.py:177)
        xi, yi = xs.long(), ys.long()
        target_rgb = imgs[tgt, yi, xi]
        pts, pts_ndc, z_vals, rays_d = self._samples(batch, xs, ys, u)
        out = render_rays(self.mlp, volume, pts, pts_ndc, z_vals, rays_d,
                          w2cs[0], w2cs[:3], intrinsics[:3], imgs[:3],
                          white_bkgd=args.white_bkgd, training=True,
                          twins=twins)

        img_loss = torch.mean((out["rgb"] - target_rgb) ** 2)
        loss, aux = img_loss, {"img_mse": img_loss}
        depths_h = batch.get("depths_h")
        if args.with_depth_loss and depths_h is not None:
            # indices clamped into the depth map, as JAX's gather does: the
            # loader's (1, 1) zero placeholder (no GT depth) then
            # supervises nothing
            dh, dw = depths_h.shape[1:]
            target_depth = depths_h[tgt, yi.clamp(max=dh - 1),
                                    xi.clamp(max=dw - 1)]
            mask = target_depth > 0
            dl = smooth_l1(out["depth"], target_depth) * 0.5  # 2**(1-2)
            depth_loss = torch.where(mask, dl, 0.0).sum() / \
                mask.sum().clamp_min(1)
            loss = loss + depth_loss
            aux["depth_loss"] = depth_loss
        return loss, aux

    def _step(self, batch, xs, ys, u, twins: bool = False):
        """One update for given draws: the loss, its gradients, Adam and a
        schedule tick. Returns (loss, aux) detached on the device (reading
        them synchronises)."""
        loss, aux = self.loss(batch, xs, ys, u, twins)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def fit(self, dataset, num_epochs=None, logger=None,
            ckpt_dir: str | None = None, seed: int = 0,
            max_steps: int | None = None, ckpt_every: int = 20000,
            val_fn=None, val_every: int = 0, log_every: int = 100):
        """Epochs over `dataset` in a per-epoch permutation (JAX
        generalizable.py:213-263). The draws of step k come from a
        generator on the device seeded from (seed, k). Every `log_every`
        steps the loss, the RGB MSE, its PSNR and the depth loss are
        logged; `val_fn(global_step)` runs every `val_every` steps and at
        each epoch end; snapshots every `ckpt_every` steps and at the end
        when `ckpt_dir` is given. Returns the step losses as floats."""
        args = self.args
        num_epochs = num_epochs or args.num_epochs
        n = len(dataset)
        if self.schedule_steps is None:
            self.schedule_steps = max(max_steps or num_epochs * n, 1)
            for group in self.optimizer.param_groups:
                group["lr"] = self._lr(self.scheduler.last_epoch)
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device)
        losses = []
        done = False
        for _ in range(num_epochs):
            for i in rng.permutation(n):
                batch = self.batch(dataset[int(i)])
                gen.manual_seed(seed * 2 ** 32 + self.global_step)
                loss, aux = self._step(batch, *self.draw(batch, gen))
                losses.append(loss)
                self.global_step += 1
                if logger is not None and self.global_step % log_every == 0:
                    mse = float(aux["img_mse"])
                    scalars = {"train/loss": float(loss),
                               "train/img_mse_loss": mse,
                               "train/PSNR": -10 * math.log10(max(mse,
                                                                  1e-10))}
                    if "depth_loss" in aux:
                        scalars["train/depth_loss"] = float(aux["depth_loss"])
                    logger.log_scalars(self.global_step, scalars)
                if ckpt_dir and self.global_step % ckpt_every == 0:
                    self.save(ckpt_dir)
                if val_fn is not None and val_every \
                        and self.global_step % val_every == 0:
                    val_fn(self.global_step)
                if max_steps and self.global_step >= max_steps:
                    done = True
                    break
            if val_fn is not None and not done:
                val_fn(self.global_step)      # per epoch, like the reference
            if done:
                break
        if ckpt_dir:
            self.save(ckpt_dir)
        return torch.stack(losses).cpu().tolist() if losses else []

    # ---------------------------------------------------------- validate ---

    @torch.no_grad()
    def render_view(self, sample, chunk: int = 8192):
        """Full-image render of the sample's target view from its 3 source
        views on the eval route (grid_sample fetch, the module's MLP), depths
        unjittered (train_mvs_nerf_pl.py:172-254). Returns numpy rgb
        (H, W, 3), depth (H, W) and the target image."""
        args = self.args
        n_samples = args.N_samples
        batch = self.batch(sample)
        imgs_norm, near_fars = batch["images"], batch["near_fars"]
        w2cs, intrinsics = batch["w2cs"], batch["intrinsics"]
        V, H, W, _ = imgs_norm.shape
        volume = self._volume(batch)
        imgs = unpreprocess_images(imgs_norm)
        tgt = V - 1
        xs, ys = full_image_pixels(H, W, self.device)
        rays_o, rays_d = rays_from_pixels(xs, ys, intrinsics[tgt],
                                          batch["c2ws"][tgt])
        inv_scale = torch.tensor([W - 1.0, H - 1.0], device=self.device)
        t = torch.linspace(0.0, 1.0, n_samples, device=self.device)
        z_row = near_fars[tgt, 0] * (1 - t) + near_fars[tgt, 1] * t

        def chunk_fn(rd):
            z_vals = z_row.expand(rd.shape[0], n_samples)
            pts = rays_o + z_vals[..., None] * rd[:, None]
            pts_ndc = get_ndc_coordinate(
                w2cs[0], intrinsics[0], pts, inv_scale, near=near_fars[0, 0],
                far=near_fars[0, 1], pad=args.pad)
            out = render_rays(self.mlp, volume, pts, pts_ndc, z_vals, rd,
                              w2cs[0], w2cs[:3], intrinsics[:3], imgs[:3],
                              white_bkgd=args.white_bkgd)
            return {"rgb": out["rgb"], "depth": out["depth"]}

        out = render_image_chunked(chunk_fn, (rays_d,), H * W, chunk)
        return {"rgb": out["rgb"].reshape(H, W, 3).cpu().numpy(),
                "depth": out["depth"].reshape(H, W).cpu().numpy(),
                "target": imgs[tgt].cpu().numpy()}

    # ------------------------------------------------------------- state ---

    def state(self):
        """Everything a resume needs: params, optimizer and scheduler state
        and the global step."""
        return {"params": {"mlp": self.mlp.state_dict(),
                           "mvsnet": self.mvsnet.state_dict()},
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "global_step": self.global_step}

    def save(self, ckpt_dir: str) -> str:
        return save_checkpoint(ckpt_dir, self.state(), self.global_step)

    def restore(self, ckpt_path_or_dir: str, strict: bool = False) -> int:
        """Load a snapshot, before or after the first step: a file path
        loads that file, a directory its newest `ckpt_*.pt`. Returns the
        restored global step; 0 when nothing was found (raises instead
        when `strict`)."""
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
        self.mlp.load_state_dict(state["params"]["mlp"])
        self.mvsnet.load_state_dict(state["params"]["mvsnet"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.global_step = int(state["global_step"])
        return self.global_step
