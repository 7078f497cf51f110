"""The no-finetune evaluator: build a scene's encoding volume, answer each
novel-view request with a full-image render, and score a dataset's views.

Counterpart of mvsnerf_tpu/eval/evaluate.py:48 `Evaluator`. `build_volume`
takes the arrays a dataset's `read_source_views` returns; `render` serves
one view in the `chunked` (K4 colours, `grid_sample` fetch, K8), `hybrid`
(K4 colours into K6) or `tiled` (colours baked into the volume, K6b) mode;
`evaluate` loops over a dataset with the reference's protocol
(renderer.ipynb cells 4-18): optionally the 3 nearest training views as
each image's sources, PSNR / SSIM / LPIPS, Blender's 80 % centre crop,
DTU's depth mask with the depth metrics, and [gt | pred | depth] panels.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device, set_precision_policy
from ..models.mvsnet import N_DEPTH_PLANES
from ..render.hybrid import make_hybrid_renderer
from ..render.renderer import make_chunked_renderer
from ..render.tiled import make_tiled_renderer
from ..train.common import unpreprocess_images
from ..utils.profiling import trace_context
from ..utils.vis import panel, visualize_depth, write_png
from .metrics import abs_error, acc_threshold, psnr, ssim

RENDER_MODES = {"chunked": make_chunked_renderer,
                "hybrid": make_hybrid_renderer,
                "tiled": make_tiled_renderer}


def nearest_source_views(tgt_c2w, train_c2ws, n: int = 3):
    """Indices of the n training views whose camera centres are nearest
    the target's by L1 distance (renderer.ipynb cell 11's protocol, not the
    L2 of utils.py:698-711)."""
    d = np.sum(np.abs(np.asarray(train_c2ws)[:, :3, 3] -
                      np.asarray(tgt_c2w)[:3, 3]), axis=-1)
    return np.argsort(d)[:n]


class Evaluator:
    """Generalizable (no-finetune) evaluator of one scene at a time.

    Args:
        mvsnet: `models.mvsnet.MVSNet`; mlp: an `MVSNeRF` of any net type
            (`hybrid` and `tiled` take the v0 MLP at D=6, W=128 alone).
        n_samples: samples per ray; pad: cost-volume padding;
        n_planes: sweep planes (the reference's 128).
        white_bkgd: composite onto white (Blender scenes).
        chunk: rays per render chunk (every mode).
        costreg_impl: the route of the volume build's U-Net (a
            `--costreg_impl` value: "auto" for the K10 kernels on a card
            and cuDNN elsewhere, "dband" for K10, "plain" for
            cuDNN); None keeps the one `mvsnet` was built with.
        device: where the scene's tensors live: CUDA unless the caller
            names the CPU; with no card it raises.
        lindisp: sweep planes, ray samples and NDC depth linear in
            disparity (`--use_disp`, JAX evaluate.py:66, 100, 104), in
            every mode.
    """

    def __init__(self, mvsnet, mlp, n_samples: int = 128, pad: int = 24,
                 n_planes: int = N_DEPTH_PLANES, white_bkgd: bool = False,
                 chunk: int = 16384, device=None,
                 costreg_impl: str | None = None, lindisp: bool = False):
        set_precision_policy()
        self.mvsnet, self.mlp = mvsnet, mlp
        self.costreg_impl, self.lindisp = costreg_impl, lindisp
        self.n_samples, self.pad, self.n_planes = n_samples, pad, n_planes
        self.white_bkgd, self.chunk = white_bkgd, chunk
        self.device = resolve_device(device)
        self.scene = None
        self.renderers = {}

    def _tensor(self, a):
        with trace_context("upload"):
            if torch.is_tensor(a):
                return a.to(self.device, torch.float32)
            return torch.tensor(np.asarray(a, np.float32),
                                device=self.device)

    @torch.no_grad()
    def build_volume(self, imgs, proj_mats, near_far, pose_source):
        """Build the scene's encoding volume; its renderers are made at
        their mode's first request (the `tiled` one bakes the colours
        then).

        Args:
            imgs: (V, H, W, 3) ImageNet-normalised source views, view 0 =
                reference.
            proj_mats: (V, 3, 4) stride-4 projections relative to view 0.
            near_far: (2,) reference depth range.
            pose_source: dict with (V, 4, 4) `w2cs` and (V, 3, 3)
                image-scale `intrinsics`.
        Returns:
            volume (D, hp, wp, 8), imgs in [0, 1], near_far (2,),
            pose_source, all tensors on the evaluator's device.
        """
        with trace_context("eval.volume"):
            imgs_norm = self._tensor(imgs)
            nf = self._tensor(near_far)
            volume, _ = self.mvsnet(imgs_norm, self._tensor(proj_mats), nf,
                                    pad=self.pad, n_planes=self.n_planes,
                                    lindisp=self.lindisp,
                                    costreg_impl=self.costreg_impl)
            pose = {k: self._tensor(pose_source[k])
                    for k in ("w2cs", "intrinsics")}
            self.scene = (volume, unpreprocess_images(imgs_norm), nf, pose)
            self.renderers = {}
        return self.scene

    def renderer(self, mode: str):
        """The current scene's fn(rays, H, W) for `mode`, made once."""
        if self.scene is None:
            raise RuntimeError("render() before build_volume()")
        if mode not in RENDER_MODES:
            raise ValueError(f"unknown render mode {mode!r}")
        if mode not in self.renderers:
            self.renderers[mode] = RENDER_MODES[mode](
                self.mlp, *self.scene, self.n_samples, self.pad,
                white_bkgd=self.white_bkgd, chunk=self.chunk,
                lindisp=self.lindisp)
        return self.renderers[mode]

    @torch.no_grad()
    def render(self, rays, H: int, W: int, mode: str = "chunked"):
        """Render one full H x W view of the current scene.

        Args:
            rays: (H*W, 8) [origin, direction, near, far] ray buffer.
            mode: 'chunked', 'hybrid' or 'tiled' (module docstring).
        Returns:
            dict rgb (H*W, 3), depth (H*W,), acc (H*W,).
        """
        with trace_context("eval.render"):
            return self.renderer(mode)(self._tensor(rays), H, W)

    def _score(self, pred, gt, depth, sample, lpips_fn, center_crop):
        """One image's metrics (evaluate.py:189-219)."""
        row = {}
        if center_crop:  # Blender: the central 80 % (renderer.ipynb c. 11)
            hc, wc = gt.shape[0] // 10, gt.shape[1] // 10
            pred, gt = pred[hc:-hc, wc:-wc], gt[hc:-hc, wc:-wc]
            row["psnr"] = float(psnr(pred, gt))
        elif "depth" in sample:  # DTU: GT depth 0 is background (cell 16)
            gt_depth = np.asarray(sample["depth"])
            mask = gt_depth > 0
            row["psnr"] = float(psnr(pred, gt, mask))
            row["abs_err"] = float(abs_error(depth, gt_depth, mask).sum()
                                   / mask.sum())
            for t in (0.01, 0.05, 0.1):
                row[f"acc_{t}"] = float(acc_threshold(depth, gt_depth, mask,
                                                      t))
        else:
            row["psnr"] = float(psnr(pred, gt))
        row["ssim"] = float(ssim(pred, gt))
        if lpips_fn is not None:
            row["lpips"] = float(lpips_fn(pred * 2 - 1, gt * 2 - 1))
        return row

    def evaluate(self, dataset, mode: str = "chunked", lpips_fn=None,
                 save_dir: str | None = None,
                 per_image_sources: bool = False, train_c2ws=None,
                 train_indices=None, val_c2ws=None,
                 center_crop: bool = False):
        """Score the dataset's views (evaluate.py:130-231).

        Args:
            dataset: `read_source_views(pair_idx=None)`, `len()`, items
                with `rays` (H*W, 8), `rgbs` (H, W, 3) and optionally GT
                `depth` (H, W); `poses` when `per_image_sources` has no
                `val_c2ws`.
            mode: the render mode of every image.
            per_image_sources: rebuild the volume for each image from the
                3 training views nearest it (`train_c2ws`, with dataset
                view ids `train_indices`); else the dataset's default
                sources for all.
            val_c2ws: the target poses (default `dataset.poses`).
            center_crop: Blender's 80 % crop before the metrics.
            save_dir: where to write each image's [gt | pred | depth]
                panel as a PNG.
        Returns:
            {"per_image": [metrics dict per image], "mean": {...}}.
        """
        if not per_image_sources:
            self.build_volume(*dataset.read_source_views())
        results = []
        for i in range(len(dataset)):
            sample = dataset[i]
            if per_image_sources:
                tgt = val_c2ws[i] if val_c2ws is not None else \
                    dataset.poses[i]
                sel = nearest_source_views(tgt, train_c2ws, 3)
                self.build_volume(*dataset.read_source_views(
                    pair_idx=np.asarray(train_indices)[sel]))
            gt = np.asarray(sample["rgbs"], np.float32)
            h, w = gt.shape[:2]
            out = self.render(sample["rays"], h, w, mode)
            pred = out["rgb"].clamp(0, 1).reshape(h, w, 3).cpu().numpy()
            depth = out["depth"].reshape(h, w).cpu().numpy()
            results.append(self._score(pred, gt, depth, sample, lpips_fn,
                                       center_crop))
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                dvis, _ = visualize_depth(
                    depth, tuple(self.scene[2].cpu().numpy()))
                write_png(os.path.join(save_dir, f"{i:03d}.png"),
                          panel([gt, pred, dvis]))
        mean = {k: float(np.mean([r[k] for r in results]))
                for k in results[0]}
        return {"per_image": results, "mean": mean}
