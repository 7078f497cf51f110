"""The no-finetune evaluator's compute: build the encoding volume once per
scene, then answer each novel-view request with a full-image render.

Counterpart of mvsnerf_tpu/eval/evaluate.py:48 `Evaluator`. `build_volume`
takes the arrays a dataset's `read_source_views` returns, so a
dataset-backed CLI can wrap it; the metrics and the dataset loop are not
part of this module.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device, set_precision_policy
from ..models.mvsnet import N_DEPTH_PLANES
from ..render.hybrid import make_hybrid_renderer
from ..render.renderer import make_chunked_renderer
from ..train.common import unpreprocess_images

RENDER_MODES = {"chunked": make_chunked_renderer,
                "hybrid": make_hybrid_renderer}


class Evaluator:
    """Generalizable (no-finetune) evaluator of one scene at a time.

    Args:
        mvsnet: `models.mvsnet.MVSNet`; mlp: the v0 `MVSNeRF`.
        n_samples: samples per ray; pad: cost-volume padding;
        n_planes: sweep planes (the reference's 128).
        white_bkgd: composite onto white (Blender scenes).
        chunk: rays per render chunk (both modes).
        device: where the scene's tensors live: CUDA unless the caller
            names the CPU; with no card it raises.
    """

    def __init__(self, mvsnet, mlp, n_samples: int = 128, pad: int = 24,
                 n_planes: int = N_DEPTH_PLANES, white_bkgd: bool = False,
                 chunk: int = 16384, device=None):
        set_precision_policy()
        self.mvsnet, self.mlp = mvsnet, mlp
        self.n_samples, self.pad, self.n_planes = n_samples, pad, n_planes
        self.white_bkgd, self.chunk = white_bkgd, chunk
        self.device = resolve_device(device)
        self.renderers = None

    def _tensor(self, a):
        if torch.is_tensor(a):
            return a.to(self.device, torch.float32)
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    @torch.no_grad()
    def build_volume(self, imgs, proj_mats, near_far, pose_source):
        """Build the scene's encoding volume and its renderers.

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
        imgs_norm = self._tensor(imgs)
        nf = self._tensor(near_far)
        volume, _ = self.mvsnet(imgs_norm, self._tensor(proj_mats), nf,
                                pad=self.pad, n_planes=self.n_planes)
        pose = {k: self._tensor(pose_source[k])
                for k in ("w2cs", "intrinsics")}
        imgs01 = unpreprocess_images(imgs_norm)
        self.renderers = {
            mode: make(self.mlp, volume, imgs01, nf, pose, self.n_samples,
                       self.pad, white_bkgd=self.white_bkgd,
                       chunk=self.chunk)
            for mode, make in RENDER_MODES.items()}
        return volume, imgs01, nf, pose

    @torch.no_grad()
    def render(self, rays, H: int, W: int, mode: str = "chunked"):
        """Render one full H x W view of the current scene.

        Args:
            rays: (H*W, 8) [origin, direction, near, far] ray buffer.
            mode: 'chunked' (K4 colours + plain fetch/MLP/compositing) or
                'hybrid' (K4 colours + the fused K6 kernel).
        Returns:
            dict rgb (H*W, 3), depth (H*W,), acc (H*W,).
        """
        if self.renderers is None:
            raise RuntimeError("render() before build_volume()")
        if mode not in RENDER_MODES:
            raise ValueError(f"unknown render mode {mode!r}")
        return self.renderers[mode](self._tensor(rays), H, W)
