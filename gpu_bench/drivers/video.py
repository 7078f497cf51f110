"""A free-viewpoint video after fine-tuning: `eval/video.render_video`
over a `FinetuneSystem` (its volume built once by MVSNet in set-up from
three seeded source views), frame after frame along a spiral path, as the
program's `render_video` CLI calls it (its chunk, a depth panel beside
each frame, nothing written: `out_path=None`).

Traffic parameters: `frames` (poses on the path), `radii` and
`focus_depth` of the spiral, `near_far` of the rays (the CLI's for LLFF),
`check_frames`, `flags`, `limits`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import scenes
from .base import BaseDriver


class SourceViews:
    def __init__(self, source_views):
        self._src = source_views

    def read_source_views(self):
        return self._src


class Driver(BaseDriver):

    def setup(self, spans):
        from mvsnerf_tpu_torch.eval.video import render_video
        from mvsnerf_tpu_torch.train.finetune import FinetuneSystem

        self.mark("program imports")
        cfg, mix, dev = self.cfg, self.mix, self.device
        args = self.program_args(["--dataset_name", "llff"])
        self.W, self.H = cfg["img_wh"]
        rig = scenes.LLFFRig(tuple(cfg["img_wh"]), cfg["views"],
                             seed=self.seeds[1])
        ids = cfg["train_views"][:3]
        full = np.zeros((cfg["views"], self.H, self.W, 3), np.float32)
        full[ids] = scenes.images(3, self.H, self.W, self.seeds[1], dev)
        self.src = rig.source_views(full, ids)
        self.system = FinetuneSystem(args, SourceViews(self.src), device=dev)
        self.drop_ckpt()
        self.mark("program")
        self.focal = rig.focal
        self.path = scenes.spiral_path(np.asarray(mix["radii"]),
                                       mix["focus_depth"], mix["frames"])
        # each seed renders the same path from its own first frame
        self.first = int(np.random.default_rng(self.seeds[2]).integers(
            len(self.path)))
        self.chunk = args.chunk * 8  # the render_video CLI's
        self.render_video = render_video
        # keep each frame's float rgb and depth as the timed path made
        # them, for the check
        self.outs = []
        render = self.system.render_image

        def kept(rays, chunk=8192):
            out = render(rays, chunk=chunk)
            self.outs.append((out["rgb"].cpu().numpy(),
                              out["depth"].cpu().numpy()))
            return out

        self.system.render_image = kept
        self.frame(0, spans)  # warm-up
        self.outs, self.poses_done = [], []

    def frame(self, k, spans):
        pose = self.path[(self.first + k) % len(self.path)]
        with spans("frame"):
            frames = self.render_video(
                self.system, pose[None], self.H, self.W, self.focal,
                self.mix["near_far"], out_path=None, chunk=self.chunk,
                with_depth_panel=True)
        return pose, frames[0]

    def window(self, seconds, spans):
        t0 = time.perf_counter()
        k, failed = 0, 0
        while time.perf_counter() - t0 < seconds:
            pose, _ = self.frame(k, spans)
            rgb, depth = self.outs[-1]
            if not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
                failed += 1
            self.poses_done.append(pose)
            k += 1
        return {"attempted": k, "failed": failed, "frames": k,
                "rendered_rays": k * self.W * self.H}

    def end_to_end(self, stats, window_s):
        return {"video_frames_per_s": stats["frames"] / window_s}

    def work_flops(self, stats):
        from ..costs import mlp_v0
        return stats["frames"] * mlp_v0.render_flops(
            self.W * self.H * self.cfg["samples_per_ray"])

    def release(self):
        self.volume = self.system.volume.detach().cpu()
        self.system = None

    # ------------------------------------------------------------ check ---

    def program_outputs(self):
        self.picked = self.sample(len(self.poses_done),
                                  self.mix["check_frames"])
        return {"images": [self.outs[j] for j in self.picked],
                "volume": self.volume}

    def reference(self, tf32: bool):
        """The picked frames in the plain reference, over its own volume,
        with the program's depth jitter: `render_image` draws each chunk's
        uniforms in turn from a generator on the device seeded 0."""
        ref, dev, cfg = self.ref, self.device, self.cfg
        imgs, proj, nf = (torch.as_tensor(np.asarray(a, np.float32),
                                          device=dev) for a in self.src[:3])
        pose = {k: torch.as_tensor(v, device=dev)
                for k, v in self.src[3].items()}
        S = cfg["samples_per_ray"]
        scene = {"imgs": ref.unpreprocess(imgs), "w2cs": pose["w2cs"],
                 "intrinsics": pose["intrinsics"], "near_far": nf,
                 "pad": cfg["pad"]}
        out = {"images": []}
        with self.precision(tf32), torch.no_grad():
            volume = ref.encoding_volume(self.params, imgs, proj, nf,
                                         cfg["pad"], cfg["planes"])
            out["volume"] = volume.cpu()
            for j in self.picked:
                rays = torch.as_tensor(scenes.rays_for_pose(
                    self.H, self.W, self.focal, [self.W / 2, self.H / 2],
                    self.poses_done[j], *self.mix["near_far"]), device=dev)
                gen = torch.Generator(device=dev).manual_seed(0)
                o = ref.render_image(
                    self.params, volume, rays, scene, block=self.chunk,
                    u_fn=lambda n: torch.rand((n, S), generator=gen,
                                              device=dev))
                out["images"].append((o["rgb"].cpu().numpy(),
                                      o["depth"].cpu().numpy()))
        return out

    def readings(self, got, want):
        near, far = self.mix["near_far"]
        rgb = max(float(np.abs(g[0] - w[0]).max())
                  for g, w in zip(got["images"], want["images"]))
        depth = max(float(np.abs(g[1] - w[1]).max())
                    for g, w in zip(got["images"], want["images"]))
        vol = float((got["volume"] - want["volume"]).abs().max() /
                    want["volume"].abs().max())
        return {"rgb_gap": rgb, "depth_gap": depth / (far - near),
                "volume_gap": vol}
