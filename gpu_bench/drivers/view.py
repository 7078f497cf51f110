"""Novel views without fine-tuning: one client in a closed loop, each
request the evaluation protocol of the generalizable model (the program's
`evaluate` CLI, nearest-3 mode): a test pose of one of several scenes,
with its 3 nearest training views and its rays on the host as the
program's loaders hand them over (the CLI's dataset makes every test
view's rays when it loads); the encoding volume built from the sources
(`Evaluator.build_volume`, which uploads them), the full image rendered
(`Evaluator.render` in the CLI's mode and chunk, which uploads the rays)
and brought to the host.

Traffic parameters: `scenes` (how many seeded scenes), `check_requests`
(how many of the window's requests the reference recomputes), `flags`
(the program's flags beyond its defaults), `limits`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import core, scenes
from .base import BaseDriver


class Driver(BaseDriver):

    def setup(self, spans):
        from mvsnerf_tpu_torch.data.dtu_ft import rays_for_pose
        from mvsnerf_tpu_torch.eval.evaluate import Evaluator, \
            nearest_source_views
        from mvsnerf_tpu_torch.train.finetune import reference_modules

        self.mark("program imports")
        cfg, dev = self.cfg, self.device
        args = self.program_args(["--dataset_name", "dtu_ft"])
        mlp, mvsnet, _ = reference_modules(args, dev)
        self.drop_ckpt()
        # the evaluate CLI's evaluator
        self.ev = Evaluator(mvsnet, mlp, n_samples=args.N_samples,
                            pad=args.pad, white_bkgd=args.white_bkgd,
                            chunk=args.chunk * 5, device=dev,
                            lindisp=args.use_disp)
        self.mark("program")
        rig = scenes.DTURig(tuple(cfg["img_wh"]))
        self.W, self.H = cfg["img_wh"]
        train = np.asarray(cfg["train_views"])
        n_scenes = self.mix["scenes"]
        imgs = scenes.images(n_scenes * len(train), self.H, self.W,
                             self.seeds[1], dev).reshape(
                                 n_scenes, len(train), self.H, self.W, 3)
        full = np.zeros((rig.N_VIEWS, self.H, self.W, 3), np.float32)
        # every (scene, test view): its sources and its rays as the
        # program's loaders hand them over (host arrays), and its view id
        self.rig, self.requests = rig, []
        for s in range(n_scenes):
            full[train] = imgs[s]
            for t in cfg["test_views"]:
                sel = nearest_source_views(rig.c2ws[t], rig.c2ws[train], 3)
                k = rig.k[t]
                rays = rays_for_pose(self.H, self.W, [k[0, 0], k[1, 1]],
                                     [k[0, 2], k[1, 2]], rig.c2ws[t],
                                     *rig.near_far)
                self.requests.append((rig.source_views(full, train[sel]),
                                      rays, int(t)))
        # every seed sends the same requests, each equally often, in its
        # own order
        rng = np.random.default_rng(self.seeds[2])
        self.order = np.concatenate([rng.permutation(len(self.requests))
                                     for _ in range(256)])
        self.mark("scenes")
        self.mode = args.render_mode
        for i in range(2):  # warm-up: every kernel built and loaded
            self.request(self.order[i], core.Spans(False))
        self.done = []

    def request(self, i, spans):
        """One request as the evaluate CLI serves it: the sources and the
        rays uploaded by the evaluator, the image brought back."""
        src, rays, _ = self.requests[i]
        with spans("build_volume"):
            self.ev.build_volume(*src)
        with spans("render"):
            out = self.ev.render(rays, self.H, self.W, self.mode)
        return out["rgb"].cpu().numpy(), out["depth"].cpu().numpy()

    def window(self, seconds, spans):
        lat, failed = [], 0
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            with spans("request"):
                rgb, depth = self.request(self.order[k], spans)
            lat.append(time.perf_counter() - t)
            if not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
                failed += 1
            self.done.append((int(self.order[k]), rgb, depth))
            k += 1
        return {"attempted": k, "failed": failed, "latency_s": lat,
                "requests": k, "rendered_rays": k * self.W * self.H}

    def end_to_end(self, stats, window_s):
        return {"view_p90_ms": 1e3 * float(np.percentile(stats["latency_s"],
                                                          90))}

    def work_flops(self, stats):
        from ..costs import mlp_v0, mvsnet
        cfg = self.cfg
        per = mvsnet.forward_flops(3, cfg["img_wh"][::-1], cfg["planes"],
                                   cfg["pad"]) + mlp_v0.render_flops(
            self.W * self.H * cfg["samples_per_ray"])
        return stats["requests"] * per

    def release(self):
        # the last request's volume is an output the check compares
        self.last_volume = self.ev.scene[0].cpu()
        self.ev = None

    # ------------------------------------------------------------ check ---

    def program_outputs(self):
        self.picked = self.sample(len(self.done), self.mix["check_requests"])
        return {"images": [self.done[j][1:] for j in self.picked],
                "volume": self.last_volume}

    def reference(self, tf32: bool):
        ref, p, dev = self.ref, self.params, self.device
        out = {"images": []}
        with self.precision(tf32), torch.no_grad():
            for j in self.picked:
                src, _, t = self.requests[self.done[j][0]]
                imgs, proj, nf = (torch.as_tensor(np.asarray(a, np.float32),
                                                  device=dev)
                                  for a in src[:3])
                pose = {k: torch.as_tensor(v, device=dev)
                        for k, v in src[3].items()}
                rays = torch.as_tensor(self.rig.rays(t), device=dev)
                volume = ref.encoding_volume(p, imgs, proj, nf,
                                             self.cfg["pad"],
                                             self.cfg["planes"])
                scene = {"imgs": ref.unpreprocess(imgs), "w2cs": pose["w2cs"],
                         "intrinsics": pose["intrinsics"], "near_far": nf,
                         "pad": self.cfg["pad"],
                         "n_samples": self.cfg["samples_per_ray"]}
                o = ref.render_image(p, volume, rays, scene)
                out["images"].append((o["rgb"].cpu().numpy(),
                                      o["depth"].cpu().numpy()))
                if j == len(self.done) - 1:
                    out["volume"] = volume.cpu()
        return out

    def readings(self, got, want):
        near, far = self.cfg["near_far"]
        rgb = max(float(np.abs(g[0] - w[0]).max())
                  for g, w in zip(got["images"], want["images"]))
        depth = max(float(np.abs(g[1] - w[1]).max())
                    for g, w in zip(got["images"], want["images"]))
        vol = float((got["volume"] - want["volume"]).abs().max() /
                    want["volume"].abs().max())
        return {"rgb_gap": rgb, "depth_gap": depth / (far - near),
                "volume_gap": vol}
