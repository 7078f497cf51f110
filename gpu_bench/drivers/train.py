"""Generalizable training across scenes: `GeneralizableSystem.fit` over a
dataset held in memory, in consecutive `max_steps` segments, with no
logger. A sample is what the program's `dtu` loader yields (3 source
views and the target, 640x512, ImageNet-normalised, with their cameras,
near/far and depth maps), made from the seed on the rig of the program's
synthetic DTU scan.

Set-up builds the system from the seeded checkpoint, fixes its cosine
schedule's length as a `fit` over `num_epochs` of the dataset would, and
drives it through its first three steps with `fit` (one step, whose Adam
state gives the first gradient, then two). The check recomputes them in
the plain reference: each step's loss, each leaf's first gradient norm
and each leaf's change after the three, over MVSNet and the MLP.

Traffic parameters: `samples` (the dataset's size), `segment_steps`,
`flags`, `limits`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import core, scenes
from .base import BaseDriver

BETA1 = 0.9


def _unchanged_state(monkeypatch):
    """A fault: a step that computes its loss and update, then leaves the
    parameters as they were."""
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    orig = GeneralizableSystem._step

    def step(self, *a, **kw):
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        out = orig(self, *a, **kw)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out

    monkeypatch.setattr(GeneralizableSystem, "_step", step)


def _half_batch(monkeypatch):
    """A fault: half of the batch left out, the loss the mean over the
    rest."""
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    orig = GeneralizableSystem._step

    def step(self, *a, **kw):
        batch, xs, ys, u = a[:4]
        n = len(xs) // 2
        return orig(self, batch, xs[:n], ys[:n], u[:n], *a[4:], **kw)

    monkeypatch.setattr(GeneralizableSystem, "_step", step)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch}


class Driver(BaseDriver):

    def fit_seed(self, k: int) -> int:
        return core.seeds(self.seeds[4] + k, 1)[0]

    def setup(self, spans):
        from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem

        self.mark("program imports")
        cfg, dev = self.cfg, self.device
        args = self.program_args(["--dataset_name", "dtu"])
        self.args = args
        self.batch, self.S = args.batch_size, args.N_samples
        self.dataset = self.make_dataset()
        self.mark("dataset")
        self.system = GeneralizableSystem(args, device=dev)
        self.mark("program")
        self.drop_ckpt()
        sy = self.system
        sy.schedule_steps = args.num_epochs * len(self.dataset)

        leaves = dict(sy.mlp.named_parameters())
        leaves.update({f"{k}": v for k, v in sy.mvsnet.named_parameters()})
        theta0 = {k: v.detach().clone() for k, v in leaves.items()}
        self.plan = [(1, self.fit_seed(0)), (3, self.fit_seed(1))]
        losses, grads = [], None
        for stop, seed in self.plan:
            losses += sy.fit(self.dataset, num_epochs=1, max_steps=stop,
                             seed=seed)
            if grads is None:
                grads = {k: float(sy.optimizer.state[p]["exp_avg"].norm())
                         / (1 - BETA1) for k, p in leaves.items()}
        delta = {k: (p.detach() - theta0[k]).cpu() for k, p in leaves.items()}
        self.mark("first steps")
        self.prog = {"losses": losses, "grads": grads, "delta": delta,
                     "change": {k: float(v.norm()) for k, v in delta.items()}}
        del theta0

    def make_dataset(self):
        """`samples` dicts in the `dtu` loader's format: a seeded target
        view of the 49, 3 of its 5 nearest cameras as sources, images and
        depth maps from the seed."""
        cfg, dev = self.cfg, self.device
        W, H = cfg["img_wh"]
        rig = scenes.DTURig((W, H))
        rng = np.random.default_rng(self.seeds[1])
        n = self.mix["samples"]
        imgs = scenes.images(4 * n, H, W, self.seeds[1], dev)
        gen = torch.Generator(device=dev).manual_seed(self.seeds[1] + 1)
        out = []
        for i in range(n):
            tgt = int(rng.integers(rig.N_VIEWS))
            near = np.argsort(np.abs(np.arange(rig.N_VIEWS) - tgt),
                              kind="stable")[1:6]
            ids = [int(v) for v in rng.permutation(near)[:3]] + [tgt]
            depths = 3.5 + 0.1 * (torch.rand((4, H, W), generator=gen,
                                             device=dev) * 2 - 1)
            out.append({
                "images": scenes.normalize(imgs[4 * i:4 * i + 4]),
                "depths_h": depths.cpu().numpy(),
                "w2cs": rig.w2cs[ids], "c2ws": rig.c2ws[ids],
                "near_fars": np.tile(np.float32(rig.near_far), (4, 1)),
                "proj_mats": scenes.relative_projections(rig.k_s4[ids],
                                                         rig.w2cs[ids]),
                "intrinsics": rig.k[ids]})
        return out

    def window(self, seconds, spans):
        seg, losses, k = self.mix["segment_steps"], [], 2
        sy = self.system
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with spans("segment"):
                losses += sy.fit(self.dataset, num_epochs=10 ** 6,
                                 max_steps=sy.global_step + seg,
                                 seed=self.fit_seed(k))
            k += 1
        failed = int(np.sum(~np.isfinite(losses)))
        return {"attempted": len(losses), "failed": failed,
                "steps": len(losses),
                "mlp_samples": len(losses) * self.batch * self.S}

    def end_to_end(self, stats, window_s):
        return {"train_step_ms": 1e3 * window_s / stats["steps"]}

    def work_flops(self, stats):
        from ..costs import mvsnet
        cfg = self.cfg
        return stats["steps"] * (
            mvsnet.train_flops(3, cfg["img_wh"][::-1], cfg["planes"],
                               cfg["pad"])
            + self.mlp_costs.train_flops(self.batch * self.S))

    def release(self):
        self.system = None

    # ------------------------------------------------------------ check ---

    def program_outputs(self):
        return self.prog

    def reference(self, tf32: bool, half: bool = False):
        """The three steps in the plain reference, each sample and draw as
        the program's `fit` takes them (`default_rng(seed).permutation` of
        the samples; from a generator on the device seeded seed * 2**32 +
        step: the pixels' x, then y, then the depth jitter), the cosine
        schedule of the program's length, Adam over MVSNet and the MLP.
        `half` is a fault: the loss of the first half of the batch."""
        ref, dev, cfg, B, S = self.ref, self.device, self.cfg, self.batch, \
            self.S
        W, H = cfg["img_wh"]
        steps = self.args.num_epochs * len(self.dataset)
        lrate = self.args.lrate
        with self.precision(tf32):
            leaves = {k: v.detach().clone().requires_grad_()
                      for k, v in self.params.items() if ref.trainable(k)}
            init = {k: v.detach().clone() for k, v in leaves.items()}
            opt = torch.optim.Adam(list(leaves.values()), lr=lrate,
                                   betas=(BETA1, 0.999), foreach=False)
            p = dict(self.params, **leaves)
            losses, grads, step = [], None, 0
            for stop, seed in self.plan:
                order = np.random.default_rng(seed).permutation(
                    len(self.dataset))
                for j in range(stop - step):
                    smp = {k: torch.as_tensor(np.asarray(v, np.float32),
                                              device=dev)
                           for k, v in self.dataset[int(order[j])].items()}
                    gen = torch.Generator(device=dev).manual_seed(
                        seed * 2 ** 32 + step)
                    xs = torch.randint(0, W, (B,), generator=gen,
                                       device=dev).float()
                    ys = torch.randint(0, H, (B,), generator=gen,
                                       device=dev).float()
                    u = torch.rand((B, S), generator=gen, device=dev)
                    loss = self._loss(p, smp, xs, ys, u, half)
                    for g in opt.param_groups:
                        g["lr"] = ref.cosine_lr(lrate, step, steps)
                    opt.zero_grad()
                    loss.backward()
                    if grads is None:
                        grad1 = {k: v.grad.detach().cpu()
                                 for k, v in leaves.items()}
                        grads = {k: float(v.norm()) for k, v in grad1.items()}
                    opt.step()
                    losses.append(float(loss.detach()))
                    step += 1
            delta = {k: (v.detach() - init[k]).cpu()
                     for k, v in leaves.items()}
        return {"losses": losses, "grads": grads, "grad1": grad1,
                "delta": delta,
                "change": {k: float(v.norm()) for k, v in delta.items()}}

    def _loss(self, p, smp, xs, ys, u, half):
        ref, cfg = self.ref, self.cfg
        imgs_n, k, c2w = smp["images"], smp["intrinsics"], smp["c2ws"]
        volume = ref.encoding_volume(p, imgs_n[:3], smp["proj_mats"][:3],
                                     smp["near_fars"][0], cfg["pad"],
                                     cfg["planes"])
        imgs = ref.unpreprocess(imgs_n)
        target = imgs[3, ys.long(), xs.long()]
        dirs = torch.stack([(xs - k[3, 0, 2]) / k[3, 0, 0],
                            (ys - k[3, 1, 2]) / k[3, 1, 1],
                            torch.ones_like(xs)], -1) @ c2w[3, :3, :3].T
        nf = smp["near_fars"][3].expand(len(xs), 2)
        rays = torch.cat([c2w[3, :3, 3].expand(len(xs), 3), dirs, nf], -1)
        scene = {"imgs": imgs[:3], "w2cs": smp["w2cs"][:3],
                 "intrinsics": k[:3], "near_far": smp["near_fars"][0],
                 "pad": cfg["pad"]}
        out = ref.render_rays(p, volume, rays, scene, u)
        m = len(xs) // 2 if half else len(xs)
        return ref.mse(out["rgb"][:m], target[:m])

    def readings(self, got, want):
        loss = max(abs(a - b) / b for a, b in zip(got["losses"],
                                                  want["losses"]))
        leaves = core.moved(want["grads"])
        return {"loss_gap": loss,
                "grad_gap": core.norm_gap(got["grads"], want["grads"],
                                          leaves),
                "change_gap": core.norm_gap(got["change"], want["change"],
                                            leaves)}

    def leaf_detail(self):
        """A look at the check's worst leaves: the five worst of the first
        gradient and of the change (program, reference norms), the gap of
        the change's norm over all leaves together, and, in the leaf whose
        change is worst, its four elements whose change differs most: each
        difference over the learning rate (Adam moves an element by about
        the learning rate a step, whatever its gradient's size) and their
        first gradient over the leaf's median element's, with their share
        of the leaf's squared difference."""
        want = self._ref32
        leaves = core.moved(want["grads"])
        worst = core.leaf_gaps(self.prog["change"], want["change"],
                               leaves, 1)[0][0]
        diff = (self.prog["delta"][worst] - want["delta"][worst]).flatten()
        g1 = want["grad1"][worst].abs().flatten()
        top = diff.abs().argsort(descending=True)[:4]
        return {k: core.leaf_gaps(self.prog[k], want[k], leaves)
                for k in ("grads", "change")} | {
            "left_out": sorted(set(want["grads"]) - leaves),
            "change_total": core.total_gap(self.prog["change"],
                                           want["change"], leaves),
            "worst_leaf": {
                "name": worst, "elements": diff.numel(),
                "top_diff_over_lr": (diff[top] / self.args.lrate).tolist(),
                "top_g1_over_median": (g1[top] / g1.median()).tolist(),
                "top_share": float((diff[top] ** 2).sum()
                                   / (diff ** 2).sum().clamp_min(1e-30))}}

    def fault_readings(self):
        still = dict(self._ref32, change={k: 0.0 for k in
                                          self._ref32["change"]})
        return {"half_batch": self.readings(
                    self.reference(tf32=False, half=True), self._ref32),
                "unchanged_state": self.readings(still, self._ref32)}
