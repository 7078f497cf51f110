#!/usr/bin/env python3
"""Smoke run of the mvsnerf_tpu_torch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's no-finetune inference path at DTU scale on a synthetic
3-view 640x512 scene made from a seed, with seeded random weights:

  1. device: the card's name and power limit (nvidia-smi); exits non-zero
     when torch sees no CUDA device;
  2. build: compiles the hand-written kernels under
     mvsnerf_tpu_torch/csrc/ (nvcc, sm_90a) and prints ptxas's register
     report;
  3. kernels: K1 (sweep), K4 (colour warp) and K6 (fused render) against
     their plain PyTorch twins on the path's own inputs, at the path's
     shapes (a 41x128x176x208 cost volume, 16384 rays x 128 samples),
     with max abs error and CUDA-event times of kernel and twin;
  4. slice: `Evaluator.build_volume` -> a (128, 176, 208, 8) volume, then
     3 full 640x512 requests at 128 samples, each rendered in 'chunked'
     and 'hybrid' mode; checks finiteness, hybrid vs chunked rgb, and that
     every kernel ran in this phase (launch counters reset just before);
  5. small-input parity: the same evaluator on a 64x96 toy scene on the
     card and on the CPU (whose wrappers run the plain twins);
  6. fine-tune: `FinetuneSystem` from a reference-format checkpoint of the
     same seeded weights, on an in-memory scene of the same rig with 16
     random 640x512 training views (5.2M rays, no files), volume
     (128, 176, 208, 8), batch 1024, 128 samples, perturb 1.0:
     (a) K5 (volume gather / splat) and K7 (v0 MLP forward / backward)
     against their plain twins at the step's own shapes; (b) one step on
     the kernels and one on the twins from the same state; (c) 36 steps of
     `fit` (launch counters reset just before), timed over the last 30;
     (d) `torch.profiler` over 3 steps: device time by kernel group.

A failed comparison is reported and the remaining phases still run; the
script then exits non-zero without the result lines. Other errors raise.
On success the last two lines are one JSON object of per-kernel results
and `{"ok": true, "device": {...}}`.
"""

import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
H, W, PAD, N_PLANES, N_SAMPLES = 512, 640, 24, 128, 128
NEAR_FAR = (2.125, 4.525)
FOCAL = 722.0
CHUNK = 16384
TOL_K1, TOL_K4, TOL_K6, TOL_MODES = 1e-5, 1e-6, 1e-4, 1e-3
# K5 forward and backward, K7 forward: x (1 + max|plain|). The splat's
# atomics and the MLP's sums run in other orders than the twins'.
TOL_K5, TOL_K7 = 1e-5, 1e-5
# K7 backward: dW sums 131,072 samples and d feats differences of large
# terms (d bias sums six products, d feats 128 more), each in another order
# than the twin's. Both are held to a float64 run of the twin on the same
# inputs: |kernel - twin| <= TOL_K7_BWD x max(|twin - float64|, 1e-6 x
# max|float64|).
TOL_K7_BWD = 5.0
# one fine-tune step, kernels vs twins: gradients x max|g|; updates x lr
# (Adam's first step moves a value by about lr); ReLU-kink margin
TOL_STEP_GRAD, STEP_TOL, KINK = 1e-4, 0.02, 5e-6
FT_BATCH, FT_VIEWS, FT_WARM, FT_TIMED = 1024, 16, 6, 30


def require(cond, msg):
    """A failure that makes the later phases meaningless: stop now."""
    if not cond:
        raise RuntimeError(msg)


def check(cond, msg, failures):
    """A failed comparison: record it, run the remaining phases, and fail
    at the end."""
    if not cond:
        print(f"FAIL: {msg}")
        failures.append(msg)


def pose(i, da=0.0, dt=0.0):
    """World-to-camera of view i of the bench geometry (bench.py:208-234),
    optionally turned by `da` rad and shifted by `dt` along x."""
    a = 0.04 * (i - 1) + da
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                 [-math.sin(a), 0, math.cos(a)]]
    m[:3, 3] = [0.3 * (i - 1) + dt, 0.0, 0.0]
    return m


def make_scene(rng, h=H, w=W, focal=FOCAL):
    """3 views of random images with the bench's camera rig: normalised
    images, relative stride-4 projections, w2cs and intrinsics."""
    imgs = rng.uniform(0, 1, (3, h, w, 3)).astype(np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                    np.float32)
    intr_s4 = intr.copy()
    intr_s4[:2] /= 4
    w2cs = np.stack([pose(i) for i in range(3)])
    p4 = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    p4[:, :3] = intr_s4 @ w2cs[:, :3]
    projs = (p4 @ np.linalg.inv(p4[0]))[:, :3].astype(np.float32)
    return ((imgs - mean) / std, projs,
            {"w2cs": w2cs, "intrinsics": np.stack([intr] * 3)})


def seeded_init_(module, gen):
    """Re-draw every parameter from `gen`: weights uniform in
    +-1/sqrt(fan_in), biases N(0, 0.05), ABN scales U(0.5, 1.5)."""
    import torch
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                b = 1.0 / math.sqrt(p[0].numel())
                v = (torch.rand(p.shape, generator=gen) * 2 - 1) * b
            elif name.endswith("bias"):
                v = torch.randn(p.shape, generator=gen) * 0.05
            else:
                v = torch.rand(p.shape, generator=gen) + 0.5
            p.copy_(v)
    return module


def rays_for_pose(w2c, intr, h, w, device):
    """(h*w, 8) [origin, direction, near, far] rays of a full view."""
    import torch
    from mvsnerf_tpu_torch.ops.geometry import get_ray_directions, get_rays
    c2w = torch.linalg.inv(torch.tensor(w2c, device=device))
    dirs = get_ray_directions(h, w, (float(intr[0, 0]), float(intr[1, 1])),
                              (float(intr[0, 2]), float(intr[1, 2])),
                              device=device)
    o, d = get_rays(dirs, c2w)
    nf = torch.tensor(NEAR_FAR, device=device).expand(d.shape[0], 2)
    return torch.cat([o, d, nf], dim=-1)


def cuda_ms(fn, reps=3):
    """Mean CUDA-event time of `fn` over `reps` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def grad_only(forward, inputs, g):
    """A call of the backward alone, for `cuda_ms`: runs `forward()` once
    under autograd, then each call differentiates that graph (kept for the
    next call), so the twin's forward is not inside the timed span."""
    import torch
    with torch.enable_grad():
        out = forward()
    return lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)


def max_err(a, b):
    if isinstance(a, dict):
        return max(max_err(a[k], b[k]) for k in a)
    return float((a - b).abs().max())


class FinetuneScene:
    """In-memory fine-tune dataset on the bench rig: the 3 source views of
    `make_scene` and `n_views` training views of random pixels around the
    reference pose. No files and no PIL."""

    def __init__(self, rng, n_views=FT_VIEWS):
        from mvsnerf_tpu_torch.data.dtu_ft import rays_for_pose
        self.imgs_norm, self.projs, self.pose_source = make_scene(
            rng, h=H, w=W, focal=FOCAL)
        intr = self.pose_source["intrinsics"][0]
        rays = []
        for v in range(n_views):
            off = v - n_views // 2
            c2w = np.linalg.inv(pose(0, 0.01 * off, 0.02 * off))
            rays.append(rays_for_pose(H, W, (intr[0, 0], intr[1, 1]),
                                      (intr[0, 2], intr[1, 2]), c2w,
                                      *NEAR_FAR))
        self.all_rays = np.concatenate(rays)
        self.all_rgbs = rng.uniform(0, 1, (len(self.all_rays), 3)).astype(
            np.float32)

    def read_source_views(self):
        return self.imgs_norm, self.projs, list(NEAR_FAR), self.pose_source


class StepClock:
    """A `fit` logger that notes the host clock at each logged step; the
    log reads the loss, so the device has finished that step."""

    def __init__(self):
        self.marks = {}

    def log_scalars(self, step, scalars):
        self.marks[step] = time.perf_counter()


def finetune_phase(dev, mlp, mvsnet, failures):
    """Phase 6; returns the K5 and K7 entries of the kernels line."""
    import tempfile

    import torch
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.render_fused import pack_v0_weights
    from mvsnerf_tpu_torch.render.renderer import sample_rays
    from mvsnerf_tpu_torch.train.common import RayBatchIterator
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem

    t0 = time.perf_counter()
    scene = FinetuneScene(np.random.default_rng(SEED + 2))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "seeded.tar")
        torch.save({"global_step": 0,
                    "network_fn_state_dict": mlp.state_dict(),
                    "network_mvs_state_dict": mvsnet.state_dict()}, ckpt)
        args = config_parser(
            f"--dataset_name dtu_ft --with_rgb_loss --pad {PAD} "
            f"--batch_size {FT_BATCH} --N_samples {N_SAMPLES} --ckpt {ckpt}")
        system = FinetuneSystem(args, scene, device=dev)
    vol = system.volume
    require(tuple(vol.shape) == (N_PLANES, H // 4 + 2 * PAD,
                                 W // 4 + 2 * PAD, 8),
            f"fine-tune volume shape {tuple(vol.shape)}")
    require(bool(torch.isfinite(vol).all()), "non-finite fine-tune volume")
    print(f"[6 fine-tune] {len(scene.all_rays)} rays in "
          f"{FT_VIEWS} views, volume {tuple(vol.shape)}, set up in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- (a) K5 and K7 against their twins at the step's shapes
    batch = next(RayBatchIterator({"rays": scene.all_rays,
                                   "rgbs": scene.all_rgbs}, FT_BATCH,
                                  seed=SEED))
    rays = torch.from_numpy(batch["rays"]).to(dev)
    rgbs = torch.from_numpy(batch["rgbs"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = []

    def entry(name, source, replaces, err, tol, fn_k, fn_p, **extra):
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=err, tol=tol,
                            ms=cuda_ms(fn_k), plain_ms=cuda_ms(fn_p),
                            **extra))

    src5 = "mvsnerf_tpu_torch/csrc/volume_gather.cu"
    rep5 = "mvsnerf_tpu/ops/pallas_volgather2.py:268"
    src7 = "mvsnerf_tpu_torch/csrc/mlp_v0_train.cu"
    rep7 = "mvsnerf_tpu/ops/pallas_mlp.py:318"
    with torch.no_grad():
        w2cs = system.pose_source["w2cs"]
        intrs = system.pose_source["intrinsics"]
        ndc = sample_rays(
            rays, N_SAMPLES, w2cs[0], intrs[0], system.imgs.shape[1:3],
            system.near_far, PAD, perturb=args.perturb,
            generator=gen)[3].contiguous()
        v = vol.detach()
        f_k, f_p = k5.volume_gather_kernel(v, ndc), \
            k5.sample_volume_plain(v, ndc)
        entry("K5 volume_gather (fwd)", src5, rep5, max_err(f_k, f_p),
              TOL_K5 * (1 + float(f_p.abs().max())),
              lambda: k5.volume_gather_kernel(v, ndc),
              lambda: k5.sample_volume_plain(v, ndc))
        g5 = torch.randn(f_p.shape, device=dev, generator=gen)
        b_k = k5.volume_splat_kernel(g5, ndc, v.shape)
        b_p = k5.volume_splat_plain(g5, ndc, v)
        v_r = v.clone().requires_grad_()
        entry("K5 volume_splat (bwd)", src5, rep5, max_err(b_k, b_p),
              TOL_K5 * (1 + float(b_p.abs().max())),
              lambda: k5.volume_splat_kernel(g5, ndc, v.shape),
              grad_only(lambda: k5.sample_volume_plain(v_r, ndc), v_r, g5))
        del f_k, f_p, g5, b_k, b_p, v_r

        x = system.mlp_input(rays, gen).reshape(-1, 86).contiguous()
        m = system.mlp
        packed = pack_v0_weights(m)
        wt = pack_v0_weights(m, transposed=True)
        scratch = k7.mlp_v0_scratch(len(x), dev)
        o_k, o_p = k7.mlp_v0_fwd_kernel(x, packed, scratch), m(x)
        entry("K7 mlp_v0 (fwd)", src7, rep7, max_err(o_k, o_p),
              TOL_K7 * (1 + float(o_p.abs().max())),
              lambda: k7.mlp_v0_fwd_kernel(x, packed, scratch),
              lambda: m(x))
        # samples at a ReLU kink get a zero cotangent: float32 puts them
        # on either side of it, and their gradients then differ by design
        kink7 = k7.relu_margin(m, x) <= KINK
        g7 = torch.randn(o_p.shape, device=dev, generator=gen) / len(x)
        g7[kink7] = 0.0
        dx_k, dw_k = k7.mlp_v0_bwd_kernel(g7, packed, wt, scratch)
        dx_p, dw_p = k7.mlp_v0_bwd_plain(m, x, g7)
        dx_64, dw_64 = k7.mlp_v0_bwd_plain(copy.deepcopy(m).double(),
                                           x.double(), g7.double())
        f = slice(63, 83)

        def tol64(plain, ref):
            return TOL_K7_BWD * max(max_err(plain.double(), ref),
                                    1e-6 * float(ref.abs().max()))

        feat_err = max_err(dx_k[:, f], dx_p[:, f])
        feat_tol = tol64(dx_p[:, f], dx_64[:, f])
        zero = float(dx_k[:, :63].abs().max() + dx_k[:, 83:].abs().max())
        x_r = x.clone().requires_grad_()
        entry("K7 mlp_v0 (bwd)", src7, rep7, max_err(dw_k, dw_p),
              tol64(dw_p, dw_64),
              lambda: k7.mlp_v0_bwd_kernel(g7, packed, wt, scratch),
              grad_only(lambda: m(x_r), [x_r, *m.parameters()], g7),
              dfeat_max_abs_err=feat_err)
        print(f"   K7 bwd: {int(kink7.sum())} of {len(x)} samples at a ReLU "
              f"kink, cotangent zeroed")
        print(f"   K7 bwd vs float64: dW kernel "
              f"{max_err(dw_k.double(), dw_64):.3e} / twin "
              f"{max_err(dw_p.double(), dw_64):.3e} (max |dW| "
              f"{float(dw_64.abs().max()):.3e}); d feats kernel "
              f"{max_err(dx_k[:, f].double(), dx_64[:, f]):.3e} / twin "
              f"{max_err(dx_p[:, f].double(), dx_64[:, f]):.3e} (max "
              f"{float(dx_64[:, f].abs().max()):.3e})")
        print(f"   K7 bwd: d feats err {feat_err:.3e} (tol {feat_tol:.1e}), "
              f"PE / view-direction slices max |dx| {zero} (must be 0)")
        check(feat_err <= feat_tol, "K7 d feats disagree with the twin",
              failures)
        check(zero == 0.0, "K7 returned a non-zero PE / view gradient",
              failures)
        del x, x_r, scratch, o_k, o_p, g7, dx_k, dw_k, dx_p, dw_p, dx_64, \
            dw_64
    for k in kernels:
        print(f"[6 kernel] {k['name']}: max_abs_err {k['max_abs_err']:.3e} "
              f"(tol {k['tol']:.1e}), kernel {k['ms']:.3f} ms, plain "
              f"{k['plain_ms']:.3f} ms")
        check(k["max_abs_err"] <= k["tol"],
              f"{k['name']} disagrees with its plain twin", failures)

    # ---- (b) one step on the kernels, one on the twins, same state
    state0 = copy.deepcopy(system.state(0))
    after = {}
    for twins in (False, True):
        system.load_state(state0)
        gen.manual_seed(SEED + 1)
        loss = float(system._step(rays, rgbs, gen, twins=twins))
        after[twins] = dict(
            loss=loss, volume=system.volume.detach().clone(),
            g_volume=system.volume.grad.clone(),
            mlp=torch.cat([p.detach().reshape(-1)
                           for p in system.mlp.parameters()]),
            g_mlp=torch.cat([p.grad.reshape(-1)
                             for p in system.mlp.parameters()]))
    # samples within KINK of a ReLU kink may take either side of it in
    # float32; the voxels they reach are left out of the gradient check
    system.load_state(state0)
    gen.manual_seed(SEED + 1)
    x = system.mlp_input(rays, gen)
    kink = (k7.relu_margin(system.mlp, x) <= KINK).float()
    reached = k5.volume_splat_plain(
        kink.reshape(x.shape[0], x.shape[1], 1).expand(-1, -1, 8)
        .contiguous(), x[..., :3].contiguous(), system.volume) != 0
    k, p = after[False], after[True]
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    g_tol = {n: TOL_STEP_GRAD * float(p[f"g_{n}"].abs().max())
             for n in ("volume", "mlp")}
    g_err = {"volume": max_err(k["g_volume"][~reached],
                               p["g_volume"][~reached]),
             "mlp": max_err(k["g_mlp"], p["g_mlp"])}
    # Adam's first update is lr * g / (|g| + 1e-8): where |g| is near 1e-8
    # it turns float32 gradient differences into update differences of up
    # to lr. Elsewhere the updates agree to STEP_TOL; untouched values must
    # not move.
    u_err = {}
    for n in ("volume", "mlp"):
        g = p[f"g_{n}"].abs()
        firm, still = g > 1e-7, g == 0
        u_err[n] = max_err(k[n][firm], p[n][firm])
        check(max_err(k[n], p[n]) <= 2 * args.lrate and
              bool(torch.equal(k[n][still], p[n][still])),
              f"the kernel step and the plain step update {n} apart",
              failures)
    step_tol = STEP_TOL * args.lrate
    print(f"[6 step] kernels vs twins from one state: loss {k['loss']:.6f}"
          f" / {p['loss']:.6f} (rel {loss_rel:.2e}, tol 1e-5); gradient "
          f"max diff volume {g_err['volume']:.2e} (tol "
          f"{g_tol['volume']:.1e}; {int(kink.sum())} samples at a ReLU "
          f"kink reach {int(reached.sum())} volume values, left out), MLP "
          f"{g_err['mlp']:.2e} (tol {g_tol['mlp']:.1e}); update max diff "
          f"where |g| > 1e-7: volume {u_err['volume']:.2e}, MLP "
          f"{u_err['mlp']:.2e} (tol {step_tol:.1e})")
    check(loss_rel <= 1e-5 and all(g_err[n] <= g_tol[n] for n in g_err)
          and all(e <= step_tol for e in u_err.values()),
          "the kernel step and the plain step disagree", failures)
    system.load_state(state0)
    del state0, after, k, p, x, kink, reached
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        system._step(rays, rgbs, gen, twins=True)
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) * 1e3 / 5

    # ---- (c) the main path: fit, launch counters reset just before
    counters = {"K4 color_warp": (color_warp, "launches"),
                "K5 volume_gather (fwd)": (k5.sample_volume, "launches"),
                "K5 volume_splat (bwd)": (k5.sample_volume, "bwd_launches"),
                "K7 mlp_v0 (fwd)": (k7.mlp_v0_train, "launches"),
                "K7 mlp_v0 (bwd)": (k7.mlp_v0_train, "bwd_launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    clock = StepClock()
    torch.cuda.reset_peak_memory_stats()
    losses = system.fit(num_steps=FT_WARM + FT_TIMED, log_every=5,
                        logger=clock, seed=SEED, val_every=0)
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    first, last = FT_WARM - 1, FT_WARM + FT_TIMED - 1
    step_ms = (clock.marks[last] - clock.marks[first]) * 1e3 / FT_TIMED
    print(f"[6 fit] {len(losses)} steps, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; steps {first + 1}-{last}: {step_ms:.2f} "
          f"ms/step, finetune_train_rays_per_sec_per_chip "
          f"{FT_BATCH / step_ms * 1e3:.0f}; plain-twin step "
          f"{plain_step_ms:.2f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches {launches}")
    check(len(losses) == FT_WARM + FT_TIMED and
          all(math.isfinite(v) for v in losses),
          "fit returned a non-finite loss", failures)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the fine-tune path",
              failures)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # ---- (d) device time of one step by kernel group
    from torch.profiler import ProfilerActivity, profile
    groups = {"K7": ("mlp_fwd_kernel", "mlp_bwd_kernel", "mlp_dw_kernel",
                     "reduce_partials"),
              "K5 fwd": ("gather_kernel",), "K5 bwd": ("splat_kernel",),
              "K4": ("color_warp_kernel",),
              "Adam (multi_tensor_apply)": ("multi_tensor_apply",),
              "fills (zeroed buffers)": ("FillFunctor",)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            system._step(rays, rgbs, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False) and \
                not e.name.startswith("Optimizer."):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    total = sum(by_name.values())
    if total == 0:
        print("[6 profile] the profiler saw no device time")
        return kernels
    shares = {g: 0.0 for g in groups}
    shares["rest"] = 0.0
    for name, us in by_name.items():
        g = next((g for g, keys in groups.items()
                  if any(key in name for key in keys)), "rest")
        shares[g] += us
    print(f"[6 profile] 3 steps: device busy {total / 1e3:.2f} of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * total / wall_us:.1f} %); "
          f"per step {total / 3e3:.2f} ms of kernels")
    for g, us in shares.items():
        print(f"   {g}: {us / 3e3:.3f} ms/step ({100 * us / total:.1f} %)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"   {us / 3e3:8.3f} ms/step  {name[:110]}")
    return kernels


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])

    import mvsnerf_tpu_torch
    from mvsnerf_tpu_torch import _build
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from mvsnerf_tpu_torch.models.mvsnet import MVSNet, depth_plane_values
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.color_warp import color_warp, \
        color_warp_plain
    from mvsnerf_tpu_torch.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu_torch.ops.interp import interpolate_bilinear_resize
    from mvsnerf_tpu_torch.ops.render_fused import render_v0, \
        render_v0_plain
    from mvsnerf_tpu_torch.ops.sampling import ray_marcher
    from mvsnerf_tpu_torch.ops.sweep import sweep_cost_volume, \
        sweep_cost_volume_plain
    from mvsnerf_tpu_torch.render.renderer import gen_dir_feature
    mvsnerf_tpu_torch.set_precision_policy()

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[2 build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("   ptxas:", line.strip())

    gen = torch.Generator().manual_seed(SEED)
    mlp = seeded_init_(MVSNeRF(device=dev), gen).eval()
    mvsnet = seeded_init_(MVSNet(device=dev), gen)
    imgs_norm, projs, pose_src = make_scene(np.random.default_rng(SEED))
    ev = Evaluator(mvsnet, mlp, n_samples=N_SAMPLES, pad=PAD,
                   n_planes=N_PLANES, chunk=CHUNK, device=dev)
    requests = [rays_for_pose(pose(0, da, dt), pose_src["intrinsics"][0], H,
                              W, dev)
                for da, dt in ((0.0, 0.0), (0.02, 0.1), (-0.02, -0.1))]

    # ---- 3. kernels against their plain twins on the path's inputs
    kernels, failures = [], []
    with torch.no_grad():
        volume, imgs01, nf, pose_t = ev.build_volume(imgs_norm, projs,
                                                     NEAR_FAR, pose_src)
        imgs_t = torch.tensor(imgs_norm, device=dev)
        feats = mvsnet.feature(imgs_t)
        h4, w4 = feats.shape[1:3]
        imgs_l = torch.stack([interpolate_bilinear_resize(im, h4, w4)
                              for im in imgs_t])
        srcs = torch.cat([feats, imgs_l], dim=-1).contiguous()
        proj_t = torch.tensor(projs, device=dev)
        depths = depth_plane_values(nf[0], nf[1], N_PLANES, device=dev)
        k1 = (srcs, proj_t, depths, PAD, 32)
        out_k, out_p = sweep_cost_volume(*k1), sweep_cost_volume_plain(*k1)
        require(out_k.shape == (1, 41, N_PLANES, h4 + 2 * PAD,
                                w4 + 2 * PAD), f"K1 shape {out_k.shape}")
        err = max_err(out_k, out_p)
        tol = TOL_K1 * (1 + float(out_p.abs().max()))
        kernels.append(dict(
            name="K1 sweep_cost_volume", route="cuda",
            source="mvsnerf_tpu_torch/csrc/sweep.cu",
            replaces="mvsnerf_tpu/ops/pallas_sweep2.py:316",
            max_abs_err=err, tol=tol,
            ms=cuda_ms(lambda: sweep_cost_volume(*k1)),
            plain_ms=cuda_ms(lambda: sweep_cost_volume_plain(*k1))))
        del out_k, out_p

        pts, _, rays_d, z_vals = ray_marcher(requests[1][:CHUNK], N_SAMPLES)
        w2cs, intrs = pose_t["w2cs"], pose_t["intrinsics"]
        k4 = (pts.contiguous(), w2cs, intrs, imgs01.contiguous())
        colors, colors_p = color_warp(*k4), color_warp_plain(*k4)
        kernels.append(dict(
            name="K4 color_warp", route="cuda",
            source="mvsnerf_tpu_torch/csrc/color_warp.cu",
            replaces="mvsnerf_tpu/ops/pallas_sweep.py:258",
            max_abs_err=max_err(colors, colors_p), tol=TOL_K4,
            ms=cuda_ms(lambda: color_warp(*k4)),
            plain_ms=cuda_ms(lambda: color_warp_plain(*k4))))

        inv_scale = torch.tensor([W - 1.0, H - 1.0], device=dev)
        ndc = get_ndc_coordinate(w2cs[0], intrs[0], pts, inv_scale,
                                 near=nf[0], far=nf[1], pad=PAD)
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        k6 = (ndc.contiguous(), z_vals.contiguous(), colors,
              gen_dir_feature(w2cs[0], unit).contiguous(), volume, mlp)
        r_k, r_p = render_v0(*k6), render_v0_plain(*k6)
        kernels.append(dict(
            name="K6 render_v0", route="cuda",
            source="mvsnerf_tpu_torch/csrc/render_v0.cu",
            replaces="mvsnerf_tpu/ops/pallas_render_tiled.py:313",
            max_abs_err=max_err(r_k, r_p), tol=TOL_K6,
            ms=cuda_ms(lambda: render_v0(*k6)),
            plain_ms=cuda_ms(lambda: render_v0_plain(*k6))))
        print(f"   K6 inputs: acc mean {float(r_p['acc'].mean()):.4f}, "
              f"rgb std {float(r_p['rgb'].std()):.4f}")
        del k1, k4, k6, srcs, feats, colors, colors_p, r_k, r_p
    for k in kernels:
        print(f"[3 kernel] {k['name']}: max_abs_err {k['max_abs_err']:.3e} "
              f"(tol {k['tol']:.1e}), kernel {k['ms']:.3f} ms, plain "
              f"{k['plain_ms']:.3f} ms")
        check(k["max_abs_err"] <= k["tol"],
              f"{k['name']} disagrees with its plain twin", failures)
    torch.cuda.empty_cache()

    # ---- 4. the slice, counting kernel launches
    wrappers = {"K1 sweep_cost_volume": sweep_cost_volume,
                "K4 color_warp": color_warp, "K6 render_v0": render_v0}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    volume, *_ = ev.build_volume(imgs_norm, projs, NEAR_FAR, pose_src)
    torch.cuda.synchronize()
    volume_ms = (time.perf_counter() - t0) * 1e3
    require(tuple(volume.shape) == (N_PLANES, H // 4 + 2 * PAD,
                                    W // 4 + 2 * PAD, 8),
            f"volume shape {tuple(volume.shape)}")
    require(bool(torch.isfinite(volume).all()), "non-finite volume")
    times = {"chunked": [], "hybrid": []}
    worst = 0.0
    for rays in requests:
        outs = {}
        for mode in ("chunked", "hybrid"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ev.render(rays, H, W, mode=mode)
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3)
            for key, shape in (("rgb", (H * W, 3)), ("depth", (H * W,)),
                               ("acc", (H * W,))):
                require(tuple(out[key].shape) == shape,
                        f"{mode} {key} shape {tuple(out[key].shape)}")
                require(bool(torch.isfinite(out[key]).all()),
                        f"{mode} {key} not finite")
            outs[mode] = out
        worst = max(worst, max_err(outs["hybrid"]["rgb"],
                                   outs["chunked"]["rgb"]))
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"[4 slice] volume {tuple(volume.shape)} built in "
          f"{volume_ms:.1f} ms")
    for mode, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"[4 slice] {mode}: {len(ts)} requests of {H}x{W} rays, "
              f"ms/request {[round(t, 1) for t in ts]}, mean {ms:.1f}, "
              f"{H * W / ms * 1e3:.0f} rays/s")
    print(f"[4 slice] hybrid vs chunked rgb max abs diff {worst:.3e} "
          f"(tol {TOL_MODES:.0e}); launches {launches}")
    check(worst <= TOL_MODES, "hybrid and chunked renders disagree",
          failures)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path", failures)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # ---- 5. small input: the card against the CPU's plain twins
    rng = np.random.default_rng(SEED + 1)
    toy = make_scene(rng, h=64, w=96, focal=80.0)
    results = []
    for device, nets in ((dev, (mvsnet, mlp)),
                         ("cpu", (copy.deepcopy(mvsnet).cpu(),
                                  copy.deepcopy(mlp).cpu()))):
        small = Evaluator(*nets, n_samples=32, pad=4, n_planes=16,
                          chunk=1000, device=device)
        vol, *_ = small.build_volume(*toy[:2], NEAR_FAR, toy[2])
        rays = rays_for_pose(pose(0, 0.01, 0.05), toy[2]["intrinsics"][0],
                             32, 48, device)
        results.append([vol.cpu()] + [
            small.render(rays, 32, 48, mode=m)["rgb"].cpu()
            for m in ("chunked", "hybrid")])
    (vg, cg, hg), (vc, cc, hc) = results
    verr = max_err(vg, vc) / (1 + float(vc.abs().max()))
    rerr = max(max_err(cg, cc), max_err(hg, hc))
    print(f"[5 small] card vs CPU: volume rel err {verr:.2e}, rgb err "
          f"{rerr:.2e}")
    check(verr <= 1e-4 and rerr <= 1e-4, "card and CPU disagree", failures)

    # ---- 6. fine-tune
    torch.cuda.empty_cache()
    kernels += finetune_phase(dev, mlp, mvsnet, failures)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed",
              file=sys.stderr)
        return 1

    for k in kernels:
        del k["tol"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
