#!/usr/bin/env python3
"""Smoke run of the mvsnerf_tpu_torch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths at DTU scale on synthetic 640x512 scenes made
from a seed, with seeded random weights: no-finetune inference, the
per-scene fine-tune step and the generalizable training step.

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
     (d) `torch.profiler` over 3 steps: device time by kernel group;
  7. generalizable training: `GeneralizableSystem` from a
     reference-format checkpoint of the same weights, on bench.py's
     generalizable batch (4 random 640x512 views of the rig, the last the
     target, random depths in [2, 5]), batch 1024, 128 samples, pad 24,
     128 planes, depth loss: (a) K2 (the sweep backward) against its plain
     twin on the cotangent that reaches the sweep in the trainer's own
     graph, read in place in the layout it arrives in (K3'), and on the
     same cotangent in channels_last_3d; (b) one step's MLP, CostRegNet
     and FeatureNet gradients on the kernels, on the twins and on the
     twins in float64, from one state and draws; (c) 12 steps of `fit`
     (launch counters reset just before), timed over the last 10:
     generalizable_train_step_ms and peak memory; (d) the step with K7
     against the step with the module's MLP, and with cuDNN's autotuner;
     (e) `torch.profiler` over 2 steps: device busy share, time by stage
     and each stage's largest kernels, and that no operation copied a
     cost-volume-sized tensor (the U-Net reads K1's output in place).

A failed comparison is reported and the remaining phases still run; the
script then exits non-zero without the result lines. Other errors raise.
On success the last two lines are one JSON object of per-kernel results
(error against the plain twin, kernel, twin and library-call times, the
bound the card's peaks set, launches on the kernel's path) and
`{"ok": true, "device": {...}}`.
"""

import contextlib
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
# phase 7, the generalizable step at bench.py:471-486's configuration
GEN_VIEWS, GEN_BATCH = 4, 1024
# K2 against its twin: x max|twin|. f32 atomics add the source gradients in
# an order that changes from run to run.
TOL_K2 = 1e-5
# one generalizable step's gradients: the kernels' distance from a float64
# run of the twins, per module, at most TOL_GEN_GRAD x the float32 twins'
# own (floored at 1e-6 x max|g|). The step runs the U-Net's cuDNN backward
# (which sums in a run-dependent order) and the atomics of K2 and K5, and
# its batch-statistics norms cancel most of each weight gradient, so a
# fixed share of max|g| says less than the twins' own float32 error. Rays
# with a sample near a ReLU kink of the MLP are not drawn (KINK, the
# fine-tune step's rule). Nothing is left out at MVSNet's LeakyReLU
# kinks: the float32 twins take the other side of some of them too.
TOL_GEN_GRAD = 5.0
GEN_WARM, GEN_TIMED, GEN_AB = 2, 10, 3


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


def make_scene(rng, h=H, w=W, focal=FOCAL, v=3):
    """v views of random images with the bench's camera rig: normalised
    images, relative stride-4 projections, w2cs and intrinsics."""
    imgs = rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                    np.float32)
    intr_s4 = intr.copy()
    intr_s4[:2] /= 4
    w2cs = np.stack([pose(i) for i in range(v)])
    p4 = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    p4[:, :3] = intr_s4 @ w2cs[:, :3]
    projs = (p4 @ np.linalg.inv(p4[0]))[:, :3].astype(np.float32)
    return ((imgs - mean) / std, projs,
            {"w2cs": w2cs, "intrinsics": np.stack([intr] * v)})


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


@contextlib.contextmanager
def swapped(module, name, value):
    """`module.name` set to `value` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


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


# the H100's published peaks (NVIDIA's data sheet, SXM part, at 700 W):
# device-memory bytes/s and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops):
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the
    memory rate and its operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sweep_flops(V, C, voxels, backward=False):
    """Operations of one K1 (or K2) call. Per voxel and source view: the
    projection and normalisation (39) and 4 bilinear taps of C + 3
    channels (a multiply and an add each). K1 then takes the variance
    over V views (3 per channel and view, 4 more per channel); K2 the
    variance gradient (4 per channel and view), scattered back through the
    same taps."""
    warp = (V - 1) * (39 + 8 * (C + 3))
    if backward:
        return voxels * (2 * warp + 4 * C * V)
    return voxels * (warp + C * (3 * V + 4))


def touched_volume_bytes(volume, ndc):
    """Bytes of the distinct cells of a (D, hp, wp, C) volume that the
    trilinear taps at (..., 3) NDC reach: what this run's gather reads."""
    import torch
    D, hp, wp, C = volume.shape
    size = torch.tensor([wp, hp, D], device=ndc.device)
    base = (ndc.reshape(-1, 3) * (size - 1)).floor().long()
    cells = []
    for corner in range(8):
        c = base + torch.tensor([corner & 1, corner >> 1 & 1, corner >> 2],
                                device=ndc.device)
        inside = ((c >= 0) & (c < size)).all(-1)
        cells.append(((c[:, 2] * hp + c[:, 1]) * wp + c[:, 0])[inside])
    return torch.unique(torch.cat(cells)).numel() * C * 4


def mlp_flops(n_samples, backward=False):
    """The v0 MLP's multiply-adds (nn.Linear weights, 125,476 a sample)
    times 2; the backward forms both dx and dW, twice the forward."""
    from mvsnerf_tpu_torch.ops.render_fused import _LAYERS
    macs = sum(i * o for _, i, o in _LAYERS)
    return 2 * macs * n_samples * (2 if backward else 1)


def layout(t):
    """The memory layout of a 5-D tensor, by name where it has one."""
    import torch
    if t.is_contiguous(memory_format=torch.channels_last_3d):
        return "channels_last_3d"
    return "NCDHW" if t.is_contiguous() else f"strides {t.stride()}"


def report(phase, kernels, failures):
    """Print each kernel entry and hold it to its tolerance."""
    for k in kernels:
        lib = "none" if k["library_ms"] is None else \
            f"{k['library_ms']:.3f} ms"
        print(f"[{phase} kernel] {k['name']}: max_abs_err "
              f"{k['max_abs_err']:.3e} (tol {k['tol']:.1e}), kernel "
              f"{k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, library "
              f"{lib}, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
        check(k["max_abs_err"] <= k["tol"],
              f"{k['name']} disagrees with its plain twin", failures)


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

    def entry(name, source, replaces, err, tol, fn_k, fn_p, fn_lib,
              n_bytes, flops, **extra):
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=err, tol=tol,
                            ms=cuda_ms(fn_k), plain_ms=cuda_ms(fn_p),
                            library_ms=fn_lib and cuda_ms(fn_lib),
                            **bound(n_bytes, flops), **extra))

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
        n5, c5 = ndc[..., 0].numel(), v.shape[-1]
        # the library call: one 3-D grid_sample (and its backward) on the
        # NCDHW volume, laid out beforehand
        vol5 = v.permute(3, 0, 1, 2)[None].contiguous()
        grid5 = (ndc * 2 - 1).reshape(1, -1, 1, 1, 3)
        f_k, f_p = k5.volume_gather_kernel(v, ndc), \
            k5.sample_volume_plain(v, ndc)
        entry("K5 volume_gather (fwd)", src5, rep5, max_err(f_k, f_p),
              TOL_K5 * (1 + float(f_p.abs().max())),
              lambda: k5.volume_gather_kernel(v, ndc),
              lambda: k5.sample_volume_plain(v, ndc),
              lambda: torch.nn.functional.grid_sample(
                  vol5, grid5, mode="bilinear", padding_mode="zeros",
                  align_corners=True),
              touched_volume_bytes(v, ndc) + nbytes(ndc, f_k),
              n5 * (30 + 8 * c5 * 2))
        g5 = torch.randn(f_p.shape, device=dev, generator=gen)
        g5_lib = g5.reshape(-1, c5).t().reshape(1, c5, -1, 1, 1).contiguous()
        b_k = k5.volume_splat_kernel(g5, ndc, v.shape)
        b_p = k5.volume_splat_plain(g5, ndc, v)
        v_r = v.clone().requires_grad_()
        entry("K5 volume_splat (bwd)", src5, rep5, max_err(b_k, b_p),
              TOL_K5 * (1 + float(b_p.abs().max())),
              lambda: k5.volume_splat_kernel(g5, ndc, v.shape),
              grad_only(lambda: k5.sample_volume_plain(v_r, ndc), v_r, g5),
              lambda: torch.ops.aten.grid_sampler_3d_backward(
                  g5_lib, vol5, grid5, 0, 0, True, [True, False]),
              nbytes(g5, ndc, b_k), n5 * (30 + 8 * c5 * 2))
        del f_k, f_p, g5, g5_lib, b_k, b_p, v_r, vol5, grid5

        x = system.mlp_input(rays, gen).reshape(-1, 86).contiguous()
        m = system.mlp
        packed = pack_v0_weights(m)
        wt = pack_v0_weights(m, transposed=True)
        scratch = k7.mlp_v0_scratch(len(x), dev)
        o_k, o_p = k7.mlp_v0_fwd_kernel(x, packed, scratch), m(x)
        entry("K7 mlp_v0 (fwd)", src7, rep7, max_err(o_k, o_p),
              TOL_K7 * (1 + float(o_p.abs().max())),
              lambda: k7.mlp_v0_fwd_kernel(x, packed, scratch),
              lambda: m(x), None, nbytes(x, packed, o_k),
              mlp_flops(len(x)))
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
              grad_only(lambda: m(x_r), [x_r, *m.parameters()], g7), None,
              nbytes(g7, x, packed, dx_k, dw_k), mlp_flops(len(x), True),
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
    report(6, kernels, failures)

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


def generalizable_sample(rng):
    """bench.py's generalizable batch (bench.py:471-486) as a dataset
    sample: GEN_VIEWS random views of the rig (the target is the last),
    the fine-tune near/far for every view, random depths in [2, 5]."""
    imgs_norm, projs, pose_src = make_scene(rng, H, W, FOCAL, GEN_VIEWS)
    w2cs = pose_src["w2cs"]
    return {"images": imgs_norm, "proj_mats": projs,
            "near_fars": np.tile(np.array(NEAR_FAR, np.float32),
                                 (GEN_VIEWS, 1)),
            "w2cs": w2cs, "c2ws": np.linalg.inv(w2cs).astype(np.float32),
            "intrinsics": pose_src["intrinsics"],
            "depths_h": rng.uniform(2, 5, (GEN_VIEWS, H, W)).astype(
                np.float32)}


# The generalizable step's device timeline in launch order, cut at marker
# kernels: (name fragment, the marker's group, the group of the kernels
# after it, or None to stay in the marker's). Before K1: FeatureNet's
# forward and the sources' resize; between the render's first kernel and
# K7's backward: the render forward, the loss and the compositing's
# backward.
STEP_MARKS = [("sweep_kernel", "K1", "CostRegNet fwd"),
              ("color_warp_kernel", "render fwd + loss", None),
              ("mlp_bwd_kernel", "render bwd", None),
              ("splat_kernel", "render bwd", "CostRegNet bwd"),
              ("sweep_bwd_kernel", "K2", "FeatureNet bwd"),
              ("multi_tensor_apply", "Adam", None)]


def step_groups(kernels):
    """Device microseconds by group of a run of whole steps, from
    (name, us) pairs in launch order (one stream): {group: {kernel name:
    us}}."""
    groups = {g: {} for g in (
        "FeatureNet fwd", "K1", "CostRegNet fwd", "render fwd + loss",
        "render bwd", "CostRegNet bwd", "K2", "FeatureNet bwd", "Adam",
        "host copies")}
    group = "FeatureNet fwd"
    for name, us in kernels:
        into = group
        mark = next((m for m in STEP_MARKS if m[0] in name), None)
        if name.startswith("Memcpy"):
            into = "host copies"
        elif mark is not None:
            into = mark[1]
            group = mark[2] or mark[1]
        elif group == "Adam":  # the next step begins
            into = group = "FeatureNet fwd"
        groups[into][name] = groups[into].get(name, 0.0) + us
    return groups


def generalizable_phase(dev, mlp, mvsnet, failures):
    """Phase 7; returns the K2 entry of the kernels line."""
    import tempfile

    import torch
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.ops import homography
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import sweep as k12
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.geometry import sample_random_pixels
    from mvsnerf_tpu_torch.render import renderer
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem

    t0 = time.perf_counter()
    sample = generalizable_sample(np.random.default_rng(SEED + 3))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "seeded.tar")
        torch.save({"global_step": 0,
                    "network_fn_state_dict": mlp.state_dict(),
                    "network_mvs_state_dict": mvsnet.state_dict()}, ckpt)
        args = config_parser(
            f"--dataset_name dtu --pad {PAD} --N_samples {N_SAMPLES} "
            f"--batch_size {GEN_BATCH} --with_depth_loss --with_depth "
            f"--net_type v0 --ckpt {ckpt}")
        system = GeneralizableSystem(args, device=dev)
    batch = system.batch(sample)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    print(f"[7 generalizable] {GEN_VIEWS} views of {H}x{W}, batch "
          f"{GEN_BATCH} x {N_SAMPLES} samples, pad {PAD}, {N_PLANES} "
          f"planes, depth loss; set up in {time.perf_counter() - t0:.1f} s")

    # ---- (a) K2 against its twin on the cotangent that reaches the sweep
    # in the trainer's own graph (`_volume`, i.e. MVSNet.forward, under a
    # seeded random loss of the (D, hp, wp, 8) volume it returns), in the
    # layout it arrives in, and on the same cotangent in channels_last_3d
    captured = {}

    def capturing(srcs, *rest):
        cost = k12.sweep_cost_volume(srcs, *rest)
        captured.update(args=(srcs.detach(), *rest), cost=cost)
        return cost

    with swapped(homography, "sweep_cost_volume", capturing):
        vol = system._volume(batch)
    require(captured["cost"].grad_fn is not None,
            "the card's cost volume has no grad_fn though srcs require grad")
    g = torch.autograd.grad(
        (vol * torch.randn(vol.shape, device=dev, generator=gen)).sum(),
        captured["cost"])[0]
    k2 = captured["args"]
    del vol, captured
    srcs = k2[0]
    gp = k12.sweep_cost_volume_bwd_plain(g, *k2)
    ref_max = float(gp.abs().max())
    path_layout = layout(g)
    other = g.contiguous(memory_format=torch.channels_last_3d) \
        if path_layout == "NCDHW" else g.contiguous()
    gk = k12.sweep_cost_volume_bwd_kernel(g, *k2)
    rerun = max_err(k12.sweep_cost_volume_bwd_kernel(g, *k2), gk)
    other_err = max_err(k12.sweep_cost_volume_bwd_kernel(other, *k2), gp)
    other_ms = cuda_ms(lambda: k12.sweep_cost_volume_bwd_kernel(other, *k2))
    s_p = srcs.clone().requires_grad_()
    entry = dict(
        name="K2 sweep_cost_volume (bwd)", route="cuda",
        source="mvsnerf_tpu_torch/csrc/sweep.cu",
        replaces="mvsnerf_tpu/ops/pallas_sweep2.py:210",
        max_abs_err=max_err(gk, gp), tol=TOL_K2 * ref_max,
        ms=cuda_ms(lambda: k12.sweep_cost_volume_bwd_kernel(g, *k2)),
        plain_ms=cuda_ms(grad_only(
            lambda: k12.sweep_cost_volume_plain(s_p, *k2[1:]), s_p, g)),
        library_ms=None,
        **bound(nbytes(g, *k2[:3], gk),
                sweep_flops(3, 32, g[0, 0].numel(), backward=True)))
    view_max = [float(gk[v].abs().max()) for v in range(3)]
    print(f"   K2: cotangent {tuple(g.shape)} reaches the sweep in "
          f"{path_layout}, read in place; max|twin| {ref_max:.3e}, per-view "
          f"max |d srcs| {[f'{m:.3e}' for m in view_max]}; kernel "
          f"run-to-run max diff {rerun:.3e}")
    print(f"   K2 on the same cotangent in {layout(other)}: max_abs_err "
          f"{other_err:.3e} (tol {entry['tol']:.1e}), kernel {other_ms:.3f} "
          f"ms")
    report(7, [entry], failures)
    check(other_err <= entry["tol"],
          f"K2 disagrees with its twin on a {layout(other)} cotangent",
          failures)
    check(min(view_max) > 0, "K2 left a view without gradient", failures)
    del g, gk, gp, s_p, srcs, k2, other
    torch.cuda.empty_cache()

    # ---- (b) one step's gradients on the kernels, on the twins and on the
    # twins in float64, from one state and draws: up to GEN_BATCH of
    # 16 x GEN_BATCH drawn rays whose samples all lie more than KINK from
    # every ReLU kink of the MLP (the fine-tune step's rule)
    xs, ys = sample_random_pixels(*batch["images"].shape[1:3],
                                  16 * GEN_BATCH, gen)
    u = torch.rand((len(xs), N_SAMPLES), generator=gen, device=dev)
    margin = k7.relu_margin(system.mlp, system.mlp_input(batch, xs, ys, u))
    keep = torch.nonzero(margin.reshape(len(xs), -1).amin(1) > KINK)[:, 0]
    require(len(keep) >= GEN_BATCH // 4,
            f"only {len(keep)} of {len(xs)} rays clear of the ReLU kinks")
    keep = keep[:GEN_BATCH]
    draws = (xs[keep], ys[keep], u[keep])
    del margin, xs, ys, u
    state0 = copy.deepcopy(system.state())
    mv = system.mvsnet
    parts = {"MLP": system.mlp, "CostRegNet": mv.cost_reg_2,
             "FeatureNet": mv.feature}

    def sweep_twin(twins):
        """The sweep's plain twin in place of K1/K2 when `twins`."""
        if not twins:
            return contextlib.nullcontext()
        return swapped(homography, "sweep_cost_volume",
                       k12.sweep_cost_volume_plain)

    def step_grads(twins, f64=False):
        """The loss at state0 for the draws and each part's gradient."""
        system.load_state(state0)
        b, d = batch, draws
        if f64:
            torch.set_default_dtype(torch.float64)
            system.mlp.double()
            mv.double()
            b = {key: val.double() for key, val in batch.items()}
            d = tuple(t.double() for t in draws)
        try:
            system.optimizer.zero_grad(set_to_none=True)
            launched = k12.sweep_cost_volume.bwd_launches
            with sweep_twin(twins):
                loss, aux = system.loss(b, *d, twins=twins)
                loss.backward()
            missing = [n for n, q in mv.named_parameters() if q.grad is None]
            require(not missing, f"no gradient for {missing}")
            return dict(
                loss=float(loss.detach()),
                depth=float(aux["depth_loss"].detach()),
                k2=k12.sweep_cost_volume.bwd_launches - launched,
                **{n: torch.cat([q.grad.reshape(-1).double()
                                 for q in m.parameters()])
                   for n, m in parts.items()})
        finally:
            if f64:
                torch.set_default_dtype(torch.float32)
                system.mlp.float()
                mv.float()

    # the layout the U-Net's backward hands K2 on the real path
    seen = []
    bwd_kernel = k12.sweep_cost_volume_bwd_kernel

    def noting_layout(g_cost, *rest):
        seen.append(layout(g_cost))
        return bwd_kernel(g_cost, *rest)

    with swapped(k12, "sweep_cost_volume_bwd_kernel", noting_layout):
        k = step_grads(False)
    k_again, p, p64 = step_grads(False), step_grads(True), \
        step_grads(True, f64=True)
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    print(f"[7 step] one step's gradients from one state ({len(keep)} "
          f"rays): loss kernels {k['loss']:.7f} / twins {p['loss']:.7f} / "
          f"twins in float64 {p64['loss']:.7f} (rel {loss_rel:.2e}, tol "
          f"1e-5; depth loss {k['depth']:.5f}); K2 launches {k['k2']} / "
          f"{p['k2']}; cotangent at K2 in {seen}")
    for n in parts:
        g64 = float(p64[n].abs().max())
        err = {"kernels vs twins": max_err(k[n], p[n]),
               "kernels run-to-run": max_err(k[n], k_again[n]),
               "twins vs float64": max_err(p[n], p64[n]),
               "kernels vs float64": max_err(k[n], p64[n])}
        tol = TOL_GEN_GRAD * max(err["twins vs float64"], 1e-6 * g64)
        print(f"   {n}: max|g| {g64:.3e}; " + ", ".join(
            f"{key} {e:.2e}" for key, e in err.items()) +
            f" (tol {tol:.2e})")
        check(err["kernels vs float64"] <= tol,
              f"the kernel step's {n} gradient is further from float64 "
              f"than {TOL_GEN_GRAD} x the twin step's", failures)
    check(loss_rel <= 1e-5, "the kernel and twin steps' losses disagree",
          failures)
    check(seen == [path_layout],
          f"K2 got {seen} in the step, not (a)'s {path_layout}", failures)
    check(k["k2"] == 1 and p["k2"] == 0 and
          float(k["FeatureNet"].abs().max()) > 0,
          "FeatureNet got no gradient through K2", failures)
    system.load_state(state0)
    del state0, k, k_again, p, p64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sweep_twin(True):
        for _ in range(3):
            system._step(batch, *draws, twins=True)
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) * 1e3 / 3

    # ---- (c) the main path: fit, launch counters reset just before
    counters = {"K1 sweep_cost_volume": (k12.sweep_cost_volume, "launches"),
                "K2 sweep_cost_volume (bwd)": (k12.sweep_cost_volume,
                                               "bwd_launches"),
                "K4 color_warp": (color_warp, "launches"),
                "K5 volume_gather (fwd)": (k5.sample_volume, "launches"),
                "K5 volume_splat (bwd)": (k5.sample_volume, "bwd_launches"),
                "K7 mlp_v0 (fwd)": (k7.mlp_v0_train, "launches"),
                "K7 mlp_v0 (bwd)": (k7.mlp_v0_train, "bwd_launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    clock = StepClock()
    torch.cuda.reset_peak_memory_stats()
    losses = system.fit([sample], num_epochs=GEN_WARM + GEN_TIMED,
                        logger=clock, seed=SEED, log_every=GEN_WARM)
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    step_ms = (clock.marks[GEN_WARM + GEN_TIMED] - clock.marks[GEN_WARM]) \
        * 1e3 / GEN_TIMED
    print(f"[7 fit] {len(losses)} steps, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; steps {GEN_WARM + 1}-{GEN_WARM + GEN_TIMED}: "
          f"generalizable_train_step_ms {step_ms:.2f}; plain-twin step "
          f"{plain_step_ms:.2f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches {launches}")
    check(len(losses) == GEN_WARM + GEN_TIMED and
          all(math.isfinite(v) for v in losses),
          "fit returned a non-finite loss", failures)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the generalizable path",
              failures)
    entry["launches"] = launches[entry["name"]]

    # ---- (d) the step with K7 against the step with the module's own MLP
    # (the JAX step pins its XLA MLP here), in turns on one batch; the
    # training route's MLP is swapped for the module's for the second
    def steps_ms(module_mlp):
        mlp_fn = k7.mlp_v0_train_plain if module_mlp else k7.mlp_v0_train
        with swapped(renderer, "mlp_v0_train", mlp_fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GEN_AB):
                system._step(batch, *draws)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / GEN_AB

    ab = {"K7": [], "module MLP": []}
    for which in ("K7", "module MLP", "module MLP", "K7"):
        ab[which].append(steps_ms(which == "module MLP"))
    print(f"[7 A/B] ms/step over {GEN_AB} steps in turns: " + "; ".join(
        f"{n} {[round(t, 2) for t in ts]}" for n, ts in ab.items()))
    # and with cuDNN choosing its convolution algorithms by timing them
    # (torch.backends.cudnn.benchmark; the port leaves it off), after one
    # step that runs the timing
    torch.backends.cudnn.benchmark = True
    try:
        system._step(batch, *draws)
        tuned = [steps_ms(False) for _ in range(2)]
    finally:
        torch.backends.cudnn.benchmark = False
    print(f"[7 A/B] with cudnn.benchmark: ms/step "
          f"{[round(t, 2) for t in tuned]}")

    # ---- (e) device time of 2 steps (with their batch copies) by group,
    # and the operations that copied a cost-volume-sized tensor (none: the
    # U-Net reads K1's output, and K2 its cotangent, in place)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            b = system.batch(sample)
            system._step(b, *system.draw(b, gen))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = sorted(
        ((e.time_range.start, e.name, e.time_range.elapsed_us())
         for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA and
         not getattr(e, "is_user_annotation", False) and
         not e.name.startswith("Optimizer.")), key=lambda t: t[0])
    cost_shape = [1, 41, N_PLANES, H // 4 + 2 * PAD, W // 4 + 2 * PAD]
    copies = [e.name for e in prof.events()
              if e.name in ("aten::copy_", "aten::clone", "aten::contiguous",
                            "aten::_to_copy") and
              cost_shape in (getattr(e, "input_shapes", None) or [])]
    print(f"[7 profile] operations copying a {tuple(cost_shape)} tensor: "
          f"{copies}")
    check(not copies, "the step copies the cost volume or its cotangent",
          failures)
    total = sum(us for _, _, us in events)
    if total == 0:
        print("[7 profile] the profiler saw no device time")
        return [entry]
    print(f"[7 profile] 2 steps: device busy {total / 1e3:.2f} of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * total / wall_us:.1f} %); "
          f"per step {total / 2e3:.2f} ms of kernels")
    for grp, names in step_groups([(n, us) for _, n, us in events]).items():
        us = sum(names.values())
        print(f"   {grp}: {us / 2e3:.3f} ms/step ({100 * us / total:.1f} %)")
        for name, t in sorted(names.items(), key=lambda kv: -kv[1])[:4]:
            print(f"      {t / 2e3:8.3f}  {name[:100]}")
    return [entry]


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
                                w4 + 2 * PAD) and out_k.is_contiguous(),
                f"K1 output {out_k.shape} in {layout(out_k)}, not NCDHW")
        err = max_err(out_k, out_p)
        tol = TOL_K1 * (1 + float(out_p.abs().max()))
        kernels.append(dict(
            name="K1 sweep_cost_volume", route="cuda",
            source="mvsnerf_tpu_torch/csrc/sweep.cu",
            replaces="mvsnerf_tpu/ops/pallas_sweep2.py:316",
            max_abs_err=err, tol=tol,
            ms=cuda_ms(lambda: sweep_cost_volume(*k1)),
            plain_ms=cuda_ms(lambda: sweep_cost_volume_plain(*k1)),
            library_ms=None,
            **bound(nbytes(srcs, proj_t, depths, out_k),
                    sweep_flops(3, 32, out_k[0, 0].numel()))))
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
            plain_ms=cuda_ms(lambda: color_warp_plain(*k4)),
            library_ms=None,
            # per sample and view: the projection (~30) and 4 bilinear
            # taps of 3 channels
            **bound(nbytes(*k4, colors),
                    pts[..., 0].numel() * len(w2cs) * (30 + 4 * 3 * 2))))

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
            plain_ms=cuda_ms(lambda: render_v0_plain(*k6)),
            library_ms=None,
            **bound(nbytes(*k6[:4], *r_k.values()) +
                    touched_volume_bytes(volume, k6[0]),
                    mlp_flops(k6[0][..., 0].numel()))))
        print(f"   K6 inputs: acc mean {float(r_p['acc'].mean()):.4f}, "
              f"rgb std {float(r_p['rgb'].std()):.4f}")
        del k1, k4, k6, srcs, feats, colors, colors_p, r_k, r_p
    report(3, kernels, failures)
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

    # ---- 7. generalizable training
    torch.cuda.empty_cache()
    kernels += generalizable_phase(dev, mlp, mvsnet, failures)
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
