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
     card and on the CPU (whose wrappers run the plain twins).

A failed comparison is reported and the remaining phases still run; the
script then exits non-zero without the result lines. Other errors raise.
On success the last two lines are one JSON object of per-kernel results
and `{"ok": true, "device": {...}}`.
"""

import copy
import json
import math
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


def max_err(a, b):
    if isinstance(a, dict):
        return max(max_err(a[k], b[k]) for k in a)
    return float((a - b).abs().max())


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
