#!/usr/bin/env python3
"""Smoke run of the mvsnerf_tpu_torch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths at DTU scale on synthetic 640x512 scenes made
from a seed, with seeded random weights: no-finetune inference, the
per-scene fine-tune step and the generalizable training step, the last
with the U-Net on cuDNN (`--costreg_impl plain`) and on the default route,
which takes the hand-written K10 kernels on the card (as every other phase
does), the colour-baked volume with the eval and video entry points, the
render's gradient in its source images (K4's backward), the
density volume with importance sampling and `--use_disp`, and the fusion
trainer; then the Blender (800x800) and LLFF (960x640) datasets through
their loaders, the fine-tune trainer, every render mode and the CLIs;
then data-parallel training and the ray-sharded render, and the v1, v2
and fusion MLPs; then resuming from the JAX package's `.msgpack`
snapshots, the batch driver, the validation panels and the reference
helpers; then the DTU path from files: the port's DTU scene writer, every
DTU CLI at 640x512, LPIPS on the card and the post-hoc metric tool.

  1. device: the card's name and power limit (nvidia-smi); exits non-zero
     when torch sees no CUDA device;
  2. build: compiles the hand-written kernels under
     mvsnerf_tpu_torch/csrc/ (nvcc, sm_90a) and prints ptxas's register,
     spill and shared-memory report, the render body's dynamic shared
     memory and the tensor-core instructions (HMMA) in its SASS
     (cuobjdump), which must be there in all three forms and in K7's
     forward, delta and dW kernels;
  3. kernels: K1 (sweep), K4 (colour warp) and K6 (fused render) against
     their plain PyTorch twins on the path's own inputs, at the path's
     shapes (a 41x128x176x208 cost volume, 16384 rays x 128 samples),
     with max abs error and CUDA-event times of kernel and twin (and for
     K4 of one `F.grid_sample` of the 3 views on its grid and K4's masks
     against the twin's; for K6 its and the f32 twin's distance from a
     float64 run of the twin, and its bound at the TF32 tensor-core peak
     for its 3 passes beside the f32 one; the device times of K1, K4,
     `F.grid_sample` and K6, from `torch.profiler`, are taken on the same
     inputs after phase 10);
  4. slice: `Evaluator.build_volume` -> a (128, 176, 208, 8) volume, then
     3 full 640x512 requests at 128 samples, each rendered in 'chunked'
     (K8) and 'hybrid' (K6) mode; checks finiteness, hybrid vs chunked rgb
     (K6 against K8), and that every kernel ran in this phase (launch
     counters reset just before), K10 4 / 3 / 3 / 0 times (s1 / s2 / up /
     wgrad) in the build;
  5. small-input parity: the same evaluator on a 64x96 toy scene on the
     card and on the CPU (whose wrappers run the plain twins), in all
     three render modes;
  6. fine-tune: `FinetuneSystem` from a reference-format checkpoint of the
     same seeded weights, on an in-memory scene of the same rig with 16
     random 640x512 training views (5.2M rays, no files), volume
     (128, 176, 208, 8), batch 1024, 128 samples, perturb 1.0:
     (a) one step on the kernels and one on the twins from the same
     state; (b) 36 steps of `fit` (launch counters reset just before),
     timed over the last 30; (c) K5 (volume gather / splat) and K7 (v0 MLP
     forward / backward) against their plain twins at the step's own
     shapes, with CUDA-event and `torch.profiler` device times of kernel
     and library call, and the share of the splat's corner adds merged
     into the next sample's atomic (the kernel's count, which must be its
     rule's, `splat_merges`); K7 also against a float64 run of its twin at
     the step's N and at a ragged N, its weight streams against their
     Python packings, dW bit-identical over two calls, its saved floats a
     sample, its forward with and without saving them, its wrapper's host
     time and its bound in 3xTF32 beside the f32 one; (d)
     `torch.profiler` over 3 steps: device time by kernel group. No
     profile is taken before (b): `torch.profiler` can leave CUPTI
     attached to the process and slow every later launch on the host, and
     the step is host-bound;
  7. generalizable training: `GeneralizableSystem` from a
     reference-format checkpoint of the same weights, its U-Net on cuDNN
     (`--costreg_impl plain`), on bench.py's
     generalizable batch (4 random 640x512 views of the rig, the last the
     target, random depths in [2, 5]), batch 1024, 128 samples, pad 24,
     128 planes, depth loss: (a) K2 (the sweep backward) against its plain
     twin on the cotangent that reaches the sweep in the trainer's own
     graph, read in place in the layout it arrives in (K3'), and on the
     same cotangent in channels_last_3d, with event and device times of
     both, the share of its taps that fall outside its shared-memory
     windows, and K1's device time on the same sources; (b) one step's MLP, CostRegNet
     and FeatureNet gradients on the kernels, on the twins and on the
     twins in float64, from one state and draws; (c) 12 steps of `fit`
     (launch counters reset just before), timed over the last 10:
     generalizable_train_step_ms and peak memory; (d) the step with K7
     against the step with the module's MLP, and with cuDNN's autotuner;
     (e) `torch.profiler` over 2 steps: device busy share, time by stage
     and each stage's largest kernels, and that no operation copied a
     cost-volume-sized tensor (the U-Net reads K1's output in place);
  8. the default route, phase 7's configuration with no `--costreg_impl`,
     which must resolve `auto` to `dband` (K10) on the card:
     (a) each K10 kernel (conv3d_fwd at stride 1 and 2, conv3d_up,
     conv3d_wgrad) against its plain twin on the inputs one step gives it,
     layer by layer in each direction (forward, dgrad, wgrad), with
     CUDA-event times of the kernel, the twin and cuDNN's call, and the
     device times of kernel and cuDNN for every call; (b) one
     step's gradients on K10 against a float64 run of the twins; (c) 12
     steps of `fit` (launch counters reset just before), timed over the
     last 10, next to phase 7's, with K10's launches 8 / 6 / 6 / 10 a step;
     (d) `Evaluator(costreg_impl="auto").build_volume` against
     `costreg_impl="plain"`'s volume; (e) the profile of 2 steps: no
     library convolution in the U-Net's stages, no cost-volume-sized copy;
  9. the colour-baked volume and the eval and video entry points: (a) K6b
     (the baked render) and K8 (PE + MLP + compositing from gathered
     features) against their twins on one 16384-ray chunk at 128 samples
     over the baked (128, 176, 208, 20) volume, with the bake's time,
     CUDA-event and device times, and, as for K6, the float64 distances
     and both bounds; K11 (the v1 attention MLP's render body, a seeded
     v1 MLP) on K8's gathered features, at the view cell's 5120-ray chunk
     and at 16384 rays, the same way (its launches are phase 14(c)'s); (b)
     `Evaluator` in all three modes, 3 requests each (ms/request, rays/s),
     the `tiled` request against its twin path on the same baked volume,
     launches of K4, K6, K6b and K8; (c) `Evaluator.evaluate` on an
     in-memory DTU-like dataset of 2 views with GT depth, in each mode;
     (d) `FinetuneSystem --use_color_volume`: K5 forward and backward at
     C=20 against their twins (and the splat's merged share), one step on
     the kernels against one on the twins, 36 steps of `fit` timed over
     the last 30, and no MVSNet parameter in Adam; (e) `render_video`: 3
     frames of 640x512 through `render_image` in the `tiled` mode, kept in
     memory;
 10. the render's gradient in its source images, at phase 6's
     configuration with the images made leaf tensors that require grad:
     (a) K4's backward against its twin on the cotangent that reaches the
     warp in the fine-tune loss's own graph (a hook on the warp's output),
     held to a float64 run of the twin, with CUDA-event times of kernel,
     twin and `grid_sampler_2d_backward` (the 3 views on K4's grid, border
     padding), their device times (`torch.profiler`: by kernel, and of
     the kernel on each view alone), and the same on one 16384 x 128
     serving chunk and on one 16384 x 128 chunk whose samples all lie
     outside view 2 (rays through its centre right of its frame, so every
     sample clamps onto its border column); (b) d loss /
     d imgs of the fine-tune loss through `render_rays(training=True)`
     (K4, K5, K7 forward and backward), from one state and draws, on the
     kernels, on the twins and on the twins in float64 (launch counters
     reset just before the kernels' run); (c) K4's backward launched in
     this phase and in no earlier one (no trainer reaches it, and the
     forward-only route is unchanged); (d) asking the card for d pts_world
     raises;
 11. the density volume and importance sampling, at phase 6's
     configuration with `--use_density_volume --N_importance 64` (S =
     192): (a) `update_density_volume` over the (128, 176, 208) voxels,
     CUDA-event ms against its bound, 65,536 of its voxels against a
     float64 run of `render_density` (TOL_DENSITY); (b) one step on the
     kernels against one on the twins from one state; (c) 36 steps of
     `fit` (refreshing at step 0; launch counters reset just before),
     timed over the last 30, beside phase 6's step; (d) K5 and K7 against
     their twins at the step's S = 192 shapes, K6b and K8 on one
     16384-ray chunk of the tiled render's samples (importance depths from
     a generator seeded 1) against their twins and float64; (e) one
     640x512 `render_image` in the `tiled` and one in the `chunked` mode
     with the density volume: finite, K6b / K8 launched; (f) one step
     with `--use_disp` (MVSNet's planes, the samples and NDC linear in
     disparity) on the kernels against the twins;
 12. fusion, on an in-memory scene of 16 random 640x512 views in an arc
     (their cameras, `pair_idx`, the DTU box): `FusionFinetuneSystem`
     fuses each view's local volume (MVSNet over its 3 nearest views, its
     rays at 160x128 with 128 samples through K4 and K8 with alpha, K5's
     splat of 24 channels) into the (128, 128, 128, 20) grid. (c) the
     first 2 views fused on the kernels against the twins (TOL_FUSE /
     FUSE_FLOOR), then `fuse_local_volumes` over all 16 views with its
     launch counters reset just before, timed with events (fuse ms) with
     its share per stage (MVSNet, local render, splat); (d) one step on
     the kernels against one on the twins, 36 steps of `fit` timed over
     the last 30 (K5 and K7 must launch), one step with `--N_importance
     64` against the twins; (e) one 640x512 `render_image` in the tiled
     mode (K6b in box coordinates) and one in the chunked mode (K5 + K8)
     at perturb 0, against each other, then 3 `render_video` frames; (a)
     K8 with alpha on one local-render chunk and (b) the fuse's masked K5
     splat on one view's 24-channel values against their twins, with the
     samples JAX's rule dropped and the splat's merge counters, K5 over
     the fused volume and K6b in box coordinates, with event and device
     times; (f) the fuse on `--costreg_impl dband`, timed, and its first 2
     views under `torch.profiler`: K10's launches, no library convolution
     or GEMM in their U-Nets, and the fuse against the cuDNN one;
 13. the Blender and LLFF datasets at their published resolutions, on
     scenes written by `mvsnerf_tpu_torch.data.synthetic` into a temporary
     directory: NeRF-synthetic `lego` at 800x800 (RGBA PNGs of the 20
     frames its pair table names, blended onto white, `--white_bkgd`) and
     LLFF `fern` at 960x640 (20 images, a forward-facing
     `poses_bounds.npy`). For each: (a) the loaders (train and val splits,
     the source views); (b) `Evaluator.build_volume` on cuDNN (`plain`)
     and on dband (K10's generic stride-2 route at Blender's width 62, its
     pair route at LLFF's), held to each
     other as in phase 8d and timed; (c) one fine-tune step on the kernels
     against one on the twins, then 36 steps of `fit` timed over the last
     30 (ms/step, rays/s); (d) one full-resolution request in each of the
     chunked, hybrid and tiled modes after a first one, hybrid held to
     chunked as in phase 4; (e) the CLIs `train_finetune` (3 steps, then
     the 4 val views), `evaluate --render_mode hybrid` (K10 on the
     default route) and `render_video --render_mode tiled` (3 frames from
     the fine-tune's snapshot), run from the temporary directory; (f) the
     launches of K1, K4, K5, K6, K6b, K7, K8 and K10's stride-2 route of
     the dataset (generic for Blender, pair for LLFF) over (b)-(e); (g) `native.available()`, the
     fit's batches counted at `native.ray_gather`, and its time a batch
     beside numpy's; then `torch.profiler` over 3 steps. Then K1 at each
     dataset's volume and K10's generic stride-2 call against their twins
     and cuDNN, and `torch.profiler` over a volume build on each route and
     a chunked and a tiled request.
 14. data parallelism and the MLPs other than v0: (a) NCCL at world size 1
     (a `file://` store): one generalizable step at phase 7's
     configuration through `parallel/`'s all-reduce against today's step
     from one state and draws (the all-reduce must leave every gradient
     bit-equal; the steps are held to STEP_TOL and TOL_STEP_GRAD where
     they are not bit-equal), 10 steps of each in turns, the all-reduce's
     device time and byte count, and `fit` on the path with its launches;
     (b) two gloo ranks on the one card (spawned processes; gloo
     all-reduces CUDA tensors through the host): 3 steps of `fit`, the
     first step's averaged gradients against both ranks' recomputed in one
     process from the same draws (TOL_STEP_GRAD), the parameters
     bit-equal on both ranks, and `shard_rays_render` of one 640x512
     request against rank 0's one-process chunked render (TOL_K6); (c)
     the v1, v2 and fusion MLPs at full width: a 640x512 chunked request
     each (K1, K4, and K11 for v1, once a chunk, or the module's MLP for
     v2 and fusion) held to the same request on the twins of K4 and K11
     (the module's forward), 10 timed `--net_type v2` fine-tune steps (K4,
     K5 and the module's MLP under autograd), `evaluate --net_type v2`
     through the CLI on an LLFF scene at 960x640 (and its `tiled` mode
     refused); K6, K6b, K7 and K8 never launch for these MLPs, nor K11
     for v2 and fusion.
 15. the JAX package's `.msgpack` snapshots, the batch driver, the
     generalizable validation panels and the reference helpers: (a)
     phase 6's fine-tune at full width, 5 steps, its state written as a
     `.pt` (`save`) and as JAX's `.msgpack` (`write_jax_snapshot`, ~450
     MB), each restored into a fresh system; every parameter, moment, Adam
     step, lr and the global step bit-equal across the two and to the
     writer's; 3 steps from each held to each other (STEP_TOL,
     TOL_STEP_GRAD, as a step against its twins); encode and restore times
     and the files' sizes; again with `--use_color_volume` (C = 20, ~1.1
     GB, no MVSNet in Adam); (b) the same for phase 7's generalizable step
     (2 steps of a 10-step schedule, then 2 from each on the same draws)
     and phase 12's fused (128, 128, 128, 20) volume (one step each way);
     (c) `run_batch.scene_commands` for Blender `lego` at 800x800 (written
     into a temporary directory with a seeded reference checkpoint), run as
     two processes side by side on the card from that directory (the
     evaluation reads the reference checkpoint, not the fine-tune's
     output), the fine-tune cut to
     RUN_BATCH_STEPS steps by an appended `--max_steps` (the phase's only
     cut): both exit 0, the snapshot, `metrics.json` and the CSV's
     val/PSNR exist, their walls, whether TensorBoard events were written;
     then `render_video --render_mode tiled` from that run's snapshot
     written as JAX's `.msgpack`: the step restored, CLI_FRAMES finite
     frames; (d) `train_mvs_nerf.validate` on phase 7's system and a
     640x512 sample: the `val_00` panel, 3 x 640 wide, and val/PSNR; (e)
     `build_rays_test` and `build_rays_train` (the same CPU generator's
     draws) at 640x512, `sweep_side_outputs` and `build_cost_volume_feat`
     at DTU width and `gen_angle_feature` on the card against the CPU
     (1e-5 of the CPU's max; mask flips counted, only at the border); the
     launches of K1, K2, K4, K5, K6b, K7 and K8 in the phase's process.
 16. the DTU path from files at bench.py's DTU geometry (640x512,
     `--imgScale_train 1.0 --imgScale_test 1.0 --pad 24`, 128 planes and
     samples, batch 1024), run from a temporary directory that is removed
     at the end: (a) `write_dtu_multiscan` writes the first scan of the
     packaged train list with 640x512 PNGs (49 views x 7 lights, 49
     1200x1600 depth maps) and its `scans.txt`: seconds and bytes; (b)
     `train_mvs_nerf --dataset_name dtu --with_depth_loss` for GEN_WARM +
     GEN_TIMED steps and one validation panel: ms/step over the last
     GEN_TIMED beside phase 8's in-memory step, and the share of those
     steps' wall spent in the `dtu` loader's `__getitem__` (4 PNGs and 4
     1200x1600 depth maps a sample); (c) `train_finetune --dataset_name
     dtu_ft` for FT_WARM + FT_TIMED steps, then its 4 val views: the
     loader's seconds (16 views, 5.2M rays) and ms/step over the last
     FT_TIMED beside phase 6's; (d) `evaluate --render_mode chunked` on the
     4 test views with LPIPS weights converted by the port's
     `convert_lpips_weights` from seeded state dicts: finite PSNR, SSIM,
     LPIPS in `metrics.json`; (e) `render_video --render_mode tiled` from
     (c)'s `.pt` snapshot (4 frames: the path's 4 key poses at
     CLI_FRAMES // 3 frames each); (f) `LPIPS(npz)`, on the card by
     default, against `LPIPS(npz, "cpu")` on (d)'s first prediction and
     ground truth (TOL_LPIPS relative), and its ms a call; (g)
     `metrics_from_panels` over (d)'s panels on the card against
     `--device cpu` (TOL_PANEL_PSNR, TOL_PANEL_SSIM, TOL_LPIPS), and its
     mean's distance from (d)'s in-loop metrics (the PNGs' quantisation,
     not held to a bound). Each CLI's launches are checked (K1, K2, K4,
     K5, K7, K8 in (b); K1, K4, K5, K7, K8 in (c); K1, K4, K8 in (d); K1,
     K6b in (e)) and added to the kernels line's counts.

A failed comparison is reported and the remaining phases still run; the
script then exits non-zero without the result lines. Other errors raise.
On success the last two lines are one JSON object of per-kernel results
(error against the plain twin, kernel, twin and library-call times, device
times where measured, the bound the card's peaks set, launches on the
kernel's path) and
`{"ok": true, "device": {...}}`.
"""

import contextlib
import copy
import importlib.util
import io
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
# K4 backward: its f32 atomics add each pixel's gradient in an order that
# changes from run to run. Held to a float64 run of the twin by
# TOL_K7_BWD's rule: |kernel - twin| <= TOL_K4_BWD x max(|twin - float64|,
# 1e-6 x max|float64|).
TOL_K4_BWD = 5.0
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
# phase 9: K6b and K8 against their twins at TOL_K6 (f32 sums in another
# order, no early stop on either side); the in-memory eval dataset's views
# and the video's frames
EVAL_VIEWS, VIDEO_FRAMES = 2, 3
# phase 8, the default route (K10) at phase 7's configuration. Forward and
# dgrad against the twin: x (1 + max|twin|). The weight gradient sums up to
# 4.7M products in another order than the twin's: held to a float64 run of
# the twin by TOL_K7_BWD's rule.
TOL_K10 = 1e-5
# the U-Net's layers in the order of its forward
K10_LAYERS = (("conv0", "s1"), ("conv1", "s2"), ("conv2", "s1"),
              ("conv3", "s2"), ("conv4", "s1"), ("conv5", "s2"),
              ("conv6", "s1"), ("conv7", "up"), ("conv9", "up"),
              ("conv11", "up"))
# K10 launches per dband step: conv3d_fwd at stride 1 (4 forward + 4
# dgrad) and stride 2 (3 forward + the 3 up layers' dgrad), conv3d_up (3
# forward + the 3 s2 layers' dgrad), conv3d_wgrad (10)
K10_PER_STEP = {"s1": 8, "s2": 6, "up": 6, "wgrad": 10}
# and per volume build (the forward alone)
K10_PER_BUILD = {"s1": 4, "s2": 3, "up": 3, "wgrad": 0}
# launch key -> entry name and the TPU kernel it replaces (the wgrad entry
# replaces _s1_wgrad_dband :597 and _s2_wgrad_dband :707)
K10_ENTRIES = {
    "s1": ("K10 conv3d_s1", "mvsnerf_tpu/ops/pallas_costreg.py:210"),
    "s2": ("K10 conv3d_s2", "mvsnerf_tpu/ops/pallas_costreg.py:337"),
    "up": ("K10 conv3d_up", "mvsnerf_tpu/ops/pallas_costreg.py:480"),
    "wgrad": ("K10 conv3d_wgrad", "mvsnerf_tpu/ops/pallas_costreg.py:597")}
# convolution kernels of a library (cuDNN's fprop, dgrad and wgrad engines)
# by name fragment, not cuBLAS's GEMMs ("xmma_gemm"); K10's own names
# contain "conv3d_" or "wgrad_reduce"
CONV_LIBRARY_NAMES = ("conv", "fprop", "dgrad", "wgrad", "implicit",
                      "winograd")
# phase 11, the density volume: importance samples a ray beside phase 6's
# N_SAMPLES, and the voxels of the refresh held to a float64 run. The
# refresh runs the MLP's alpha head in f32 layers (TF32 off) on the same
# float32 points and features as the float64 run: the sums of 6 layers of
# 128 and the PE's sines differ by ~1e-6 of their size, so TOL_DENSITY x
# (1 + max|sigma|) leaves a tenfold margin
N_IMPORTANCE, DENSITY_HELD, TOL_DENSITY = 64, 65536, 1e-5
# phase 12, fusion: 16 training views fused into the (128, 128, 128, 20)
# volume in the DTU box; the first FUSE_HELD views also fused on the twins.
# The kernels' fuse against the twins': each accumulator channel within
# TOL_FUSE x max|twin| of that channel (K8 and MVSNet's K1 differ from
# their twins by float32 sums in other orders, the splat's atomics add in
# an order that changes from run to run); the normalised volume and
# density, acc / (weight + 1e-6), divide those differences by the weight,
# so they are held to TOL_FUSE x (1 + max|twin|) only where the weight
# exceeds FUSE_FLOOR (one sample's whole trilinear weight) and the voxels
# below it are counted. The tiled and chunked renders agree to TOL_MODES.
FUSE_VIEWS, FUSE_HELD, TOL_FUSE, FUSE_FLOOR = 16, 2, 1e-3, 1.0
# the seeded MLP's density bias is -0.012 and its density hardly depends
# on small features: on the fused volume, whose features are the local
# renders' times their weights (|f| < 0.2 here), its ReLU is dead at every
# sample and every gradient of the step is zero. Phase 12 sets that bias to
# +0.05, one standard deviation of its draw, so that the step has gradients
FUSE_SIGMA_BIAS = 0.05
FUSE_BOX = ((-1.0, -1.0, 2.2), (1.0, 1.0, 4.2))  # data/dtu_ft.py's DTU box
# phase 13: the Blender and LLFF datasets at their published resolutions on
# scenes written by mvsnerf_tpu_torch.data.synthetic; the fine-tune CLI
# takes CLI_STEPS steps, the video CLI renders CLI_FRAMES frames
DATASET_WH = {"blender": (800, 800), "llff": (960, 640)}
CLI_STEPS, CLI_FRAMES = 3, 3
# volume builds timed a route after the counted one
BUILD_AGAIN = 2
# phase 14: data parallelism at phase 7's configuration (DP_TIMED steps a
# way, in turns; DP_RANKS gloo ranks on the one card for DP_STEPS steps),
# and the MLPs other than v0 at phase 6's width (MLP_STEPS timed fine-tune
# steps)
DP_TIMED, DP_RANKS, DP_STEPS, MLP_STEPS = 10, 2, 3, 10
MLP_TYPES = ("v1", "v2", "fusion")
# the benchmark's view chunk (the evaluate CLI's --chunk 1024 x 5), at
# which phase 9 holds K11 to its twin besides CHUNK
VIEW_CHUNK = 5120
# phase 15: run_batch's fine-tune of one scene is cut to RUN_BATCH_STEPS
# steps (its only cut; the reference runs 10,000). Two generalizable
# systems restored from one snapshot take bit-equal-state first steps
# (within TOL_STEP_GRAD); after it their states part by the atomics' and
# cuDNN's summation order, which batch-statistics norms and Adam's eps
# amplify: the second step's gradients then lie 3.4e-4 to 2.2e-3 x
# max|g| apart (PR 17's runs, the .msgpack and the .pt route alike), and
# are held to TOL_RESUMED_GRAD x max|g|
RUN_BATCH_STEPS, TOL_RESUMED_GRAD = 200, 1e-2
# phase 16: the DTU path from files at bench.py's DTU geometry, on one
# scan that `write_dtu_scene` writes with 640x512 PNGs (the generalizable
# loader reads them at their own size). Its only cuts are the step counts:
# the generalizable CLI takes GEN_WARM + GEN_TIMED steps and the fine-tune
# CLI FT_WARM + FT_TIMED, timed over the last GEN_TIMED / FT_TIMED as
# phases 7 and 6 time theirs. LPIPS on the card against the CPU, relative:
# VGG16 in float32 with TF32 off on both, so only the order of the sums
# differs. metrics_from_panels on the card against --device cpu: PSNR in
# dB, SSIM absolute, LPIPS relative
DTU_HW, DTU_SEED = (512, 640), SEED + 16
TOL_LPIPS, TOL_PANEL_PSNR, TOL_PANEL_SSIM = 1e-5, 1e-4, 1e-5
# phase 16's launch counters -> the kernels line's entries they add to
DTU_ENTRIES = {"K1": "K1 sweep_cost_volume",
               "K2": "K2 sweep_cost_volume (bwd)",
               "K4": "K4 color_warp", "K5 fwd": "K5 volume_gather (fwd)",
               "K5 bwd": "K5 volume_splat (bwd)",
               "K6b": "K6b render_v0 (baked)", "K7 fwd": "K7 mlp_v0 (fwd)",
               "K7 bwd": "K7 mlp_v0 (bwd)", "K8": "K8 render_v0_feats"}


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
    return float((a - b).abs().max()) if a.numel() else 0.0


# the H100's published peaks (NVIDIA's data sheet, SXM part, at 700 W):
# device-memory bytes/s, float32 FLOP/s outside the tensor cores and dense
# TF32 FLOP/s on them
HBM_BYTES_PER_S, F32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
# tensor-core passes of the render body's MLP and K7's (3xTF32,
# csrc/mlp_tc.cuh)
RENDER_TC_PASSES = 3
# K7's kernels that run products on the tensor cores (csrc/mlp_v0_train.cu)
K7_TC_KERNELS = ("mlp_fwd_kernel", "mlp_delta_kernel", "mlp_dw_kernel")
# K10's kernels on the tensor cores (stride 1 and every weight gradient)
K10_TC_KERNELS = ("conv3d_s1_tc_kernel", "conv3d_wgrad_tc_kernel")


def sass_mma_counts(lib_path):
    """Tensor-core instructions (HMMA, HGMMA) in each kernel of the built
    library, by mangled name, from cuobjdump's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", lib_path], capture_output=True, text=True,
                         timeout=300)
    require(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, tc_passes=0):
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the
    memory rate and its operations over the f32 peak, or, for a kernel
    that runs them on the tensor cores in `tc_passes` TF32 passes, those
    passes' operations over the TF32 peak (the f32 bound then beside it as
    `bound_f32_ms`)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f32 = flops / F32_FLOPS * 1e3
    t_ops = tc_passes * flops / TF32_FLOPS * 1e3 if tc_passes else t_f32
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if tc_passes:
        out["bound_f32_ms"] = max(t_bytes, t_f32)
    return out


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
        dev = ""
        if "bound_f32_ms" in k:
            dev += (f" ({RENDER_TC_PASSES}xTF32; f32 bound "
                    f"{k['bound_f32_ms']:.4f} ms)")
        if "max_abs_err_f64" in k:
            dev += (f"; vs a float64 twin: kernel {k['max_abs_err_f64']:.3e}"
                    f", f32 twin {k['plain_err_f64']:.3e}")
        if k.get("device_ms") is not None:
            dev += f"; device (torch.profiler) kernel {k['device_ms']:.4f} ms"
            if k.get("device_library_ms") is not None:
                dev += f", library {k['device_library_ms']:.4f} ms"
            dev += (f"; events - device {k['ms'] - k['device_ms']:.4f} "
                    f"ms")
        print(f"[{phase} kernel] {k['name']}: max_abs_err "
              f"{k['max_abs_err']:.3e} (tol {k['tol']:.1e}), kernel "
              f"{k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, library "
              f"{lib}, bound {k['bound_ms']:.4f} ms ({k['bound_by']})"
              f"{dev}")
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
        self.c2ws = np.stack([np.linalg.inv(pose(0, 0.01 * off, 0.02 * off))
                              for off in range(-2, 3)])

    def read_source_views(self, pair_idx=None):
        return self.imgs_norm, self.projs, list(NEAR_FAR), self.pose_source

    def load_poses_all(self):
        """Camera-to-world poses for the video's `interp` path."""
        return self.c2ws


class StepClock:
    """A `fit` logger that notes the host clock at each logged step; the
    log reads the loss, so the device has finished that step."""

    def __init__(self):
        self.marks = {}

    def log_scalars(self, step, scalars):
        self.marks[step] = time.perf_counter()


def kernel_entry(kernels, name, source, replaces, err, tol, fn_k, fn_p,
                 fn_lib, n_bytes, flops, tc_passes=0, **extra):
    """Append one kernels-line entry: the error against the twin, CUDA-event
    times of kernel, twin and library call, the device times of kernel and
    library call (torch.profiler), and the bound."""
    kernels.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, max_abs_err=err, tol=tol,
                        ms=cuda_ms(fn_k), plain_ms=cuda_ms(fn_p),
                        library_ms=fn_lib and cuda_ms(fn_lib),
                        # None where the profiler saw no device activity
                        # (it can lose a short call's every launch)
                        device_ms=device_total(fn_k) or None,
                        device_library_ms=fn_lib and (device_total(fn_lib)
                                                      or None),
                        **bound(n_bytes, flops, tc_passes), **extra))


def f64_anchor(out_k, out_p, run_f64):
    """The render forms' distance from a float64 run of their twin
    (`run_f64()`, on a float64 copy of the MLP), beside the f32 twin's own:
    the evidence for the 3xTF32 split."""
    ref = run_f64()
    keys = ("rgb", "depth", "acc")
    return {"max_abs_err_f64": max(max_err(out_k[k], ref[k]) for k in keys),
            "plain_err_f64": max(max_err(out_p[k], ref[k]) for k in keys)}


def k5_entries(kernels, v, ndc, gen, failures, suffix=""):
    """K5's forward and backward against their twins (and one 3-D
    grid_sample call and its backward, on the NCDHW volume laid out
    beforehand) on the (D, hp, wp, C) volume `v` at `ndc`; the share of
    the splat's corner adds that it merged into the next sample's atomic,
    which must be the count of its rule (`splat_merges`)."""
    import torch
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    src5 = "mvsnerf_tpu_torch/csrc/volume_gather.cu"
    rep5 = "mvsnerf_tpu/ops/pallas_volgather2.py:268"
    n5, c5 = ndc[..., 0].numel(), v.shape[-1]
    vol5 = v.permute(3, 0, 1, 2)[None].contiguous()
    grid5 = (ndc * 2 - 1).reshape(1, -1, 1, 1, 3)
    f_k, f_p = k5.volume_gather_kernel(v, ndc), \
        k5.sample_volume_plain(v, ndc)
    kernel_entry(kernels, f"K5 volume_gather{suffix} (fwd)", src5, rep5,
                 max_err(f_k, f_p), TOL_K5 * (1 + float(f_p.abs().max())),
                 lambda: k5.volume_gather_kernel(v, ndc),
                 lambda: k5.sample_volume_plain(v, ndc),
                 lambda: torch.nn.functional.grid_sample(
                     vol5, grid5, mode="bilinear", padding_mode="zeros",
                     align_corners=True),
                 touched_volume_bytes(v, ndc) + nbytes(ndc, f_k),
                 n5 * (30 + 8 * c5 * 2))
    g5 = torch.randn(f_p.shape, device=v.device, generator=gen)
    g5_lib = g5.reshape(-1, c5).t().reshape(1, c5, -1, 1, 1).contiguous()
    adds = torch.zeros(2, dtype=torch.int64, device=v.device)
    b_k = k5.volume_splat_kernel(g5, ndc, v.shape, adds=adds)
    b_p = k5.volume_splat_plain(g5, ndc, v)
    n_add, n_merged = adds.tolist()
    rule = k5.splat_merges(ndc, v.shape)[1]
    print(f"   K5{suffix} splat: {n_merged} of {n_add + n_merged} corner "
          f"adds ({n_merged / max(1, n_add + n_merged):.2%}) merged into the "
          f"next sample's atomic, {n_add} atomics; the rule counts {rule}")
    check((n_add, n_merged) == rule,
          f"K5{suffix}'s splat merged other corners than its rule", failures)
    v_r = v.clone().requires_grad_()
    kernel_entry(kernels, f"K5 volume_splat{suffix} (bwd)", src5, rep5,
                 max_err(b_k, b_p), TOL_K5 * (1 + float(b_p.abs().max())),
                 lambda: k5.volume_splat_kernel(g5, ndc, v.shape),
                 grad_only(lambda: k5.sample_volume_plain(v_r, ndc), v_r,
                           g5),
                 lambda: torch.ops.aten.grid_sampler_3d_backward(
                     g5_lib, vol5, grid5, 0, 0, True, [True, False]),
                 nbytes(g5, ndc, b_k), n5 * (30 + 8 * c5 * 2))


def k4_library_inputs(pts, w2cs, intrs, imgs):
    """The images as (V, 3, H, W) and K4's own sampling grid as
    (V, N*S, 1, 2): the inputs of one `grid_sample` (or its backward) over
    the V views, the library call that computes K4's RGB."""
    from mvsnerf_tpu_torch.ops.color_warp import color_warp_grids
    V, H_, W_, _ = imgs.shape
    grids = color_warp_grids(pts, w2cs, intrs, H_, W_)
    return (imgs.permute(0, 3, 1, 2).contiguous(),
            grids.reshape(V, -1, 1, 2).contiguous())


def k1_inputs(ev, src, near_far=NEAR_FAR):
    """K1's arguments on the serving path: the (3, h, w, 35) [feat | rgb]
    sources of `src` (images, projections, poses), the projections, the
    128 plane depths over `near_far`, the pad and the feature width."""
    import torch
    from mvsnerf_tpu_torch.models.mvsnet import depth_plane_values
    from mvsnerf_tpu_torch.ops.interp import interpolate_bilinear_resize
    imgs_norm, projs, _ = src
    dev = ev.device
    imgs_t = torch.tensor(imgs_norm, device=dev)
    feats = ev.mvsnet.feature(imgs_t)
    h4, w4 = feats.shape[1:3]
    imgs_l = torch.stack([interpolate_bilinear_resize(im, h4, w4)
                          for im in imgs_t])
    srcs = torch.cat([feats, imgs_l], dim=-1).contiguous()
    nf = torch.tensor(near_far, device=dev)
    return (srcs, torch.tensor(projs, device=dev),
            depth_plane_values(nf[0], nf[1], N_PLANES, device=dev), PAD, 32)


def k6_inputs(ev, mlp, src, requests):
    """Phase 3's K6 arguments: the first 16384 rays of request 1 at 128
    samples over the scene's (128, 176, 208, 8) volume, with K4's colours
    of the 3 views."""
    import torch
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu_torch.ops.sampling import ray_marcher
    from mvsnerf_tpu_torch.render.renderer import gen_dir_feature
    volume, imgs01, nf, pose_t = ev.build_volume(src[0], src[1], NEAR_FAR,
                                                 src[2])
    w2cs, intrs = pose_t["w2cs"], pose_t["intrinsics"]
    pts, _, rays_d, z_vals = ray_marcher(requests[1][:CHUNK], N_SAMPLES)
    colors = color_warp(pts.contiguous(), w2cs, intrs, imgs01.contiguous())
    ndc = get_ndc_coordinate(w2cs[0], intrs[0], pts,
                             torch.tensor([W - 1.0, H - 1.0],
                                          device=pts.device),
                             near=nf[0], far=nf[1], pad=PAD)
    unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return (ndc.contiguous(), z_vals.contiguous(), colors,
            gen_dir_feature(w2cs[0], unit).contiguous(), volume, mlp)


def k4_device_times(imgs01, pose_t, requests):
    """Device ms of K4's forward and of its library call (`F.grid_sample`
    of the 3 views on K4's grid) on phase 3's inputs: the serving scene's
    images and cameras and the first chunk of the second request."""
    import torch
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.sampling import ray_marcher
    with torch.no_grad():
        pts = ray_marcher(requests[1][:CHUNK], N_SAMPLES)[0].contiguous()
        k4 = (pts, pose_t["w2cs"], pose_t["intrinsics"],
              imgs01.contiguous())
        inp, grid = k4_library_inputs(*k4)
        return dict(
            device_ms=device_total(lambda: color_warp(*k4)),
            device_library_ms=device_total(
                lambda: torch.nn.functional.grid_sample(
                    inp, grid, mode="bilinear", padding_mode="border",
                    align_corners=True)))


def save_seeded_checkpoint(path, mlp, mvsnet):
    """Write the seeded weights as a reference-format checkpoint at `path`
    (the `--ckpt` the trainers and CLIs read); returns the path."""
    import torch
    torch.save({"global_step": 0, "network_fn_state_dict": mlp.state_dict(),
                "network_mvs_state_dict": mvsnet.state_dict()}, path)
    return path


def finetune_system(dev, mlp, mvsnet, scene, extra=""):
    """`FinetuneSystem` on `scene` from a reference-format checkpoint of
    the seeded weights, at phase 6's flags plus `extra`."""
    import tempfile

    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_seeded_checkpoint(os.path.join(tmp, "seeded.tar"), mlp,
                                      mvsnet)
        args = config_parser(
            f"--dataset_name dtu_ft --with_rgb_loss --pad {PAD} "
            f"--batch_size {FT_BATCH} --N_samples {N_SAMPLES} --ckpt {ckpt} "
            f"{extra}")
        return FinetuneSystem(args, scene, device=dev)


def step_parity(phase, system, rays, rgbs, gen, failures):
    """One step on the kernels and one on the twins from the same state;
    samples within KINK of a ReLU kink are left out of the volume's
    gradient check and eps-sized gradients held to Adam's bound. Returns
    the twins' mean step ms (5 steps), the state restored."""
    import torch
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    lrate = system.args.lrate
    state0 = copy.deepcopy(system.state(0))
    after = {}
    for twins in (False, True):
        # a copy each time: Adam's loaded moments are the state dict's own
        # tensors, which its step then updates in place
        system.load_state(copy.deepcopy(state0))
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
    system.load_state(copy.deepcopy(state0))
    gen.manual_seed(SEED + 1)
    x = system.mlp_input(rays, gen)
    kink = (k7.relu_margin(system.mlp, x) <= KINK).float()
    reached = k5.volume_splat_plain(
        kink.reshape(x.shape[0], x.shape[1], 1)
        .expand(-1, -1, system.volume.shape[-1]).contiguous(),
        x[..., :3].contiguous(), system.volume) != 0
    k, p = after[False], after[True]
    check(all(float(p[f"g_{n}"].abs().max()) > 0 for n in ("volume", "mlp")),
          f"[{phase}] the step has no gradient in the volume or the MLP",
          failures)
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
        check(max_err(k[n], p[n]) <= 2 * lrate and
              bool(torch.equal(k[n][still], p[n][still])),
              f"[{phase}] the kernel step and the plain step update {n} "
              "apart", failures)
    step_tol = STEP_TOL * lrate
    print(f"[{phase} step] kernels vs twins from one state: loss "
          f"{k['loss']:.6f} / {p['loss']:.6f} (rel {loss_rel:.2e}, tol "
          f"1e-5); gradient max diff volume {g_err['volume']:.2e} (tol "
          f"{g_tol['volume']:.1e}; {int(kink.sum())} samples at a ReLU "
          f"kink reach {int(reached.sum())} volume values, left out), MLP "
          f"{g_err['mlp']:.2e} (tol {g_tol['mlp']:.1e}); update max diff "
          f"where |g| > 1e-7: volume {u_err['volume']:.2e}, MLP "
          f"{u_err['mlp']:.2e} (tol {step_tol:.1e})")
    check(loss_rel <= 1e-5 and all(g_err[n] <= g_tol[n] for n in g_err)
          and all(e <= step_tol for e in u_err.values()),
          f"[{phase}] the kernel step and the plain step disagree", failures)
    system.load_state(state0)
    del state0, after, k, p, x, kink, reached
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        system._step(rays, rgbs, gen, twins=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / 5


def timed_fit(phase, system, counters, plain_step_ms, failures):
    """The main path: `fit` for FT_WARM + FT_TIMED steps, launch counters
    reset just before, timed over the last FT_TIMED; returns the launches
    and ms/step."""
    import torch
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
    print(f"[{phase} fit] {len(losses)} steps, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; steps {first + 1}-{last}: {step_ms:.2f} "
          f"ms/step, finetune_train_rays_per_sec_per_chip "
          f"{FT_BATCH / step_ms * 1e3:.0f}; plain-twin step "
          f"{plain_step_ms:.2f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches {launches}")
    check(len(losses) == FT_WARM + FT_TIMED and
          all(math.isfinite(v) for v in losses),
          f"[{phase}] fit returned a non-finite loss", failures)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the phase {phase} fine-tune "
              "path", failures)
    return launches, step_ms


def first_batch(scene, dev):
    """The first batch `fit` draws (RayBatchIterator at SEED)."""
    import torch
    from mvsnerf_tpu_torch.train.common import RayBatchIterator
    batch = next(RayBatchIterator({"rays": scene.all_rays,
                                   "rgbs": scene.all_rgbs}, FT_BATCH,
                                  seed=SEED))
    return (torch.from_numpy(batch["rays"]).to(dev),
            torch.from_numpy(batch["rgbs"]).to(dev))


def step_ndc(system, rays, gen):
    """The step's (N, S, 3) sample NDC for `rays`, jittered from `gen`."""
    from mvsnerf_tpu_torch.render.renderer import sample_rays
    return sample_rays(
        rays, N_SAMPLES, system.pose_source["w2cs"][0],
        system.pose_source["intrinsics"][0], system.imgs.shape[1:3],
        system.near_far, PAD, perturb=system.args.perturb,
        generator=gen)[3].contiguous()


def k7_pair(x, g, m, m64, packed):
    """K7's forward and backward on (x, g) against the twins and a float64
    run of the twin: (scratch, forward error and tolerance, dW and d feats
    errors and tolerances (TOL_K7_BWD's rule), the kernel's outputs)."""
    import torch
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    scratch = k7.mlp_v0_scratch(len(x), x.device)
    o_k, o_p = k7.mlp_v0_fwd_kernel(x, packed, scratch), m(x)
    dx_k, dw_k = k7.mlp_v0_bwd_kernel(g, x, packed, scratch)
    dx_p, dw_p = k7.mlp_v0_bwd_plain(m, x, g)
    dx_64, dw_64 = k7.mlp_v0_bwd_plain(m64, x.double(), g.double())
    f = slice(63, 83)

    def tol64(plain, ref):
        return TOL_K7_BWD * max(max_err(plain.double(), ref),
                                1e-6 * float(ref.abs().max()))

    out = dict(
        scratch=scratch, o_k=o_k, dx_k=dx_k, dw_k=dw_k,
        fwd=(max_err(o_k, o_p), TOL_K7 * (1 + float(o_p.abs().max()))),
        dw=(max_err(dw_k, dw_p), tol64(dw_p, dw_64)),
        feat=(max_err(dx_k[:, f], dx_p[:, f]), tol64(dx_p[:, f],
                                                     dx_64[:, f])),
        zero=float(dx_k[:, :63].abs().max() + dx_k[:, 83:].abs().max()))
    print(f"   K7 at N={len(x)} vs float64: forward kernel "
          f"{max_err(o_k.double(), m64(x.double())):.3e}; dW kernel "
          f"{max_err(dw_k.double(), dw_64):.3e} / twin "
          f"{max_err(dw_p.double(), dw_64):.3e} (max |dW| "
          f"{float(dw_64.abs().max()):.3e}); d feats kernel "
          f"{max_err(dx_k[:, f].double(), dx_64[:, f]):.3e} / twin "
          f"{max_err(dx_p[:, f].double(), dx_64[:, f]):.3e}")
    return out


def k7_entries(kernels, x, m, gen, failures, suffix=""):
    """Phase 6c's K7: forward and backward against their twins and a
    float64 run of the twin at the step's x and at a ragged N, the weight
    streams against their Python packings, dW bit-identical over two
    calls, the forward with and without saving its state, and the
    kernels-line entries (bound in 3xTF32, the f32 one beside it), their
    names with `suffix`."""
    import torch
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import render_fused as rf
    src7 = "mvsnerf_tpu_torch/csrc/mlp_v0_train.cu"
    rep7 = "mvsnerf_tpu/ops/pallas_mlp.py:318"
    packed = rf.pack_v0_weights(m)
    streams = k7.mlp_v0_streams(packed)
    same = (torch.equal(streams[:rf.TC_TOTAL], rf.pack_v0_weights_tc(packed))
            and torch.equal(streams[rf.TC_TOTAL:],
                            rf.pack_v0_weights_tct(packed)))
    print(f"   K7 weight streams equal to pack_v0_weights_tc / _tct: {same}")
    check(same, "K7's weight streams differ from their Python packings",
          failures)
    # samples at a ReLU kink get a zero cotangent: float32 puts them
    # on either side of it, and their gradients then differ by design
    kink7 = k7.relu_margin(m, x) <= KINK
    g7 = torch.randn((len(x), 4), device=x.device, generator=gen) / len(x)
    g7[kink7] = 0.0
    print(f"   K7 bwd: {int(kink7.sum())} of {len(x)} samples at a ReLU "
          f"kink, cotangent zeroed")
    n_r = len(x) - 37  # a ragged N: the last tile of 128 samples partial
    m64 = copy.deepcopy(m).double()
    for xs, gs in ((x, g7), (x[:n_r].contiguous(), g7[:n_r].contiguous())):
        r = k7_pair(xs, gs, m, m64, packed)
        for what, (err, tol) in (("forward", r["fwd"]), ("dW", r["dw"]),
                                 ("d feats", r["feat"])):
            print(f"   K7 at N={len(xs)}: {what} err {err:.3e} (tol "
                  f"{tol:.1e})")
            check(err <= tol, f"K7 {what} disagrees with the twin at N="
                  f"{len(xs)}", failures)
        print(f"   K7 at N={len(xs)}: PE / view-direction slices max |dx| "
              f"{r['zero']} (must be 0)")
        check(r["zero"] == 0.0, "K7 returned a non-zero PE / view gradient",
              failures)
        if len(xs) == len(x):
            full = r
    scratch = full["scratch"]
    dx2, dw2 = k7.mlp_v0_bwd_kernel(g7, x, packed, scratch)
    same = torch.equal(dw2, full["dw_k"]) and torch.equal(dx2, full["dx_k"])
    print(f"   K7 bwd: two calls bit-identical (dW, dx): {same}")
    check(same, "K7's backward is not deterministic", failures)
    x_r = x.clone().requires_grad_()
    kernel_entry(kernels, f"K7 mlp_v0{suffix} (fwd)", src7, rep7,
                 *full["fwd"],
                 lambda: k7.mlp_v0_fwd_kernel(x, packed, scratch),
                 lambda: m(x), None, nbytes(x, packed, full["o_k"]),
                 mlp_flops(len(x)), RENDER_TC_PASSES)
    kernel_entry(kernels, f"K7 mlp_v0{suffix} (bwd)", src7, rep7,
                 *full["dw"],
                 lambda: k7.mlp_v0_bwd_kernel(g7, x, packed, scratch),
                 grad_only(lambda: m(x_r), [x_r, *m.parameters()], g7),
                 None, nbytes(g7, x, packed, full["dx_k"], full["dw_k"]),
                 mlp_flops(len(x), True), RENDER_TC_PASSES,
                 dfeat_max_abs_err=full["feat"][0])
    # the saved state against recomputing it: the forward's products alone
    # (no state written) are what a backward that recomputed would add
    bare = device_total(lambda: k7.mlp_v0_fwd_kernel(x, packed, scratch,
                                                     save=False))
    fwd, bwd = kernels[-2], kernels[-1]
    print(f"   K7 saved state: {k7.STATE_FLOATS} floats a sample "
          f"({k7.STATE_FLOATS * 4 * len(x) / 1e6:.1f} MB at N={len(x)}); "
          f"forward on the device {fwd['device_ms']:.4f} ms saving it, "
          f"{bare:.4f} ms without")
    print(f"   K7 wrapper host time (events - device): forward "
          f"{fwd['ms'] - fwd['device_ms']:.4f} ms, backward "
          f"{bwd['ms'] - bwd['device_ms']:.4f} ms")
    fwd["device_nosave_ms"] = bare


def finetune_phase(dev, mlp, mvsnet, failures):
    """Phase 6; returns the K5 and K7 entries of the kernels line and the
    step's ms."""
    import torch
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops.color_warp import color_warp

    t0 = time.perf_counter()
    scene = FinetuneScene(np.random.default_rng(SEED + 2))
    system = finetune_system(dev, mlp, mvsnet, scene)
    vol = system.volume
    require(tuple(vol.shape) == (N_PLANES, H // 4 + 2 * PAD,
                                 W // 4 + 2 * PAD, 8),
            f"fine-tune volume shape {tuple(vol.shape)}")
    require(bool(torch.isfinite(vol).all()), "non-finite fine-tune volume")
    print(f"[6 fine-tune] {len(scene.all_rays)} rays in "
          f"{FT_VIEWS} views, volume {tuple(vol.shape)}, set up in "
          f"{time.perf_counter() - t0:.1f} s")

    rays, rgbs = first_batch(scene, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- (a) one step on the kernels, one on the twins, same state
    plain_step_ms = step_parity(6, system, rays, rgbs, gen, failures)

    # ---- (b) the main path: fit, launch counters reset just before
    counters = {"K4 color_warp": (color_warp, "launches"),
                **k5_counters(),
                "K7 mlp_v0 (fwd)": (k7.mlp_v0_train, "launches"),
                "K7 mlp_v0 (bwd)": (k7.mlp_v0_train, "bwd_launches")}
    launches, step_ms = timed_fit(6, system, counters, plain_step_ms,
                                  failures)

    # ---- (c) K5 and K7 against their twins at the step's shapes, after
    # the timed steps: their device times come from torch.profiler, which
    # can leave CUPTI attached to the process and slow every later launch
    # on the host, and with it the host-bound step that (b) times
    gen.manual_seed(SEED)
    kernels = []
    src7 = "mvsnerf_tpu_torch/csrc/mlp_v0_train.cu"
    rep7 = "mvsnerf_tpu/ops/pallas_mlp.py:318"
    with torch.no_grad():
        k5_entries(kernels, system.volume.detach(),
                   step_ndc(system, rays, gen), gen, failures)
        x = system.mlp_input(rays, gen).reshape(-1, 86).contiguous()
        m = system.mlp
        k7_entries(kernels, x, m, gen, failures)
    report(6, kernels, failures)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # ---- (d) device time of one step by kernel group
    step_profile(6, system, rays, rgbs, gen, FT_STEP_GROUPS)
    return kernels, step_ms


# kernel groups of a fine-tune step's profile, by name fragment
FT_STEP_GROUPS = {
    "K7": ("mlp_pack_kernel", "mlp_fwd_kernel", "mlp_delta_kernel",
           "mlp_dw_kernel", "mlp_dw_reduce"),
    "K5 fwd": ("gather_kernel",), "K5 bwd": ("splat_kernel",),
    "K4": ("color_warp_kernel",),
    "Adam (multi_tensor_apply)": ("multi_tensor_apply",),
    "fills (zeroed buffers)": ("FillFunctor",)}


def step_profile(phase, system, rays, rgbs, gen, groups):
    """`torch.profiler` over 3 fine-tune steps: device busy share and time
    by kernel group (`groups`: name -> name fragments) and the 10 largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
        print(f"[{phase} profile] the profiler saw no device time")
        return
    shares = {g: 0.0 for g in groups}
    shares["rest"] = 0.0
    for name, us in by_name.items():
        g = next((g for g, keys in groups.items()
                  if any(key in name for key in keys)), "rest")
        shares[g] += us
    print(f"[{phase} profile] 3 steps: device busy {total / 1e3:.2f} of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * total / wall_us:.1f} %); "
          f"per step {total / 3e3:.2f} ms of kernels")
    for g, us in shares.items():
        print(f"   {g}: {us / 3e3:.3f} ms/step ({100 * us / total:.1f} %)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"   {us / 3e3:8.3f} ms/step  {name[:110]}")


def k5_counters(suffix=""):
    """K5's launch counters by kernels-line entry name."""
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    return {f"K5 volume_gather{suffix} (fwd)": (k5.sample_volume,
                                                "launches"),
            f"K5 volume_splat{suffix} (bwd)": (k5.sample_volume,
                                               "bwd_launches")}


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
              ("mlp_delta_kernel", "render bwd", None),
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


def twin_routes(twins):
    """A context in which the sweep (K1, K2) and K10 run their plain twins
    in place of their kernels when `twins`."""
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    from mvsnerf_tpu_torch.ops import homography
    from mvsnerf_tpu_torch.ops import sweep as k12
    stack = contextlib.ExitStack()
    if twins:
        stack.enter_context(swapped(homography, "sweep_cost_volume",
                                    k12.sweep_cost_volume_plain))
        for name, plain in (("conv3d_fwd", k10.conv3d_fwd_plain),
                            ("conv3d_up_op", k10.conv3d_up_plain),
                            ("conv3d_wgrad", k10.conv3d_wgrad_plain)):
            stack.enter_context(swapped(k10, name, plain))
    return stack


def step_grads(system, state0, batch, draws, twins, f64=False):
    """A generalizable step's loss at `state0` for `draws` and the MLP's,
    CostRegNet's and FeatureNet's gradients: on the kernels, or on the
    twins (in float64 when `f64`). Also the K2 and K10 launches it made."""
    import torch
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    from mvsnerf_tpu_torch.ops import sweep as k12
    mv = system.mvsnet
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
        k10_before = dict(k10.launches)
        with twin_routes(twins):
            loss, aux = system.loss(b, *d, twins=twins)
            loss.backward()
        missing = [n for n, q in mv.named_parameters() if q.grad is None]
        require(not missing, f"no gradient for {missing}")
        return dict(
            loss=float(loss.detach()),
            depth=float(aux["depth_loss"].detach()),
            k2=k12.sweep_cost_volume.bwd_launches - launched,
            k10={key: n - k10_before[key] for key, n in k10.launches.items()},
            **grads_by_part(system))
    finally:
        if f64:
            torch.set_default_dtype(torch.float32)
            system.mlp.float()
            mv.float()


def report_step_grads(phase, n_rays, k, k_again, p, p64, failures):
    """Hold one step's gradients on the kernels (`k`, and `k_again` from
    the same state) to a float64 run of the twins (`p64`): per part at
    most TOL_GEN_GRAD x the float32 twins' (`p`) own distance."""
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    print(f"[{phase} step] one step's gradients from one state ({n_rays} "
          f"rays): loss kernels {k['loss']:.7f} / twins {p['loss']:.7f} / "
          f"twins in float64 {p64['loss']:.7f} (rel {loss_rel:.2e}, tol "
          f"1e-5; depth loss {k['depth']:.5f})")
    for n in ("MLP", "CostRegNet", "FeatureNet"):
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


def profile_steps(phase, system, sample, gen, failures):
    """`torch.profiler` over 2 steps (with their batch copies): device time
    by group (`step_groups`), and a check that no operation copied a
    cost-volume-sized tensor. Returns (the groups, the kernel names in
    launch order), or None when the profiler saw no device time."""
    import torch
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
    print(f"[{phase} profile] operations copying a {tuple(cost_shape)} "
          f"tensor: {copies}")
    check(not copies, "the step copies the cost volume or its cotangent",
          failures)
    total = sum(us for _, _, us in events)
    if total == 0:
        print(f"[{phase} profile] the profiler saw no device time")
        return None
    print(f"[{phase} profile] 2 steps: device busy {total / 1e3:.2f} of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * total / wall_us:.1f} %); "
          f"per step {total / 2e3:.2f} ms of kernels")
    groups = step_groups([(n, us) for _, n, us in events])
    for grp, names in groups.items():
        us = sum(names.values())
        print(f"   {grp}: {us / 2e3:.3f} ms/step ({100 * us / total:.1f} %)")
        for name, t in sorted(names.items(), key=lambda kv: -kv[1])[:4]:
            print(f"      {t / 2e3:8.3f}  {name[:100]}")
    return groups, [n for _, n, _ in events]


def is_k10(name):
    return "conv3d_" in name or "wgrad_reduce" in name


def unet_spans(names):
    """The kernels launched inside the U-Net's forward and backward: in
    each stretch between two step marks (STEP_MARKS), those from its first
    K10 kernel to its last."""
    marks = [i for i, n in enumerate(names)
             if any(m[0] in n for m in STEP_MARKS)]
    inside = []
    for a, b in zip([-1] + marks, marks + [len(names)]):
        k10 = [i for i in range(a + 1, b) if is_k10(names[i])]
        if k10:
            inside += names[k10[0]:k10[-1] + 1]
    return inside


def generalizable_system(dev, mlp, mvsnet, extra="", mesh=None):
    """A `GeneralizableSystem` from a reference-format checkpoint of the
    seeded weights at bench.py's generalizable configuration, with `extra`
    flags (data-parallel over `mesh` when given)."""
    import tempfile

    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_seeded_checkpoint(os.path.join(tmp, "seeded.tar"), mlp,
                                      mvsnet)
        args = config_parser(
            f"--dataset_name dtu --pad {PAD} --N_samples {N_SAMPLES} "
            f"--batch_size {GEN_BATCH} --with_depth_loss --with_depth "
            f"--net_type v0 --ckpt {ckpt} {extra}")
        return GeneralizableSystem(args, device=dev, mesh=mesh)


def generalizable_phase(dev, mlp, mvsnet, failures):
    """Phase 7; returns the K2 entry of the kernels line,
    generalizable_train_step_ms and K1's device ms on the path's
    sources."""
    import torch
    from mvsnerf_tpu_torch.ops import homography
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import sweep as k12
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.geometry import sample_random_pixels
    from mvsnerf_tpu_torch.render import renderer

    t0 = time.perf_counter()
    sample = generalizable_sample(np.random.default_rng(SEED + 3))
    system = generalizable_system(dev, mlp, mvsnet, "--costreg_impl plain")
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
    # the feature taps K2 adds into its shared-memory windows and those it
    # adds in device memory instead (a cut window, a corner behind a source
    # camera): the window rule's share at this geometry
    taps = torch.zeros(2, dtype=torch.int64, device=dev)
    gk = k12.sweep_cost_volume_bwd_kernel(g, *k2, taps=taps)
    n_win, n_out = taps.tolist()
    rerun = max_err(k12.sweep_cost_volume_bwd_kernel(g, *k2), gk)
    other_err = max_err(k12.sweep_cost_volume_bwd_kernel(other, *k2), gp)
    other_ms = cuda_ms(lambda: k12.sweep_cost_volume_bwd_kernel(other, *k2))
    other_device = device_total(
        lambda: k12.sweep_cost_volume_bwd_kernel(other, *k2))
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
        device_ms=device_total(
            lambda: k12.sweep_cost_volume_bwd_kernel(g, *k2)),
        **bound(nbytes(g, *k2[:3], gk),
                sweep_flops(3, 32, g[0, 0].numel(), backward=True)))
    # K1 on the generalizable path's own inputs, on the device (after
    # phase 6, so that no profile precedes the fine-tune step's timing)
    k1_device = device_total(lambda: k12.sweep_cost_volume_kernel(*k2))
    view_max = [float(gk[v].abs().max()) for v in range(3)]
    print(f"   K2: cotangent {tuple(g.shape)} reaches the sweep in "
          f"{path_layout}, read in place; max|twin| {ref_max:.3e}, per-view "
          f"max |d srcs| {[f'{m:.3e}' for m in view_max]}; kernel "
          f"run-to-run max diff {rerun:.3e}")
    print(f"   K2 taps: {n_win} into the blocks' windows, {n_out} outside "
          f"them ({n_out / max(1, n_win + n_out):.4%})")
    print(f"   K2 on the same cotangent in {layout(other)}: max_abs_err "
          f"{other_err:.3e} (tol {entry['tol']:.1e}), kernel {other_ms:.3f} "
          f"ms, device (torch.profiler) {other_device:.4f} ms")
    print(f"   K1 on the same sources, device (torch.profiler): "
          f"{k1_device:.4f} ms")
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

    def grads(twins, f64=False):
        return step_grads(system, state0, batch, draws, twins, f64)

    # the layout the U-Net's backward hands K2 on the real path
    seen = []
    bwd_kernel = k12.sweep_cost_volume_bwd_kernel

    def noting_layout(g_cost, *rest):
        seen.append(layout(g_cost))
        return bwd_kernel(g_cost, *rest)

    with swapped(k12, "sweep_cost_volume_bwd_kernel", noting_layout):
        k = grads(False)
    k_again, p, p64 = grads(False), grads(True), grads(True, f64=True)
    report_step_grads(7, len(keep), k, k_again, p, p64, failures)
    print(f"   K2 launches {k['k2']} / {p['k2']}; cotangent at K2 in {seen}")
    check(seen == [path_layout],
          f"K2 got {seen} in the step, not (a)'s {path_layout}", failures)
    check(k["k2"] == 1 and p["k2"] == 0 and
          float(k["FeatureNet"].abs().max()) > 0,
          "FeatureNet got no gradient through K2", failures)
    system.load_state(state0)
    del state0, k, k_again, p, p64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with twin_routes(True):
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
    profile_steps(7, system, sample, gen, failures)
    return [entry], step_ms, k1_device


def k10_taps(n_out, n_in, stride, up=False):
    """Valid (output, tap) pairs along one axis of a 3-tap convolution with
    pad 1: i = stride o + k - 1 in [0, n_in); for the transposed stride-2
    one, o = 2 i - 1 + k."""
    o, k = np.arange(n_out)[:, None], np.arange(3)[None]
    if up:
        j = o + 1 - k
        return int(((j % 2 == 0) & (j >= 0) & (j // 2 < n_in)).sum())
    i = stride * o + k - 1
    return int(((i >= 0) & (i < n_in)).sum())


def k10_call_bound(op, args, out):
    """`bound` of one K10 call: its inputs and output once over the memory
    rate, and 2 x the multiply-adds its taps inside the volume need; the
    stride-1 and weight-gradient calls run them on the tensor cores in
    three TF32 passes (the f32 bound beside it as `bound_f32_ms`)."""
    a, b, third = args
    if op == "conv3d_wgrad":   # (g, x, stride) -> (A, B, 3, 3, 3)
        taps = [k10_taps(n, m, third) for n, m in zip(a.shape[2:],
                                                       b.shape[2:])]
        macs = a.shape[1] * b.shape[1]
    elif op == "conv3d_up_op":  # (x, w (Cin, Cout, ..), size)
        taps = [k10_taps(n, m, 2, up=True) for n, m in zip(out.shape[2:],
                                                           a.shape[2:])]
        macs = b.shape[0] * b.shape[1]
    else:                       # conv3d_fwd (x, w (Cout, Cin, ..), stride)
        taps = [k10_taps(n, m, third) for n, m in zip(out.shape[2:],
                                                       a.shape[2:])]
        macs = b.shape[0] * b.shape[1]
    tc = op == "conv3d_wgrad" or (op == "conv3d_fwd" and third == 1)
    return bound(nbytes(a, b, out), 2 * macs * math.prod(taps),
                 tc_passes=3 if tc else 0)


def record_k10_calls(system, batch, draws):
    """The K10 operations of one dband step in call order, with their
    inputs: [(direction, op name, args)], direction 'forward' during the
    loss and 'backward' during its backward."""
    import torch
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    calls, where = [], ["forward"]

    def recording(name):
        fn = getattr(k10, name)

        def op(*args):
            calls.append((where[0], name, tuple(
                a.detach() if torch.is_tensor(a) else a for a in args)))
            return fn(*args)
        return op

    with contextlib.ExitStack() as stack:
        for name in ("conv3d_fwd", "conv3d_up_op", "conv3d_wgrad"):
            stack.enter_context(swapped(k10, name, recording(name)))
        system.optimizer.zero_grad(set_to_none=True)
        loss, _ = system.loss(batch, *draws)
        where[0] = "backward"
        loss.backward()
    system.optimizer.zero_grad(set_to_none=True)
    return calls


def k10_layer_calls(calls, net):
    """The recorded calls by layer: {layer: {"forward" | "dgrad" | "wgrad":
    (op, args)}}, checked against the U-Net's structure: the forward in
    layer order, the backward in reverse with each layer's dgrad before its
    wgrad, each forward on the layer's own weight."""
    fwd = [c for c in calls if c[0] == "forward"]
    bwd = [c for c in calls if c[0] == "backward"]
    require(len(fwd) == 10 and len(bwd) == 20,
            f"{len(fwd)} forward and {len(bwd)} backward K10 calls in a "
            f"step, not 10 and 20")
    dgrad_op = {"s1": ("conv3d_fwd", 1), "s2": ("conv3d_up_op", None),
                "up": ("conv3d_fwd", 2)}
    out = {}
    for i, (layer, kind) in enumerate(K10_LAYERS):
        mod = getattr(net, layer)
        weight = mod.conv.weight if kind != "up" else mod[0].weight
        f = fwd[i]
        d, w = bwd[2 * (9 - i)], bwd[2 * (9 - i) + 1]
        op, stride = dgrad_op[kind]
        ok = (f[1] == ("conv3d_up_op" if kind == "up" else "conv3d_fwd") and
              f[2][1].data_ptr() == weight.data_ptr() and d[1] == op and
              (stride is None or d[2][2] == stride) and
              w[1] == "conv3d_wgrad" and
              w[2][2] == (1 if kind == "s1" else 2))
        require(ok, f"K10 calls of {layer} ({kind}) out of the expected "
                    f"order: {f[1]}, {d[1]}, {w[1]}")
        out[layer] = {"forward": f[1:], "dgrad": d[1:], "wgrad": w[1:]}
    return out


def k10_library_call(kind, direction, rec):
    """The one cuDNN call computing the same function as a layer's K10
    call in `direction` (TF32 off): F.conv3d / F.conv_transpose3d, or
    aten.convolution_backward for the gradients."""
    import torch
    import torch.nn.functional as F
    x, w = rec["forward"][1][:2]
    gy = rec["dgrad"][1][0]
    stride = 1 if kind == "s1" else 2
    if direction == "forward":
        if kind == "up":
            return lambda: F.conv_transpose3d(x, w, stride=2, padding=1,
                                              output_padding=1)
        return lambda: F.conv3d(x, w, stride=stride, padding=1)
    mask = [direction == "dgrad", direction == "wgrad", False]
    up = kind == "up"
    return lambda: torch.ops.aten.convolution_backward(
        gy, x, w, None, [stride] * 3, [1] * 3, [1] * 3, up,
        [1 if up else 0] * 3, 1, mask)


def k10_kernel_entries(system, batch, draws, failures):
    """Phase 8a: each K10 kernel against its plain twin on the inputs one
    dband step gives it, layer by layer and direction by direction, with
    CUDA-event times of the kernel, the twin and cuDNN's call, and the
    bound; the four entries of the kernels line, summed over the step."""
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    kernel_of = {"conv3d_fwd": k10.conv3d_fwd_kernel,
                 "conv3d_up_op": k10.conv3d_up_kernel,
                 "conv3d_wgrad": k10.conv3d_wgrad_kernel}
    plain_of = {"conv3d_fwd": k10.conv3d_fwd_plain,
                "conv3d_up_op": k10.conv3d_up_plain,
                "conv3d_wgrad": k10.conv3d_wgrad_plain}
    layers = k10_layer_calls(record_k10_calls(system, batch, draws),
                             system.mvsnet.cost_reg_2)
    sums = {key: dict(max_abs_err=0.0, tol=0.0, ratio=-1.0, ms=0.0,
                      plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      by={"bytes": 0.0, "operations": 0.0})
            for key in K10_ENTRIES}
    device_keys = ("device_ms", "device_library_ms", "bound_f32_ms")
    for layer, kind in K10_LAYERS:
        rec = layers[layer]
        for direction in ("forward", "dgrad", "wgrad"):
            op, args = rec[direction]
            key = {"conv3d_fwd": f"s{args[2]}", "conv3d_up_op": "up",
                   "conv3d_wgrad": "wgrad"}[op]
            out_k = kernel_of[op](*args)
            out_p = plain_of[op](*args)
            err = max_err(out_k, out_p)
            if op == "conv3d_wgrad":
                ref = plain_of[op](*(a.double() if hasattr(a, "double")
                                     else a for a in args))
                tol = TOL_K7_BWD * max(max_err(out_p.double(), ref),
                                       1e-6 * float(ref.abs().max()))
                del ref
            else:
                tol = TOL_K10 * (1 + float(out_p.abs().max()))
            b = k10_call_bound(op, args, out_k)
            library = k10_library_call(kind, direction, rec)
            times = [cuda_ms(lambda: kernel_of[op](*args)),
                     cuda_ms(lambda: plain_of[op](*args)),
                     cuda_ms(library)]
            # every call is also timed on the device
            d = (device_total(lambda: kernel_of[op](*args)),
                 device_total(library))
            s = sums[key]
            s["device_ms"] = s.get("device_ms", 0.0) + d[0]
            s["device_library_ms"] = s.get("device_library_ms", 0.0) + d[1]
            dev = (f"; device (torch.profiler) kernel {d[0]:.4f} ms, "
                   f"cuDNN {d[1]:.4f} ms")
            if "bound_f32_ms" in b:
                sums[key]["bound_f32_ms"] = \
                    sums[key].get("bound_f32_ms", 0.0) + b["bound_f32_ms"]
                dev += f"; f32 bound {b['bound_f32_ms']:.4f} ms"
            print(f"[8 kernel] {layer} {direction} ({key}, "
                  f"{'x'.join(map(str, args[0].shape[1:]))} -> "
                  f"{'x'.join(map(str, out_k.shape[1:]))}): max_abs_err "
                  f"{err:.3e} (tol {tol:.1e}), kernel {times[0]:.3f} ms, "
                  f"plain {times[1]:.3f} ms, cuDNN {times[2]:.3f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}){dev}")
            check(err <= tol, f"K10 {key} disagrees with its twin on "
                              f"{layer} {direction}", failures)
            s = sums[key]
            if err / tol > s["ratio"]:
                s.update(max_abs_err=err, tol=tol, ratio=err / tol)
            for name, t in zip(("ms", "plain_ms", "library_ms"), times):
                s[name] += t
            s["bound_ms"] += b["bound_ms"]
            s["by"][b["bound_by"]] += b["bound_ms"]
            del out_k, out_p
    entries = []
    for key, (name, replaces) in K10_ENTRIES.items():
        s = sums[key]
        device = {k: s[k] for k in device_keys if k in s}
        entries.append(dict(
            name=name, route="cuda",
            source="mvsnerf_tpu_torch/csrc/conv3d.cu", replaces=replaces,
            max_abs_err=s["max_abs_err"], tol=s["tol"], ms=s["ms"],
            plain_ms=s["plain_ms"], library_ms=s["library_ms"],
            bound_ms=s["bound_ms"],
            bound_by=max(s["by"], key=s["by"].get), **device))
        dev = "".join(f", {k} {v:.4f}" for k, v in device.items())
        print(f"[8 kernel] {name}, summed over one step's "
              f"{K10_PER_STEP[key]} calls: kernel {s['ms']:.3f} ms, plain "
              f"{s['plain_ms']:.3f} ms, cuDNN {s['library_ms']:.3f} ms, "
              f"bound {s['bound_ms']:.4f} ms{dev}; worst max_abs_err "
              f"{s['max_abs_err']:.3e} (tol {s['tol']:.1e})")
    return entries


def dband_phase(dev, mlp, mvsnet, failures, cudnn_step_ms, scene):
    """Phase 8: the generalizable step and the volume build on the default
    route (`--costreg_impl auto`), which takes K10 on the card; returns
    K10's entries of the kernels line and the step's ms."""
    import torch
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from mvsnerf_tpu_torch.models.mvsnet import costreg_route
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import sweep as k12
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    from mvsnerf_tpu_torch.ops.color_warp import color_warp

    t0 = time.perf_counter()
    sample = generalizable_sample(np.random.default_rng(SEED + 3))
    system = generalizable_system(dev, mlp, mvsnet)
    impl = system.mvsnet.cost_reg_2.impl
    require(impl == "auto" and costreg_route(impl, dev) == "dband",
            f"the default route is {impl!r}, resolving to "
            f"{costreg_route(impl, dev)!r} on {dev}, not auto -> dband")
    batch = system.batch(sample)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    print(f"[8 dband] phase 7's configuration on the default route (auto "
          f"-> dband); set up in {time.perf_counter() - t0:.1f} s")

    # ---- (a) each kernel against its twin on one step's inputs
    draws = system.draw(batch, gen)
    entries = k10_kernel_entries(system, batch, draws, failures)
    torch.cuda.empty_cache()

    # ---- (b) one step's gradients on K10 against the twins in float64
    from mvsnerf_tpu_torch.ops.geometry import sample_random_pixels
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
    k, k_again, p, p64 = (
        step_grads(system, state0, batch, draws, twins, f64)
        for twins, f64 in ((False, False), (False, False), (True, False),
                           (True, True)))
    report_step_grads(8, len(keep), k, k_again, p, p64, failures)
    print(f"   K10 launches in the kernel step {k['k10']}, in the twin "
          f"step {p['k10']}")
    check(k["k10"] == K10_PER_STEP and not any(p["k10"].values()),
          f"K10 launched {k['k10']} / {p['k10']} times in one step, not "
          f"{K10_PER_STEP} / none", failures)
    system.load_state(state0)
    del state0, k, k_again, p, p64

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
    for key in k10.launches:
        k10.launches[key] = 0
    clock = StepClock()
    torch.cuda.reset_peak_memory_stats()
    n_steps = GEN_WARM + GEN_TIMED
    losses = system.fit([sample], num_epochs=n_steps, logger=clock,
                        seed=SEED, log_every=GEN_WARM)
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    k10_launches = dict(k10.launches)
    step_ms = (clock.marks[n_steps] - clock.marks[GEN_WARM]) * 1e3 / GEN_TIMED
    print(f"[8 fit] {len(losses)} steps on auto (K10), loss "
          f"{losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; steps {GEN_WARM + 1}-{n_steps}: "
          f"generalizable_train_step_ms {step_ms:.2f} (cuDNN U-Net, phase "
          f"7: {cudnn_step_ms:.2f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K10 "
          f"launches {k10_launches}; others {launches}")
    check(len(losses) == n_steps and all(math.isfinite(v) for v in losses),
          "fit on the default route returned a non-finite loss", failures)
    check(k10_launches == {key: n * n_steps
                           for key, n in K10_PER_STEP.items()},
          f"K10 launched {k10_launches} times in {n_steps} steps, not "
          f"{n_steps} x {K10_PER_STEP}", failures)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the default route", failures)
    for e, key in zip(entries, K10_ENTRIES):
        e["launches"] = k10_launches[key]

    # ---- (d) the volume build on the default route against cuDNN's
    cudnn_volume = Evaluator(mvsnet, mlp, n_samples=N_SAMPLES, pad=PAD,
                             n_planes=N_PLANES, chunk=CHUNK, device=dev,
                             costreg_impl="plain").build_volume(*scene)[0]
    ev = Evaluator(mvsnet, mlp, n_samples=N_SAMPLES, pad=PAD,
                   n_planes=N_PLANES, chunk=CHUNK, device=dev,
                   costreg_impl="auto")
    ev.build_volume(*scene)
    for key in k10.launches:
        k10.launches[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = ev.build_volume(*scene)[0]
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    rel = max_err(vol, cudnn_volume) / float(cudnn_volume.abs().max())
    print(f"[8 volume] Evaluator(costreg_impl='auto').build_volume: "
          f"{build_ms:.1f} ms, volume {tuple(vol.shape)}, max abs diff from "
          f"the cuDNN route's / its max {rel:.2e} (tol 1e-4); K10 launches "
          f"{k10.launches}")
    check(rel <= 1e-4, "the dband volume disagrees with the cuDNN route's",
          failures)
    check(k10.launches == K10_PER_BUILD,
          f"the default volume build launched K10 {k10.launches} times",
          failures)
    del ev, vol

    # ---- (e) device time of 2 dband steps by group; no convolution
    # library kernel in the U-Net's stages and no cost-volume copy
    profiled = profile_steps(8, system, sample, gen, failures)
    if profiled is not None:
        groups, order = profiled
        stray = sorted({name for grp in ("CostRegNet fwd", "CostRegNet bwd")
                        for name in groups[grp]
                        if not is_k10(name) and
                        any(f in name.lower() for f in CONV_LIBRARY_NAMES)})
        k10_us = {}
        for grp in ("CostRegNet fwd", "CostRegNet bwd"):
            mine = {name: us for name, us in groups[grp].items()
                    if is_k10(name)}
            k10_us[grp] = sum(mine.values())
            print(f"[8 profile] {grp}: K10 {k10_us[grp] / 2e3:.3f} of "
                  f"{sum(groups[grp].values()) / 2e3:.3f} ms/step")
            for name, us in sorted(mine.items(), key=lambda kv: -kv[1]):
                print(f"      {us / 2e3:8.3f}  {name[:100]}")
        # cuBLAS GEMMs inside the U-Net's own span (the stages also hold
        # the rays' and projections' small products, outside it)
        span = unet_spans(order)
        gemm = sorted({name for name in span if "gemm" in name.lower()})
        others = sorted({name.split("(")[0][:60] for name in span
                         if not is_k10(name)})
        print(f"[8 profile] the U-Net's span: {len(span)} kernels over 2 "
              f"steps; besides K10: {others}")
        print(f"[8 profile] convolution library kernels in the U-Net's "
              f"stages: {stray}; cuBLAS GEMMs between its first and last "
              f"K10 kernel: {gemm}")
        check(not stray, "a library convolution ran in the dband U-Net",
              failures)
        check(not gemm, "a cuBLAS GEMM ran in the dband U-Net", failures)
        check(all(k10_us.values()), "the profile shows no K10 kernel in "
                                    "the U-Net's stages", failures)
    return entries, step_ms


class EvalScene:
    """In-memory DTU-like eval dataset: the rig's 3 source views, and
    `n` target views near the reference with random pixels and random GT
    depths in [2.5, 4.2] (a quarter of them 0: background)."""

    def __init__(self, rng, src, dev, n=EVAL_VIEWS):
        self.src = src
        intr = src[2]["intrinsics"][0]
        self.items = [
            {"rays": rays_for_pose(pose(0, 0.015 * (i + 1), 0.05 * (i + 1)),
                                   intr, H, W, dev),
             "rgbs": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
             "depth": (rng.uniform(2.5, 4.2, (H, W)) *
                       (rng.uniform(0, 1, (H, W)) > 0.25)).astype(
                           np.float32)} for i in range(n)]

    def read_source_views(self, pair_idx=None):
        imgs_norm, projs, pose_src = self.src
        return imgs_norm, projs, list(NEAR_FAR), pose_src

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def color_phase(dev, mlp, mvsnet, ev, src, requests, failures):
    """Phase 9; returns the K6b, K8, K11 and K5-at-C=20 entries."""
    import torch
    from gpu_bench.costs import mlp_v1 as costs_v1
    from mvsnerf_tpu_torch.eval.video import make_path, render_video
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu_torch.ops.interp import index_point_feature
    from mvsnerf_tpu_torch.ops.sampling import ray_marcher
    from mvsnerf_tpu_torch.render import tiled
    from mvsnerf_tpu_torch.render.renderer import gen_dir_feature
    src6 = "mvsnerf_tpu_torch/csrc/render_v0.cu"
    kernels = []

    # ---- (a) K6b and K8 against their twins on one chunk
    with torch.no_grad():
        volume, imgs01, nf, pose_t = ev.build_volume(src[0], src[1],
                                                     NEAR_FAR, src[2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vol20 = tiled.bake_color_volume(volume, imgs01, pose_t, nf, PAD)
        torch.cuda.synchronize()
        bake_ms = (time.perf_counter() - t0) * 1e3
        require(tuple(vol20.shape) == (N_PLANES, H // 4 + 2 * PAD,
                                       W // 4 + 2 * PAD, 20)
                and bool(torch.isfinite(vol20).all()),
                f"baked volume {tuple(vol20.shape)} not finite or not "
                "(128, 176, 208, 20)")
        print(f"[9 bake] colour-baked volume {tuple(vol20.shape)} in "
              f"{bake_ms:.2f} ms (K4 at the voxel centres); masks in view "
              f"{float(vol20[..., 11::4].mean()):.3f}")
        w2cs, intrs = pose_t["w2cs"], pose_t["intrinsics"]
        pts, _, rays_d, z = ray_marcher(requests[1][:CHUNK], N_SAMPLES)
        ndc = get_ndc_coordinate(w2cs[0], intrs[0], pts,
                                 torch.tensor([W - 1.0, H - 1.0], device=dev),
                                 near=nf[0], far=nf[1], pad=PAD).contiguous()
        z = z.contiguous()
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        dirs = gen_dir_feature(w2cs[0], unit).contiguous()
        n_samp = ndc[..., 0].numel()
        mlp64 = copy.deepcopy(mlp).double()
        b_args = (ndc, z, None, dirs, vol20, mlp)
        r_k, r_p = rf.render_v0(*b_args), rf.render_v0_plain(*b_args)
        kernel_entry(kernels, "K6b render_v0 (baked)", src6,
                     "mvsnerf_tpu/ops/pallas_render_tiled.py:313",
                     max_err(r_k, r_p), TOL_K6,
                     lambda: rf.render_v0(*b_args),
                     lambda: rf.render_v0_plain(*b_args), None,
                     nbytes(ndc, z, dirs, *r_k.values()) +
                     touched_volume_bytes(vol20, ndc), mlp_flops(n_samp),
                     RENDER_TC_PASSES, **f64_anchor(
                         r_k, r_p, lambda: rf.render_v0_plain(
                             ndc.double(), z.double(), None, dirs.double(),
                             vol20.double(), mlp64)))
        colors = color_warp(pts.contiguous(), w2cs, intrs,
                            imgs01.contiguous())
        feats = torch.cat([index_point_feature(volume, ndc), colors],
                          -1).contiguous()
        f_args = (ndc, feats, dirs, z, mlp)
        f_k, f_p = rf.render_v0_feats(*f_args), rf.render_v0_feats_plain(
            *f_args)
        kernel_entry(kernels, "K8 render_v0_feats", src6,
                     "mvsnerf_tpu/ops/pallas_kernels.py:196",
                     max_err(f_k, f_p), TOL_K6,
                     lambda: rf.render_v0_feats(*f_args),
                     lambda: rf.render_v0_feats_plain(*f_args), None,
                     nbytes(ndc, feats, dirs, z, *f_k.values()),
                     mlp_flops(n_samp), RENDER_TC_PASSES, **f64_anchor(
                         f_k, f_p, lambda: rf.render_v0_feats_plain(
                             ndc.double(), feats.double(), dirs.double(),
                             z.double(), mlp64)))
        w_gap = max_err(f_k["weights"].sum(-1), f_k["acc"])
        print(f"   K6b inputs: acc mean {float(r_p['acc'].mean()):.4f}; "
              f"K8: |sum of weights - acc| max {w_gap:.2e}")
        # K11 on the same features with phase 14(c)'s seeded v1 MLP; its
        # bound from the benchmark's v1 counts, the attention's 2,700
        # multiply-adds a sample counted with the trunk's
        mlp_v1 = seeded_init_(MVSNeRF("v1", device=dev),
                              torch.Generator().manual_seed(SEED + 20))
        m1_64 = copy.deepcopy(mlp_v1).double()
        for n in (VIEW_CHUNK, CHUNK):
            a = tuple(x[:n] for x in f_args[:4]) + (mlp_v1,)
            v_k, v_p = rf.render_v1_feats(*a), rf.render_v1_feats_plain(*a)
            kernel_entry(kernels, f"K11 render_v1_feats {n}x{N_SAMPLES}",
                         "mvsnerf_tpu_torch/csrc/render_v1.cu",
                         "none (the JAX package computes v1 in XLA, "
                         "mvsnerf_tpu/models/nerf_mlp.py:117)",
                         max_err(v_k, v_p), TOL_K6,
                         lambda a=a: rf.render_v1_feats(*a),
                         lambda a=a: rf.render_v1_feats_plain(*a), None,
                         costs_v1.render_bytes(n, N_SAMPLES),
                         costs_v1.render_flops(n * N_SAMPLES),
                         RENDER_TC_PASSES, **f64_anchor(
                             v_k, v_p, lambda a=a: rf.render_v1_feats_plain(
                                 *(x.double() for x in a[:4]), m1_64)))
            print(f"   K11 {n} rays: acc mean {float(v_p['acc'].mean()):.4f}"
                  f"; |sum of weights - acc| max "
                  f"{max_err(v_k['weights'].sum(-1), v_k['acc']):.2e}")
            del a, v_k, v_p
        del pts, rays_d, z, ndc, dirs, colors, feats, r_k, r_p, f_k, f_p, \
            b_args, f_args, vol20, mlp64, mlp_v1, m1_64
    report(9, kernels, failures)

    # ---- (b) the Evaluator in all three modes, launch counters reset
    counters = {"K4 color_warp": (color_warp, "launches"),
                "K6 render_v0": (rf.render_v0, "launches"),
                "K6b render_v0 (baked)": (rf.render_v0, "baked_launches"),
                "K8 render_v0_feats": (rf.render_v0_feats, "launches")}
    modes = ("chunked", "hybrid", "tiled")
    with torch.no_grad():
        ev.build_volume(src[0], src[1], NEAR_FAR, src[2])
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.renderer("tiled")
        torch.cuda.synchronize()
        eval_bake_ms = (time.perf_counter() - t0) * 1e3
        times = {m: [] for m in modes}
        outs = {}
        for i, rays in enumerate(requests):
            for mode in modes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = ev.render(rays, H, W, mode=mode)
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3)
                require(all(bool(torch.isfinite(out[k]).all())
                            for k in ("rgb", "depth", "acc")),
                        f"{mode} request {i} not finite")
                if i == 0:
                    outs[mode] = out
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr) in counters.items()}
        with swapped(tiled, "render_v0", rf.render_v0_plain):
            twin = ev.render(requests[0], H, W, mode="tiled")
    terr = max_err(outs["tiled"], twin)
    rgb = {m: outs[m]["rgb"] for m in modes}
    hybrid_err = max_err(rgb["hybrid"], rgb["chunked"])
    baked_gap = (rgb["tiled"] - rgb["chunked"]).abs()
    print(f"[9 eval] tiled mode's bake (first request's set-up) "
          f"{eval_bake_ms:.2f} ms")
    for mode, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"[9 eval] {mode}: {len(ts)} requests of {H}x{W} rays, "
              f"ms/request {[round(t, 1) for t in ts]}, mean {ms:.1f}, "
              f"{H * W / ms * 1e3:.0f} rays/s")
    print(f"[9 eval] tiled request vs its twin path on the same baked "
          f"volume: max abs err {terr:.3e} (tol {TOL_K6:.0e}); tiled vs "
          f"chunked rgb (baked against exact colours, no tolerance): max "
          f"{float(baked_gap.max()):.3e}, mean {float(baked_gap.mean()):.3e};"
          f" hybrid vs chunked rgb {hybrid_err:.3e} (tol {TOL_MODES:.0e}); "
          f"launches {launches}")
    check(terr <= TOL_K6, "the tiled request disagrees with its twin path",
          failures)
    check(hybrid_err <= TOL_MODES, "[9] hybrid and chunked renders disagree",
          failures)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the Evaluator's path",
              failures)
    for k in kernels:  # K11's launches are phase 14(c)'s
        if not k["name"].startswith("K11 "):
            k["launches"] = launches[k["name"]]
    del outs, twin, rgb, baked_gap

    # ---- (c) Evaluator.evaluate on an in-memory DTU-like dataset
    ds = EvalScene(np.random.default_rng(SEED + 9), src, dev)
    for mode in modes:
        t0 = time.perf_counter()
        res = ev.evaluate(ds, mode=mode)
        ms = (time.perf_counter() - t0) * 1e3
        rows = res["per_image"]
        print(f"[9 evaluate] {mode}: {len(rows)} views in {ms:.0f} ms, mean "
              + ", ".join(f"{k} {v:.4f}" for k, v in res["mean"].items()))
        check(len(rows) == EVAL_VIEWS and
              all(set(r) >= {"psnr", "ssim", "abs_err", "acc_0.01"}
                  and all(math.isfinite(v) for v in r.values())
                  for r in rows),
              f"Evaluator.evaluate ({mode}) gave missing or non-finite "
              "metrics", failures)

    # ---- (d) the colour-volume fine-tune at full width
    t0 = time.perf_counter()
    scene = FinetuneScene(np.random.default_rng(SEED + 2))
    system = finetune_system(dev, mlp, mvsnet, scene,
                             "--use_color_volume --render_mode tiled")
    vol = system.volume
    require(tuple(vol.shape) == (N_PLANES, H // 4 + 2 * PAD,
                                 W // 4 + 2 * PAD, 20)
            and bool(torch.isfinite(vol).all()),
            f"colour-volume shape {tuple(vol.shape)} or non-finite")
    held = {id(p) for g in system.optimizer.param_groups
            for p in g["params"]}
    in_adam = sum(id(p) in held for p in system.mvsnet.parameters())
    print(f"[9 colour fine-tune] volume {tuple(vol.shape)} "
          f"({vol.numel() / 1e6:.1f}M values), set up in "
          f"{time.perf_counter() - t0:.1f} s; Adam holds {len(held)} "
          f"tensors, {in_adam} of them MVSNet's (must be 0)")
    check(in_adam == 0 and id(vol) in held,
          "the colour-volume Adam holds MVSNet parameters or not the "
          "volume", failures)
    rays, rgbs = first_batch(scene, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k5 = []
    with torch.no_grad():
        k5_entries(k5, vol.detach(), step_ndc(system, rays, gen), gen,
                   failures, " C=20")
    report(9, k5, failures)
    plain_step_ms = step_parity(9, system, rays, rgbs, gen, failures)
    counters = {**k5_counters(" C=20"),
                "K7 mlp_v0 (fwd)": (k7.mlp_v0_train, "launches"),
                "K7 mlp_v0 (bwd)": (k7.mlp_v0_train, "bwd_launches")}
    color_warp.launches = 0
    launches, _ = timed_fit(9, system, counters, plain_step_ms, failures)
    check(color_warp.launches == 0, "the colour-volume step warped colours",
          failures)
    for k in k5:
        k["launches"] = launches[k["name"]]
    kernels += k5

    # ---- (e) render_video in the tiled mode, frames kept in memory
    poses = make_path("interp", dataset=scene, n_frames=3)[:VIDEO_FRAMES]
    rf.render_v0.baked_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = render_video(system, poses, H, W, [FOCAL, FOCAL], NEAR_FAR,
                          chunk=CHUNK)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    baked = rf.render_v0.baked_launches
    print(f"[9 video] {len(frames)} frames of {H}x{W} in the tiled mode, "
          f"{ms:.1f} ms/frame (the first makes the renderer), K6b "
          f"launches {baked}, written to {render_video.last_path}")
    check(len(frames) == VIDEO_FRAMES and
          all(f.shape == (H, W, 3) and f.dtype == np.uint8 for f in frames)
          and baked > 0 and render_video.last_path is None,
          "render_video's frames are wrong, K6b never ran or it wrote",
          failures)
    return kernels


def image_grads(system, samples, rgbs, twins, f64=False):
    """The fine-tune loss (the step's MSE) at the system's state through
    `render_rays(training=True)` with the source images made a leaf that
    requires grad, differentiated in the images, the volume and the MLP in
    one backward: on the kernels, or on the twins (in float64 when `f64`).
    Returns (loss, d imgs)."""
    import torch
    from mvsnerf_tpu_torch.render import renderer
    mlp, vol, imgs = system.mlp, system.volume.detach(), system.imgs.detach()
    w2cs = system.pose_source["w2cs"]
    intrs = system.pose_source["intrinsics"]
    if f64:
        mlp = copy.deepcopy(mlp).double()
        samples, rgbs, vol, imgs, w2cs, intrs = (
            [x.double() for x in samples], rgbs.double(), vol.double(),
            imgs.double(), w2cs.double(), intrs.double())
        torch.set_default_dtype(torch.float64)
    try:
        vol = vol.clone().requires_grad_()
        im = imgs.clone().requires_grad_()
        pts, rays_d, z_vals, ndc = samples
        out = renderer.render_rays(mlp, vol, pts, ndc, z_vals, rays_d,
                                   w2cs[0], w2cs, intrs, im, training=True,
                                   twins=twins)
        loss = torch.mean((out["rgb"] - rgbs) ** 2)
        g_im = torch.autograd.grad(loss, [im, vol, *mlp.parameters()])[0]
        return float(loss.detach()), g_im
    finally:
        if f64:
            torch.set_default_dtype(torch.float32)


def device_ms(fn, reps=5):
    """Device time per call of `fn` by kernel name (torch.profiler), ms,
    after one warm-up call. The profile can lose a launch now and then (a
    kernel that every call launches once seen 4 times in 5 calls), so a
    name's time per call is the mean of the launches it saw times the
    launches a call makes, `reps` calls rounded up. A profile that caught
    no device activity is taken again, up to twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, seen = {}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
                seen[e.name] = seen.get(e.name, 0) + 1
        if us:
            break
    return {name: t / seen[name] * -(-seen[name] // reps) / 1e3
            for name, t in us.items()}


def device_total(fn, reps=5):
    """Device ms per call of `fn`, summed over every kernel, copy and fill
    it launches (torch.profiler)."""
    return sum(device_ms(fn, reps).values())


def k4_bwd_compare(g, pts, w2cs, intrs, imgs):
    """K4's backward against its twin on the cotangent `g`, held to a
    float64 run of the twin (TOL_K4_BWD), with CUDA-event times of kernel,
    twin and `grid_sampler_2d_backward` and the bound. Returns a dict of
    the kernels-line numbers."""
    import torch
    from mvsnerf_tpu_torch.ops import color_warp as k4
    V = imgs.shape[0]
    b_k = k4.color_warp_bwd_kernel(g, pts, w2cs, intrs, imgs.shape)
    b_p = k4.color_warp_bwd_plain(g, pts, w2cs, intrs, imgs)
    b_64 = k4.color_warp_bwd_plain(g.double(), pts.double(), w2cs.double(),
                                   intrs.double(), imgs.double())
    rerun = max_err(k4.color_warp_bwd_kernel(g, pts, w2cs, intrs,
                                             imgs.shape), b_k)
    tol = TOL_K4_BWD * max(max_err(b_p.double(), b_64),
                           1e-6 * float(b_64.abs().max()))
    inp, grid = k4_library_inputs(pts, w2cs, intrs, imgs)
    # the RGB slots of each view's block, (V, 3, N*S, 1)
    g_lib = g.reshape(-1, V, 4)[..., :3].permute(1, 2, 0)[..., None] \
        .contiguous()

    def lib():
        return torch.ops.aten.grid_sampler_2d_backward(
            g_lib, inp, grid, 0, 1, True, [True, False])[0]

    lib_err = max_err(lib().permute(0, 2, 3, 1), b_p)
    im_r = imgs.clone().requires_grad_()
    n = pts[..., 0].numel()
    # device time alone (no host overhead), and the kernel on each view by
    # itself: where the atomics collide
    dev_k = device_ms(lambda: k4.color_warp_bwd_kernel(g, pts, w2cs, intrs,
                                                        imgs.shape))
    per_view = []
    for v in range(V):
        g_v = g[..., 4 * v:4 * v + 4].contiguous()
        one = (pts, w2cs[v:v + 1], intrs[v:v + 1])
        per_view.append(sum(
            t for name, t in device_ms(lambda: k4.color_warp_bwd_kernel(
                g_v, *one, (1, *imgs.shape[1:]))).items()
            if "color_warp_bwd" in name))
    device_library = device_ms(lib)
    return dict(
        max_abs_err=max_err(b_k, b_p), tol=tol,
        ms=cuda_ms(lambda: k4.color_warp_bwd_kernel(g, pts, w2cs, intrs,
                                                     imgs.shape)),
        plain_ms=cuda_ms(grad_only(
            lambda: k4.color_warp_plain(pts, w2cs, intrs, im_r), im_r, g)),
        library_ms=cuda_ms(lib),
        # the kernel with its zeroing, the library call with its fill
        device_ms=sum(dev_k.values()),
        device_library_ms=sum(device_library.values()),
        # per sample and view: the projection (~30) and 4 taps of 3
        # channels, a multiply and an add each
        **bound(nbytes(g, pts, w2cs, intrs, b_k), n * V * (30 + 4 * 3 * 2)),
        extra=dict(err_f64_kernel=max_err(b_k.double(), b_64),
                   err_f64_twin=max_err(b_p.double(), b_64),
                   max_abs=float(b_64.abs().max()), rerun=rerun,
                   library_vs_twin=lib_err, samples=n, device_kernel=dev_k,
                   device_library=device_library, device_per_view=per_view))


def print_k4_bwd_device(x):
    """The device-time lines of `k4_bwd_compare`'s extras."""
    for what in ("kernel", "library"):
        print(f"   K4 bwd device ms per call ({what}, torch.profiler): " +
              ", ".join(f"{name[:60]} {t:.4f}" for name, t in
                        x[f"device_{what}"].items()))
    print("   K4 bwd device ms of the kernel on each view alone: " +
          ", ".join(f"view {v} {t:.4f}"
                    for v, t in enumerate(x["device_per_view"])))


def outside_view_points(w2cs, intrs, view, n_rays, n_samples):
    """(n_rays, n_samples, 3) world points that all project right of view
    `view`'s frame: rays through that camera's centre at pixels u in
    [W + 8, W + 264], v in [-64, H + 64], each sampled at n_samples
    depths in NEAR_FAR. Each ray's samples land on one point of the view's
    image plane, and every one clamps onto its border column: the worst
    case for the backward's atomics."""
    import torch
    K = intrs[view].double()
    c2w = torch.linalg.inv(w2cs[view].double())
    side = math.isqrt(n_rays)
    u = torch.linspace(W + 8, W + 264, side, dtype=torch.float64,
                       device=K.device)
    v = torch.linspace(-64, H + 64, n_rays // side, dtype=torch.float64,
                       device=K.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    z = torch.linspace(*NEAR_FAR, n_samples, dtype=torch.float64,
                       device=K.device)
    x = (uu.reshape(-1, 1) - K[0, 2]) / K[0, 0] * z
    y = (vv.reshape(-1, 1) - K[1, 2]) / K[1, 1] * z
    cam = torch.stack([x, y, z.expand_as(x), torch.ones_like(x)], -1)
    return (cam @ c2w.T)[..., :3].float().contiguous()


def print_k4_bwd_chunk(what, x):
    """One line of `k4_bwd_compare`'s numbers on a chunk, then its device
    times."""
    print(f"[10 kernel] K4 color_warp (bwd) on {what}: max_abs_err "
          f"{x['max_abs_err']:.3e} (tol {x['tol']:.1e}), kernel "
          f"{x['ms']:.3f} ms, plain {x['plain_ms']:.3f} ms, library "
          f"{x['library_ms']:.3f} ms, bound {x['bound_ms']:.4f} ms "
          f"({x['bound_by']}); device kernel {x['device_ms']:.4f} ms, "
          f"library {x['device_library_ms']:.4f} ms; vs float64 kernel "
          f"{x['extra']['err_f64_kernel']:.3e} / twin "
          f"{x['extra']['err_f64_twin']:.3e}")
    print_k4_bwd_device(x["extra"])


def image_grad_phase(dev, mlp, mvsnet, requests, earlier, failures):
    """Phase 10: the render's gradient in its source images; `earlier`
    maps each earlier phase to the K4 backward launches it made. Returns
    K4 backward's entry of the kernels line."""
    import torch
    from mvsnerf_tpu_torch.ops import color_warp as k4
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    from mvsnerf_tpu_torch.ops.sampling import ray_marcher
    from mvsnerf_tpu_torch.render import renderer

    t0 = time.perf_counter()
    scene = FinetuneScene(np.random.default_rng(SEED + 2))
    system = finetune_system(dev, mlp, mvsnet, scene)
    imgs = system.imgs.detach()
    w2cs = system.pose_source["w2cs"]
    intrs = system.pose_source["intrinsics"]
    gen = torch.Generator(device=dev)
    print(f"[10 image grad] phase 6's configuration, source images "
          f"{tuple(imgs.shape)} a leaf that requires grad; set up in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- (a) K4 backward against its twin on the cotangent that reaches
    # the warp in the fine-tune loss's own graph, at phase 6's shapes
    rays, rgbs = first_batch(scene, dev)
    gen.manual_seed(SEED + 1)
    samples = system._samples(rays, gen)
    captured = {}

    def capturing(*args):
        out = k4.color_warp(*args)
        captured["args"] = tuple(a.detach() for a in args)
        out.register_hook(lambda g: captured.update(g=g))
        return out

    with swapped(renderer, "color_warp", capturing):
        image_grads(system, samples, rgbs, twins=False)
    g = captured["g"].contiguous()
    pts = captured["args"][0]
    rgb_g = g.reshape(-1, 3, 4)[..., :3]
    print(f"   K4 bwd: cotangent {tuple(g.shape)} from the loss's graph, "
          f"max |RGB slots| {float(rgb_g.abs().max()):.3e}, mask slots "
          f"max {float(g[..., 3::4].abs().max()):.3e} (dropped)")
    require(float(rgb_g.abs().max()) > 0, "no cotangent reached the warp")
    res = k4_bwd_compare(g, pts, w2cs, intrs, imgs)
    entry = dict(name="K4 color_warp (bwd)", route="cuda",
                 source="mvsnerf_tpu_torch/csrc/color_warp.cu",
                 replaces="mvsnerf_tpu/ops/pallas_sweep.py:147",
                 **{k: v for k, v in res.items() if k != "extra"})
    x = res["extra"]
    print(f"   K4 bwd vs float64 ({x['samples']} samples): kernel "
          f"{x['err_f64_kernel']:.3e} / twin {x['err_f64_twin']:.3e} (max "
          f"|d imgs| {x['max_abs']:.3e}); kernel run-to-run "
          f"{x['rerun']:.3e}; grid_sampler_2d_backward vs twin "
          f"{x['library_vs_twin']:.3e}")
    print_k4_bwd_device(x)
    report(10, [entry], failures)
    # the same on one serving-sized chunk, a seeded random cotangent
    with torch.no_grad():
        pts_c = ray_marcher(requests[1][:CHUNK], N_SAMPLES)[0].contiguous()
    g_c = torch.randn((*pts_c.shape[:2], 4 * len(w2cs)), device=dev,
                      generator=gen.manual_seed(SEED + 10))
    chunk = k4_bwd_compare(g_c, pts_c, w2cs, intrs, imgs)
    print_k4_bwd_chunk(f"one {CHUNK} x {N_SAMPLES} chunk", chunk)
    check(chunk["max_abs_err"] <= chunk["tol"],
          "K4 bwd disagrees with its twin on a serving chunk", failures)
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "device_ms", "device_library_ms")
    entry["serving_chunk"] = {k: chunk[k] for k in keys}
    # the same on a chunk whose samples all clamp onto view 2's border
    pts_o = outside_view_points(w2cs, intrs, 2, CHUNK, N_SAMPLES)
    grid2 = k4.color_warp_grids(pts_o, w2cs, intrs, *imgs.shape[1:3])[2]
    outside = bool((grid2.abs() >= 1).any(-1).all())
    print(f"   all-clamped chunk: every sample outside view 2: {outside}")
    check(outside, "the all-clamped chunk has samples inside view 2",
          failures)
    g_o = torch.randn(g_c.shape, device=dev,
                      generator=gen.manual_seed(SEED + 13))
    clamped = k4_bwd_compare(g_o, pts_o, w2cs, intrs, imgs)
    print_k4_bwd_chunk("the all-clamped chunk", clamped)
    check(clamped["max_abs_err"] <= clamped["tol"],
          "K4 bwd disagrees with its twin on the all-clamped chunk",
          failures)
    entry["clamped_chunk"] = {k: clamped[k] for k in keys}
    del g, g_c, pts_c, captured, res, chunk, pts_o, g_o, grid2, clamped
    torch.cuda.empty_cache()

    # ---- (b) d loss / d imgs three ways from one state and draws: up to
    # FT_BATCH of 16 x FT_BATCH drawn rays whose samples all lie more than
    # KINK from every ReLU kink of the MLP (the fine-tune step's rule)
    pick = torch.randperm(len(scene.all_rays),
                          generator=torch.Generator().manual_seed(SEED + 11))
    pick = pick[:16 * FT_BATCH].numpy()
    rays = torch.from_numpy(scene.all_rays[pick]).to(dev)
    rgbs = torch.from_numpy(scene.all_rgbs[pick]).to(dev)
    gen.manual_seed(SEED + 12)
    samples = system._samples(rays, gen)
    pts, rays_d, _, ndc = samples
    with torch.no_grad():
        feats = renderer.gen_pts_feats(system.volume, ndc, pts, w2cs, intrs,
                                       imgs)
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        x = renderer.network_input(
            ndc, renderer.gen_dir_feature(w2cs[0], unit), feats)
        margin = k7.relu_margin(system.mlp, x).reshape(len(rays), -1)
    keep = torch.nonzero(margin.amin(1) > KINK)[:, 0]
    require(len(keep) >= FT_BATCH // 4,
            f"only {len(keep)} of {len(rays)} rays clear of the ReLU kinks")
    keep = keep[:FT_BATCH]
    samples = [x[keep] for x in samples]
    rgbs = rgbs[keep]
    del feats, x, margin, rays
    # the main path: counters reset just before the kernels' run
    counters = {"K4 color_warp": (k4.color_warp, "launches"),
                "K4 color_warp (bwd)": (k4.color_warp, "bwd_launches"),
                **k5_counters(),
                "K7 mlp_v0 (fwd)": (k7.mlp_v0_train, "launches"),
                "K7 mlp_v0 (bwd)": (k7.mlp_v0_train, "bwd_launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    loss_k, g_k = image_grads(system, samples, rgbs, twins=False)
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    loss_p, g_p = image_grads(system, samples, rgbs, twins=True)
    loss_64, g_64 = image_grads(system, samples, rgbs, twins=True, f64=True)
    g64_max = float(g_64.abs().max())
    err = {"kernels vs twins": max_err(g_k, g_p),
           "twins vs float64": max_err(g_p.double(), g_64),
           "kernels vs float64": max_err(g_k.double(), g_64)}
    tol = TOL_GEN_GRAD * max(err["twins vs float64"], 1e-6 * g64_max)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[10 step] d loss / d imgs from one state ({len(keep)} rays x "
          f"{N_SAMPLES} samples): loss kernels {loss_k:.7f} / twins "
          f"{loss_p:.7f} / twins in float64 {loss_64:.7f} (rel "
          f"{loss_rel:.2e}, tol 1e-5); max|g| {g64_max:.3e}; " + ", ".join(
              f"{k} {e:.2e}" for k, e in err.items()) + f" (tol {tol:.2e}); "
          f"launches {launches}")
    check(err["kernels vs float64"] <= tol and loss_rel <= 1e-5,
          f"the kernels' image gradient is further from float64 than "
          f"{TOL_GEN_GRAD} x the twins'", failures)
    check(g64_max > 0, "the render has no gradient in its images", failures)
    for name, n in launches.items():
        check(n == 1, f"{name} launched {n} times in one differentiable "
                      "render, not once", failures)
    entry["launches"] = launches[entry["name"]]

    # ---- (c) no earlier phase launched K4's backward
    print(f"[10 launches] K4 backward launches by phase: {earlier}, "
          f"phase 10: {entry['launches']}")
    check(not any(earlier.values()),
          "an earlier phase launched K4's backward", failures)

    # ---- (d) the geometry's gradient is refused on the card
    try:
        k4.color_warp(pts[:4].clone().requires_grad_(), w2cs, intrs, imgs)
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    print(f"[10 refusal] d pts_world on the card: {refused}")
    check(refused is not None, "the card computed a gradient in pts_world",
          failures)
    return entry


def density_chunk(system, rays, mlp):
    """Phase 11d's K6b and K8 inputs: the tiled render's samples of
    `rays` (unjittered, importance depths drawn from a generator seeded 1)
    over the trainer's density volume, their unit directions, the
    20-channel volume of the tiled render and the chunked render's
    features (the volume's fetch and K4's colours)."""
    import torch
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.interp import index_point_feature
    from mvsnerf_tpu_torch.render.renderer import gen_dir_feature, \
        sample_rays
    pose_t = system.pose_source
    w2cs, intrs = pose_t["w2cs"], pose_t["intrinsics"]
    gen = torch.Generator(device=rays.device).manual_seed(1)
    pts, rays_d, z, ndc = sample_rays(
        rays, N_SAMPLES, w2cs[0], intrs[0], system.imgs.shape[1:3],
        system.near_far, PAD, generator=gen,
        density_volume=system.density_volume, n_importance=N_IMPORTANCE)
    unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    volume = system.volume.detach()
    vol20 = torch.cat([volume, system.color_feature], -1).contiguous()
    colors = color_warp(pts.contiguous(), w2cs, intrs,
                        system.imgs.contiguous())
    feats = torch.cat([index_point_feature(volume, ndc), colors],
                      -1).contiguous()
    return (ndc.contiguous(), z.contiguous(),
            gen_dir_feature(w2cs[0], unit).contiguous(), vol20, feats)


def density_phase(dev, mlp, mvsnet, failures, ft_step_ms):
    """Phase 11; returns the S = N_SAMPLES + N_IMPORTANCE entries of K5,
    K7, K6b and K8. `ft_step_ms` is phase 6's step at N_SAMPLES."""
    import torch
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.render.renderer import render_density
    s_all = N_SAMPLES + N_IMPORTANCE
    sfx = f" S={s_all}"
    src6 = "mvsnerf_tpu_torch/csrc/render_v0.cu"
    flags = f"--use_density_volume --N_importance {N_IMPORTANCE}"

    t0 = time.perf_counter()
    scene = FinetuneScene(np.random.default_rng(SEED + 2))
    system = finetune_system(dev, mlp, mvsnet, scene, flags)
    print(f"[11 density] phase 6's configuration with {flags} (S = "
          f"{s_all}); set up in {time.perf_counter() - t0:.1f} s")

    # ---- (a) the density refresh, and a sample of it against float64
    n_vox = system.volume[..., 0].numel()
    refresh_ms = cuda_ms(system.update_density_volume)
    dv = system.density_volume
    require(tuple(dv.shape) == (N_PLANES, H // 4 + 2 * PAD,
                                W // 4 + 2 * PAD, 1)
            and bool(torch.isfinite(dv).all()),
            f"density volume {tuple(dv.shape)} not finite or not "
            "(128, 176, 208, 1)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    idx = torch.randperm(n_vox, generator=gen, device=dev)[:DENSITY_HELD]
    feats = torch.cat([system.volume.detach(), system.color_feature],
                      -1).reshape(n_vox, -1)[idx]
    pts = system.vox_pts.reshape(-1, 3)[idx]
    ref = render_density(copy.deepcopy(mlp).double(), pts.double(),
                         feats.double())
    d_err = max_err(dv.reshape(-1, 1)[idx].double(), ref)
    d_tol = TOL_DENSITY * (1 + float(ref.abs().max()))
    # the alpha head's multiply-adds a voxel: the trunk and alpha_linear
    macs = sum(i * o for name, i, o in rf._LAYERS if name not in (
        "feature_linear", "views_linears.0", "rgb_linear"))
    r_bound = bound(nbytes(system.vox_pts, system.volume,
                           system.color_feature, dv), 2 * macs * n_vox)
    print(f"[11 refresh] update_density_volume: {n_vox} voxels in "
          f"{refresh_ms:.2f} ms (CUDA events), bound {r_bound['bound_ms']:.2f}"
          f" ms ({r_bound['bound_by']}, f32 layers); sigma > 0 at "
          f"{float((dv > 0).float().mean()):.3f} of the voxels; "
          f"{DENSITY_HELD} voxels vs float64: max abs err {d_err:.3e} (tol "
          f"{d_tol:.1e})")
    check(d_err <= d_tol, "[11] the density refresh disagrees with float64",
          failures)
    del idx, feats, pts, ref

    # ---- (b) one step on the kernels, one on the twins, same state
    rays, rgbs = first_batch(scene, dev)
    gen.manual_seed(SEED)
    with torch.no_grad():
        z_step = system._samples(rays, gen)[2]
    require(tuple(z_step.shape) == (FT_BATCH, s_all),
            f"the step's samples {tuple(z_step.shape)}")
    plain_step_ms = step_parity(11, system, rays, rgbs, gen, failures)

    # ---- (c) the main path: fit (refreshing at step 0), launch counters
    # reset just before
    counters = {"K4 color_warp": (color_warp, "launches"),
                **k5_counters(sfx),
                f"K7 mlp_v0{sfx} (fwd)": (k7.mlp_v0_train, "launches"),
                f"K7 mlp_v0{sfx} (bwd)": (k7.mlp_v0_train, "bwd_launches")}
    launches, step_ms = timed_fit(11, system, counters, plain_step_ms,
                                  failures)
    print(f"[11 fit] the step at S={s_all}: {step_ms:.2f} ms against phase "
          f"6's {ft_step_ms:.2f} ms at S={N_SAMPLES} "
          f"({step_ms / ft_step_ms:.2f}x); a refresh every 200 of these "
          f"steps adds {refresh_ms / (200 * step_ms):.2%} to their time")

    # ---- (d) K5 and K7 at the step's shapes, K6b and K8 on one chunk
    kernels = []
    gen.manual_seed(SEED)
    with torch.no_grad():
        ndc = system._samples(rays, gen)[3].contiguous()
        k5_entries(kernels, system.volume.detach(), ndc, gen, failures, sfx)
        gen.manual_seed(SEED)
        x = system.mlp_input(rays, gen).reshape(-1, 86).contiguous()
        k7_entries(kernels, x, system.mlp, gen, failures, sfx)
        del ndc, x
        chunk = rays_for_pose(pose(0, 0.01, 0.05),
                              scene.pose_source["intrinsics"][0], H, W,
                              dev)[:CHUNK]
        ndc, z, dirs, vol20, feats = density_chunk(system, chunk, mlp)
        n_samp = ndc[..., 0].numel()
        mlp64 = copy.deepcopy(mlp).double()
        b_args = (ndc, z, None, dirs, vol20, mlp)
        r_k, r_p = rf.render_v0(*b_args), rf.render_v0_plain(*b_args)
        kernel_entry(kernels, f"K6b render_v0{sfx} (baked)", src6,
                     "mvsnerf_tpu/ops/pallas_render_tiled.py:313",
                     max_err(r_k, r_p), TOL_K6,
                     lambda: rf.render_v0(*b_args),
                     lambda: rf.render_v0_plain(*b_args), None,
                     nbytes(ndc, z, dirs, *r_k.values()) +
                     touched_volume_bytes(vol20, ndc), mlp_flops(n_samp),
                     RENDER_TC_PASSES, **f64_anchor(
                         r_k, r_p, lambda: rf.render_v0_plain(
                             ndc.double(), z.double(), None, dirs.double(),
                             vol20.double(), mlp64)))
        f_args = (ndc, feats, dirs, z, mlp)
        f_k, f_p = rf.render_v0_feats(*f_args), rf.render_v0_feats_plain(
            *f_args)
        kernel_entry(kernels, f"K8 render_v0_feats{sfx}", src6,
                     "mvsnerf_tpu/ops/pallas_kernels.py:196",
                     max_err(f_k, f_p), TOL_K6,
                     lambda: rf.render_v0_feats(*f_args),
                     lambda: rf.render_v0_feats_plain(*f_args), None,
                     nbytes(ndc, feats, dirs, z, *f_k.values()),
                     mlp_flops(n_samp), RENDER_TC_PASSES, **f64_anchor(
                         f_k, f_p, lambda: rf.render_v0_feats_plain(
                             ndc.double(), feats.double(), dirs.double(),
                             z.double(), mlp64)))
        print(f"   K6b / K8 chunk: {CHUNK} x {ndc.shape[1]} samples, acc "
              f"mean {float(r_p['acc'].mean()):.4f}")
        del ndc, z, dirs, vol20, feats, r_k, r_p, f_k, f_p, b_args, \
            f_args, mlp64
    report(11, kernels, failures)
    for k in kernels:
        if k["name"] in launches:
            k["launches"] = launches[k["name"]]
    # where the refresh's time goes (cuBLAS's f32 GEMMs against the rest),
    # and the step's, with the importance step's kernels as a group
    by_name = device_ms(system.update_density_volume, reps=2)
    gemm = sum(ms for name, ms in by_name.items() if "gemm" in name.lower())
    print(f"[11 profile] the refresh on the device: "
          f"{sum(by_name.values()):.2f} ms, of which GEMMs {gemm:.2f}; "
          f"largest: " + ", ".join(
              f"{name[:60]} {ms:.2f}" for name, ms in sorted(
                  by_name.items(), key=lambda kv: -kv[1])[:4]))
    step_profile(11, system, rays, rgbs, gen, {
        **FT_STEP_GROUPS, "importance draws (grid_sample, scans, "
        "searchsorted, gather, sort)": ("grid_sampler_3d", "scan",
                                        "searchsorted", "scatter_gather",
                                        "Sort", "sort")})

    # ---- (e) one 640x512 render_image per mode with the density volume
    rays_img = rays_for_pose(pose(0, 0.01, 0.05),
                             scene.pose_source["intrinsics"][0], H, W,
                             dev).cpu().numpy()
    for mode, (fn, attr) in (("tiled", (rf.render_v0, "baked_launches")),
                             ("chunked", (rf.render_v0_feats, "launches"))):
        setattr(fn, attr, 0)
        with swapped(system.args, "render_mode", mode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = system.render_image(rays_img, chunk=CHUNK)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = getattr(fn, attr)
        ok = all(tuple(out[k].shape[:1]) == (H * W,) and
                 bool(torch.isfinite(out[k]).all())
                 for k in ("rgb", "depth"))
        name = f"K6b render_v0{sfx} (baked)" if mode == "tiled" else \
            f"K8 render_v0_feats{sfx}"
        next(k for k in kernels if k["name"] == name)["launches"] = n
        print(f"[11 render] render_image {mode}: {H}x{W} rays at S={s_all} "
              f"in {ms:.1f} ms (from host rays; the tiled one joins the "
              f"colours to the volume first), {name.split()[0]} launches "
              f"{n}, finite {ok}")
        check(ok and n > 0, f"[11] the {mode} render with the density "
              "volume is not finite or never launched its kernel", failures)
        del out
    del system, rays_img
    torch.cuda.empty_cache()

    # ---- (f) one step with --use_disp, kernels against twins
    system = finetune_system(dev, mlp, mvsnet, scene, "--use_disp")
    print(f"[11 disp] --use_disp: MVSNet's volume on planes linear in "
          f"disparity, {tuple(system.volume.shape)}")
    step_parity("11 disp", system, rays, rgbs, gen, failures)
    del system
    torch.cuda.empty_cache()
    return kernels


class FusionScene:
    """In-memory fusion dataset on the bench rig: FUSE_VIEWS random 640x512
    training views in an arc around the reference pose (pose(0, 0.02 k,
    0.1 k)), their rays and pixels, their cameras (`load_poses_all`),
    `pair_idx` (the training views from the centre of the arc outwards:
    the fuse's first views, its reference among them, see the box
    squarely), the DTU box and `read_source_views(pair_idx=...)`. The
    principal point sits 0.37 / 0.29 pixel off the image centre: the fuse
    renders each view's own rays at 1/4 resolution, and with it at the
    centre their first row and column project back exactly onto the source
    view's border, where the colours' in-image mask flips on one ulp
    between two float32 routes."""

    def __init__(self, rng, n_views=None):
        from mvsnerf_tpu_torch.data.dtu_ft import rays_for_pose
        n_views = n_views or FUSE_VIEWS
        self.imgs = rng.uniform(0, 1, (n_views, H, W, 3)).astype(np.float32)
        self.intr = np.array([[FOCAL, 0, W / 2 + 0.37],
                              [0, FOCAL, H / 2 + 0.29], [0, 0, 1]],
                             np.float32)
        arc = np.arange(n_views) - n_views // 2
        self.w2cs = np.stack([pose(0, 0.02 * k, 0.1 * k) for k in arc])
        self.c2ws = np.linalg.inv(self.w2cs).astype(np.float32)
        self.pair_idx = [np.argsort(np.abs(arc), kind="stable"),
                         np.arange(1)]
        self.focal = [FOCAL, FOCAL]
        self.img_wh = (W, H)
        self.near_far = list(NEAR_FAR)
        self.bbox_3d = np.array(FUSE_BOX, np.float32)
        self.all_rays = np.concatenate([
            rays_for_pose(H, W, self.focal, self.intr[:2, 2], c2w, *NEAR_FAR)
            for c2w in self.c2ws])
        self.all_rgbs = self.imgs.reshape(-1, 3)

    def load_poses_all(self):
        return self.c2ws

    def read_source_views(self, pair_idx=None):
        idx = [int(i) for i in (pair_idx if pair_idx is not None
                                else [0, 1, 2])]
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
        intr_s4 = self.intr.copy()
        intr_s4[:2] /= 4
        p4 = np.tile(np.eye(4, dtype=np.float32), (len(idx), 1, 1))
        p4[:, :3] = intr_s4 @ self.w2cs[idx][:, :3]
        projs = (p4 @ np.linalg.inv(p4[0]))[:, :3].astype(np.float32)
        return ((self.imgs[idx] - mean) / std, projs, list(NEAR_FAR),
                {"w2cs": self.w2cs[idx], "c2ws": self.c2ws[idx],
                 "intrinsics": np.stack([self.intr] * len(idx))})


def fusion_system(dev, mlp, mvsnet, scene, extra=""):
    """`FusionFinetuneSystem` on `scene` from a reference-format checkpoint
    of the seeded weights (the constructor fuses every view), at phase 6's
    flags plus `extra`."""
    import tempfile

    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.train.fusion import FusionFinetuneSystem
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_seeded_checkpoint(os.path.join(tmp, "seeded.tar"), mlp,
                                      mvsnet)
        args = config_parser(
            f"--dataset_name dtu_ft --with_rgb_loss --pad {PAD} "
            f"--batch_size {FT_BATCH} --N_samples {N_SAMPLES} --ckpt {ckpt} "
            f"{extra}")
        return FusionFinetuneSystem(args, scene, device=dev)


def fuse_state(system):
    """The fuse's accumulator, volume and density, copied."""
    return (system.fuse_acc.clone(), system.volume.detach().clone(),
            system.density_volume.clone())


def fuse_compare(phase, what, ours, ref, failures):
    """Hold a fuse's (accumulator, volume, density) to another's by the
    TOL_FUSE / FUSE_FLOOR rules."""
    from mvsnerf_tpu_torch.train.fusion import WEIGHT
    acc, vol, dens = ours
    acc_r, vol_r, dens_r = ref
    used = slice(0, WEIGHT + 1)  # the channels after it are padding
    scale = acc_r[..., used].abs().amax(dim=(0, 1, 2))
    acc_err = float(((acc[..., used] - acc_r[..., used]).abs()
                     .amax(dim=(0, 1, 2)) / scale.clamp(min=1e-30)).max())
    firm = acc_r[..., WEIGHT] > FUSE_FLOOR
    require(bool(firm.any()), f"[{phase}] {what}: no voxel above the "
            "weight floor")
    v_err = max_err(vol[firm], vol_r[firm]) / (1 + float(vol_r.abs().max()))
    d_err = max_err(dens[firm], dens_r[firm]) / (1 + float(
        dens_r.abs().max()))
    print(f"[{phase} fuse] {what}: accumulators max err / channel max "
          f"{acc_err:.2e}; normalised volume {v_err:.2e}, density "
          f"{d_err:.2e} x (1 + max) over {int(firm.sum())} voxels, "
          f"{int((~firm).sum())} below the weight floor {FUSE_FLOOR} left "
          f"out (tol {TOL_FUSE:.0e})")
    check(max(acc_err, v_err, d_err) <= TOL_FUSE and
          float(firm.float().mean()) > 0.01,
          f"[{phase}] {what}: the fuses disagree", failures)


@contextlib.contextmanager
def first_call(module, name, calls):
    """`module.name` wrapped inside the block so that its first call's
    arguments land in `calls`."""
    fn = getattr(module, name)

    def spy(*a, **k):
        if not calls:
            calls.append((a, k))
        return fn(*a, **k)

    with swapped(module, name, spy):
        yield


# kernel groups of the fuse's profile, by name fragment (MVSNet: FeatureNet
# and the U-Net on cuDNN, K1; its batch norms and the rest fall in "rest")
FUSE_GROUPS = {
    "MVSNet on cuDNN (convolutions, norms)": (
        "conv", "fprop", "dgrad", "implicit", "winograd", "cudnn"),
    "K1": ("sweep_kernel", "sweep_pack"), "K4": ("color_warp_kernel",),
    "K8": ("render_v0_kernel",), "K5 splat": ("splat_kernel",),
    "the local volume's fetch (grid_sample)": ("grid_sampler_3d",)}


def fuse_profile(system):
    """`torch.profiler` over one fuse of every view: the device's busy share
    of its wall time and its time by kernel group (FUSE_GROUPS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.fuse_local_volumes(CHUNK)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    shares = dict.fromkeys([*FUSE_GROUPS, "rest"], 0.0)
    for name, ms in by_name.items():
        shares[next((g for g, keys in FUSE_GROUPS.items()
                     if any(k in name.lower() for k in keys)), "rest")] += ms
    print(f"[12 profile] one fuse: device busy {busy:.1f} of {wall_ms:.1f} ms "
          f"wall ({busy / wall_ms:.1%}); " + ", ".join(
              f"{g} {ms:.1f}" for g, ms in shares.items()))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"   {ms:8.2f} ms  {name[:100]}")


def fusion_phase(dev, mlp, mvsnet, failures):
    """Phase 12; returns its entries of the kernels line."""
    import torch
    from mvsnerf_tpu_torch.eval.video import render_video
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.sweep import sweep_cost_volume
    from mvsnerf_tpu_torch.render import renderer
    from mvsnerf_tpu_torch.render.renderer import gen_dir_feature, \
        sample_rays
    from mvsnerf_tpu_torch.train import fusion
    from torch.profiler import ProfilerActivity, profile
    src6 = "mvsnerf_tpu_torch/csrc/render_v0.cu"
    src5 = "mvsnerf_tpu_torch/csrc/volume_gather.cu"
    sfx = " 128³x20"
    mlp = copy.deepcopy(mlp)
    with torch.no_grad():
        mlp.nerf.alpha_linear.bias.fill_(FUSE_SIGMA_BIAS)

    t0 = time.perf_counter()
    scene = FusionScene(np.random.default_rng(SEED + 12))
    system = fusion_system(dev, mlp, mvsnet, scene, "--costreg_impl plain")
    vol = system.volume
    require(tuple(vol.shape) == (*fusion.FusionFinetuneSystem.VOLUME_DIM,
                                 20) and
            bool(torch.isfinite(vol).all()) and
            bool(torch.isfinite(system.density_volume).all()),
            f"fused volume {tuple(vol.shape)} not finite or not "
            "(128, 128, 128, 20)")
    covered = float((system.fuse_acc[..., fusion.WEIGHT] > FUSE_FLOOR)
                    .float().mean())
    print(f"[12 fusion] {FUSE_VIEWS} views of {H}x{W}, local renders "
          f"{W // 4}x{H // 4} x {fusion.FUSE_SAMPLES} samples, fused volume "
          f"{tuple(vol.shape)}; set up (the first fuse) in "
          f"{time.perf_counter() - t0:.1f} s; weight > {FUSE_FLOOR} at "
          f"{covered:.3f} of the voxels")

    # ---- (c) the first FUSE_HELD views on the kernels and on the twins;
    # the kernels' run also keeps one K8 chunk's and view 0's splat inputs
    # (spied where their callers look the kernels up, so that the wrappers'
    # own launch counters stay theirs)
    k8_calls, splat_calls = [], []
    with first_call(renderer, "render_v0_feats", k8_calls), \
            first_call(fusion, "volume_splat_kernel", splat_calls):
        system.fuse_local_volumes(CHUNK, n_views=FUSE_HELD)
    held = fuse_state(system)
    with twin_routes(True):
        system.fuse_local_volumes(CHUNK, n_views=FUSE_HELD, twins=True)
    fuse_compare(12, f"the first {FUSE_HELD} views, kernels against twins",
                 held, fuse_state(system), failures)

    # ---- (c) the main path: the fuse of every view, launch counters reset
    # just before, timed with events, its stages too
    wrappers = {"K1": (sweep_cost_volume, "launches"),
                "K4": (color_warp, "launches"),
                "K8 alpha": (rf.render_v0_feats, "launches"),
                "K5 splat": (fusion.splat_trilinear, "launches")}
    stages = {"_local_volume": [], "_local_render_chunk": [],
              "_splat_view": []}

    def timed(name):
        fn = getattr(system, name)

        def call(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            stages[name].append(ev)
            return out
        return call

    fuse_ms = []
    for rep in range(2):
        for fn, attr in wrappers.values():
            setattr(fn, attr, 0)
        for name in stages:
            stages[name] = []
            setattr(system, name, timed(name))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        system.fuse_local_volumes(CHUNK)
        ev[1].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for name in stages:
            delattr(system, name)
        fuse_ms.append(ev[0].elapsed_time(ev[1]))
        stage_ms = {name: sum(a.elapsed_time(b) for a, b in evs)
                    for name, evs in stages.items()}
        fuse_launches = {k: getattr(fn, attr)
                         for k, (fn, attr) in wrappers.items()}
        print(f"[12 fuse] fuse_local_volumes over {FUSE_VIEWS} views, run "
              f"{rep + 1}: fuse ms {fuse_ms[-1]:.1f} (events; host clock "
              f"{wall:.1f}); MVSNet {stage_ms['_local_volume']:.1f} ms "
              f"({stage_ms['_local_volume'] / fuse_ms[-1]:.1%}), local "
              f"render {stage_ms['_local_render_chunk']:.1f} "
              f"({stage_ms['_local_render_chunk'] / fuse_ms[-1]:.1%}), splat "
              f"{stage_ms['_splat_view']:.1f} "
              f"({stage_ms['_splat_view'] / fuse_ms[-1]:.1%}); launches "
              f"{fuse_launches}")
    for name, n in fuse_launches.items():
        check(n > 0, f"{name} never launched in the phase 12 fuse", failures)
    require(bool(torch.isfinite(system.volume).all()),
            "non-finite fused volume")

    # ---- (d) one step on the kernels against one on the twins, then the
    # main path: fit, launch counters reset just before
    rays, rgbs = first_batch(scene, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    plain_step_ms = step_parity(12, system, rays, rgbs, gen, failures)
    counters = {**k5_counters(sfx),
                "K7 mlp_v0 (fwd)": (k7.mlp_v0_train, "launches"),
                "K7 mlp_v0 (bwd)": (k7.mlp_v0_train, "bwd_launches")}
    fit_launches, step_ms = timed_fit(12, system, counters, plain_step_ms,
                                      failures)
    with swapped(system.args, "N_importance", N_IMPORTANCE):
        gen.manual_seed(SEED)
        with torch.no_grad():
            s_all = system._samples(rays, gen)[2].shape[1]
        require(s_all == N_SAMPLES + N_IMPORTANCE,
                f"the importance step's samples: {s_all}")
        step_parity(f"12 N_importance={N_IMPORTANCE}", system, rays, rgbs,
                    gen, failures)

    # ---- (e) one 640x512 render_image per mode at perturb 0, launch
    # counters reset just before each; then 3 video frames
    rays_img = rays_for_pose(pose(0, 0.01, 0.05), scene.intr, H, W,
                             dev).cpu().numpy()
    outs, render_launches = {}, {}
    for mode, counted in (
            ("tiled", {"K6b": (rf.render_v0, "baked_launches")}),
            ("chunked", {"K8": (rf.render_v0_feats, "launches"),
                         "K5 fwd": (k5.sample_volume, "launches")})):
        for fn, attr in counted.values():
            setattr(fn, attr, 0)
        with swapped(system.args, "render_mode", mode), \
                swapped(system.args, "perturb", 0.0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = system.render_image(rays_img, chunk=CHUNK)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = {k: getattr(fn, attr) for k, (fn, attr) in counted.items()}
        render_launches[mode] = n
        ok = all(tuple(out[k].shape[:1]) == (H * W,) and
                 bool(torch.isfinite(out[k]).all()) for k in ("rgb", "depth"))
        print(f"[12 render] render_image {mode}: {H}x{W} rays in {ms:.1f} ms "
              f"(request ms; from host rays), launches {n}, finite {ok}")
        check(ok and all(n.values()), f"[12] the {mode} render is not finite "
              "or never launched its kernels", failures)
        outs[mode] = out
    worst = max_err(outs["tiled"]["rgb"], outs["chunked"]["rgb"])
    acc_mean = float(outs["tiled"]["acc"].mean())
    print(f"[12 render] tiled vs chunked rgb max abs diff {worst:.3e} (tol "
          f"{TOL_MODES:.0e}); acc mean {acc_mean:.4f}")
    check(worst <= TOL_MODES, "[12] the tiled and chunked fusion renders "
          "disagree", failures)
    del outs
    rf.render_v0.baked_launches = 0
    with swapped(system.args, "render_mode", "tiled"):
        t0 = time.perf_counter()
        frames = render_video(system, scene.c2ws[:VIDEO_FRAMES], H, W,
                              scene.focal, NEAR_FAR, chunk=CHUNK)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    print(f"[12 video] {len(frames)} frames of {H}x{W} in the tiled mode, "
          f"{ms:.1f} ms/frame, K6b launches {rf.render_v0.baked_launches}")
    check(len(frames) == VIDEO_FRAMES and
          all(f.shape == (H, W, 3) for f in frames) and
          rf.render_v0.baked_launches > 0,
          "[12] render_video's frames are wrong or K6b never ran", failures)

    # ---- (a), (b) and the step's kernels against their twins, after the
    # timed runs (torch.profiler can slow later launches on the host)
    kernels = []
    with torch.no_grad():
        # render_rays' call: (ndc, feats, dirs, z, mlp, with_alpha)
        f_args = k8_calls[0][0][:5]
        ndc, feats, dirs, z, m = f_args
        f_k = rf.render_v0_feats(*f_args, with_alpha=True)
        f_p = rf.render_v0_feats_plain(*f_args, with_alpha=True)
        mlp64 = copy.deepcopy(m).double()
        kernel_entry(kernels, "K8 render_v0_feats alpha", src6,
                     "mvsnerf_tpu/ops/pallas_kernels.py:196",
                     max_err(f_k, f_p), TOL_K6,
                     lambda: rf.render_v0_feats(*f_args, with_alpha=True),
                     lambda: rf.render_v0_feats_plain(*f_args, True), None,
                     nbytes(ndc, feats, dirs, z, *f_k.values()),
                     mlp_flops(ndc[..., 0].numel()), RENDER_TC_PASSES,
                     alpha_max_abs_err=max_err(f_k["alpha"], f_p["alpha"]),
                     **f64_anchor(f_k, f_p, lambda: rf.render_v0_feats_plain(
                         *(a.double() for a in f_args[:4]), mlp64)))
        print(f"   K8 alpha chunk: {tuple(ndc.shape[:2])} of view 0's local "
              f"render; alpha err {kernels[-1]['alpha_max_abs_err']:.3e}, "
              f"weights err {max_err(f_k['weights'], f_p['weights']):.3e}")
        del k8_calls, f_args, f_k, f_p, feats

        # `splat_trilinear`'s call of K5: (masked vals, pts_ndc, shape)
        vals, ndc = splat_calls[0][0][:2]
        ndc, shape = ndc.contiguous(), (*fusion.FusionFinetuneSystem
                                        .VOLUME_DIM, fusion.SPLAT_CHANNELS)
        keep = fusion.splat_keep(ndc, shape)
        g = (vals * keep[..., None]).contiguous()
        adds = torch.zeros(2, dtype=torch.int64, device=dev)
        k5.volume_splat_kernel(g, ndc, shape, adds=adds)
        rule = k5.splat_merges(ndc, shape)[1]
        n_add, n_merged = adds.tolist()
        print(f"   K5 fuse splat: {ndc[..., 0].numel()} samples of view 0, "
              f"{int((~keep).sum())} dropped by JAX's rule (rows zeroed); "
              f"{n_merged} of {n_add + n_merged} corner adds "
              f"({n_merged / max(1, n_add + n_merged):.2%}) merged, {n_add} "
              f"atomics; the rule counts {rule}")
        check((n_add, n_merged) == rule, "the fuse splat merged other "
              "corners than its rule", failures)
        a_k = fusion.splat_trilinear(torch.zeros(shape, device=dev), ndc,
                                     vals)
        a_p = fusion.splat_trilinear_plain(torch.zeros(shape, device=dev),
                                           ndc, vals)
        acc_k, acc_p = torch.zeros(shape, device=dev), \
            torch.zeros(shape, device=dev)
        vol5 = torch.zeros((1, shape[-1], *shape[:3]), device=dev)
        g5 = g.reshape(-1, shape[-1]).t().reshape(1, shape[-1], -1, 1, 1) \
            .contiguous()
        grid5 = (ndc * 2 - 1).reshape(1, -1, 1, 1, 3)
        kernel_entry(kernels, "K5 volume_splat fuse C=24", src5,
                     "mvsnerf_tpu/ops/pallas_volgather2.py:268",
                     max_err(a_k, a_p), TOL_K5 * (1 + float(a_p.abs().max())),
                     lambda: fusion.splat_trilinear(acc_k, ndc, vals),
                     lambda: fusion.splat_trilinear_plain(acc_p, ndc, vals),
                     lambda: torch.ops.aten.grid_sampler_3d_backward(
                         g5, vol5, grid5, 0, 0, True, [True, False]),
                     nbytes(vals, ndc) + 2 * touched_volume_bytes(a_p, ndc),
                     ndc[..., 0].numel() * (30 + 8 * shape[-1] * 2),
                     dropped=int((~keep).sum()))
        del splat_calls, vals, g, g5, vol5, a_k, a_p, acc_k, acc_p, keep

        gen.manual_seed(SEED)
        ndc = system._samples(rays, gen)[3].contiguous()
        k5_entries(kernels, system.volume.detach(), ndc, gen, failures, sfx)
        chunk = torch.from_numpy(rays_img[:CHUNK]).to(dev)
        _, rays_d, z, ndc = sample_rays(chunk, N_SAMPLES, None, None, None,
                                        None, None, bbox=system.bbox)
        unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        dirs = gen_dir_feature(system.pose_source["w2cs"][0], unit)
        vol20 = system.volume.detach().contiguous()
        b_args = (ndc.contiguous(), z.contiguous(), None, dirs.contiguous(),
                  vol20, m)
        r_k, r_p = rf.render_v0(*b_args), rf.render_v0_plain(*b_args)
        kernel_entry(kernels, "K6b render_v0 bbox (baked)", src6,
                     "mvsnerf_tpu/ops/pallas_render_tiled.py:313",
                     max_err(r_k, r_p), TOL_K6,
                     lambda: rf.render_v0(*b_args),
                     lambda: rf.render_v0_plain(*b_args), None,
                     nbytes(*b_args[:2], b_args[3], *r_k.values()) +
                     touched_volume_bytes(vol20, b_args[0]),
                     mlp_flops(ndc[..., 0].numel()), RENDER_TC_PASSES,
                     **f64_anchor(r_k, r_p, lambda: rf.render_v0_plain(
                         b_args[0].double(), b_args[1].double(), None,
                         b_args[3].double(), vol20.double(), mlp64)))
        print(f"   K6b bbox chunk: {CHUNK} x {N_SAMPLES} samples in the box, "
              f"acc mean {float(r_p['acc'].mean()):.4f}")
        del b_args, r_k, r_p, vol20, mlp64
    report(12, kernels, failures)
    fuse_profile(system)
    launches = {"K8 render_v0_feats alpha": fuse_launches["K8 alpha"],
                "K5 volume_splat fuse C=24": fuse_launches["K5 splat"],
                "K6b render_v0 bbox (baked)":
                    render_launches["tiled"]["K6b"], **fit_launches}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    acc_cudnn = held
    del system
    torch.cuda.empty_cache()

    # ---- (f) --costreg_impl dband: the first FUSE_HELD views, K10's
    # launches and no library convolution in their U-Nets
    system = fusion_system(dev, mlp, mvsnet, scene, "--costreg_impl dband")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    system.fuse_local_volumes(CHUNK)
    ev[1].record()
    torch.cuda.synchronize()
    dband_ms = ev[0].elapsed_time(ev[1])
    print(f"[12 dband] fuse_local_volumes over {FUSE_VIEWS} views on "
          f"--costreg_impl dband: fuse ms {dband_ms:.1f} (events)")
    for key in k10.launches:
        k10.launches[key] = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        system.fuse_local_volumes(CHUNK, n_views=FUSE_HELD)
        torch.cuda.synchronize()
    names = [e.name for e in sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start)]
    span = unet_spans(names)
    stray = sorted({n for n in span if not is_k10(n) and (
        any(f in n.lower() for f in CONV_LIBRARY_NAMES) or
        "gemm" in n.lower())})
    want = {k: FUSE_HELD * n for k, n in
            {"s1": 4, "s2": 3, "up": 3, "wgrad": 0}.items()}
    print(f"[12 dband] the first {FUSE_HELD} views' fuse on "
          f"--costreg_impl dband: K10 launches {dict(k10.launches)} (want "
          f"{want}); {len(span)} kernels in the U-Nets' spans, library "
          f"convolutions or GEMMs among them: {stray}")
    check(dict(k10.launches) == want and not stray and
          any(is_k10(n) for n in span),
          "[12] the dband fuse's U-Nets ran other than K10", failures)
    fuse_compare("12 dband", f"the first {FUSE_HELD} views, dband against "
                 "cuDNN", fuse_state(system), acc_cudnn, failures)
    print(f"[12 summary] fuse ms {min(fuse_ms):.1f} on cuDNN's U-Net, "
          f"{dband_ms:.1f} on dband; step {step_ms:.2f} ms, "
          f"{FT_BATCH / step_ms * 1e3:.0f} rays/s")
    del system, acc_cudnn, held
    torch.cuda.empty_cache()
    return kernels


class Counted:
    """`fn` counting its calls in `calls`."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def write_dataset_scenes(root):
    """Phase 13's scenes under `root`: Blender `lego` at 800x800 (RGBA PNGs
    of the 20 frames its pair table names, 100 poses) and LLFF `fern` at
    960x640 (20 images); {dataset: directory}."""
    from mvsnerf_tpu_torch.data import synthetic
    from mvsnerf_tpu_torch.data.pairs import get_split
    dirs = {"blender": os.path.join(root, "lego"),
            "llff": os.path.join(root, "fern")}
    frames = np.concatenate([get_split("lego", "train"),
                             get_split("lego", "val")])
    synthetic.write_blender_scene(dirs["blender"], res=800, frames=frames,
                                  seed=SEED + 13)
    synthetic.write_llff_scene(dirs["llff"], wh=(960, 640), seed=SEED + 14)
    return dirs


def dataset_counters():
    """Phase 13's launch counters: name -> (object, attribute)."""
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.sweep import sweep_cost_volume
    return {"K1": (sweep_cost_volume, "launches"),
            "K4": (color_warp, "launches"),
            "K5 fwd": (k5.sample_volume, "launches"),
            "K5 bwd": (k5.sample_volume, "bwd_launches"),
            "K6": (rf.render_v0, "launches"),
            "K6b": (rf.render_v0, "baked_launches"),
            "K7 fwd": (k7.mlp_v0_train, "launches"),
            "K7 bwd": (k7.mlp_v0_train, "bwd_launches"),
            "K8": (rf.render_v0_feats, "launches"),
            "K10 s2 generic": (k10.s2_routes, "generic"),
            "K10 s2 pair": (k10.s2_routes, "pair")}


def zero_counts(counters):
    for obj, attr in counters.values():
        if isinstance(obj, dict):
            obj[attr] = 0
        else:
            setattr(obj, attr, 0)


def read_counts(counters):
    return {name: obj[attr] if isinstance(obj, dict) else getattr(obj, attr)
            for name, (obj, attr) in counters.items()}


def synced_ms(fn):
    """(fn()'s result, host ms of the call, synchronised on both sides)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dataset_run(dev, mlp, mvsnet, name, datadir, ckpt, white, tmp,
                failures):
    """Phase 13 (a)-(e) and (g) on one dataset; returns what the kernel
    entries need (K1's inputs, K10's generic stride-2 call) and the
    launches and times of its main paths."""
    import torch
    from mvsnerf_tpu_torch import evaluate, native, render_video, \
        train_finetune
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.data import dataset_dict
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.render import tiled
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    tag = f"13 {name}"
    counters = dataset_counters()
    total = dict.fromkeys(counters, 0)

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    # ---- (a) the loader
    flags = (f"--dataset_name {name} --datadir {datadir} --with_rgb_loss "
             f"--pad {PAD} --batch_size {FT_BATCH} --N_samples {N_SAMPLES} "
             f"--ckpt {ckpt}" + (" --white_bkgd" if white else ""))
    args = config_parser(flags)
    t0 = time.perf_counter()
    train = dataset_dict[name](args, "train")
    val = dataset_dict[name](args, "val")
    src = train.read_source_views()
    load_s = time.perf_counter() - t0
    w, h = train.img_wh
    nf = train.all_rays[:, 6:]
    print(f"[{tag} loader] train: {len(train.all_rays)} rays of "
          f"{len(train.img_idx)} views at {w}x{h}; val: {len(val)} views "
          f"{tuple(val.all_rgbs.shape)}; focal {np.round(train.focal, 3)}; "
          f"rays' near/far in [{nf[:, 0].min():.4f}, {nf[:, 1].max():.4f}], "
          f"the sources' {np.round(src[2], 4).tolist()}; loaded (train, "
          f"val, sources) in {load_s:.2f} s")
    require(train.img_wh == DATASET_WH[name] and
            val.all_rays.shape == (len(val), w * h, 8) and
            src[0].shape == (3, h, w, 3), f"[{tag}] the loader's shapes")
    if white:
        print(f"   alpha masks: {float(val.all_masks.mean()):.3f} of the "
              f"val pixels opaque; a clear corner's rgb "
              f"{val.all_rgbs[0, 0, 0].tolist()}")
        check(bool((val.all_rgbs[:, 0, 0] == 1.0).all()),
              f"[{tag}] the clear pixels are not white", failures)

    # ---- (b) the volume build on cuDNN and on dband
    ev = Evaluator(mvsnet, mlp, n_samples=N_SAMPLES, pad=PAD, chunk=CHUNK,
                   white_bkgd=white, device=dev, costreg_impl="plain")
    ev_d = Evaluator(mvsnet, mlp, n_samples=N_SAMPLES, pad=PAD, chunk=CHUNK,
                     white_bkgd=white, device=dev, costreg_impl="dband")
    builds = {}
    for label, e in (("cuDNN", ev), ("dband", ev_d)):
        e.build_volume(*src)
        zero_counts(counters)
        vol, builds[label] = synced_ms(lambda: e.build_volume(*src)[0])
        counts = read_counts(counters)
        add(counts)
        again = [synced_ms(lambda: e.build_volume(*src))[1]
                 for _ in range(BUILD_AGAIN)]
        print(f"[{tag} volume] build_volume on {label}: {builds[label]:.1f} "
              f"ms (then {[round(t, 1) for t in again]}), volume "
              f"{tuple(vol.shape)}, launches K1 {counts['K1']}, K10 s2 by "
              f"route: generic {counts['K10 s2 generic']}, pair "
              f"{counts['K10 s2 pair']}")
        if label == "cuDNN":
            vol_c = vol
    require(tuple(vol_c.shape) == (N_PLANES, h // 4 + 2 * PAD,
                                   w // 4 + 2 * PAD, 8) and
            bool(torch.isfinite(vol_c).all()), f"[{tag}] the volume")
    rel = max_err(vol, vol_c) / float(vol_c.abs().max())
    print(f"[{tag} volume] dband against cuDNN: max abs diff / max "
          f"{rel:.2e} (tol 1e-4)")
    check(rel <= 1e-4, f"[{tag}] the dband volume disagrees with cuDNN's",
          failures)
    check(total["K10 s2 generic"] == (1 if name == "blender" else 0),
          f"[{tag}] K10's generic stride-2 route ran "
          f"{total['K10 s2 generic']} times in the dband build", failures)
    del vol, vol_c
    generic_calls = []

    def recording(x, w_, stride, *rest):
        if stride == 2 and not k10.library().conv3d_s2_pairs(
                x.shape[4], k10.out_size(x.shape[4], 2)):
            generic_calls.append((x.detach().clone(), w_.detach().clone()))
        return fn(x, w_, stride, *rest)

    fn = k10.conv3d_fwd
    with swapped(k10, "conv3d_fwd", recording), torch.no_grad():
        ev_d.build_volume(*src)
    k1 = k1_inputs(ev, (src[0], src[1], src[3]), src[2])
    del ev_d

    # ---- (c) the fine-tune step and fit, the batches from the native
    # gather
    system = FinetuneSystem(args, train, val, device=dev)
    rays, rgbs = first_batch(train, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    plain_ms = step_parity(tag, system, rays, rgbs, gen, failures)
    gather = Counted(native.ray_gather)
    fit_counters = {"K4 color_warp": counters["K4"], **k5_counters(),
                    "K7 mlp_v0 (fwd)": counters["K7 fwd"],
                    "K7 mlp_v0 (bwd)": counters["K7 bwd"],
                    "native.ray_gather": (gather, "calls")}
    zero_counts(counters)
    with swapped(native, "ray_gather", gather):
        _, step_ms = timed_fit(tag, system, fit_counters, plain_ms, failures)
    add(read_counts(counters))
    # ---- (g) the native library
    idx = np.random.default_rng(SEED).permutation(len(train.all_rays))[
        :FT_BATCH]
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        native.ray_gather(train.all_rays, train.all_rgbs, idx)
    t_native = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        train.all_rays[idx], train.all_rgbs[idx]
    t_numpy = (time.perf_counter() - t0) * 1e3 / reps
    print(f"[{tag} native] native.available() {native.available()}; fit's "
          f"batches from native.ray_gather: {gather.calls} calls; a "
          f"{FT_BATCH}-ray batch gathered in {t_native:.4f} ms native, "
          f"{t_numpy:.4f} ms numpy (host clock, {reps} calls)")
    check(native.available() and gather.calls >= FT_WARM + FT_TIMED,
          f"[{tag}] the fine-tune's batches did not come from the native "
          "gather", failures)
    step_profile(tag, system, rays, rgbs, gen, FT_STEP_GROUPS)
    del system, rays, rgbs
    torch.cuda.empty_cache()

    # ---- (d) one full-resolution request in each mode
    ev.build_volume(*src)
    rays_v = torch.from_numpy(val[0]["rays"]).to(dev)
    want = {"chunked": ("K4", "K8"), "hybrid": ("K4", "K6"),
            "tiled": ("K6b",)}
    outs, request_ms = {}, {}
    for mode, kernels_of_mode in want.items():
        ev.render(rays_v, h, w, mode=mode)  # the renderer's first request
        zero_counts(counters)
        out, request_ms[mode] = synced_ms(
            lambda: ev.render(rays_v, h, w, mode=mode))
        counts = read_counts(counters)
        add(counts)
        ok = all(tuple(out[k].shape) == s and bool(torch.isfinite(out[k])
                                                   .all())
                 for k, s in (("rgb", (h * w, 3)), ("depth", (h * w,)),
                              ("acc", (h * w,))))
        print(f"[{tag} request] {mode}: {w}x{h} in {request_ms[mode]:.1f} "
              f"ms ({h * w / request_ms[mode] * 1e3:.0f} rays/s), launches "
              f"{ {k: counts[k] for k in ('K4', 'K6', 'K6b', 'K8')} }, acc "
              f"mean {float(out['acc'].mean()):.4f}, finite {ok}")
        check(ok and all(counts[k] > 0 for k in kernels_of_mode),
              f"[{tag}] the {mode} request is not finite or never launched "
              f"{kernels_of_mode}", failures)
        outs[mode] = out
    # K6b held to its twin on the same baked volume, as in phase 9
    with torch.no_grad(), swapped(tiled, "render_v0", rf.render_v0_plain):
        twin = ev.render(rays_v, h, w, mode="tiled")
    terr = max_err(outs["tiled"], twin)
    worst = max_err(outs["hybrid"]["rgb"], outs["chunked"]["rgb"])
    print(f"[{tag} request] hybrid vs chunked rgb max abs diff {worst:.3e} "
          f"(tol {TOL_MODES:.0e}); tiled vs its twin path on the same baked "
          f"volume {tuple(ev.renderer('tiled').volume.shape)}: max abs err "
          f"{terr:.3e} (tol {TOL_K6:.0e}); tiled vs chunked (baked against "
          f"exact colours, no tolerance) "
          f"{max_err(outs['tiled']['rgb'], outs['chunked']['rgb']):.3e}")
    check(worst <= TOL_MODES, f"[{tag}] hybrid and chunked disagree",
          failures)
    check(terr <= TOL_K6, f"[{tag}] the tiled request disagrees with its "
          "twin path", failures)
    del twin
    del outs, rays_v, ev
    torch.cuda.empty_cache()

    # ---- (e) the CLIs, on the card, in a directory of their own
    base = ["--dataset_name", name, "--datadir", datadir, "--ckpt", ckpt,
            "--pad", str(PAD), "--with_rgb_loss", "--expname",
            f"smoke_{name}"] + (["--white_bkgd"] if white else [])
    snapshot = os.path.join("runs_fine_tuning", f"smoke_{name}", "ckpts",
                            f"ckpt_{CLI_STEPS:09d}.pt")
    s2_route = "K10 s2 generic" if name == "blender" else "K10 s2 pair"
    clis = (("train_finetune", ("K1", "K4", "K5 fwd", "K5 bwd", "K7 fwd",
                                "K7 bwd", "K8"),
             lambda: train_finetune.main(base + ["--max_steps",
                                                 str(CLI_STEPS)])),
            ("evaluate --render_mode hybrid", ("K1", "K4", "K6", s2_route),
             lambda: evaluate.main(base + ["--render_mode", "hybrid"])),
            ("render_video --render_mode tiled", ("K1", "K6b"),
             lambda: render_video.main(base + ["--render_mode", "tiled",
                                               "--ckpt", snapshot],
                                       n_frames=CLI_FRAMES)))
    cli_out = {}
    with contextlib.chdir(tmp):
        for label, needed, run in clis:
            zero_counts(counters)
            cli_out[label], ms = synced_ms(run)
            counts = read_counts(counters)
            add(counts)
            print(f"[{tag} cli] {label}: {ms / 1e3:.1f} s, launches "
                  f"{ {k: n for k, n in counts.items() if n} }")
            check(all(counts[k] > 0 for k in needed),
                  f"[{tag}] {label} never launched one of {needed}", failures)
    metrics = cli_out[clis[1][0]]
    frames = cli_out[clis[2][0]]
    print(f"[{tag} cli] evaluate's mean over {len(metrics['per_image'])} "
          f"val views: { {k: round(v, 4) for k, v in metrics['mean'].items()} }"
          f"; render_video: {len(frames)} frames of "
          f"{frames[0].shape if frames else None}")
    check(len(metrics["per_image"]) == len(val) and
          all(math.isfinite(v) for v in metrics["mean"].values()) and
          len(frames) == CLI_FRAMES and
          all(f.shape == (h, 2 * w, 3) for f in frames),
          f"[{tag}] the CLIs' outputs are wrong", failures)

    # ---- (f) every kernel of the path ran
    print(f"[{tag} launches] over (b)-(e): "
          f"{ {k: n for k, n in total.items()} }")
    needed = ["K1", "K4", "K5 fwd", "K5 bwd", "K6", "K6b", "K7 fwd",
              "K7 bwd", "K8", s2_route]
    check(all(total[k] > 0 for k in needed),
          f"[{tag}] a kernel of the path never launched", failures)
    print(f"[{tag} summary] volume build {builds['cuDNN']:.1f} ms on cuDNN, "
          f"{builds['dband']:.1f} on dband; fine-tune {step_ms:.2f} "
          f"ms/step, {FT_BATCH / step_ms * 1e3:.0f} rays/s; ms/request "
          f"chunked {request_ms['chunked']:.1f}, hybrid "
          f"{request_ms['hybrid']:.1f}, tiled {request_ms['tiled']:.1f}")
    return dict(k1=k1, generic=generic_calls, launches=total, src=src,
                white=white, rays=val[0]["rays"], hw=(h, w))


def dataset_kernel_entries(name, rec, failures):
    """K1 at the dataset's volume and, for Blender, K10's generic stride-2
    call (conv5, input width 62) against their twins, with the library
    call (cuDNN's F.conv3d for K10), device times and bounds."""
    import torch
    import torch.nn.functional as F
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    from mvsnerf_tpu_torch.ops.sweep import sweep_cost_volume, \
        sweep_cost_volume_plain
    kernels = []
    with torch.no_grad():
        k1 = rec["k1"]
        srcs, proj_t, depths = k1[:3]
        out_k, out_p = sweep_cost_volume(*k1), sweep_cost_volume_plain(*k1)
        shape = tuple(out_k.shape[2:])
        kernel_entry(kernels, f"K1 sweep_cost_volume {name} {shape}",
                     "mvsnerf_tpu_torch/csrc/sweep.cu",
                     "mvsnerf_tpu/ops/pallas_sweep2.py:316",
                     max_err(out_k, out_p),
                     TOL_K1 * (1 + float(out_p.abs().max())),
                     lambda: sweep_cost_volume(*k1),
                     lambda: sweep_cost_volume_plain(*k1), None,
                     nbytes(srcs, proj_t, depths, out_k),
                     sweep_flops(3, 32, out_k[0, 0].numel()))
        kernels[-1]["launches"] = rec["launches"]["K1"]
        del out_k, out_p
        for x, w in rec["generic"]:
            out_k = k10.conv3d_fwd_kernel(x, w, 2)
            out_p = k10.conv3d_fwd_plain(x, w, 2)
            taps = [k10_taps(n, m, 2) for n, m in zip(out_k.shape[2:],
                                                      x.shape[2:])]
            kernel_entry(kernels, f"K10 conv3d_s2 generic {name}",
                         "mvsnerf_tpu_torch/csrc/conv3d.cu",
                         K10_ENTRIES["s2"][1], max_err(out_k, out_p),
                         TOL_K10 * (1 + float(out_p.abs().max())),
                         lambda: k10.conv3d_fwd_kernel(x, w, 2),
                         lambda: k10.conv3d_fwd_plain(x, w, 2),
                         lambda: F.conv3d(x, w, stride=2, padding=1),
                         nbytes(x, w, out_k),
                         2 * w.shape[0] * w.shape[1] * math.prod(taps),
                         shape=f"{tuple(x.shape[1:])} -> "
                               f"{tuple(out_k.shape[1:])}")
            kernels[-1]["launches"] = rec["launches"]["K10 s2 generic"]
            lib = device_ms(lambda: F.conv3d(x, w, stride=2, padding=1))
            print(f"   K10 generic {name}: cuDNN's call on the device, by "
                  f"kernel (torch.profiler): "
                  f"{ {k[:70]: round(v, 4) for k, v in lib.items()} }")
            del out_k, out_p
    report(13, kernels, failures)
    return kernels


def call_profile(tag, what, fn, top=6):
    """`torch.profiler` over one call of `fn` after a first one: device
    busy time against the wall, and the `top` kernels by device time with
    their shares."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = synced_ms(fn)
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(us.values()) / 1e3
    print(f"[{tag} profile] {what}: device busy {total:.2f} of {wall:.2f} "
          f"ms wall ({100 * total / wall:.1f} %)")
    for name, t in sorted(us.items(), key=lambda kv: -kv[1])[:top]:
        print(f"   {t / 1e3:8.3f} ms ({100 * t / 1e3 / max(total, 1e-9):5.1f}"
              f" %)  {name[:100]}")


def dataset_phase(dev, mlp, mvsnet, failures):
    """Phase 13; returns its entries of the kernels line."""
    import tempfile

    import torch
    t_phase = time.perf_counter()
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dirs = write_dataset_scenes(tmp)
        ckpt = save_seeded_checkpoint(os.path.join(tmp, "seeded.tar"), mlp,
                                      mvsnet)
        print(f"[13 scenes] lego (800x800, 20 RGBA frames) and fern "
              f"(960x640, 20 images) written in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, white in (("blender", True), ("llff", False)):
            records[name] = dataset_run(dev, mlp, mvsnet, name, dirs[name],
                                        ckpt, white, tmp, failures)
            torch.cuda.empty_cache()
    # the kernel entries after every timed run: torch.profiler can leave
    # CUPTI attached and slow later launches on the host
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    kernels = []
    for name, rec in records.items():
        kernels += dataset_kernel_entries(name, rec, failures)
        h, w = rec["hw"]
        rays = torch.from_numpy(rec["rays"]).to(dev)
        for impl in ("plain", "dband"):
            ev = Evaluator(mvsnet, mlp, n_samples=N_SAMPLES, pad=PAD,
                           chunk=CHUNK, white_bkgd=rec["white"], device=dev,
                           costreg_impl=impl)
            call_profile(f"13 {name}", f"build_volume, U-Net on "
                         f"{'cuDNN' if impl == 'plain' else impl}",
                         lambda: ev.build_volume(*rec["src"]))
        for mode in ("chunked", "tiled"):
            call_profile(f"13 {name}", f"one {mode} request",
                         lambda: ev.render(rays, h, w, mode=mode), top=4)
        del ev, rays
        torch.cuda.empty_cache()
    print(f"[13 time] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return kernels

def grads_by_part(system):
    """The MLP's, CostRegNet's and FeatureNet's gradients, each one flat
    float64 vector."""
    import torch
    mv = system.mvsnet
    return {n: torch.cat([q.grad.reshape(-1).double() for q in m.parameters()])
            for n, m in (("MLP", system.mlp), ("CostRegNet", mv.cost_reg_2),
                         ("FeatureNet", mv.feature))}


def flat_params(system, grads=False):
    """Every parameter of the MLP and the MVSNet (or its gradient), one
    flat vector."""
    import torch
    return torch.cat([(p.grad if grads else p.detach()).reshape(-1)
                      for m in (system.mlp, system.mvsnet)
                      for p in m.parameters()])


def hold_grads(phase, what, ours, ref, failures):
    """Per part: max |ours - ref| <= TOL_STEP_GRAD x max|ref|."""
    errs = {n: (max_err(ours[n], ref[n]), float(ref[n].abs().max()))
            for n in ref}
    print(f"[{phase}] {what}: " + ", ".join(
        f"{n} {e:.2e} of max|g| {g:.3e}" for n, (e, g) in errs.items()) +
        f" (tol {TOL_STEP_GRAD:.0e} x max|g|)")
    check(all(e <= TOL_STEP_GRAD * g and g > 0 for e, g in errs.values()),
          f"[{phase}] {what}: the gradients disagree", failures)


def dp_counters():
    """The generalizable step's launch counters."""
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    from mvsnerf_tpu_torch.ops.sweep import sweep_cost_volume
    return {"K1": (sweep_cost_volume, "launches"),
            "K2": (sweep_cost_volume, "bwd_launches"),
            "K4": (color_warp, "launches"),
            "K5 fwd": (k5.sample_volume, "launches"),
            "K5 bwd": (k5.sample_volume, "bwd_launches"),
            "K6": (rf.render_v0, "launches"),
            "K6b": (rf.render_v0, "baked_launches"),
            "K7 fwd": (k7.mlp_v0_train, "launches"),
            "K7 bwd": (k7.mlp_v0_train, "bwd_launches"),
            "K8": (rf.render_v0_feats, "launches")}


def dp_single_rank(dev, mlp, mvsnet, sample, failures, gen_step_ms):
    """Phase 14 (a): NCCL at world size 1 (a `file://` store): the step
    through the data-parallel path against today's step, 10 steps of each
    in turns, the all-reduce's device time, and `fit` on the path."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from mvsnerf_tpu_torch.parallel import init_distributed, make_mesh
    from mvsnerf_tpu_torch.train import generalizable as gmod

    with tempfile.TemporaryDirectory() as tmp:
        require(init_distributed(f"file://{tmp}/store", 0, 1,
                                 local_rank=dev.index or 0, device=dev),
                "init_distributed at world size 1 did not start a group")
        try:
            require(dist.get_backend() == "nccl",
                    f"backend {dist.get_backend()}, not nccl")
            mesh = make_mesh()
            dp = generalizable_system(dev, mlp, mvsnet, mesh=mesh)
            plain = generalizable_system(dev, mlp, mvsnet)
            batch = plain.batch(sample)
            gen = torch.Generator(device=dev).manual_seed(SEED + 14)
            draws = plain.draw(batch, gen)
            reduced = {}
            allreduce = gmod.allreduce_mean

            def noting(params, *a, **kw):
                before = [p.grad.clone() for p in params
                          if p.grad is not None]
                out = allreduce(params, *a, **kw)
                after = [p.grad for p in params if p.grad is not None]
                reduced.update(bytes=out[1], exact=all(
                    torch.equal(x, y) for x, y in zip(before, after)))
                return out

            steps = {}
            with swapped(gmod, "allreduce_mean", noting):
                for name, system in (("data-parallel", dp),
                                     ("one process", plain)):
                    loss, _ = system._step(batch, *draws)
                    steps[name] = dict(loss=float(loss),
                                       grads=grads_by_part(system),
                                       g=flat_params(system, grads=True),
                                       params=flat_params(system))
            a, b = steps["data-parallel"], steps["one process"]
            bit = a["loss"] == b["loss"] and torch.equal(
                a["params"], b["params"]) and all(
                torch.equal(a["grads"][n], b["grads"][n]) for n in a["grads"])
            # Adam's first update is lr * g / (|g| + 1e-8): where |g| is
            # near 1e-8, run-to-run float32 differences of g (K2's and K5's
            # atomics, FeatureNet's cuDNN backward) move the update by up to
            # lr; the
            # rest agree to STEP_TOL x lr (phase 6's rule)
            lr = plain.args.lrate
            firm = b["g"].abs() > 1e-7
            p_err = max_err(a["params"][firm], b["params"][firm])
            p_all = max_err(a["params"], b["params"])
            print(f"[14 dp1] one step from one state and draws, NCCL at "
                  f"world size 1 against one process: loss {a['loss']:.7f} / "
                  f"{b['loss']:.7f}; bit-equal {bit}; the all-reduce of "
                  f"{reduced['bytes']} bytes (one flat float32 buffer) left "
                  f"every gradient bit-equal: {reduced['exact']}; params max "
                  f"diff where |g| > 1e-7 {p_err:.2e} (tol STEP_TOL x lr "
                  f"{STEP_TOL * lr:.1e}), elsewhere {p_all:.2e} (tol 2 lr)")
            check(reduced.get("exact") is True, "[14] the all-reduce at one "
                  "rank changed a gradient", failures)
            check(abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]) and
                  p_err <= STEP_TOL * lr and p_all <= 2 * lr,
                  "[14] the data-parallel step and today's disagree",
                  failures)
            if not bit:
                hold_grads("14 dp1", "data-parallel vs one process",
                           a["grads"], b["grads"], failures)

            def steps_ms(system):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DP_TIMED):
                    system._step(batch, *draws)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / DP_TIMED

            times = {"data-parallel": [], "one process": []}
            for name in ("data-parallel", "one process", "one process",
                         "data-parallel"):
                times[name].append(steps_ms(dp if name == "data-parallel"
                                            else plain))
            print(f"[14 dp1] ms/step over {DP_TIMED} steps in turns: " +
                  "; ".join(f"{n} {[round(t, 2) for t in ts]}"
                            for n, ts in times.items()) +
                  f" (phase 8's fit: {gen_step_ms:.2f})")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                dp._step(batch, *draws)
                torch.cuda.synchronize()
            dev_events = [e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
            nccl = [e for e in dev_events if "nccl" in e.name.lower() or
                    "allreduce" in e.name.lower()]
            total = sum(e.time_range.elapsed_us() for e in dev_events)
            print(f"[14 dp1] all-reduce on the device (torch.profiler, one "
                  f"step): {sum(e.time_range.elapsed_us() for e in nccl) / 1e3:.4f}"
                  f" ms in {len(nccl)} kernel(s) "
                  f"{sorted({e.name[:60] for e in nccl})} of "
                  f"{total / 1e3:.2f} ms of kernels; buffer "
                  f"{reduced['bytes']} bytes")
            # the main path: fit through the data-parallel step
            counters = dp_counters()
            zero_counts(counters)
            losses = dp.fit([sample], num_epochs=DP_STEPS, seed=SEED,
                            max_steps=DP_STEPS)
            counts = read_counts(counters)
            print(f"[14 dp1] fit: {len(losses)} steps, loss "
                  f"{losses[0]:.5f} -> {losses[-1]:.5f}; launches {counts}")
            check(len(losses) == DP_STEPS and
                  all(math.isfinite(v) for v in losses),
                  "[14] the data-parallel fit returned a non-finite loss",
                  failures)
            for k in ("K1", "K2", "K4", "K5 fwd", "K5 bwd", "K7 fwd",
                      "K7 bwd"):
                check(counts[k] > 0, f"[14] {k} never launched on the "
                      "data-parallel path", failures)
            del dp, plain, batch, steps, a, b
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()


def dp_rank(rank, tmp):
    """Phase 14 (b), one of DP_RANKS gloo ranks on the one card (a spawned
    process): 3 data-parallel steps, the first step's averaged gradients,
    on rank 0 every rank's gradients recomputed in one process from the
    same draws, and `shard_rays_render` of one 640x512 request against
    rank 0's one-process chunked render; results saved to tmp."""
    import torch
    import torch.distributed as dist
    from mvsnerf_tpu_torch import set_precision_policy
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from mvsnerf_tpu_torch.parallel import (init_distributed, make_mesh,
                                            rank_seed, shard_rays_render)
    from mvsnerf_tpu_torch.train import generalizable as gmod
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    set_precision_policy()
    dev = torch.device("cuda", 0)
    init_distributed(f"file://{tmp}/store", rank, DP_RANKS, local_rank=0,
                     device=dev, backend="gloo")
    out = {"backend": dist.get_backend()}
    try:
        mesh = make_mesh(device_type="cuda")
        sample = dict(np.load(os.path.join(tmp, "sample.npz")))

        def system(batch_size, mesh=None):
            args = config_parser(
                f"--dataset_name dtu --pad {PAD} --N_samples {N_SAMPLES} "
                f"--batch_size {batch_size} --with_depth_loss --with_depth "
                f"--ckpt {os.path.join(tmp, 'seeded.tar')}")
            return GeneralizableSystem(args, device=dev, mesh=mesh)

        dp = system(GEN_BATCH, mesh)
        first = {}
        allreduce = gmod.allreduce_mean

        def recording(*a, **kw):  # the first step's averaged gradients
            res = allreduce(*a, **kw)
            if not first:
                first.update(grads_by_part(dp))
            return res

        counters = dp_counters()
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with swapped(gmod, "allreduce_mean", recording):
            out["losses"] = dp.fit([sample], num_epochs=DP_STEPS, seed=SEED,
                                   max_steps=DP_STEPS)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["launches"] = read_counts(counters)
        out["params"] = flat_params(dp).cpu()
        out["grads"] = {k: v.cpu() for k, v in first.items()}

        imgs_norm, projs, pose_src = make_scene(np.random.default_rng(SEED))
        ev = Evaluator(dp.mvsnet, dp.mlp, n_samples=N_SAMPLES, pad=PAD,
                       n_planes=N_PLANES, chunk=CHUNK, device=dev)
        with torch.no_grad():
            ev.build_volume(imgs_norm, projs, NEAR_FAR, pose_src)
            rays = rays_for_pose(pose(0, 0.02, 0.1),
                                 pose_src["intrinsics"][0], H, W, dev)
            sharded = shard_rays_render(
                lambda r: ev.render(r, 1, r.shape[0], "chunked"), mesh)
            zero_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sharded(rays)
            torch.cuda.synchronize()
            out["sharded_ms"] = (time.perf_counter() - t0) * 1e3
            out["render_launches"] = read_counts(counters)
            out["sharded"] = {k: v.cpu() for k, v in res.items()}
            if rank == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                single = ev.render(rays, H, W, "chunked")
                torch.cuda.synchronize()
                out["single_ms"] = (time.perf_counter() - t0) * 1e3
                out["single"] = {k: v.cpu() for k, v in single.items()}
        del ev
        if rank == 0:  # each rank's first step recomputed in one process
            one = system(GEN_BATCH // DP_RANKS)
            batch = one.batch(sample)
            per_rank = []
            for r in range(DP_RANKS):
                gen = torch.Generator(device=dev).manual_seed(
                    rank_seed(SEED * 2 ** 32, r))
                loss, _ = one.loss(batch, *one.draw(batch, gen))
                one.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                per_rank.append(grads_by_part(one))
            out["recomputed"] = {n: (sum(g[n] for g in per_rank) /
                                     DP_RANKS).cpu() for n in per_rank[0]}
            out["rank_differs"] = max_err(per_rank[0]["MLP"],
                                          out["recomputed"]["MLP"].to(dev))
    finally:
        dist.destroy_process_group()
    import torch as _torch
    _torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def dp_two_ranks(mlp, mvsnet, sample, failures):
    """Phase 14 (b): DP_RANKS gloo ranks on the one card (NCCL cannot put
    two ranks on one card; gloo all-reduces the CUDA tensors through the
    host), spawned with torch.multiprocessing."""
    import tempfile

    import torch
    with tempfile.TemporaryDirectory() as tmp:
        save_seeded_checkpoint(os.path.join(tmp, "seeded.tar"), mlp, mvsnet)
        np.savez(os.path.join(tmp, "sample.npz"), **sample)
        t0 = time.perf_counter()
        try:
            torch.multiprocessing.spawn(dp_rank, args=(tmp,),
                                        nprocs=DP_RANKS, join=True)
        except Exception as e:  # a rank's failure fails the phase
            print(f"[14 dp2] a rank failed: {type(e).__name__}: "
                  f"{str(e)[-2000:]}")
            check(False, "[14] a gloo rank on the card failed", failures)
            return
        spawn_s = time.perf_counter() - t0
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(DP_RANKS)]
    r0 = res[0]
    print(f"[14 dp2] {DP_RANKS} ranks ({r0['backend']}) on the one card, "
          f"{GEN_BATCH // DP_RANKS} rays a rank: spawn to join "
          f"{spawn_s:.1f} s; fit of {DP_STEPS} steps "
          f"{[round(r['fit_s'], 2) for r in res]} s; losses "
          f"{[round(v, 5) for v in r0['losses']]}; launches rank 0: fit "
          f"{ {k: n for k, n in r0['launches'].items() if n} }, sharded "
          f"render { {k: n for k, n in r0['render_launches'].items() if n} }")
    hold_grads("14 dp2", "the all-reduced first-step gradients vs the mean "
               "of both ranks' recomputed in one process", r0["grads"],
               r0["recomputed"], failures)
    print(f"   rank 0's own MLP gradient is {r0['rank_differs']:.2e} from "
          "the mean (the ranks drew apart)")
    same = all(torch.equal(r["params"], r0["params"]) for r in res) and \
        all(r["losses"] == r0["losses"] for r in res)
    print(f"[14 dp2] parameters bit-equal on every rank after {DP_STEPS} "
          f"steps: {same}")
    check(same and r0["rank_differs"] > 0, "[14] the ranks' parameters "
          "differ, or the ranks drew the same rays", failures)
    err = max(max_err(r["sharded"][k], r0["single"][k]) for r in res
              for k in ("rgb", "depth", "acc"))
    print(f"[14 dp2] shard_rays_render of one {H}x{W} request: "
          f"{[round(r['sharded_ms'], 1) for r in res]} ms a rank against "
          f"{r0['single_ms']:.1f} ms in one process; max abs err against "
          f"rank 0's one-process chunked render {err:.3e} (tol "
          f"{TOL_K6:.0e})")
    check(err <= TOL_K6, "[14] the sharded render disagrees", failures)
    for k in ("K1", "K2", "K4", "K5 fwd", "K5 bwd", "K7 fwd", "K7 bwd"):
        check(all(r["launches"][k] > 0 for r in res),
              f"[14] {k} never launched in a gloo rank's fit", failures)
    for k in ("K4", "K8"):
        check(all(r["render_launches"][k] > 0 for r in res),
              f"[14] {k} never launched in a gloo rank's sharded render",
              failures)


def mlp_types_phase(dev, mvsnet, failures, ft_step_ms):
    """Phase 14 (c): v1, v2 and fusion at full width: a request per type
    on the chunked route held to the same request on the twins of K4 and
    K11, 10 v2 fine-tune steps, `evaluate --net_type v2` through the CLI;
    K7, K8, K6 and K6b never launch for these MLPs, K11 once a chunk for
    v1 and never for the others. Returns v1's K11 launches."""
    import tempfile

    import torch
    from mvsnerf_tpu_torch import evaluate as evaluate_cli
    from mvsnerf_tpu_torch.data import synthetic
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops.color_warp import color_warp_plain
    from mvsnerf_tpu_torch.render import renderer

    counters = {**dp_counters(), "K11": (rf.render_v1_feats, "launches")}
    never = ("K6", "K6b", "K7 fwd", "K7 bwd", "K8")
    n_chunks = -(-H * W // CHUNK)
    imgs_norm, projs, pose_src = make_scene(np.random.default_rng(SEED))
    rays = rays_for_pose(pose(0, 0.02, 0.1), pose_src["intrinsics"][0], H,
                         W, dev)
    mlps = {}
    for i, net_type in enumerate(MLP_TYPES):
        gen = torch.Generator().manual_seed(SEED + 20 + i)
        mlps[net_type] = m = seeded_init_(MVSNeRF(net_type, device=dev), gen)
        ev = Evaluator(mvsnet, m, n_samples=N_SAMPLES, pad=PAD,
                       n_planes=N_PLANES, chunk=CHUNK, device=dev)
        zero_counts(counters)
        with torch.no_grad():
            ev.build_volume(imgs_norm, projs, NEAR_FAR, pose_src)
            out, ms = synced_ms(lambda: ev.render(rays, H, W, "chunked"))
            counts = read_counts(counters)
            with swapped(renderer, "color_warp", color_warp_plain), \
                    swapped(renderer, "render_v1_feats",
                            rf.render_v1_feats_plain):
                twin, twin_ms = synced_ms(
                    lambda: ev.render(rays, H, W, "chunked"))
        err = max(max_err(out[k], twin[k]) for k in ("rgb", "depth", "acc"))
        finite = all(bool(torch.isfinite(out[k]).all()) for k in out)
        print(f"[14 {net_type}] one {H}x{W} chunked request: {ms:.1f} ms "
              f"(the twins of K4 and K11: {twin_ms:.1f} ms), max abs err "
              f"against the twins' {err:.3e} (tol {TOL_K6:.0e}); acc mean "
              f"{float(out['acc'].mean()):.4f}; launches "
              f"{ {k: n for k, n in counts.items() if n} }")
        check(finite and err <= TOL_K6, f"[14] the {net_type} request "
              "disagrees with the twins' or is not finite", failures)
        k11 = n_chunks if net_type == "v1" else 0
        check(counts["K1"] > 0 and counts["K4"] > 0 and
              counts["K11"] == k11 and not any(counts[k] for k in never),
              f"[14] the {net_type} request's launches {counts} (K11 "
              f"{k11} wanted)", failures)
        if net_type == "v1":
            k11_launches = counts["K11"]
        del ev, out, twin
        torch.cuda.empty_cache()

    # 10 fine-tune steps with --net_type v2 (K4, K5 gather and splat, the
    # module's MLP under autograd), beside phase 6's v0 step on K7
    scene = FinetuneScene(np.random.default_rng(SEED + 2))
    system = finetune_system(dev, mlps["v2"], mvsnet, scene,
                             "--net_type v2")
    require(system.mlp.net_type == "v2", "the v2 system's MLP is not v2")
    zero_counts(counters)
    clock = StepClock()
    losses = system.fit(num_steps=MLP_STEPS + 2, log_every=1, logger=clock,
                        seed=SEED, val_every=0)
    counts = read_counts(counters)
    step_ms = (clock.marks[MLP_STEPS + 1] - clock.marks[1]) * 1e3 / MLP_STEPS
    print(f"[14 v2 fine-tune] {len(losses)} steps, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; steps 3-{MLP_STEPS + 2}: {step_ms:.2f} ms/step "
          f"on the module's MLP (phase 6's v0 step on K7: "
          f"{ft_step_ms:.2f}); launches "
          f"{ {k: n for k, n in counts.items() if n} }")
    check(all(math.isfinite(v) for v in losses) and counts["K4"] > 0 and
          counts["K5 fwd"] > 0 and counts["K5 bwd"] > 0 and
          not any(counts[k] for k in never),
          f"[14] the v2 fine-tune's losses or launches {counts}", failures)
    del system, scene
    torch.cuda.empty_cache()

    # evaluate --net_type v2 through the CLI, on an LLFF scene at its
    # published 960x640 written by data/synthetic.py (the port has no DTU
    # scene writer; JAX's scripts/make_synthetic_scene.py imports JAX)
    with tempfile.TemporaryDirectory() as tmp:
        datadir = os.path.join(tmp, "fern")
        synthetic.write_llff_scene(datadir, wh=DATASET_WH["llff"],
                                   seed=SEED + 15)
        ckpt = save_seeded_checkpoint(os.path.join(tmp, "v2.tar"),
                                      mlps["v2"], mvsnet)
        base = ["--dataset_name", "llff", "--datadir", datadir, "--ckpt",
                ckpt, "--pad", str(PAD), "--net_type", "v2", "--expname",
                "smoke_v2"]
        with contextlib.chdir(tmp):
            zero_counts(counters)
            metrics, ms = synced_ms(lambda: evaluate_cli.main(
                base + ["--render_mode", "chunked"]))
            counts = read_counts(counters)
            try:
                evaluate_cli.main(base + ["--render_mode", "tiled"])
                refused = "rendered"
            except ValueError as e:
                refused = str(e)
    print(f"[14 evaluate --net_type v2] {len(metrics['per_image'])} LLFF "
          f"val views of {DATASET_WH['llff']} in {ms / 1e3:.1f} s, mean "
          f"{ {k: round(v, 4) for k, v in metrics['mean'].items()} }; "
          f"launches { {k: n for k, n in counts.items() if n} }; "
          f"--render_mode tiled: {refused[:80]}")
    check(all(math.isfinite(v) for v in metrics["mean"].values()) and
          counts["K1"] > 0 and counts["K4"] > 0 and
          not any(counts[k] for k in never) and "v0 MLP" in refused,
          f"[14] evaluate --net_type v2: launches {counts}, tiled "
          f"{refused[:80]}", failures)
    return k11_launches


def parallel_phase(dev, mlp, mvsnet, failures, gen_step_ms, ft_step_ms):
    """Phase 14: (a) NCCL at world size 1, (b) two gloo ranks on the one
    card, (c) the v1, v2 and fusion MLPs. Returns (c)'s K11 launches."""
    import torch
    t_phase = time.perf_counter()
    sample = generalizable_sample(np.random.default_rng(SEED + 3))
    dp_single_rank(dev, mlp, mvsnet, sample, failures, gen_step_ms)
    t_a = time.perf_counter()
    dp_two_ranks(mlp, mvsnet, sample, failures)
    t_b = time.perf_counter()
    torch.cuda.empty_cache()
    k11_launches = mlp_types_phase(dev, mvsnet, failures, ft_step_ms)
    print(f"[14 time] phase 14 took {time.perf_counter() - t_phase:.1f} s "
          f"((a) {t_a - t_phase:.1f}, (b) {t_b - t_a:.1f}, (c) "
          f"{time.perf_counter() - t_b:.1f})")
    return k11_launches



def same_state(a, b, path="state"):
    """The places two `state()` dicts differ, bit for bit: tensors by
    `torch.equal` (dtype and device too), everything else by ==."""
    import torch
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys {sorted(map(str, a))} / "
                    f"{sorted(map(str, b))}"]
        return [d for k in a for d in same_state(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: lengths {len(a)} / {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in same_state(x, y, f"{path}/{i}")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        ok = a.dtype == b.dtype and a.device == b.device and \
            a.shape == b.shape and bool(torch.equal(a, b))
        return [] if ok else [f"{path}: tensors differ"]
    return [] if a == b else [f"{path}: {a!r} / {b!r}"]


def trained(system):
    """(the part of each trained tensor, the tensors, their gradients), in
    Adam's order, detached copies. Parts: the volume, the MLP, CostRegNet,
    FeatureNet."""
    part = {id(system.volume): "volume"} \
        if getattr(system, "volume", None) is not None else {}
    for name, m in (("MLP", system.mlp),
                    ("CostRegNet", system.mvsnet.cost_reg_2),
                    ("FeatureNet", system.mvsnet.feature)):
        part.update({id(p): name for p in m.parameters()})
    params = [p for g in system.optimizer.param_groups for p in g["params"]]
    return ([part[id(p)] for p in params],
            [p.detach().clone() for p in params],
            [None if p.grad is None else p.grad.detach().clone()
             for p in params])


def step_distance(a, b, lrate):
    """How far one step of system a lies from one of b: (loss rel, the
    gradients' max difference over each part's max|g|, the updates' where
    |g| > 1e-7 over lr, whether every update lies within 2 lr of b's and
    tensors with no gradient match). `a` and `b` are (loss, parts, before,
    after, grads)."""
    import torch
    (la, parts, ba, aa, ga), (lb, _, bb, ab, gb) = a, b
    gmax, gerr, upd, ok = {}, {}, 0.0, True
    for part, p0a, p1a, g_a, p0b, p1b, g_b in zip(parts, ba, aa, ga, bb, ab,
                                                   gb):
        if g_b is None:
            ok &= g_a is None and bool(torch.equal(p1a, p1b))
            continue
        gmax[part] = max(gmax.get(part, 0.0), float(g_b.abs().max()))
        gerr[part] = max(gerr.get(part, 0.0), max_err(g_a, g_b))
        du = (p1a - p0a) - (p1b - p0b)
        firm = g_b.abs() > 1e-7
        if bool(firm.any()):
            upd = max(upd, float(du[firm].abs().max()) / lrate)
        ok &= float(du.abs().max()) <= 2 * lrate
    rel = {k: gerr[k] / g if g > 0 else
           (0.0 if gerr[k] == 0 else float("inf")) for k, g in gmax.items()}
    return abs(la - lb) / abs(lb), rel, upd, ok


def hold_steps(phase, what, steps, lrate, failures, control=None):
    """Two resumed systems' steps held to each other. `steps` holds per
    step the (loss, parts, before, after, grads) of each. Every step from
    states that are bit-equal (all of them without `control`) by
    step_parity's and phase 14's rules: the losses rel 1e-5, each part's
    gradients TOL_STEP_GRAD x its max|g|, the updates STEP_TOL x lr where
    |g| > 1e-7 (Adam turns float32 differences of an eps-sized gradient
    into update differences of up to lr) and 2 lr everywhere. With
    `control` (a third system restored from the same `.pt`, stepped
    beside them) the steps after the first start from states that parted
    already: they are held to the losses' rule, TOL_RESUMED_GRAD and 2 lr,
    and the control's own distance from the second system, under the
    same rules, is printed beside them."""
    ok, rows = True, []
    for k, pair in enumerate(steps):
        loss, rel, upd, bounded = step_distance(*pair, lrate)
        parted = control is not None and k > 0
        ok &= bounded and loss <= 1e-5 and all(
            v <= (TOL_RESUMED_GRAD if parted else TOL_STEP_GRAD)
            for v in rel.values()) and (parted or upd <= STEP_TOL)
        row = (f"loss rel {loss:.2e}, gradients of max|g| "
               f"{ {n: f'{v:.2e}' for n, v in rel.items()} }, updates "
               f"where |g| > 1e-7 {upd:.2e} x lr")
        if parted:
            c_loss, c_rel, c_upd, c_ok = step_distance(control[k], pair[1],
                                                       lrate)
            ok &= c_ok and c_loss <= 1e-5 and all(
                v <= TOL_RESUMED_GRAD for v in c_rel.values())
            row += (f" (tol {TOL_RESUMED_GRAD:.0e} x max|g|, 2 lr; the "
                    f"control .pt run: loss {c_loss:.2e}, gradients "
                    f"{ {n: f'{v:.2e}' for n, v in c_rel.items()} }, "
                    f"updates {c_upd:.2e})")
        rows.append(row)
    print(f"[{phase} steps] {what}, step by step: " +
          "; ".join(f"{k + 1}: {r}" for k, r in enumerate(rows)))
    check(ok, f"[{phase}] {what}: the resumed steps disagree", failures)


def snapshot_pair(phase, kind, system, step, tmp, make_fresh, failures):
    """Write `system`'s state as a `.pt` (`save`) and as the JAX package's
    `.msgpack` (`write_jax_snapshot`), restore each into a fresh system of
    `make_fresh()` and hold all three states bit-equal. Returns (the .pt
    system, the .msgpack system)."""
    import torch
    from mvsnerf_tpu_torch.io.jax_snapshot import write_jax_snapshot
    state = system.state() if kind == "generalizable" else system.state(step)
    d = os.path.join(tmp, f"{phase}_{kind}")
    ms = {}
    _, ms["pt save"] = synced_ms(lambda: system.save(d) if kind ==
                                 "generalizable" else system.save(d, step))
    pt = os.path.join(d, f"ckpt_{step:09d}.pt")
    msgpack = os.path.join(d, "jax", f"ckpt_{step:09d}.msgpack")
    _, ms["msgpack encode"] = synced_ms(
        lambda: write_jax_snapshot(msgpack, state, kind, system))
    out = []
    for name, path in ((".pt", pt), (".msgpack", msgpack)):
        fresh = make_fresh()
        got, ms[f"{name} restore"] = synced_ms(
            lambda: fresh.restore(path, strict=True))
        check(got == step, f"[{phase}] {path} restored step {got}, not "
              f"{step}", failures)
        out.append(fresh)
    diffs = {name: same_state(state, s.state() if kind == "generalizable"
                              else s.state(step))
             for name, s in ((".pt", out[0]), (".msgpack", out[1]))}
    sizes = {k: os.path.getsize(p) / 2 ** 20 for k, p in
             ((".pt", pt), (".msgpack", msgpack))}
    opt = out[1].optimizer
    print(f"[{phase} snapshot] {kind}: .msgpack {sizes['.msgpack']:.1f} MiB "
          f"(.pt {sizes['.pt']:.1f}); ms: " +
          ", ".join(f"{k} {v:.1f}" for k, v in ms.items()) +
          f"; Adam states {len(opt.state)} at step "
          f"{sorted({float(s['step']) for s in opt.state.values()})}, lr "
          f"{opt.param_groups[0]['lr']:.6g}; state differences from the "
          f"writer's: .pt {diffs['.pt'][:3]}, .msgpack "
          f"{diffs['.msgpack'][:3]}")
    check(not diffs[".pt"] and not diffs[".msgpack"],
          f"[{phase}] a restored {kind} state is not the writer's", failures)
    torch.cuda.empty_cache()
    return out


def finetune_resume(dev, mlp, mvsnet, tmp, extra, failures):
    """15a: phase 6's fine-tune at full width (and with `extra`): 5 steps,
    the state through both snapshot formats into fresh systems, then 3
    steps from each held to each other."""
    import torch
    from mvsnerf_tpu_torch.train.common import RayBatchIterator
    scene = FinetuneScene(np.random.default_rng(SEED + 2))
    system = finetune_system(dev, mlp, mvsnet, scene, extra)
    losses = system.fit(num_steps=5, seed=SEED, val_every=0)
    check(all(math.isfinite(v) for v in losses),
          "[15a] non-finite fine-tune loss", failures)
    pt_sys, mp_sys = snapshot_pair(
        "15a", "finetune", system, 5, tmp,
        lambda: finetune_system(dev, mlp, mvsnet, scene, extra), failures)
    in_adam = {id(p) for g in mp_sys.optimizer.param_groups
               for p in g["params"]}
    check((id(next(mp_sys.mvsnet.parameters())) in in_adam) ==
          (not extra), "[15a] Adam holds the MVSNet with the colour volume "
          "or misses it without", failures)
    del system
    torch.cuda.empty_cache()
    it = RayBatchIterator({"rays": scene.all_rays, "rgbs": scene.all_rgbs},
                          FT_BATCH, seed=SEED + 15)
    gen = torch.Generator(device=dev)
    pairs = []
    for k in range(3):
        batch = next(it)
        rays, rgbs = (torch.from_numpy(batch[n]).to(dev)
                      for n in ("rays", "rgbs"))
        rec = []
        for s in (mp_sys, pt_sys):
            _, before, _ = trained(s)
            gen.manual_seed(SEED * 2 ** 32 + 5 + k)
            loss = float(s._step(rays, rgbs, gen))
            parts, after, grads = trained(s)
            rec.append((loss, parts, before, after, grads))
        pairs.append(rec)
    hold_steps("15a", f"volume {tuple(pt_sys.volume.shape)}, .msgpack "
               "against .pt", pairs, pt_sys.args.lrate, failures)
    del pt_sys, mp_sys, pairs
    torch.cuda.empty_cache()


def generalizable_resume(dev, mlp, mvsnet, tmp, failures):
    """15b: phase 7's generalizable step: 2 steps of `fit` over a 10-step
    schedule, both snapshot formats, then 2 steps from each on the same
    draws, beside a control restored from the same `.pt` (hold_steps).
    Returns the writer system (phase 15d validates with it)."""
    import torch
    sample = generalizable_sample(np.random.default_rng(SEED + 3))
    system = generalizable_system(dev, mlp, mvsnet)
    losses = system.fit([sample], num_epochs=2, max_steps=10, seed=SEED)
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses),
          "[15b] the generalizable fit is wrong", failures)

    def fresh():
        s = generalizable_system(dev, mlp, mvsnet)
        s.schedule_steps = system.schedule_steps
        return s

    pt_sys, mp_sys = snapshot_pair("15b", "generalizable", system, 2, tmp,
                                   fresh, failures)
    # the control: the same .pt restored again
    control = fresh()
    control.restore(os.path.join(tmp, "15b_generalizable",
                                 "ckpt_000000002.pt"), strict=True)
    batch = system.batch(sample)
    gen = torch.Generator(device=dev)
    pairs, ctl = [], []
    for k in range(2):
        gen.manual_seed(SEED + 150 + k)
        draws = system.draw(batch, gen)
        rec = []
        for s in (mp_sys, pt_sys, control):
            _, before, _ = trained(s)
            loss, _ = s._step(batch, *draws)
            parts, after, grads = trained(s)
            rec.append((float(loss), parts, before, after, grads))
        pairs.append(rec[:2])
        ctl.append(rec[2])
    hold_steps("15b", "generalizable, .msgpack against .pt", pairs,
               system.args.lrate, failures, control=ctl)
    del pt_sys, mp_sys, control, pairs, ctl
    torch.cuda.empty_cache()
    return system, sample


def fusion_resume(dev, mlp, mvsnet, tmp, failures):
    """15b: phase 12's fused (128, 128, 128, 20) volume: one step, both
    snapshot formats into copies of the unstepped system, one step each."""
    import torch
    mlp = copy.deepcopy(mlp)
    with torch.no_grad():
        mlp.nerf.alpha_linear.bias.fill_(FUSE_SIGMA_BIAS)
    scene = FusionScene(np.random.default_rng(SEED + 12))
    system = fusion_system(dev, mlp, mvsnet, scene)
    unstepped = []

    def fresh():
        s = copy.deepcopy(unstepped[0])
        s._build_optimizer()  # a copied scheduler would not see Adam's step
        return s

    unstepped.append(copy.deepcopy(system))
    system.fit(num_steps=1, seed=SEED, val_every=0)
    pt_sys, mp_sys = snapshot_pair("15b", "fusion", system, 1, tmp, fresh,
                                   failures)
    del system, unstepped[:]
    rays, rgbs = first_batch(scene, dev)
    gen = torch.Generator(device=dev)
    rec = []
    for s in (mp_sys, pt_sys):
        _, before, _ = trained(s)
        gen.manual_seed(SEED * 2 ** 32 + 1)
        loss = float(s._step(rays, rgbs, gen))
        parts, after, grads = trained(s)
        rec.append((loss, parts, before, after, grads))
    hold_steps("15b", f"fusion {tuple(pt_sys.volume.shape)}, .msgpack "
               "against .pt", [rec], pt_sys.args.lrate, failures)
    del pt_sys, mp_sys, rec
    torch.cuda.empty_cache()


def run_batch_scene(dev, mlp, mvsnet, tmp, failures):
    """15c: `run_batch`'s two commands for Blender `lego` at 800x800, run
    as processes on the card, side by side, from a directory of their own,
    the fine-tune cut to RUN_BATCH_STEPS steps; then `render_video --ckpt *.msgpack
    --render_mode tiled` from that run's snapshot in JAX's format."""
    import subprocess as sp

    import torch
    from mvsnerf_tpu_torch import render_video, run_batch
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.data import synthetic
    from mvsnerf_tpu_torch.data.blender import BlenderDataset
    from mvsnerf_tpu_torch.data.pairs import get_split
    from mvsnerf_tpu_torch.io.jax_snapshot import write_jax_snapshot
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    root = os.path.join(tmp, "nerf_synthetic")
    t0 = time.perf_counter()
    synthetic.write_blender_scene(
        os.path.join(root, "lego"), res=800, seed=SEED + 13,
        frames=np.concatenate([get_split("lego", "train"),
                               get_split("lego", "val")]))
    ckpt = save_seeded_checkpoint(os.path.join(tmp, "seeded.tar"), mlp,
                                  mvsnet)
    print(f"[15c scene] lego at 800x800 and a seeded checkpoint written in "
          f"{time.perf_counter() - t0:.1f} s")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    ft_cmd, ev_cmd = run_batch.scene_commands("blender", root, ckpt, "lego")
    cmds = {"train_finetune": ft_cmd + ["--max_steps", str(RUN_BATCH_STEPS)],
            "evaluate": ev_cmd}
    # both at once: the evaluation reads the reference checkpoint, not the
    # fine-tune's output, and the whole script has 6 minutes
    logs = {k: os.path.join(tmp, f"{k}.log") for k in cmds}
    walls, procs = {}, {}
    t0 = time.perf_counter()
    try:
        for k, cmd in cmds.items():
            with open(logs[k], "w") as f:
                procs[k] = sp.Popen(cmd, cwd=tmp, env=env, stdout=f,
                                    stderr=sp.STDOUT)
        while len(walls) < len(procs):
            for k, proc in procs.items():
                if k not in walls and proc.poll() is not None:
                    walls[k] = time.perf_counter() - t0
            require(time.perf_counter() - t0 < 600,
                    "[15c] run_batch's processes took over 600 s")
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, proc in procs.items():
        with open(logs[k]) as f:
            text = f.read()
        print(f"[15c run_batch] {k}: exit {proc.returncode}, {walls[k]:.1f} s "
              f"from the common start; last lines "
              f"{text.strip().splitlines()[-3:]}")
        check(proc.returncode == 0, f"[15c] {k} failed: {text[-2000:]}",
              failures)
    run = os.path.join(tmp, "runs_fine_tuning", "lego-ft")
    pt = os.path.join(run, "ckpts", f"ckpt_{RUN_BATCH_STEPS:09d}.pt")
    metrics = os.path.join(tmp, "results", "lego-eval", "metrics.json")
    csv_head = ""
    if os.path.exists(os.path.join(run, "metrics.csv")):
        with open(os.path.join(run, "metrics.csv")) as f:
            csv_head = f.readline().strip()
    events = [n for n in (os.listdir(run) if os.path.isdir(run) else [])
              if n.startswith("events.out.tfevents")]
    print(f"[15c run_batch] {pt} {'exists' if os.path.exists(pt) else 'MISSING'}"
          f"; {metrics} {'exists' if os.path.exists(metrics) else 'MISSING'}"
          f"; metrics.csv columns {csv_head}; TensorBoard events written: "
          f"{bool(events)} (tensorboardX on this machine: "
          f"{importlib.util.find_spec('tensorboardX') is not None})")
    check(os.path.exists(pt) and os.path.exists(metrics) and
          "val/PSNR" in csv_head.split(","), "[15c] run_batch's outputs "
          "are missing", failures)
    if not os.path.exists(pt):
        return

    # the run's snapshot in JAX's format, then render_video on each
    flags = ["--dataset_name", "blender", "--datadir",
             os.path.join(root, "lego"), "--white_bkgd", "--pad", str(PAD),
             "--expname", "lego-video", "--render_mode", "tiled"]
    args = config_parser(flags + ["--ckpt", pt])
    train = BlenderDataset(args, "train")
    w, h = train.img_wh
    system = FinetuneSystem(args, train, device=dev)
    system.restore(pt, strict=True)
    msgpack = os.path.join(tmp, "jax_ckpts", f"ckpt_{RUN_BATCH_STEPS:09d}"
                           ".msgpack")
    write_jax_snapshot(msgpack, system.state(RUN_BATCH_STEPS), "finetune",
                       system)
    del system, train
    with contextlib.chdir(tmp), contextlib.redirect_stdout(io.StringIO()) \
            as out:
        frames, ms = synced_ms(lambda: render_video.main(
            flags + ["--ckpt", msgpack], n_frames=CLI_FRAMES))
    restored = f"restored {msgpack} (step {RUN_BATCH_STEPS})" in \
        out.getvalue()
    ok = restored and len(frames) == CLI_FRAMES and all(
        f.shape == (h, 2 * w, 3) and np.isfinite(f).all() for f in frames)
    print(f"[15c render_video] --ckpt {os.path.basename(msgpack)} "
          f"--render_mode tiled: restored step {RUN_BATCH_STEPS}: "
          f"{restored}; {len(frames)} frames of "
          f"{frames[0].shape if frames else None} in {ms / 1e3:.1f} s")
    check(ok, "[15c] render_video from the .msgpack snapshot is wrong",
          failures)
    torch.cuda.empty_cache()


def validation_panels(system, sample, tmp, failures):
    """15d: the generalizable CLI's `validate` on phase 7's system and one
    of its 640x512 samples: the [target | rgb | depth] panel and val/PSNR."""
    from PIL import Image
    from mvsnerf_tpu_torch.train_mvs_nerf import validate
    from mvsnerf_tpu_torch.utils.logging import MetricLogger
    log_dir = os.path.join(tmp, "val")
    logger = MetricLogger(log_dir)
    (val_psnr, ms) = synced_ms(lambda: validate(
        system, logger, [sample], system.global_step, 1,
        system.args.chunk * 8))
    panel = os.path.join(log_dir, f"val_00_{system.global_step:08d}.png")
    shape = np.asarray(Image.open(panel)).shape \
        if os.path.exists(panel) else None
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        head = f.readline().strip()
    print(f"[15d validate] {os.path.basename(panel)} {shape}, val/PSNR "
          f"{val_psnr:.3f}, {ms:.0f} ms; metrics.csv columns {head}")
    check(shape == (H, 3 * W, 3) and "val/PSNR" in head.split(",") and
          math.isfinite(val_psnr), "[15d] the validation panel or its PSNR "
          "is wrong", failures)


def card_vs_cpu(card, cpu, skip=None):
    """max |card - CPU| over max |CPU|, where `skip` is False."""
    card = card.cpu()
    if skip is not None:
        card, cpu = card[~skip], cpu[~skip]
    return max_err(card, cpu) / max(float(cpu.abs().max()), 1e-30)


def reference_helpers(dev, failures):
    """15e: the reference helpers on the card against the CPU: the ray
    builders at 640x512, the sweep's side outputs and the feature-only
    variance volume at DTU width, gen_angle_feature."""
    import torch
    from mvsnerf_tpu_torch.ops.geometry import build_rays_test, \
        build_rays_train
    from mvsnerf_tpu_torch.ops.homography import build_cost_volume_feat, \
        plane_sweep_grid, sweep_side_outputs
    from mvsnerf_tpu_torch.render.renderer import gen_angle_feature
    rng = np.random.default_rng(SEED + 15)
    imgs_norm, projs, pose_src = make_scene(rng)
    imgs = torch.from_numpy(np.ascontiguousarray(
        imgs_norm * np.float32([0.229, 0.224, 0.225]) +
        np.float32([0.485, 0.456, 0.406])))
    h, w = imgs.shape[1:3]
    intr = torch.from_numpy(pose_src["intrinsics"])
    w2cs = torch.from_numpy(pose_src["w2cs"])
    c2w_t = torch.linalg.inv(torch.from_numpy(pose(0, 0.02, 0.1)))
    nf = torch.tensor(NEAR_FAR)
    errs, flips = {}, {}

    def on(x, d):
        return x.to(d) if isinstance(x, torch.Tensor) else x

    def both(fn, *a, **k):
        return fn(*(on(x, dev) for x in a), **k), fn(*a, **k)

    card, cpu = both(build_rays_test, h, w, c2w_t, w2cs[0], intr[0], nf, nf,
                     N_SAMPLES, pad=PAD)
    errs["build_rays_test"] = max(card_vs_cpu(a, b)
                                  for a, b in zip(card, cpu) if b is not None)
    depth = torch.from_numpy(rng.uniform(2, 5, (h, w)).astype(np.float32))
    out = []
    for d in (dev, torch.device("cpu")):
        gen = torch.Generator().manual_seed(SEED)
        out.append(build_rays_train(
            gen, imgs[1].to(d), depth.to(d), intr[1].to(d), c2w_t.to(d),
            w2cs[0].to(d), intr[0].to(d), nf.to(d), nf.to(d), FT_BATCH,
            N_SAMPLES, pad=PAD))
    errs["build_rays_train"] = max(card_vs_cpu(a, b) for a, b in zip(*out)
                                   if b is not None)
    depths = torch.linspace(NEAR_FAR[0], NEAR_FAR[1], N_PLANES)
    projs_t = torch.from_numpy(projs)
    feats = torch.from_numpy(rng.standard_normal(
        (3, h // 4, w // 4, 32)).astype(np.float32))
    # a mask flips where a sample lies within float32 rounding of the
    # source view's border (the two devices' grids differ in the last
    # bits): counted, and each must sit at |grid| = 1 +- 1e-5. The sampled
    # values move by their image's slope times those bits (random images
    # have slopes up to 1 a pixel): each device is held to a float64 run
    # (on the card), the card within TOL_K7_BWD x the CPU's float32
    # distance from it
    sampled = {}
    grids = torch.stack([plane_sweep_grid(projs_t[i].double(),
                                          depths.double(), h // 4, w // 4,
                                          PAD) for i in (1, 2)])
    edge = ((grids.abs() - 1).abs() <= 1e-5).any(-1)
    for name, fn, args in (("sweep_side_outputs", sweep_side_outputs,
                            (imgs, projs_t)),
                           ("build_cost_volume_feat", build_cost_volume_feat,
                            (feats, projs_t))):
        # (values, masks) of each run: the sweep's side outputs come as
        # (masks, colours)
        (v_card, m_card), (v_cpu, m_cpu), (v64, m64) = (
            o[::-1] if name == "sweep_side_outputs" else o
            for o in (*both(fn, *args, depths, PAD),
                      [t.cpu() for t in fn(*(a.to(dev, torch.float64)
                                              for a in args),
                                            depths.to(dev, torch.float64),
                                            PAD)]))
        flip = m_card.cpu() != m_cpu
        near = edge.any(0) if name == "build_cost_volume_feat" else \
            torch.cat([torch.ones_like(edge[:1]), edge])
        flips[name] = (int(flip.sum()), bool((~flip | near).all()))
        # the variance of a voxel whose mask count differs between two runs
        # is another quantity: those voxels are left out
        flip |= m_cpu.double() != m64
        keep = flip[..., None].expand_as(v_cpu) if \
            name == "build_cost_volume_feat" else None
        if name == "sweep_side_outputs":  # the mask channel is in colours
            v_card, v_cpu, v64 = v_card[..., :3], v_cpu[..., :3], \
                v64[..., :3]
        d_card = card_vs_cpu(v_card.double(), v64, skip=keep)
        d_cpu = card_vs_cpu(v_cpu.double(), v64, skip=keep)
        errs[name] = card_vs_cpu(v_card, v_cpu, skip=keep)
        sampled[name] = (d_card, d_cpu)
        del v_card, m_card, v_cpu, m_cpu, v64, m64
    ray = out[1]
    errs["gen_angle_feature"] = card_vs_cpu(*both(
        gen_angle_feature, torch.linalg.inv(w2cs), ray.pts_world,
        ray.dirs_world))
    print(f"[15e helpers] card vs CPU, max |diff| / max |CPU|: "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol 1e-5 for the "
          f"rays and angles); sampled values' distance from float64 / its "
          f"max, card and CPU: "
          f"{ {k: f'{a:.2e} / {b:.2e}' for k, (a, b) in sampled.items()} } "
          f"(tol {TOL_K7_BWD} x the CPU's, floor 1e-6); mask flips (count, "
          f"all at the border): {flips}")
    check(all(errs[k] <= 1e-5 for k in errs if k not in sampled) and
          all(a <= TOL_K7_BWD * max(b, 1e-6) for a, b in sampled.values())
          and all(ok and n <= 64 for n, ok in flips.values()),
          "[15e] a reference helper differs on the card", failures)


def resume_phase(dev, mlp, mvsnet, failures):
    """Phase 15: resuming from the JAX package's `.msgpack` snapshots, the
    batch driver, the generalizable validation panels and the reference
    helpers; the launches of the phase's own process."""
    import tempfile

    import torch
    t_phase = time.perf_counter()
    counters = dp_counters()
    zero_counts(counters)
    took = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        took[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        for extra in ("", "--use_color_volume"):
            timed(f"15a{extra and ' C=20'}", finetune_resume, dev, mlp,
                  mvsnet, tmp, extra, failures)
        system, sample = timed("15b generalizable", generalizable_resume,
                               dev, mlp, mvsnet, tmp, failures)
        timed("15b fusion", fusion_resume, dev, mlp, mvsnet, tmp, failures)
        timed("15d", validation_panels, system, sample, tmp, failures)
        del system
        torch.cuda.empty_cache()
        timed("15c", run_batch_scene, dev, mlp, mvsnet, tmp, failures)
    launches = read_counts(counters)
    timed("15e", reference_helpers, dev, failures)
    print(f"[15 launches] in this process over 15a-15d: "
          f"{ {k: n for k, n in launches.items() if n} }")
    check(all(launches[k] > 0 for k in ("K1", "K2", "K4", "K5 fwd",
                                        "K5 bwd", "K7 fwd", "K7 bwd", "K8",
                                        "K6b")),
          "[15] a kernel of the phase's paths never launched", failures)
    print(f"[15 time] phase 15 took {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in took.items()) + ")")


def stamped(fn, marks, at):
    """Method `fn` noting in `at[n]` the host clock, after a synchronise,
    when its n-th call returns, for each n in `marks` (a trainer's `_step`:
    the steps between two marks are timed as `StepClock` times them)."""
    import torch
    calls = [0]

    def wrapper(self, *args, **kw):
        out = fn(self, *args, **kw)
        calls[0] += 1
        if calls[0] in marks:
            torch.cuda.synchronize()
            at[calls[0]] = time.perf_counter()
        return out
    return wrapper


def timed_calls(fn, spans):
    """`fn` (a function or a method) appending (host clock at entry,
    seconds) of each call to `spans`."""
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        spans.append((t0, time.perf_counter() - t0))
        return out
    return wrapper


def lpips_weights(tmp):
    """16f: seeded torchvision-format VGG16 (He-initialised convolutions)
    and lpips-head state dicts written with torch.save, then converted by
    the port's `convert_lpips_weights` CLI; the .npz's path."""
    import torch
    from mvsnerf_tpu_torch import convert_lpips_weights
    from mvsnerf_tpu_torch.eval.metrics import VGG16_CFG
    gen = torch.Generator().manual_seed(SEED + 16)
    vgg, cin = {}, 3
    for idx, cout in zip(convert_lpips_weights.VGG16_CONV_IDX,
                         [v for v in VGG16_CFG if v != "M"]):
        vgg[f"features.{idx}.weight"] = torch.randn(
            cout, cin, 3, 3, generator=gen) * (2.0 / (9 * cin)) ** 0.5
        vgg[f"features.{idx}.bias"] = torch.randn(cout, generator=gen) * 0.01
        cin = cout
    lin = {f"lin{j}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen)
           for j, c in enumerate([64, 128, 256, 512, 512])}
    paths = [os.path.join(tmp, f) for f in ("vgg16.pth", "vgg_lin.pth",
                                            "lpips_vgg.npz")]
    torch.save(vgg, paths[0])
    torch.save(lin, paths[1])
    return convert_lpips_weights.main(["--vgg_pth", paths[0], "--lin_pth",
                                       paths[1], "--out", paths[2]])


def tree_size(root):
    """(files, bytes) under `root`."""
    sizes = [os.path.getsize(os.path.join(base, f))
             for base, _, files in os.walk(root) for f in files]
    return len(sizes), sum(sizes)


def dtu_phase(dev, mlp, mvsnet, failures, kernels, ft_step_ms, gen_step_ms):
    """Phase 16: the DTU path from files at 640x512 through every DTU CLI,
    LPIPS on the card and the post-hoc metric tool; adds its launches to
    the kernels line's entries (DTU_ENTRIES)."""
    import tempfile

    import torch
    from PIL import Image
    from mvsnerf_tpu_torch import evaluate, metrics_from_panels, native, \
        render_video, train_finetune, train_mvs_nerf
    from mvsnerf_tpu_torch.data import dtu
    from mvsnerf_tpu_torch.data.dtu import MVSDatasetDTU, load_scan_list
    from mvsnerf_tpu_torch.data.dtu_ft import DTUFTDataset
    from mvsnerf_tpu_torch.data.synthetic import write_dtu_multiscan
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from mvsnerf_tpu_torch.eval.metrics import LPIPS
    from mvsnerf_tpu_torch.ops.sweep import sweep_cost_volume
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    t_phase = time.perf_counter()
    counters = dict(dataset_counters(), K2=(sweep_cost_volume,
                                            "bwd_launches"))
    total = dict.fromkeys(counters, 0)
    h, w = DTU_HW
    scan = load_scan_list("train")[0]
    n_gen, n_ft = GEN_WARM + GEN_TIMED, FT_WARM + FT_TIMED

    def cli(tag, label, needed, run):
        zero_counts(counters)
        out, ms = synced_ms(run)
        counts = read_counts(counters)
        for k, n in counts.items():
            total[k] += n
        print(f"[16{tag} cli] {label}: {ms / 1e3:.1f} s, launches "
              f"{ {k: n for k, n in counts.items() if n} }")
        check(all(counts[k] > 0 for k in needed),
              f"[16{tag}] {label} never launched one of {needed}", failures)
        return out

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        # ---- (a) the scene, written by the port
        t0 = time.perf_counter()
        write_dtu_multiscan(tmp, [scan], img_hw=DTU_HW, seed=DTU_SEED)
        write_s = time.perf_counter() - t0
        n_files, n_bytes = tree_size(tmp)
        print(f"[16a scene] {scan} at {w}x{h}: {n_files} files, "
              f"{n_bytes / 2 ** 20:.1f} MiB written in {write_s:.2f} s "
              f"({n_bytes / 2 ** 20 / write_s:.0f} MiB/s)")
        check(n_files == 49 * (1 + 7 + 1) + 1,
              "[16a] the scene's files are missing", failures)
        ckpt = save_seeded_checkpoint(os.path.join(tmp, "seeded.tar"), mlp,
                                      mvsnet)
        npz = lpips_weights(tmp)
        geometry = ["--pad", str(PAD), "--N_samples", str(N_SAMPLES),
                    "--imgScale_train", "1.0", "--imgScale_test", "1.0",
                    "--ckpt", ckpt]

        # ---- (b) the generalizable CLI on the dtu loader
        marks, spans, pngs, depths = {}, [], [], []
        with swapped(GeneralizableSystem, "_step",
                     stamped(GeneralizableSystem._step, {GEN_WARM, n_gen},
                             marks)), \
                swapped(MVSDatasetDTU, "__getitem__",
                        timed_calls(MVSDatasetDTU.__getitem__, spans)), \
                swapped(MVSDatasetDTU, "read_depth",
                        timed_calls(MVSDatasetDTU.read_depth, depths)), \
                swapped(dtu, "load_image",
                        timed_calls(dtu.load_image, pngs)):
            losses = cli("b", "train_mvs_nerf --dataset_name dtu",
                         ("K1", "K2", "K4", "K5 fwd", "K5 bwd", "K7 fwd",
                          "K7 bwd", "K8"),
                         lambda: train_mvs_nerf.main(geometry + [
                             "--dataset_name", "dtu", "--datadir", tmp,
                             "--scan_list", os.path.join(tmp, "scans.txt"),
                             "--batch_size", str(GEN_BATCH),
                             "--with_depth_loss", "--max_steps", str(n_gen),
                             "--N_vis", "1", "--expname", "smoke_dtu"]))
        t_a, t_b = marks[GEN_WARM], marks[n_gen]
        gen_ms = (t_b - t_a) * 1e3 / GEN_TIMED
        window = [s for t, s in spans if t_a < t < t_b]
        load_share = sum(window) / (t_b - t_a)
        png_ms, depth_ms = (sum(s for t, s in parts if t_a < t < t_b) * 1e3
                            / max(len(window), 1) for parts in (pngs, depths))
        panel = os.path.join("runs_new", "smoke_dtu",
                             f"val_00_{n_gen:08d}.png")
        shape = np.asarray(Image.open(panel)).shape \
            if os.path.exists(panel) else None
        print(f"[16b fit] {len(losses)} steps, loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}; steps {GEN_WARM + 1}-{n_gen}: "
              f"{gen_ms:.2f} ms/step from files (phase 8 in memory "
              f"{gen_step_ms:.2f}); the dtu loader's __getitem__ "
              f"{sum(window) * 1e3 / max(len(window), 1):.2f} ms a sample "
              f"({len(window)} in the window; its 4 PNG decodes "
              f"{png_ms:.2f} ms, its 4 depth maps {depth_ms:.2f} ms, "
              f"native.available() {native.available()}), "
              f"{100 * load_share:.1f} % of the steps' wall; panel "
              f"{os.path.basename(panel)} {shape}")
        check(len(losses) == n_gen and len(window) == GEN_TIMED and
              all(math.isfinite(v) for v in losses) and
              shape == (h, 3 * w, 3),
              "[16b] the generalizable CLI's losses, loader or validation "
              "panel are wrong", failures)

        # ---- (c) the fine-tune CLI on the dtu_ft loader, then its 4 val
        # views
        ft_dir = os.path.join(tmp, scan)
        marks, inits = {}, []
        with swapped(FinetuneSystem, "_step",
                     stamped(FinetuneSystem._step, {FT_WARM, n_ft}, marks)), \
                swapped(DTUFTDataset, "__init__",
                        timed_calls(DTUFTDataset.__init__, inits)):
            cli("c", "train_finetune --dataset_name dtu_ft",
                ("K1", "K4", "K5 fwd", "K5 bwd", "K7 fwd", "K7 bwd", "K8"),
                lambda: train_finetune.main(geometry + [
                    "--dataset_name", "dtu_ft", "--datadir", ft_dir,
                    "--batch_size", str(FT_BATCH), "--with_rgb_loss",
                    "--max_steps", str(n_ft), "--expname", "smoke_dtu_ft"]))
        ft_ms = (marks[n_ft] - marks[FT_WARM]) * 1e3 / FT_TIMED
        val_panels = sorted(f for f in os.listdir(os.path.join(
            "runs_fine_tuning", "smoke_dtu_ft")) if f.startswith("val_"))
        print(f"[16c fit] the dtu_ft loader: train ({FT_VIEWS} views, "
              f"{FT_VIEWS * h * w} rays) {inits[0][1]:.2f} s, val (4 views "
              f"with GT depth) {inits[1][1]:.2f} s; steps {FT_WARM + 1}-"
              f"{n_ft}: {ft_ms:.2f} ms/step from files, "
              f"{FT_BATCH / ft_ms * 1e3:.0f} rays/s (phase 6 in memory "
              f"{ft_step_ms:.2f}); val panels {val_panels}")
        check(len(inits) == 2 and len(val_panels) == 4,
              "[16c] the fine-tune CLI's loaders or val panels are wrong",
              failures)

        # ---- (d) evaluate on the 4 test views with LPIPS on the card
        first = {}
        score = Evaluator._score

        def first_scored(self, pred, gt, *args):
            first.setdefault("pair", (pred.copy(), gt.copy()))
            return score(self, pred, gt, *args)

        with swapped(Evaluator, "_score", first_scored):
            metrics = cli("d", "evaluate --render_mode chunked",
                          ("K1", "K4", "K8"),
                          lambda: evaluate.main(geometry + [
                              "--dataset_name", "dtu_ft", "--datadir",
                              ft_dir, "--render_mode", "chunked",
                              "--lpips_weights", npz, "--expname",
                              "smoke_dtu_eval"]))
        mean = metrics["mean"]
        with open(os.path.join("results", "smoke_dtu_eval",
                               "metrics.json")) as f:
            saved = json.load(f)["mean"]
        print(f"[16d evaluate] mean over {len(metrics['per_image'])} test "
              f"views: { {k: round(v, 5) for k, v in mean.items()} }")
        check(len(metrics["per_image"]) == 4 and saved == mean and
              all(math.isfinite(mean[k]) for k in ("psnr", "ssim", "lpips")),
              "[16d] evaluate's metrics are wrong", failures)

        # ---- (e) render_video from (c)'s snapshot
        snapshot = os.path.join("runs_fine_tuning", "smoke_dtu_ft", "ckpts",
                                f"ckpt_{n_ft:09d}.pt")
        frames = cli("e", "render_video --render_mode tiled", ("K1", "K6b"),
                     lambda: render_video.main(geometry + [
                         "--dataset_name", "dtu_ft", "--datadir", ft_dir,
                         "--render_mode", "tiled", "--ckpt", snapshot,
                         "--expname", "smoke_dtu_video"],
                         n_frames=CLI_FRAMES))
        # the interp path: 4 key poses, n_frames // 3 frames each
        print(f"[16e video] {len(frames)} frames of "
              f"{frames[0].shape if frames else None}")
        check(len(frames) == 4 * (CLI_FRAMES // 3) and
              all(f.shape == (h, 2 * w, 3) for f in frames),
              "[16e] render_video's frames are wrong", failures)

        # ---- (f) LPIPS on the card against the CPU on (d)'s first
        # prediction and ground truth
        pred, gt = (torch.from_numpy(x * 2 - 1).to(dev)
                    for x in first["pair"])
        on_card = LPIPS(npz)
        card = float(on_card(pred, gt))
        cpu = float(LPIPS(npz, "cpu")(pred.cpu(), gt.cpu()))
        rel = abs(card - cpu) / abs(cpu)
        lpips_ms = cuda_ms(lambda: on_card(pred, gt), reps=5)
        print(f"[16f lpips] LPIPS(npz) on {on_card.device}: {card!r}, on "
              f"the CPU {cpu!r}: rel diff {rel:.2e} (tol {TOL_LPIPS:.0e}); "
              f"{lpips_ms:.2f} ms a {w}x{h} pair on the card")
        check(on_card.device.type == "cuda" and rel <= TOL_LPIPS,
              "[16f] LPIPS on the card disagrees with the CPU", failures)

        # ---- (g) the post-hoc metrics of (d)'s panels, card and CPU
        flags = ["--panels", os.path.join("results", "smoke_dtu_eval",
                                          "*.png"),
                 "--width", str(w), "--lpips_weights", npz]
        with contextlib.redirect_stdout(io.StringIO()):
            panels_card, panels_ms = synced_ms(
                lambda: metrics_from_panels.main(flags))
            panels_cpu = metrics_from_panels.main(flags + ["--device", "cpu"])
        rows = list(zip(panels_card["per_image"], panels_cpu["per_image"]))
        d_psnr = max(abs(a["psnr"] - b["psnr"]) for a, b in rows)
        d_ssim = max(abs(a["ssim"] - b["ssim"]) for a, b in rows)
        d_lpips = max(abs(a["lpips"] - b["lpips"]) / abs(b["lpips"])
                      for a, b in rows)
        vs_evaluate = {k: float(f"{panels_card['mean'][k] - mean[k]:.3e}")
                       for k in ("psnr", "ssim", "lpips")}
        print(f"[16g panels] metrics_from_panels on {len(rows)} panels, "
              f"card against --device cpu: PSNR {d_psnr:.2e} dB (tol "
              f"{TOL_PANEL_PSNR:.0e}), SSIM {d_ssim:.2e} (tol "
              f"{TOL_PANEL_SSIM:.0e}), LPIPS rel {d_lpips:.2e} (tol "
              f"{TOL_LPIPS:.0e}); {panels_ms / 1e3:.2f} s on the card; its "
              f"mean minus evaluate's (the PNGs' 8 bits): {vs_evaluate}")
        check(len(rows) == 4 and d_psnr <= TOL_PANEL_PSNR and
              d_ssim <= TOL_PANEL_SSIM and d_lpips <= TOL_LPIPS,
              "[16g] metrics_from_panels on the card disagrees with the CPU",
              failures)

    for key, name in DTU_ENTRIES.items():
        next(k for k in kernels if k["name"] == name)["launches"] += \
            total[key]
    print(f"[16 launches] over (b)-(e): "
          f"{ {k: n for k, n in total.items() if n} }")
    print(f"[16 summary] scene written in {write_s:.2f} s; "
          f"generalizable {gen_ms:.2f} ms/step from files against "
          f"{gen_step_ms:.2f} in memory, the dtu loader "
          f"{100 * load_share:.1f} % of it; fine-tune {ft_ms:.2f} against "
          f"{ft_step_ms:.2f}, its loader {inits[0][1]:.2f} s; LPIPS "
          f"{lpips_ms:.2f} ms")
    print(f"[16 time] phase 16 took {time.perf_counter() - t_phase:.1f} s")


def main():
    t_start = time.perf_counter()
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
    from mvsnerf_tpu_torch.models.mvsnet import MVSNet
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    from mvsnerf_tpu_torch.ops.color_warp import color_warp, \
        color_warp_plain
    from mvsnerf_tpu_torch.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu_torch.ops.render_fused import render_v0, \
        render_v0_feats, render_v0_plain
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
    print(f"   render body (K6, K6b, K8): "
          f"{_build.library().render_v0_smem_bytes()} bytes of dynamic shared "
          f"memory a block, beside ptxas's static report")
    sass = sass_mma_counts(_build.library()._name)
    mma = {name: n for name, n in sass.items() if "render_v0_kernel" in name}
    print(f"[2 sass] tensor-core instructions (HMMA / HGMMA) in the render "
          f"body's forms: {mma}")
    mma7 = {key: sum(n for name, n in sass.items() if key in name)
            for key in K7_TC_KERNELS}
    print(f"[2 sass] tensor-core instructions in K7's kernels: {mma7}")
    mma10 = {key: sum(n for name, n in sass.items() if key in name)
             for key in K10_TC_KERNELS}
    print(f"[2 sass] tensor-core instructions in K10's kernels: {mma10}")

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
    check(len(mma) == 3 and all(mma.values()), "the render body's forms "
          "have no tensor-core instructions", failures)
    check(all(mma7.values()), "a K7 kernel has no tensor-core instructions",
          failures)
    check(all(mma10.values()), "a K10 kernel has no tensor-core "
          "instructions", failures)
    with torch.no_grad():
        volume, imgs01, nf, pose_t = ev.build_volume(imgs_norm, projs,
                                                     NEAR_FAR, pose_src)
        k1 = k1_inputs(ev, (imgs_norm, projs, pose_src))
        srcs, proj_t, depths = k1[:3]
        h4, w4 = srcs.shape[1:3]
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
        inp4, grid4 = k4_library_inputs(*k4)
        masks_equal = torch.equal(colors[..., 3::4], colors_p[..., 3::4])
        print(f"   K4 masks equal to the twin's: {masks_equal}")
        check(masks_equal, "K4's masks differ from the twin's", failures)
        kernels.append(dict(
            name="K4 color_warp", route="cuda",
            source="mvsnerf_tpu_torch/csrc/color_warp.cu",
            replaces="mvsnerf_tpu/ops/pallas_sweep.py:258",
            max_abs_err=max_err(colors, colors_p), tol=TOL_K4,
            ms=cuda_ms(lambda: color_warp(*k4)),
            plain_ms=cuda_ms(lambda: color_warp_plain(*k4)),
            # the RGB alone: no projection, no mask
            library_ms=cuda_ms(lambda: torch.nn.functional.grid_sample(
                inp4, grid4, mode="bilinear", padding_mode="border",
                align_corners=True)),
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
        mlp64 = copy.deepcopy(mlp).double()
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
                    mlp_flops(k6[0][..., 0].numel()), RENDER_TC_PASSES),
            **f64_anchor(r_k, r_p, lambda: render_v0_plain(
                *(a.double() for a in k6[:5]), mlp64))))
        print(f"   K6 inputs: acc mean {float(r_p['acc'].mean()):.4f}, "
              f"rgb std {float(r_p['rgb'].std()):.4f}")
        del k1, k4, k6, srcs, colors, colors_p, r_k, r_p, inp4, grid4, \
            mlp64
    report(3, kernels, failures)
    torch.cuda.empty_cache()
    # K4 backward launches by phase, from here on (phase 10 reads them)
    k4_bwd = {}

    def note_k4_bwd(phase):
        k4_bwd[phase] = color_warp.bwd_launches
        color_warp.bwd_launches = 0

    note_k4_bwd(3)

    # ---- 4. the slice, counting kernel launches
    wrappers = {"K1 sweep_cost_volume": sweep_cost_volume,
                "K4 color_warp": color_warp, "K6 render_v0": render_v0,
                "K8 render_v0_feats": render_v0_feats}
    for fn in wrappers.values():
        fn.launches = 0
    for key in k10.launches:
        k10.launches[key] = 0
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
          f"{volume_ms:.1f} ms on the default route, K10 launches "
          f"{k10.launches}")
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
    check(k10.launches == K10_PER_BUILD, f"the volume build launched K10 "
          f"{k10.launches} times, not {K10_PER_BUILD}", failures)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    note_k4_bwd(4)

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
            for m in ("chunked", "hybrid", "tiled")])
    (vg, *rg), (vc, *rc) = results
    verr = max_err(vg, vc) / (1 + float(vc.abs().max()))
    rerr = max(max_err(a, b) for a, b in zip(rg, rc))
    print(f"[5 small] card vs CPU: volume rel err {verr:.2e}, rgb err "
          f"{rerr:.2e} (chunked, hybrid, tiled)")
    check(verr <= 1e-4 and rerr <= 1e-4, "card and CPU disagree", failures)
    note_k4_bwd(5)

    # ---- 6. fine-tune
    torch.cuda.empty_cache()
    entries, ft_step_ms = finetune_phase(dev, mlp, mvsnet, failures)
    kernels += entries
    note_k4_bwd(6)

    # ---- 7. generalizable training
    torch.cuda.empty_cache()
    entries, cudnn_step_ms, k1_device = generalizable_phase(dev, mlp, mvsnet,
                                                           failures)
    next(k for k in kernels if k["name"] == "K1 sweep_cost_volume")[
        "device_ms_generalizable"] = k1_device
    kernels += entries
    note_k4_bwd(7)

    # ---- 8. the dband route: the U-Net on K10
    torch.cuda.empty_cache()
    entries, gen_step_ms = dband_phase(dev, mlp, mvsnet, failures,
                                       cudnn_step_ms,
                                       (imgs_norm, projs, NEAR_FAR, pose_src))
    kernels += entries
    note_k4_bwd(8)

    # ---- 9. the colour-baked volume, the eval and video entry points
    torch.cuda.empty_cache()
    kernels += color_phase(dev, mlp, mvsnet, ev, (imgs_norm, projs,
                                                  pose_src), requests,
                           failures)
    note_k4_bwd(9)

    # ---- 10. the render's gradient in its source images (K4 backward)
    torch.cuda.empty_cache()
    kernels.append(image_grad_phase(dev, mlp, mvsnet, requests, k4_bwd,
                                    failures))

    # ---- 11. the density volume and importance samples, and --use_disp
    torch.cuda.empty_cache()
    kernels += density_phase(dev, mlp, mvsnet, failures, ft_step_ms)

    # ---- 12. fusion: the fuse of 16 views, its steps and renders
    torch.cuda.empty_cache()
    kernels += fusion_phase(dev, mlp, mvsnet, failures)

    # ---- 13. the Blender and LLFF datasets: loaders, volumes, fine-tune,
    # requests and the CLIs at 800x800 and 960x640
    torch.cuda.empty_cache()
    kernels += dataset_phase(dev, mlp, mvsnet, failures)

    # ---- 14. data parallelism (NCCL at one rank, two gloo ranks on the
    # card) and the v1, v2 and fusion MLPs
    torch.cuda.empty_cache()
    k11_launches = parallel_phase(dev, mlp, mvsnet, failures, gen_step_ms,
                                  ft_step_ms)
    for k in kernels:
        if k["name"].startswith("K11 "):
            k["launches"] = k11_launches

    # ---- 15. resuming from JAX's .msgpack snapshots, run_batch, the
    # generalizable validation panels, the reference helpers
    torch.cuda.empty_cache()
    resume_phase(dev, mlp, mvsnet, failures)

    # ---- 16. the DTU path from files at 640x512: the scene writer, every
    # DTU CLI, LPIPS on the card and the post-hoc metric tool
    torch.cuda.empty_cache()
    dtu_phase(dev, mlp, mvsnet, failures, kernels, ft_step_ms, gen_step_ms)
    # ---- K4's forward on the device, on phase 3's inputs, taken last:
    # torch.profiler can leave CUPTI attached to the process and slow
    # every later launch on the host, and with it the host-bound fine-tune
    # step that phase 6 times
    k4_entry = next(k for k in kernels if k["name"] == "K4 color_warp")
    with torch.no_grad():
        _, imgs01, _, pose_t = ev.build_volume(imgs_norm, projs, NEAR_FAR,
                                               pose_src)
    k4_entry.update(k4_device_times(imgs01, pose_t, requests))
    print(f"[3 kernel] K4 color_warp on the device (torch.profiler, after "
          f"phase 10): kernel {k4_entry['device_ms']:.4f} ms, library "
          f"{k4_entry['device_library_ms']:.4f} ms; events - device "
          f"{k4_entry['ms'] - k4_entry['device_ms']:.4f} ms")
    # ---- K6's device time on phase 3's inputs, taken last for the same
    # reason
    k6_entry = next(k for k in kernels if k["name"] == "K6 render_v0")
    with torch.no_grad():
        k6 = k6_inputs(ev, mlp, (imgs_norm, projs, pose_src), requests)
        k6_entry["device_ms"] = device_total(lambda: render_v0(*k6))
        del k6
    print(f"[3 kernel] K6 render_v0 on the device (torch.profiler, after "
          f"phase 10): {k6_entry['device_ms']:.4f} ms (its weight packing "
          f"included); events - device "
          f"{k6_entry['ms'] - k6_entry['device_ms']:.4f} ms")
    # ---- K1's device time on phase 3's inputs, taken last for the same
    # reason
    k1_entry = next(k for k in kernels if k["name"] == "K1 sweep_cost_volume")
    with torch.no_grad():
        k1 = k1_inputs(ev, (imgs_norm, projs, pose_src))
        k1_entry["device_ms"] = device_total(lambda: sweep_cost_volume(*k1))
        k1_ms = cuda_ms(lambda: sweep_cost_volume(*k1), reps=10)
        del k1
    print(f"[3 kernel] K1 sweep_cost_volume on the device (torch.profiler, "
          f"after phase 10): {k1_entry['device_ms']:.4f} ms (its sources' "
          f"relayout included; {k1_entry['device_ms_generalizable']:.4f} ms "
          f"on phase 7's sources); events now {k1_ms:.4f} ms, in phase 3 "
          f"{k1_entry['ms']:.4f}")
    print(f"[time] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
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
