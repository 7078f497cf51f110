"""Per-scene fine-tuning entry point (counterpart of
train_mvs_nerf_finetuning.py, reference train_mvs_nerf_finetuning_pl.py),
with the same flags:

    python -m mvsnerf_tpu_torch.train_finetune --dataset_name dtu_ft \\
        --datadir /data/dtu/scan1 --expname scan1-ft --with_rgb_loss \\
        --ckpt /path/mvsnerf-v0.tar --batch_size 1024 --pad 24
    python -m mvsnerf_tpu_torch.train_finetune --dataset_name llff \\
        --datadir /data/nerf_llff_data/horns --expname horns-ft \\
        --with_rgb_loss --ckpt /path/mvsnerf-v0.tar --pad 24
    python -m mvsnerf_tpu_torch.train_finetune --dataset_name blender \\
        --datadir /data/nerf_synthetic/lego --expname lego-ft --white_bkgd \\
        --with_rgb_loss --ckpt /path/mvsnerf-v0.tar --pad 24

`--dataset_name` takes the per-scene datasets `dtu_ft`, `blender` and
`llff` (data/__init__.py's `dataset_dict`).

Runs on the CUDA card (`--device cpu` runs on the CPU; with no card and no
`--device cpu` it raises). Writes
`runs_fine_tuning/<expname>/metrics.csv` (train loss/PSNR, val PSNR) and
snapshots under `runs_fine_tuning/<expname>/ckpts/`, and resumes from the
newest of them by default. `--use_color_volume` trains the colour-baked
20-channel volume; `--render_mode tiled` renders the validation views
through K6b; `--use_density_volume --N_importance N` adds N importance
samples a ray drawn from a density volume baked every 200 steps;
`--use_disp` samples linearly in disparity. After training, each val view
logs its PSNR and SSIM and writes its [gt | pred | depth] panel
`val_<i>_<steps>.png` (the root train_mvs_nerf_finetuning.py:44-58);
TensorBoard events land beside the CSV when `tensorboardX` imports. A
run's `ckpts/` holding only a JAX run's `.msgpack` snapshots resumes from
the newest of them.
"""

from __future__ import annotations

import os

import numpy as np

from . import resolve_device
from .config import config_parser
from .data import per_scene_dataset
from .eval.metrics import ssim
from .train.finetune import FinetuneSystem, psnr
from .utils.logging import MetricLogger
from .utils.vis import panel, visualize_depth


def main(argv=None):
    args = config_parser(argv)
    dataset = per_scene_dataset(args.dataset_name)
    device = resolve_device(args.device)
    log_dir = os.path.join("runs_fine_tuning", args.expname or "exp")
    logger = MetricLogger(log_dir)

    train_ds, val_ds = dataset(args, "train"), dataset(args, "val")
    system = FinetuneSystem(args, train_ds, val_ds, device=device)
    ckpt_dir = os.path.join(log_dir, "ckpts")
    n_steps = args.max_steps or 10000
    start = system.restore(ckpt_dir)
    if start:
        print(f"resumed from {ckpt_dir} at step {start}")
    if start >= n_steps:
        print(f"snapshot already at step {start} >= {n_steps}; "
              "skipping training")
    losses = system.fit(num_steps=n_steps, logger=logger, ckpt_dir=ckpt_dir,
                        start_step=start)
    if losses:
        print(f"steps {start}..{n_steps - 1} on {device}: loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}")

    for i in range(len(val_ds)):
        sample = val_ds[i]
        gt = np.asarray(sample["rgbs"])
        h, w = gt.shape[:2]
        out = system.render_image(sample["rays"], chunk=args.chunk * 8)
        pred = out["rgb"].clamp(0, 1).cpu().numpy().reshape(h, w, 3)
        val_psnr = psnr(pred, gt)
        logger.log_scalars(n_steps + i, {"val/PSNR": val_psnr,
                                         "val/SSIM": float(ssim(pred, gt))})
        dvis, _ = visualize_depth(out["depth"].cpu().numpy().reshape(h, w))
        logger.save_panel(n_steps, f"val_{i:02d}", panel([gt, pred, dvis]))
        print(f"val view {i}: PSNR {val_psnr:.3f}")
    logger.flush()


if __name__ == "__main__":
    main()
