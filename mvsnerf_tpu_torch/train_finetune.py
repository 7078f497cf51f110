"""Per-scene fine-tuning entry point (counterpart of
train_mvs_nerf_finetuning.py, reference train_mvs_nerf_finetuning_pl.py),
with the same flags:

    python -m mvsnerf_tpu_torch.train_finetune --dataset_name dtu_ft \\
        --datadir /data/dtu/scan1 --expname scan1-ft --with_rgb_loss \\
        --ckpt /path/mvsnerf-v0.tar --batch_size 1024 --pad 24

Runs on the CUDA card (`--device cpu` runs on the CPU; with no card and no
`--device cpu` it raises). Writes
`runs_fine_tuning/<expname>/metrics.csv` (train loss/PSNR, val PSNR) and
snapshots under `runs_fine_tuning/<expname>/ckpts/`, and resumes from the
newest of them by default. `--use_color_volume` trains the colour-baked
20-channel volume; `--render_mode tiled` renders the validation views
through K6b; `--use_density_volume --N_importance N` adds N importance
samples a ray drawn from a density volume baked every 200 steps;
`--use_disp` samples linearly in disparity. SSIM and the image panels of validation are not ported yet
(`evaluate.py` has both).
"""

from __future__ import annotations

import os

from . import resolve_device
from .config import config_parser
from .data.dtu_ft import DTUFTDataset
from .train.finetune import FinetuneSystem, psnr
from .utils.logging import MetricLogger

DATASETS = {"dtu_ft": DTUFTDataset}


def main(argv=None):
    args = config_parser(argv)
    if args.dataset_name not in DATASETS:
        raise NotImplementedError(f"--dataset_name {args.dataset_name}: "
                                  f"only {sorted(DATASETS)} is ported")
    device = resolve_device(args.device)
    log_dir = os.path.join("runs_fine_tuning", args.expname or "exp")
    logger = MetricLogger(log_dir)

    dataset = DATASETS[args.dataset_name]
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
        gt = sample["rgbs"]
        h, w = gt.shape[:2]
        out = system.render_image(sample["rays"], chunk=args.chunk * 8)
        pred = out["rgb"].clamp(0, 1).cpu().numpy().reshape(h, w, 3)
        val_psnr = psnr(pred, gt)
        logger.log_scalars(n_steps + i, {"val/PSNR": val_psnr})
        print(f"val view {i}: PSNR {val_psnr:.3f}")


if __name__ == "__main__":
    main()
