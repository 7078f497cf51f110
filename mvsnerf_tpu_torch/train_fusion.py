"""Fusion fine-tuning entry point (counterpart of
train_mvs_nerf_fusion_finetuning.py, reference
train_mvs_nerf_fusion_finetuning_pl.py), with the same flags: fuse a local
encoding volume per training view into a canonical 128^3 grid, then
fine-tune it for free-viewpoint video.

    python -m mvsnerf_tpu_torch.train_fusion --dataset_name dtu_ft \\
        --datadir /data/dtu/scan1 --expname scan1-fusion --with_rgb_loss \\
        --ckpt /path/mvsnerf-v0.tar --batch_size 1024 --pad 24

Runs on the CUDA card (`--device cpu` runs on the CPU; with no card and no
`--device cpu` it raises). Writes `runs_fine_tuning/<expname>/metrics.csv`
(train loss and PSNR, val PSNR), the validation panels beside it and
snapshots under `runs_fine_tuning/<expname>/ckpts/`, and resumes from the
newest of them. `--N_importance N` adds N importance samples a ray drawn
from a density volume refreshed every 500 steps; `--render_mode tiled`
renders the validation views through K6b.
"""

from __future__ import annotations

import os

from . import resolve_device
from .config import config_parser
from .train.fusion import FusionFinetuneSystem
from .train_finetune import DATASETS
from .utils.logging import MetricLogger


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
    system = FusionFinetuneSystem(args, train_ds, val_ds, device=device)
    ckpt_dir = os.path.join(log_dir, "ckpts")
    n_steps = args.max_steps or 10000
    start = system.restore(ckpt_dir)
    if start:
        print(f"resumed from {ckpt_dir} at step {start}")
    losses = system.fit(num_steps=n_steps, logger=logger, ckpt_dir=ckpt_dir,
                        start_step=start)
    if losses:
        print(f"steps {start}..{n_steps - 1} on {device}: loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}")


if __name__ == "__main__":
    main()
