"""Generalizable training entry point (counterpart of train_mvs_nerf.py,
reference train_mvs_nerf_pl.py), with the same flags:

    python -m mvsnerf_tpu_torch.train_mvs_nerf --expname dtu_gen \\
        --dataset_name dtu --datadir /data/dtu --num_epochs 6 \\
        --batch_size 1024 --N_samples 128 --with_depth --with_depth_loss \\
        --pad 24

Runs on the CUDA card (`--device cpu` runs on the CPU; with no card and no
`--device cpu` it raises). Writes `runs_new/<expname>/metrics.csv` (train
loss, MSE, PSNR and depth loss every 100 steps; val PSNR every
`--val_every` steps, at each epoch end and after the last step) and
snapshots under `runs_new/<expname>/ckpts/`, and resumes from the newest of
them by default. It takes `--dataset_name dtu` only, as JAX's does
(the per-scene datasets raise, saying why); the validation panels are not
ported, and `--num_devices` above 1 (data parallelism) is refused.
"""

from __future__ import annotations

import os

import numpy as np

from . import resolve_device
from .config import config_parser
from .data.dtu import MVSDatasetDTU
from .train.finetune import psnr
from .train.generalizable import GeneralizableSystem
from .utils.logging import MetricLogger


def main(argv=None):
    args = config_parser(argv)
    if args.dataset_name != "dtu":
        raise NotImplementedError(
            f"--dataset_name {args.dataset_name}: generalizable training "
            "runs on dtu only: its step reads multi-view samples with "
            "per-view projections, near/far and poses "
            "(mvsnerf_tpu/train/generalizable.py:100-104), which only "
            "MVSDatasetDTU gives, and the JAX CLI builds its dataset as "
            "MVSDatasetDTU's constructor takes it (train_mvs_nerf.py:27-30); "
            "dtu_ft, blender and llff are per-scene datasets for "
            "train_finetune")
    if args.num_devices > 1:
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: data-parallel training is "
            "not ported yet; 0 (all) and 1 run on the one card")
    device = resolve_device(args.device)
    log_dir = os.path.join("runs_new", args.expname or "exp")
    logger = MetricLogger(log_dir)

    extra = {}
    if args.scan_list:
        with open(args.scan_list) as f:
            extra["scan_list"] = [ln.strip() for ln in f if ln.strip()]
    train_ds = MVSDatasetDTU(args.datadir, "train",
                             downSample=args.imgScale_train, **extra)
    val_ds = MVSDatasetDTU(args.datadir, "val", downSample=args.imgScale_test,
                           max_len=10, **extra)

    system = GeneralizableSystem(args, device=device)
    ckpt_dir = os.path.join(log_dir, "ckpts")
    start = system.restore(ckpt_dir)  # resume by default
    if start:
        print(f"resumed from {ckpt_dir} at step {start}")

    def validate(step):
        """Mean PSNR of the first N_vis val views (the reference's PL val
        loop, train_mvs_nerf_pl.py:172-254)."""
        vals = []
        for i in range(min(len(val_ds), args.N_vis)):
            out = system.render_view(val_ds[i], chunk=args.chunk * 8)
            vals.append(psnr(np.clip(out["rgb"], 0, 1), out["target"]))
        if vals:
            logger.log_scalars(step, {"val/PSNR": float(np.mean(vals))})
            print(f"step {step}: val PSNR {np.mean(vals):.3f} over "
                  f"{len(vals)} views")

    losses = system.fit(train_ds, num_epochs=args.num_epochs, logger=logger,
                        ckpt_dir=ckpt_dir, max_steps=args.max_steps or None,
                        ckpt_every=args.ckpt_every, val_fn=validate,
                        val_every=args.val_every)
    if losses:
        print(f"{len(losses)} steps on {device}: loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}")
    validate(system.global_step)


if __name__ == "__main__":
    main()
