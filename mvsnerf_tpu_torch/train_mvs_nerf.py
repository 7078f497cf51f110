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
them by default (a JAX run's `.msgpack` snapshots too, when the directory
holds no `.pt`). Each validation writes a [target | rgb | depth] panel
`val_<i>_<step>.png` per val view beside the CSV, and TensorBoard events
go there too when `tensorboardX` imports. It takes `--dataset_name dtu`
only, as JAX's does (the per-scene datasets raise, saying why).

`--num_devices` keeps JAX's meaning (the root train_mvs_nerf.py:34-42): 1
is one process, 0 every visible card, N > 1 N data-parallel ranks, one a
card, over NCCL (train/generalizable.py). Under torchrun (WORLD_SIZE set)
the ranks are torchrun's and `--num_devices` must be 0 or WORLD_SIZE:

    torchrun --nproc_per_node 4 -m mvsnerf_tpu_torch.train_mvs_nerf ...

Otherwise the CLI spawns its ranks itself (torch.multiprocessing, a
`file://` store in a temporary directory). More ranks than cards raises;
with `--device cpu` the ranks are gloo processes on the CPU. Rank 0 alone
logs, validates and writes snapshots; every rank resumes from the same
one.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from . import resolve_device
from .config import config_parser
from .data.dtu import MVSDatasetDTU
from .parallel import init_distributed, is_main_rank, make_mesh
from .train.finetune import psnr
from .train.generalizable import GeneralizableSystem
from .utils.logging import MetricLogger
from .utils.vis import panel, visualize_depth


def n_ranks(args, device) -> int:
    """The ranks `--num_devices` asks for on `device` (1 on the CPU for 0):
    raises when it asks for more cards than there are."""
    if args.num_devices < 0:
        raise ValueError(f"--num_devices {args.num_devices}")
    if device.type == "cpu":
        return args.num_devices or 1
    cards = torch.cuda.device_count()
    n = args.num_devices or cards
    if n > cards:
        raise ValueError(f"--num_devices {n}: {n} ranks, one a card, but "
                         f"torch sees {cards} card(s)")
    return n


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
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
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:  # under torchrun
        world = int(os.environ["WORLD_SIZE"])
        if args.num_devices not in (0, world):
            raise ValueError(f"--num_devices {args.num_devices} under "
                             f"torchrun's WORLD_SIZE {world}: pass 0 or "
                             f"{world}")
        if init_distributed(device=device):
            try:
                local = int(os.environ.get("LOCAL_RANK", 0))
                return train(args, _rank_device(device, local), make_mesh())
            finally:
                torch.distributed.destroy_process_group()
        return train(args, device)
    world = n_ranks(args, device)
    if world == 1:
        return train(args, device)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(argv, world, f"file://{tmp}/store"),
            nprocs=world, join=True)
    return None


def _rank_device(device, local_rank):
    return torch.device("cuda", local_rank) if device.type == "cuda" \
        else device


def _rank_main(rank, argv, world, init_method):
    """One spawned rank: join the group, train, leave it."""
    args = config_parser(argv)
    device = torch.device(args.device)
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(init_method, rank, world, local_rank=rank,
                     device=device)
    try:
        train(args, _rank_device(device, rank), make_mesh())
    finally:
        torch.distributed.destroy_process_group()


def train(args, device, mesh=None):
    """Train on `device` (one rank of `mesh` when given) and validate;
    returns the step losses."""
    main_rank = is_main_rank()
    log_dir = os.path.join("runs_new", args.expname or "exp")
    logger = MetricLogger(log_dir) if main_rank else None

    extra = {}
    if args.scan_list:
        with open(args.scan_list) as f:
            extra["scan_list"] = [ln.strip() for ln in f if ln.strip()]
    train_ds = MVSDatasetDTU(args.datadir, "train",
                             downSample=args.imgScale_train, **extra)
    val_ds = MVSDatasetDTU(args.datadir, "val", downSample=args.imgScale_test,
                           max_len=10, **extra)

    system = GeneralizableSystem(args, device=device, mesh=mesh)
    ckpt_dir = os.path.join(log_dir, "ckpts")
    start = system.restore(ckpt_dir)  # resume by default, on every rank
    if start and main_rank:
        print(f"resumed from {ckpt_dir} at step {start}")

    def val_fn(step):
        validate(system, logger, val_ds, step, args.N_vis, args.chunk * 8)

    losses = system.fit(train_ds, num_epochs=args.num_epochs, logger=logger,
                        ckpt_dir=ckpt_dir, max_steps=args.max_steps or None,
                        ckpt_every=args.ckpt_every, val_fn=val_fn,
                        val_every=args.val_every)
    if losses and main_rank:
        ranks = f" x {torch.distributed.get_world_size()} ranks" \
            if mesh is not None else ""
        print(f"{len(losses)} steps on {device}{ranks}: loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}")
    system.on_main_rank(val_fn, system.global_step)
    if logger is not None:
        logger.flush()
    return losses


def validate(system, logger, val_samples, step: int, n_vis: int,
             chunk: int = 8192):
    """Render the first `n_vis` of `val_samples` (`render_view`), write
    each one's [target | clip(rgb) | depth] panel as `val_{i:02d}` and log
    their mean PSNR (the root train_mvs_nerf.py:54-67, the reference's PL
    val loop, train_mvs_nerf_pl.py:172-254). Returns the mean PSNR, or
    None with no view."""
    vals = []
    for i in range(min(len(val_samples), n_vis)):
        out = system.render_view(val_samples[i], chunk=chunk)
        rgb = np.clip(out["rgb"], 0, 1)
        vals.append(psnr(rgb, out["target"]))
        dvis, _ = visualize_depth(out["depth"])
        logger.save_panel(step, f"val_{i:02d}",
                          panel([out["target"], rgb, dvis]))
    if not vals:
        return None
    mean = float(np.mean(vals))
    logger.log_scalars(step, {"val/PSNR": mean})
    print(f"step {step}: val PSNR {mean:.3f} over {len(vals)} views")
    return mean


if __name__ == "__main__":
    main()
