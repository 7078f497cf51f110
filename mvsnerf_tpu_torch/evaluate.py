"""No-finetune evaluation entry point (counterpart of the root evaluate.py,
reference renderer.ipynb cells 4-18), with the same flags:

    python -m mvsnerf_tpu_torch.evaluate --dataset_name dtu_ft \\
        --datadir /data/dtu/scan1 --ckpt /path/mvsnerf-v0.tar --pad 24 \\
        --render_mode tiled
    python -m mvsnerf_tpu_torch.evaluate --dataset_name blender \\
        --datadir /data/nerf_synthetic/lego --ckpt /path/mvsnerf-v0.tar \\
        --white_bkgd --pad 24

By default each validation image is rendered from the 3 training views
nearest it (the notebook protocol), the volume rebuilt per image;
`--fixed_sources` keeps the scene's default 3 sources. The val split of
`dtu_ft`, `blender` (scored on its central 80 %) or `llff`. `--render_mode`
picks `chunked`, `hybrid` or `tiled`. `--net_type`, `--netdepth` and
`--netwidth` name the checkpoint's MLP (its keys do not tell v0 from v2);
`hybrid` and `tiled` take the v0 MLP at D=6, W=128 alone and raise for
any other. LPIPS is scored when
`--lpips_weights` (default lpips_vgg.npz) exists. Runs on the CUDA card
(`--device cpu` runs on the CPU; with no card and no `--device cpu` it
raises). Prints the mean metrics and writes
`results/<expname>/metrics.json` and one panel per image.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import resolve_device
from .config import config_parser
from .data import per_scene_dataset
from .data.pairs import get_split
from .eval.evaluate import Evaluator
from .train.finetune import reference_modules


def train_split_info(ds, args):
    """(train_indices, train_c2ws, val_c2ws) for the per-image nearest-3
    protocol, in the dataset's absolute view ids; (None, None, None) when
    the scene has no pair split (the eval then keeps fixed sources, as the
    reference does for scenes missing from pairs.th)."""
    poses_all = np.asarray(ds.load_poses_all())
    if hasattr(ds, "pair_idx"):  # dtu_ft: its splits are loaded
        train_idx = np.asarray(ds.pair_idx[0])
    else:
        try:
            train_idx = np.asarray(get_split(
                os.path.basename(args.datadir.rstrip("/")), "train"))
        except KeyError:
            return None, None, None
    return train_idx, poses_all[train_idx], poses_all[np.asarray(ds.img_idx)]


def lpips_metric(args, device):
    """The LPIPS metric when its weights file exists; None (and a note)
    when the default file is missing; raises for a missing named file."""
    if os.path.exists(args.lpips_weights):
        from .eval.metrics import LPIPS
        return LPIPS(args.lpips_weights, device)
    if args.lpips_weights != "lpips_vgg.npz":
        raise FileNotFoundError(
            f"--lpips_weights {args.lpips_weights!r} does not exist")
    print("note: lpips_vgg.npz not found - metrics omit LPIPS")
    return None


def main(argv=None):
    args = config_parser(argv)
    dataset = per_scene_dataset(args.dataset_name)
    device = resolve_device(args.device)
    mlp, mvsnet, _ = reference_modules(args, device)
    val_ds = dataset(args, "val")
    evaluator = Evaluator(mvsnet, mlp, n_samples=args.N_samples,
                          pad=args.pad, white_bkgd=args.white_bkgd,
                          chunk=args.chunk * 5, device=device,
                          lindisp=args.use_disp)

    train_idx = train_c2ws = val_c2ws = None
    if not args.fixed_sources:
        train_idx, train_c2ws, val_c2ws = train_split_info(val_ds, args)
        if train_idx is None:
            print("note: no pair split for this scene - evaluating from "
                  "fixed sources")
    save_dir = os.path.join("results", args.expname or "eval")
    out = evaluator.evaluate(
        val_ds, mode=args.render_mode, lpips_fn=lpips_metric(args, device),
        save_dir=save_dir, per_image_sources=train_idx is not None,
        train_c2ws=train_c2ws, train_indices=train_idx, val_c2ws=val_c2ws,
        center_crop=args.dataset_name == "blender")
    print(json.dumps(out["mean"], indent=2))
    with open(os.path.join(save_dir, "metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
