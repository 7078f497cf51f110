"""Free-viewpoint video entry point (counterpart of the root
render_video.py, reference renderer_video.ipynb), with the same flags:

    python -m mvsnerf_tpu_torch.render_video --dataset_name dtu_ft \\
        --datadir /data/dtu/scan1 --ckpt /path/mvsnerf-v0.tar \\
        --expname scan1-video --render_mode tiled

Builds the fine-tune system from a reference-format `--ckpt` (`.tar`),
or restores exactly the port snapshot that `--ckpt` names (`ckpt_*.pt`,
strictly: a missing file raises, and no other snapshot is read), then
renders 60 frames along the scene's path (the DTU views interpolated)
with a depth panel beside each, and writes `results/<expname>.mp4` (a GIF
without imageio's ffmpeg plugin). Runs on the CUDA card (`--device cpu`
runs on the CPU).
"""

from __future__ import annotations

import os

from . import resolve_device
from .config import config_parser
from .data.dtu_ft import DTUFTDataset
from .eval.video import make_path, render_video
from .train.finetune import FinetuneSystem

DATASETS = {"dtu_ft": DTUFTDataset}


def main(argv=None, n_frames: int = 60):
    args = config_parser(argv)
    if args.dataset_name not in DATASETS:
        raise NotImplementedError(f"--dataset_name {args.dataset_name}: "
                                  f"only {sorted(DATASETS)} is ported")
    device = resolve_device(args.device)
    train_ds = DATASETS[args.dataset_name](args, "train")
    system = FinetuneSystem(args, train_ds, device=device)
    if args.ckpt and args.ckpt.endswith(".pt"):
        # exactly the named snapshot, as the root render_video.py:27-32
        step = system.restore(args.ckpt, strict=True)
        print(f"restored {args.ckpt} (step {step})")

    poses = make_path("interp", dataset=train_ds, n_frames=n_frames)
    w, h = train_ds.img_wh
    out = os.path.join("results", f"{args.expname or 'video'}.mp4")
    frames = render_video(system, poses, h, w, train_ds.focal,
                          train_ds.near_far, out,
                          chunk=args.chunk * 8, with_depth_panel=True)
    print(f"wrote {len(frames)} frames to {render_video.last_path}")
    return frames


if __name__ == "__main__":
    main()
