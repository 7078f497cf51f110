"""Free-viewpoint video entry point (counterpart of the root
render_video.py, reference renderer_video.ipynb), with the same flags:

    python -m mvsnerf_tpu_torch.render_video --dataset_name dtu_ft \\
        --datadir /data/dtu/scan1 --ckpt /path/mvsnerf-v0.tar \\
        --expname scan1-video --render_mode tiled
    python -m mvsnerf_tpu_torch.render_video --dataset_name blender \\
        --datadir /data/nerf_synthetic/lego --white_bkgd \\
        --ckpt runs_fine_tuning/lego-ft/ckpts/ckpt_000010000.pt \\
        --expname lego-video

Builds the fine-tune system from a reference-format `--ckpt` (`.tar`),
or restores exactly the snapshot that `--ckpt` names, the port's
(`ckpt_*.pt`) or the JAX package's (`ckpt_*.msgpack`, as the root
render_video.py:27-31 does), strictly: a missing file raises, and no
other snapshot is read. Then it renders 60 frames along the scene's path
(`dtu_ft`: its views interpolated; `blender`: NeRF's orbit; `llff`: a
spheric path of radius 4, as in JAX) with a depth panel beside each, and
writes `results/<expname>.mp4` (a GIF without imageio's ffmpeg plugin).
Runs on the CUDA card (`--device cpu` runs on the CPU).
"""

from __future__ import annotations

import os

from . import resolve_device
from .config import config_parser
from .data import per_scene_dataset
from .eval.video import make_path, render_video
from .train.finetune import SNAPSHOT_SUFFIXES, FinetuneSystem

# the video path of each dataset (the root render_video.py:34-35)
PATH_KIND = {"blender": "nerf", "llff": "spheric", "dtu_ft": "interp"}


def main(argv=None, n_frames: int = 60):
    args = config_parser(argv)
    dataset = per_scene_dataset(args.dataset_name)
    device = resolve_device(args.device)
    train_ds = dataset(args, "train")
    system = FinetuneSystem(args, train_ds, device=device)
    if args.ckpt and args.ckpt.endswith(SNAPSHOT_SUFFIXES):
        # exactly the named snapshot, as the root render_video.py:27-32
        step = system.restore(args.ckpt, strict=True)
        print(f"restored {args.ckpt} (step {step})")

    poses = make_path(PATH_KIND[args.dataset_name], dataset=train_ds,
                      n_frames=n_frames)
    w, h = train_ds.img_wh
    # LLFF has no near_far: its video renders at [2, 6], as the root
    # render_video.py:40 does (ROADMAP.md Queue 3)
    near_far = getattr(train_ds, "near_far", [2.0, 6.0])
    out = os.path.join("results", f"{args.expname or 'video'}.mp4")
    frames = render_video(system, poses, h, w, train_ds.focal, near_far, out,
                          chunk=args.chunk * 8, with_depth_panel=True)
    print(f"wrote {len(frames)} frames to {render_video.last_path}")
    return frames


if __name__ == "__main__":
    main()
