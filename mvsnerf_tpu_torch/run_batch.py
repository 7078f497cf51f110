"""Batch driver for fine-tune + eval sweeps over scene lists (counterpart
of the root run_batch.py, reference run_batch.py), with the same argv:

    python -m mvsnerf_tpu_torch.run_batch blender ./data/nerf_synthetic \\
        ./ckpts/mvsnerf-v0.tar
    python -m mvsnerf_tpu_torch.run_batch llff ./data/nerf_llff_data \\
        ./ckpts/mvsnerf-v0.tar

For each scene of the dataset's list it runs one fine-tune process
(`python -m mvsnerf_tpu_torch.train_finetune`) and one evaluation process
(`python -m mvsnerf_tpu_torch.evaluate`), each to its end before the next
starts, so that no device state carries over between scenes; a process
that fails stops the sweep (`check=True`). The flags are JAX's: batch
1024, pad 24, `--with_rgb_loss`, `--imgScale_test 1.0`, and
`--white_bkgd` for Blender. Both write under the working directory
(`runs_fine_tuning/<scene>-ft/`, `results/<scene>-eval/`).
"""

from __future__ import annotations

import os
import subprocess
import sys

BLENDER_SCENES = ["ship", "mic", "chair", "lego", "drums", "ficus",
                  "materials", "hotdog"]
LLFF_SCENES = ["fern", "flower", "fortress", "horns", "leaves", "orchids",
               "room", "trex"]


def scene_commands(dataset: str, data_root: str, ckpt: str, scene: str):
    """The fine-tune and the evaluation command of one scene."""
    datadir = os.path.join(data_root, scene)
    white = ["--white_bkgd"] if dataset == "blender" else []
    return [
        [sys.executable, "-m", "mvsnerf_tpu_torch.train_finetune",
         "--dataset_name", dataset, "--datadir", datadir,
         "--expname", f"{scene}-ft", "--ckpt", ckpt,
         "--batch_size", "1024", "--pad", "24", "--with_rgb_loss",
         "--imgScale_test", "1.0"] + white,
        [sys.executable, "-m", "mvsnerf_tpu_torch.evaluate",
         "--dataset_name", dataset, "--datadir", datadir,
         "--expname", f"{scene}-eval", "--ckpt", ckpt, "--pad", "24"]
        + white]


def run(cmd):
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    dataset = argv[0] if len(argv) > 0 else "blender"
    data_root = argv[1] if len(argv) > 1 else "./data/nerf_synthetic"
    ckpt = argv[2] if len(argv) > 2 else "./ckpts/mvsnerf-v0.tar"
    scenes = BLENDER_SCENES if dataset == "blender" else LLFF_SCENES
    for scene in scenes:
        for cmd in scene_commands(dataset, data_root, ckpt, scene):
            run(cmd)


if __name__ == "__main__":
    main()
