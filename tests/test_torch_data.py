"""The port's dtu_ft loader against the JAX package's, on a minimal DTU
tree written here (cameras and images of the 20 views the dtu split
reads, no depth maps), at imgScale 0.1: flat training rays and colours,
per-image val rays and colours, and the source views for the volume. The
loaders share their numpy arithmetic, so everything agrees exactly. Also:
the port's pair tables are a copy of the JAX package's."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    from PIL import Image

    from mvsnerf_tpu_torch.data.common import write_cam_file
    from mvsnerf_tpu_torch.data.pairs import get_split
    root = tmp_path_factory.mktemp("dtu")
    os.makedirs(root / "Cameras/train")
    os.makedirs(root / "Rectified/scan1_train")
    rng = np.random.default_rng(5)
    views = np.concatenate([get_split("dtu", "train"),
                            get_split("dtu", "test")])
    for vid in views:
        a = 0.02 * (vid - 24)
        ext = np.eye(4)
        ext[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]]
        ext[:3, 3] = [8.0 * (vid - 24), 3.0, 600]
        intr = np.array([[180.0, 0, 80], [0, 181.0, 64], [0, 0, 1]])
        write_cam_file(root / f"Cameras/train/{vid:08d}_cam.txt", intr, ext,
                       425.0, 2.5)
        Image.fromarray(rng.integers(0, 256, (64, 80, 3), np.uint8)).save(
            root / f"Rectified/scan1_train/rect_{vid + 1:03d}_3_r5000.png")
    return str(root / "scan1")


def _args(datadir):
    return SimpleNamespace(datadir=datadir, imgScale_train=0.1,
                           imgScale_test=0.1)


@pytest.mark.parametrize("split", ["train", "val"])
def test_dtu_ft_matches_jax(scan, split):
    from mvsnerf_tpu.data.dtu_ft import DTUFTDataset as JaxDataset
    from mvsnerf_tpu_torch.data.dtu_ft import DTUFTDataset
    ours, ref = DTUFTDataset(_args(scan), split), \
        JaxDataset(_args(scan), split)
    assert ours.img_wh == ref.img_wh == (64, 51)
    n_views = 16 if split == "train" else 4
    if split == "train":
        assert ours.all_rays.shape == (n_views * 64 * 51, 8)
    else:
        assert ours.all_rgbs.shape == (n_views, 51, 64, 3)
        assert ours.all_depth is None and len(ours) == n_views
    np.testing.assert_array_equal(ours.all_rays, ref.all_rays)
    np.testing.assert_array_equal(ours.all_rgbs, ref.all_rgbs)
    np.testing.assert_array_equal(ours.poses, ref.poses)
    a, b = ours[1], ref[1]
    np.testing.assert_array_equal(a["rays"], b["rays"])


def test_read_source_views_matches_jax(scan):
    from mvsnerf_tpu.data.dtu_ft import DTUFTDataset as JaxDataset
    from mvsnerf_tpu_torch.data.dtu_ft import DTUFTDataset
    ours = DTUFTDataset(_args(scan), "train", load_ref=True)
    ref = JaxDataset(_args(scan), "train", load_ref=True)
    (imgs, projs, nf, pose), (r_imgs, r_projs, r_nf, r_pose) = \
        ours.read_source_views(), ref.read_source_views()
    assert imgs.shape == (3, 51, 64, 3) and projs.shape == (3, 3, 4)
    np.testing.assert_array_equal(imgs, r_imgs)
    np.testing.assert_array_equal(projs, r_projs)
    assert nf == r_nf
    assert pose.keys() == r_pose.keys()
    for k in pose:
        np.testing.assert_array_equal(pose[k], r_pose[k])


def test_pair_tables_are_a_copy():
    with open(os.path.join(ROOT, "mvsnerf_tpu/configs/pairs.json")) as f:
        ref = json.load(f)
    with open(os.path.join(ROOT, "mvsnerf_tpu_torch/configs/pairs.json")) as f:
        ours = json.load(f)
    assert ours == ref


def test_pfm_round_trip(tmp_path):
    from mvsnerf_tpu.data.common import read_pfm as jax_read_pfm
    from mvsnerf_tpu_torch.data.common import read_pfm, resize_nearest, \
        write_pfm
    depth = np.random.default_rng(1).uniform(400, 900, (30, 40)).astype(
        np.float32)
    write_pfm(tmp_path / "d.pfm", depth)
    ours, scale = read_pfm(tmp_path / "d.pfm")
    np.testing.assert_array_equal(ours, depth)
    np.testing.assert_array_equal(ours, jax_read_pfm(tmp_path / "d.pfm")[0])
    assert scale == 1.0
    assert resize_nearest(depth, 0.5, 0.5).shape == (15, 20)


def test_train_finetune_cli_writes_and_resumes(scan, tmp_path, monkeypatch,
                                               capsys):
    """`python -m mvsnerf_tpu_torch.train_finetune` on the tree: trains,
    writes metrics.csv (the val views' PSNR and SSIM, as the root CLI
    logs them), a panel per val view and a snapshot, and a second run
    resumes from it."""
    from mvsnerf_tpu_torch.train_finetune import main
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset_name", "dtu_ft", "--datadir", scan, "--expname",
            "cli", "--with_rgb_loss", "--imgScale_train", "0.1",
            "--imgScale_test", "0.1", "--pad", "4", "--N_samples", "8",
            "--batch_size", "64", "--device", "cpu", "--max_steps"]
    main(argv + ["2"])
    run = tmp_path / "runs_fine_tuning/cli"
    assert sorted(os.listdir(run / "ckpts")) == ["ckpt_000000002.pt"]
    rows = (run / "metrics.csv").read_text().splitlines()
    assert rows[0].split(",") == ["step", "train/loss", "train/PSNR",
                                  "val/PSNR", "val/SSIM"] and \
        len(rows) == 1 + 1 + 4
    assert sorted(n for n in os.listdir(run) if n.endswith(".png")) == [
        f"val_{i:02d}_00000002.png" for i in range(4)]
    main(argv + ["3"])
    assert "resumed from runs_fine_tuning/cli/ckpts at step 2" in \
        capsys.readouterr().out
    assert "ckpt_000000003.pt" in os.listdir(run / "ckpts")
