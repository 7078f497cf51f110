"""DTU per-scene fine-tuning dataset (counterpart of
mvsnerf_tpu/data/dtu_ft.py, reference data/dtu_ft.py).

Flat ray buffers [o, d, near, far] (N*h*w, 8) for training, per-image rays
and GT depth for eval, and `read_source_views` for building the encoding
volume. Numpy only: the trainer moves what it needs to its device.
"""

from __future__ import annotations

import os

import numpy as np

from .common import (load_image, normalize_imagenet, read_cam_file,
                     read_pfm, resize_nearest)
from .pairs import get_split


def _ray_dirs(h, w, focal, center):
    """Camera-frame ray directions, no half-pixel centering
    (data/ray_utils.py:12-29)."""
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32), indexing="xy")
    return np.stack([(xs - center[0]) / focal[0],
                     (ys - center[1]) / focal[1],
                     np.ones_like(xs)], -1)


def rays_for_pose(h, w, focal, center, c2w, near, far):
    """(h*w, 8) flat ray buffer [o, d, near, far]."""
    dirs = _ray_dirs(h, w, focal, center).reshape(-1, 3)
    rays_d = dirs @ np.asarray(c2w)[:3, :3].T
    rays_o = np.broadcast_to(np.asarray(c2w)[:3, 3], rays_d.shape)
    nf = np.empty((len(rays_d), 2), np.float32)
    nf[:, 0], nf[:, 1] = near, far
    return np.concatenate([rays_o, rays_d, nf], -1).astype(np.float32)


class DTUFTDataset:
    """Per-scene DTU dataset (reference data/dtu_ft.py:11-220).

    args.datadir = <root>/<scan>; fixed 640x512 base resolution; near/far
    [2.125, 4.525]; view splits from the pair tables ('dtu_train' 16 /
    'dtu_test' 4; any split other than 'train' reads the test views).
    """

    SCALE_FACTOR = 1.0 / 200

    def __init__(self, args, split="train", load_ref=False):
        self.args = args
        self.root_dir = os.path.dirname(args.datadir)
        self.scan = os.path.basename(args.datadir)
        self.split = split
        downsample = args.imgScale_train if split == "train" \
            else args.imgScale_test
        if int(640 * downsample) % 32 != 0:
            raise ValueError("image width must be divisible by 32 "
                             "(adjust imgScale)")
        self.img_wh = (int(640 * downsample), int(512 * downsample))
        self.downsample = downsample
        self.bbox_3d = np.array([[-1.0, -1.0, 2.2], [1.0, 1.0, 4.2]],
                                np.float32)
        self.near_far = [2.125, 4.525]
        self.pair_idx = [get_split("dtu", "train"), get_split("dtu", "test")]
        self.white_back = False
        if not load_ref:
            self.read_meta()

    def _read_cam(self, idx):
        fname = os.path.join(self.root_dir, "Cameras/train",
                             f"{idx:08d}_cam.txt")
        intrinsic, w2c, near_far, _ = read_cam_file(fname, self.SCALE_FACTOR)
        intrinsic = intrinsic.copy()
        intrinsic[:2] *= self.downsample
        return intrinsic, w2c, near_far

    def _image_path(self, idx):
        return os.path.join(self.root_dir, f"Rectified/{self.scan}_train",
                            f"rect_{int(idx) + 1:03d}_3_r5000.png")

    def read_depth(self, filename):
        depth_h = read_pfm(filename)[0]
        depth_h = resize_nearest(depth_h, 0.5, 0.5)
        depth_h = depth_h[44:556, 80:720]
        if self.downsample != 1.0:
            depth_h = resize_nearest(depth_h, self.downsample,
                                     self.downsample)
        return depth_h

    def read_source_views(self, pair_idx=None):
        """3 source views + relative projections for the encoding volume
        (data/dtu_ft.py:72-119): ImageNet-normalised images (V, H, W, 3),
        stride-4 projections (V, 3, 4), near/far, and pose_source with
        c2ws, w2cs and image-scale intrinsics."""
        if pair_idx is None:
            pair_idx = self.pair_idx[0][:3]
        imgs, proj_mats = [], []
        intrinsics, c2ws, w2cs = [], [], []
        ref_proj_inv = None
        near_far_source = None
        for i, idx in enumerate(pair_idx):
            intrinsic, w2c, near_far_source = self._read_cam(int(idx))
            c2ws.append(np.linalg.inv(w2c))
            w2cs.append(w2c)
            proj = np.eye(4, dtype=np.float32)
            proj[:3, :4] = intrinsic @ w2c[:3, :4]  # stride-4 scale
            if i == 0:
                ref_proj_inv = np.linalg.inv(proj)
                proj_mats.append(np.eye(4, dtype=np.float32))
            else:
                proj_mats.append((proj @ ref_proj_inv).astype(np.float32))
            intrinsic4 = intrinsic.copy()
            intrinsic4[:2] *= 4  # image scale (data/dtu_ft.py:101)
            intrinsics.append(intrinsic4)
            imgs.append(normalize_imagenet(
                load_image(self._image_path(idx), self.img_wh)))

        pose_source = {
            "c2ws": np.stack(c2ws).astype(np.float32),
            "w2cs": np.stack(w2cs).astype(np.float32),
            "intrinsics": np.stack(intrinsics).astype(np.float32),
        }
        return (np.stack(imgs).astype(np.float32),
                np.stack(proj_mats)[:, :3].astype(np.float32),
                near_far_source, pose_source)

    def load_poses_all(self):
        """Camera-to-world poses of every camera file of the scan, (n, 4,
        4), for the per-image source selection and the video's `interp`
        path; sets `focal` to the image-scale focal at this dataset's
        downsample (the JAX package's reads the full-size one)."""
        cam_dir = os.path.join(self.root_dir, "Cameras/train")
        c2ws, intrinsic = [], None
        for item in sorted(os.listdir(cam_dir)):
            intrinsic, w2c, _, _ = read_cam_file(
                os.path.join(cam_dir, item), self.SCALE_FACTOR)
            c2ws.append(np.linalg.inv(w2c))
        intrinsic = intrinsic.copy()
        intrinsic[:2] *= 4 * self.downsample
        self.focal = [intrinsic[0, 0], intrinsic[1, 1]]
        return np.stack(c2ws)

    def read_meta(self):
        self.img_idx = self.pair_idx[0] if self.split == "train" \
            else self.pair_idx[1]
        w, h = self.img_wh
        all_rays, all_rgbs, all_depth, poses = [], [], [], []
        for idx in self.img_idx:
            intrinsic, w2c, near_far = self._read_cam(int(idx))
            c2w = np.linalg.inv(w2c)
            poses.append(c2w)
            img = load_image(self._image_path(idx), self.img_wh)
            all_rgbs.append(img.reshape(-1, 3))

            depth_path = os.path.join(self.root_dir, f"Depths/{self.scan}",
                                      f"depth_map_{int(idx):04d}.pfm")
            if os.path.exists(depth_path) and self.split != "train":
                all_depth.append(
                    (self.read_depth(depth_path) * self.SCALE_FACTOR)
                    .reshape(-1))

            intrinsic4 = intrinsic.copy()
            intrinsic4[:2] *= 4  # image-scale intrinsics (dtu_ft.py:174)
            center = [intrinsic4[0, 2], intrinsic4[1, 2]]
            self.focal = [intrinsic4[0, 0], intrinsic4[1, 1]]
            all_rays.append(rays_for_pose(h, w, self.focal, center, c2w,
                                          near_far[0], near_far[1]))
        self.poses = np.stack(poses)
        if self.split == "train":
            self.all_rays = np.concatenate(all_rays, 0)
            self.all_rgbs = np.concatenate(all_rgbs, 0)
        else:
            self.all_rays = np.stack(all_rays, 0)
            self.all_rgbs = np.stack(all_rgbs, 0).reshape(-1, h, w, 3)
            self.all_depth = (np.stack(all_depth, 0).reshape(-1, h, w)
                              if all_depth else None)

    def __len__(self):
        return len(self.all_rays) if self.split == "train" \
            else len(self.all_rgbs)

    def __getitem__(self, idx):
        sample = {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx],
                  "idx": idx}
        if self.split != "train" and self.all_depth is not None:
            sample["depth"] = self.all_depth[idx]
        return sample
