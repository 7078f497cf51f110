"""LLFF (forward-facing real scenes) per-scene dataset (counterpart of
mvsnerf_tpu/data/llff.py, reference data/llff.py).

960x640 scaled by imgScale; `poses_bounds.npy` parsed with the "down right
back" axis swap, the poses recentred on their average and the scene
rescaled so the nearest bound is 1 / 0.75. Spheric poses (the default)
keep world rays with each image's bounds x [0.8, 1.2] as near/far; without
them the rays go to NeRF's NDC with near/far [0, 1]. Numpy arrays
throughout.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..ops.geometry import get_ndc_rays
from .common import (BLENDER2OPENCV, center_poses, load_image,
                     normalize_imagenet)
from .dtu_ft import _ray_dirs
from .pairs import get_split


def _parse_poses_bounds(root_dir, img_wh):
    """(poses (N, 3, 4) OpenCV c2w, bounds (N, 2), focal [fx, fy] at
    img_wh, the (4, 4) recentring transform) from poses_bounds.npy (JAX
    llff.py:38)."""
    pb = np.load(os.path.join(root_dir, "poses_bounds.npy"))
    poses = pb[:, :15].reshape(-1, 3, 5)
    bounds = pb[:, -2:]
    H, W, focal = poses[0, :, -1]
    focal = [focal * img_wh[0] / W, focal * img_wh[1] / H]
    # "down right back" -> "right up back" (data/llff.py:200)
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]],
                           -1)
    poses, pose_avg = center_poses(poses, BLENDER2OPENCV)
    near_original = bounds.min()
    scale = near_original * 0.75
    bounds = bounds / scale
    poses = poses.copy()
    poses[..., 3] /= scale
    return poses.astype(np.float32), bounds.astype(np.float32), focal, pose_avg


class LLFFDataset:
    """args.datadir = <root>/<scene> with `images/` and `poses_bounds.npy`;
    the split's views come from the pair table of the directory's name
    (every image when the table has none). Training rays are flat
    (N*h*w, 8); other splits keep them per image, with the colours as
    (n, h, w, 3)."""

    def __init__(self, args, split="train", spheric_poses=True,
                 load_ref=False):
        self.args = args
        self.root_dir = args.datadir
        self.split = split
        downsample = args.imgScale_train if split == "train" \
            else args.imgScale_test
        self.img_wh = (int(960 * downsample), int(640 * downsample))
        if self.img_wh[0] % 32 != 0 and self.img_wh[1] % 32 != 0:
            raise ValueError("image width must be divisible by 32 "
                             "(adjust imgScale)")
        self.spheric_poses = spheric_poses
        self.white_back = False
        if not load_ref:
            self.read_meta()

    def _scene_name(self):
        return os.path.basename(self.root_dir.rstrip("/"))

    def _image_paths(self):
        return sorted(glob.glob(os.path.join(self.root_dir, "images/*")))

    def read_meta(self):
        self.image_paths = self._image_paths()
        poses, bounds, self.focal, _ = _parse_poses_bounds(self.root_dir,
                                                           self.img_wh)
        self.poses, self.bounds = poses, bounds
        try:
            self.img_idx = get_split(self._scene_name(), self.split)
        except KeyError:
            self.img_idx = np.arange(len(self.image_paths))

        w, h = self.img_wh
        center = [w / 2, h / 2]
        dirs = _ray_dirs(h, w, self.focal, center).reshape(-1, 3)
        all_rays, all_rgbs = [], []
        for i in self.img_idx:
            img = load_image(self.image_paths[int(i)], self.img_wh)
            all_rgbs.append(img.reshape(-1, 3).astype(np.float32))
            c2w = poses[int(i)]
            rays_d = dirs @ c2w[:3, :3].T
            rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
            if not self.spheric_poses:
                near, far = 0.0, 1.0
                rays_o, rays_d = get_ndc_rays(h, w, self.focal, 1.0,
                                              rays_o, rays_d)
            else:
                near = bounds[int(i)][0] * 0.8
                far = bounds[int(i)][1] * 1.2
            nf = np.empty((len(rays_d), 2), np.float32)
            nf[:, 0], nf[:, 1] = near, far
            all_rays.append(
                np.concatenate([rays_o, rays_d, nf], -1).astype(np.float32))
        if self.split == "train":
            self.all_rays = np.concatenate(all_rays, 0)
            self.all_rgbs = np.concatenate(all_rgbs, 0)
        else:
            self.all_rays = np.stack(all_rays, 0)
            self.all_rgbs = np.stack(all_rgbs, 0).reshape(-1, h, w, 3)

    def read_source_views(self, pair_idx=None):
        """The 3 source views for the encoding volume (JAX llff.py:110-
        159): ImageNet-normalised images (V, h, w, 3), stride-4
        projections relative to view 0 (V, 3, 4), the near/far of the
        sources' bounds ([min x 0.8, max x 1.2]) and pose_source. Without
        `pair_idx` they are the first 3 training views of the pair table,
        which must name the scene (no fallback, as in JAX)."""
        image_paths = self._image_paths()
        poses, bounds, focal, _ = _parse_poses_bounds(self.root_dir,
                                                      self.img_wh)
        if pair_idx is None:
            pair_idx = get_split(self._scene_name(), "train")[:3]

        w, h = self.img_wh
        imgs, proj_mats = [], []
        intrinsics, c2ws, w2cs = [], [], []
        ref_proj_inv = None
        for i, idx in enumerate(pair_idx):
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3] = poses[int(idx)]
            w2c = np.linalg.inv(c2w)
            c2ws.append(c2w)
            w2cs.append(w2c.astype(np.float32))
            intrinsic = np.array([[focal[0], 0, w / 2], [0, focal[1], h / 2],
                                  [0, 0, 1]], np.float32)
            intrinsics.append(intrinsic.copy())
            intrinsic_s4 = intrinsic.copy()
            intrinsic_s4[:2] /= 4
            proj = np.eye(4, dtype=np.float32)
            proj[:3, :4] = intrinsic_s4 @ w2c[:3, :4]
            if i == 0:
                ref_proj_inv = np.linalg.inv(proj)
                proj_mats.append(np.eye(4, dtype=np.float32))
            else:
                proj_mats.append((proj @ ref_proj_inv).astype(np.float32))
            img = load_image(image_paths[int(idx)], self.img_wh)
            imgs.append(normalize_imagenet(img))

        pose_source = {
            "c2ws": np.stack(c2ws), "w2cs": np.stack(w2cs),
            "intrinsics": np.stack(intrinsics),
        }
        sel = np.asarray([int(i) for i in pair_idx])
        near_far_source = [float(bounds[sel].min() * 0.8),
                           float(bounds[sel].max() * 1.2)]
        return (np.stack(imgs).astype(np.float32),
                np.stack(proj_mats)[:, :3].astype(np.float32),
                near_far_source, pose_source)

    def load_poses_all(self):
        """The recentred camera-to-world poses of every image, (n, 4, 4);
        sets `focal`."""
        poses, _, self.focal, _ = _parse_poses_bounds(self.root_dir,
                                                      self.img_wh)
        out = np.tile(np.eye(4, dtype=np.float32), (len(poses), 1, 1))
        out[:, :3] = poses
        return out

    def __len__(self):
        return len(self.all_rays)

    def __getitem__(self, idx):
        return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}
