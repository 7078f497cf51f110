"""NeRF-synthetic (Blender) per-scene dataset (counterpart of
mvsnerf_tpu/data/blender.py, reference data/blender.py).

800x800 scaled by imgScale, near/far 2/6, Blender poses converted to
OpenCV, RGBA blended onto white, view splits from the pair tables. Every
split reads `transforms_train.json`, as the JAX package's does. Numpy
only: the trainer moves what it needs to its device.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .common import BLENDER2OPENCV, load_image, normalize_imagenet
from .dtu_ft import rays_for_pose
from .pairs import get_split


class BlenderDataset:
    """args.datadir = <root>/<scene>; the split's views come from the pair
    table of the directory's name (all frames of the file when the table
    has none). Training rays are flat (N*h*w, 8) [o, d, near, far]; other
    splits keep them per image, with the colours as (n, h, w, 3) and the
    alpha masks as (n, h, w)."""

    def __init__(self, args, split="train", load_ref=False):
        self.args = args
        self.root_dir = args.datadir
        self.split = split
        downsample = args.imgScale_train if split == "train" \
            else args.imgScale_test
        if int(800 * downsample) % 32 != 0:
            raise ValueError("image width must be divisible by 32 "
                             "(adjust imgScale)")
        self.img_wh = (int(800 * downsample), int(800 * downsample))
        self.near, self.far = 2.0, 6.0
        self.white_back = True
        if not load_ref:
            self.read_meta()

    def _load_frame_image(self, frame):
        """(rgb (h, w, 3) blended onto white, mask (h, w) of alpha > 0)."""
        path = os.path.join(self.root_dir, f"{frame['file_path']}.png")
        img = load_image(path, self.img_wh, keep_alpha=True)
        if img.shape[-1] == 4:
            rgb = img[..., :3] * img[..., 3:] + (1 - img[..., 3:])
            return rgb, img[..., 3] > 0
        return img, np.ones(img.shape[:2], bool)

    def _focal(self, meta):
        focal = 0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"])
        return focal * self.img_wh[0] / 800

    def _scene_name(self):
        return os.path.basename(self.root_dir.rstrip("/"))

    def read_meta(self):
        with open(os.path.join(self.root_dir, "transforms_train.json")) as f:
            self.meta = json.load(f)
        try:
            self.img_idx = get_split(self._scene_name(), self.split)
            frames = [self.meta["frames"][i] for i in self.img_idx]
        except KeyError:
            frames = self.meta["frames"]
            self.img_idx = np.arange(len(frames))

        w, h = self.img_wh
        self.focal = self._focal(self.meta)
        center = [w / 2, h / 2]
        all_rays, all_rgbs, all_masks, poses = [], [], [], []
        for frame in frames:
            pose = np.array(frame["transform_matrix"]) @ BLENDER2OPENCV
            poses.append(pose.astype(np.float32))
            rgb, mask = self._load_frame_image(frame)
            all_rgbs.append(rgb.reshape(-1, 3))
            all_masks.append(mask.reshape(-1))
            all_rays.append(rays_for_pose(h, w, [self.focal, self.focal],
                                          center, pose, self.near, self.far))
        self.poses = np.stack(poses)
        if self.split == "train":
            self.all_rays = np.concatenate(all_rays, 0)
            self.all_rgbs = np.concatenate(all_rgbs, 0)
        else:
            self.all_rays = np.stack(all_rays, 0)
            self.all_rgbs = np.stack(all_rgbs, 0).reshape(-1, h, w, 3)
            self.all_masks = np.stack(all_masks, 0).reshape(-1, h, w)

    def read_source_views(self, file="transforms_train.json", pair_idx=None):
        """The 3 source views for the encoding volume (JAX blender.py:
        77-121): ImageNet-normalised images (V, h, w, 3), stride-4
        projections relative to view 0 (V, 3, 4), near/far [2, 6] and
        pose_source (c2ws, w2cs, image-scale intrinsics). Without
        `pair_idx` they are the first 3 training views of the pair table,
        which must name the scene (no fallback, as in JAX)."""
        with open(os.path.join(self.root_dir, file)) as f:
            meta = json.load(f)
        w, h = self.img_wh
        focal = self._focal(meta)
        if pair_idx is None:
            pair_idx = get_split(self._scene_name(), "train")[:3]

        imgs, proj_mats = [], []
        intrinsics, c2ws, w2cs = [], [], []
        ref_proj_inv = None
        for i, idx in enumerate(pair_idx):
            frame = meta["frames"][int(idx)]
            c2w = np.array(frame["transform_matrix"]) @ BLENDER2OPENCV
            w2c = np.linalg.inv(c2w)
            c2ws.append(c2w.astype(np.float32))
            w2cs.append(w2c.astype(np.float32))
            intrinsic = np.array([[focal, 0, w / 2], [0, focal, h / 2],
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
            rgb, _ = self._load_frame_image(frame)
            imgs.append(normalize_imagenet(rgb))

        pose_source = {
            "c2ws": np.stack(c2ws), "w2cs": np.stack(w2cs),
            "intrinsics": np.stack(intrinsics),
        }
        return (np.stack(imgs).astype(np.float32),
                np.stack(proj_mats)[:, :3].astype(np.float32),
                [2.0, 6.0], pose_source)

    def load_poses_all(self, file="transforms_train.json"):
        """Camera-to-world poses (OpenCV) of every frame of `file`,
        (n, 4, 4)."""
        with open(os.path.join(self.root_dir, file)) as f:
            meta = json.load(f)
        return np.stack([np.array(fr["transform_matrix"]) @ BLENDER2OPENCV
                         for fr in meta["frames"]])

    def __len__(self):
        return len(self.all_rays) if self.split == "train" \
            else len(self.all_rgbs)

    def __getitem__(self, idx):
        if self.split == "train":
            return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx]}
        return {"rays": self.all_rays[idx], "rgbs": self.all_rgbs[idx],
                "mask": self.all_masks[idx]}
