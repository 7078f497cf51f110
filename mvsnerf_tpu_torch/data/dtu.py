"""DTU multi-view-stereo dataset for generalizable training (counterpart of
mvsnerf_tpu/data/dtu.py, reference data/dtu.py).

Samples are channel-last numpy dicts; the trainer moves them to its
device. The scan lists and source-view rankings are the port's copies
under configs/ (`dtu_pairs.txt`, `lists/`). GT depths (PFM -> x0.5
nearest -> crop -> downSample) go through the native host library
(`mvsnerf_tpu_torch.native`) where it builds, else numpy.
"""

from __future__ import annotations

import os

import numpy as np

from .common import (load_image, normalize_imagenet, read_cam_file,
                     resize_nearest)

CFG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def load_dtu_pairs():
    """configs/dtu_pairs.txt: 49 viewpoints, each with 10 ranked source
    views (reference data/dtu.py:63-72)."""
    pairs = {}
    with open(os.path.join(CFG_DIR, "dtu_pairs.txt")) as f:
        n = int(f.readline())
        for _ in range(n):
            ref = int(f.readline().rstrip())
            toks = f.readline().rstrip().split()
            pairs[ref] = [int(x) for x in toks[1::2]]
    return pairs


def load_scan_list(split: str):
    """configs/lists/dtu_<split>_all.txt: the split's scan names."""
    with open(os.path.join(CFG_DIR, "lists", f"dtu_{split}_all.txt")) as f:
        return [line.rstrip() for line in f if line.strip()]


class MVSDatasetDTU:
    """Generalizable-training DTU dataset (reference data/dtu.py:22-213).

    Each sample: 3 source views + 1 target view (the last) of one scan
    under one light condition. Images are ImageNet-normalised (V, H, W, 3)
    channel-last; proj_mats are stride-4-scale projections relative to
    view 0.
    """

    SCALE_FACTOR = 1.0 / 200  # reference data/dtu.py:34

    def __init__(self, root_dir, split, n_views=3, downSample=1.0,
                 max_len=-1, scan_list=None, seed=0):
        assert split in ("train", "val", "test")
        self.root_dir = root_dir
        self.split = split
        self.n_views = n_views
        self.downSample = downSample
        self.max_len = max_len
        self.rng = np.random.default_rng(seed)

        self.scans = scan_list or load_scan_list(split)
        self.pairs = load_dtu_pairs()
        # light conditions: all 7 for train, light 3 otherwise
        # (reference data/dtu.py:57-59)
        light_idxs = range(7) if split == "train" else [3]
        self.metas = []
        ids = set()
        for scan in self.scans:
            for ref_view, src_views in self.pairs.items():
                for light in light_idxs:
                    self.metas.append((scan, light, ref_view, src_views))
                ids.update([ref_view] + src_views)
        self.id_list = sorted(ids)
        self._build_proj_mats()

    def _build_proj_mats(self):
        """Camera table at stride-4 feature scale (data/dtu.py:77-99):
        cam.txt intrinsics are already at 1/4 scale; x4 then (optionally
        downSample) then /4 reproduces the reference's intrinsic dance."""
        self.proj_mats, self.near_fars = {}, {}
        self.intrinsics, self.world2cams, self.cam2worlds = {}, {}, {}
        for vid in self.id_list:
            fname = os.path.join(self.root_dir, "Cameras/train",
                                 f"{vid:08d}_cam.txt")
            intrinsic, extrinsic, near_far, _ = read_cam_file(
                fname, self.SCALE_FACTOR)
            intrinsic = intrinsic.copy()
            intrinsic[:2] *= 4
            intrinsic[:2] *= self.downSample
            self.intrinsics[vid] = intrinsic.copy()

            proj = np.eye(4, dtype=np.float32)
            intrinsic_s4 = intrinsic.copy()
            intrinsic_s4[:2] /= 4
            proj[:3, :4] = intrinsic_s4 @ extrinsic[:3, :4]
            self.proj_mats[vid] = proj
            self.near_fars[vid] = np.asarray(near_far, np.float32)
            self.world2cams[vid] = extrinsic
            self.cam2worlds[vid] = np.linalg.inv(extrinsic).astype(np.float32)

    def read_depth(self, filename):
        """GT depth pyramid (data/dtu.py:116-127): PFM -> x0.5 nearest ->
        crop [44:556, 80:720] -> downSample; returns (depth at 1/4, its
        mask, depth_h). Through the native library, which takes its numpy
        route where the library is not built; both give the same arrays."""
        from .. import native
        with open(filename, "rb") as f:
            depth_full = native.pfm_decode(f.read())
        depth_h = native.dtu_depth_pipeline(depth_full, self.downSample)
        depth = resize_nearest(depth_h, 0.25, 0.25)
        return depth, depth > 0, depth_h

    def __len__(self):
        return len(self.metas) if self.max_len <= 0 else min(
            self.max_len, len(self.metas))

    def __getitem__(self, idx):
        scan, light_idx, target_view, src_views = self.metas[idx]
        if self.split == "train":
            # 3 random of the top-5 ranked source views (data/dtu.py:140-142)
            ids = self.rng.permutation(5)[:self.n_views]
        else:
            ids = np.arange(self.n_views)
        view_ids = [src_views[i] for i in ids] + [target_view]

        imgs, depths_h = [], []
        proj_mats, intrinsics, w2cs, c2ws, near_fars = [], [], [], [], []
        affine_mats = []
        ref_proj_inv = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(
                self.root_dir, f"Rectified/{scan}_train",
                f"rect_{vid + 1:03d}_{light_idx}_r5000.png")
            img = load_image(img_path, method="bilinear")
            if self.downSample != 1.0:
                h, w = img.shape[:2]
                wh = (int(round(w * self.downSample)),
                      int(round(h * self.downSample)))
                img = load_image(img_path, wh, method="bilinear")
            imgs.append(normalize_imagenet(img))

            proj = self.proj_mats[vid]
            affine_mats.append(proj)
            if i == 0:
                ref_proj_inv = np.linalg.inv(proj)
                proj_mats.append(np.eye(4, dtype=np.float32))
            else:
                proj_mats.append((proj @ ref_proj_inv).astype(np.float32))
            intrinsics.append(self.intrinsics[vid])
            w2cs.append(self.world2cams[vid])
            c2ws.append(self.cam2worlds[vid])
            near_fars.append(self.near_fars[vid])

            depth_path = os.path.join(self.root_dir, f"Depths/{scan}",
                                      f"depth_map_{vid:04d}.pfm")
            if os.path.exists(depth_path):
                _, _, depth_h = self.read_depth(depth_path)
                depths_h.append(depth_h * self.SCALE_FACTOR)
            else:
                depths_h.append(np.zeros((1, 1), np.float32))

        return {
            "images": np.stack(imgs).astype(np.float32),      # (V, H, W, 3)
            "depths_h": np.stack(depths_h).astype(np.float32),
            "w2cs": np.stack(w2cs).astype(np.float32),
            "c2ws": np.stack(c2ws).astype(np.float32),
            "near_fars": np.stack(near_fars).astype(np.float32),
            "proj_mats": np.stack(proj_mats)[:, :3].astype(np.float32),
            "intrinsics": np.stack(intrinsics).astype(np.float32),
            "affine_mats": np.stack(affine_mats).astype(np.float32),
            "view_ids": np.asarray(view_ids),
            "light_id": np.asarray(light_idx),
            "scan": scan,
        }
