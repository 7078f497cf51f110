"""Cameras, images and rays of the benchmark's scenes, made from a seed.

The camera rigs are copies of the arithmetic of the port's synthetic
scene writers and loaders (data/synthetic.py `write_dtu_scene` with
data/dtu_ft.py, data/dtu.py and data/common.py `read_cam_file`;
`_llff_poses_bounds` with data/llff.py `_parse_poses_bounds`), so that a
scene reaches the program as its loaders would hand it over, without
files. Images are uniform noise from a generator on the device: nothing
on the measured paths depends on their content.

Every array is float32 numpy unless it says otherwise; `normalize` is the
loaders' ImageNet normalisation.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(img):
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def images(n: int, h: int, w: int, seed: int, device) -> np.ndarray:
    """(n, h, w, 3) uniform [0, 1) images drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, h, w, 3), generator=gen,
                      device=device).cpu().numpy()


def ray_dirs(h, w, focal, center):
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32), indexing="xy")
    return np.stack([(xs - center[0]) / focal[0],
                     (ys - center[1]) / focal[1], np.ones_like(xs)], -1)


def rays_for_pose(h, w, focal, center, c2w, near, far):
    """(h*w, 8) [origin, direction, near, far] (data/dtu_ft.py)."""
    dirs = ray_dirs(h, w, focal, center).reshape(-1, 3)
    rays_d = dirs @ np.asarray(c2w)[:3, :3].T
    rays_o = np.broadcast_to(np.asarray(c2w)[:3, 3], rays_d.shape)
    nf = np.empty((len(rays_d), 2), np.float32)
    nf[:, 0], nf[:, 1] = near, far
    return np.concatenate([rays_o, rays_d, nf], -1).astype(np.float32)


def relative_projections(intrinsics_s4, w2cs):
    """(V, 3, 4) stride-4 projections relative to view 0."""
    projs = []
    for k, w2c in zip(intrinsics_s4, w2cs):
        p = np.eye(4, dtype=np.float32)
        p[:3, :4] = k @ w2c[:3, :4]
        projs.append(p)
    ref_inv = np.linalg.inv(projs[0])
    out = [np.eye(4, dtype=np.float32)] + [(p @ ref_inv).astype(np.float32)
                                           for p in projs[1:]]
    return np.stack(out)[:, :3]


class DTURig:
    """49 cameras on an arc about a plane ~3.5 units away, DTU's stride-4
    intrinsics (180, 80, 64) and near/far [2.125, 4.525] (the synthetic
    DTU scan, data/synthetic.py; translations scaled by 1/200)."""

    N_VIEWS = 49

    def __init__(self, img_wh=(640, 512)):
        self.w, self.h = img_wh
        scale = img_wh[0] / 640.0
        self.w2cs, self.k_s4 = [], []
        for vid in range(self.N_VIEWS):
            a = 0.02 * (vid - self.N_VIEWS / 2)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                           [-np.sin(a), 0, np.cos(a)]]
            ext[:3, 3] = np.array([8.0 * (vid - self.N_VIEWS / 2), 0, 600],
                                  np.float32) / 200.0
            self.w2cs.append(ext)
            k = np.array([[180.0, 0, 80], [0, 180.0, 64], [0, 0, 1]],
                         np.float32)
            k[:2] *= scale
            self.k_s4.append(k)
        self.w2cs = np.stack(self.w2cs)
        self.c2ws = np.linalg.inv(self.w2cs).astype(np.float32)
        self.k_s4 = np.stack(self.k_s4)
        self.k = self.k_s4.copy()
        self.k[:, :2] *= 4  # image scale
        self.near_far = [2.125, 4.525]

    def rays(self, vid):
        k = self.k[vid]
        return rays_for_pose(self.h, self.w, [k[0, 0], k[1, 1]],
                             [k[0, 2], k[1, 2]], self.c2ws[vid],
                             *self.near_far)

    def source_views(self, imgs, ids):
        """`read_source_views` of views `ids` of (49, h, w, 3) images:
        (normalised images, projections, near_far, pose_source)."""
        ids = [int(i) for i in ids]
        pose = {"c2ws": self.c2ws[ids], "w2cs": self.w2cs[ids],
                "intrinsics": self.k[ids]}
        return (normalize(imgs[ids]).astype(np.float32),
                relative_projections(self.k_s4[ids], self.w2cs[ids]),
                list(self.near_far), pose)


# [H, W, focal] of the 4032x3024 capture the synthetic LLFF scene claims
LLFF_HWF = (3024.0, 4032.0, 3260.0)
BLENDER2OPENCV = np.diag([1.0, -1.0, -1.0, 1.0])


def _look_at(eye, target, up):
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    c2w[:3, 3] = eye
    return c2w


def _normalize(v):
    return v / np.linalg.norm(v)


class LLFFRig:
    """20 forward-facing cameras on a 5 x 4 grid, LLFF's recentring and
    rescaling (data/synthetic.py `_llff_poses_bounds`, data/llff.py
    `_parse_poses_bounds`), OpenCV c2w; `seed` draws the look-at jitter
    and the bounds."""

    def __init__(self, img_wh=(960, 640), n=20, seed=0):
        rng = np.random.default_rng(seed)
        self.w, self.h = img_wh
        poses, bounds = [], []
        for i in range(n):
            eye = np.array([0.15 * (i % 5 - 2), 0.15 * (i // 5 - 1.5), 0.0])
            target = np.array([0.0, 0.0, -10.0]) + rng.uniform(-0.3, 0.3, 3)
            c2w = _look_at(eye, target, np.array([0.0, 1.0, 0.0]))
            poses.append(c2w[:3])  # "right up back" OpenGL
            bounds.append([rng.uniform(1.5, 2.0), rng.uniform(12.0, 16.0)])
        poses, bounds = np.stack(poses), np.asarray(bounds)
        H, W, f = LLFF_HWF
        self.focal = [f * self.w / W, f * self.h / H]
        # recentre on the average pose, then to OpenCV (data/common.py)
        center = poses[..., 3].mean(0)
        z = _normalize(poses[..., 2].mean(0))
        x = _normalize(np.cross(poses[..., 1].mean(0), z))
        avg = np.eye(4)
        avg[:3] = np.stack([x, np.cross(z, x), z, center], 1)
        homo = np.concatenate([poses, np.tile([[[0, 0, 0, 1.0]]],
                                              (n, 1, 1))], 1)
        poses = (np.linalg.inv(avg) @ homo @ BLENDER2OPENCV)[:, :3]
        scale = bounds.min() * 0.75
        self.bounds = (bounds / scale).astype(np.float32)
        poses = poses.copy()
        poses[..., 3] /= scale
        self.c2ws = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        self.c2ws[:, :3] = poses
        self.w2cs = np.linalg.inv(self.c2ws).astype(np.float32)
        self.k = np.array([[self.focal[0], 0, self.w / 2],
                           [0, self.focal[1], self.h / 2], [0, 0, 1]],
                          np.float32)

    def source_views(self, imgs, ids):
        """`read_source_views` of views `ids` (data/llff.py)."""
        ids = [int(i) for i in ids]
        k = np.stack([self.k] * len(ids))
        k_s4 = k.copy()
        k_s4[:, :2] /= 4
        near_far = [float(self.bounds[ids].min() * 0.8),
                    float(self.bounds[ids].max() * 1.2)]
        pose = {"c2ws": self.c2ws[ids], "w2cs": self.w2cs[ids],
                "intrinsics": k}
        return (normalize(imgs[ids]).astype(np.float32),
                relative_projections(k_s4, self.w2cs[ids]), near_far, pose)


def spiral_path(radii, focus_depth, n: int):
    """A spiral of OpenCV c2ws about the origin looking down -z at
    `focus_depth` (data/common.py `create_spiral_poses`, turned from
    OpenGL to OpenCV as eval/paths.py `pose_spherical_dtu` does)."""
    out = []
    for t in np.linspace(0, 4 * np.pi, n + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = _normalize(center - np.array([0, 0, -focus_depth]))
        x = _normalize(np.cross(np.array([0, 1.0, 0]), z))
        c2w = np.eye(4)
        c2w[:3] = np.stack([x, np.cross(z, x), z, center], 1)
        out.append(c2w @ BLENDER2OPENCV)
    return np.stack(out).astype(np.float32)
